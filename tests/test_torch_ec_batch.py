"""Batched EC encode of the port — ``encode_batched`` and the
``EncodeBatcher`` — against ``ceph_tpu``'s, on the CPU.

A batching layer is only admissible if it is byte-identical to the
per-object path for every plugin and profile, and if its warmed shapes
build nothing again; ``ceph_tpu``'s ``test_ec_batch.py`` holds its own
to that, and this file holds the port to ``ceph_tpu``.
"""

import sys
import threading

import numpy as np
import pytest
import torch

from ceph_tpu.ec.batcher import EncodeBatcher as JEncodeBatcher
from ceph_tpu.ec.registry import factory as jfactory
from ceph_tpu.ec.rs_jax import RSCode as JRSCode

from ceph_tpu_torch.analysis import contracts, lockdep
from ceph_tpu_torch.ec import batcher as pbatcher
from ceph_tpu_torch.ec import engine
from ceph_tpu_torch.ec.batcher import EncodeBatcher
from ceph_tpu_torch.ec.registry import factory
from ceph_tpu_torch.ec.rs import RSCode
from ceph_tpu_torch.parallel.placement import make_mesh

# ceph_tpu's plugin/profile grid: the jerasure technique/w/packetsize
# points, isa, LRC, SHEC and the sub-chunked Clay (per-object fallback)
PROFILES = [
    ("jerasure", {"technique": "reed_sol_van", "k": "2", "m": "1",
                  "w": "8"}),
    ("jerasure", {"technique": "reed_sol_van", "k": "4", "m": "2",
                  "w": "8"}),
    ("jerasure", {"technique": "reed_sol_van", "k": "3", "m": "2",
                  "w": "16"}),
    ("jerasure", {"technique": "reed_sol_van", "k": "3", "m": "2",
                  "w": "32"}),
    ("jerasure", {"technique": "reed_sol_r6_op", "k": "4", "m": "2",
                  "w": "8"}),
    ("jerasure", {"technique": "cauchy_good", "k": "4", "m": "2",
                  "w": "8", "packetsize": "8"}),
    ("jerasure", {"technique": "liberation", "k": "3", "m": "2",
                  "w": "7", "packetsize": "8"}),
    ("isa", {"k": "4", "m": "2"}),
    ("lrc", {"k": "4", "m": "2", "l": "3"}),
    ("shec", {"k": "4", "m": "3", "c": "2"}),
    ("clay", {"k": "4", "m": "2"}),
]
IDS = [p + "-" + "-".join(f"{k}{v}" for k, v in sorted(prof.items()))
       for p, prof in PROFILES]


def _objects(n, size, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size, dtype=np.uint8).tobytes()
            for _ in range(n)]


def _same(jchunks, pchunks):
    assert sorted(jchunks) == sorted(pchunks)
    for i in jchunks:
        assert np.asarray(jchunks[i], np.uint8).tobytes() == \
            pchunks[i].numpy().tobytes(), f"chunk {i}"


@pytest.mark.parametrize("plugin,profile", PROFILES, ids=IDS)
@pytest.mark.parametrize("mesh_size", [0, 4], ids=["one-device", "mesh4"])
def test_plugin_encode_batched_byte_identical(plugin, profile, mesh_size):
    """encode_batched of 2 and 3 objects (3: ceph_tpu's pad case) ==
    ceph_tpu's per-object encode and its encode_batched, on one device
    and over a 4-way mesh."""
    jcode = jfactory(plugin, dict(profile))
    code = factory(plugin, dict(profile), device="cpu")
    mesh = make_mesh(["cpu"] * mesh_size) if mesh_size else None
    want = set(range(code.get_chunk_count()))
    for B, size in ((2, 4096), (3, 8192)):
        raws = _objects(B, size, seed=B)
        batched = code.encode_batched(want, raws, mesh=mesh)
        assert len(batched) == B
        for raw, got, jgot in zip(raws, batched,
                                  jcode.encode_batched(want, raws)):
            _same(jcode.encode(want, raw), got)
            _same(jgot, got)


def test_plugin_encode_batched_mixed_sizes_fall_back():
    prof = {"technique": "reed_sol_van", "k": "2", "m": "1", "w": "8"}
    jcode = jfactory("jerasure", dict(prof))
    code = factory("jerasure", dict(prof), device="cpu")
    raws = [b"a" * 1024, b"b" * 2048]
    for raw, got in zip(raws, code.encode_batched(set(range(3)), raws,
                                                  mesh=make_mesh(["cpu"] * 2))):
        _same(jcode.encode(set(range(3)), raw), got)


def test_engine_encode_batched_byte_identical():
    bc, jbc = RSCode(4, 2, device="cpu")._bit, JRSCode(4, 2)._bit
    stripes = np.random.default_rng(7).integers(0, 256, (8, 4, 2048),
                                                dtype=np.uint8)
    out = bc.encode_batched(stripes)
    assert out.shape == (8, 2, 2048) and out.dtype == torch.uint8
    assert out.numpy().tobytes() == \
        np.asarray(jbc.encode_batched(stripes)).tobytes()
    for b in range(8):
        assert torch.equal(out[b], bc.encode(stripes[b]))


def test_engine_encode_batched_steady_state():
    """A warmed batch shape builds nothing: no new signature inside the
    window."""
    bc = RSCode(4, 2, device="cpu")._bit
    rng = np.random.default_rng(8)
    bc.encode_batched(rng.integers(0, 256, (8, 4, 2048), dtype=np.uint8))
    base = len(contracts.recompile_violations())
    with contracts.steady_state("torch.ec.encode_batched"):
        for _ in range(3):
            bc.encode_batched(rng.integers(0, 256, (8, 4, 2048),
                                           dtype=np.uint8))
    assert contracts.recompile_violations()[base:] == []


def _run_threads(batcher, code, want, raws):
    outs = [None] * len(raws)
    errs = []

    def worker(i):
        try:
            outs[i] = batcher.encode(code, want, raws[i])
        except Exception as e:  # surfaced by the caller
            errs.append(e)

    ths = [threading.Thread(target=worker, args=(i,))
           for i in range(len(raws))]
    for t in ths:
        t.start()
    for t in ths:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in ths), "a writer never finished"
    return outs, errs


@pytest.mark.parametrize("mesh_size", [0, 8], ids=["one-device", "mesh8"])
def test_encode_batcher_coalesces_concurrent_encodes(mesh_size):
    """Concurrent encodes through the coalescer: every output equal to
    ceph_tpu's encode and to its batcher's, and at least one
    multi-object batch dispatched (the ec_batch_size canary)."""
    prof = {"technique": "reed_sol_van", "k": "2", "m": "1", "w": "8"}
    jcode = jfactory("jerasure", dict(prof))
    code = factory("jerasure", dict(prof), device="cpu")
    want = set(range(3))
    mesh = make_mesh(["cpu"] * mesh_size) if mesh_size else None
    raws = _objects(12, 4096, seed=3)
    base = engine._pc.dump()["ec_batch_size"]["buckets"]
    outs, errs = _run_threads(EncodeBatcher(max_delay_us=5000, mesh=mesh),
                              code, want, raws)
    jouts, jerrs = _run_threads(JEncodeBatcher(max_delay_us=5000), jcode,
                                want, raws)
    assert not errs and not jerrs
    for raw, got, jgot in zip(raws, outs, jouts):
        _same(jcode.encode(want, raw), got)
        _same(jgot, got)
    cur = engine._pc.dump()["ec_batch_size"]["buckets"]
    assert sum(c - b for c, b in zip(cur[1:], base[1:])) > 0, \
        "no multi-object batch ever dispatched"


def test_batcher_encodes_no_zero_objects():
    """A group of 3 goes to encode_batched as 3 objects (ceph_tpu pads
    it to 4 with a zero object), and books a batch of 3."""
    seen = []

    class Code:
        def encode(self, want, raw):
            return {0: raw}

        def encode_batched(self, want, raws, mesh=None):
            seen.append(len(raws))
            return [{0: r} for r in raws]

    b = EncodeBatcher()
    reqs = [pbatcher._EncodeReq(Code(), {0}, bytes([i]) * 16)
            for i in range(3)]
    base = engine._pc.dump()["ec_batch_size"]["buckets"]
    b._run_group(reqs)
    assert seen == [3] and [r.out[0][0] for r in reqs] == [0, 1, 2]
    cur = engine._pc.dump()["ec_batch_size"]["buckets"]
    grew = [i for i, (c, bb) in enumerate(zip(cur, base)) if c > bb]
    assert grew == [2]   # (2, 4]: the batch of 3


def test_batcher_splits_at_max_batch():
    seen = []

    class Code:
        def encode_batched(self, want, raws, mesh=None):
            seen.append(len(raws))
            return [{} for _ in raws]

    b = EncodeBatcher(max_batch=4)
    b._run_group([pbatcher._EncodeReq(Code(), {0}, b"x") for _ in range(10)])
    assert seen == [4, 4, 2]


def test_batcher_stress_no_lost_request():
    """48 writers (more than the cores), a switch interval of a
    microsecond, 48 distinct objects: every request completes with its
    own object's chunks (a lost or crossed request would not)."""
    code = factory("jerasure", {"technique": "reed_sol_van", "k": "2",
                                "m": "1", "w": "8"}, device="cpu")
    want = set(range(3))
    raws = _objects(48, 512, seed=9)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        outs, errs = _run_threads(EncodeBatcher(max_delay_us=200), code,
                                  want, raws)
    finally:
        sys.setswitchinterval(old)
    assert not errs
    for raw, got in zip(raws, outs):
        ref = code.encode(want, raw)
        assert all(torch.equal(ref[i], got[i]) for i in want)


def test_batcher_error_propagates_to_all_requesters():
    class Boom:
        def encode(self, want, raw):
            raise ValueError("boom")

        def encode_batched(self, want, raws, mesh=None):
            raise ValueError("boom")

    b = EncodeBatcher()
    with pytest.raises(ValueError):
        b.encode(Boom(), {0}, b"x")
    outs, errs = _run_threads(EncodeBatcher(max_delay_us=5000), Boom(),
                              {0}, [b"x" * 8] * 6)
    assert len(errs) == 6 and all(isinstance(e, ValueError) for e in errs)


def test_batcher_locks_are_lockdep_tracked():
    """The batcher's two locks come from the port's lockdep, and a
    coalesced run records no order violation."""
    was = lockdep.enabled()
    lockdep.enable(True)
    try:
        b = EncodeBatcher(max_delay_us=2000)
        assert isinstance(b._mutex, lockdep.DLock)
        assert isinstance(b._qlock, lockdep.DLock)
        code = factory("isa", {"k": "4", "m": "2"}, device="cpu")
        before = len(lockdep.violations())
        _, errs = _run_threads(b, code, set(range(6)),
                               _objects(6, 4096, seed=8))
        assert not errs and len(lockdep.violations()) == before
    finally:
        lockdep.enable(was)
