"""Client EC writes over the port's messenger into the port's EC engine,
on the CPU: ``chip_smoke``'s phase 12 path as a whole.

Port client messengers write objects to a port primary
(``chip_smoke.WirePrimary``: a lossless messenger built from a port
``Context``, a throttle on ``ec_write``, an ``EncodeBatcher``) that
encodes each with isa 8+3 and jerasure cauchy_good 4+2 packetsize 8 on
``device="cpu"`` (the kernels' plain versions).  Every reply's crc32c,
and the chunk bytes of every 8th, must equal ``ceph_tpu``'s same plugin
on the same bytes, and the port's bufpool must end with nothing
outstanding (``port_gates``).
"""

import tempfile

import numpy as np
import pytest
import torch

import chip_smoke as cs
from ceph_tpu.ec import registry as jregistry
from ceph_tpu_torch.common import bufpool
from ceph_tpu_torch.ec import gf2_kernels, gf2_packet
from ceph_tpu_torch.ec.registry import factory
from ceph_tpu_torch.ec.stripe import crc32c
from ceph_tpu_torch.msg.messenger import Messenger
from test_torch_messenger import _warm
from test_torch_runtime import port_gates  # noqa: F401  (autouse)

CPU = torch.device("cpu")
NAMES = [cs.layout_label(p, prof) for p, prof in cs.WIRE_PROFILES]
SIZES = [4099, (64 << 10) + 5, 256 << 10]
N_OBJECTS = 4


def _codes(device):
    return {nm: factory(p, dict(prof), device=device)
            for nm, (p, prof) in zip(NAMES, cs.WIRE_PROFILES)}


def _objects(size):
    rng = np.random.default_rng(size)
    return [rng.integers(0, 256, size, dtype=np.uint8).tobytes()
            for _ in range(N_OBJECTS)]


@pytest.fixture(scope="module")
def expected():
    """Per object size, ``wire_expected`` of the port's plugins on the
    CPU, held here to ``ceph_tpu``'s plugins on the same bytes."""
    out = {}
    jcodes = {nm: jregistry.factory(p, dict(prof))
              for nm, (p, prof) in zip(NAMES, cs.WIRE_PROFILES)}
    for size in SIZES:
        objs = _objects(size)
        exp = cs.wire_expected(_codes("cpu"), objs)
        for nm, jc in jcodes.items():
            n = jc.get_chunk_count()
            for raw, (host, crcs) in zip(objs, exp[nm]):
                ref = jc.encode(range(n), raw)
                for p in range(n):
                    assert host[p].tobytes() == np.asarray(
                        ref[p], np.uint8).tobytes(), (nm, size, p)
                assert crcs == [crc32c(np.asarray(ref[p], np.uint8))
                                for p in range(n)]
        out[size] = (objs, exp)
    return out


@pytest.fixture(scope="module")
def wire():
    """The EC and wire-only primaries and four port clients."""
    with tempfile.TemporaryDirectory(prefix="wire", dir="/tmp") as d:
        prims = {"ec": cs.WirePrimary(_codes(CPU), d),
                 "wire": cs.WirePrimary({}, d, encode=False, name="osd.1")}
        for prim in prims.values():
            _warm(prim.msgr)
        clients = [Messenger(f"client.{c}") for c in range(4)]
        for cli in clients:
            cli.start()
            for prim in prims.values():  # connected before the tests
                cli.call(prim.msgr.addr, {"type": "hello"}, timeout=10)
        yield prims, clients
        for m in clients:
            m.shutdown()
        for prim in prims.values():
            prim.shutdown()


@pytest.mark.parametrize("writers", [1, 4])
@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("profile", NAMES)
def test_wire_writes_equal_ceph_tpu(wire, expected, profile, size, writers):
    prims, clients = wire
    objs, exp = expected[size]
    ops0, groups0 = cs._engine_counts()
    recs, wall = cs.wire_run(prims["ec"], clients[:writers], profile, objs,
                             exp, writes=4)
    ops, groups = cs._engine_counts()
    assert len(recs) == 4 * writers and wall > 0
    # one encode call (one K1 or K3 product on the card) a batcher group
    assert ops - ops0 == groups - groups0 >= 1
    assert all(r["total"] >= r["crc"] >= 0 for r in recs)


@pytest.mark.parametrize("writers", [1, 4])
def test_wire_only_writes(wire, expected, writers):
    prims, clients = wire
    objs, exp = expected[SIZES[1]]
    recs, _wall = cs.wire_run(prims["wire"], clients[:writers], None, objs,
                              exp, writes=3)
    assert len(recs) == 3 * writers
    assert all(r["prepare_copy"] == 0.0 for r in recs)


def test_a_wrong_chunk_fails_the_run(wire, expected):
    prims, clients = wire
    objs, exp = expected[SIZES[0]]
    bad = dict(exp)
    host, crcs = exp[NAMES[0]][1]
    bad[NAMES[0]] = list(exp[NAMES[0]])
    bad[NAMES[0]][1] = (host, [crcs[0] ^ 1] + crcs[1:])
    with pytest.raises(AssertionError, match="crc32c"):
        cs.wire_run(prims["ec"], clients[:1], NAMES[0], objs, bad, writes=2)


@pytest.mark.parametrize("profile", NAMES)
def test_encode_has_read_the_segment_before_release(wire, expected,
                                                    profile):
    """``encode_prepare`` has read the receive segment when the
    batcher's ``encode`` returns: poisoning the segment right after it,
    before the chunks are read back, changes no chunk; and a later write
    that recycles the same segment changes no chunk kept from before."""
    prims, clients = wire
    prim = prims["ec"]
    objs, exp = expected[SIZES[2]]
    code = prim.codes[profile]
    n = code.get_chunk_count()
    kept = []

    def poisoning(msg):
        buf = msg["data"]
        chunks = prim.batcher.encode(code, range(n), buf)
        buf[:] = b"\xee" * len(buf)
        host = torch.stack([chunks[p] for p in range(n)]).cpu().numpy()
        kept.append((msg["obj"], chunks))
        return {"crc": [crc32c(host[p]) for p in range(n)]}

    prim.msgr.register("poison", poisoning)
    hits0 = cs._bufpool_counts()[0]
    for i in range(3):
        rep = clients[0].call(prim.msgr.addr,
                              {"type": "poison", "obj": i, "data": objs[i]},
                              timeout=30)
        assert rep["crc"] == exp[profile][i][1]
    assert cs._bufpool_counts()[0] - hits0 >= 2  # the segment recycled
    for i, chunks in kept:
        host = exp[profile][i][0]
        for p in range(n):
            assert chunks[p].numpy().tobytes() == host[p].tobytes()


def test_phase_wire_on_the_cpu(monkeypatch):
    """The whole phase, shrunk: every profile and writer count, the
    admin socket's dumps, the launch checks and the quiesce checks.  A
    plain version counts a launch where its wrapper would on the card:
    on the name the module holds (the phase's kernel clock while it
    runs)."""
    for mod, plain, kern in ((gf2_kernels, "gf2_matmul_w8_plain",
                              "gf2_matmul_w8"),
                             (gf2_packet, "gf2_packet_plain", "gf2_packet")):
        real = getattr(mod, plain)

        def counted(*a, _real=real, _mod=mod, _kern=kern, **kw):
            getattr(_mod, _kern).launches += 1
            return _real(*a, **kw)

        monkeypatch.setattr(mod, plain, counted)
    monkeypatch.setattr(cs, "WIRE_OBJECTS", 3)
    saved = cs.launch_counts()
    try:
        with tempfile.TemporaryDirectory(prefix="phase", dir="/tmp") as d:
            out, k1, k3 = cs.phase_wire(CPU, d, "cpu", writers=(1, 2),
                                        writes=2, size=(32 << 10) + 3)
    finally:
        cs.set_launch_counts(saved)
    runs = out["runs"]
    assert [(r["profile"], r["writers"]) for r in runs] == [
        (p, w) for p in NAMES + ["wire-only"] for w in (1, 2)]
    assert k1 == sum(r["launches"]["k1"] for r in runs) >= 2
    assert k3 == sum(r["launches"]["k3"] for r in runs) >= 2
    assert all(r["copies_per_object"] >= 1 for r in runs)
    assert out["asok"]["frames_in"] >= 2 * (2 + 4) + 2
    assert out["asok"]["bufpool"]["leaked_segments"] == 0
    assert bufpool.outstanding() == []
