"""The port's EC plugins (``ceph_tpu_torch.ec``: jerasure at every
technique and w, isa, lrc, shec, clay) against ``ceph_tpu``'s, on the
CPU (the kernels' plain versions), over a grid of profiles with and
without ``mapping=``.

Chunk sizes, parity and decoded bytes, minimum sets, Clay's repair
sub-chunks, ``decode_concat``, ``encode_batched``, the rules of
``create_rule`` and the error codes of bad profiles must all be equal:
outputs are bytes and integers, so the tolerance is zero.  ``ceph_tpu``
runs on its default engine (the native GF(2^8) one where it has it)
and, for jerasure and isa, on ``engine=bitplane`` (its XLA engine).
"""

import itertools
import json

import numpy as np
import pytest
import torch

from ceph_tpu.crush.wrapper import CrushWrapper as JCrushWrapper
from ceph_tpu.ec import registry as jregistry
from ceph_tpu.ec.interface import ErasureCodeError as JErasureCodeError

from ceph_tpu_torch.crush.wrapper import CrushWrapper
from ceph_tpu_torch.ec import registry
from ceph_tpu_torch.ec.interface import ErasureCodeError
from test_torch_ref_native import ref_native_built  # noqa: F401  (autouse)

CPU = "cpu"

LRC_LAYERS = json.dumps([["_cDD_cDD", ""], ["cDDD____", ""],
                         ["____cDDD", ""]])
PROFILES = [
    ("jerasure", {"technique": "reed_sol_van", "k": "4", "m": "2",
                  "w": "8"}),
    ("jerasure", {"technique": "reed_sol_van", "k": "3", "m": "3",
                  "jerasure-per-chunk-alignment": "true"}),
    ("jerasure", {"technique": "reed_sol_r6_op", "k": "5", "m": "2"}),
    ("jerasure", {"technique": "reed_sol_van", "k": "4", "m": "2",
                  "mapping": "_DD_DD"}),
    ("isa", {"k": "8", "m": "3"}),
    ("isa", {"technique": "cauchy", "k": "4", "m": "3"}),
    ("isa", {"k": "4", "m": "2", "mapping": "DD__DD"}),
    ("lrc", {"k": "4", "m": "2", "l": "3"}),
    ("lrc", {"mapping": "__DD__DD", "layers": LRC_LAYERS}),
    ("shec", {"k": "4", "m": "3", "c": "2"}),
    ("shec", {"technique": "single", "k": "6", "m": "3", "c": "2"}),
    ("shec", {"k": "4", "m": "3", "c": "2", "w": "7"}),   # w falls back
    ("clay", {"k": "4", "m": "2"}),
    ("clay", {"k": "4", "m": "3", "d": "6"}),             # nu = 2
    ("clay", {"k": "3", "m": "2", "scalar_mds": "isa"}),
]
IDS = [f"{p}-" + "-".join(f"{k}={v}" for k, v in sorted(prof.items())
                          if k != "layers") for p, prof in PROFILES]
# the plugins with an engine= key: also held to ceph_tpu's XLA engine
BITPLANE = [(p, prof) for p, prof in PROFILES if p in ("jerasure", "isa")]


def _obj(n, seed=0):
    return np.random.default_rng(seed).integers(
        0, 256, n, dtype=np.uint8).tobytes()


def _codes(plugin, profile, engine=""):
    jprof = dict(profile, engine=engine) if engine else dict(profile)
    return (jregistry.factory(plugin, jprof),
            registry.factory(plugin, dict(profile), device=CPU))


def _np(chunk):
    assert isinstance(chunk, torch.Tensor) and chunk.dtype == torch.uint8
    assert chunk.device.type == "cpu"
    return chunk.numpy()


def _same_chunks(jchunks, pchunks):
    assert sorted(jchunks) == sorted(pchunks)
    for i in jchunks:
        assert np.array_equal(np.asarray(jchunks[i], np.uint8),
                              _np(pchunks[i])), f"chunk {i}"


def _call(fn):
    """(result, None) or (None, errno) of ``fn()``."""
    try:
        return fn(), None
    except (ErasureCodeError, JErasureCodeError) as e:
        return None, e.errno


@pytest.mark.parametrize("plugin,profile", PROFILES, ids=IDS)
def test_geometry_and_chunk_sizes(plugin, profile):
    jc, pc = _codes(plugin, profile)
    for name in ("get_chunk_count", "get_data_chunk_count",
                 "get_coding_chunk_count", "get_sub_chunk_count",
                 "get_chunk_mapping"):
        assert getattr(pc, name)() == getattr(jc, name)(), name
    align = jc.get_chunk_size(1) * jc.get_data_chunk_count()
    for size in range(1, 3 * align + 1):
        assert pc.get_chunk_size(size) == jc.get_chunk_size(size), size
    assert pc.get_profile() == jc.get_profile()


@pytest.mark.parametrize("size", [1, 5000, 31 * 1024 + 7])
@pytest.mark.parametrize("plugin,profile", PROFILES, ids=IDS)
def test_encode_unaligned_objects(plugin, profile, size):
    jc, pc = _codes(plugin, profile)
    n = jc.get_chunk_count()
    raw = _obj(size, seed=size)
    _same_chunks(jc.encode(range(n), raw), pc.encode(range(n), raw))
    # input as numpy and as a tensor, and a subset of the chunks
    want = {0, n - 1}
    arr = np.frombuffer(raw, np.uint8)
    _same_chunks(jc.encode(want, raw), pc.encode(want, arr))
    _same_chunks(jc.encode(want, raw),
                 pc.encode(want, torch.from_numpy(arr.copy())))


@pytest.mark.parametrize("plugin,profile", BITPLANE,
                         ids=[i for i, (p, _) in zip(IDS, PROFILES)
                              if p in ("jerasure", "isa")])
def test_encode_and_decode_match_xla_engine(plugin, profile):
    jc, pc = _codes(plugin, profile, engine="bitplane")
    n = jc.get_chunk_count()
    raw = _obj(3000, seed=3)
    jch = jc.encode(range(n), raw)
    _same_chunks(jch, pc.encode(range(n), raw))
    m = jc.get_coding_chunk_count()
    for erased in itertools.combinations(range(n), m):
        avail = {i: np.asarray(c) for i, c in jch.items()
                 if i not in erased}
        _same_chunks(jc.decode(set(range(n)), avail),
                     pc.decode(set(range(n)), avail))


@pytest.mark.parametrize("plugin,profile", PROFILES, ids=IDS)
def test_decode_every_erasure_set(plugin, profile):
    """Every erasure set up to the coding chunk count: the same minimum
    sets (or the same error), and the same bytes for the lost chunks
    and for every chunk."""
    jc, pc = _codes(plugin, profile)
    n = jc.get_chunk_count()
    raw = _obj(4000, seed=4)
    jch = {i: np.asarray(c, np.uint8)
           for i, c in jc.encode(range(n), raw).items()}
    decoded = 0
    for e in range(1, jc.get_coding_chunk_count() + 1):
        for erased in itertools.combinations(range(n), e):
            avail = {i: c for i, c in jch.items() if i not in erased}
            want = set(erased)
            jmin, jerr = _call(lambda: jc.minimum_to_decode(want,
                                                            set(avail)))
            pmin, perr = _call(lambda: pc.minimum_to_decode(want,
                                                            set(avail)))
            assert (pmin, perr) == (jmin, jerr), erased
            cost = {i: 1 for i in avail}
            assert _call(lambda: pc.minimum_to_decode_with_cost(
                want, cost)) == _call(lambda: jc.minimum_to_decode_with_cost(
                    want, cost)), erased
            jdec, jerr = _call(lambda: jc.decode(want, avail))
            if jerr is not None:
                assert _call(lambda: pc.decode(want, avail))[1] == jerr
                continue
            _same_chunks(jdec, pc.decode(want, avail))
            _same_chunks(jc.decode(set(range(n)), avail),
                         pc.decode(set(range(n)), avail))
            decoded += 1
    assert decoded >= n


@pytest.mark.parametrize("plugin,profile", PROFILES, ids=IDS)
def test_decode_concat(plugin, profile):
    jc, pc = _codes(plugin, profile)
    n = jc.get_chunk_count()
    raw = _obj(2500, seed=5)
    jch = {i: np.asarray(c, np.uint8)
           for i, c in jc.encode(range(n), raw).items()}
    for lost in range(n):
        avail = {i: c for i, c in jch.items() if i != lost}
        got = _np(pc.decode_concat(avail)).tobytes()
        assert got == jc.decode_concat(avail)
        assert got[:len(raw)] == raw


@pytest.mark.parametrize("plugin,profile", PROFILES, ids=IDS)
def test_encode_batched_equals_per_object_encode(plugin, profile):
    jc, pc = _codes(plugin, profile)
    n = jc.get_chunk_count()
    raws = [_obj(3000, seed=s) for s in range(4)]
    batched = pc.encode_batched(range(n), raws)
    for raw, got in zip(raws, batched):
        _same_chunks(jc.encode(range(n), raw), got)
    for raw, got, jgot in zip(raws, batched,
                              jc.encode_batched(range(n), raws)):
        _same_chunks(jgot, got)
    # mixed sizes fall back to one encode an object
    mixed = [_obj(1000, 1), _obj(2500, 2)]
    for raw, got in zip(mixed, pc.encode_batched({0, n - 1}, mixed)):
        _same_chunks(jc.encode({0, n - 1}, raw), got)
    # over a mesh (a 4-way split on the CPU): the same chunks
    from ceph_tpu_torch.parallel.placement import make_mesh

    meshed = pc.encode_batched(range(n), raws, mesh=make_mesh(["cpu"] * 4))
    for raw, got in zip(raws, meshed):
        _same_chunks(jc.encode(range(n), raw), got)


@pytest.mark.parametrize("plugin,profile", [p for p in PROFILES
                                            if p[0] == "clay"],
                         ids=[i for i, (p, _) in zip(IDS, PROFILES)
                              if p == "clay"])
def test_clay_repair_sub_chunks(plugin, profile):
    """Single-chunk repair from the sub-chunk ranges minimum_to_decode
    asks for: the same plan, the same repaired bytes."""
    jc, pc = _codes(plugin, profile)
    n = jc.get_chunk_count()
    raw = _obj(8192, seed=9)
    jch = {i: np.asarray(c, np.uint8)
           for i, c in jc.encode(range(n), raw).items()}
    chunk_size = len(jch[0])
    sc_size = chunk_size // jc.get_sub_chunk_count()
    for node in range(jc.q * jc.t):
        assert pc.get_repair_subchunks(node) == jc.get_repair_subchunks(node)
    for lost in range(n):
        rest = set(range(n)) - {lost}
        assert pc.is_repair({lost}, rest) == jc.is_repair({lost}, rest)
        assert pc.get_repair_sub_chunk_count({lost}) == \
            jc.get_repair_sub_chunk_count({lost})
        minimum = jc.minimum_to_decode({lost}, rest)
        assert pc.minimum_to_decode({lost}, rest) == minimum
        helpers = {node: np.concatenate(
            [jch[node][off * sc_size:(off + cnt) * sc_size]
             for off, cnt in ranges]) for node, ranges in minimum.items()}
        got = pc.decode({lost}, helpers, chunk_size)
        _same_chunks(jc.decode({lost}, helpers, chunk_size), got)
        assert np.array_equal(_np(got[lost]), jch[lost])


def _wrappers():
    """One sample map in both packages: 4 racks of 3 hosts of 2 OSDs,
    even OSDs of class ssd, odd of class hdd."""
    both = (CrushWrapper(), JCrushWrapper())
    dev = 0
    for rack in range(4):
        for h in range(3):
            for _ in range(2):
                loc = {"host": f"host{rack}-{h}", "rack": f"rack{rack}",
                       "root": "default"}
                for w in both:
                    w.insert_item(dev, 0x10000, f"osd.{dev}", loc)
                    w.set_item_class(dev, "ssd" if dev % 2 == 0 else "hdd")
                dev += 1
    return both


RULE_PROFILES = [
    ("jerasure", {"k": "4", "m": "2"}),
    ("isa", {"k": "4", "m": "2", "crush-failure-domain": "rack"}),
    ("isa", {"k": "4", "m": "2", "crush-device-class": "ssd"}),
    ("lrc", {"k": "4", "m": "2", "l": "3"}),
    ("lrc", {"k": "4", "m": "2", "l": "3", "crush-locality": "rack"}),
    ("lrc", {"k": "4", "m": "2", "l": "3", "crush-device-class": "hdd",
             "crush-failure-domain": "osd"}),
    ("shec", {"k": "4", "m": "3", "c": "2"}),
    ("clay", {"k": "4", "m": "2"}),
]


@pytest.mark.parametrize("plugin,profile", RULE_PROFILES,
                         ids=[f"{p}-{i}" for i, (p, _) in
                              enumerate(RULE_PROFILES)])
def test_create_rule(plugin, profile):
    w, jw = _wrappers()
    jc, pc = _codes(plugin, profile)
    rid = pc.create_rule("ecpool", w)
    assert rid == jc.create_rule("ecpool", jw)
    assert w.rule_name_map == jw.rule_name_map
    steps = [(s.op, s.arg1, s.arg2) for s in w.crush.rules[rid].steps]
    assert steps == [(s.op, s.arg1, s.arg2)
                     for s in jw.crush.rules[rid].steps]
    assert w.crush.rules[rid].type == jw.crush.rules[rid].type == 3
    n = pc.get_chunk_count()
    weight = [0x10000] * 24
    for x in range(64):
        assert w.do_rule(rid, x, n, weight) == jw.do_rule(rid, x, n,
                                                          weight), x


ERROR_PROFILES = [
    ("nope", {}),
    ("jerasure", {"technique": "nope"}),
    ("jerasure", {"technique": "reed_sol_van", "k": "1", "m": "1"}),
    ("jerasure", {"technique": "reed_sol_van", "k": "2", "m": "0"}),
    ("jerasure", {"technique": "reed_sol_van", "k": "x"}),
    ("jerasure", {"technique": "reed_sol_van", "k": "2", "m": "1",
                  "w": "9"}),
    ("jerasure", {"technique": "reed_sol_van", "k": "4", "m": "2",
                  "mapping": "DD_"}),
    ("jerasure", {"technique": "reed_sol_van", "engine": "nope"}),
    ("jerasure", {"technique": "reed_sol_van", "w": "16",
                  "engine": "native"}),
    ("jerasure", {"technique": "reed_sol_r6_op", "k": "2", "m": "3"}),
    ("jerasure", {"technique": "liberation", "k": "2", "m": "2", "w": "6",
                  "packetsize": "8"}),
    ("jerasure", {"technique": "liberation", "k": "2", "m": "2", "w": "7",
                  "packetsize": "6"}),
    ("jerasure", {"technique": "liber8tion", "k": "2", "m": "2", "w": "7",
                  "packetsize": "8"}),
    ("jerasure", {"technique": "blaum_roth", "k": "2", "m": "2", "w": "8",
                  "packetsize": "8"}),
    ("jerasure", {"technique": "cauchy_good", "engine": "native"}),
    ("isa", {"technique": "nope"}),
    ("isa", {"k": "33", "m": "2"}),
    ("isa", {"k": "8", "m": "5"}),
    ("isa", {"k": "22", "m": "4"}),
    ("isa", {"k": "1", "m": "2"}),
    ("lrc", {"k": "4", "m": "2"}),
    ("lrc", {"k": "4", "m": "2", "l": "4"}),
    ("lrc", {"k": "4", "m": "2", "l": "3", "mapping": "DD"}),
    ("lrc", {"mapping": "DD_"}),
    ("lrc", {"mapping": "DD_", "layers": "not json"}),
    ("lrc", {"mapping": "DD_", "layers": json.dumps([["DDc_", ""]])}),
    ("shec", {"k": "4", "m": "3"}),
    ("shec", {"k": "4", "m": "3", "c": "4"}),
    ("shec", {"k": "13", "m": "3", "c": "2"}),
    ("shec", {"k": "3", "m": "4", "c": "2"}),
    ("shec", {"technique": "nope"}),
    ("clay", {"k": "4", "m": "2", "d": "3"}),
    ("clay", {"k": "4", "m": "2", "scalar_mds": "nope"}),
    ("clay", {"k": "4", "m": "2", "technique": "liberation"}),
]


@pytest.mark.parametrize("plugin,profile", ERROR_PROFILES,
                         ids=[f"{p}-{i}" for i, (p, _) in
                              enumerate(ERROR_PROFILES)])
def test_bad_profiles_give_the_same_error_codes(plugin, profile):
    _, jerr = _call(lambda: jregistry.factory(plugin, dict(profile)))
    assert jerr is not None
    assert _call(lambda: registry.factory(plugin, dict(profile),
                                          device=CPU))[1] == jerr


# profiles at the w=16/32 word layouts and the packet layouts, which
# K1 (over virtual chunks) and K3 run on the card: jerasure's packet
# techniques and wide words, SHEC's wide words, an LRC layer and Clay's
# sub-codes that name a packet technique
LAYOUT_PROFILES = [
    ("jerasure", {"technique": "cauchy_good", "k": "4", "m": "3", "w": "8",
                  "packetsize": "8"}),
    ("jerasure", {"technique": "cauchy_orig", "k": "4", "m": "2"}),
    ("jerasure", {"technique": "liberation", "k": "4", "m": "2", "w": "7",
                  "packetsize": "8"}),
    ("jerasure", {"technique": "blaum_roth", "k": "4", "m": "2", "w": "6",
                  "packetsize": "8"}),
    ("jerasure", {"technique": "liber8tion", "k": "4", "m": "2",
                  "packetsize": "8"}),
    ("jerasure", {"technique": "reed_sol_van", "k": "4", "m": "2",
                  "w": "16"}),
    ("jerasure", {"technique": "reed_sol_van", "k": "4", "m": "2",
                  "w": "32"}),
    ("jerasure", {"technique": "reed_sol_r6_op", "k": "4", "m": "2",
                  "w": "16"}),
    ("shec", {"k": "4", "m": "3", "c": "2", "w": "16"}),
    ("shec", {"k": "4", "m": "3", "c": "2", "w": "32"}),
    ("clay", {"k": "4", "m": "2", "technique": "cauchy_good"}),
    ("lrc", {"mapping": "DD_", "layers": json.dumps(
        [["DDc", "technique=cauchy_good packetsize=8"]])}),
]
# ceph_tpu's jerasure test grid (tests/test_jerasure.py): every
# technique at a few (k, m, w)
JERASURE_GRID = [
    {"technique": "reed_sol_van", "k": "2", "m": "2", "w": "8"},
    {"technique": "reed_sol_van", "k": "3", "m": "2", "w": "16"},
    {"technique": "reed_sol_van", "k": "4", "m": "3", "w": "32"},
    {"technique": "reed_sol_r6_op", "k": "4", "m": "2", "w": "8"},
    {"technique": "cauchy_orig", "k": "2", "m": "2", "w": "4",
     "packetsize": "8"},
    {"technique": "cauchy_orig", "k": "4", "m": "3", "w": "8",
     "packetsize": "8"},
    {"technique": "cauchy_good", "k": "4", "m": "3", "w": "8",
     "packetsize": "8"},
    {"technique": "liberation", "k": "2", "m": "2", "w": "7",
     "packetsize": "8"},
    {"technique": "blaum_roth", "k": "2", "m": "2", "w": "6",
     "packetsize": "8"},
    {"technique": "liber8tion", "k": "2", "m": "2", "w": "8",
     "packetsize": "8"},
]


def _every_erasure_matches(plugin, profile, size, seed):
    """Geometry, an encode of an unaligned object and the decode of every
    erasure of up to m chunks (each chunk wanted), equal to ceph_tpu's:
    the same bytes, or the same error.  Returns the decodes made."""
    jc, pc = _codes(plugin, profile)
    for name in ("get_chunk_count", "get_data_chunk_count",
                 "get_sub_chunk_count", "get_chunk_mapping"):
        assert getattr(pc, name)() == getattr(jc, name)(), name
    for obj in (1, size, 3 * size + 5):
        assert pc.get_chunk_size(obj) == jc.get_chunk_size(obj), obj
    n = jc.get_chunk_count()
    raw = _obj(size, seed)
    jchunks = jc.encode(range(n), raw)
    pchunks = pc.encode(range(n), raw)
    _same_chunks(jchunks, pchunks)
    m = n - jc.get_data_chunk_count()
    decodes = 0
    for e in range(1, m + 1):
        for lost in itertools.combinations(range(n), e):
            javail = {i: c for i, c in jchunks.items() if i not in lost}
            pavail = {i: c for i, c in pchunks.items() if i not in lost}
            want, jerr = _call(lambda: jc.decode(set(range(n)), javail))
            got, perr = _call(lambda: pc.decode(set(range(n)), pavail))
            assert perr == jerr, lost
            if jerr is None:
                _same_chunks(want, got)
                decodes += 1
    return decodes


@pytest.mark.parametrize("plugin,profile", LAYOUT_PROFILES,
                         ids=[f"{p}-{i}" for i, (p, _) in
                              enumerate(LAYOUT_PROFILES)])
def test_packet_and_wide_layouts_match_jax(plugin, profile):
    """The profiles at the w=16/32 and packet layouts build, encode and
    decode every erasure of up to m chunks as ceph_tpu does."""
    assert _every_erasure_matches(plugin, profile, 5000, 3) > 0


@pytest.mark.parametrize("profile", JERASURE_GRID,
                         ids=["%s-k%s-m%s-w%s" % (p["technique"], p["k"],
                                                  p["m"], p["w"])
                              for p in JERASURE_GRID])
def test_jerasure_grid_matches_jax(profile):
    k, m = int(profile["k"]), int(profile["m"])
    assert _every_erasure_matches("jerasure", profile, 4099, 4) == sum(
        len(list(itertools.combinations(range(k + m), e)))
        for e in range(1, m + 1))


@pytest.mark.parametrize("plugin,profile", [
    ("jerasure", {"technique": "reed_sol_van", "k": "4", "m": "2"}),
    ("isa", {"k": "8", "m": "3"}),
    ("lrc", {"k": "4", "m": "2", "l": "3"}),
    ("clay", {"k": "4", "m": "2"}),
], ids=["jerasure", "isa", "lrc", "clay"])
def test_native_engine_equals_k1(plugin, profile):
    """engine=native (the host C engine, reaching LRC's layers and
    Clay's sub-codes) gives K1's bytes, on the CPU, whatever the
    device asked for."""
    pc = registry.factory(plugin, dict(profile), device=CPU)
    nc = registry.factory(plugin, dict(profile, engine="native"))
    assert nc.device.type == "cpu"
    n = pc.get_chunk_count()
    raw = _obj(6000, seed=6)
    pch = pc.encode(range(n), raw)
    _same_chunks(pch, nc.encode(range(n), raw))
    for erased in itertools.combinations(range(n), 2):
        avail = {i: c for i, c in pch.items() if i not in erased}
        got, err = _call(lambda: pc.decode(set(range(n)), avail))
        if err is not None:   # LRC: a local parity and a chunk it covers
            assert _call(lambda: nc.decode(set(range(n)), avail))[1] == err
            continue
        _same_chunks(got, nc.decode(set(range(n)), avail))


def test_registry_lists_the_five_plugins():
    assert registry.plugins() == jregistry.plugins() == \
        ["clay", "isa", "jerasure", "lrc", "shec"]
    code = registry.profile_factory({"k": "3", "m": "2"}, device=CPU)
    jcode = jregistry.profile_factory({"k": "3", "m": "2"})
    assert type(code).__name__ == type(jcode).__name__
    assert code.get_profile() == jcode.get_profile()


def test_decode_allocates_only_buffers_it_reads(monkeypatch):
    """The trivial decode copies nothing; jerasure's decode and encode
    read no zero buffer (the reference zero-fills one a chunk), while
    LRC's layers, which read theirs, still find zeros."""
    from ceph_tpu_torch.ec.interface import ChunkBuffers

    made = []
    real = ChunkBuffers.__missing__

    def counting(self, i):
        made.append(i)
        return real(self, i)

    monkeypatch.setattr(ChunkBuffers, "__missing__", counting)
    pc = registry.factory("jerasure", {"k": "4", "m": "2"}, device=CPU)
    chunks = pc.encode(range(6), _obj(4000))
    got = pc.decode({0, 1}, chunks)
    assert got[0].data_ptr() == chunks[0].data_ptr()
    avail = {i: c for i, c in chunks.items() if i not in (0, 5)}
    out = pc.decode({0, 5}, avail)
    assert torch.equal(out[0], chunks[0]) and torch.equal(out[5], chunks[5])
    assert made == []
    lrc = registry.factory("lrc", {"k": "4", "m": "2", "l": "3"},
                           device=CPU)
    lch = lrc.encode(range(8), _obj(4000))
    assert made
    out = lrc.decode({0}, {i: c for i, c in lch.items() if i != 0})
    assert torch.equal(out[0], lch[0])
