"""The port's mesh data plane downstream of the placement plane, against
``ceph_tpu``'s, on the CPU: the stripe-batch split of the EC engine,
the plugins' and the batcher's mesh paths, ``PoolMapper(mesh=)``,
``CrushTester.test_rule(mesh=)`` and the per-position work accounting.

``ceph_tpu`` runs on the 8 virtual devices of ``tests/conftest.py``
(its jerasure and isa on ``engine=bitplane``, the engine its sharded
path needs); the port's mesh is ``make_mesh(["cpu"] * 8)``.  Every
output is bytes or integers: equal, or the test fails.
"""

import threading

import numpy as np
import pytest
import torch

import jax

from ceph_tpu.crush.builder import sample_cluster_map as j_sample_map
from ceph_tpu.crush.wrapper import CrushWrapper as JCrushWrapper
from ceph_tpu.ec.registry import factory as jfactory
from ceph_tpu.osdmap.osdmap import OSDMap as JOSDMap
from ceph_tpu.osdmap.osdmap import PgPool as JPgPool
from ceph_tpu.osdmap.pipeline_jax import PoolMapper as JPoolMapper
from ceph_tpu.parallel import placement as jplacement
from ceph_tpu.tools.tester import CrushTester as JCrushTester

from ceph_tpu_torch.analysis import contracts
from ceph_tpu_torch.common import device_metrics
from ceph_tpu_torch.crush.builder import sample_cluster_map
from ceph_tpu_torch.crush.wrapper import CrushWrapper
from ceph_tpu_torch.ec import engine, gf2_kernels
from ceph_tpu_torch.ec.batcher import EncodeBatcher
from ceph_tpu_torch.ec.registry import factory
from ceph_tpu_torch.ec.rs import RSCode
from ceph_tpu_torch.osdmap.osdmap import (OSDMap, PgPool,
                                          POOL_TYPE_ERASURE,
                                          POOL_TYPE_REPLICATED)
from ceph_tpu_torch.osdmap.pipeline import PoolMapper
from ceph_tpu_torch.parallel.placement import (data_plane, data_plane_mesh,
                                               make_mesh,
                                               mesh_device_report)
from ceph_tpu_torch.tools.tester import CrushTester
from test_torch_ref_native import ref_native_built  # noqa: F401  (autouse)

N_DEV = 8


@pytest.fixture(scope="module")
def jmesh():
    devs = jax.devices()
    if len(devs) < N_DEV:
        pytest.skip(f"need {N_DEV} virtual devices, have {len(devs)}")
    return jplacement.make_mesh(devs[:N_DEV], axis_name="ec")


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(["cpu"] * N_DEV, axis_name="ec")


# the EC corpus grid of ceph_tpu's test: every technique/w/packetsize
# family, and the layered/sub-chunked plugins that keep the concat path
PROFILES = [
    ("jerasure", {"technique": "reed_sol_van", "k": "4", "m": "2",
                  "w": "8"}),
    ("jerasure", {"technique": "reed_sol_van", "k": "3", "m": "2",
                  "w": "16"}),
    ("jerasure", {"technique": "reed_sol_van", "k": "3", "m": "2",
                  "w": "32"}),
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


def _codes(profile):
    plugin, prof = profile
    jprof = dict(prof, engine="bitplane") if plugin in ("jerasure", "isa") \
        else dict(prof)
    return jfactory(plugin, jprof), factory(plugin, dict(prof), device="cpu")


def _objects(n, size, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size, dtype=np.uint8).tobytes()
            for _ in range(n)]


def _same(jchunks, pchunks):
    assert sorted(jchunks) == sorted(pchunks)
    for i in jchunks:
        got = pchunks[i]
        assert isinstance(got, torch.Tensor) and got.dtype == torch.uint8
        assert np.asarray(jchunks[i], np.uint8).tobytes() == \
            got.numpy().tobytes(), f"chunk {i}"


# -- engine level -----------------------------------------------------------

@pytest.mark.parametrize("layout", [0, 1, 2, 3],
                         ids=["w8", "w16", "w32", "packet"])
def test_engine_sharded_byte_identical_all_layouts(mesh, layout):
    """encode_batched_sharded == ceph_tpu's per-stripe encode for every
    layout family, at divisible and non-divisible batch sizes, on the
    8-way and the one-device mesh."""
    jcode, pcode = _codes(PROFILES[layout])
    jbc, bc = jcode._code, pcode._code
    mesh1 = make_mesh(["cpu"], axis_name="ec")
    rng = np.random.default_rng(11)
    blk = bc.layout.w * bc.layout.packetsize if bc.layout.is_packet \
        else max(1, bc.layout.w // 8)
    L = 64 * blk
    for B in (8, 5, 1):
        stripes = rng.integers(0, 256, (B, bc.k, L), dtype=np.uint8)
        for m in (mesh, mesh1):
            got = bc.encode_batched_sharded(stripes, m)
            assert got.shape == (B, bc.m, L) and got.dtype == torch.uint8
            for b in range(B):
                assert got[b].numpy().tobytes() == \
                    np.asarray(jbc.encode(stripes[b])).tobytes(), (B, b)


def test_engine_sharded_equals_ceph_tpu_sharded(jmesh, mesh):
    """The same stripes through both packages' sharded encode."""
    jcode, pcode = _codes(PROFILES[0])
    stripes = np.random.default_rng(5).integers(0, 256, (6, 4, 512),
                                                dtype=np.uint8)
    got = pcode._code.encode_batched_sharded(stripes, mesh)
    want = np.asarray(jcode._code.encode_batched_sharded(stripes, jmesh))
    assert got.numpy().tobytes() == want.tobytes()


def test_engine_default_mesh_routing(mesh):
    """encode_batched with no mesh takes the process-default data-plane
    mesh, and stays on one device when none is installed or the one
    installed has one device."""
    bc = RSCode(4, 2, device="cpu")._bit
    stripes = np.random.default_rng(12).integers(0, 256, (8, 4, 1024),
                                                 dtype=np.uint8)
    ref = bc.encode_batched(stripes)
    assert data_plane_mesh() is None

    def sharded_calls():
        return sum(v["count"] for k, v in device_metrics.shape_table()
                   .items() if "encb_mesh" in k)

    before = sharded_calls()
    with data_plane(mesh):
        assert data_plane_mesh() is mesh
        got = bc.encode_batched(stripes)
    assert sharded_calls() == before + 1
    with data_plane(make_mesh(["cpu"])):
        one = bc.encode_batched(stripes)
    assert sharded_calls() == before + 1
    assert data_plane_mesh() is None
    assert torch.equal(got, ref) and torch.equal(one, ref)


def test_engine_sharded_steady_state(mesh):
    """Warmed sharded batch shapes build nothing: batches that pad to a
    warmed signature add no signature and no device matrix inside the
    window, on both mesh sizes."""
    bc = RSCode(4, 2, device="cpu")._bit
    mesh1 = make_mesh(["cpu"], axis_name="ec")
    rng = np.random.default_rng(13)
    for m in (mesh, mesh1):
        bc.encode_batched_sharded(
            rng.integers(0, 256, (8, 4, 1024), dtype=np.uint8), m)
    base = len(contracts.recompile_violations())
    with contracts.steady_state("torch.ec.encode_batched_sharded"):
        for m in (mesh, mesh1):
            for B in (8, 5, 7):
                s = rng.integers(0, 256, (B, 4, 1024), dtype=np.uint8)
                assert bc.encode_batched_sharded(s, m).shape == (B, 2, 1024)
    assert contracts.recompile_violations()[base:] == []


@pytest.mark.parametrize("B", [8, 3, 1])
def test_sharded_encode_one_product_a_non_empty_shard(mesh, monkeypatch,
                                                      B):
    """One K1 call a non-empty shard (one launch each on the card), no
    zero stripes encoded."""
    calls = []
    real = gf2_kernels.gf2_matmul_w8

    def counted(bm, data, frag=None):
        calls.append(data.shape[0])
        return real(bm, data, frag)

    monkeypatch.setattr(gf2_kernels, "gf2_matmul_w8", counted)
    bc = RSCode(4, 2, device="cpu")._bit
    stripes = np.zeros((B, 4, 256), np.uint8)
    bc.encode_batched_sharded(stripes, mesh)
    assert len(calls) == B and sum(calls) == B
    calls.clear()
    bc.encode_batched_sharded(stripes, make_mesh(["cpu"]))
    assert calls == [B]


# -- plugin + batcher level -------------------------------------------------

@pytest.mark.parametrize("profile", PROFILES, ids=IDS)
def test_plugin_encode_batched_mesh_byte_identical(mesh, profile):
    """Plugin-level encode_batched over the mesh == ceph_tpu's
    per-object encode, over the corpus grid (jerasure and isa take the
    sharded path, the layered and sub-chunked plugins the concat
    path)."""
    jcode, pcode = _codes(profile)
    n = pcode.get_chunk_count()
    want = set(range(n))
    for B, size in ((3, 4096), (5, 8192)):
        raws = _objects(B, size, seed=B)
        batched = pcode.encode_batched(want, raws, mesh=mesh)
        assert len(batched) == B
        for raw, got in zip(raws, batched):
            _same(jcode.encode(want, raw), got)


def test_plugin_mesh_path_actually_shards(mesh):
    """The jerasure mesh path really splits: every mesh position books
    a row in the per-position table, and the report shows it."""
    device_metrics.reset_for_tests()
    _, pcode = _codes(PROFILES[0])
    assert pcode._mesh_code() is pcode._code
    pcode.encode_batched(set(range(pcode.get_chunk_count())),
                         _objects(8, 4096, seed=21), mesh=mesh)
    table = device_metrics.mesh_device_table()
    assert set(mesh.device_ids) <= set(table)
    assert all(table[i]["launches"] >= 1 for i in mesh.device_ids)
    report = mesh_device_report(mesh)
    assert [r["id"] for r in report] == mesh.device_ids
    assert all(r["platform"] == "cpu" and r["kernel_launches"] >= 1
               for r in report)


@pytest.mark.parametrize("profile", [PROFILES[6], PROFILES[7], PROFILES[8]],
                         ids=IDS[6:9])
def test_layered_plugins_keep_the_concat_path(mesh, profile):
    _, pcode = _codes(profile)
    assert pcode._mesh_code() is None


def test_native_engine_keeps_the_concat_path(mesh):
    pcode = factory("isa", {"k": "4", "m": "2", "engine": "native"},
                    device="cpu")
    assert pcode._mesh_code() is None
    raws = _objects(3, 4096, seed=4)
    want = set(range(6))
    for raw, got in zip(raws, pcode.encode_batched(want, raws, mesh=mesh)):
        ref = pcode.encode(want, raw)
        assert all(torch.equal(ref[i], got[i]) for i in want)


def test_encode_batcher_mesh_coalesced_identical(mesh):
    """Concurrent encodes through an EncodeBatcher carrying the mesh:
    outputs equal ceph_tpu's encode, and at least one multi-object batch
    was dispatched."""
    jcode, pcode = _codes(PROFILES[0])
    want = set(range(pcode.get_chunk_count()))
    batcher = EncodeBatcher(max_delay_us=5000, mesh=mesh)
    raws = _objects(8, 4096, seed=3)
    base = engine._pc.dump()["ec_batch_size"]["buckets"]
    outs = [None] * len(raws)
    errs = []

    def worker(i):
        try:
            outs[i] = batcher.encode(pcode, want, raws[i])
        except Exception as e:  # surfaced below
            errs.append(e)

    ths = [threading.Thread(target=worker, args=(i,))
           for i in range(len(raws))]
    for t in ths:
        t.start()
    for t in ths:
        t.join()
    assert not errs
    for raw, got in zip(raws, outs):
        _same(jcode.encode(want, raw), got)
    cur = engine._pc.dump()["ec_batch_size"]["buckets"]
    assert sum(c - b for c, b in zip(cur[1:], base[1:])) > 0


# -- osdmap + tester sweeps -------------------------------------------------

def _osdmaps(pool_type):
    """The same OSDMap (48 OSDs, pool 1 of 100 PGs: not divisible by the
    mesh, exceptions of every kind) in both packages."""
    out = []
    for cls, mk, pool_cls in ((JOSDMap, j_sample_map, JPgPool),
                              (OSDMap, sample_cluster_map, PgPool)):
        m = cls(mk(3, 4, 4))
        for o in range(48):
            m.add_osd(o)
        if pool_type == POOL_TYPE_REPLICATED:
            pool = dict(pool_type=pool_type, size=3, pg_num=100,
                        crush_rule=0)
        else:
            pool = dict(pool_type=pool_type, size=4, pg_num=100,
                        pgp_num=72, crush_rule=1)
        m.pools[1] = pool_cls(**pool)
        m.pg_upmap[(1, 5)] = [1, 2, 3] + ([4] if pool["size"] == 4 else [])
        m.pg_upmap_items[(1, 3)] = [(0, 47)]
        m.pg_temp[(1, 7)] = [9, 10, 11]
        m.primary_temp[(1, 8)] = 12
        out.append(m)
    return out


@pytest.mark.parametrize("pool_type", [POOL_TYPE_REPLICATED,
                                       POOL_TYPE_ERASURE],
                         ids=["replicated", "erasure"])
def test_pool_mapper_mesh_equals_unsharded(jmesh, pool_type):
    """The port's PoolMapper split 8 ways (the PG axis and every
    exception table) == its unsplit pipeline == ceph_tpu's PoolMapper
    over its 8-device mesh, through upmap edits and
    refresh_tables."""
    jm, pm = _osdmaps(pool_type)
    mesh = make_mesh(["cpu"] * N_DEV)
    jpm = JPoolMapper(jm, 1, mesh=jplacement.make_mesh(jax.devices()[:8]))
    pms = [PoolMapper(pm, 1, device="cpu"), PoolMapper(pm, 1, mesh=mesh)]
    for step in range(2):
        want = {k: np.asarray(v) for k, v in jpm.map_all().items()}
        for p in pms:
            got = p.map_all()
            assert sorted(got) == sorted(want)
            for k in want:
                assert got[k].dtype == torch.int32
                assert np.array_equal(got[k].numpy(), want[k]), (step, k)
        for m in (jm, pm):
            m.pg_upmap[(1, 6)] = list(range(2, 2 + m.pools[1].size))
        jpm.refresh_tables()
        for p in pms:
            p.refresh_tables()


def test_pool_mapper_mesh_shards(monkeypatch):
    """One K2 call a shard, each over its slice of the PGs."""
    from ceph_tpu_torch.osdmap import pipeline

    _, pm = _osdmaps(POOL_TYPE_REPLICATED)
    calls = []
    real = pipeline.crush_rule_batched

    def counted(arrays, prog, weight, xs):
        calls.append(xs.numel())
        return real(arrays, prog, weight, xs)

    monkeypatch.setattr(pipeline, "crush_rule_batched", counted)
    out = PoolMapper(pm, 1, mesh=make_mesh(["cpu"] * 3)).map_all()
    assert calls == [34, 34, 32] and out["up"].shape == (100, 3)


def test_crush_tester_mesh_sweep_matches_scalar(jmesh):
    """CrushTester.test_rule over the mesh: the same mappings and the
    same tally (the plane's all-reduced counts) as the scalar sweep and
    as ceph_tpu's mesh sweep."""
    t = CrushTester(CrushWrapper(sample_cluster_map(2, 2, 4)))
    jt = JCrushTester(JCrushWrapper(j_sample_map(2, 2, 4)))
    mesh = make_mesh(["cpu"] * N_DEV)
    rep_mesh = t.test_rule(0, 3, 0, 99, mesh=mesh, collect_mappings=True)
    rep_scalar = t.test_rule(0, 3, 0, 99, scalar=True,
                             collect_mappings=True)
    jrep = jt.test_rule(0, 3, 0, 99,
                        mesh=jplacement.make_mesh(jax.devices()[:8]))
    for rep in (rep_scalar, jrep):
        assert rep_mesh.total == rep.total == 100
        assert rep_mesh.size_counts == rep.size_counts
        assert np.array_equal(rep_mesh.device_stored, rep.device_stored)
        assert rep_mesh.bad == [(x, [int(o) for o in r])
                                for x, r in rep.bad]
    assert rep_mesh.mappings == rep_scalar.mappings
    assert rep_mesh.device_stored.dtype == np.int64
    xs, rows, lens = t.sweep(1, 4, 0, 63, pool=3, mesh=mesh)
    sx, srows, slens = t.sweep(1, 4, 0, 63, pool=3, scalar=True)
    assert torch.equal(xs, sx) and torch.equal(rows, srows) and \
        torch.equal(lens, slens)
