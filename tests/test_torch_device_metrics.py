"""The port's perf counters and device-plane accounting against
``ceph_tpu``'s, on the CPU.

The same sequence of calls (one-device and mesh encodes, a decode, the
batched mapper, the placement plane, the host engine) books the same
counter names and the same counts of ops, bytes, first calls, launches,
xs mapped, transferred bytes, batch sizes and shape signatures in both
packages; only the host-clock times differ.  ``sample_memory()`` never
creates a CUDA context.
"""

import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from ceph_tpu.common import device_metrics as jdm
from ceph_tpu.common import perf_counters as jpc
from ceph_tpu.crush.builder import sample_cluster_map as j_sample_map
from ceph_tpu.crush.mapper_jax import BatchedMapper as JBatchedMapper
from ceph_tpu.ec.native_gf import NativeMatrixCode as JNativeMatrixCode
from ceph_tpu.ec.rs_jax import RSCode as JRSCode
from ceph_tpu.parallel import placement as jplacement

from ceph_tpu_torch.common import device_metrics as pdm
from ceph_tpu_torch.common import perf_counters as ppc
from ceph_tpu_torch.crush.builder import sample_cluster_map
from ceph_tpu_torch.crush.mapper import BatchedMapper
from ceph_tpu_torch.ec import gf
from ceph_tpu_torch.ec.native_gf import NativeMatrixCode
from ceph_tpu_torch.ec.rs import RSCode
from ceph_tpu_torch.parallel import placement
from test_torch_ref_native import ref_native_built  # noqa: F401  (autouse)

LOGGERS = ("ec.engine", "crush.mapper", "device")
TIMES = {"encode_time", "decode_time", "jit_compile_time", "map_time",
         "kernel_time"}
LAT = {"encode_lat", "decode_lat", "map_lat"}


def _snapshot(pc_mod, dm_mod):
    dump = pc_mod.collection().dump()
    return ({k: dump[k] for k in LOGGERS}, dm_mod.shape_table(),
            dm_mod.mesh_device_table())


def _delta(before, after):
    """Counts booked between two snapshots, times left out (a latency
    histogram by its total count only: its buckets are times)."""
    (b, bs, bm), (a, as_, am) = before, after
    out = {}
    for logger in LOGGERS:
        for key, val in a[logger].items():
            if key in TIMES or key.startswith("live_buffer"):
                continue
            old = b[logger][key]
            if key in LAT:
                out[f"{logger}.{key}"] = sum(val["buckets"]) - \
                    sum(old["buckets"])
            elif isinstance(val, dict):
                out[f"{logger}.{key}"] = [x - y for x, y in
                                          zip(val["buckets"],
                                              old["buckets"])]
            else:
                out[f"{logger}.{key}"] = val - old
    shapes = {}
    for key, rec in as_.items():
        old = bs.get(key, {"count": 0, "h2d_bytes": 0, "d2h_bytes": 0})
        if rec["count"] != old["count"]:
            shapes[key] = (rec["count"] - old["count"],
                           rec["h2d_bytes"] - old["h2d_bytes"],
                           rec["d2h_bytes"] - old["d2h_bytes"])
    mesh = {}
    for did, rec in am.items():
        old = bm.get(did, {"launches": 0, "h2d_bytes": 0, "d2h_bytes": 0})
        mesh[did] = (rec["launches"] - old["launches"],
                     rec["h2d_bytes"] - old["h2d_bytes"],
                     rec["d2h_bytes"] - old["d2h_bytes"])
    return out, shapes, mesh


def _sequence(rs, bm_cls, plane_cls, native_cls, mesh, cmap):
    """One package's calls: RS(6,3) encodes at two lengths, a batched
    and a sharded encode (8 shards), a decode of two lost chunks twice,
    the batched mapper at two batch sizes, the plane twice, the host
    engine's encode and decode."""
    rng = np.random.default_rng(42)
    bc = rs._bit
    data = rng.integers(0, 256, (6, 1352), dtype=np.uint8)
    for _ in range(3):
        bc.encode(data)
    bc.encode(rng.integers(0, 256, (6, 1368), dtype=np.uint8))
    bc.encode_batched(rng.integers(0, 256, (4, 6, 1352), dtype=np.uint8))
    for _ in range(2):
        bc.encode_batched_sharded(
            rng.integers(0, 256, (5, 6, 1352), dtype=np.uint8), mesh)
    full = np.concatenate([data, np.asarray(bc.encode(data))])
    avail = {i: full[i] for i in range(9) if i not in (0, 6)}
    for _ in range(2):
        bc.decode_data(avail)
    weight = np.full(cmap.max_devices, 0x10000, np.uint32)
    bm = bm_cls(cmap)
    for n in (64, 64, 100):
        bm.map_batch(0, np.arange(n, dtype=np.uint32), 3, weight)
    plane = plane_cls(cmap, mesh=mesh)
    for _ in range(2):
        plane.map_batch(1, np.arange(100, dtype=np.uint32), 4, weight,
                        gather_stats=True)
    nat = native_cls(4, 2, gf.rs_vandermonde_matrix(4, 2)[4:])
    nd = rng.integers(0, 256, (4, 256), dtype=np.uint8)
    nfull = np.concatenate([nd, np.asarray(nat.encode(nd))])
    nat.decode_data({i: nfull[i] for i in range(1, 6)})


def test_counter_dump_equals_ceph_tpu():
    jdm.reset_for_tests()
    pdm.reset_for_tests()
    kw = dict(racks=2, hosts_per_rack=2, osds_per_host=3)
    jb = _snapshot(jpc, jdm)
    _sequence(JRSCode(6, 3), JBatchedMapper, jplacement.PlacementPlane,
              JNativeMatrixCode, jplacement.make_mesh(jax.devices()[:8]),
              j_sample_map(**kw))
    jd = _delta(jb, _snapshot(jpc, jdm))
    pb = _snapshot(ppc, pdm)
    _sequence(RSCode(6, 3, device="cpu"),
              lambda cmap: BatchedMapper(cmap, device="cpu"),
              placement.PlacementPlane, NativeMatrixCode,
              placement.make_mesh(["cpu"] * 8), sample_cluster_map(**kw))
    pd = _delta(pb, _snapshot(ppc, pdm))
    counts, shapes, mesh = pd
    assert counts == jd[0]
    assert shapes == jd[1]
    assert mesh == jd[2]
    # the sequence booked what it says
    assert counts["ec.engine.encode_ops"] == 9
    assert counts["ec.engine.decode_ops"] == 3
    assert counts["crush.mapper.map_calls"] == 5
    assert set(mesh) == set(range(8))


def test_counter_names_equal_ceph_tpu():
    jdump, pdump = jpc.collection().dump(), ppc.collection().dump()
    for logger in LOGGERS:
        assert list(pdump[logger]) == list(jdump[logger]), logger


@pytest.mark.parametrize("value", [0, 1e-6, 3e-6, 0.5, 2.0, 7, 4096, 1e9])
@pytest.mark.parametrize("min_value", [1e-6, 1])
def test_histogram_buckets_equal_ceph_tpu(value, min_value):
    j, p = jpc.PerfCounters("x"), ppc.PerfCounters("x")
    for pc in (j, p):
        pc.add_histogram("h", min_value=min_value)
        pc.add_u64_avg("a")
        pc.hist_add("h", value)
        pc.avg_add("a", value)
    assert p.dump() == j.dump()


@pytest.mark.parametrize("value", [0, 1e-6, 3e-6, 0.5, 2.0, 7, 4096,
                                   (1 << 20) - 1, 1e9])
@pytest.mark.parametrize("min_value", [1e-6, 1])
def test_update_equals_single_updates_and_ceph_tpu(value, min_value):
    """``update`` (one lock for a call's updates) books what ``inc``,
    ``tinc`` and ``hist_add`` book one by one, and what ``ceph_tpu``'s
    do."""
    j, p, q = (jpc.PerfCounters("x"), ppc.PerfCounters("x"),
               ppc.PerfCounters("x"))
    for pc in (j, p, q):
        pc.add_u64_counter("c")
        pc.add_time("t")
        pc.add_histogram("h", min_value=min_value)
    for pc in (j, p):
        pc.inc("c", 3)
        pc.tinc("t", value)
        pc.hist_add("h", value)
    q.update((("c", 3), ("t", value)), (("h", value),))
    assert q.dump() == p.dump() == j.dump()
    with pytest.raises(KeyError):
        q.update((("missing", 1),))


def test_perf_counter_types():
    pc = ppc.PerfCounters("t")
    pc.add_u64_counter("c")
    pc.add_u64("g")
    pc.add_time("t")
    pc.inc("c", 3)
    pc.set("g", 5)
    pc.dec("g")
    pc.tinc("t", 0.25)
    assert pc.dump() == {"c": 3, "g": 4, "t": 0.25}
    with pytest.raises(AssertionError, match="no key"):
        pc.inc("missing")
    with pytest.raises(AssertionError, match="not one of"):
        pc.dec("c")


def test_record_mesh_launch_splits_bytes_and_bounds_shapes():
    pdm.reset_for_tests()
    pdm.record_mesh_launch("t", "sig", 0.5, [0, 1, 2, 3], h2d_bytes=400,
                           d2h_bytes=80)
    table = pdm.mesh_device_table()
    assert table == {i: {"launches": 1, "kernel_time_s": 0.5,
                         "h2d_bytes": 100, "d2h_bytes": 20}
                     for i in range(4)}
    assert pdm.shape_table()["t|sig"]["count"] == 1
    for i in range(300):
        pdm.record_launch("t", i, 0.0)
    assert len(pdm.shape_table()) == pdm._MAX_SHAPES
    pdm.reset_for_tests()
    assert pdm.shape_table() == {} and pdm.mesh_device_table() == {}


def test_sample_memory_creates_no_cuda_context():
    """In a fresh process, sampling (and importing every module that
    books) leaves CUDA uninitialised."""
    code = (
        "import torch\n"
        "from ceph_tpu_torch.common import device_metrics as d\n"
        "import ceph_tpu_torch.ec.engine, ceph_tpu_torch.crush.mapper\n"
        "import ceph_tpu_torch.parallel.placement\n"
        "d.sample_memory()\n"
        "print(torch.cuda.is_initialized(), d._pc.dump()['live_buffers'])\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         cwd=str(__import__("pathlib").Path(__file__)
                                 .resolve().parents[1]))
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split() == ["False", "0"]
    pdm.sample_memory()
    assert not torch.cuda.is_initialized()


def test_sample_memory_reads_an_initialised_allocator(monkeypatch):
    """Once CUDA is initialised, the gauges follow the allocator of
    every card and keep their highwater."""
    stats = [{"active.all.current": 3}, {"active.all.current": 2}]
    allocated = [1000, 500]
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "memory_stats", lambda i: stats[i])
    monkeypatch.setattr(torch.cuda, "memory_allocated",
                        lambda i: allocated[i])
    pdm.reset_for_tests()
    pdm.sample_memory()
    d = pdm._pc.dump()
    assert (d["live_buffers"], d["live_buffer_bytes"],
            d["live_buffer_bytes_hw"]) == (5, 1500, 1500)
    allocated[0] = 0
    pdm.sample_memory()
    d = pdm._pc.dump()
    assert (d["live_buffer_bytes"], d["live_buffer_bytes_hw"]) == (500, 1500)


def test_per_device_and_report_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("holds the no-card rows")
    assert pdm.per_device() == []
    mesh = placement.make_mesh(["cpu"] * 2)
    pdm.reset_for_tests()
    assert placement.mesh_device_report(mesh) == [
        {"id": 0, "device": "cpu", "platform": "cpu"},
        {"id": 1, "device": "cpu", "platform": "cpu"}]


def test_cache_counters_count_rebuilds():
    """A new decode signature builds one device matrix, a lowered map
    one entry; the same calls again build nothing."""
    code = RSCode(4, 2, device="cpu")
    full = code.all_chunks(np.zeros((4, 64), np.uint8))

    def caches():
        return dict(ppc.collection().dump()["device.caches"])

    before = caches()
    code.decode({i: full[i] for i in range(6)}, [1, 4])
    mid = caches()
    code.decode({i: full[i] for i in range(6)}, [1, 4])
    assert mid["matrices"] == before["matrices"] + 1
    assert caches() == mid
    BatchedMapper(sample_cluster_map(2, 2, 2), device="cpu")
    assert caches()["lowered_maps"] == mid["lowered_maps"] + 1


def test_engine_signatures_equal_ceph_tpu():
    """The signature keys of the shape table are ceph_tpu's, string for
    string, for encode, batched encode and decode on the CPU."""
    jdm.reset_for_tests()
    pdm.reset_for_tests()
    stripes = np.random.default_rng(1).integers(0, 256, (3, 5, 96),
                                                dtype=np.uint8)
    for bc in (JRSCode(5, 1)._bit, RSCode(5, 1, device="cpu")._bit):
        bc.encode(stripes[0])
        bc.encode_batched(stripes)
        full = np.concatenate([stripes[0], np.asarray(bc.encode(
            stripes[0]))])
        bc.decode_data({i: full[i] for i in range(1, 6)})
    assert sorted(pdm.shape_table()) == sorted(jdm.shape_table())
    assert len(pdm.shape_table()) == 3
