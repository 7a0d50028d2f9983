"""The port's mesh placement plane (``ceph_tpu_torch.parallel.placement``)
against ``ceph_tpu``'s, on the CPU.

``ceph_tpu`` runs on the 8 virtual devices ``tests/conftest.py``
provisions; the port's mesh is ``make_mesh(["cpu"] * 8)``, an 8-way
split on one device.  The same xs and weights (numpy) go through
``sharded_rule_fn`` and ``PlacementPlane`` of both packages, the
unsharded ``BatchedMapper`` and the scalar ``mapper_ref``: results,
lengths and the all-reduced tally must be equal (integers: zero
tolerance), the tally int32 in both.
"""

import json
import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from ceph_tpu.crush.builder import sample_cluster_map as j_sample_map
from ceph_tpu.crush.map import CrushMap as JCrushMap
from ceph_tpu.ec.rs_jax import RSCode as JRSCode
from ceph_tpu.parallel import placement as jplacement

from ceph_tpu_torch.analysis import contracts
from ceph_tpu_torch.crush import mapper as pmapper
from ceph_tpu_torch.crush import mapper_ref
from ceph_tpu_torch.crush.builder import sample_cluster_map
from ceph_tpu_torch.crush.map import CrushMap
from ceph_tpu_torch.crush.mapper import BatchedMapper
from ceph_tpu_torch.ec.rs import RSCode
from ceph_tpu_torch.parallel import placement
from ceph_tpu_torch.parallel.placement import (PlacementPlane, make_mesh,
                                               pad_batch, sharded_rule_fn,
                                               utilization)

N_DEV = 8
GOLDEN = pathlib.Path(__file__).parent / "golden"


@pytest.fixture(scope="module")
def jmesh():
    devs = jax.devices()
    if len(devs) < N_DEV:
        pytest.skip(f"need {N_DEV} virtual devices, have {len(devs)}")
    return jplacement.make_mesh(devs[:N_DEV])


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(["cpu"] * N_DEV)


@pytest.fixture(scope="module")
def maps():
    kw = dict(racks=3, hosts_per_rack=2, osds_per_host=4)
    return j_sample_map(**kw), sample_cluster_map(**kw)


def _np(t):
    assert isinstance(t, torch.Tensor) and t.device.type == "cpu"
    return t.numpy()


def _jax_sharded(jmesh, cmap, ruleno, numrep, weight, xs, gather=True,
                 valid=None):
    """``ceph_tpu``'s sharded_rule_fn with its inputs put on the mesh."""
    fn, static, arrays = jplacement.sharded_rule_fn(
        cmap, ruleno, numrep, jmesh, gather_stats=gather,
        masked=valid is not None)
    repl = NamedSharding(jmesh, P())
    shard = NamedSharding(jmesh, P("pg"))
    A = jax.tree_util.tree_map(
        lambda a: jax.device_put(jnp.asarray(a), repl), arrays)
    args = [A, jax.device_put(jnp.asarray(np.asarray(weight, np.uint32)),
                              repl),
            jax.device_put(jnp.asarray(xs), shard)]
    if valid is not None:
        args.append(jax.device_put(jnp.asarray(valid), shard))
    return [np.asarray(o) for o in fn(*args)]


def test_sharded_equals_unsharded_equals_scalar(jmesh, mesh, maps):
    jmap, pmap = maps
    numrep = 3
    weight = [0x10000] * pmap.max_devices
    xs = np.arange(N_DEV * 16, dtype=np.uint32)
    fn, static, arrays = sharded_rule_fn(pmap, 0, numrep, mesh)
    res, lens, counts = fn(arrays, np.asarray(weight, np.uint32), xs)
    jres, jlens, jcounts = _jax_sharded(jmesh, jmap, 0, numrep, weight, xs)
    assert np.array_equal(_np(res), jres)
    assert np.array_equal(_np(lens), jlens)
    assert counts.dtype == torch.int32 and jcounts.dtype == np.int32
    assert np.array_equal(_np(counts), jcounts)
    bres, blens = BatchedMapper(pmap, device="cpu").map_batch(
        0, xs, numrep, np.asarray(weight, np.uint32))
    assert torch.equal(res, bres) and torch.equal(lens, blens)
    for i, x in enumerate(xs):
        want = mapper_ref.crush_do_rule(pmap, 0, int(x), numrep, weight)
        assert _np(res)[i, :_np(lens)[i]].tolist() == want, f"x={x}"


def test_masked_step_keeps_invalid_lanes_out_of_the_tally(jmesh, mesh,
                                                          maps):
    jmap, pmap = maps
    weight = np.full(pmap.max_devices, 0x10000, np.uint32)
    xs = np.arange(64, dtype=np.uint32)
    valid = np.arange(64) % 3 != 0
    fn, _, arrays = sharded_rule_fn(pmap, 1, 4, mesh, masked=True)
    res, lens, counts = fn(arrays, weight, xs, torch.from_numpy(valid))
    jres, jlens, jcounts = _jax_sharded(jmesh, jmap, 1, 4, weight, xs,
                                        valid=valid)
    assert np.array_equal(_np(res), jres)
    assert np.array_equal(_np(lens), jlens)
    assert np.array_equal(_np(counts), jcounts)


def test_utilization_matches_bincount_random():
    rng = np.random.default_rng(7)
    max_dev = 24
    res = rng.integers(-1, max_dev, (64, 3)).astype(np.int32)
    lens = rng.integers(0, 4, 64).astype(np.int32)
    got = _np(utilization(torch.from_numpy(res), torch.from_numpy(lens),
                          max_dev))
    jgot = np.asarray(jplacement.utilization(jnp.asarray(res),
                                             jnp.asarray(lens), max_dev))
    want = np.zeros(max_dev, np.int64)
    for i in range(64):
        for v in res[i, :lens[i]]:
            if 0 <= v < max_dev:
                want[v] += 1
    assert np.array_equal(got, want) and np.array_equal(jgot, want)


@pytest.mark.parametrize("n_dev", [1, 3, 8])
def test_sharded_ec_encode_equals_single_device(n_dev):
    """RS(4,2) over a stripe batch split on the mesh == the one-device
    encode == ``ceph_tpu``'s encode, stripe by stripe."""
    code, jcode = RSCode(4, 2, device="cpu"), JRSCode(4, 2)
    rng = np.random.default_rng(3)
    stripes = rng.integers(0, 256, (N_DEV, 4, 128), dtype=np.uint8)
    got = code._bit.encode_batched_sharded(
        stripes, make_mesh(["cpu"] * n_dev, axis_name="ec"))
    assert torch.equal(got, code._bit.encode_batched(stripes))
    for b in range(N_DEV):
        assert np.array_equal(_np(got[b]),
                              np.asarray(jcode.encode(stripes[b])))


# -- PlacementPlane ----------------------------------------------------------

@pytest.mark.parametrize("ruleno,numrep", [(0, 3), (0, 5), (1, 3), (1, 6)])
@pytest.mark.parametrize("n", [N_DEV * 8, 100])
def test_placement_plane_bit_exact_grid(jmesh, mesh, maps, ruleno, numrep,
                                        n):
    """The plane's results, lengths and tally equal ``ceph_tpu``'s plane
    across the rule 0/1 (firstn/indep) x R grid, at a batch divisible
    by the mesh and one that is not (``ceph_tpu`` pads and masks, the
    port splits unevenly)."""
    jmap, pmap = maps
    weight = np.full(pmap.max_devices, 0x10000, np.uint32)
    weight[3] = 0x8000
    xs = np.arange(n, dtype=np.uint32)
    res, lens, counts = PlacementPlane(pmap, mesh=mesh).map_batch(
        ruleno, xs, numrep, weight, gather_stats=True)
    jres, jlens, jcounts = jplacement.PlacementPlane(
        jmap, mesh=jmesh).map_batch(ruleno, xs, numrep, weight,
                                    gather_stats=True)
    assert np.array_equal(_np(res), np.asarray(jres))
    assert np.array_equal(_np(lens), np.asarray(jlens))
    assert counts.dtype == torch.int32
    assert np.array_equal(_np(counts), np.asarray(jcounts))


def test_placement_plane_choose_args_bit_exact(jmesh, mesh):
    d = json.load(open(GOLDEN / "map_tree3_chooseargs.json"))
    pmap, jmap = CrushMap.from_dict(d["map"]), JCrushMap.from_dict(d["map"])
    cargs, jcargs = pmap.choose_args["golden"], jmap.choose_args["golden"]
    case = d["cases"][0]
    n = min(64, case["x1"] - case["x0"])
    xs = np.arange(case["x0"], case["x0"] + n, dtype=np.uint32)
    weight = np.asarray(case["weight"], np.uint32)
    res, lens = PlacementPlane(pmap, choose_args=cargs, mesh=mesh) \
        .map_batch(case["ruleno"], xs, case["numrep"], weight)
    jres, jlens = jplacement.PlacementPlane(
        jmap, choose_args=jcargs, mesh=jmesh).map_batch(
            case["ruleno"], xs, case["numrep"], weight)
    assert np.array_equal(_np(res), np.asarray(jres))
    assert np.array_equal(_np(lens), np.asarray(jlens))
    for i in range(n):
        assert _np(res)[i, :_np(lens)[i]].tolist() == case["results"][i]


def test_placement_plane_single_device_mesh(maps):
    """The one-device mesh: one K2 call, the same results as the
    unsharded mapper, the tally summing to the placed replicas."""
    _, pmap = maps
    plane = PlacementPlane(pmap, mesh=make_mesh(["cpu"]))
    weight = np.full(pmap.max_devices, 0x10000, np.uint32)
    xs = np.arange(37, dtype=np.uint32)
    res, lens, counts = plane.map_batch(0, xs, 3, weight, gather_stats=True)
    bres, blens = BatchedMapper(pmap, device="cpu").map_batch(0, xs, 3,
                                                              weight)
    assert torch.equal(res, bres) and torch.equal(lens, blens)
    assert int(counts.sum()) == int(blens.sum())


@pytest.mark.parametrize("n_dev,n,shards", [(1, 37, 1), (8, 64, 8),
                                            (8, 100, 8), (8, 5, 5),
                                            (2, 1 << 10, 2)])
def test_one_rule_walk_a_non_empty_shard(maps, monkeypatch, n_dev, n,
                                         shards):
    """Each non-empty shard is one call of K2's wrapper (one launch on
    the card), and nothing maps pad lanes: the shards' xs add up to n."""
    _, pmap = maps
    calls = []
    real = placement.crush_rule_batched

    def counted(arrays, prog, weight, xs):
        calls.append(xs.numel())
        return real(arrays, prog, weight, xs)

    monkeypatch.setattr(placement, "crush_rule_batched", counted)
    plane = PlacementPlane(pmap, mesh=make_mesh(["cpu"] * n_dev))
    weight = np.full(pmap.max_devices, 0x10000, np.uint32)
    res, _ = plane.map_batch(0, np.arange(n, dtype=np.uint32), 3, weight)
    assert len(calls) == shards and sum(calls) == n
    assert res.shape == (n, 3)


def test_pad_batch_bounds_signatures():
    for n_dev in (1, 3, 8):
        pads = {pad_batch(n, n_dev) for n in range(1, 4097)}
        assert len(pads) <= 14, (n_dev, sorted(pads))
        assert all(p % n_dev == 0 for p in pads)
        assert all(pad_batch(n, n_dev) >= n for n in range(1, 4097))
        assert all(pad_batch(n, n_dev) == jplacement.pad_batch(n, n_dev)
                   for n in range(1, 600))


def test_placement_plane_steady_state(mesh, maps):
    """After warming a plane per mesh size, batches that pad to the
    warmed signature build nothing: no new signature, launch plan or
    lowered map inside the window."""
    _, pmap = maps
    weight = np.full(pmap.max_devices, 0x10000, np.uint32)
    planes = [PlacementPlane(pmap, mesh=mesh),
              PlacementPlane(pmap, mesh=make_mesh(["cpu"]))]
    for plane in planes:
        plane.map_batch(0, np.arange(64, dtype=np.uint32), 3, weight)
    base = len(contracts.recompile_violations())
    with contracts.steady_state("torch.placement.plane.mesh_sizes"):
        for plane in planes:
            for n in (64, 40, 33, 64):
                res, lens = plane.map_batch(
                    0, np.arange(n, dtype=np.uint32), 3, weight)
                assert res.shape == (n, 3)
    assert contracts.recompile_violations()[base:] == []


def test_placement_plane_new_signature_is_caught(maps):
    _, pmap = maps
    weight = np.full(pmap.max_devices, 0x10000, np.uint32)
    plane = PlacementPlane(pmap, mesh=make_mesh(["cpu"] * 2))
    plane.map_batch(0, np.arange(64, dtype=np.uint32), 3, weight)
    base = len(contracts.recompile_violations())
    with contracts.steady_state("torch.placement.plane.new_size"):
        plane.map_batch(0, np.arange(65, dtype=np.uint32), 3, weight)
    caught = contracts.recompile_violations()[base:]
    contracts.clear_recompile_violations()
    assert caught and "crush.mapper.jit_compiles" in caught[-1]["message"]


def test_golden_map_sharded(mesh):
    """The 10k-OSD golden map split 8 ways reproduces the reference C
    core's golden vectors."""
    d = json.load(open(GOLDEN / "map_big10k.json"))
    cmap = CrushMap.from_dict(d["map"])
    case = d["cases"][0]
    n = 64
    fn, _, arrays = sharded_rule_fn(cmap, case["ruleno"], case["numrep"],
                                    mesh, gather_stats=False)
    xs = np.arange(case["x0"], case["x0"] + n, dtype=np.uint32)
    res, lens = fn(arrays, np.asarray(case["weight"], np.uint32), xs)
    for i in range(n):
        assert _np(res)[i, :_np(lens)[i]].tolist() == case["results"][i]


def test_mesh_type():
    m = make_mesh(["cpu", "cpu:1", torch.device("cpu")], axis_name="ec")
    assert m.size == 3 and m.axis_names == ("ec",)
    assert m.devices == (torch.device("cpu"),) * 3
    assert m.distinct == [torch.device("cpu")] and m.device_ids == [0, 1, 2]
    assert [(i, lo, hi) for i, _, lo, hi in m.shards(7)] == \
        [(0, 0, 3), (1, 3, 6), (2, 6, 7)]
    assert m.shards(0) == []
    assert m == make_mesh(["cpu"] * 3, axis_name="ec") and len({m, m}) == 1
    with pytest.raises(ValueError):
        make_mesh([])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh()


def test_mapper_launch_counter_is_untouched_on_the_cpu(maps):
    """The plain walk is not a launch: K2's launch count stays where it
    was through a plane call on CPU tensors."""
    _, pmap = maps
    before = pmapper.crush_rule_batched.launches
    PlacementPlane(pmap, mesh=make_mesh(["cpu"] * 4)).map_batch(
        0, np.arange(16, dtype=np.uint32), 3,
        np.full(pmap.max_devices, 0x10000, np.uint32))
    assert pmapper.crush_rule_batched.launches == before
