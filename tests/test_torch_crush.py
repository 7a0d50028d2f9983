"""The port's CRUSH primitives and rule walk (K2's plain version) on the
CPU, held against the reference-C golden vectors and the ``ceph_tpu``
host code.

Every output is an integer, so the tolerance is zero: hashes, ln values,
draws and OSD lists must be equal.
"""

import json

import numpy as np
import pytest
import torch

from conftest import GOLDEN_DIR

from ceph_tpu.crush import builder as jbuilder
from ceph_tpu.crush import ln as jln
from ceph_tpu.crush.map_arrays import encode_map as jencode_map

from ceph_tpu_torch.crush import hash as H
from ceph_tpu_torch.crush import ln
from ceph_tpu_torch.crush.builder import sample_cluster_map
from ceph_tpu_torch.crush.map import CrushMap
from ceph_tpu_torch.crush.map_arrays import as_i32, encode_map
from ceph_tpu_torch.crush.mapper import (BatchedMapper, build_rule_fn,
                                         compile_rule, crush_rule_batched)

CPU = "cpu"
IN_SCOPE = ["map_big10k", "map_flat12", "map_tree3", "map_weird"]
# every bucket algorithm, choose_args and legacy tunables map now
# (tests/test_torch_crush_buckets.py); these maps, given a bucket hash
# other than rjenkins1, stand for a map past what the kernel holds
OUT_OF_SCOPE = ["map_list", "map_straw", "map_uniform",
                "map_tree3_chooseargs", "map_tree3_legacy"]


def load(name):
    with open(GOLDEN_DIR / f"{name}.json") as f:
        return json.load(f)


def test_hash_matches_golden():
    cases = np.array(load("hash")["cases"], dtype=np.int64)
    a, b = torch.from_numpy(cases[:, 0]), torch.from_numpy(cases[:, 1])
    assert H.CRUSH_HASH_SEED == load("hash")["seed"]
    assert torch.equal(H.crush_hash32_2(a, b), torch.from_numpy(cases[:, 3]))
    assert torch.equal(H.crush_hash32_3(a, b, a ^ b),
                       torch.from_numpy(cases[:, 4]))
    assert torch.equal(H.crush_hash32_4(a, b, a + b, a - b),
                       torch.from_numpy(cases[:, 5]))


def test_crush_ln_full_domain_matches_golden():
    want = load("crush_ln")["ln"]
    got = ln.crush_ln(torch.arange(65536, dtype=torch.int64))
    assert got.tolist() == want
    assert torch.equal(ln.ln16_table(CPU), got)


def test_straw2_draw_matches_jax_package():
    rng = np.random.default_rng(7)
    u = rng.integers(0, 65536, 4096, dtype=np.uint32)
    w = rng.integers(0, 2 ** 32, 4096, dtype=np.uint64).astype(np.uint32)
    w[::9] = 0
    w[1::9] = 0x10000
    want = jln.straw2_draw(u, w)
    got = ln.straw2_draw(torch.from_numpy(u.astype(np.int64)),
                         torch.from_numpy(w.astype(np.int64)))
    assert np.array_equal(got.numpy(), want.astype(np.int64))


def test_sample_map_and_encoding_match_jax_package():
    cmap = sample_cluster_map(racks=3, hosts_per_rack=4, osds_per_host=4)
    jmap = jbuilder.sample_cluster_map(racks=3, hosts_per_rack=4,
                                       osds_per_host=4)
    static, arrays = encode_map(cmap)
    jstatic, jarrays = jencode_map(jmap)
    assert static.max_devices == jstatic.max_devices == 48
    assert static.algs_present == jstatic.algs_present
    assert static.tunables == jstatic.tunables
    assert static.hashes_present == tuple(sorted(set(jarrays.bhash)))
    for name in ("alg", "btype", "size", "items", "weights"):
        assert np.array_equal(getattr(arrays, name),
                              getattr(jarrays, name)), name


@pytest.mark.parametrize("name", IN_SCOPE)
def test_map_batch_matches_golden(name):
    d = load(name)
    mapper = BatchedMapper(CrushMap.from_dict(d["map"]), device=CPU)
    for case in d["cases"]:
        xs = np.arange(case["x0"], case["x1"], dtype=np.uint32)
        res, lens = mapper.map_batch(case["ruleno"], xs, case["numrep"],
                                     np.asarray(case["weight"], np.uint32))
        assert res.shape == (len(xs), case["numrep"])
        assert res.dtype == lens.dtype == torch.int32
        res, lens = res.numpy(), lens.numpy()
        for i, x in enumerate(xs):
            got = [int(v) for v in res[i, :lens[i]]]
            assert got == case["results"][i], (name, case["ruleno"], int(x))
            assert (res[i, lens[i]:] == 0x7FFFFFFF).all()


def test_rule_fn_tracks_runtime_weights():
    """A reweight goes through the weight tensor alone, like the JAX
    package's runtime arrays: marking OSDs out moves only the PGs that
    used them."""
    d = load("map_tree3")
    cmap = CrushMap.from_dict(d["map"])
    fn, static, arrays = build_rule_fn(cmap, 0, 3, device=CPU)
    xs = torch.arange(512, dtype=torch.int32)
    weight = torch.full((static.max_devices,), 0x10000, dtype=torch.int32)
    res, lens = fn(arrays, weight, xs)
    out = [3, 17]
    weight[out] = 0
    res2, lens2 = fn(arrays, weight, xs)
    for i in range(512):
        before = res[i, :lens[i]].tolist()
        after = res2[i, :lens2[i]].tolist()
        assert not set(after) & set(out)
        if not set(before) & set(out):
            assert before == after


@pytest.mark.parametrize("name", OUT_OF_SCOPE)
def test_out_of_scope_maps_raise(name):
    d = load(name)
    cmap = CrushMap.from_dict(d["map"])
    cmap.buckets[min(cmap.buckets)].hash = 1
    case = d["cases"][0]
    with pytest.raises(NotImplementedError):
        BatchedMapper(cmap, device=CPU).map_batch(
            case["ruleno"], np.arange(4, dtype=np.uint32), case["numrep"],
            np.asarray(case["weight"], np.uint32))
    with pytest.raises(NotImplementedError):
        build_rule_fn(cmap, case["ruleno"], case["numrep"], device=CPU)


def test_bucket_wider_than_the_kernel_raises():
    """A bucket past the kernel's key width is refused on both paths,
    before any walk."""
    from ceph_tpu_torch.crush.builder import add_simple_rule, \
        make_straw2_bucket
    from ceph_tpu_torch.crush.mapper import MAX_BUCKET

    cmap = CrushMap()
    n = MAX_BUCKET + 1
    root = cmap.add_bucket(make_straw2_bucket(range(n), [0x10000] * n, 1))
    add_simple_rule(cmap, root, 0, ruleno=0)
    with pytest.raises(NotImplementedError):
        BatchedMapper(cmap, device=CPU).map_batch(
            0, np.arange(4, dtype=np.uint32), 3,
            np.full(n, 0x10000, np.uint32))
    static, _ = encode_map(cmap)
    with pytest.raises(NotImplementedError):
        compile_rule(static, [(1, root, 0), (6, 0, 0), (4, 0, 0)], 3)


def test_wrapper_checks_inputs():
    cmap = sample_cluster_map()
    mapper = BatchedMapper(cmap, device=CPU)
    prog = mapper.program(0, 3)
    weight = as_i32(np.full(48, 0x10000, np.uint32), CPU)
    with pytest.raises(ValueError):
        crush_rule_batched(mapper.arrays, prog, weight,
                           torch.arange(4, dtype=torch.int64))
    with pytest.raises(ValueError):
        mapper.program(0, 33)


def test_launch_plan_is_kept_until_a_tensor_changes():
    """K2's parameter block and map pointers are built once per (arrays,
    program) and rebuilt when a field the kernel reads, or the weights
    behind its reciprocals, changes; a bad field is refused."""
    from ceph_tpu_torch.crush.mapper import _launch_plan

    mapper = BatchedMapper(sample_cluster_map(), device=CPU)
    arrays, dev = mapper.arrays, torch.device(CPU)
    prog = mapper.program(0, 3)
    p, m = _launch_plan(arrays, prog, dev)
    assert (p.B, p.S, p.result_max, p.general) == (
        *arrays.items.shape, 3, 0)
    assert m.items == arrays.items.data_ptr()
    assert _launch_plan(arrays, prog, dev) == (p, m)
    arrays.weights[0, 0] += 1  # new reciprocals
    _, m2 = _launch_plan(arrays, prog, dev)
    assert m2 is not m and m2.magic == arrays.magic.data_ptr()
    arrays.items = arrays.items.to(torch.int64)
    with pytest.raises(ValueError):
        _launch_plan(arrays, prog, dev)


def test_xs_are_u32():
    """x = -1 and x = 2**32 - 1 map identically, from numpy or torch."""
    cmap = sample_cluster_map()
    mapper = BatchedMapper(cmap, device=CPU)
    w = np.full(48, 0x10000, np.uint32)
    a, _ = mapper.map_batch(1, np.array([2 ** 32 - 1, 7], np.uint32), 6, w)
    b, _ = mapper.map_batch(1, torch.tensor([-1, 7], dtype=torch.int32), 6,
                            w)
    c, _ = mapper.map_batch(1, torch.tensor([2 ** 32 - 1, 7]), 6, w)
    assert torch.equal(a, b) and torch.equal(a, c)
