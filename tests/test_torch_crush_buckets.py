"""The port's rule walk (K2's plain version) on every bucket algorithm,
choose_args and legacy tunables, held to the golden vectors, to
``ceph_tpu``'s ``BatchedMapper`` and, for the port's scalar
``mapper_ref``, to ``ceph_tpu``'s.

Maps are built with ``ceph_tpu``'s builder and carried into the port by
``to_dict``; each runs through the port's own ``encode_map`` and
through ``convert.map_arrays_from_numpy`` of the JAX package's arrays.
The JAX mapper compiles for seconds per map and rule, so the tree,
mixed, uniform and legacy maps are held to it in
``test_torch_crush_buckets_mixed.py`` and ``..._legacy.py``, which
reuse this file's maps.  Outputs are OSD ids, so the tolerance is zero.
"""

import json

import numpy as np
import pytest
import torch

from conftest import GOLDEN_DIR

from ceph_tpu.crush import builder as jb
from ceph_tpu.crush.map import Bucket as JBucket
from ceph_tpu.crush.map import ChooseArg as JChooseArg
from ceph_tpu.crush.map import ChooseArgMap as JChooseArgMap
from ceph_tpu.crush.map import CrushMap as JCrushMap
from ceph_tpu.crush.map import Tunables as JTunables
from ceph_tpu.crush.mapper_jax import BatchedMapper as JBatchedMapper
from ceph_tpu.crush.mapper_ref import crush_do_rule as jcrush_do_rule

from ceph_tpu_torch.convert import map_arrays_from_numpy
from ceph_tpu_torch.crush.map import CrushMap
from ceph_tpu_torch.crush.map_arrays import as_i32
from ceph_tpu_torch.crush.mapper import (BatchedMapper, _rule_steps,
                                         compile_rule, crush_rule_batched)
from ceph_tpu_torch.crush.mapper_ref import crush_do_rule

CPU = "cpu"
GOLDEN = ["map_big10k", "map_flat12", "map_tree3", "map_weird", "map_list",
          "map_straw", "map_uniform", "map_tree3_chooseargs",
          "map_tree3_legacy"]


def load(name):
    with open(GOLDEN_DIR / f"{name}.json") as f:
        return json.load(f)


GOLDEN_CASES = [(name, i) for name in GOLDEN
                for i in range(len(load(name)["cases"]))]


@pytest.mark.parametrize("name,case", GOLDEN_CASES)
def test_golden_vectors(name, case):
    d = load(name)
    cmap = CrushMap.from_dict(d["map"])
    c = d["cases"][case]
    mapper = BatchedMapper(cmap, choose_args=cmap.choose_args.get("golden"),
                           device=CPU)
    xs = np.arange(c["x0"], c["x1"], dtype=np.uint32)
    res, lens = mapper.map_batch(c["ruleno"], xs, c["numrep"],
                                 np.asarray(c["weight"], np.uint32))
    res, lens = res.numpy(), lens.numpy()
    for i in range(len(xs)):
        assert res[i, :lens[i]].tolist() == c["results"][i], (name, i)
        assert (res[i, lens[i]:] == 0x7FFFFFFF).all()


# -- maps the golden corpus does not hold, from the JAX builder ---------


def _rules(cmap, root, leaf_type=1):
    jb.add_simple_rule(cmap, root, leaf_type, firstn=True, ruleno=0)
    jb.add_simple_rule(cmap, root, leaf_type, firstn=False, ruleno=1)


def tree_map():
    """Tree hosts under a tree root (as tests/test_mapper_props.py)."""
    cmap = JCrushMap()
    ids = [cmap.add_bucket(jb.make_tree_bucket(
        list(range(4 * h, 4 * h + 4)), [0x10000, 0x20000, 0x10000, 0x8000],
        1)) for h in range(3)]
    _rules(cmap, cmap.add_bucket(jb.make_tree_bucket(ids, [0x48000] * 3,
                                                     2)))
    return cmap, None


def mixed_map():
    """One host of every algorithm under a straw2 root."""
    cmap = JCrushMap()
    sw = [0x10000, 0x20000, 0x8000]
    straw = JBucket(id=0, alg=4, type=1, items=[12, 13, 14],
                    item_weights=sw, straws=jb.calc_straw(sw),
                    weight=sum(sw))
    hosts = [
        jb.make_straw2_bucket([0, 1, 2], [0x10000] * 3, 1),
        jb.make_list_bucket([3, 4, 5], [0x10000, 0x18000, 0x8000], 1),
        jb.make_tree_bucket([6, 7, 8, 15, 16], [0x10000, 0x10000, 0x20000,
                                                0x8000, 0x30000], 1),
        jb.make_uniform_bucket([9, 10, 11], 0x10000, 1),
        straw,
    ]
    ids = [cmap.add_bucket(b) for b in hosts]
    _rules(cmap, cmap.add_bucket(jb.make_straw2_bucket(
        ids, [b.weight for b in hosts], 2)))
    return cmap, None


def uniform_map():
    """Uniform hosts of 3 under a uniform root of 3: at numrep 3 every
    bucket's size is a multiple of numrep (the indep r offset)."""
    cmap = JCrushMap()
    ids = [cmap.add_bucket(jb.make_uniform_bucket(
        list(range(3 * h, 3 * h + 3)), 0x10000, 1)) for h in range(3)]
    _rules(cmap, cmap.add_bucket(jb.make_uniform_bucket(ids, 0x30000, 2)))
    return cmap, None


def legacy_map():
    """Legacy tunables over list and straw2 hosts of 8: with most OSDs
    of a host out, the draws there fail often enough for the perm
    fallback (flocal > 5) on both algorithms."""
    cmap = JCrushMap(JTunables.legacy())
    hosts = []
    for h in range(6):
        osds = list(range(8 * h, 8 * h + 8))
        mk = jb.make_list_bucket if h % 2 else jb.make_straw2_bucket
        hosts.append(mk(osds, [0x10000] * 8, 1))
    ids = [cmap.add_bucket(b) for b in hosts]
    _rules(cmap, cmap.add_bucket(jb.make_straw2_bucket(
        ids, [b.weight for b in hosts], 2)))
    return cmap, None


def chooseargs_map(positions):
    """Straw2 racks and hosts with a choose_args set of ``positions``
    weight sets and substitute ids, as the balancer writes them."""
    cmap = jb.sample_cluster_map(3, 3, 4)
    rng = np.random.default_rng(positions)
    cam = JChooseArgMap()
    for i, b in cmap.buckets.items():
        rows = [[int(w * f) for w, f in
                 zip(b.item_weights, rng.uniform(0.5, 1.5, b.size))]
                for _ in range(positions)]
        ids = [it - 100 if it < 0 else it for it in b.items] \
            if i % 2 else None
        cam[i] = JChooseArg(ids=ids, weight_set=rows)
    return cmap, cam


MAPS = {"tree": tree_map, "mixed": mixed_map, "uniform": uniform_map,
        "legacy": legacy_map, "chooseargs1": lambda: chooseargs_map(1),
        "chooseargs3": lambda: chooseargs_map(3)}
NUMREP = {"tree": 3, "mixed": 3, "uniform": 3, "legacy": 4,
          "chooseargs1": 3, "chooseargs3": 4}


def inputs(name, max_devices):
    rng = np.random.default_rng(len(name))
    weight = np.full(max_devices, 0x10000, np.uint32)
    weight[rng.choice(max_devices, max_devices // 8, replace=False)] = 0
    weight[rng.choice(max_devices, max_devices // 8, replace=False)] = \
        0x8000
    if name == "legacy":
        weight[8:14] = 0     # host 1 (list): 6 of 8 out
        weight[16:23] = 0    # host 2 (straw2): 7 of 8 out
    xs = rng.integers(0, 2 ** 32, 192, dtype=np.uint64).astype(np.uint32)
    return weight, xs


_BUILT = {}


def built(name):
    """(JAX map, JAX choose_args, the port's map, the port's choose_args,
    JAX BatchedMapper), built once per map."""
    if name not in _BUILT:
        jmap, jca = MAPS[name]()
        d = jmap.to_dict()
        if jca is not None:
            d["choose_args"] = {"1": [{"bucket_index": i, "ids": a.ids,
                                       "weight_set": a.weight_set}
                                      for i, a in sorted(jca.items())]}
        cmap = CrushMap.from_dict(d)
        ca = cmap.choose_args.get(1)
        _BUILT[name] = (jmap, jca, cmap, ca, JBatchedMapper(jmap, jca))
    return _BUILT[name]


def check_jax_parity(name, ruleno):
    """The port (its own encode and the JAX package's arrays) against
    ``ceph_tpu``'s ``BatchedMapper`` on map ``name``."""
    jmap, jca, cmap, ca, jmapper = built(name)
    numrep = NUMREP[name]
    weight, xs = inputs(name, jmap.max_devices)
    wres, wlens = jmapper.map_batch(ruleno, xs, numrep, weight)
    wres, wlens = np.asarray(wres), np.asarray(wlens)

    own = BatchedMapper(cmap, choose_args=ca, device=CPU)
    res, lens = own.map_batch(ruleno, xs, numrep, weight)
    assert np.array_equal(lens.numpy(), wlens)
    assert np.array_equal(res.numpy(), wres)

    static, arrays = map_arrays_from_numpy(*jmapper._encoded, device=CPU)
    prog = compile_rule(static, _rule_steps(cmap, ruleno), numrep)
    assert prog == own.program(ruleno, numrep)
    res2, lens2 = crush_rule_batched(arrays, prog, as_i32(weight, CPU),
                                     as_i32(xs, CPU))
    assert torch.equal(res2, res) and torch.equal(lens2, lens)


@pytest.mark.parametrize("ruleno", [0, 1])
@pytest.mark.parametrize("name", ["chooseargs1", "chooseargs3"])
def test_matches_jax_batched_mapper(name, ruleno):
    check_jax_parity(name, ruleno)


def test_legacy_map_takes_the_perm_fallback():
    """The legacy map's inputs do reach the perm fallback: with it
    switched off (fallback tries 0) some mappings change."""
    jmap, _, cmap, _, _ = built("legacy")
    weight, xs = inputs("legacy", jmap.max_devices)
    res, _ = BatchedMapper(cmap, device=CPU).map_batch(0, xs, 4, weight)
    cmap.tunables.choose_local_fallback_tries = 0
    try:
        res0, _ = BatchedMapper(cmap, device=CPU).map_batch(0, xs, 4, weight)
    finally:
        cmap.tunables.choose_local_fallback_tries = 5
    assert not torch.equal(res, res0)


@pytest.mark.parametrize("ruleno", [0, 1])
@pytest.mark.parametrize("name", sorted(MAPS))
def test_mapper_ref_matches_jax_package(name, ruleno):
    jmap, jca, cmap, ca, _ = built(name)
    numrep = NUMREP[name]
    weight, xs = inputs(name, jmap.max_devices)
    weight = weight.tolist()
    for x in xs[:64].tolist():
        assert crush_do_rule(cmap, ruleno, x, numrep, weight, ca) == \
            jcrush_do_rule(jmap, ruleno, x, numrep, weight, jca), x


@pytest.mark.parametrize("name", GOLDEN)
def test_mapper_ref_matches_golden_head(name):
    d = load(name)
    cmap = CrushMap.from_dict(d["map"])
    ca = cmap.choose_args.get("golden")
    for c in d["cases"]:
        for i, x in enumerate(range(c["x0"], min(c["x1"], c["x0"] + 48))):
            assert crush_do_rule(cmap, c["ruleno"], x, c["numrep"],
                                 c["weight"], ca) == c["results"][i]
