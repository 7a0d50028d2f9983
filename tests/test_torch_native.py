"""The port's native CPU engine (``crush/native.py``) against
``ceph_tpu``'s and against the port's plain walk.

The same map, rule, weights and xs must give the same rows and lengths
from the port's ``NativeMapper`` (built by ``build.build_host`` from the
port's ln tables), from ``ceph_tpu``'s ``NativeMapper`` (built by
``native/Makefile``) and from the plain PyTorch walk on the CPU: on
every golden case (also against its golden vector), on leaf buckets of
every algorithm, under legacy tunables, with choose_args, on the
rule-shape map (set steps, several takes, takes of a device and of a
missing bucket) and for xs of 2^31 and above.  The build raises when it
fails and never touches ``native/``.
"""

import json

import numpy as np
import pytest
import torch

from conftest import GOLDEN_DIR

from ceph_tpu.crush.map import ChooseArg as JArg
from ceph_tpu.crush.map import ChooseArgMap as JArgs
from ceph_tpu.crush.map import CrushMap as JCrushMap
from ceph_tpu.crush.native import NativeMapper as JNative

from ceph_tpu_torch import build
from ceph_tpu_torch.crush import builder as B
from ceph_tpu_torch.crush import native
from ceph_tpu_torch.crush.map import ChooseArg, ChooseArgMap, CrushMap
from ceph_tpu_torch.crush.mapper import BatchedMapper
from ceph_tpu_torch.tools import rule_shapes
from test_torch_ref_native import ref_native_built  # noqa: F401  (autouse)

GOLDEN_MAPS = ("map_big10k", "map_flat12", "map_tree3", "map_weird",
               "map_list", "map_straw", "map_uniform",
               "map_tree3_chooseargs", "map_tree3_legacy")
EDGE_XS = np.asarray([0, 1, 2 ** 31 - 1, 2 ** 31, 2 ** 31 + 1,
                      2 ** 32 - 2, 2 ** 32 - 1], np.uint32)


def xs_with_edges(n, seed):
    rng = np.random.default_rng(seed)
    return np.concatenate([EDGE_XS, rng.integers(
        0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32)])


def three_ways(cmap, ruleno, numrep, weight, xs, choose_args=None,
               jchoose_args=None):
    """Rows of the port's engine, checked equal to ceph_tpu's and to the
    plain walk's over each row's length; the lengths equal too."""
    weight = np.asarray(weight, np.uint32)
    res, lens = native.NativeMapper(cmap, choose_args).map_batch(
        ruleno, xs, numrep, weight)
    jmap = JCrushMap.from_dict(cmap.to_dict())
    if jchoose_args is None and choose_args is not None:
        jchoose_args = jmap.choose_args.get("golden")
    jres, jlens = JNative(jmap, jchoose_args).map_batch(
        ruleno, xs, numrep, weight)
    pres, plens = BatchedMapper(cmap, choose_args, device="cpu").map_batch(
        ruleno, xs, numrep, weight)
    pres, plens = pres.numpy(), plens.numpy()
    assert np.array_equal(lens, jlens) and np.array_equal(lens, plens)
    live = np.arange(numrep)[None, :] < lens[:, None]
    assert np.array_equal(np.where(live, res, 0), np.where(live, jres, 0))
    assert np.array_equal(res, pres)   # both pad with CRUSH_ITEM_NONE
    return res, lens


def golden(name):
    with open(GOLDEN_DIR / f"{name}.json") as f:
        d = json.load(f)
    return CrushMap.from_dict(d["map"]), d["cases"]


@pytest.mark.parametrize("name", GOLDEN_MAPS)
def test_golden_cases(name):
    cmap, cases = golden(name)
    cargs = cmap.choose_args.get("golden")
    for case in cases:
        xs = np.arange(case["x0"], case["x1"], dtype=np.uint32)
        res, lens = three_ways(cmap, case["ruleno"], case["numrep"],
                               case["weight"], xs, cargs)
        for i, want in enumerate(case["results"]):
            assert res[i, :lens[i]].tolist() == want
    three_ways(cmap, cases[0]["ruleno"], cases[0]["numrep"],
               cases[0]["weight"], xs_with_edges(256, 1), cargs)


LEAF_MAKERS = {
    "uniform": lambda items, ws: B.make_uniform_bucket(items, 0x10000, 1),
    "list": lambda items, ws: B.make_list_bucket(items, ws, 1),
    "tree": lambda items, ws: B.make_tree_bucket(items, ws, 1),
    "straw": lambda items, ws: B.make_straw_bucket(items, ws, 1),
    "straw2": lambda items, ws: B.make_straw2_bucket(items, ws, 1),
}


def leaf_map(alg, tunables=None, hosts=4, per_host=5):
    """``hosts`` leaf buckets of algorithm ``alg`` under a straw2 root,
    with firstn and indep rules."""
    cmap = CrushMap(tunables)
    ids, weights = [], []
    for h in range(hosts):
        items = list(range(h * per_host, (h + 1) * per_host))
        ws = [0x10000 * (1 + (i % 3)) for i in items]
        b = LEAF_MAKERS[alg](items, ws)
        ids.append(cmap.add_bucket(b))
        weights.append(b.weight)
    root = cmap.add_bucket(B.make_straw2_bucket(ids, weights, 2))
    B.add_simple_rule(cmap, root, 1, firstn=True, ruleno=0)
    B.add_simple_rule(cmap, root, 1, firstn=False, ruleno=1)
    return cmap


@pytest.mark.parametrize("tunables", ["optimal", "legacy", "local"])
@pytest.mark.parametrize("alg", sorted(LEAF_MAKERS))
def test_bucket_algorithms_and_tunables(alg, tunables):
    tun = rule_shapes.TUNABLES[tunables]
    cmap = leaf_map(alg, tun)
    weight = np.full(cmap.max_devices, 0x10000, np.uint32)
    weight[[1, 7]] = 0
    weight[[4, 12]] = 0x8000
    for ruleno, numrep in ((0, 3), (1, 4), (0, 6)):
        three_ways(cmap, ruleno, numrep, weight, xs_with_edges(200, 2))


@pytest.mark.parametrize("positions", [1, 3])
def test_choose_args(positions):
    cmap = leaf_map("straw2")
    rng = np.random.default_rng(positions)
    cargs = ChooseArgMap()
    for i, b in sorted(cmap.buckets.items()):
        cargs[i] = ChooseArg(
            ids=[it - 1000 if it < 0 else it for it in b.items]
            if i % 2 else None,
            weight_set=[[max(1, int(w * f)) for w, f in
                         zip(b.item_weights, rng.uniform(0.5, 1.5, b.size))]
                        for _ in range(positions)])
    jargs = JArgs()
    for i, a in cargs.items():
        jargs[i] = JArg(ids=a.ids, weight_set=a.weight_set)
    weight = np.full(cmap.max_devices, 0x10000, np.uint32)
    for ruleno, numrep in ((0, 3), (1, 4)):
        three_ways(cmap, ruleno, numrep, weight, xs_with_edges(200, 3),
                   cargs, jargs)


@pytest.mark.parametrize("tunables", sorted(rule_shapes.TUNABLES))
@pytest.mark.parametrize("ruleno,numrep", rule_shapes.CASES)
def test_rule_shapes(ruleno, numrep, tunables):
    cmap = rule_shapes.rule_shapes_map(tunables)
    weight = rule_shapes.weights(cmap.max_devices)
    three_ways(cmap, ruleno, numrep, weight, xs_with_edges(160, 4))


def test_u32_wrap_maps_like_the_bit_pattern():
    cmap, cases = golden("map_flat12")
    nm = native.NativeMapper(cmap)
    w = cases[0]["weight"]
    a = nm.map_batch(0, np.asarray([2 ** 32 - 1, 2 ** 31], np.uint32), 3, w)
    b = nm.map_batch(0, [-1, -2 ** 31], 3, w)
    assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
    assert nm.do_rule(0, 2 ** 31, 3, w) == a[0][1, :a[1][1]].tolist()


def test_host_build_uses_the_ports_tables(tmp_path):
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "gen_ln_tables", GOLDEN_DIR.parent.parent / "native"
        / "gen_ln_tables.py")
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
    from ceph_tpu.crush._ln_tables import LL_TBL, RH_LH_TBL

    want = ("#pragma once\n#include <cstdint>\n\n"
            + gen.emit("CRUSH_LL_TBL", LL_TBL) + "\n\n"
            + gen.emit("CRUSH_RH_LH_TBL", RH_LH_TBL) + "\n")
    assert build.ln_tables_header() == want
    path = build.host_lib_path()
    assert path.parent == build.BUILD_DIR
    assert native.threads() >= 1
    assert path.exists()


def test_failed_build_raises(tmp_path, monkeypatch):
    bad = tmp_path / "crush_host.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(build, "HOST_SOURCE", bad)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(build, "_libs", {})
    with pytest.raises(RuntimeError, match="g\\+\\+ crush_host exited"):
        native.NativeMapper(leaf_map("straw2"))
    assert not list((tmp_path / "_build").glob("*.so"))
    assert not list((tmp_path / "_build").iterdir())   # no staging left


def test_results_are_host_arrays():
    cmap = leaf_map("list")
    res, lens = native.NativeMapper(cmap).map_batch(
        0, np.arange(5), 3, [0x10000] * cmap.max_devices)
    assert res.dtype == np.int32 and lens.dtype == np.int32
    assert res.shape == (5, 3) and not isinstance(res, torch.Tensor)
