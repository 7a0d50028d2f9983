"""The port's CrushTester against ``ceph_tpu``'s.

For every golden map and each of its rules the port's ``RuleReport``
(on the CPU: the plain walk, the native engine, the scalar mapper)
must equal ``ceph_tpu``'s ``scalar=True`` report field by field: total,
size counts, per-device stored and expected counts (exactly: the same
float64 arithmetic), bad mappings and mappings, compared as ints.  Also
with ``pool``, with ``--weight`` edits, on the rule-shape map (whose
rules leave bad mappings), against ``ceph_tpu``'s batched (JAX) report
on three cases, and for ``compare`` and ``format_report``'s text.
"""

import json

import numpy as np
import pytest
import torch

from conftest import GOLDEN_DIR

from ceph_tpu.crush.map import CrushMap as JCrushMap
from ceph_tpu.crush.wrapper import CrushWrapper as JWrapper
from ceph_tpu.tools import compiler as jcomp
from ceph_tpu.tools import tester as jtester

from ceph_tpu_torch.crush.map import CrushMap as PCrushMap
from ceph_tpu_torch.crush.wrapper import CrushWrapper as PWrapper
from ceph_tpu_torch.tools import compiler as pcomp
from ceph_tpu_torch.tools import rule_shapes
from ceph_tpu_torch.tools import tester as ptester

GOLDEN_MAPS = ("map_big10k", "map_flat12", "map_tree3", "map_weird",
               "map_list", "map_straw", "map_uniform",
               "map_tree3_chooseargs", "map_tree3_legacy")
ENGINES = {"cpu": {"device": "cpu"}, "native": {"native": True},
           "scalar": {"scalar": True}}


def golden(name):
    with open(GOLDEN_DIR / f"{name}.json") as f:
        d = json.load(f)
    return (JWrapper(JCrushMap.from_dict(d["map"])),
            PWrapper(PCrushMap.from_dict(d["map"])), d["cases"])


def golden_rules():
    """(map, ruleno, numrep, weight index) of each map's distinct
    (rule, numrep) cases."""
    out = []
    for name in GOLDEN_MAPS:
        seen = set()
        for i, c in enumerate(golden(name)[2]):
            if (c["ruleno"], c["numrep"]) not in seen:
                seen.add((c["ruleno"], c["numrep"]))
                out.append((name, c["ruleno"], c["numrep"], i))
    return out


GOLDEN_RULES = golden_rules()


def assert_same_report(got, want):
    assert (got.ruleno, got.num_rep, got.min_x, got.max_x, got.total) == \
        (want.ruleno, want.num_rep, want.min_x, want.max_x, want.total)
    assert got.size_counts == want.size_counts
    assert got.device_stored.dtype == np.int64
    assert np.array_equal(got.device_stored, want.device_stored)
    assert np.array_equal(got.device_expected, want.device_expected)
    as_ints = [(int(x), [int(o) for o in m]) for x, m in want.bad]
    assert got.bad == as_ints
    assert all(type(o) is int for _, m in got.bad for o in m)
    if want.mappings is None:
        assert got.mappings is None
    else:
        assert got.mappings == [[int(o) for o in m] for m in want.mappings]


# the port's scalar engine is left out on map_big10k, the slowest sweep:
# test_torch_crush.py holds its mapper_ref to ceph_tpu's there
GOLDEN_PARAMS = [(engine, *r) for r in GOLDEN_RULES for engine in
                 sorted(ENGINES)
                 if not (engine == "scalar" and r[0] == "map_big10k")]


@pytest.mark.parametrize("engine,name,ruleno,numrep,case", GOLDEN_PARAMS,
                         ids=[f"{e}-{n}-r{r}-n{k}"
                              for e, n, r, k, _ in GOLDEN_PARAMS])
def test_golden_report_equals_scalar(name, ruleno, numrep, case, engine):
    jw, pw, cases = golden(name)
    weight = cases[case]["weight"]
    max_x = 95 if name == "map_big10k" else 255
    want = jtester.CrushTester(jw, weight).test_rule(
        ruleno, numrep, 0, max_x, scalar=True, collect_mappings=True)
    got = ptester.CrushTester(pw, weight).test_rule(
        ruleno, numrep, 0, max_x, collect_mappings=True, **ENGINES[engine])
    assert_same_report(got, want)


@pytest.mark.parametrize("engine", sorted(ENGINES))
@pytest.mark.parametrize("pool,edits,min_x,max_x", [
    (1, {}, 0, 255), (-3, {}, 100, 300), (None, {3: 0.5, 7: 0.0}, 0, 255),
    (7, {0: 0.25, 11: 0.0, 5: 1.0}, 2 ** 31 - 64, 2 ** 31 + 63),
    (None, {}, 2 ** 32 - 128, 2 ** 32 - 1),
], ids=["pool1", "pool-3", "weights", "pool-weights-wrap", "top"])
def test_pool_and_weights(engine, pool, edits, min_x, max_x):
    jw, pw, _ = golden("map_flat12")
    jt, pt = jtester.CrushTester(jw), ptester.CrushTester(pw)
    for dev, wt in edits.items():
        jt.set_device_weight(dev, wt)
        pt.set_device_weight(dev, wt)
    assert pt.weights == jt.weights
    for ruleno, numrep in ((0, 3), (1, 4)):
        want = jt.test_rule(ruleno, numrep, min_x, max_x, pool=pool,
                            scalar=True, collect_mappings=True)
        got = pt.test_rule(ruleno, numrep, min_x, max_x, pool=pool,
                           collect_mappings=True, **ENGINES[engine])
        assert_same_report(got, want)


def shapes():
    """The rule-shape map in both packages, its bucket ``spare``
    removed (so that rule 11 takes a missing bucket)."""
    return [rule_shapes.remove_spare(comp.compile_crushmap(
        rule_shapes.text())) for comp in (jcomp, pcomp)]


@pytest.mark.parametrize("engine", sorted(ENGINES))
@pytest.mark.parametrize("ruleno,numrep", rule_shapes.CASES)
def test_rule_shapes_and_bad_mappings(engine, ruleno, numrep):
    jw, pw = shapes()
    jt, pt = jtester.CrushTester(jw), ptester.CrushTester(pw)
    for t in (jt, pt):
        t.set_device_weight(5, 0.0)
        t.set_device_weight(10, 0.5)
    want = jt.test_rule(ruleno, numrep, 0, 127, scalar=True,
                        collect_mappings=True)
    got = pt.test_rule(ruleno, numrep, 0, 127, collect_mappings=True,
                       **ENGINES[engine])
    assert_same_report(got, want)
    text = dict(show_utilization=True, show_statistics=True,
                show_bad_mappings=True, show_mappings=True)
    assert ptester.format_report(got, pw, **text) == \
        jtester.format_report(want, jw, **text)


def test_bad_rows_stay_arrays_until_read():
    _, pw = shapes()
    rep = ptester.CrushTester(pw).test_rule(7, 5, 0, 63, device="cpu")
    xs, rows, lens = rep.bad_rows
    assert isinstance(rows, np.ndarray) and rows.shape == (64, 5)
    assert (lens == 2).all() and rep.size_counts == {2: 64}
    assert rep.bad[0] == (0, rows[0, :2].tolist())
    assert rep.mappings is None


@pytest.mark.parametrize("name,ruleno,numrep", [
    ("map_flat12", 0, 3), ("map_tree3", 0, 3), ("map_big10k", 0, 3)])
def test_report_equals_the_batched_report(name, ruleno, numrep):
    """ceph_tpu's batched (JAX) sweep gives the same report; its lists
    hold numpy ints, which compare equal to the port's ints."""
    jw, pw, _ = golden(name)
    want = jtester.CrushTester(jw).test_rule(ruleno, numrep, 0, 511,
                                             collect_mappings=True)
    got = ptester.CrushTester(pw).test_rule(ruleno, numrep, 0, 511,
                                            collect_mappings=True,
                                            device="cpu")
    assert_same_report(got, want)


def reweighted(w, host_index):
    """The map with one host's items at half weight (``host_index``
    among the buckets of type 1)."""
    hosts = sorted(i for i, b in w.crush.buckets.items() if b.type == 1)
    b = w.crush.buckets[hosts[host_index]]
    for item in list(b.items):
        w.adjust_item_weight(item, b.item_weights[b.items.index(item)] // 2)
    return w


@pytest.mark.parametrize("engine", sorted(ENGINES))
@pytest.mark.parametrize("name,ruleno,numrep", [
    ("map_flat12", 0, 3), ("map_tree3", 1, 6), ("map_list", 1, 4)])
def test_compare_equal(engine, name, ruleno, numrep):
    ja, pa, _ = golden(name)
    jb, pb, _ = golden(name)
    if name == "map_flat12":
        for w in (jb, pb):
            w.adjust_item_weight(3, 0x8000)
    else:
        reweighted(jb, 1)
        reweighted(pb, 1)
    want = jtester.CrushTester(ja).compare(jtester.CrushTester(jb), ruleno,
                                           numrep, 0, 255, scalar=True)
    got = ptester.CrushTester(pa).compare(ptester.CrushTester(pb), ruleno,
                                          numrep, 0, 255, **ENGINES[engine])
    assert got == want and got[0] > 0
    same = ptester.CrushTester(pa).compare(ptester.CrushTester(pa), ruleno,
                                           numrep, 0, 255, **ENGINES[engine])
    assert same == (0, 256)


def test_engines_and_devices():
    _, pw, _ = golden("map_flat12")
    t = ptester.CrushTester(pw)
    # over a mesh (a 3-way split on the CPU): the same report, the
    # plane's tally as its per-device counts
    from ceph_tpu_torch.parallel.placement import make_mesh

    a = t.test_rule(0, 3, 0, 99, mesh=make_mesh(["cpu"] * 3),
                    collect_mappings=True)
    b = t.test_rule(0, 3, 0, 99, device="cpu", collect_mappings=True)
    assert (a.size_counts, a.mappings, a.bad) == \
        (b.size_counts, b.mappings, b.bad)
    assert np.array_equal(a.device_stored, b.device_stored)
    for kw in ({"scalar": True}, {"native": True}):
        xs, rows, lens = t.sweep(0, 3, 0, 15, **kw)
        assert rows.device.type == "cpu" and rows.shape == (16, 3)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            t.test_rule(0, 3)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            t.compare(t, 0, 3)
