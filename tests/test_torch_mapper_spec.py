"""The port's speculative straw2 mapper (``crush/mapper_spec.py``)
against ``ceph_tpu``'s and the golden ``do_rule`` vectors, on the CPU.

The corpus of ``tests/test_mapper_spec.py``: on every golden map, each
case ``analyze`` accepts must give the golden rows, and ``ceph_tpu``'s
speculative mapper's, on the same xs; every case must get the same
``Ineligible`` judgment (and reason) from both packages.  Then the
judgments that test names, the indep form with rejections in play (held
to the scalar ``mapper_ref``), ``flagship.spec_cross_check`` (the
speculative lowering equals the general walk on ``map_big10k`` rule 0)
and the round loop's counts.  Outputs are integers: the tolerance is
zero.
"""

import json
import random

import numpy as np
import pytest
import torch

from ceph_tpu.crush.map import CrushMap as JCrushMap
from ceph_tpu.crush.mapper_spec import Ineligible as JIneligible
from ceph_tpu.crush.mapper_spec import SpeculativeMapper as JSpeculative
from ceph_tpu.crush.mapper_spec import analyze as janalyze

from ceph_tpu_torch.crush import constants as C
from ceph_tpu_torch.crush.map import CrushMap, Rule, RuleStep
from ceph_tpu_torch.crush.mapper import BatchedMapper
from ceph_tpu_torch.crush.mapper_ref import crush_do_rule
from ceph_tpu_torch.crush.mapper_spec import (Ineligible, SpeculativeMapper,
                                              analyze, build_spec_rule_fn,
                                              make_single_spec)
from ceph_tpu_torch.flagship import BIG10K, spec_cross_check

from conftest import GOLDEN_DIR

CPU = "cpu"
MAP_FILES = [
    "map_flat12", "map_tree3", "map_tree3_chooseargs", "map_tree3_legacy",
    "map_uniform", "map_list", "map_straw", "map_weird", "map_big10k",
]
ELIGIBLE = {("map_flat12", 0), ("map_tree3", 0),
            ("map_tree3_chooseargs", 0), ("map_weird", 0),
            ("map_big10k", 0)}
INELIGIBLE = {("map_tree3_legacy", 0), ("map_uniform", 0), ("map_tree3", 2)}


def _load(name):
    with open(GOLDEN_DIR / f"{name}.json") as f:
        d = json.load(f)
    return CrushMap.from_dict(d["map"]), JCrushMap.from_dict(d["map"]), d


def _judge(fn, *args):
    """None, or the Ineligible reason."""
    try:
        fn(*args)
    except (Ineligible, JIneligible) as e:
        return str(e)
    return None


@pytest.mark.parametrize("name", MAP_FILES)
def test_golden_cases_match_jax_and_golden(name):
    cmap, jmap, d = _load(name)
    cargs = cmap.choose_args.get("golden")
    jcargs = jmap.choose_args.get("golden")
    mappers = {}
    covered = 0
    for case in d["cases"]:
        ruleno, numrep = case["ruleno"], case["numrep"]
        why = _judge(analyze, cmap, ruleno, numrep)
        assert why == _judge(janalyze, jmap, ruleno, numrep), case["ruleno"]
        if why is not None:
            continue
        if not mappers:
            mappers = {k: SpeculativeMapper(cmap, choose_args=cargs,
                                            k_tries=k, device=CPU)
                       for k in (1, 8)}
            jm = JSpeculative(jmap, choose_args=jcargs, k_tries=8)
        n = min(case["x1"] - case["x0"], 48)
        xs = np.arange(case["x0"], case["x0"] + n, dtype=np.uint32)
        weight = np.asarray(case["weight"], np.uint32)
        jres, jlens = jm.map_batch(ruleno, xs, numrep, weight)
        for k, m in mappers.items():
            res, lens = m.map_batch(ruleno, xs, numrep, weight)
            assert res.dtype == torch.int32 and lens.dtype == torch.int32
            assert np.array_equal(res.numpy(), np.asarray(jres)), k
            assert np.array_equal(lens.numpy(), np.asarray(jlens)), k
            for i in range(n):
                assert res[i, :lens[i]].tolist() == case["results"][i], \
                    (name, ruleno, int(xs[i]), k)
        covered += 1
    if any(nm == name for nm, _ in ELIGIBLE):
        assert covered > 0


def test_eligibility_judgments():
    for name, ruleno in ELIGIBLE:
        cmap, _, d = _load(name)
        numrep = next(c["numrep"] for c in d["cases"]
                      if c["ruleno"] == ruleno)
        plan = analyze(cmap, ruleno, numrep)
        assert plan.numrep == numrep
    for name, ruleno in INELIGIBLE:
        cmap, jmap, d = _load(name)
        numrep = next((c["numrep"] for c in d["cases"]
                       if c["ruleno"] == ruleno), 3)
        with pytest.raises(Ineligible) as e:
            analyze(cmap, ruleno, numrep)
        assert str(e.value) == _judge(janalyze, jmap, ruleno, numrep)
    # chooseleaf indep of type 0 is refused (the reference's out2 leak)
    cmap, _, _ = _load("map_flat12")
    root = next(b.id for b in cmap.buckets.values()
                if all(i >= 0 for i in b.items))
    cmap.rules[9] = Rule(steps=[
        RuleStep(C.CRUSH_RULE_TAKE, root, 0),
        RuleStep(C.CRUSH_RULE_CHOOSELEAF_INDEP, 4, 0),
        RuleStep(C.CRUSH_RULE_EMIT, 0, 0)])
    with pytest.raises(Ineligible, match="type 0"):
        analyze(cmap, 9, 4)
    with pytest.raises(Ineligible):
        SpeculativeMapper(cmap, device=CPU).rule_fn(9, 4)


def test_indep_with_rejections_matches_mapper_ref():
    """map_big10k rule 1 (chooseleaf indep, numrep 11) with 40 OSDs at
    weight 0: the dense rounds and their in-order commit against the
    scalar reference walk and ceph_tpu's speculative mapper."""
    cmap, jmap, d = _load("map_big10k")
    case = next(c for c in d["cases"] if c["ruleno"] == 1)
    analyze(cmap, 1, case["numrep"])
    rng = random.Random(99)
    weights = list(case["weight"])
    for _ in range(40):
        weights[rng.randrange(len(weights))] = 0
    weight = np.asarray(weights, np.uint32)
    xs = np.arange(500, 564, dtype=np.uint32)
    m = SpeculativeMapper(cmap, k_tries=1, device=CPU)
    res, lens = m.map_batch(1, xs, case["numrep"], weight)
    jres, _ = JSpeculative(jmap, k_tries=1).map_batch(1, xs, case["numrep"],
                                                      weight)
    assert np.array_equal(res.numpy(), np.asarray(jres))
    for i, x in enumerate(xs):
        want = crush_do_rule(cmap, 1, int(x), case["numrep"], list(weights))
        assert res[i, :lens[i]].tolist() == want, int(x)
    assert m.rounds >= 1 and m.syncs == m.rounds


def test_firstn_with_rejections_matches_k2_plain_walk():
    """map_big10k rule 0 with a tenth of the OSDs out or at half weight,
    so tries fail and later rounds run: equal to the general walk."""
    cmap, _, d = _load("map_big10k")
    rng = np.random.default_rng(5)
    weight = np.asarray(d["cases"][0]["weight"], np.uint32).copy()
    weight[rng.choice(weight.size, weight.size // 20, replace=False)] = 0
    weight[rng.choice(weight.size, weight.size // 20,
                      replace=False)] = 0x8000
    xs = np.arange(3000, 3512, dtype=np.uint32)
    want, wlens = BatchedMapper(cmap, device=CPU).map_batch(0, xs, 3, weight)
    for k in (1, 3, 8):
        m = SpeculativeMapper(cmap, k_tries=k, device=CPU)
        res, lens = m.map_batch(0, xs, 3, weight)
        assert torch.equal(res, want) and torch.equal(lens, wlens), k
        assert m.syncs == m.rounds >= 3


def test_spec_cross_check_and_entry_points():
    """flagship.spec_cross_check on the CPU; build_spec_rule_fn and
    make_single_spec give the mapper's function; no xs, no rows."""
    res, lens, spec = spec_cross_check(1024, device=CPU)
    assert res.shape == (1024, 3) and bool((lens == 3).all())
    assert spec.rounds >= 3 and spec.syncs == spec.rounds
    cmap, _, d = _load("map_big10k")
    assert BIG10K == GOLDEN_DIR / "map_big10k.json"
    fn, static, arrays = build_spec_rule_fn(cmap, 0, 3, device=CPU)
    weight = torch.from_numpy(np.asarray(d["cases"][0]["weight"],
                                         np.uint32).view(np.int32))
    r2, l2 = fn(arrays, weight, torch.arange(1024, dtype=torch.int32))
    assert torch.equal(r2, res) and torch.equal(l2, lens)
    single, static2, _ = make_single_spec(cmap, 0, 3, k_tries=4)
    assert single.K == 4 and static2 == static
    r0, l0 = fn(arrays, weight, torch.zeros(0, dtype=torch.int32))
    assert r0.shape == (0, 3) and l0.shape == (0,)
