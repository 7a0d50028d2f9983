"""The port's offline balancer loop (``mgr/balancer_module.py``) and
synthetic maps (``mgr/synthetic.py``) against ``ceph_tpu``'s.

``make_synthetic_map`` must give the same ``OSDMap.to_dict()`` and
wrapper for the same arguments.  ``run_offline`` and ``evaluate`` must
give the same records, the host-clock fields (``sweep_s``,
``sweep_mappings_per_sec``) aside, and the same final
``pg_upmap_items``, on synthetic maps of 16-64 OSDs with and without
device classes and a compat ``choose_args`` set.  The port runs its
batched sweep on the CPU (``PoolMapper`` with its cache across rounds,
rollbacks included) and its scalar one; ``ceph_tpu`` runs its scalar
sweep, whose records equal its batched sweep's, and once its batched
sweep (its ``PoolMapper`` compiles again whenever a table stage appears
or grows, for seconds each time).  Tolerance zero: the stddevs are the
same float sums in the same order.
"""

import json

import pytest

from ceph_tpu.mgr.balancer_module import diff_upmap_items as jdiff
from ceph_tpu.mgr.balancer_module import evaluate as jevaluate
from ceph_tpu.mgr.balancer_module import run_offline as jrun
from ceph_tpu.mgr.synthetic import make_synthetic_map as jmake
from ceph_tpu.osdmap.osdmap import OSDMap as JOSDMap

from ceph_tpu_torch.mgr.balancer_module import diff_upmap_items as pdiff
from ceph_tpu_torch.mgr.balancer_module import evaluate as pevaluate
from ceph_tpu_torch.mgr.balancer_module import run_offline as prun
from ceph_tpu_torch.mgr.synthetic import make_synthetic_map as pmake
from ceph_tpu_torch.osdmap.osdmap import OSDMap as POSDMap

TIMING = ("sweep_s", "sweep_mappings_per_sec")

MAPS = {
    "flat16": dict(n_osds=16, osds_per_host=2, hosts_per_rack=4,
                   pg_num=64, seed=1),
    "racks32": dict(n_osds=32, osds_per_host=2, hosts_per_rack=4,
                    pg_num=128, seed=2),
    "classes48": dict(n_osds=48, osds_per_host=4, hosts_per_rack=3,
                      pg_num=256, seed=3, device_classes=["ssd", "hdd"]),
    "choose_args64": dict(n_osds=64, osds_per_host=4, hosts_per_rack=4,
                          pg_num=256, seed=4, with_choose_args=True),
    "classes_args64": dict(n_osds=64, osds_per_host=4, hosts_per_rack=4,
                           pg_num=128, seed=5,
                           device_classes=["ssd", "hdd"],
                           with_choose_args=True),
    "even_rack32": dict(n_osds=32, osds_per_host=4, hosts_per_rack=2,
                        pg_num=128, seed=6, uneven=False,
                        failure_domain="rack"),
}
RUN = dict(max_deviation=1, max_iterations=10, max_rounds=6, seed=5)


def untimed(rec):
    return {k: v for k, v in rec.items() if k not in TIMING}


_JAX_RUNS = {}


def jax_run(name):
    """``ceph_tpu``'s scalar run_offline on map ``name``: (record,
    final map dict), once per map."""
    if name not in _JAX_RUNS:
        mj, wj, _ = jmake(**MAPS[name])
        rec = untimed(jrun(mj, wj, use_batched=False, **RUN))
        _JAX_RUNS[name] = rec, mj.to_dict()
    return _JAX_RUNS[name]


@pytest.mark.parametrize("name", sorted(MAPS))
def test_make_synthetic_map_equal(name):
    mj, wj, rj = jmake(**MAPS[name])
    mp, wp, rp = pmake(**MAPS[name])
    assert rj == rp
    assert mj.to_dict() == mp.to_dict()
    assert wj.to_dict() == wp.to_dict()
    # and each reads the other's file
    assert POSDMap.from_json(mj.to_json()).to_dict() == mj.to_dict()
    assert JOSDMap.from_json(mp.to_json()).to_dict() == mp.to_dict()


@pytest.mark.parametrize("use_batched", [True, False],
                         ids=["batched", "scalar"])
@pytest.mark.parametrize("name", sorted(MAPS))
def test_run_offline_equal(name, use_batched):
    want, want_map = jax_run(name)
    mp, wp, _ = pmake(**MAPS[name])
    got = prun(mp, wp, use_batched=use_batched, device="cpu", **RUN)
    assert untimed(got) == want
    assert mp.to_dict() == want_map
    assert want["upmaps"] > 0 or want["converged"]
    mj = JOSDMap.from_dict(want_map)
    assert pdiff({}, mp.pg_upmap_items) == jdiff({}, mj.pg_upmap_items)


@pytest.mark.parametrize("only_pools", [None, {2}, {1, 3}],
                         ids=["all", "pool2", "pools13"])
def test_evaluate_equal(only_pools):
    """evaluate's record with its per-pool breakdown, on a map that has
    upmap items (from a first round) and classes."""
    mj, wj, _ = jmake(**MAPS["classes48"])
    mp, wp, _ = pmake(**MAPS["classes48"])
    jrun(mj, wj, use_batched=False, max_deviation=1, max_iterations=5,
         max_rounds=1, seed=2)
    prun(mp, wp, device="cpu", max_deviation=1, max_iterations=5,
         max_rounds=1, seed=2)
    assert mp.pg_upmap_items == mj.pg_upmap_items
    want = jevaluate(mj, wj, only_pools, use_batched=False)
    for use_batched in (True, False):
        got = pevaluate(mp, wp, only_pools, use_batched=use_batched,
                        device="cpu")
        assert got == want
        assert json.dumps(got) == json.dumps(want)


def test_run_offline_equal_to_jax_batched():
    """``ceph_tpu``'s batched loop, its ``PoolMapper`` cache and
    rollbacks, against the port's, on the smallest map."""
    mj, wj, _ = jmake(**MAPS["flat16"])
    mp, wp, _ = pmake(**MAPS["flat16"])
    kw = dict(max_deviation=1, max_iterations=4, max_rounds=2, seed=9)
    want = jrun(mj, wj, use_batched=True, **kw)
    got = prun(mp, wp, use_batched=True, device="cpu", **kw)
    assert untimed(got) == untimed(want)
    assert mp.pg_upmap_items == mj.pg_upmap_items


def test_run_offline_rollback_patience():
    """Rounds that do not improve are rolled back in place and the cached
    mappers see the rolled-back tables.  Two OSDs are down: they keep
    their targets but the up sets drop them, so some proposals do not
    show in the next sweep and rounds are rejected, in both packages
    alike."""
    kw = dict(n_osds=24, osds_per_host=2, hosts_per_rack=3, pg_num=48,
              seed=2)
    run = dict(max_deviation=1, max_iterations=3, max_rounds=10, seed=0,
               patience=2)
    mj, wj, _ = jmake(**kw)
    mp, wp, _ = pmake(**kw)
    for m in (mj, mp):
        for osd in (3, 8):
            m.osd_state[osd] &= ~2   # down
    want = jrun(mj, wj, use_batched=False, **run)
    got = prun(mp, wp, device="cpu", **run)
    assert untimed(got) == untimed(want)
    assert mp.pg_upmap_items == mj.pg_upmap_items
    assert want["rejected_rounds"] > 0, want


def test_diff_upmap_items_equal():
    old = {(1, 2): [(0, 1)], (1, 5): [(3, 4), (6, 7)], (2, 0): [(1, 2)]}
    new = {(1, 2): [(0, 1)], (1, 5): [(3, 4)], (1, 9): [(8, 9)]}
    assert pdiff(old, new) == jdiff(old, new)
    assert pdiff(new, old) == jdiff(new, old)


@pytest.mark.parametrize("name", ["classes48", "classes_args64"])
def test_shadow_tree_map_arrays_equal(name):
    """The class rules TAKE shadow buckets: both packages lower such a
    map to the same arrays (bucket count, ids, widths, weights), and
    the port's plain walk over them equals ``ceph_tpu``'s scalar mapper
    on every rule."""
    from dataclasses import fields

    import numpy as np
    import torch

    from ceph_tpu.crush.map_arrays import encode_map as jencode
    from ceph_tpu.crush.mapper_ref import crush_do_rule as jdo_rule
    from ceph_tpu_torch.crush.map_arrays import as_i32, encode_map, to_device
    from ceph_tpu_torch.crush.mapper import (_rule_steps, compile_rule,
                                             crush_rule_batched)

    mj, wj, rules = jmake(**MAPS[name])
    mp, _wp, _ = pmake(**MAPS[name])
    jstatic, jarr = jencode(mj.crush)
    pstatic, parr = encode_map(mp.crush)
    assert (pstatic.max_buckets, pstatic.max_devices, pstatic.max_size) == \
        (jstatic.max_buckets, jstatic.max_devices, jstatic.max_size)
    assert pstatic.max_buckets == len(mp.crush.buckets)
    for f in fields(parr):
        assert np.array_equal(np.asarray(getattr(jarr, f.name)),
                              np.asarray(getattr(parr, f.name))), f.name
    arrays = to_device(parr, "cpu")
    weight = as_i32(np.asarray(mp.osd_weight, np.uint32), "cpu")
    xs = torch.arange(200, dtype=torch.int32)
    for rule in sorted(rules.values()):
        prog = compile_rule(pstatic, _rule_steps(mp.crush, rule), 3)
        res, lens = crush_rule_batched(arrays, prog, weight, xs)
        for x in range(200):
            assert res[x, :lens[x]].tolist() == \
                jdo_rule(mj.crush, rule, x, 3, mj.osd_weight)
