"""The port's upmap balancer (``osdmap/balancer.py``) against
``ceph_tpu``'s.

``calc_pg_upmaps`` runs on every map of tests/test_balancer.py (the
device-class map and ``only_pools`` among them) over several seeds, on
the port with the batched sweep (``PoolMapper`` on the CPU) and with
the scalar one, against ``ceph_tpu``'s scalar sweep; on two maps also
against ``ceph_tpu``'s batched sweep (its ``PoolMapper`` compiles for
seconds a pool and a table shape, so it runs where it adds a case, not
on every seed).  The return count and ``pg_upmap_items`` must be equal.
So must ``do_crush_compat``'s scores and weight-set rows, and the tally
helpers' dicts, keys in the same order: the deviations are float sums in
that order, and a change is kept on a strict ``<`` of them.  Tolerance
zero.
"""

import pytest
import torch

import ceph_tpu.crush.wrapper as jwrapper
import ceph_tpu.mgr.synthetic as jsynth
import ceph_tpu.osdmap.balancer as jbal
import ceph_tpu.osdmap.osdmap as josdmap

import ceph_tpu_torch.crush.wrapper as pwrapper
import ceph_tpu_torch.mgr.synthetic as psynth
import ceph_tpu_torch.osdmap.balancer as pbal
import ceph_tpu_torch.osdmap.osdmap as posdmap

JAX = (jwrapper, josdmap, jsynth)
PORT = (pwrapper, posdmap, psynth)


def make_cluster(pkg, hosts=4, osds_per_host=4, pg_num=256, size=3):
    """tests/test_balancer.py's cluster: root -> hosts -> osds."""
    W, O, _ = pkg
    w = W.CrushWrapper()
    dev = 0
    for h in range(hosts):
        for _ in range(osds_per_host):
            w.insert_item(dev, 0x10000, f"osd.{dev}",
                          {"host": f"host{h}", "root": "default"})
            dev += 1
    rid = w.add_simple_rule("repl", "default", "host", "", "firstn")
    m = O.OSDMap(w.crush)
    for d in range(dev):
        m.add_osd(d)
    m.pools[1] = O.PgPool(size=size, pg_num=pg_num, crush_rule=rid)
    return m, w, rid


def _reduces(pkg):
    m, w, _ = make_cluster(pkg, 4, 4, 256)
    return m, w, dict(max_deviation=1, max_iterations=20)


def _converges(pkg):
    m, w, _ = make_cluster(pkg, 4, 4, 128)
    return m, w, dict(max_deviation=2, max_iterations=50)


def _only_pools(pkg):
    m, w, rid = make_cluster(pkg, pg_num=64)
    m.pools[2] = pkg[1].PgPool(size=3, pg_num=64, crush_rule=rid)
    return m, w, dict(max_deviation=1, max_iterations=10, only_pools={2})


def _out_osd(pkg):
    m, w, _ = make_cluster(pkg, pg_num=64)
    m.osd_weight[3] = 0
    return m, w, dict(max_deviation=1, max_iterations=10)


def _heavy_osd(pkg):
    m, w, _ = make_cluster(pkg, 4, 4, 128)
    w.adjust_item_weight(0, 0x20000)
    return m, w, dict(max_deviation=1, max_iterations=15)


def _classes(pkg):
    m, w, _ = pkg[2].make_synthetic_map(
        n_osds=16, osds_per_host=2, hosts_per_rack=4, pg_num=64, seed=5,
        device_classes=["ssd", "hdd"])
    return m, w, dict(max_deviation=1, max_iterations=20, only_pools={2})


def _classes_all_pools(pkg):
    m, w, _ = pkg[2].make_synthetic_map(
        n_osds=24, osds_per_host=2, hosts_per_rack=3, pg_num=64, seed=6,
        device_classes=["ssd", "hdd"])
    return m, w, dict(max_deviation=1, max_iterations=20)


def _balanced(pkg):
    m, w, _ = make_cluster(pkg, pg_num=16)
    return m, w, dict(max_deviation=1000)


def _with_upmaps(pkg):
    """Items already present: the search drops and cancels pairs too."""
    m, w, _ = make_cluster(pkg, 4, 4, 128)
    w.adjust_item_weight(5, 0x30000)
    m.pg_upmap_items[(1, 3)] = [(m.pg_to_up_acting_osds(1, 3)[0][0], 5)]
    m.pg_upmap_items[(1, 9)] = [(m.pg_to_up_acting_osds(1, 9)[0][1], 5)]
    m.pg_upmap[(1, 11)] = [0, 4, 8]
    return m, w, dict(max_deviation=1, max_iterations=25)


MAPS = {f.__name__[1:]: f for f in (
    _reduces, _converges, _only_pools, _out_osd, _heavy_osd, _classes,
    _classes_all_pools, _balanced, _with_upmaps)}
SEEDS = (0, 7, 11)


def run_calc(pkg, case, seed, use_batched):
    m, w, kw = MAPS[case](pkg)
    extra = {"device": "cpu"} if pkg is PORT else {}
    bal = pbal if pkg is PORT else jbal
    n = bal.calc_pg_upmaps(m, wrapper=w, use_batched=use_batched,
                           seed=seed, **kw, **extra)
    return n, dict(m.pg_upmap_items)


_JAX_SCALAR = {}


def jax_scalar(case, seed):
    key = (case, seed)
    if key not in _JAX_SCALAR:
        _JAX_SCALAR[key] = run_calc(JAX, case, seed, False)
    return _JAX_SCALAR[key]


@pytest.mark.parametrize("use_batched", [True, False],
                         ids=["batched", "scalar"])
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("case", sorted(MAPS))
def test_calc_pg_upmaps_equal(case, seed, use_batched):
    want = jax_scalar(case, seed)
    got = run_calc(PORT, case, seed, use_batched)
    assert got == want
    if case != "balanced":
        assert want[0] > 0


@pytest.mark.parametrize("case", ["heavy_osd", "classes"])
def test_calc_pg_upmaps_equal_to_jax_batched(case):
    """``ceph_tpu``'s batched sweep (its ``PoolMapper``) against the
    port's: the same proposals."""
    want = run_calc(JAX, case, 3, True)
    assert run_calc(PORT, case, 3, True) == want
    assert want == run_calc(JAX, case, 3, False) and want[0] > 0


@pytest.mark.parametrize("case", ["reduces", "classes_all_pools",
                                  "out_osd", "with_upmaps"])
def test_tally_helpers_equal(case):
    """get_rule_weight_osd_map, target_osd_weights, build_pgs_by_osd
    (both sweeps) and distribution_score: equal values and key order."""
    mj, wj, kw = MAPS[case](JAX)
    mp, wp, _ = MAPS[case](PORT)
    only = kw.get("only_pools")
    for rule in sorted(mj.crush.rules):
        a = jbal.get_rule_weight_osd_map(wj, rule)
        b = pbal.get_rule_weight_osd_map(wp, rule)
        assert list(a.items()) == list(b.items())
    ja = jbal.target_osd_weights(mj, wj, only)
    pa = pbal.target_osd_weights(mp, wp, only)
    assert ja == pa and list(ja[0]) == list(pa[0])
    jt = jbal.build_pgs_by_osd(mj, only)
    for use_batched in (True, False):
        pt = pbal.build_pgs_by_osd(mp, only, use_batched, device="cpu")
        assert pt == jt and list(pt) == list(jt)
        assert all(type(o) is int and all(type(g[0]) is int and
                                          type(g[1]) is int for g in pgs)
                   for o, pgs in pt.items())
    assert jbal.distribution_score(mj, ja[0], only, jt) == \
        pbal.distribution_score(mp, pa[0], only)


def test_tally_mapper_cache_sees_edits():
    """A cached ``PoolMapper`` lowers its tables again on each sweep: an
    edit and its rollback show in the next tallies."""
    m, w, _ = _heavy_osd(PORT)
    mj, _wj, _ = _heavy_osd(JAX)
    mappers = {}
    first = pbal.build_pgs_by_osd(m, None, True, mappers, device="cpu")
    pm = mappers[1]
    up = m.pg_to_up_acting_osds(1, 4)[0]
    m.pg_upmap_items[(1, 4)] = [(up[0], next(o for o in range(16)
                                              if o not in up))]
    mj.pg_upmap_items[(1, 4)] = list(m.pg_upmap_items[(1, 4)])
    edited = pbal.build_pgs_by_osd(m, None, True, mappers, device="cpu")
    assert mappers[1] is pm
    assert edited == jbal.build_pgs_by_osd(mj) != first
    m.pg_upmap_items.clear()
    assert pbal.build_pgs_by_osd(m, None, True, mappers,
                                 device="cpu") == first


@pytest.mark.parametrize("case", ["only_pools", "classes_all_pools"])
def test_defaults_take_the_batched_sweep(case, monkeypatch):
    """Called without ``use_batched`` or ``device``, ``build_pgs_by_osd``
    and ``calc_pg_upmaps`` ask for the card and sweep with one
    ``PoolMapper.map_all`` a selected pool; ``do_crush_compat`` sweeps
    with the scalar pipeline and asks for no device.  The card asked for
    is handed out here as the CPU."""
    asked, swept = [], []
    real = pbal.PoolMapper.map_all

    def resolve(device="cuda"):
        asked.append(str(device))
        return torch.device("cpu")

    def map_all(pm, *a, **k):
        swept.append(pm.pool_id)
        return real(pm, *a, **k)

    monkeypatch.setattr(pbal, "resolve_device", resolve)
    monkeypatch.setattr(pbal.PoolMapper, "map_all", map_all)
    m, w, kw = MAPS[case](PORT)
    only = kw.get("only_pools")
    pools = sorted(p for p in m.pools if not only or p in only)
    tally = pbal.build_pgs_by_osd(m, only)
    assert (asked, swept) == (["cuda"], pools)
    assert tally == pbal.build_pgs_by_osd(m, only, use_batched=False)
    asked.clear(), swept.clear()
    got = pbal.calc_pg_upmaps(m, wrapper=w, seed=7, **kw)
    assert (asked, swept) == (["cuda"], pools)
    assert (got, dict(m.pg_upmap_items)) == jax_scalar(case, 7)
    asked.clear(), swept.clear()
    mp, wp, _ = MAPS[case](PORT)
    pbal.do_crush_compat(mp, wrapper=wp, max_iterations=2,
                         only_pools=only)
    assert (asked, swept) == ([], [])


@pytest.mark.parametrize("case", ["reduces", "classes_all_pools"])
def test_do_crush_compat_equal(case):
    """crush-compat: equal scores and choose_args rows, installed on the
    same pools."""
    kw = dict(max_iterations=15, step=0.5, max_misplaced=0.5)
    mj, wj, _ = MAPS[case](JAX)
    mp, wp, _ = MAPS[case](PORT)
    js0, js1, jcam = jbal.do_crush_compat(mj, wrapper=wj, **kw)
    ps0, ps1, pcam = pbal.do_crush_compat(mp, wrapper=wp, **kw)
    assert (js0, js1) == (ps0, ps1)
    assert jcam is not None and js1 < js0
    assert {k: (v.ids, v.weight_set) for k, v in jcam.items()} == \
        {k: (v.ids, v.weight_set) for k, v in pcam.items()}
    assert sorted(map(str, mj.crush.choose_args)) == \
        sorted(map(str, mp.crush.choose_args))
    assert mj.to_dict() == mp.to_dict()


def test_weight_set_to_choose_args_equal():
    mj, wj, _ = make_cluster(JAX, 2, 2, 8)
    mp, wp, _ = make_cluster(PORT, 2, 2, 8)
    ws = {0: 1.0, 1: 0.5, 2: 1.0, 3: 1.0}
    a = jbal.weight_set_to_choose_args(wj, ws)
    b = pbal.weight_set_to_choose_args(wp, ws)
    assert {k: (v.ids, v.weight_set) for k, v in a.items()} == \
        {k: (v.ids, v.weight_set) for k, v in b.items()}


def test_try_pg_upmap_equal():
    """pg_to_raw_upmap and try_pg_upmap on every PG of the heavy map."""
    mj, wj, _ = _heavy_osd(JAX)
    mp, wp, _ = _heavy_osd(PORT)
    over, under = {0, 1}, [12, 13, 14, 15, 8]
    for ps in range(128):
        assert jbal.pg_to_raw_upmap(mj, 1, ps) == \
            pbal.pg_to_raw_upmap(mp, 1, ps)
        assert jbal.try_pg_upmap(mj, wj, 1, ps, over, under, [9]) == \
            pbal.try_pg_upmap(mp, wp, 1, ps, over, under, [9])
