"""The port's placement pipeline (``osdmap.pipeline.PoolMapper``) against
``ceph_tpu``'s batched ``PoolMapper`` and its scalar
``OSDMap.pg_to_up_acting_osds``, across every stage; the port's own
scalar ``OSDMap`` against the latter too.

The scenarios mirror tests/test_osdmap.py (the reference's
TestOSDMap.cc): down, out and nonexistent OSDs, pg_upmap and
pg_upmap_items with their rejection rules, pg_temp and primary_temp,
primary affinity, replicated (shifting) and erasure (positional) pools,
pg_num 128 with a pgp_num that is not a power of two.  State is built
with the JAX package and carried into the port by the port's
``OSDMap.from_dict``.  All six outputs, every PG, tolerance
zero.

The JAX ``PoolMapper`` compiles for seconds and compiles out the stages
no PG uses.  So each pool's JAX program is compiled once with every
stage in, and a scenario hands it its own tables, with inactive rows
(no entry) for a stage it does not use: the JAX package's own padding
(``PoolMapper._pad_trow``), which engages no stage.  The scenario with
every stage in use builds a JAX ``PoolMapper`` of its own.  The case
on ``map_big10k`` is in ``test_torch_osdmap_big10k.py``.
"""

import copy
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import GOLDEN_DIR

from ceph_tpu.crush.builder import sample_cluster_map
from ceph_tpu.crush.constants import CRUSH_ITEM_NONE as NONE
from ceph_tpu.crush.map import CrushMap as JCrushMap
from ceph_tpu.osdmap import pipeline_jax
from ceph_tpu.osdmap.osdmap import (OSDMap, PgPool, POOL_TYPE_ERASURE,
                                    POOL_TYPE_REPLICATED)

from ceph_tpu_torch.osdmap.osdmap import OSDMap as PortOSDMap
from ceph_tpu_torch.osdmap.pipeline import PoolMapper

CPU = "cpu"
POOLS = [1, 2]
KEYS = ("up", "up_len", "up_primary", "acting", "acting_len",
        "acting_primary")


def make_map(n_osd=48, pg_num=128):
    cmap = sample_cluster_map(3, 4, 4)
    m = OSDMap(cmap)
    for o in range(n_osd):
        m.add_osd(o)
    m.pools[1] = PgPool(pool_type=POOL_TYPE_REPLICATED, size=3,
                        pg_num=pg_num, pgp_num=100, crush_rule=0)
    m.pools[2] = PgPool(pool_type=POOL_TYPE_ERASURE, size=6,
                        pg_num=pg_num, pgp_num=96, crush_rule=1)
    return m


def big10k_map():
    with open(GOLDEN_DIR / "map_big10k.json") as f:
        cmap = JCrushMap.from_dict(json.load(f)["map"])
    m = OSDMap(cmap)
    for o in range(cmap.max_devices):
        m.add_osd(o)
    m.pools[1] = PgPool(pool_type=POOL_TYPE_REPLICATED, size=3,
                        pg_num=1024, crush_rule=0)
    m.pools[2] = PgPool(pool_type=POOL_TYPE_ERASURE, size=11,
                        pg_num=1024, pgp_num=768, crush_rule=1)
    return m


PAIRS = 2  # the widest pg_upmap_items entry a scenario holds
_JAX = {}


def jax_pipeline(kind, pool_id):
    """``ceph_tpu``'s PoolMapper for ``pool_id`` with every stage
    compiled in: built on a copy of the scenario base map with one entry
    of each table and a primary affinity."""
    key = (kind, pool_id)
    if key not in _JAX:
        t = make_map() if kind == "sample" else big10k_map()
        size = t.pools[pool_id].size
        t.pg_upmap[(pool_id, 0)] = list(range(size))
        t.pg_upmap_items[(pool_id, 0)] = [(0, 1)] * PAIRS
        t.pg_temp[(pool_id, 0)] = list(range(size))
        t.primary_temp[(pool_id, 0)] = 0
        t.set_primary_affinity(0, 0x8000)
        _JAX[key] = pipeline_jax.PoolMapper(t, pool_id)
    return _JAX[key]


def jax_map_all(m, pool_id, kind="sample"):
    """The JAX pipeline's outputs on ``m``: its tables, inactive rows
    where ``m`` has no entry."""
    jpm = jax_pipeline(kind, pool_id)
    pool = m.pools[pool_id]
    n, R = pool.pg_num, pool.size
    tabs = pipeline_jax._lower_tables(m, pool_id, pool)
    pairs = np.zeros((n, PAIRS, 2), np.int32)
    if tabs.pairs is not None:
        assert tabs.pairs.shape[1] <= PAIRS
        pairs[:, :tabs.pairs.shape[1]] = tabs.pairs

    def row(v, shape, fill):
        return np.full(shape, fill, np.int32) if v is None else v

    trow = {"upmap": row(tabs.upmap, (n, R), NONE),
            "upmap_len": row(tabs.upmap_len, n, -1),
            "pairs": pairs, "npairs": row(tabs.npairs, n, 0),
            "temp": row(tabs.temp, (n, R), NONE),
            "temp_len": row(tabs.temp_len, n, -1),
            "ptemp": row(tabs.ptemp, n, -1)}
    jpm.m = m
    jpm._trow = {k: jnp.asarray(v) for k, v in trow.items()}
    return {k: np.asarray(v) for k, v in jpm.map_all().items()}


def assert_match(m, pool_id, note, pm=None, want=None, kind="sample",
                 pss=None):
    """The port's PoolMapper (``pm``, or one built on ``m`` carried
    across) against the JAX pipeline (``want``, or ``jax_map_all``) on
    every PG, and against both scalar pipelines on ``pss`` (default:
    every PG)."""
    pool = m.pools[pool_id]
    if pm is None:
        pm = PoolMapper(PortOSDMap.from_dict(m.to_dict()), pool_id,
                        device=CPU)
    out = pm.map_all()
    assert all(out[k].dtype == torch.int32 for k in KEYS)
    got = {k: out[k].numpy() for k in KEYS}
    want = jax_map_all(m, pool_id, kind) if want is None else want
    for k in KEYS:
        assert np.array_equal(got[k], np.asarray(want[k])), (note, k)
    for ps in range(pool.pg_num) if pss is None else pss:
        w = m.pg_to_up_acting_osds(pool_id, ps)
        g = (got["up"][ps, :got["up_len"][ps]].tolist(),
             int(got["up_primary"][ps]),
             got["acting"][ps, :got["acting_len"][ps]].tolist(),
             int(got["acting_primary"][ps]))
        assert g == w, (note, pool_id, ps, g, w)
        assert pm.m.pg_to_up_acting_osds(pool_id, ps) == w, (note, ps)
    return got


@pytest.mark.parametrize("pool_id", POOLS)
def test_clean_cluster(pool_id):
    assert_match(make_map(), pool_id, "clean")


@pytest.mark.parametrize("pool_id", POOLS)
def test_down_and_out_osds(pool_id):
    m = make_map()
    for o in (3, 17, 40):
        m.osd_state[o] &= ~2  # down
    m.osd_weight[8] = 0       # out
    m.osd_weight[22] = 0x8000  # half in
    assert_match(m, pool_id, "down")


@pytest.mark.parametrize("pool_id", POOLS)
def test_nonexistent_osd(pool_id):
    m = make_map()
    m.osd_state[30] = 0  # does not exist
    assert_match(m, pool_id, "dne")


@pytest.mark.parametrize("pool_id", POOLS)
def test_pg_upmap_full(pool_id):
    m = make_map()
    m.pg_upmap[(1, 5)] = [1, 2, 3]
    m.pg_upmap[(1, 9)] = [4, 5, 44]
    m.pg_upmap[(2, 7)] = [0, 1, 2, 3, 4, 5]
    # rejected: a target marked out
    m.osd_weight[10] = 0
    m.pg_upmap[(1, 11)] = [10, 11, 12]
    m.pg_upmap[(2, 11)] = [10, 11, 12, 13, 14, 15]
    assert_match(m, pool_id, "upmap")


@pytest.mark.parametrize("pool_id", POOLS)
def test_pg_upmap_items(pool_id):
    m = make_map()
    up0 = assert_match(m, pool_id, "upmap-items-base")["up"]
    # remap the first osd of pg 3 to osd 47, and a no-op pair
    m.pg_upmap_items[(pool_id, 3)] = [(int(up0[3, 0]), 47), (200, 5)]
    # a pair whose target is already in the set (skipped)
    m.pg_upmap_items[(pool_id, 4)] = [(int(up0[4, 0]), int(up0[4, 1]))]
    # a pair whose target is marked out (skipped)
    m.osd_weight[46] = 0
    m.pg_upmap_items[(pool_id, 6)] = [(int(up0[6, 1]), 46)]
    assert_match(m, pool_id, "upmap-items")


@pytest.mark.parametrize("pool_id", POOLS)
def test_pg_temp_and_primary_temp(pool_id):
    m = make_map()
    m.pg_temp[(1, 2)] = [9, 10, 11]
    m.pg_temp[(2, 2)] = [0, 1, 2, 3, 4, 5]
    m.primary_temp[(1, 8)] = 33
    m.primary_temp[(2, 8)] = 33
    m.pg_temp[(1, 12)] = [20, 21]
    m.primary_temp[(1, 12)] = 21
    # a temp holding a down osd
    m.osd_state[10] &= ~2
    # a temp that filters to empty (all down): falls back to up
    m.osd_state[44] &= ~2
    m.osd_state[45] &= ~2
    m.pg_temp[(1, 14)] = [44, 45]
    m.pg_temp[(2, 14)] = [44, 45, 44, 45, 44, 45]
    assert_match(m, pool_id, "temp")


@pytest.mark.parametrize("pool_id", POOLS)
def test_primary_affinity(pool_id):
    m = make_map()
    m.set_primary_affinity(0, 0)        # never primary
    m.set_primary_affinity(7, 0x8000)   # half
    m.set_primary_affinity(13, 0x4000)  # quarter
    got = assert_match(m, pool_id, "paff")
    if pool_id == 1:  # osd.0 never primary where there is another
        assert not ((got["up_primary"] == 0) & (got["up_len"] > 1)).any()


@pytest.mark.parametrize("pool_id", POOLS)
def test_everything_at_once(pool_id):
    m = make_map()
    for o in (3, 17):
        m.osd_state[o] &= ~2
    m.osd_state[30] = 0
    m.osd_weight[8] = 0
    m.set_primary_affinity(7, 0x8000)
    m.pg_upmap[(pool_id, 5)] = [1, 2, 3, 4, 5, 6][:m.pools[pool_id].size]
    m.pg_upmap_items[(pool_id, 7)] = [(0, 47), (1, 46)]
    m.pg_temp[(pool_id, 2)] = [9, 10, 11, 12, 13, 14][:m.pools[pool_id].size]
    m.primary_temp[(pool_id, 2)] = 10
    # a JAX PoolMapper of its own, every stage compiled in
    want = pipeline_jax.PoolMapper(m, pool_id).map_all()
    assert_match(m, pool_id, "combo", want=want)


@pytest.mark.parametrize("pool_id", POOLS)
def test_refresh_tables(pool_id):
    m = make_map()
    pm = PoolMapper(PortOSDMap.from_dict(m.to_dict()), pool_id,
                    device=CPU)
    up0 = assert_match(m, pool_id, "refresh-base", pm=pm)["up"]

    def edit(edits):
        for osdmap in (m, pm.m):
            osdmap.pg_upmap_items.update(copy.deepcopy(edits))
        pm.refresh_tables()

    # a stage appears: pg_upmap_items added after the build
    edit({(pool_id, 3): [(int(up0[3, 0]), 47)]})
    assert_match(m, pool_id, "refresh-new-stage", pm=pm)
    # the same stage, more pairs per PG
    edit({(pool_id, 5): [(int(up0[5, 0]), 46), (int(up0[5, 1]), 45)]})
    assert_match(m, pool_id, "refresh-more-pairs", pm=pm)


@pytest.mark.parametrize("pool_id", POOLS)
def test_oversized_upmap_rejected(pool_id):
    m = make_map()
    m.pg_upmap[(pool_id, 5)] = list(range(m.pools[pool_id].size + 1))
    with pytest.raises(ValueError):
        pipeline_jax.PoolMapper(m, pool_id)
    with pytest.raises(ValueError):
        PoolMapper(PortOSDMap.from_dict(m.to_dict()), pool_id, device=CPU)


@pytest.mark.parametrize("pool_id", POOLS)
def test_stale_out_of_range_entries_ignored(pool_id):
    m = make_map()
    m.pg_temp[(pool_id, 200)] = [1, 2, 3]  # ps >= pg_num: unreachable
    m.pg_upmap_items[(pool_id, 128)] = [(1, 2)]
    assert_match(m, pool_id, "stale")
