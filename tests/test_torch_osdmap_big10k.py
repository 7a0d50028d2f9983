"""The port's placement pipeline on ``map_big10k`` (10,000 OSDs) at
pg_num 1,024, with down, out and primary-affinity OSDs and every kind
of exception entry, against ``ceph_tpu``'s batched ``PoolMapper`` on
every PG and both scalar pipelines on a sample and on every PG with an
entry.  The helpers are ``test_torch_osdmap.py``'s; tolerance zero."""

import numpy as np
import pytest

from test_torch_osdmap import POOLS, assert_match, big10k_map


@pytest.mark.parametrize("pool_id", POOLS)
def test_big10k(pool_id):
    """map_big10k, pg_num 1,024: every PG against the JAX pipeline, a
    sample and every PG with an entry against the scalar ones."""
    m = big10k_map()
    rng = np.random.default_rng(pool_id)
    for o in rng.choice(10000, 200, replace=False):
        m.osd_state[o] &= ~2
    for o in rng.choice(10000, 100, replace=False):
        m.osd_weight[o] = 0
    for o in rng.choice(10000, 500, replace=False):
        m.set_primary_affinity(int(o), int(rng.integers(0, 0x10000)))
    size = m.pools[pool_id].size
    touched = [int(p) for p in rng.choice(1024, 24, replace=False)]
    for ps in touched[:8]:
        up = m.pg_to_up_acting_osds(pool_id, ps)[0]
        m.pg_upmap_items[(pool_id, ps)] = [
            (int(up[j % len(up)]) if up else 0, int(rng.integers(10000)))
            for j in range(2)]
    for ps in touched[8:16]:
        m.pg_temp[(pool_id, ps)] = [int(o) for o in
                                    rng.choice(10000, size, replace=False)]
    for ps in touched[16:]:
        m.pg_upmap[(pool_id, ps)] = [int(o) for o in
                                     rng.choice(10000, size, replace=False)]
    m.primary_temp[(pool_id, touched[0])] = 5
    pss = sorted(set(touched) | set(range(0, 1024, 16)))
    assert_match(m, pool_id, "big10k", kind="big10k", pss=pss)
