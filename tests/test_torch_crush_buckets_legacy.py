"""The port's rule walk against ``ceph_tpu``'s ``BatchedMapper`` under
legacy tunables (local retries, the perm fallback on list and straw2
hosts) and on uniform buckets whose size numrep divides (the indep r
offset).  The maps and the check are ``test_torch_crush_buckets.py``'s;
tolerance zero."""

import pytest

from test_torch_crush_buckets import check_jax_parity


@pytest.mark.parametrize("ruleno", [0, 1])
@pytest.mark.parametrize("name", ["legacy", "uniform"])
def test_matches_jax_batched_mapper(name, ruleno):
    check_jax_parity(name, ruleno)
