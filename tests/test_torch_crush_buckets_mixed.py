"""The port's rule walk against ``ceph_tpu``'s ``BatchedMapper`` on a
hierarchy with a host of every bucket algorithm and on tree buckets.
The maps and the check are ``test_torch_crush_buckets.py``'s; tolerance
zero."""

import pytest

from test_torch_crush_buckets import check_jax_parity


@pytest.mark.parametrize("ruleno", [0, 1])
@pytest.mark.parametrize("name", ["mixed", "tree"])
def test_matches_jax_batched_mapper(name, ruleno):
    check_jax_parity(name, ruleno)
