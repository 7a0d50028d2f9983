"""The port's rule walk (K2's plain version) against ``ceph_tpu``'s
vmapped ``BatchedMapper`` on random xs of ``map_big10k``.

The port runs on two sources of state: its own ``encode_map`` of the
map, and the JAX package's numpy arrays carried across by
``convert.map_arrays_from_numpy``.  Outputs are OSD indices, so the
tolerance is zero.
"""

import json

import numpy as np
import pytest
import torch

from conftest import GOLDEN_DIR

from ceph_tpu.crush.map import CrushMap as JCrushMap
from ceph_tpu.crush.mapper_jax import BatchedMapper as JBatchedMapper

from ceph_tpu_torch.convert import map_arrays_from_numpy
from ceph_tpu_torch.crush.map import CrushMap
from ceph_tpu_torch.crush.map_arrays import as_i32
from ceph_tpu_torch.crush.mapper import (BatchedMapper, compile_rule,
                                         crush_rule_batched)

CPU = "cpu"


@pytest.fixture(scope="module")
def big10k():
    with open(GOLDEN_DIR / "map_big10k.json") as f:
        d = json.load(f)
    jmap = JCrushMap.from_dict(d["map"])
    rng = np.random.default_rng(10)
    xs = rng.integers(0, 2 ** 32, 512, dtype=np.uint64).astype(np.uint32)
    weight = np.asarray(d["cases"][0]["weight"], np.uint32).copy()
    weight[::11] = 0          # some OSDs out
    weight[5::13] = 0x8000    # some half in: is_out draws a hash
    return d, jmap, JBatchedMapper(jmap), xs, weight


@pytest.mark.parametrize("ruleno,numrep", [(0, 3), (1, 11)])
def test_matches_jax_batched_mapper(big10k, ruleno, numrep):
    d, jmap, jmapper, xs, weight = big10k
    wres, wlens = jmapper.map_batch(ruleno, xs, numrep, weight)
    wres, wlens = np.asarray(wres), np.asarray(wlens)

    own = BatchedMapper(CrushMap.from_dict(d["map"]), device=CPU)
    res, lens = own.map_batch(ruleno, xs, numrep, weight)
    assert np.array_equal(lens.numpy(), wlens)
    assert np.array_equal(res.numpy(), wres)

    static, arrays = map_arrays_from_numpy(*jmapper._encoded, device=CPU)
    steps = [(s.op, s.arg1, s.arg2) for s in jmap.rules[ruleno].steps]
    prog = compile_rule(static, steps, numrep)
    res2, lens2 = crush_rule_batched(arrays, prog, as_i32(weight, CPU),
                                     as_i32(xs, CPU))
    assert torch.equal(res2, res) and torch.equal(lens2, lens)
