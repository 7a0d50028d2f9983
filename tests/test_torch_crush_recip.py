"""The straw2 reciprocal key of kernel K2 (``csrc/crush_rule.cu``) on the
CPU.

The kernel divides by no weight: ``MapArrays.magic`` derives a magic per
item weight (``ln.straw2_magic``) and the kernel takes the quotient as
``__umul64hi(n << 15, m) >> l`` with ``m, l`` unpacked from the magic
(``m | l << 58``).  These tests emulate that arithmetic with Python
integers from the magics the port's ``encode_map`` produces and hold it
to truncating int64 division, the reference's draw.  Every value is an
integer, so the tolerance is zero.
"""

import json

import numpy as np
import pytest
import torch

from conftest import GOLDEN_DIR

from ceph_tpu_torch.crush import ln
from ceph_tpu_torch.crush.builder import make_straw2_bucket
from ceph_tpu_torch.crush.map import CrushMap
from ceph_tpu_torch.crush.map_arrays import encode_map, to_device

IN_SCOPE = ["map_big10k", "map_flat12", "map_tree3", "map_weird"]
EDGE_WEIGHTS = [1, 2, 3, 0xFFFF, 0x10000, 0x10001, 2 ** 31, 0xFFFFFFFF]
M64 = 2 ** 64 - 1


def load_map(name):
    with open(GOLDEN_DIR / f"{name}.json") as f:
        return CrushMap.from_dict(json.load(f)["map"])


def numerators():
    """Every numerator the kernel divides: 2^48 - crush_ln(u) for all
    65,536 u, and the ends of the range, 0 and 2^48."""
    lns = ln.ln16_table("cpu").tolist()
    return [(1 << 48) - v for v in lns] + [0, 1 << 48]


def kernel_quotient(n, magic):
    """The kernel's quotient, as csrc/crush_rule.cu computes it in u64:
    mulhi64(n << 15, magic & (2^58 - 1)) >> (magic >> 58)."""
    m = magic & ((1 << 58) - 1)
    shift = magic >> 58
    a = (n << 15) & M64
    return ((a * m) >> 64) >> shift


def magics_by_weight(cmap):
    """{item weight: its magic in encode_map's output} over every item
    of every bucket (padding excluded)."""
    _, arrays = encode_map(cmap)
    out = {}
    for bi in range(arrays.items.shape[0]):
        for j in range(int(arrays.size[bi])):
            w = int(arrays.weights[bi, j])
            mg = int(arrays.magic[bi, j])
            assert out.setdefault(w, mg) == mg
    return out


def edge_map():
    """One straw2 bucket whose items carry the edge weights and 0."""
    cmap = CrushMap()
    weights = EDGE_WEIGHTS + [0]
    cmap.add_bucket(make_straw2_bucket(range(len(weights)), weights, 1))
    return cmap


def assert_exact(by_weight):
    """The emulated quotient's draw equals torch's truncating int64
    division for every numerator and weight; zero weights have magic
    0."""
    ns = numerators()
    num = torch.tensor([-n for n in ns], dtype=torch.int64)  # ln - 2^48
    for w, magic in sorted(by_weight.items()):
        if w == 0:
            assert magic == 0
            continue
        want = torch.div(num, w, rounding_mode="trunc").tolist()
        got = [-kernel_quotient(n, magic) for n in ns]
        assert got == want, f"weight {w:#x}"


@pytest.mark.parametrize("name", IN_SCOPE)
def test_reciprocal_key_exact_on_golden_weights(name):
    assert_exact(magics_by_weight(load_map(name)))


def test_reciprocal_key_exact_on_edge_weights():
    by_weight = magics_by_weight(edge_map())
    assert sorted(by_weight) == sorted(EDGE_WEIGHTS + [0])
    assert_exact(by_weight)


def test_encode_map_magic_matches_fresh_computation():
    """map_big10k's magic column, recomputed from the definition: l =
    ceil(log2 w), m = ceil(2^(49+l) / w), magic = m | l << 58; 0 for a
    zero weight and for padding.  It survives ``to_device`` as its int64
    bit pattern."""
    _, arrays = encode_map(load_map("map_big10k"))
    assert arrays.magic.dtype == np.uint64
    assert arrays.magic.shape == arrays.weights.shape
    want = np.zeros(arrays.weights.shape, np.uint64)
    for (bi, j), w in np.ndenumerate(arrays.weights):
        w = int(w)
        if w:
            shift = (w - 1).bit_length()
            m = -(-(1 << (49 + shift)) // w)
            assert m < 1 << 58
            want[bi, j] = m | (shift << 58)
    assert np.array_equal(arrays.magic, want)
    dev = to_device(arrays, "cpu").magic
    assert dev.dtype == torch.int64
    assert np.array_equal(dev.numpy().view(np.uint64), want)


def test_straw2_key_picks_the_first_maximum():
    """The kernel's straw2 key (quotient << 15 | item index, a zero
    weight's quotient 2^49 - 1) has its minimum at the item
    bucket_straw2_choose picks: the first maximum of the draws.  Rows
    are made to tie: repeated weights and hashes, and zero weights."""
    rng = np.random.default_rng(11)
    rows, S = 2000, 25
    weights = rng.choice([0, 1, 0x10000, 0x10000, 0x28000, 0xFFFFFFFF],
                         (rows, S)).astype(np.uint32)
    weights[:50] = 0
    u = rng.integers(0xFFF0, 0x10000, (rows, S))
    u[::3] = rng.integers(0, 0x10000, (rows // 3 + 1, S))
    draws = ln.straw2_draw(torch.from_numpy(u), torch.from_numpy(
        weights.astype(np.int64)))
    want = torch.argmax(draws, dim=1).tolist()   # first maximum
    magic = ln.straw2_magic(weights)
    lns = ln.ln16_table("cpu").tolist()
    for r in range(rows):
        keys = []
        for i in range(S):
            mg = int(magic[r, i])
            q = (1 << 49) - 1 if mg == 0 else \
                kernel_quotient((1 << 48) - lns[u[r, i]], mg)
            keys.append(q << 15 | i)
        assert min(keys) & 0x7FFF == want[r], r


def test_wrapper_requires_the_magic_column():
    """The kernel reads ``magic`` beside ``items``: on the arrays the
    wrapper is given it is a contiguous int64 column of the items'
    shape, derived from ``weights``, and the wrapper refuses weights of
    another type or shape, from which no such column comes."""
    from dataclasses import replace

    from ceph_tpu_torch.crush.builder import sample_cluster_map
    from ceph_tpu_torch.crush.map_arrays import as_i32
    from ceph_tpu_torch.crush.mapper import (BatchedMapper,
                                             crush_rule_batched)

    mapper = BatchedMapper(sample_cluster_map(), device="cpu")
    prog = mapper.program(0, 3)
    weight = as_i32(np.full(48, 0x10000, np.uint32), "cpu")
    xs = torch.arange(4, dtype=torch.int32)
    a = mapper.arrays
    assert a.magic.dtype == torch.int64 and a.magic.is_contiguous()
    assert a.magic.shape == a.items.shape
    for bad in (a.weights.to(torch.int64), a.weights[:, :-1].contiguous()):
        with pytest.raises(ValueError):
            crush_rule_batched(replace(a, weights=bad), prog, weight, xs)
    res, lens = crush_rule_batched(a, prog, weight, xs)
    assert res.shape == (4, 3) and lens.tolist() == [3] * 4


def test_magic_follows_weight_updates():
    """``weights`` is the one source of the kernel's magics: after an
    in-place write to the weights tensor, or a new tensor in its place,
    ``arrays.magic`` (what ``crush_rule_batched`` hands the kernel) is
    the magic of the new weights; unchanged weights reuse the column."""
    _, enc = encode_map(load_map("map_big10k"))
    a = to_device(enc, "cpu")
    first = a.magic
    assert a.magic is first

    def expect():
        w = a.weights.numpy().view(np.uint32)
        return torch.from_numpy(ln.straw2_magic(w).view(np.int64))

    a.weights[3, :4] = 0
    a.weights[5, 1] = torch.tensor(0xFFFFFFFF - 2 ** 32, dtype=torch.int32)
    assert torch.equal(a.magic, expect())
    assert not torch.equal(a.magic, first)
    assert int(a.magic[3, 0]) == 0
    a.weights.copy_(torch.full_like(a.weights, 0x30000))
    assert torch.equal(a.magic, expect())
    a.weights = torch.full_like(a.weights, 3)
    assert torch.equal(a.magic, expect())
