"""The port's GF(2) bit-matmul (K1's plain version), the layouts (w=8,
w=16/32 words on K1, packets on K3's plain version) and the EC engine,
held byte for byte against ``ceph_tpu`` on the CPU.

Inputs come from numpy with fixed seeds and go through both packages.
Every output is integer, so the tolerance is zero: byte-equal.  The
Pallas kernel runs in interpret mode, as ``tests/test_pallas.py`` runs
it.
"""

import itertools

import numpy as np
import pytest
import torch

from ceph_tpu.ec import gf as jgf
from ceph_tpu.ec.engine import BitCode as JBitCode
from ceph_tpu.ec.engine import Layout as JLayout
from ceph_tpu.ec.engine import _mod2_matmul
from ceph_tpu.ec.pallas_kernels import fused_gf2_matmul_w8
from ceph_tpu.ec.rs_jax import RSCode as JRSCode

from ceph_tpu_torch.convert import bitcode_from_numpy
from ceph_tpu_torch.ec import gf
from ceph_tpu_torch.ec.engine import BitCode, Layout
from ceph_tpu_torch.ec.gf2_kernels import (gf2_matmul_w8, gf2_matmul_w8_plain,
                                           gf2_matmul_words,
                                           gf2_matmul_words_plain,
                                           interleave_words, virtual_chunks)
from ceph_tpu_torch.ec.gf2_packet import (gf2_packet, gf2_packet_plain,
                                          packet_lists)
from ceph_tpu_torch.ec.gfw import GFW, gf2_mat_inv
from ceph_tpu_torch.ec.matrices import cauchy_good_coding_matrix
from ceph_tpu_torch.ec.rs import RSCode

CPU = "cpu"


def _bm(k, m):
    return gf.expand_bitmatrix(gf.rs_vandermonde_matrix(k, m)[k:])


@pytest.mark.parametrize("k,m,L", [(4, 2, 512), (8, 3, 2048), (2, 1, 100),
                                   (5, 4, 513), (8, 3, 777)])
def test_plain_matches_pallas_kernel(k, m, L):
    rng = np.random.default_rng(k * 100 + m + L)
    bm = _bm(k, m)
    data = rng.integers(0, 256, (k, L), dtype=np.uint8)
    want = np.asarray(fused_gf2_matmul_w8(bm, data, interpret=True))
    got = gf2_matmul_w8_plain(torch.from_numpy(bm), torch.from_numpy(data))
    assert got.dtype == torch.uint8
    assert np.array_equal(got.numpy(), want)
    # the wrapper takes the plain version for CPU tensors
    assert np.array_equal(
        gf2_matmul_w8(torch.from_numpy(bm), torch.from_numpy(data)).numpy(),
        want)


def test_plain_decode_inverse_matches_pallas_kernel():
    rng = np.random.default_rng(3)
    k, m, L = 8, 3, 777
    data = rng.integers(0, 256, (k, L), dtype=np.uint8)
    jcode = JBitCode(k, m, _bm(k, m), JLayout(8))
    code = BitCode(k, m, _bm(k, m), device=CPU)
    present = tuple(range(2, 2 + k))           # data chunks 0, 1 lost
    (jinv,) = jcode._decode_mats(present)
    inv, _ = code._decode_mats(present)
    assert np.array_equal(inv.numpy(), np.asarray(jinv))
    full = code.all_chunks(torch.from_numpy(data))
    stack = full[list(present)]
    want = np.asarray(fused_gf2_matmul_w8(np.asarray(jinv),
                                          stack.numpy(), interpret=True))
    got = gf2_matmul_w8_plain(inv, stack).numpy()
    assert np.array_equal(got, want)
    assert np.array_equal(got, data)


def test_plain_batched_equals_per_stripe():
    rng = np.random.default_rng(5)
    bm = torch.from_numpy(_bm(8, 3))
    stripes = torch.from_numpy(rng.integers(0, 256, (3, 8, 301),
                                            dtype=np.uint8))
    got = gf2_matmul_w8_plain(bm, stripes)
    assert got.shape == (3, 3, 301)
    for b in range(3):
        assert torch.equal(got[b], gf2_matmul_w8_plain(bm, stripes[b]))


def test_gf2_mat_inv_is_an_inverse():
    bm = _bm(8, 3)
    full = np.concatenate([np.eye(64, dtype=np.uint8), bm], axis=0)
    rows = full[16:80]
    inv = gf2_mat_inv(rows)
    assert np.array_equal((inv.astype(np.int64) @ rows) % 2,
                          np.eye(64, dtype=np.int64))


def test_wrapper_rejects_bad_inputs():
    bm = torch.from_numpy(_bm(4, 2))
    with pytest.raises(TypeError):
        gf2_matmul_w8(bm, torch.zeros((4, 16), dtype=torch.int32))
    with pytest.raises(ValueError):
        gf2_matmul_w8(bm, torch.zeros((5, 16), dtype=torch.uint8))
    with pytest.raises(ValueError):
        gf2_matmul_w8(bm[:, :30], torch.zeros((4, 16), dtype=torch.uint8))


@pytest.mark.parametrize("technique", ["reed_sol_van", "cauchy"])
@pytest.mark.parametrize("k,m,L", [(8, 3, 4096), (4, 2, 777)])
def test_rscode_matches_jax_and_host_reference(technique, k, m, L):
    rng = np.random.default_rng(k + m + L)
    data = rng.integers(0, 256, (k, L), dtype=np.uint8)
    code = RSCode(k, m, technique, device=CPU)
    jcode = JRSCode(k, m, technique)
    assert np.array_equal(code.G, jcode.G)
    parity = code.encode_np(data)
    assert np.array_equal(parity, np.asarray(jcode.encode(data)))
    assert np.array_equal(parity, gf.encode_ref(code.G, data))
    full = code.all_chunks(data).numpy()
    assert np.array_equal(full, np.asarray(jcode.all_chunks(data)))
    chunks = {i: full[i] for i in range(k + m)}
    for erasures in ([0, 1], [1, k], list(range(k, k + m))[:m]):
        got = code.decode_np(chunks, erasures)
        assert np.array_equal(got, data)
        assert np.array_equal(got, np.asarray(jcode.decode(chunks,
                                                            erasures)))
        assert np.array_equal(got, gf.decode_ref(code.G, chunks, erasures,
                                                 k))


def test_bitcode_batched_and_decode_match_jax():
    rng = np.random.default_rng(11)
    k, m, B, L = 8, 3, 4, 513
    stripes = rng.integers(0, 256, (B, k, L), dtype=np.uint8)
    jcode = JBitCode(k, m, _bm(k, m), JLayout(8))
    code = bitcode_from_numpy(jcode.coding_bm, k, m, device=CPU)
    got = code.encode_batched(stripes).numpy()
    assert np.array_equal(got, np.asarray(jcode.encode_batched(stripes)))
    full = np.concatenate([stripes[0], got[0]], axis=0)
    have = {i: full[i] for i in range(k + m) if i not in (2, 9)}
    want = jcode.decode([2, 9, 10], have)
    out = code.decode([2, 9, 10], have)
    for i in (2, 9, 10):
        assert np.array_equal(out[i].numpy(), np.asarray(want[i]))
        assert np.array_equal(out[i].numpy(), full[i])
    assert np.array_equal(code.decode_data(have).numpy(),
                          np.asarray(jcode.decode_data(have)))


def test_decode_cache_is_bounded():
    code = BitCode(4, 2, _bm(4, 2), device=CPU)
    code._decode_mats((0, 1, 2, 3))
    assert (0, 1, 2, 3) in code._dec_cache
    for sig in [(0, 1, 2, 4), (0, 1, 2, 5), (0, 1, 3, 4)]:
        code._decode_mats(sig)
    assert len(code._dec_cache) == 4


def test_host_tables_match_jax_package():
    assert np.array_equal(gf.GF_MUL, jgf.GF_MUL)
    for k, m in [(8, 3), (4, 2), (10, 4)]:
        assert np.array_equal(gf.rs_vandermonde_matrix(k, m),
                              jgf.rs_vandermonde_matrix(k, m))
        assert np.array_equal(gf.rs_cauchy_matrix(k, m),
                              jgf.rs_cauchy_matrix(k, m))


LAYOUTS = [(16, 0), (32, 0), (4, 8), (6, 8), (7, 8), (8, 8), (8, 64)]
LAYOUT_IDS = [f"w{w}-ps{ps}" for w, ps in LAYOUTS]


def _layout_len(w, ps, units):
    return units * (w * ps if ps else w // 8)


@pytest.mark.parametrize("w,packetsize", LAYOUTS, ids=LAYOUT_IDS)
def test_layout_rows_match_jax(w, packetsize):
    """``to_rows``/``from_rows`` of every layout equal ``ceph_tpu``'s,
    and invert each other; ``check`` refuses the same lengths."""
    rng = np.random.default_rng(w * 100 + packetsize)
    L = _layout_len(w, packetsize, 13)
    data = rng.integers(0, 256, (3, L), dtype=np.uint8)
    lay, jlay = Layout(w, packetsize), JLayout(w, packetsize)
    rows = lay.to_rows(torch.from_numpy(data))
    assert rows.dtype == torch.uint8
    assert np.array_equal(rows.numpy(), np.asarray(jlay.to_rows(data)))
    assert np.array_equal(lay.from_rows(rows, 3, L).numpy(), data)
    assert np.array_equal(
        np.asarray(jlay.from_rows(rows.numpy(), 3, L)), data)
    # leading batch dimensions: each stripe as alone
    batch = rng.integers(0, 256, (2, 3, L), dtype=np.uint8)
    brows = lay.to_rows(torch.from_numpy(batch))
    for b in range(2):
        assert np.array_equal(brows[b].numpy(),
                              np.asarray(jlay.to_rows(batch[b])))
    for bad in (L + 1, L - 1):
        with pytest.raises(ValueError):
            lay.check(bad)
        with pytest.raises(ValueError):
            jlay.check(bad)


@pytest.mark.parametrize("w,packetsize", LAYOUTS, ids=LAYOUT_IDS)
def test_bitcode_layouts_match_jax(w, packetsize):
    """``BitCode`` in every layout: encode, batched encode, decode_data
    and decode of every erasure of up to m chunks, byte-equal to
    ``ceph_tpu``'s, with the survivors as separate tensors."""
    rng = np.random.default_rng(w + packetsize)
    k, m = 4, 3
    # a Cauchy code over GF(2^w): every erasure of up to m chunks decodes
    cb = GFW(w).expand_bitmatrix(cauchy_good_coding_matrix(k, m, w))
    L = _layout_len(w, packetsize, 9)
    data = rng.integers(0, 256, (k, L), dtype=np.uint8)
    jcode = JBitCode(k, m, cb, JLayout(w, packetsize))
    code = BitCode(k, m, cb, Layout(w, packetsize), device=CPU)
    parity = code.encode(torch.from_numpy(data)).numpy()
    assert np.array_equal(parity, np.asarray(jcode.encode(data)))
    stripes = rng.integers(0, 256, (3, k, L), dtype=np.uint8)
    assert np.array_equal(code.encode_batched(stripes).numpy(),
                          np.asarray(jcode.encode_batched(stripes)))
    full = np.concatenate([data, parity], axis=0)
    n_dec = 0
    for e in range(1, m + 1):
        for lost in itertools.combinations(range(k + m), e):
            have = {i: torch.from_numpy(full[i].copy())
                    for i in range(k + m) if i not in lost}
            want = jcode.decode(list(lost), {i: full[i] for i in have})
            got = code.decode(list(lost), have)
            for i in lost:
                assert np.array_equal(got[i].numpy(), np.asarray(want[i]))
                assert np.array_equal(got[i].numpy(), full[i])
            assert np.array_equal(code.decode_data(have).numpy(),
                                  np.asarray(jcode.decode_data(
                                      {i: full[i] for i in have})))
            n_dec += 1
    assert n_dec == 63


@pytest.mark.parametrize("w,packetsize", LAYOUTS[2:], ids=LAYOUT_IDS[2:])
def test_packet_plain_matches_jax_mod2_matmul(w, packetsize):
    """K3's plain version (what the wrapper runs on CPU tensors) against
    ``ceph_tpu``'s ``to_rows`` -> ``_mod2_matmul`` -> ``from_rows``, on
    random bit matrices, stripes in place and rows given one by one."""
    rng = np.random.default_rng(31 * w + packetsize)
    k, m = 5, 3
    bm = rng.integers(0, 2, (w * m, w * k), dtype=np.uint8)
    L = _layout_len(w, packetsize, 7)
    jlay = JLayout(w, packetsize)
    stripes = rng.integers(0, 256, (2, k, L), dtype=np.uint8)
    want = np.stack([np.asarray(jlay.from_rows(
        _mod2_matmul(bm, jlay.to_rows(s)), m, L)) for s in stripes])
    tbm = torch.from_numpy(bm)
    got = gf2_packet_plain(tbm, torch.from_numpy(stripes), w, packetsize)
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(
        gf2_packet(tbm, torch.from_numpy(stripes), w, packetsize).numpy(),
        want)
    rows = [torch.from_numpy(r.copy()) for r in stripes[1]]
    assert np.array_equal(gf2_packet(tbm, rows, w, packetsize).numpy(),
                          want[1])


@pytest.mark.parametrize("w", [16, 32])
def test_virtual_chunk_identity(w):
    """The word layouts on K1: K1's w=8 product (its plain version) over
    the de-interleaved virtual chunks, interleaved back, gives
    ``ceph_tpu``'s word-layout bytes for the same bit matrix."""
    rng = np.random.default_rng(w)
    wb = w // 8
    for k, m in ((2, 3), (3, 2), (4, 4)):
        bm = rng.integers(0, 2, (w * m, w * k), dtype=np.uint8)
        L = wb * 101
        data = rng.integers(0, 256, (k, L), dtype=np.uint8)
        jlay = JLayout(w)
        want = np.asarray(jlay.from_rows(_mod2_matmul(bm, jlay.to_rows(data)),
                                         m, L))
        virt = virtual_chunks(torch.from_numpy(data), wb)
        assert virt.shape == (k * wb, L // wb)
        for c in range(k):
            for t in range(wb):
                assert np.array_equal(virt[c * wb + t].numpy(),
                                      data[c, t::wb])
        out = gf2_matmul_w8_plain(torch.from_numpy(bm), virt)
        got = interleave_words(out, wb)
        assert np.array_equal(got.numpy(), want)
        # the row form (a decode's survivors) and the wrapper
        rows = [torch.from_numpy(r.copy()) for r in data]
        assert torch.equal(virtual_chunks(rows, wb), virt)
        assert np.array_equal(
            gf2_matmul_words(torch.from_numpy(bm), rows, w).numpy(), want)
        assert np.array_equal(gf2_matmul_words_plain(
            torch.from_numpy(bm), torch.from_numpy(data), w).numpy(), want)


def test_layout_wrappers_reject_bad_inputs():
    bm = torch.zeros((16, 32), dtype=torch.uint8)
    with pytest.raises(ValueError):
        Layout(12)                      # no 12-bit words
    with pytest.raises(ValueError):
        gf2_matmul_words(bm, torch.zeros((2, 7), dtype=torch.uint8), 16)
    with pytest.raises(ValueError):
        gf2_matmul_words(bm, torch.zeros((2, 8), dtype=torch.uint8), 8)
    with pytest.raises(ValueError):     # L not a multiple of w*packetsize
        gf2_packet(bm, torch.zeros((4, 60), dtype=torch.uint8), 8, 8)
    with pytest.raises(ValueError):     # k rows
        gf2_packet(bm, torch.zeros((3, 64), dtype=torch.uint8), 8, 8)
    with pytest.raises(TypeError):
        gf2_packet(bm, torch.zeros((4, 64), dtype=torch.int32), 8, 8)
    with pytest.raises(ValueError):
        gf2_packet(bm[:, :30], torch.zeros((4, 64), dtype=torch.uint8), 8, 8)
    assert packet_lists(bm, 8) is None   # the plain version needs none


def _survivor_layouts(full, present, L):
    """The same survivors three ways: separate tensors, rows at odd
    offsets of one buffer, and rows of the full chunk array."""
    sep = {i: torch.from_numpy(full[i].copy()) for i in present}
    buf = torch.zeros(len(present) * (L + 3) + 1, dtype=torch.uint8)
    odd = {}
    for n, i in enumerate(present):
        off = 1 + n * (L + 3)
        buf[off:off + L] = torch.from_numpy(full[i])
        odd[i] = buf[off:off + L]
    rows = {i: torch.from_numpy(full)[i] for i in present}
    return {"separate": sep, "odd offsets": odd, "rows of one array": rows}


@pytest.mark.parametrize("L", [777, 4096])
def test_decode_from_row_tables_matches_jax(L):
    rng = np.random.default_rng(L)
    k, m = 8, 3
    data = rng.integers(0, 256, (k, L), dtype=np.uint8)
    jcode = JBitCode(k, m, _bm(k, m), JLayout(8))
    code = BitCode(k, m, _bm(k, m), device=CPU)
    full = code.all_chunks(torch.from_numpy(data)).numpy()
    for lost in ([0, 1], [3, 9], [8, 9, 10]):
        present = [i for i in range(k + m) if i not in lost]
        want = np.asarray(jcode.decode_data({i: full[i] for i in present}))
        assert np.array_equal(want, data)
        for label, chunks in _survivor_layouts(full, present, L).items():
            got = code.decode_data(chunks).numpy()
            assert np.array_equal(got, want), (lost, label)
            out = code.decode(lost, chunks)
            for i in lost:
                assert np.array_equal(out[i].numpy(), full[i]), (lost, label)


def test_row_table_matches_stacked_rows():
    rng = np.random.default_rng(9)
    bm = torch.from_numpy(_bm(5, 4))
    rows = [torch.from_numpy(rng.integers(0, 256, 513, dtype=np.uint8))
            for _ in range(5)]
    assert torch.equal(gf2_matmul_w8(bm, rows),
                       gf2_matmul_w8_plain(bm, torch.stack(rows)))
    assert torch.equal(gf2_matmul_w8(bm, tuple(rows)),
                       gf2_matmul_w8(bm, torch.stack(rows)))


def test_wrapper_refuses_mixed_rows():
    bm = torch.from_numpy(_bm(4, 2))
    ok = [torch.zeros(16, dtype=torch.uint8) for _ in range(4)]
    gf2_matmul_w8(bm, ok)
    bad_len = ok[:3] + [torch.zeros(17, dtype=torch.uint8)]
    bad_dtype = ok[:3] + [torch.zeros(16, dtype=torch.int16)]
    bad_device = ok[:3] + [torch.zeros(16, dtype=torch.uint8,
                                       device="meta")]
    bad_dim = ok[:3] + [torch.zeros((1, 16), dtype=torch.uint8)]
    strided = ok[:3] + [torch.zeros(32, dtype=torch.uint8)[::2]]
    with pytest.raises(ValueError):
        gf2_matmul_w8(bm, bad_len)
    with pytest.raises(TypeError):
        gf2_matmul_w8(bm, bad_dtype)
    with pytest.raises(ValueError):
        gf2_matmul_w8(bm, bad_device)
    with pytest.raises(ValueError):
        gf2_matmul_w8(bm, bad_dim)
    with pytest.raises(ValueError):
        gf2_matmul_w8(bm, strided)
    with pytest.raises(ValueError):
        gf2_matmul_w8(bm, ok[:3])
