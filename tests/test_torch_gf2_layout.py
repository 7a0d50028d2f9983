"""Kernel K1's bit plumbing (``csrc/gf2_matmul_w8.cu``) on the CPU.

K1 runs the GF(2) bit-matmul on the tensor cores as 1-bit products
(``mma.sync`` m16n8k256 b1 AND-popcount).  Where each bit lives, in
which lane and fragment register, is defined once, in
``csrc/gf2_layout.cuh``.  These tests build that header with the host's
C++ compiler and model the kernel in numpy on its definitions: the 4x4
byte transpose into B registers, A's block-diagonal rows and padding,
the fragment maps (with the ``mma`` taken as an int32 numpy product),
the parity gather and pack, and the exchange between the two lanes that
hold halves of an output byte.  The model must give the bytes of
``gf2_matmul_w8_plain`` and of the Pallas kernel (interpret mode).
Every value is an integer, so the tolerance is zero: byte-equal.
"""

import ctypes
import pathlib
import shutil
import subprocess

import numpy as np
import pytest
import torch

from ceph_tpu.ec.pallas_kernels import fused_gf2_matmul_w8

from ceph_tpu_torch.ec import gf
from ceph_tpu_torch.ec.gf2_kernels import gf2_matmul_w8_plain

CSRC = pathlib.Path(__file__).resolve().parents[1] / "ceph_tpu_torch" / "csrc"

SHIM = r"""
#include "gf2_layout.cuh"
extern "C" {
void tab_frags(int* a, int* b, int* c) {
  for (int lane = 0; lane < 32; lane++) {
    for (int r = 0; r < 4; r++)
      for (int i = 0; i < 32; i++) {
        int* o = a + 2 * ((lane * 4 + r) * 32 + i);
        gf2::frag_a(lane, r, i, o, o + 1);
      }
    for (int r = 0; r < 2; r++)
      for (int i = 0; i < 32; i++) {
        int* o = b + 2 * ((lane * 2 + r) * 32 + i);
        gf2::frag_b(lane, r, i, o, o + 1);
      }
    for (int r = 0; r < 4; r++) {
      int* o = c + 2 * (lane * 4 + r);
      gf2::frag_c(lane, r, o, o + 1);
    }
  }
}
void tab_b_load(int ks_n, int* out) {
  for (int ks = 0; ks < ks_n; ks++)
    for (int lane = 0; lane < 32; lane++)
      for (int r = 0; r < 2; r++)
        for (int e = 0; e < 4; e++) {
          int* o = out + 2 * (((ks * 32 + lane) * 2 + r) * 4 + e);
          gf2::b_load(lane, r, e, ks, o, o + 1);
        }
}
void tab_k_source(int ks_n, int* out) {
  for (int ks = 0; ks < ks_n; ks++)
    for (int kk = 0; kk < 256; kk++) {
      int* o = out + 3 * (ks * 256 + kk);
      gf2::k_source(kk, ks, o, o + 1, o + 2);
    }
}
void tab_a_source(int nt, int ks_n, int k, int m, int* out) {
  int n = 0;
  for (int T = 0; T < nt; T++)
    for (int ks = 0; ks < ks_n; ks++)
      for (int lane = 0; lane < 32; lane++)
        for (int r = 0; r < 4; r++)
          for (int i = 0; i < 32; i++, n += 2)
            gf2::a_source(lane, r, i, T, ks, k, m, out + n, out + n + 1);
}
void tab_out_bit(int nt, int* out) {
  for (int T = 0; T < nt; T++)
    for (int r = 0; r < 16; r++)
      gf2::out_bit(T, r, out + 2 * (T * 16 + r), out + 2 * (T * 16 + r) + 1);
}
void tab_store_col(int* out) {
  for (int lane = 0; lane < 32; lane++) out[lane] = gf2::store_col(lane);
}
void variant(int k, int m, int* out) { gf2::variant(k, m, out, out + 1); }
int chunk_col(int n, int c, int q) { return gf2::chunk_col(n, c, q); }
unsigned byte_perm(unsigned x, unsigned y, unsigned s) {
  return gf2::byte_perm(x, y, s);
}
void transpose4(const unsigned* w, unsigned* b) {
  const uint32_t in[4] = {w[0], w[1], w[2], w[3]};
  uint32_t o[4];
  gf2::transpose4(in, o);
  for (int q = 0; q < 4; q++) b[q] = o[q];
}
unsigned gather4(unsigned a, unsigned b, unsigned c, unsigned d) {
  return gf2::gather4(a, b, c, d);
}
unsigned gather4_small(unsigned a, unsigned b, unsigned c, unsigned d) {
  return gf2::gather4_small(a, b, c, d);
}
unsigned pack_bit_at(unsigned w, unsigned g4, unsigned at) {
  return gf2::pack_bit_at(w, g4, at);
}
int chunk_cols() { return gf2::kChunkCols; }
int blocks() { return gf2::kBlocks; }
int step_rows() { return gf2::kStepRows; }
}
"""

CASES_KM = [(4, 2), (8, 3), (8, 8), (8, 16), (32, 32), (5, 7)]
LENGTHS = [1, 31, 777, 4096]


@pytest.fixture(scope="module")
def layout(tmp_path_factory):
    """gf2_layout.cuh built for the host, behind a C shim."""
    cxx = shutil.which("g++") or shutil.which("c++")
    assert cxx, "a host C++ compiler is needed to build gf2_layout.cuh"
    d = tmp_path_factory.mktemp("gf2_layout")
    (d / "shim.cpp").write_text(SHIM)
    lib = d / "libshim.so"
    subprocess.run([cxx, "-std=c++17", "-O1", "-shared", "-fPIC",
                    f"-I{CSRC}", "-o", str(lib), str(d / "shim.cpp")],
                   check=True, capture_output=True, text=True)
    so = ctypes.CDLL(str(lib))
    u32 = ctypes.c_uint32
    for name in ("byte_perm", "gather4", "gather4_small", "pack_bit_at"):
        getattr(so, name).restype = u32
    so.byte_perm.argtypes = [u32, u32, u32]
    so.gather4.argtypes = [u32, u32, u32, u32]
    so.gather4_small.argtypes = [u32, u32, u32, u32]
    so.pack_bit_at.argtypes = [u32, u32, u32]
    return Layout(so)


def _ints(n):
    return np.zeros(n, dtype=np.int32)


def _ptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int))


class Layout:
    """The header's tables and constants, read through the shim."""

    def __init__(self, so):
        self.so = so
        a, b, c = _ints(32 * 128 * 2), _ints(32 * 64 * 2), _ints(32 * 4 * 2)
        so.tab_frags(_ptr(a), _ptr(b), _ptr(c))
        self.frag_a = a.reshape(32, 4, 32, 2)  # lane, reg, bit -> row, col
        self.frag_b = b.reshape(32, 2, 32, 2)
        self.frag_c = c.reshape(32, 4, 2)      # lane, reg -> row, col
        self.chunk = so.chunk_cols()
        self.blocks = so.blocks()
        self.step_rows = so.step_rows()
        sc = _ints(32)
        so.tab_store_col(_ptr(sc))
        self.store_col = sc

    def variant(self, k, m):
        out = _ints(2)
        self.so.variant(k, m, _ptr(out))
        return tuple(int(v) for v in out)

    def b_load(self, ks_n):
        out = _ints(ks_n * 32 * 8 * 2)
        self.so.tab_b_load(ks_n, _ptr(out))
        return out.reshape(ks_n, 32, 2, 4, 2)  # ks, lane, reg, byte

    def k_source(self, ks_n):
        out = _ints(ks_n * 256 * 3)
        self.so.tab_k_source(ks_n, _ptr(out))
        return out.reshape(ks_n, 256, 3)       # block, row, bit

    def a_source(self, nt, ks_n, k, m):
        out = _ints(nt * ks_n * 32 * 128 * 2)
        self.so.tab_a_source(nt, ks_n, k, m, _ptr(out))
        return out.reshape(nt, ks_n, 32, 4, 32, 2)

    def out_bit(self, nt):
        out = _ints(nt * 16 * 2)
        self.so.tab_out_bit(nt, _ptr(out))
        return out.reshape(nt, 16, 2)          # byte, bit

    def transpose4(self, w):
        src = np.asarray(w, np.uint32)
        dst = np.zeros(4, np.uint32)
        self.so.transpose4(src.ctypes.data_as(ctypes.c_void_p),
                           dst.ctypes.data_as(ctypes.c_void_p))
        return dst


# -- numpy mirrors of the header's arithmetic --------------------------


def transpose4(w):
    """w[..., e] holds byte q of row e at bits 8q.. -> b[..., q] holds
    byte e of column q at bits 8e.."""
    w = np.asarray(w, np.uint32)
    b = np.zeros_like(w)
    for q in range(4):
        for e in range(4):
            b[..., q] |= ((w[..., e] >> (8 * q)) & 0xFF) << (8 * e)
    return b


def gather4(a, b, c, d):
    """Low bytes of four accumulators as one word's bytes 0..3."""
    return ((a & 0xFF) | (b & 0xFF) << 8 | (c & 0xFF) << 16
            | (d & 0xFF) << 24).astype(np.uint32)


def gather4_small(a, b, c, d):
    """gather4 as a sum, for counts below 256."""
    return (a + (b << 8) + (c << 16) + (d << 24)).astype(np.uint32)


def pack_bit(word, g4, bit):
    """pack_bit_at(word, g4, 1 << bit) for a word whose bit is clear."""
    return word + ((g4 & np.uint32(0x01010101)) << np.uint32(bit))


def bits_of(words):
    """u32[...] -> 0/1 int32[..., 32], bit i of each word at index i."""
    w = np.asarray(words, np.uint32)[..., None]
    return ((w >> np.arange(32, dtype=np.uint32)) & 1).astype(np.int32)


# -- the model ----------------------------------------------------------


def model(lay, bm, data):
    """K1 in numpy, lane by lane as the kernel computes it, from the
    header's maps.  bm u8 (8m, 8k) 0/1, data u8[k, L] -> u8[m, L]."""
    m, k = bm.shape[0] // 8, bm.shape[1] // 8
    L = data.shape[1]
    nt, ks_n = lay.variant(k, m)
    C = -(-L // lay.chunk)
    rows = np.zeros((lay.step_rows * ks_n, C * lay.chunk + 4), np.uint8)
    rows[:k, :L] = data

    # A registers of every (tile, k-step, lane) from the bit matrix, and
    # the 16 x 256 bit matrix of each product they make together
    src = lay.a_source(nt, ks_n, k, m)         # T, ks, lane, reg, bit
    r_, c_ = src[..., 0], src[..., 1]
    abits = np.where(r_ >= 0, bm[np.maximum(r_, 0), np.maximum(c_, 0)] & 1, 0)
    areg = (abits.astype(np.uint64) << np.arange(32, dtype=np.uint64)).sum(
        -1).astype(np.uint32)                  # T, ks, lane, reg
    A = np.zeros((nt, ks_n, 16, 256), np.int32)
    fa = lay.frag_a
    A[:, :, fa[..., 0], fa[..., 1]] = bits_of(areg)

    # B registers: lane loads a word of each of 4 rows per register and
    # transposes it into one register per product q
    bl = lay.b_load(ks_n)                      # ks, lane, reg, byte
    ch = np.arange(C)[:, None, None, None, None] * lay.chunk
    cols = ch + bl[None, ..., 1]               # ch, ks, lane, reg, byte
    brow = np.broadcast_to(bl[None, ..., 0], cols.shape)
    word = np.zeros(cols.shape, np.uint32)
    for q in range(4):
        word |= rows[brow, cols + q].astype(np.uint32) << (8 * q)
    breg = transpose4(word)                    # ch, ks, lane, reg, q
    Bm = np.zeros((C, 4, ks_n, 256, 8), np.int32)
    fb = lay.frag_b
    Bm[:, :, :, fb[..., 0], fb[..., 1]] = bits_of(
        breg.transpose(0, 4, 1, 2, 3))         # ch, q, ks, lane, reg, bit

    # the mma: D = popcount(A & B) summed over k-steps, one int32 product
    A2 = A.transpose(0, 2, 1, 3).reshape(nt * 16, ks_n * 256)
    B2 = Bm.transpose(2, 3, 0, 1, 4).reshape(ks_n * 256, C * 4 * 8)
    D = (A2 @ B2).reshape(nt, 16, C, 4, 8).transpose(2, 3, 0, 1, 4)
    fc = lay.frag_c
    acc = D[..., fc[..., 0], fc[..., 1]].astype(np.uint32)  # ch, q, T, lane, rc

    # pack: tiles 2i and 2i + 1 make byte i; register rc holds column
    # n = 2t + (rc & 1) at the bit out_bit gives its row
    ob = lay.out_bit(nt)
    lane = np.arange(32)
    words = np.zeros((C, m, 32, 2), np.uint32)
    for T in range(2 * m):
        for rc in range(4):
            rowr = fc[:, rc, 0]                # per lane
            byte, bit = ob[T, rowr, 0], ob[T, rowr, 1]
            assert (byte == T // 2).all()
            accs = [acc[:, q, T, :, rc] for q in range(4)]
            if ks_n == 1:   # the kernel sums: every count is below 256
                assert max(int(a.max(initial=0)) for a in accs) < 256
                g4 = gather4_small(*accs)
            else:
                g4 = gather4(*accs)
            words[:, T // 2, :, rc & 1] = pack_bit(
                words[:, T // 2, :, rc & 1], g4, bit[None, :])
    # join: lane g keeps column n = 2t + g // 4 and takes the other half
    # of the byte from lane ^ 16
    p = lane // 16
    mine = words[:, :, lane, p] | words[:, :, lane ^ 16, p]
    out = np.zeros((m, C * lay.chunk + 4), np.uint8)
    sc = lay.store_col
    for q in range(4):
        out[:, (ch[:, 0, 0, 0, 0][:, None] + sc[None, :] + q)] = (
            (mine >> np.uint32(8 * q)) & 0xFF).transpose(1, 0, 2)
    return out[:, :L]


def _bm(kind, k, m, rng):
    if kind == "rs":
        return gf.expand_bitmatrix(gf.rs_vandermonde_matrix(k, m)[k:])
    return rng.integers(0, 2, (8 * m, 8 * k), dtype=np.uint8)


# -- tests ----------------------------------------------------------------


def test_arithmetic_mirrors_match_the_header(layout):
    so, rng = layout.so, np.random.default_rng(0)
    for _ in range(2000):
        x, y, a, b, c, d, w = (int(v) for v in rng.integers(0, 2 ** 32, 7))
        q = int(rng.integers(0, 4))
        # byte q of x replicated: the selector form the header relies on
        assert so.byte_perm(x, 0, 0x1111 * q) == ((x >> (8 * q)) & 0xFF) \
            * 0x01010101
        assert so.byte_perm(x, y, 0x7654) == y
        ws = [int(v) for v in rng.integers(0, 2 ** 32, 4)]
        assert np.array_equal(layout.transpose4(ws), transpose4(ws))
        assert so.gather4(a, b, c, d) == int(gather4(
            *(np.array(v, np.uint32) for v in (a, b, c, d))))
        small = [int(v) for v in rng.integers(0, 256, 4)]
        assert so.gather4_small(*small) == so.gather4(*small) == int(
            gather4_small(*(np.array(v, np.uint32) for v in small)))
        bit = int(rng.integers(0, 8))
        clear = w & ~(0x01010101 << bit) & 0xFFFFFFFF
        assert so.pack_bit_at(clear, a, 1 << bit) == int(pack_bit(
            np.uint32(clear), np.uint32(a), bit))


def test_fragment_maps_cover_each_tile_once(layout):
    for frag, shape in ((layout.frag_a, (16, 256)), (layout.frag_b, (256, 8)),
                        (layout.frag_c, (16, 8))):
        flat = frag.reshape(-1, 2)
        cells = flat[:, 0] * shape[1] + flat[:, 1]
        assert sorted(cells.tolist()) == list(range(shape[0] * shape[1]))


def test_k_blocks_hold_the_bit_matrix_columns_in_order(layout):
    ks = layout.k_source(4)
    for step in range(4):
        kk = np.arange(256)
        assert np.array_equal(ks[step, :, 0], kk // 64)
        assert np.array_equal(8 * (ks[step, :, 1] - 8 * step) + ks[step, :, 2],
                              kk % 64)


@pytest.mark.parametrize("k,m", CASES_KM)
def test_a_rows_cover_the_bit_matrix_once(layout, k, m):
    nt, ks_n = layout.variant(k, m)
    src = layout.a_source(nt, ks_n, k, m)
    # every bit-matrix cell once per byte column block: 4 times in all
    real = src.reshape(-1, 2)
    real = real[real[:, 0] >= 0]
    cells = real[:, 0] * 8 * k + real[:, 1]
    counts = np.bincount(cells, minlength=64 * m * k)
    assert (counts == layout.blocks).all()
    # and the 8 bits of a byte of a register are neighbouring cells
    c8 = src[..., 1].reshape(*src.shape[:4], 4, 8)
    r8 = src[..., 0].reshape(*src.shape[:4], 4, 8)
    ok = r8[..., 0] >= 0
    assert (r8[ok] == r8[ok][:, :1]).all()
    assert (c8[ok] == c8[ok][:, :1] + np.arange(8)).all()


def test_columns_of_a_chunk_are_each_loaded_and_stored_once(layout):
    bl = layout.b_load(1)                      # lane, reg, byte -> row, col
    seen = set()
    for lane in range(32):
        t = lane % 4
        for rb in range(2):
            for e in range(4):
                row, col = bl[0, lane, rb, e]
                seen.add((int(row), int(col)))
    # 32 lanes x 2 registers x 4 rows: each (row, word) exactly once
    assert len(seen) == 8 * 32
    sc = np.sort(layout.store_col)
    assert np.array_equal(sc, 4 * np.arange(32))


@pytest.mark.parametrize("kind", ["random", "rs"])
@pytest.mark.parametrize("L", LENGTHS)
@pytest.mark.parametrize("k,m", CASES_KM)
def test_model_matches_plain(layout, k, m, L, kind):
    rng = np.random.default_rng(1000 * k + 10 * m + L)
    bm = _bm(kind, k, m, rng)
    data = rng.integers(0, 256, (k, L), dtype=np.uint8)
    want = gf2_matmul_w8_plain(torch.from_numpy(bm),
                               torch.from_numpy(data)).numpy()
    assert np.array_equal(model(layout, bm, data), want)


@pytest.mark.parametrize("k,m,L,kind", [(8, 3, 777, "rs"),
                                        (5, 7, 31, "random"),
                                        (8, 8, 4096, "random")])
def test_model_matches_pallas_kernel(layout, k, m, L, kind):
    rng = np.random.default_rng(7 * k + m + L)
    bm = _bm(kind, k, m, rng)
    data = rng.integers(0, 256, (k, L), dtype=np.uint8)
    want = np.asarray(fused_gf2_matmul_w8(bm, data, interpret=True))
    assert np.array_equal(model(layout, bm, data), want)
