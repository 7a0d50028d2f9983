"""Kernel K3's index math and a thread's work (``csrc/gf2_packet.cu``) on
the CPU.

K3 applies a (w*m, w*k) bit matrix in a packet layout by XORing whole
packet vectors.  Its unit map (which bytes a thread owns), the vector
width and block size it picks, its shared-memory sizes and the body one
thread runs over its unit are defined once, in ``csrc/gf2_packet.cuh``.
These tests build that header with the host's C++ compiler behind a C
shim and run the thread body over every unit of every stripe, block by
block with the block's scratch array, exactly as the kernel indexes
them.  The result must give the bytes of ``gf2_packet_plain`` and of
``ceph_tpu``'s ``Layout`` with ``_mod2_matmul``.  Every value is an
integer, so the tolerance is zero: byte-equal.  The kernel's launch
(the grid, shared memory, the row table copy) is checked only on the
card (chip_smoke phase 9).
"""

import ctypes
import pathlib
import shutil
import subprocess

import numpy as np
import pytest
import torch

from ceph_tpu.ec.engine import Layout as JLayout
from ceph_tpu.ec.engine import _mod2_matmul

from ceph_tpu_torch.ec.gf2_packet import gf2_packet_plain, mask_words

CSRC = pathlib.Path(__file__).resolve().parents[1] / "ceph_tpu_torch" / "csrc"

SHIM = r"""
#include <cstddef>
#include <vector>
#include "gf2_packet.cuh"

template <int V>
static void run(const uint8_t* const* rows, long long stride, uint8_t* out,
                const uint32_t* masks, int B, int k, int m, int w, int ps,
                long long L, int nt) {
  typedef typename gf2p::VecT<V>::type T;
  const long long units = gf2p::units_per_stripe(L, w, V);
  std::vector<T> scratch(static_cast<size_t>(w) * k * nt);
  for (long long b = 0; b < B; b++)
    for (long long blk = 0; blk * nt < units; blk++)
      for (int t = 0; t < nt; t++) {
        const long long u = blk * nt + t;
        if (u >= units) continue;
        const long long off = gf2p::unit_offset(u, w, ps, V);
        gf2p::packet_unit<V>(rows, b * stride + off, out + b * m * L, off, L,
                             w, ps, k, m, masks, scratch.data(), nt, t);
      }
}

extern "C" {
void model(const uint8_t* const* rows, long long stride, uint8_t* out,
           const uint32_t* masks, int B, int k, int m, int w, int ps,
           long long L, int V, int nt) {
  switch (V) {
    case 16: run<16>(rows, stride, out, masks, B, k, m, w, ps, L, nt); break;
    case 8: run<8>(rows, stride, out, masks, B, k, m, w, ps, L, nt); break;
    case 4: run<4>(rows, stride, out, masks, B, k, m, w, ps, L, nt); break;
    case 2: run<2>(rows, stride, out, masks, B, k, m, w, ps, L, nt); break;
    default: run<1>(rows, stride, out, masks, B, k, m, w, ps, L, nt);
  }
}
int vec_bytes(int ps, unsigned long long addr_or, long long B, long long L,
              int w) {
  return gf2p::vec_bytes(ps, addr_or, B, L, w);
}
int block_threads(int wk, int V) { return gf2p::block_threads(wk, V); }
int shared_bytes(int wm, int wk, int nt, int V) {
  return gf2p::shared_bytes(wm, wk, nt, V);
}
long long unit_offset(long long u, int w, int ps, int V) {
  return gf2p::unit_offset(u, w, ps, V);
}
long long units(long long L, int w, int V) {
  return gf2p::units_per_stripe(L, w, V);
}
int max_bits() { return gf2p::kMaxBits; }
int scratch_bytes() { return gf2p::kScratchBytes; }
long long min_units() { return gf2p::kMinUnits; }
}
"""

# the packet profiles of ceph_tpu's jerasure grid and the corpus, the
# default packet size, odd w, and the kernel's widest shapes
CASES = [  # (w, ps, k, m)
    (4, 8, 2, 2), (8, 8, 4, 3), (7, 8, 2, 2), (6, 8, 2, 2), (8, 8, 2, 2),
    (8, 64, 4, 2), (8, 2048, 2, 2), (3, 12, 5, 4), (5, 6, 3, 3),
    (32, 16, 8, 8), (16, 4, 16, 16)]
WIDTHS = (16, 8, 4, 2, 1)


@pytest.fixture(scope="module")
def shim(tmp_path_factory):
    """gf2_packet.cuh built for the host, behind a C shim."""
    cxx = shutil.which("g++") or shutil.which("c++")
    assert cxx, "a host C++ compiler is needed to build gf2_packet.cuh"
    d = tmp_path_factory.mktemp("gf2_packet")
    (d / "shim.cpp").write_text(SHIM)
    lib = d / "libshim.so"
    subprocess.run([cxx, "-std=c++17", "-O1", "-shared", "-fPIC",
                    f"-I{CSRC}", "-o", str(lib), str(d / "shim.cpp")],
                   check=True, capture_output=True, text=True)
    so = ctypes.CDLL(str(lib))
    P, LL, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    so.model.argtypes = [ctypes.POINTER(P), LL, P, P, I, I, I, I, I, LL, I, I]
    so.model.restype = None
    so.vec_bytes.argtypes = [I, ctypes.c_ulonglong, LL, LL, I]
    so.block_threads.argtypes = [I, I]
    so.shared_bytes.argtypes = [I, I, I, I]
    so.unit_offset.argtypes = [LL, I, I, I]
    so.unit_offset.restype = LL
    so.units.argtypes = [LL, I, I]
    so.units.restype = LL
    so.min_units.restype = LL
    return so


def _model(so, bm, rows, stride, B, w, ps, L, V, nt):
    """The kernel's work on the host: ``rows`` are k uint8 arrays (the
    row table) whose stripe b starts ``b * stride`` bytes in."""
    k, m = bm.shape[1] // w, bm.shape[0] // w
    masks = mask_words(torch.from_numpy(bm)).numpy()
    out = np.zeros((B, m, L), np.uint8)
    table = (ctypes.c_void_p * k)(*[r.ctypes.data for r in rows])
    so.model(table, stride, out.ctypes.data, masks.ctypes.data, B, k, m, w,
             ps, L, V, nt)
    return out


def _want(bm, data, w, ps):
    """ceph_tpu's bytes: its Layout's rows through _mod2_matmul."""
    lay = JLayout(w, ps)
    return np.stack([np.asarray(lay.from_rows(
        _mod2_matmul(bm, lay.to_rows(d)), bm.shape[0] // w, d.shape[1]))
        for d in data])


def test_mask_words_pack_every_bit():
    rng = np.random.default_rng(0)
    for rows, cols in ((24, 32), (16, 48), (256, 256), (7, 5)):
        bm = rng.integers(0, 2, (rows, cols), dtype=np.uint8)
        words = mask_words(torch.from_numpy(bm)).numpy().view(np.uint32)
        nw = (cols + 31) // 32
        words = words.reshape(rows, nw)
        for o in range(rows):
            got = [(int(words[o, c // 32]) >> (c % 32)) & 1
                   for c in range(nw * 32)]
            assert got == list(bm[o]) + [0] * (nw * 32 - cols)


@pytest.mark.parametrize("w,ps,k,m", CASES)
def test_units_cover_every_byte_once(shim, w, ps, k, m):
    L = w * ps * 3
    for V in WIDTHS:
        if ps % V:
            continue
        n = shim.units(L, w, V)
        assert n * V * w == L
        hits = np.zeros(L, np.int32)
        for u in range(n):
            off = shim.unit_offset(u, w, ps, V)
            assert off % V == 0
            for r in range(w):
                hits[off + r * ps:off + r * ps + V] += 1
        assert (hits == 1).all(), (V, w, ps)


@pytest.mark.parametrize("w,ps,k,m", CASES)
def test_thread_body_matches_plain_and_jax(shim, w, ps, k, m):
    """Every vector width the packet size allows, blocks of 1, 3 and 32
    threads, 2 stripes in place ([B, k, L], stride k*L)."""
    rng = np.random.default_rng(w * 1000 + ps + k * 10 + m)
    bm = rng.integers(0, 2, (w * m, w * k), dtype=np.uint8)
    B, L = 2, w * ps * 5
    data = rng.integers(0, 256, (B, k, L), dtype=np.uint8)
    want = _want(bm, data, w, ps)
    plain = gf2_packet_plain(torch.from_numpy(bm), torch.from_numpy(data),
                             w, ps).numpy()
    assert np.array_equal(plain, want)
    flat = data.reshape(-1)
    rows = [flat[c * L:] for c in range(k)]
    for V in WIDTHS:
        if ps % V:
            continue
        for nt in (1, 3, 32):
            got = _model(shim, bm, rows, k * L, B, w, ps, L, V, nt)
            assert np.array_equal(got, want), (V, nt)


def test_rows_read_where_they_lie(shim):
    """A decode's survivors at odd offsets of one buffer: the launch
    takes byte vectors, and the row table reads them in place."""
    rng = np.random.default_rng(7)
    w, ps, k, m, L = 8, 8, 4, 4, 8 * 8 * 7
    bm = rng.integers(0, 2, (w * m, w * k), dtype=np.uint8)
    data = rng.integers(0, 256, (k, L), dtype=np.uint8)
    buf = np.zeros(k * (L + 3) + 1, np.uint8)
    rows = []
    for c in range(k):
        off = 1 + c * (L + 3)
        buf[off:off + L] = data[c]
        rows.append(buf[off:])
    addr_or = 0
    for r in rows:
        addr_or |= r.ctypes.data
    V = shim.vec_bytes(ps, addr_or, 1, L, w)
    assert V == 1
    got = _model(shim, bm, rows, 0, 1, w, ps, L, V, 32)
    assert np.array_equal(got[0], _want(bm, data[None], w, ps)[0])


def test_vector_width_and_block_size(shim):
    big = 1 << 20
    # the widest vector the packet size and the addresses allow
    assert shim.vec_bytes(2048, 0, 1, 4 * big, 8) == 16
    assert shim.vec_bytes(8, 0, 1, 4 * big, 8) == 8
    assert shim.vec_bytes(12, 0, 1, 4 * big, 8) == 4
    assert shim.vec_bytes(6, 0, 1, 4 * big, 8) == 2
    assert shim.vec_bytes(2048, 0x1004, 1, 4 * big, 8) == 4
    assert shim.vec_bytes(2048, 0x1001, 1, 4 * big, 8) == 1
    # narrowed (not below 4) while the launch has too few units
    n = shim.min_units()
    assert shim.vec_bytes(2048, 0, 1, 8 * 16 * n, 8) == 16
    assert shim.vec_bytes(2048, 0, 1, 8 * 16 * n - 8 * 16, 8) == 8
    assert shim.vec_bytes(2048, 0, 1, 8 * 2048, 8) == 4
    assert shim.vec_bytes(2048, 0, 64, 8 * 16 * n // 64, 8) == 16
    # a block's vectors fit its scratch; the widest shape fits the card
    mb = shim.max_bits()
    for wk in (8, 16, 32, 64, 128, 256):
        for V in WIDTHS:
            nt = shim.block_threads(wk, V)
            assert 32 <= nt <= 256 and nt & (nt - 1) == 0
            assert wk * nt * V <= shim.scratch_bytes()
    assert shim.shared_bytes(mb, mb, shim.block_threads(mb, 16), 16) \
        <= 232448
