"""Kernel K3's index math and a launch's work (``csrc/gf2_packet.cu``) on
the CPU.

K3 applies a (w*m, w*k) bit matrix in a packet layout by XORing whole
packet pieces.  Its plan (piece width, tiles, stage layout, grid), its
tile map, how a tile's rows are staged (whole runs for the bulk copies,
pieces for cp.async and plain copies), which piece each lane takes and
the XOR a lane runs over its row's index list are defined once, in
``csrc/gf2_packet.cuh``.  These tests build that header with the host's
C++ compiler behind a C shim and run a launch on the host: every block
of the grid walks its tiles, stages each into a buffer filled with a
poison byte first, and runs every warp's lanes over it, exactly as the
kernel indexes them.  The result must give the bytes of
``gf2_packet_plain`` and of ``ceph_tpu``'s ``Layout`` with
``_mod2_matmul``.  Every value is an integer, so the tolerance is zero:
byte-equal.  The copies, barriers and the ring are checked only on the
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

from ceph_tpu_torch.ec.gf2_packet import (PLAN_FIELDS, gf2_packet_plain,
                                          index_lists)

CSRC = pathlib.Path(__file__).resolve().parents[1] / "ceph_tpu_torch" / "csrc"

SHIM = r"""
#include <cstring>
#include <vector>
#include "gf2_packet.cuh"

using namespace gf2p;

// The lists as a block of the grid keeps them: the starts and ends, and
// each entry as its offset in a stage.
struct Lists {
  std::vector<int> bounds;
  std::vector<U64> offs;   // 4 offsets a word, as the kernel loads them
};

static Lists lists_of(const Plan& p, const int* lists, int wm, int npad) {
  Lists l;
  l.bounds.assign(lists, lists + 2 * wm);
  l.offs.resize((npad + 3) / 4 + 1);
  uint16_t* offs = reinterpret_cast<uint16_t*>(l.offs.data());
  for (int i = 0; i < npad; i++) offs[i] = entry_offset(p, lists[2 * wm + i]);
  return l;
}

template <int V>
static void lanes(const Plan& p, const Tile& t, const Lists& l, int wm,
                  int w, int ps, long long L, const uint8_t* stage,
                  uint8_t* out) {
  for (int warp = 0; warp < kWarps; warp++)
    for (int lane = 0; lane < 32; lane++)
      lane_tile<V>(p, t, l.bounds.data(),
                   reinterpret_cast<const uint16_t*>(l.offs.data()), wm, w,
                   ps, L, stage, out, warp, lane);
}

// Each piece a lane stores in a tile: fn(o, tt, jv).
template <typename F>
static void each_store(const Plan& p, const Tile& t, int wm, F fn) {
  for (int it = 0; it < items(t, wm); it++)
    for (int lane = 0; lane < 32; lane++) {
      const int g = static_cast<int>(fdiv(p.fd_wm, it));
      const int e = g * 32 + lane;
      if (e >= t.tb * t.runp) continue;
      int tt, jv;
      piece_spot(p, t, e, &tt, &jv);
      fn(it - g * wm, tt, jv);
    }
}

// Stage tile t of row c as the kernel's copies do.
static void stage_row(const Plan& p, const Tile& t, int w, int ps,
                      const uint8_t* row, uint8_t* srow) {
  if (p.mode == kBulk) {
    for (int j = 0; j < runs_per_row(p, t, w, ps); j++) {
      long long src;
      int dst, bytes;
      run_at(p, t, w, ps, j, &src, &dst, &bytes);
      std::memcpy(srow + dst, row + src, bytes);
    }
  } else {
    for (int n = 0; n < pieces_per_row(t, w); n++) {
      long long src;
      int dst;
      piece_at(p, t, w, ps, n, &src, &dst);
      std::memcpy(srow + dst, row + src, p.V);
    }
  }
}

extern "C" {

void plan_fields(int ps, int w, int k, int m, int npad, long long L,
                 long long B, unsigned long long addr_or, int n_sm,
                 long long* out) {
  const Plan p = plan(ps, w, k, m, npad, L, B, addr_or, n_sm);
  const long long v[] = {p.V, p.mode, p.T, p.nr, p.runp, p.tiles, p.grid,
                         p.smem_bytes, p.ppp, p.bpitch, p.spitch, p.rowpitch,
                         p.stage_bytes, p.nb, p.tiles_stripe, p.ctas};
  for (int i = 0; i < 16; i++) out[i] = v[i];
}

int ring_tiles() { return kStages; }

unsigned fast_quotient(unsigned d, unsigned n) {
  return fdiv(fast_div(d), n);
}

// The launch on the host: every block of the grid, every tile it walks,
// staged into a poisoned buffer (its zero row zeroed), every warp's
// lanes.
void model(const uint8_t* const* rows, long long stride, uint8_t* out,
           const int* lists, int npad, int B, int k, int m, int w, int ps,
           long long L, unsigned long long addr_or, int n_sm) {
  const Plan p = plan(ps, w, k, m, npad, L, B, addr_or, n_sm);
  const int wm = w * m;
  const Lists l = lists_of(p, lists, wm, npad);
  std::vector<U128> buf((p.stage_bytes + 15) / 16 + 1);
  uint8_t* stage = reinterpret_cast<uint8_t*>(buf.data());
  for (int g = 0; g < p.grid; g++)
    for (long long i = 0; i < tiles_of(p, g); i++) {
      const Tile t = tile_at(p, w, ps, g + i * p.grid);
      std::memset(stage, 0xA5, p.zero_at);
      std::memset(stage + p.zero_at, 0, p.stage_bytes - p.zero_at);
      for (int c = 0; c < k; c++)
        stage_row(p, t, w, ps, rows[c] + t.b * stride, stage + c * p.rowpitch);
      uint8_t* o = out + t.b * m * L;
      switch (p.V) {
        case 16: lanes<16>(p, t, l, wm, w, ps, L, stage, o); break;
        case 8: lanes<8>(p, t, l, wm, w, ps, L, stage, o); break;
        case 4: lanes<4>(p, t, l, wm, w, ps, L, stage, o); break;
        case 2: lanes<2>(p, t, l, wm, w, ps, L, stage, o); break;
        default: lanes<1>(p, t, l, wm, w, ps, L, stage, o);
      }
    }
}

// What a launch touches, counted: `in_hits` [B, k, L] the input bytes
// staged, `out_hits` [B, m, L] the output bytes stored, `tile_hits`
// [tiles] the blocks of the grid that took each tile.  Returns the most
// times one byte of one stage was written in one tile (1 when no copy
// overlaps another), -1 if a copy leaves its stage's input rows, -2 if a
// tile's bulk copies do not add up to its bytes.
int cover(int B, int k, int m, int w, int ps, long long L,
          unsigned long long addr_or, int n_sm, int* in_hits, int* out_hits,
          int* tile_hits) {
  const Plan p = plan(ps, w, k, m, w * m * (w * k / 2 + 3), L, B, addr_or,
                      n_sm);
  std::vector<int> st(p.stage_bytes);
  int worst = 0;
  for (int g = 0; g < p.grid; g++)
    for (long long i = 0; i < tiles_of(p, g); i++) {
      const long long id = g + i * p.grid;
      tile_hits[id]++;
      const Tile t = tile_at(p, w, ps, id);
      std::fill(st.begin(), st.end(), 0);
      for (int c = 0; c < k; c++) {
        int* in = in_hits + (t.b * k + c) * L;
        auto mark = [&](long long src, int dst, int bytes) {
          for (int x = 0; x < bytes; x++) {
            const long long d = static_cast<long long>(c) * p.rowpitch + dst + x;
            if (d < 0 || d >= p.stage_bytes || dst + x >= p.rowpitch) {
              worst = -1;
              return;
            }
            in[src + x]++;
            st[d]++;
          }
        };
        if (p.mode == kBulk) {
          for (int j = 0; j < runs_per_row(p, t, w, ps); j++) {
            long long src;
            int dst, bytes;
            run_at(p, t, w, ps, j, &src, &dst, &bytes);
            mark(src, dst, bytes);
          }
        } else {
          for (int n = 0; n < pieces_per_row(t, w); n++) {
            long long src;
            int dst;
            piece_at(p, t, w, ps, n, &src, &dst);
            mark(src, dst, p.V);
          }
        }
      }
      if (worst < 0) return worst;
      long long staged = 0;
      for (int v : st) {
        if (v > worst) worst = v;
        staged += v;
      }
      if (p.mode == kBulk && staged != tile_bytes(p, t, w, k)) return -2;
      int* oh = out_hits + t.b * m * L;
      each_store(p, t, w * m, [&](int o, int tt, int jv) {
        for (int x = 0; x < p.V; x++)
          oh[out_offset(p, t, w, ps, L, o, tt, jv) + x]++;
      });
    }
  return worst;
}

// Bank conflicts of a warp's reads of one packet run: the most distinct
// words one bank serves in one phase (128 bytes of requests), over the
// first tile's groups.
int read_conflicts(int B, int k, int m, int w, int ps, long long L,
                   unsigned long long addr_or, int n_sm) {
  const Plan p = plan(ps, w, k, m, 220, L, B, addr_or, n_sm);
  const Tile t = tile_at(p, w, ps, 0);
  const int per_phase = p.V >= 4 ? 128 / p.V : 32;
  const int E = t.tb * t.runp;
  int worst = 1;
  for (int g = 0; g < groups(t); g++)
    for (int base = 0; base < 32; base += per_phase) {
      std::vector<std::vector<int>> words(32);
      for (int lane = base; lane < base + per_phase; lane++) {
        const int e = g * 32 + lane;
        if (e >= E) continue;
        int tt, jv;
        piece_spot(p, t, e, &tt, &jv);
        const int addr = tt * p.bpitch + jv * p.V;
        for (int x = 0; x < p.V; x += 4) {
          const int word = (addr + x) / 4;
          auto& ws = words[word % 32];
          bool seen = false;
          for (int v : ws) seen |= v == word;
          if (!seen) ws.push_back(word);
        }
      }
      for (auto& ws : words)
        if (static_cast<int>(ws.size()) > worst) worst = ws.size();
    }
  return worst;
}

}
"""

# the packet profiles of ceph_tpu's jerasure grid and the corpus, the
# default packet size, odd w, and the kernel's widest shapes
CASES = [  # (w, ps, k, m)
    (4, 8, 2, 2), (8, 8, 4, 3), (7, 8, 2, 2), (6, 8, 2, 2), (8, 8, 2, 2),
    (8, 64, 4, 2), (8, 2048, 2, 2), (3, 12, 5, 4), (5, 6, 3, 3),
    (32, 16, 8, 8), (16, 4, 16, 16)]
PLAN_ALL = PLAN_FIELDS + ("ppp", "bpitch", "spitch", "rowpitch",
                          "stage_bytes", "nb", "tiles_stripe", "ctas")
H100_SMS = 132
SMEM_PER_SM = 233472   # bytes an H100 SM gives its blocks (228 KiB)
SMEM_PER_BLOCK = 232448


@pytest.fixture(scope="module")
def shim(tmp_path_factory):
    """gf2_packet.cuh built for the host, behind a C shim."""
    cxx = shutil.which("g++") or shutil.which("c++")
    assert cxx, "a host C++ compiler is needed to build gf2_packet.cuh"
    d = tmp_path_factory.mktemp("gf2_packet")
    (d / "shim.cpp").write_text(SHIM)
    lib = d / "libshim.so"
    subprocess.run([cxx, "-std=c++17", "-O1", "-fno-strict-aliasing",
                    "-shared", "-fPIC", f"-I{CSRC}", "-o", str(lib),
                    str(d / "shim.cpp")],
                   check=True, capture_output=True, text=True)
    so = ctypes.CDLL(str(lib))
    P, LL, I, U = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, \
        ctypes.c_ulonglong
    so.plan_fields.argtypes = [I, I, I, I, I, LL, LL, U, I, P]
    so.plan_fields.restype = None
    so.fast_quotient.argtypes = [ctypes.c_uint, ctypes.c_uint]
    so.fast_quotient.restype = ctypes.c_uint
    so.model.argtypes = [ctypes.POINTER(P), LL, P, P, I, I, I, I, I, I, LL,
                         U, I]
    so.model.restype = None
    so.cover.argtypes = [I, I, I, I, I, LL, U, I, P, P, P]
    so.read_conflicts.argtypes = [I, I, I, I, I, LL, U, I]
    so.ring_tiles.argtypes = []
    return so


def _plan(so, ps, w, k, L, B=1, addr_or=0, n_sm=H100_SMS, m=3, npad=220):
    out = (ctypes.c_longlong * len(PLAN_ALL))()
    so.plan_fields(ps, w, k, m, npad, L, B, addr_or, n_sm, out)
    return dict(zip(PLAN_ALL, out))


def _model(so, bm, rows, stride, B, w, ps, L, out, n_sm):
    """The launch on the host: ``rows`` are k uint8 arrays (the row
    table) whose stripe b starts ``b * stride`` bytes in; ``out`` is a
    uint8 array [B, m, L] (its address counts for the piece width)."""
    k = bm.shape[1] // w
    m = bm.shape[0] // w
    lists = index_lists(torch.from_numpy(bm), w).numpy()
    table = (ctypes.c_void_p * k)(*[r.ctypes.data for r in rows])
    addr_or = stride | out.ctypes.data
    for r in rows:
        addr_or |= r.ctypes.data
    npad = len(lists) - 2 * w * m
    so.model(table, stride, out.ctypes.data, lists.ctypes.data, npad, B, k,
             m, w, ps, L, addr_or, n_sm)
    return _plan(so, ps, w, k, L, B, addr_or, n_sm, m, npad)


def _want(bm, data, w, ps):
    """ceph_tpu's bytes: its Layout's rows through _mod2_matmul."""
    lay = JLayout(w, ps)
    return np.stack([np.asarray(lay.from_rows(
        _mod2_matmul(bm, lay.to_rows(d)), bm.shape[0] // w, d.shape[1]))
        for d in data])


def _aligned(n):
    """n zero bytes starting at a 16-byte boundary."""
    buf = np.zeros(n + 16, np.uint8)
    off = (-buf.ctypes.data) % 16
    return buf[off:off + n]


def _run(so, bm, data, w, ps, n_sm, offset=0, spare=0):
    """``data`` [B, k, L] through the host launch, the stripes in place
    in one buffer (stride k*L + spare) whose rows start ``offset`` bytes
    past an aligned address; returns (output, plan)."""
    B, k, L = data.shape
    stride = k * L + spare
    buf = _aligned(B * stride + offset)
    for b in range(B):
        for c in range(k):
            s = offset + b * stride + c * L
            buf[s:s + L] = data[b, c]
    rows = [buf[offset + c * L:] for c in range(k)]
    out = _aligned(B * (bm.shape[0] // w) * L).reshape(B, -1, L)
    return out, _model(so, bm, rows, stride, B, w, ps, L, out, n_sm)


def _check(so, w, ps, k, m, L, B=1, runs=((H100_SMS, 0, 0),), seed=0):
    """Random bits and data through the host launch, once for each
    (n_sm, offset, spare) of ``runs``, against the plain version and
    ``ceph_tpu``; returns the plans."""
    rng = np.random.default_rng(seed)
    bm = rng.integers(0, 2, (w * m, w * k), dtype=np.uint8)
    data = rng.integers(0, 256, (B, k, L), dtype=np.uint8)
    want = _want(bm, data, w, ps)
    plain = gf2_packet_plain(torch.from_numpy(bm), torch.from_numpy(data),
                             w, ps).numpy()
    assert np.array_equal(plain, want)
    plans = []
    for n_sm, offset, spare in runs:
        got, plan = _run(so, bm, data, w, ps, n_sm, offset, spare)
        assert np.array_equal(got, want), (n_sm, offset, spare, plan)
        plans.append(plan)
    return plans


def _cover(so, w, ps, k, m, L, B=1, addr_or=0, n_sm=H100_SMS):
    plan = _plan(so, ps, w, k, L, B, addr_or, n_sm, m,
                 w * m * (w * k // 2 + 3))
    in_hits = np.zeros((B, k, L), np.int32)
    out_hits = np.zeros((B, m, L), np.int32)
    tile_hits = np.zeros(plan["tiles"], np.int32)
    worst = so.cover(B, k, m, w, ps, L, addr_or, n_sm, in_hits.ctypes.data,
                     out_hits.ctypes.data, tile_hits.ctypes.data)
    assert worst == 1, (worst, plan)     # no copy overlaps another
    assert (in_hits == 1).all(), plan    # each input byte staged once
    assert (out_hits == 1).all(), plan   # each output byte stored once
    assert (tile_hits == 1).all(), plan  # each tile walked by one block
    return plan


def test_index_lists_name_every_set_bit():
    """The index lists hold each row's set bits, in column order, as
    (c << 16) | r', each row from a multiple of 4 entries: byte for byte
    the matrix's bits."""
    rng = np.random.default_rng(0)
    for w, m, k in ((8, 3, 4), (4, 2, 2), (7, 2, 2), (32, 8, 8),
                    (16, 16, 16), (1, 1, 5)):
        bm = rng.integers(0, 2, (w * m, w * k), dtype=np.uint8)
        bm[0] = 0                       # an empty row
        lists = index_lists(torch.from_numpy(bm), w).numpy()
        wm = w * m
        starts, ends, ent = lists[:wm], lists[wm:2 * wm], lists[2 * wm:]
        assert (starts % 4 == 0).all() and (ends >= starts).all()
        assert len(ent) == ((ends - starts + 3) // 4 * 4).sum()
        assert (ent < 0).sum() == len(ent) - bm.sum()    # the pads
        assert (ends - starts).sum() == bm.sum()
        for o in range(wm):
            cols = [(x >> 16) * w + (x & 0xffff)
                    for x in ent[starts[o]:ends[o]]]
            assert cols == list(np.flatnonzero(bm[o])), (w, m, k, o)


def test_fast_division_is_exact(shim):
    ns = np.concatenate([np.arange(5000), np.array(
        [2**20 - 1, 2**20, 65535 * 257, 2**31 - 1])])
    for d in list(range(1, 300)) + [511, 512, 513, 1000, 2056, 65535]:
        for n in ns[::7] if d > 40 else ns:
            assert shim.fast_quotient(d, int(n)) == int(n) // d, (d, n)


@pytest.mark.parametrize("w,ps,k,m", CASES)
def test_units_cover_every_byte_once(shim, w, ps, k, m):
    """Every input byte staged once, every output byte stored once, every
    tile walked by one block, no stage written twice in a tile: whole
    blocks (one SM, several tiles, the last one short) and column ranges
    where the packet is large enough (132 SMs), at each piece width the
    packet size allows."""
    L = w * ps * 37
    for V in (16, 8, 4, 2, 1):
        if ps % V:
            continue
        for n_sm in (1, H100_SMS):
            plan = _cover(shim, w, ps, k, m, L, B=2, addr_or=V, n_sm=n_sm)
            assert plan["vec_bytes"] == V


@pytest.mark.parametrize("w,ps,k,m", CASES)
def test_thread_body_matches_plain_and_jax(shim, w, ps, k, m):
    """The whole launch on the host, 2 stripes in place ([B, k, L],
    stride k*L), on 1 SM (whole blocks, the last tile short) and 132
    (column ranges where the packet allows), rows aligned and at odd
    offsets."""
    runs = [(n_sm, offset, 0) for n_sm in (1, H100_SMS)
            for offset in (0, 1, 2, 4, 8)]
    plans = _check(shim, w, ps, k, m, w * ps * 37, B=2, runs=runs,
                   seed=w * 1000 + ps + k * 10 + m)
    for (_, offset, _), plan in zip(runs, plans):
        assert plan["vec_bytes"] == min(ps & -ps, offset & -offset or 16, 16)


def test_tile_ends_inside_the_last_block(shim):
    """Column ranges that do not divide the packet (129 pieces of 16
    bytes in ranges of 9: the last of each block 3 pieces), and whole
    blocks whose last tile is short (71 blocks in tiles of 36)."""
    plan, = _check(shim, 8, 2064, 3, 2, 8 * 2064 * 2)
    assert plan["blocks_per_tile"] == 0 and plan["run_pieces"] == 9
    assert plan["ranges_per_block"] == 15   # 14 x 9 + 3
    _cover(shim, 8, 2064, 3, 2, 8 * 2064 * 2)
    plan, = _check(shim, 8, 8, 4, 3, 8 * 8 * 71, runs=((1, 0, 0),))
    assert plan["blocks_per_tile"] == 36 and plan["tiles"] == 2


def test_column_ranges_of_a_large_packet(shim):
    """Packet size 2048 (jerasure's default) at a 4 MiB object's chunks
    is cut into column ranges, bulk-copied, a tile for every block of
    the grid; the same on the host at 2 blocks."""
    L = 1 << 20
    plan = _plan(shim, 2048, 8, 4, L)
    assert plan["mode"] == 0 and plan["blocks_per_tile"] == 0
    assert plan["tiles"] == plan["grid"] <= 2 * H100_SMS
    assert plan["run_pieces"] * 16 * plan["ranges_per_block"] >= 2048
    plan, = _check(shim, 8, 2048, 4, 3, 8 * 2048 * 2)
    assert plan["blocks_per_tile"] == 0 and plan["ranges_per_block"] == 16


def test_rows_read_where_they_lie(shim):
    """A decode's survivors at odd offsets of one buffer: plain copies of
    single bytes, and the row table reads them in place."""
    rng = np.random.default_rng(7)
    w, ps, k, m, L = 8, 8, 4, 4, 8 * 8 * 70
    bm = rng.integers(0, 2, (w * m, w * k), dtype=np.uint8)
    data = rng.integers(0, 256, (k, L), dtype=np.uint8)
    buf = np.zeros(k * (L + 3) + 1, np.uint8)
    rows = []
    for c in range(k):
        off = 1 + c * (L + 3)
        buf[off:off + L] = data[c]
        rows.append(buf[off:])
    out = np.zeros((1, m, L), np.uint8)
    plan = _model(shim, bm, rows, 0, 1, w, ps, L, out, H100_SMS)
    assert plan["vec_bytes"] == 1 and plan["mode"] == 2
    assert np.array_equal(out[0], _want(bm, data[None], w, ps)[0])


def test_batch_with_a_stripe_stride(shim):
    """B > 1 stripes whose rows lie k*L + 48 bytes apart (not k*L): the
    stride moves every row of a stripe; 16-byte pieces stay bulk."""
    for w, ps, spare in ((8, 2048, 48), (8, 8, 48), (8, 8, 8), (7, 8, 4)):
        plan, = _check(shim, w, ps, 4, 3, w * ps * 19, B=3,
                       runs=((2, 0, spare),), seed=ps + spare)
        assert plan["vec_bytes"] == min(ps & -ps, spare & -spare, 16)


def test_widest_matrices(shim):
    """w*k = w*m = 256: k = m = 32 at w=8 (the row table's limit), w=32
    and w=256 with a single row; each stage still fits."""
    for w, ps, k, m in ((8, 8, 32, 32), (8, 2048, 32, 32), (32, 16, 8, 8),
                        (256, 8, 1, 1), (256, 16, 1, 1)):
        plan, = _check(shim, w, ps, k, m, w * ps * 9, runs=((2, 0, 0),),
                       seed=w + k)
        assert plan["smem_bytes"] <= SMEM_PER_BLOCK, plan
        assert plan["ctas"] == 1 or 2 * (plan["smem_bytes"] + 1024) \
            <= SMEM_PER_SM, plan
        _cover(shim, w, ps, k, m, w * ps * 9, n_sm=2)


def test_vector_width_and_block_size(shim):
    """A 4 MiB object (k=4, m=3: [4, 1 MiB]) and 4 of them at w=8: two
    blocks of the grid an SM, each taking about the same number of
    tiles; every tile of the launch in flight at once (each block's
    ring), or at least 32 KiB an SM; two blocks' shared memory within an
    SM's; the widest vector the packet size and the addresses allow."""
    L = 1 << 20
    for ps in (8, 16, 64, 2048):
        for B in (1, 4):
            p = _plan(shim, ps, 8, 4, L, B)
            assert p["vec_bytes"] == min(ps, 16)
            assert p["ctas"] == 2 and p["grid"] >= 0.95 * 2 * H100_SMS
            most = -(-p["tiles"] // p["grid"])
            assert most <= 1.15 * p["tiles"] / p["grid"], (ps, B, p)
            assert 2 * (p["smem_bytes"] + 1024) <= SMEM_PER_SM
            tile_in = 4 * 8 * (p["blocks_per_tile"] * ps
                               or p["run_pieces"] * p["vec_bytes"])
            ring = shim.ring_tiles()
            assert p["tiles"] <= ring * p["grid"] \
                or 2 * ring * tile_in >= 32 * 1024, (ps, B, p)
    assert _plan(shim, 8, 8, 4, L)["mode"] == 1          # cp.async
    assert _plan(shim, 2048, 8, 4, L)["mode"] == 0       # bulk
    assert _plan(shim, 12, 8, 4, L)["vec_bytes"] == 4
    assert _plan(shim, 6, 8, 4, L)["vec_bytes"] == 2
    assert _plan(shim, 2048, 8, 4, L, addr_or=0x1004)["vec_bytes"] == 4
    assert _plan(shim, 2048, 8, 4, L, addr_or=0x1001)["mode"] == 2
    # no halving to fill the card: a small launch keeps its vectors and
    # fills a warp's lanes
    assert _plan(shim, 2048, 8, 4, 8 * 2048)["vec_bytes"] == 16
    assert _plan(shim, 8, 8, 4, 8 * 8 * 256)["blocks_per_tile"] == 32


def test_warps_read_without_bank_conflicts(shim):
    """The staged layout puts the pieces a warp reads together (one
    packet of consecutive blocks) in distinct banks: 8-byte packets at
    w = 8, 4, 6, 7; 16-byte pieces of 16- to 2048-byte packets."""
    L = 1 << 20
    for w, ps in ((8, 8), (4, 8), (6, 8), (7, 8), (8, 16), (8, 32), (8, 64),
                  (8, 128), (8, 2048), (16, 4)):
        k = min(4, 256 // w)
        assert shim.read_conflicts(1, k, 3, w, ps, L, 0, H100_SMS) == 1, \
            (w, ps)
