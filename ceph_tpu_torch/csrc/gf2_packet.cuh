// gf2_packet.cuh — the index math of kernel K3 (gf2_packet.cu), the GF(2)
// product of the packet layouts, and one lane's work over a staged tile.
//
// A chunk of L bytes is nb = L / (w * ps) blocks of w packets of ps
// bytes; packet r of block b starts at byte b*w*ps + r*ps.  Output packet
// (p, r) of each block is the bytewise XOR of the input packets (c, r')
// whose bit BM[p*w + r][c*w + r'] is 1.  The bit matrix comes as index
// lists (int32): the w*m starts of the rows' lists, the w*m ends, then
// the entries, one a set bit, (c << 16) | r'; row o's entries are
// [starts[o], ends[o]) of them, and each row starts at a multiple of 4
// (pads, -1, fill the rows out; they name a row of zeros).
//
// Tiles.  The launch cuts every stripe into tiles, and a persistent grid
// walks them: tile i of the launch goes to block i % grid.  A tile is
//  - T consecutive whole blocks of a stripe (the last tile of a stripe
//    may hold fewer), or, where a block is too large for a stage or too
//    few blocks would fill the card,
//  - a column range of one block: the same J bytes of each of its w
//    packets (the last range of a block may be shorter).
// Each of the k input rows of a tile is staged in shared memory: block t
// of the tile at t * bpitch bytes, its packet r' at r' * spitch within
// it.  For whole blocks spitch = ps and bpitch = w*ps plus a pad that
// puts the same packet of neighbouring blocks in other banks; for a
// column range spitch = J.  Row c of a stage starts at c * rowpitch, and
// a row of zeros follows the k input rows (what the lists' pads read).
//
// Work.  The tile's bytes of one packet run are E = tb * runp pieces of V
// bytes (V, the widest of 16, 8, 4, 2, 1 that divides ps and every row
// address; runp pieces a packet in the tile), in groups of 32, one a
// lane.  A block first turns the index lists into 16-bit offsets in a
// stage (c * rowpitch + r' * spitch), kept in shared memory for the
// whole launch, four to a load.  A work item is one group and one
// output row; the warps of a block take the items in turn.  A lane finds
// its piece once a group, then XORs that piece of the input runs each
// row's list names into four accumulators (the list is the same for the
// whole warp, so its loads broadcast; rows padded to 4 entries run with
// no branch) and stores it straight to the output chunk.  The grid is
// sized so that every block takes the same number of tiles.  Each input
// byte is read from device memory once and each output byte written
// once.
//
// These functions compile for the device and for the host
// (tests/test_torch_gf2_packet_model.py builds them with a host compiler
// and runs a launch's tiles, staging and lanes against the plain
// version).  The copies and barriers are in gf2_packet.cu.

#pragma once

#include <cstdint>

#ifdef __CUDACC__
#define GF2P_HD __host__ __device__ __forceinline__
#else
#define GF2P_HD inline
#endif

namespace gf2p {

constexpr int kMaxRows = 32;       // input and output chunks (row tables)
constexpr int kMaxBits = 256;      // w*k and w*m
constexpr int kThreads = 256;      // a block of the grid
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 3;         // the ring of staged tiles
constexpr int kSmemTwo = 113 * 1024;  // a block's shared bytes, two an SM
constexpr int kSmemOne = 227 * 1024;  // a block's shared bytes, one an SM
constexpr int kListsTwo = 16 * 1024;  // lists that still leave two an SM
constexpr int kStageMax = 65520;   // a stage's bytes: offsets are 16-bit
constexpr int kHeadBytes = 384;    // the stages' barriers and the row table
constexpr int kTilesPerCta = 1;    // tiles a block of the grid takes, at least
constexpr int kMinRangePieces = 8;  // pieces of a column range, at least
constexpr int kBulkMinRun = 512;   // bytes of a bulk copy, at least

enum Mode {
  kBulk = 0,   // V = 16, runs of kBulkMinRun bytes or more: cp.async.bulk
  kAsync = 1,  // V = 16, 8, 4: cp.async of pieces
  kSync = 2,   // V = 2, 1: loads and stores of pieces
};

struct alignas(16) U128 {
  uint32_t x[4];
};
struct alignas(8) U64 {
  uint32_t x[2];
};

template <int V> struct VecT;
template <> struct VecT<16> { typedef U128 type; };
template <> struct VecT<8> { typedef U64 type; };
template <> struct VecT<4> { typedef uint32_t type; };
template <> struct VecT<2> { typedef uint16_t type; };
template <> struct VecT<1> { typedef uint8_t type; };

GF2P_HD U128 vxor(U128 a, U128 b) {
  for (int i = 0; i < 4; i++) a.x[i] ^= b.x[i];
  return a;
}
GF2P_HD U64 vxor(U64 a, U64 b) {
  for (int i = 0; i < 2; i++) a.x[i] ^= b.x[i];
  return a;
}
GF2P_HD uint32_t vxor(uint32_t a, uint32_t b) { return a ^ b; }
GF2P_HD uint16_t vxor(uint16_t a, uint16_t b) {
  return static_cast<uint16_t>(a ^ b);
}
GF2P_HD uint8_t vxor(uint8_t a, uint8_t b) {
  return static_cast<uint8_t>(a ^ b);
}

// n / d by a multiply and a shift, for 0 <= n < 2^31 (CUTLASS's
// FastDivmod): mul = ceil(2^(31 + ceil(log2 d)) / d).
struct FastDiv {
  uint32_t d, mul, shift;
};

GF2P_HD FastDiv fast_div(uint32_t d) {
  FastDiv f{d, 0, 0};
  if (d > 1) {
    uint32_t l = 0;
    while ((1ull << l) < d) l++;
    const uint32_t p = 31 + l;
    f.mul = static_cast<uint32_t>(((1ull << p) + d - 1) / d);
    f.shift = p - 32;
  }
  return f;
}

GF2P_HD uint32_t fdiv(const FastDiv& f, uint32_t n) {
  if (f.d == 1) return n;
#ifdef __CUDA_ARCH__
  return __umulhi(n, f.mul) >> f.shift;
#else
  return static_cast<uint32_t>((static_cast<uint64_t>(n) * f.mul) >> 32) >>
         f.shift;
#endif
}

// A launch's plan: its piece width, tiles, shared memory and grid.
struct Plan {
  int V, mode;
  int T;          // whole blocks a tile; 0: column-range tiles
  int nr;         // column ranges a block (column-range tiles)
  int runp;       // pieces of a packet run in a full tile's block
  int ppp;        // pieces a packet: ps / V
  int bpitch;     // staged bytes between blocks (whole-block tiles)
  int spitch;     // staged bytes between packets of a block
  int rowpitch;   // staged bytes between rows (a multiple of 16)
  int zero_at;    // a stage's zero row, after its k input rows
  int lists_at, stages_at;  // shared memory offsets
  int stage_bytes, smem_bytes;
  int ctas;       // blocks an SM holds
  int grid;
  long long nb;            // blocks a stripe
  long long tiles_stripe;  // tiles a stripe
  long long tiles;         // tiles of the launch
  FastDiv fd_ppp;   // e -> block of the tile (whole blocks)
  FastDiv fd_wppp;  // a staged piece's natural index -> block of the tile
  FastDiv fd_w;     // output row -> output chunk
  FastDiv fd_wm;    // work item -> group
};

// Bytes a block takes in a staged row: w packets, and for packets
// narrower than a bank row (128 bytes) a pad of one packet when w is
// even, so that packet r' of blocks t, t+1, ... (what a warp's lanes
// read together) falls in distinct banks.
GF2P_HD int block_pitch(int w, int ps, int V) {
  const int ppp = ps / V;
  const int q = V >= 4 ? 128 / V : 32;   // pieces a bank row holds
  return (ppp < q && w % 2 == 0 ? w + 1 : w) * ps;
}

GF2P_HD int round16(long long n) { return static_cast<int>((n + 15) / 16 * 16); }

// Shared bytes of the index lists: the w*m starts and ends, then an
// offset (16 bits) an entry, rows padded to 4 entries (npad in all).
GF2P_HD int lists_bytes(int wm, int npad) {
  return round16(8ll * wm + 2ll * npad);
}

// The plan of a launch of B stripes of k rows of L bytes in the packet
// layout (w, ps) with m output rows and npad list entries (padded),
// whose row addresses and stripe stride OR to `addr_or`, on a card of
// n_sm SMs.
GF2P_HD Plan plan(int ps, int w, int k, int m, int npad, long long L,
                  long long B, unsigned long long addr_or, int n_sm) {
  Plan p{};
  int V = 16;
  while (V > 1 && (ps % V || (addr_or % static_cast<unsigned>(V)))) V >>= 1;
  p.V = V;
  p.ppp = ps / V;
  p.nb = L / (static_cast<long long>(w) * ps);
  const int lb = lists_bytes(w * m, npad);
  p.ctas = lb <= kListsTwo ? 2 : 1;
  int rowcap = ((p.ctas == 2 ? kSmemTwo : kSmemOne) - kHeadBytes - lb) /
               (kStages * (k + 1));
  if (rowcap > kStageMax / (k + 1)) rowcap = kStageMax / (k + 1);
  rowcap = rowcap / 16 * 16;
  const long long slots = static_cast<long long>(n_sm) * p.ctas;
  const long long blocks = B * p.nb;
  const int bpitch = block_pitch(w, ps, V);
  const bool ranges = bpitch > rowcap ||
                      (blocks < slots * kTilesPerCta &&
                       p.ppp >= 2 * kMinRangePieces);
  if (!ranges) {
    // the same number of tiles for every block of the grid: the fewest
    // whose share of blocks a stage holds
    long long most = rowcap / bpitch;
    if (most > p.nb) most = p.nb;
    if (most < 1) most = 1;
    const long long share = (blocks + slots - 1) / slots;
    long long n = (share + most - 1) / most;
    if (n < kTilesPerCta) n = kTilesPerCta;
    long long T = (share + n - 1) / n;
    const long long lanes = (32 + p.ppp - 1) / p.ppp;   // a group's pieces
    if (T < lanes) T = lanes;   // a small launch: fewer, fuller tiles
    if (T > most) T = most;
    p.T = static_cast<int>(T);
    p.nr = 1;
    p.runp = p.ppp;
    p.bpitch = bpitch;
    p.spitch = ps;
    p.rowpitch = round16(static_cast<long long>(p.T) * bpitch);
    p.tiles_stripe = (p.nb + p.T - 1) / p.T;
  } else {
    int most = rowcap / w / V;   // pieces of a range a stage can hold
    if (most < 1) most = 1;
    long long nr = (p.ppp + most - 1) / most;
    // split blocks to give every block of the grid a tile, never more
    long long split = slots * kTilesPerCta / blocks;
    if (split > p.ppp / kMinRangePieces) split = p.ppp / kMinRangePieces;
    if (nr < split) nr = split;
    p.runp = static_cast<int>((p.ppp + nr - 1) / nr);
    p.nr = (p.ppp + p.runp - 1) / p.runp;
    p.T = 0;
    p.spitch = p.runp * V;
    p.bpitch = w * p.spitch;
    p.rowpitch = round16(p.bpitch);
    p.tiles_stripe = p.nb * p.nr;
  }
  // a bulk copy a row (unpadded whole blocks), a block or a packet
  const int run = !p.T ? p.spitch : p.bpitch == w * ps ? p.T * w * ps
                                                       : w * ps;
  p.mode = V < 4 ? kSync : V == 16 && run >= kBulkMinRun ? kBulk : kAsync;
  p.tiles = B * p.tiles_stripe;
  p.zero_at = k * p.rowpitch;
  p.stage_bytes = (k + 1) * p.rowpitch;
  p.lists_at = kHeadBytes;
  p.stages_at = p.lists_at + lb;
  p.smem_bytes = p.stages_at + kStages * p.stage_bytes;
  p.grid = static_cast<int>(p.tiles < slots ? p.tiles : slots);
  p.fd_ppp = fast_div(static_cast<uint32_t>(p.ppp));
  p.fd_wppp = fast_div(static_cast<uint32_t>(w * p.ppp));
  p.fd_w = fast_div(static_cast<uint32_t>(w));
  p.fd_wm = fast_div(static_cast<uint32_t>(w * m));
  return p;
}

// Tiles a block of the grid walks: grid-stride from its own index.
GF2P_HD long long tiles_of(const Plan& p, int block) {
  return block < p.tiles ? (p.tiles - block + p.grid - 1) / p.grid : 0;
}

// One tile: its stripe, the byte offset of its origin in a chunk, its
// blocks and the pieces of its packet runs.
struct Tile {
  long long b, goff;
  int tb, runp;
};

GF2P_HD Tile tile_at(const Plan& p, int w, int ps, long long id) {
  Tile t;
  t.b = id / p.tiles_stripe;
  const long long ti = id - t.b * p.tiles_stripe;
  const long long blk_bytes = static_cast<long long>(w) * ps;
  if (p.T) {
    const long long b0 = ti * p.T;
    t.tb = static_cast<int>(p.nb - b0 < p.T ? p.nb - b0 : p.T);
    t.goff = b0 * blk_bytes;
    t.runp = p.ppp;
  } else {
    const long long blk = ti / p.nr;
    const int q = static_cast<int>(ti - blk * p.nr);
    const int j0 = q * p.runp;
    t.tb = 1;
    t.goff = blk * blk_bytes + static_cast<long long>(j0) * p.V;
    t.runp = p.ppp - j0 < p.runp ? p.ppp - j0 : p.runp;
  }
  return t;
}

// Bulk staging: a tile's row is `runs` contiguous runs of global memory;
// run j is `bytes` bytes from `src` (a chunk offset) to `dst` (a staged
// row offset).  One run of the whole tile when blocks sit unpadded, a
// run a block when padded, a run a packet for a column range.
GF2P_HD int runs_per_row(const Plan& p, const Tile& t, int w, int ps) {
  if (!p.T) return w;
  return p.bpitch == w * ps ? 1 : t.tb;
}

GF2P_HD void run_at(const Plan& p, const Tile& t, int w, int ps, int j,
                    long long* src, int* dst, int* bytes) {
  if (!p.T) {
    *src = t.goff + static_cast<long long>(j) * ps;
    *dst = j * p.spitch;
    *bytes = t.runp * p.V;
  } else if (p.bpitch == w * ps) {
    *src = t.goff;
    *dst = 0;
    *bytes = t.tb * w * ps;
  } else {
    *src = t.goff + static_cast<long long>(j) * w * ps;
    *dst = j * p.bpitch;
    *bytes = w * ps;
  }
}

// Bytes a tile stages, all rows (a stage's barrier expects them).
GF2P_HD int tile_bytes(const Plan& p, const Tile& t, int w, int k) {
  return k * w * t.tb * t.runp * p.V;
}

// Piece staging: a tile's row is `pieces_per_row` pieces of V bytes;
// piece n (in the order of the chunk's bytes) comes from `src` (a chunk
// offset) to `dst` (a staged row offset).
GF2P_HD int pieces_per_row(const Tile& t, int w) {
  return t.tb * w * t.runp;
}

GF2P_HD void piece_at(const Plan& p, const Tile& t, int w, int ps, int n,
                      long long* src, int* dst) {
  if (p.T) {   // block n / (w * ppp), padded by bpitch - w*ps
    const int tt = static_cast<int>(fdiv(p.fd_wppp, static_cast<uint32_t>(n)));
    *src = t.goff + static_cast<long long>(n) * p.V;
    *dst = n * p.V + tt * (p.bpitch - w * ps);
  } else {
    const int r = n / t.runp;
    const int jv = n - r * t.runp;
    *src = t.goff + static_cast<long long>(r) * ps +
           static_cast<long long>(jv) * p.V;
    *dst = r * p.spitch + jv * p.V;
  }
}

// Groups of 32 pieces of a tile.
GF2P_HD int groups(const Tile& t) { return (t.tb * t.runp + 31) / 32; }

// Piece e of a tile: block tt of the tile, piece jv of its packet run.
GF2P_HD void piece_spot(const Plan& p, const Tile& t, int e, int* tt,
                        int* jv) {
  *tt = p.T ? static_cast<int>(fdiv(p.fd_ppp, static_cast<uint32_t>(e))) : 0;
  *jv = e - *tt * t.runp;
}

// Where piece (tt, jv) of output row o goes, from the stripe's first
// output chunk.
GF2P_HD long long out_offset(const Plan& p, const Tile& t, int w, int ps,
                             long long L, int o, int tt, int jv) {
  const int pc = static_cast<int>(fdiv(p.fd_w, static_cast<uint32_t>(o)));
  return pc * L + t.goff + static_cast<long long>(tt) * w * ps +
         static_cast<long long>(o - pc * w) * ps +
         static_cast<long long>(jv) * p.V;
}

// A stage offset of each list entry, (c << 16 | r') -> c * rowpitch +
// r' * spitch; a pad (-1) -> the stage's zero row.
GF2P_HD uint16_t entry_offset(const Plan& p, int x) {
  return static_cast<uint16_t>(
      x < 0 ? p.zero_at : (x >> 16) * p.rowpitch + (x & 0xffff) * p.spitch);
}

// Work items of a tile: (group, output row) pairs, item g * wm + o; a
// warp takes items warp, warp + kWarps, ...
GF2P_HD int items(const Tile& t, int wm) { return groups(t) * wm; }

// One lane's work on a tile staged at `stage`: for each item of its
// warp, its piece of output row o, the XOR of that piece of the input
// runs the row's list names (`bounds`: the w*m starts, then the w*m ends;
// `offs`: entry offsets, 8-byte aligned, each row padded to 4 entries
// with the zero row's offset), stored to the stripe's output chunks
// `out`.
template <int V>
GF2P_HD void lane_tile(const Plan& p, const Tile& t, const int* bounds,
                       const uint16_t* offs, int wm, int w, int ps,
                       long long L, const uint8_t* stage, uint8_t* out,
                       int warp, int lane) {
  typedef typename VecT<V>::type Vec;
  const int E = t.tb * t.runp;
  const int n = items(t, wm);
  int g = -1, tt = 0, jv = 0;
  const uint8_t* src = stage;
  for (int it = warp; it < n; it += kWarps) {
    const int gi = static_cast<int>(fdiv(p.fd_wm, static_cast<uint32_t>(it)));
    if (gi != g) {   // a new group: this lane's piece of it
      g = gi;
      const int e = g * 32 + lane;
      if (e >= E) return;   // and in every later group
      piece_spot(p, t, e, &tt, &jv);
      src = stage + tt * p.bpitch + jv * V;
    }
    const int o = it - g * wm;
    Vec a0 = Vec(), a1 = Vec(), a2 = Vec(), a3 = Vec();
    const int end = (bounds[wm + o] + 3) & ~3;
    int i = bounds[o];
    for (; i + 8 <= end; i += 8) {   // eight loads in flight
      const U64 q = *reinterpret_cast<const U64*>(offs + i);
      const U64 r = *reinterpret_cast<const U64*>(offs + i + 4);
      a0 = vxor(a0, *reinterpret_cast<const Vec*>(src + (q.x[0] & 0xffff)));
      a1 = vxor(a1, *reinterpret_cast<const Vec*>(src + (q.x[0] >> 16)));
      a2 = vxor(a2, *reinterpret_cast<const Vec*>(src + (q.x[1] & 0xffff)));
      a3 = vxor(a3, *reinterpret_cast<const Vec*>(src + (q.x[1] >> 16)));
      a0 = vxor(a0, *reinterpret_cast<const Vec*>(src + (r.x[0] & 0xffff)));
      a1 = vxor(a1, *reinterpret_cast<const Vec*>(src + (r.x[0] >> 16)));
      a2 = vxor(a2, *reinterpret_cast<const Vec*>(src + (r.x[1] & 0xffff)));
      a3 = vxor(a3, *reinterpret_cast<const Vec*>(src + (r.x[1] >> 16)));
    }
    if (i < end) {   // four entries a load
      const U64 q = *reinterpret_cast<const U64*>(offs + i);
      a0 = vxor(a0, *reinterpret_cast<const Vec*>(src + (q.x[0] & 0xffff)));
      a1 = vxor(a1, *reinterpret_cast<const Vec*>(src + (q.x[0] >> 16)));
      a2 = vxor(a2, *reinterpret_cast<const Vec*>(src + (q.x[1] & 0xffff)));
      a3 = vxor(a3, *reinterpret_cast<const Vec*>(src + (q.x[1] >> 16)));
    }
    *reinterpret_cast<Vec*>(out + out_offset(p, t, w, ps, L, o, tt, jv)) =
        vxor(vxor(a0, a1), vxor(a2, a3));
  }
}

}  // namespace gf2p
