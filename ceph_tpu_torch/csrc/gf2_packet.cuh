// gf2_packet.cuh — the index math and one thread's work of kernel K3
// (gf2_packet.cu), the GF(2) product of the packet layouts.
//
// A chunk of L bytes is nb = L / (w * ps) blocks of w packets of ps
// bytes; packet r of block b starts at byte b*w*ps + r*ps.  Output
// packet (p, r) of each block is the bytewise XOR of the input packets
// (c, r') whose bit BM[p*w + r][c*w + r'] is 1.  The bit matrix comes as
// one mask of 32-bit words a row: bit i of word q of row o is
// BM[o][32q + i].
//
// Work is cut into units: a unit is V bytes at one offset j of a packet
// column (V divides ps) in one block, the same offset of every input
// and output packet of that block.  Unit u of a stripe is block
// u / (ps / V), offset (u % (ps / V)) * V.  A thread owns one unit: it
// reads the w*k input vectors of its unit once into its own column of
// a scratch array in shared memory (vector i of thread t at i*nt + t;
// no thread reads another's column, so no barrier is needed), then
// writes each of the w*m output vectors as the XOR of the vectors its
// mask row selects.
//
// These functions compile for the device and for the host
// (tests/test_torch_gf2_packet_model.py builds them with a host compiler
// and runs a thread's work over every unit against the plain version).

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
constexpr int kMaxThreads = 256;   // a block
constexpr int kScratchBytes = 128 * 1024;  // the vectors of a block's units
constexpr long long kMinUnits = 1ll << 15;  // wide enough to fill the card

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

GF2P_HD int ctz32(uint32_t v) {
#ifdef __CUDA_ARCH__
  return __ffs(static_cast<int>(v)) - 1;
#else
  return __builtin_ctz(v);
#endif
}

// Mask words a bit-matrix row takes for `cols` columns.
GF2P_HD int mask_words(int cols) { return (cols + 31) / 32; }

// Units of one stripe: L / (w * V).
GF2P_HD long long units_per_stripe(long long L, int w, int V) {
  return L / (static_cast<long long>(w) * V);
}

// Byte offset of unit u's vector in packet 0 of its block.
GF2P_HD long long unit_offset(long long u, int w, int ps, int V) {
  const int per = ps / V;
  const long long b = u / per;
  const int j = static_cast<int>(u - b * per) * V;
  return b * w * ps + j;
}

// The vector width: the widest of 16, 8, 4, 2, 1 bytes that divides ps
// and every row address and stride (`addr_or`: their bitwise OR), then
// halved, down to 4, while the launch (`stripes` x L / w bytes of each
// packet row) would have fewer than kMinUnits units.
GF2P_HD int vec_bytes(int ps, unsigned long long addr_or, long long stripes,
                      long long L, int w) {
  int V = 16;
  while (V > 1 && (ps % V || (addr_or % static_cast<unsigned>(V))))
    V >>= 1;
  while (V > 4 && stripes * units_per_stripe(L, w, V) < kMinUnits) V >>= 1;
  return V;
}

// Threads a block: kMaxThreads, halved (not below 32) until the block's
// vectors fit kScratchBytes.
GF2P_HD int block_threads(int wk, int V) {
  int nt = kMaxThreads;
  while (nt > 32 && static_cast<long long>(wk) * nt * V > kScratchBytes)
    nt >>= 1;
  return nt;
}

// Shared memory of a block: the masks (rounded to 16 bytes), the input
// row table, then the scratch vectors.
GF2P_HD int mask_bytes(int wm, int wk) {
  return (wm * mask_words(wk) * 4 + 15) / 16 * 16;
}
GF2P_HD int table_bytes() { return kMaxRows * 8; }
GF2P_HD int shared_bytes(int wm, int wk, int nt, int V) {
  return mask_bytes(wm, wk) + table_bytes() + wk * nt * V;
}

// One thread's unit: `rows[c] + in_off` is packet 0 of the unit's block
// in input chunk c (at the unit's offset), `out + p * L + out_off` the
// same in output chunk p.  `scratch` is the block's vectors, nt of them
// a row; the thread's own are at t.
template <int V>
GF2P_HD void packet_unit(const uint8_t* const* rows, long long in_off,
                         uint8_t* out, long long out_off, long long L, int w,
                         int ps, int k, int m, const uint32_t* masks,
                         typename VecT<V>::type* scratch, int nt, int t) {
  typedef typename VecT<V>::type T;
  for (int c = 0; c < k; c++) {
    const uint8_t* src = rows[c] + in_off;
    for (int r = 0; r < w; r++)
      scratch[(c * w + r) * nt + t] =
          *reinterpret_cast<const T*>(src + static_cast<long long>(r) * ps);
  }
  const int nw = mask_words(w * k);
  for (int p = 0; p < m; p++) {
    uint8_t* dst = out + p * L + out_off;
    for (int r = 0; r < w; r++) {
      const uint32_t* mask = masks + (p * w + r) * nw;
      T acc = T();
      for (int q = 0; q < nw; q++) {
        uint32_t bits = mask[q];
        while (bits) {
          const int i = ctz32(bits);
          bits &= bits - 1;
          acc = vxor(acc, scratch[(q * 32 + i) * nt + t]);
        }
      }
      *reinterpret_cast<T*>(dst + static_cast<long long>(r) * ps) = acc;
    }
  }
}

}  // namespace gf2p
