// gf2_layout.cuh — where kernel K1 (gf2_matmul_w8.cu) keeps each bit.
//
// K1 runs the GF(2) bit-matmul on the tensor cores with the 1-bit
// product mma.sync.m16n8k256.row.col.s32.b1.b1.s32.and.popc:
// D[r][n] = popcount(A row r AND B column n) over K = 256 bits, so bit 0
// of D is the parity of the AND.  M = output bits, K = input bits,
// N = byte columns.  These functions are the whole mapping between
// bytes, bits, lanes and fragment registers.  They compile for the
// device and for the host (tests/test_torch_gf2_layout.py builds them
// with a host compiler and models the kernel in numpy on them).
//
// Fragments (PTX ISA, mma.m16n8k256 .b1; g = lane / 4, t = lane % 4;
// register bit i is element i):
//   A 16x256, 4 regs: reg ra, bit i -> row g + 8 (ra & 1),
//     col 32t + 128 (ra >> 1) + i
//   B 256x8, 2 regs:  reg rb, bit i -> row 32t + 128 rb + i, col g
//   C 16x8, 4 int32:  reg rc -> row g + 8 (rc >> 1), col 2t + (rc & 1)
//
// K: an input column needs only 8 rows x 8 bits = 64 of the 256 K bits
// (per k-step of 8 rows; more rows accumulate over k-steps through C),
// so K holds four blocks of 64 bits, block c for a different byte
// column, and A is block-diagonal: row r of A holds bit-matrix bits only
// in block r % 4, so D[r][n] is an output bit of column (n, r % 4).
// Inside a block, K bit 8j + b is bit b of input row j (the bit
// matrix's own column order).  A B register is then 4 input rows of one
// column, a byte each: a lane loads a 4-byte word of each of 4 rows
// (4 columns) and a 4x4 byte transpose gives B for 4 columns, one per
// product q.  Nothing is expanded.
//
// Columns: a warp's chunk is 128 byte columns; column n of block c of
// product q is chunk column 4 (8c + n) + q.
//
// M: row r = g + 8h of product tile T holds bit 2 (v % 4) + p of output
// byte v / 4, v = 2T + h, p = g / 4: tiles 2i and 2i + 1 make byte i,
// each lane g holding the bits of parity p, and lanes g and g ^ 4
// (lane xor 16) join their halves.  RS(8,3) encode takes 6 tiles and
// its decode 16: no row is padding.
//
// Pack: the low bytes of one register of the 4 products (4 neighbouring
// columns) gather into one word, whose bits 0, 8, 16, 24 are parities;
// masked, it is added into bit 2 (v % 4) + p of the lane's output word.

#pragma once

#include <cstdint>

#ifdef __CUDACC__
#define GF2_HD __host__ __device__ __forceinline__
#else
#define GF2_HD inline
#endif

namespace gf2 {

constexpr int kChunkCols = 128;  // byte columns per warp chunk
constexpr int kBlocks = 4;       // K blocks: byte columns per product row
constexpr int kStepRows = 8;     // input rows per k-step

// __byte_perm on the device; the same selection on the host.
GF2_HD uint32_t byte_perm(uint32_t x, uint32_t y, uint32_t s) {
#ifdef __CUDA_ARCH__
  return __byte_perm(x, y, s);
#else
  const uint64_t v = (static_cast<uint64_t>(y) << 32) | x;
  uint32_t r = 0;
  for (int n = 0; n < 4; n++) {
    const uint32_t sel = (s >> (4 * n)) & 7u;
    r |= static_cast<uint32_t>((v >> (8 * sel)) & 0xFFu) << (8 * n);
  }
  return r;
#endif
}

// ---- fragments (PTX ISA layouts) ------------------------------------

GF2_HD void frag_a(int lane, int ra, int i, int* row, int* col) {
  *row = lane / 4 + 8 * (ra & 1);
  *col = 32 * (lane % 4) + 128 * (ra >> 1) + i;
}

GF2_HD void frag_b(int lane, int rb, int i, int* row, int* col) {
  *row = 32 * (lane % 4) + 128 * rb + i;
  *col = lane / 4;
}

GF2_HD void frag_c(int lane, int rc, int* row, int* col) {
  *row = lane / 4 + 8 * (rc >> 1);
  *col = 2 * (lane % 4) + (rc & 1);
}

// ---- K: input bits --------------------------------------------------

// Block, input row and bit of K index kk at k-step ks.
GF2_HD void k_source(int kk, int ks, int* block, int* row, int* bit) {
  *block = kk / 64;
  *row = kStepRows * ks + kk % 64 / 8;
  *bit = kk % 8;
}

// Chunk column of column n of block c of product q.
GF2_HD int chunk_col(int n, int c, int q) { return 4 * (8 * c + n) + q; }

// The input row and the chunk column of the 4-byte word that lane
// `lane` loads for B reg rb, byte e, at k-step ks: bits 8e..8e+7 of
// the register are that row's byte of column (g, block), and the word's
// byte q is the same for product q (transpose4).
GF2_HD void b_load(int lane, int rb, int e, int ks, int* row, int* col) {
  const int t = lane % 4, block = 2 * rb + t / 2;
  *row = kStepRows * ks + 4 * (t % 2) + e;
  *col = chunk_col(lane / 4, block, 0);
}

// w[e] holds byte q of row e at bits 8q..8q+7 -> b[q] holds byte e of
// column q at bits 8e..8e+7.
GF2_HD void transpose4(const uint32_t (&w)[4], uint32_t (&b)[4]) {
  const uint32_t lo01 = byte_perm(w[0], w[1], 0x5140u);
  const uint32_t hi01 = byte_perm(w[0], w[1], 0x7362u);
  const uint32_t lo23 = byte_perm(w[2], w[3], 0x5140u);
  const uint32_t hi23 = byte_perm(w[2], w[3], 0x7362u);
  b[0] = byte_perm(lo01, lo23, 0x5410u);
  b[1] = byte_perm(lo01, lo23, 0x7632u);
  b[2] = byte_perm(hi01, hi23, 0x5410u);
  b[3] = byte_perm(hi01, hi23, 0x7632u);
}

// ---- M: output bits -------------------------------------------------

// Output byte and bit of row r of product tile T.
GF2_HD void out_bit(int T, int r, int* byte, int* bit) {
  const int v = 2 * T + r / 8;
  *byte = v / 4;
  *bit = 2 * (v % 4) + r % 8 / 4;
}

// Bit-matrix row and column behind A reg ra, bit i of lane `lane` for
// tile T, k-step ks; -1 where A is zero (outside the row's block, an
// output byte >= m or an input row >= k).
GF2_HD void a_source(int lane, int ra, int i, int T, int ks, int k, int m,
                     int* bm_row, int* bm_col) {
  int row, col, block, in_row, in_bit, byte, bit;
  frag_a(lane, ra, i, &row, &col);
  k_source(col, ks, &block, &in_row, &in_bit);
  out_bit(T, row, &byte, &bit);
  if (block != row % kBlocks || byte >= m || in_row >= k) {
    *bm_row = -1;
    *bm_col = -1;
    return;
  }
  *bm_row = 8 * byte + bit;
  *bm_col = 8 * in_row + in_bit;
}

// The chunk column of the word lane `lane` stores after the join: both
// lanes of a pair hold the byte for columns n = 2t and 2t + 1 of block
// g % 4, and lane g keeps n = 2t + g / 4.
GF2_HD int store_col(int lane) {
  const int g = lane / 4, t = lane % 4;
  return chunk_col(2 * t + g / kBlocks, g % kBlocks, 0);
}

// The kernel's shape for k input and m output rows: nt = 2m product
// tiles of ks k-steps of 8 rows.
GF2_HD void variant(int k, int m, int* nt, int* ks) {
  *nt = 2 * m;
  *ks = (k + kStepRows - 1) / kStepRows;
}

// ---- pack -----------------------------------------------------------

// The low bytes of four accumulators as the four bytes of one word.
GF2_HD uint32_t gather4(uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
  return byte_perm(byte_perm(a, b, 0x0040u), byte_perm(c, d, 0x0040u),
                   0x5410u);
}

// The same for counts below 256 (one k-step: at most 64): a sum, which
// the FMA pipe takes (three IMADs) instead of the ALU's byte permutes.
GF2_HD uint32_t gather4_small(uint32_t a, uint32_t b, uint32_t c,
                              uint32_t d) {
  return a + b * 0x100u + c * 0x10000u + d * 0x1000000u;
}

// Add the parities in bit 0 of each byte of `g4` into bit `bit` of each
// byte of `word` (whose bit `bit` is clear), `at` = 1 << bit: a LOP3
// and an IMAD.
GF2_HD uint32_t pack_bit_at(uint32_t word, uint32_t g4, uint32_t at) {
  return (g4 & 0x01010101u) * at + word;
}

}  // namespace gf2
