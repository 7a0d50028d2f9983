// gf2_matmul_w8 — the erasure-code GF(2) bit-matmul for w=8 byte layouts.
//
// Replaces: ceph_tpu/ec/pallas_kernels.py:_kernel (launched by _call,
// wrapped by fused_gf2_matmul_w8), the TPU kernel that unpacks each
// byte to 8 bit planes, runs an int8 matmul on the MXU, takes the
// result mod 2 and repacks.  This kernel computes the same bytes:
//
//   out[b, i, c] = pack_s( parity_j,t( BM[8i+s, 8j+t] & bit_t(row_j[b][c]) ) )
//
// What bounds it on an H100: every call must read k*L bytes and write
// m*L bytes per stripe, so memory sets the floor; but an AND-XOR over
// 8m x 8k bits per byte column on the integer pipe alone costs more
// than the bytes (about 96 ops per column for RS(8,3) encode, 256 for
// its decode), and unpacking bytes to bits and packing parities back
// costs integer ops per bit.
//
// What the design does about it:
//  - The AND-XOR runs on the tensor cores as 1-bit products,
//    mma.sync m16n8k256 b1 .and.popc: bit 0 of each popcount is a
//    parity.  Bytes go in as they are (a 4x4 byte transpose per 4 rows
//    of 4 columns, no expansion to bit planes); K holds four byte
//    columns at once against a block-diagonal A, so every product row
//    is a real output bit.  gf2_layout.cuh holds the whole bit and lane
//    mapping.
//  - What stays on the integer side is mostly the pack, 5 instructions
//    per 4 output bits, split between the FMA and the ALU pipes: for
//    k <= 8 a count is below 256, so four accumulators gather into one
//    word by three IMADs (or, for a quarter of them, three byte
//    permutes), and the masked word goes into its bit of the output by
//    one more IMAD.
//  - A's fragments are built once per bit matrix by a small kernel of
//    their own (gf2_fragments_launch; the EC engine keeps them beside
//    its cached matrices) and copied into shared memory at the start.
//  - The grid is persistent: 8 warps a block, each warp walking over
//    chunks of 128 columns of the k rows on its own.  Rows whose
//    pointers and length are 16-byte aligned go through a ring of 2
//    stages in shared memory per warp, filled by 16-byte cp.async
//    copies, so the next chunk's loads are in flight while one is
//    computed; a warp's output words are 128 contiguous bytes of a row
//    a store.  For k <= 8 and m <= 8 (RS(8,3) encode and decode) the
//    kernel is compiled for its m, so the rows' products and packs are
//    scheduled together, and held to 80 registers for 3 blocks an SM;
//    every other (k, m) takes one kernel for up to 4 k-steps and any m.
//    Other rows (an odd L such as 777, unaligned pointers) take the same
//    compute with masked byte loads (the next chunk's loaded into
//    registers during this one's) and byte stores.
//  - The k input rows are a table of pointers passed by value, so the
//    survivors of a decode are read where they lie: row j of stripe b
//    is rows[j] + b * stripe_stride.  Batched stripes [B, k, L] are
//    rows base + j * L with stride k * L; nothing is stacked or copied.

#include <cstddef>
#include <cstdint>
#include <mutex>

#include <cuda_runtime.h>

#include "gf2_layout.cuh"

namespace {

constexpr int kWarps = 8;  // warps of a block, each on chunks of its own
constexpr int kThreads = 32 * kWarps;
constexpr int kChunk = gf2::kChunkCols;  // byte columns a warp takes at once
constexpr int kMaxRows = 32;
constexpr int kSmemMax = 227 * 1024;
constexpr int kBytesPerPass = 4;  // output rows whose products interleave
// Row pitch of a chunk in shared memory: +16 bytes puts a warp's 4-byte
// loads (rows 4 apart, 8 lanes of neighbouring words) on distinct banks.
constexpr int kPitch = kChunk + 16;

// Stages of a warp's copy ring: two, the next chunk's copies in flight
// while one is computed (measured faster than 3 to 12 for k <= 8, and
// what fits beside 32 rows and the fragments of a 32 x 32 code).
constexpr int kStages = 2;

struct Rows {
  const uint8_t* p[kMaxRows];
};

struct Shape {
  int k, m, nt, ks, chunks_per_row;
  long long L, stripe_stride, nchunks;
};

// D = popcount(A & B) + C over 256 bits (gf2_layout.cuh: fragments)
__device__ __forceinline__ void mma_b1(int (&d)[4], const uint4& a,
                                       uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1));
}

// The 4 bytes at `p`, of which those at or past `n` are 0, by byte
// loads (rows that are not 16-byte aligned).
__device__ __forceinline__ uint32_t load4(const uint8_t* p, long long n) {
  uint32_t v = 0;
#pragma unroll
  for (int q = 0; q < 4; q++)
    if (q < n) v |= static_cast<uint32_t>(__ldcs(p + q)) << (8 * q);
  return v;
}

// Store the 4 bytes of `v` at `p`, those at or past `n` not: one word
// store when aligned, else byte stores.
template <bool kAligned>
__device__ __forceinline__ void store4(uint8_t* p, long long n, uint32_t v) {
  if constexpr (kAligned) {
    if (n > 0) __stcs(reinterpret_cast<unsigned int*>(p), v);
  } else {
#pragma unroll
    for (int q = 0; q < 4; q++)
      if (q < n) p[q] = static_cast<uint8_t>(v >> (8 * q));
  }
}

// Where a warp is: stripe b, chunk ci of the row.
struct Cursor {
  long long b;
  int ci;
};

// The words lane `lane` needs from one chunk (gf2::b_load): w[ks][rb][e],
// byte q = product q's column; rows past k and columns past L are 0.
template <int KS>
__device__ __forceinline__ void load_chunk(uint32_t (&w)[KS][2][4],
                                           const Rows& rows, const Shape& s,
                                           Cursor at, int lane) {
  const long long col0 = static_cast<long long>(at.ci) * kChunk;
  const long long off = at.b * s.stripe_stride + col0;
#pragma unroll
  for (int ks = 0; ks < KS; ks++)
#pragma unroll
    for (int rb = 0; rb < 2; rb++)
#pragma unroll
      for (int e = 0; e < 4; e++) {
        int row, col;
        gf2::b_load(lane, rb, e, ks, &row, &col);
        w[ks][rb][e] = ks < s.ks && row < s.k
                           ? load4(rows.p[row] + off + col,
                                   s.L - col0 - col)
                           : 0u;
      }
}

// One warp's chunk: the words of 128 columns of the k rows -> 128
// columns of the m rows at `out` (row pitch L; columns from `cols` on
// are past the end).  `afr`: A fragments in shared memory,
// [tile][k-step][lane].  KS: most k-steps (ks_n of them are real); with
// one k-step every count is below 256.  MT: m when compiled for it, else
// 0 (passes of kBytesPerPass output rows).
template <int KS, int MT, bool kAligned>
__device__ __forceinline__ void chunk(const uint32_t (&w)[KS][2][4],
                                      uint8_t* out, long long pitch,
                                      long long cols, const uint4* afr,
                                      int m, int ks_n, int lane) {
  // B registers: 4 rows of one column a register, for the 4 products q
  // (4 neighbouring columns)
  uint32_t b[KS][2][4];
#pragma unroll
  for (int ks = 0; ks < KS; ks++)
#pragma unroll
    for (int rb = 0; rb < 2; rb++) gf2::transpose4(w[ks][rb], b[ks][rb]);
  const int p = lane / 16;  // g / 4: which bits of a byte this lane holds
  const int scol = gf2::store_col(lane);
  const uint32_t one_p = 1u << p;
  uint8_t* optr = out + scol;
  const uint4* ap = afr + lane;
  constexpr int PB = MT ? MT : kBytesPerPass;
  if (MT) m = MT;
#pragma unroll
  for (int i0 = 0; i0 < m; i0 += PB) {
    uint32_t mine[PB];
#pragma unroll
    for (int u = 0; u < PB; u++) {
      const int i = i0 + u;
      if (i >= m) break;
      uint32_t word[2] = {0u, 0u};  // columns n = 2t, 2t + 1
#pragma unroll
      for (int h2 = 0; h2 < 2; h2++) {
        const int T = 2 * i + h2;
        int acc[4][4];
#pragma unroll
        for (int q = 0; q < 4; q++)
#pragma unroll
          for (int rc = 0; rc < 4; rc++) acc[q][rc] = 0;
#pragma unroll
        for (int ks = 0; ks < KS; ks++) {
          if (ks >= ks_n) break;
          const uint4 a = ap[(T * ks_n + ks) * 32];
#pragma unroll
          for (int q = 0; q < 4; q++)
            mma_b1(acc[q], a, b[ks][0][q], b[ks][1][q]);
        }
#pragma unroll
        for (int rc = 0; rc < 4; rc++) {
          // bit 4 h2 + 2 (rc >> 1) + p of the byte (gf2::out_bit)
          const uint32_t at = one_p << (4 * h2 + 2 * (rc >> 1));
          // IMADs (FMA pipe) where the counts allow, except for 2 of
          // the 8 gathers of a byte: their byte permutes keep the ALU
          // pipe busy beside the FMA pipe (6 of 8 measured fastest)
          const bool fma = KS == 1 && (h2 == 0 || rc < 2);
          const uint32_t g =
              fma ? gf2::gather4_small(acc[0][rc], acc[1][rc], acc[2][rc],
                                       acc[3][rc])
                  : gf2::gather4(acc[0][rc], acc[1][rc], acc[2][rc],
                                 acc[3][rc]);
          word[rc & 1] = gf2::pack_bit_at(word[rc & 1], g, at);
        }
      }
      // lanes g and g ^ 4 hold the two halves of each byte: each keeps
      // column n = 2t + p and gives the other one
      mine[u] = (p ? word[1] : word[0]) |
                __shfl_xor_sync(0xFFFFFFFFu, p ? word[0] : word[1], 16);
    }
#pragma unroll
    for (int u = 0; u < PB; u++) {
      if (i0 + u >= m) break;
      store4<kAligned>(optr, cols - scol, mine[u]);
      optr += pitch;
    }
  }
}

// KS, MT: 1, m for k <= 8 and m <= 8 (compiled for m); 4, 0 for any
// other shape (up to 4 k-steps, any m; chunk).  kAligned: rows, their
// length and the output 16-byte aligned: each warp keeps a ring of
// stages in shared memory filled by 16-byte asynchronous copies, the
// next chunk's copies in flight while it computes one.  Otherwise the
// same compute takes masked byte loads and stores (and loads the next
// chunk into registers while computing one).
template <int KS, int MT, bool kAligned>
__global__ void __launch_bounds__(kThreads, KS == 1 ? 3 : 1)
gf2_matmul_w8_kernel(const uint4* __restrict__ frag, Rows rows,
                     uint8_t* __restrict__ out, Shape s) {
  constexpr int S = kStages;
  extern __shared__ __align__(16) uint4 afr[];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int nfrag = s.nt * s.ks * 32, k = s.k;

  // chunks this warp takes: first, first + step, ...; a cursor advances
  // without a division
  const long long first = static_cast<long long>(blockIdx.x) * kWarps + warp;
  const long long step = static_cast<long long>(gridDim.x) * kWarps;
  const long long db = step / s.chunks_per_row;
  const int dci = static_cast<int>(step % s.chunks_per_row);
  auto advance = [&](Cursor c) {
    c.b += db;
    c.ci += dci;
    if (c.ci >= s.chunks_per_row) {
      c.ci -= s.chunks_per_row;
      c.b++;
    }
    return c;
  };
  Cursor at{first / s.chunks_per_row,
            static_cast<int>(first % s.chunks_per_row)};
  auto compute = [&](const uint32_t (&w)[KS][2][4]) {
    const long long col0 = static_cast<long long>(at.ci) * kChunk;
    chunk<KS, MT, kAligned>(w, out + (at.b * s.m) * s.L + col0, s.L,
                        s.L - col0, afr, s.m, s.ks, lane);
    at = advance(at);
  };

  if constexpr (kAligned) {
    // A chunk's k rows are k * 8 copies of 16 bytes; lane copies
    // x = lane + 32u, from row x / 8 at byte 16 (x % 8) of the chunk.
    uint8_t* ring = reinterpret_cast<uint8_t*>(afr + nfrag) +
                    warp * S * k * kPitch;
    constexpr int kCopies = 2 * KS;
    Cursor fat = at;
    long long fetched = first;
    auto fetch = [&](int st) {
      if (fetched < s.nchunks) {
        const long long col0 = static_cast<long long>(fat.ci) * kChunk;
        const long long off = fat.b * s.stripe_stride + col0;
        const int piece = 16 * (lane % 8);
        const bool in_row = col0 + piece < s.L;
#pragma unroll
        for (int u = 0; u < kCopies; u++) {
          const int j = (lane + 32 * u) / 8;
          if (j >= k) break;
          const uint8_t* src = rows.p[j] + piece + (in_row ? off : 0);
          const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(
              ring + (st * k + j) * kPitch + piece));
          asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                           dst),
                       "l"(src), "r"(in_row ? 16 : 0)
                       : "memory");
        }
        fat = advance(fat);
        fetched += step;
      }
      asm volatile("cp.async.commit_group;\n" ::: "memory");  // one a stage
    };
    for (int st = 0; st < S - 1; st++) fetch(st);
    // A's fragments come in while the first copies are on their way
    for (int f = tid; f < nfrag; f += kThreads) afr[f] = frag[f];
    __syncthreads();
    int it = 0;
    for (long long c = first; c < s.nchunks; c += step, it++) {
      fetch((it + S - 1) % S);
      asm volatile("cp.async.wait_group %0;\n" ::"n"(S - 1) : "memory");
      __syncwarp();
      const uint8_t* in = ring + (it % S) * k * kPitch;
      uint32_t w[KS][2][4];
#pragma unroll
      for (int ks = 0; ks < KS; ks++)
#pragma unroll
        for (int rb = 0; rb < 2; rb++)
#pragma unroll
          for (int e = 0; e < 4; e++) {
            int row, col;
            gf2::b_load(lane, rb, e, ks, &row, &col);
            const uint8_t* at_word = in + row * kPitch + col;
            w[ks][rb][e] = ks < s.ks && row < k
                               ? *reinterpret_cast<const uint32_t*>(at_word)
                               : 0u;
          }
      __syncwarp();  // the stage is free for the next copies
      compute(w);
    }
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  } else {
    uint32_t w[KS][2][4];
    if (first < s.nchunks) load_chunk<KS>(w, rows, s, at, lane);
    for (int f = tid; f < nfrag; f += kThreads) afr[f] = frag[f];
    __syncthreads();
    for (long long c = first; c < s.nchunks; c += step) {
      uint32_t wn[KS][2][4];
      if (c + step < s.nchunks)
        load_chunk<KS>(wn, rows, s, advance(at), lane);
      compute(w);
#pragma unroll
      for (int ks = 0; ks < KS; ks++)
#pragma unroll
        for (int rb = 0; rb < 2; rb++)
#pragma unroll
          for (int e = 0; e < 4; e++) w[ks][rb][e] = wn[ks][rb][e];
    }
  }
}

// A's fragments of a bit matrix (u8 0/1 [8m, 8k]): one thread per
// (tile, k-step, lane), the 8 bits of a byte of a register from 8
// neighbouring bit-matrix entries.
__global__ void gf2_fragments_kernel(const uint8_t* __restrict__ bm, int k,
                                     int m, int nt, int ks_n,
                                     uint4* __restrict__ frag) {
  const int f = blockIdx.x * blockDim.x + threadIdx.x;
  if (f >= nt * ks_n * 32) return;
  const int lane = f % 32, ks = f / 32 % ks_n, T = f / 32 / ks_n;
  uint32_t reg[4];
  for (int ra = 0; ra < 4; ra++) {
    uint32_t v = 0;
    for (int e = 0; e < 4; e++) {
      int row, col;
      gf2::a_source(lane, ra, 8 * e, T, ks, k, m, &row, &col);
      if (row < 0) continue;
      const uint8_t* src = bm + row * 8 * k + col;
      uint32_t byte = 0;
      for (int bit = 0; bit < 8; bit++) byte |= (src[bit] & 1u) << bit;
      v |= byte << (8 * e);
    }
    reg[ra] = v;
  }
  frag[f] = make_uint4(reg[0], reg[1], reg[2], reg[3]);
}

// Held by a launch from setting its kernel's shared-memory attribute
// to the launch itself, so that two host threads cannot set a smaller
// one in between.
std::mutex launch_mutex;

template <int KS, int MT, bool kAligned>
cudaError_t launch_one(const uint4* frag, const Rows& rows, uint8_t* out,
                       Shape s, cudaStream_t stream) {
  auto kernel = gf2_matmul_w8_kernel<KS, MT, kAligned>;
  const size_t smem =
      static_cast<size_t>(16) * s.nt * s.ks * 32 +
      (kAligned ? static_cast<size_t>(kWarps) * kStages * s.k * kPitch
                : 0);
  if (smem > kSmemMax) return cudaErrorInvalidConfiguration;
  std::lock_guard<std::mutex> lock(launch_mutex);

  // blocks per SM for this shared-memory size, cached per device
  static int cached_dev = -1;
  static size_t cached_smem = 0;
  static int cached_grid = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev != cached_dev || smem != cached_smem) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, smem);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    cached_dev = dev;
    cached_smem = smem;
    cached_grid = per_sm * sms;
  }
  const long long blocks = (s.nchunks + kWarps - 1) / kWarps;
  const long long grid = blocks < cached_grid ? blocks : cached_grid;
  kernel<<<static_cast<unsigned>(grid), kThreads, smem, stream>>>(frag, rows,
                                                                   out, s);
  return cudaGetLastError();
}

template <int KS, int MT>
cudaError_t launch(const uint4* frag, const Rows& rows, uint8_t* out, Shape s,
                   cudaStream_t stream) {
  bool aligned = s.L % 16 == 0 && s.stripe_stride % 16 == 0 &&
                 reinterpret_cast<uintptr_t>(out) % 16 == 0;
  for (int j = 0; j < s.k; j++)
    aligned = aligned && reinterpret_cast<uintptr_t>(rows.p[j]) % 16 == 0;
  return aligned ? launch_one<KS, MT, true>(frag, rows, out, s, stream)
                 : launch_one<KS, MT, false>(frag, rows, out, s, stream);
}

}  // namespace

extern "C" {

// Bytes of A's fragments for k input and m output rows.
long long gf2_fragments_bytes(int k, int m) {
  int nt = 0, ks = 0;
  gf2::variant(k, m, &nt, &ks);
  return 16ll * nt * ks * 32;
}

// A's fragments of the bit matrix bm (u8 0/1 [8m, 8k], contiguous) into
// `frag` (gf2_fragments_bytes(k, m) bytes on the same device).  Returns
// the launch's cudaError_t; 0 is success.
int gf2_fragments_launch(const void* bm, int k, int m, void* frag,
                         void* stream) {
  if (k < 1 || k > kMaxRows || m < 1 || m > 32) return cudaErrorInvalidValue;
  int nt = 0, ks = 0;
  gf2::variant(k, m, &nt, &ks);
  const int n = nt * ks * 32;
  gf2_fragments_kernel<<<(n + 255) / 256, 256, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(bm), k, m, nt, ks,
      static_cast<uint4*>(frag));
  return cudaGetLastError();
}

// out u8[B, m, L] (contiguous) = the bit matrix whose fragments are
// `frag` applied to k input rows: row j of stripe b is the L bytes at
// rows[j] + b * stripe_stride, or, when `rows` is null, at
// base + j * L + b * stripe_stride (stripes u8[B, k, L] in place).
// 1 <= k, m <= 32, B >= 1, L >= 1 (the Python wrapper checks).  Returns
// the launch's cudaError_t; 0 is success.
int gf2_matmul_w8_launch(const void* frag, const void* const* rows,
                         const void* base, long long stripe_stride, void* out,
                         int B, int k, int m, long long L, void* stream) {
  if (k < 1 || k > kMaxRows || m < 1 || m > 32 || B < 1 || L < 1)
    return cudaErrorInvalidValue;
  Rows r{};
  for (int j = 0; j < k; j++)
    r.p[j] = rows != nullptr ? static_cast<const uint8_t*>(rows[j])
                             : static_cast<const uint8_t*>(base) + j * L;
  Shape s{};
  s.k = k;
  s.m = m;
  s.L = L;
  s.stripe_stride = stripe_stride;
  s.chunks_per_row = static_cast<int>((L + kChunk - 1) / kChunk);
  s.nchunks = static_cast<long long>(B) * s.chunks_per_row;
  gf2::variant(k, m, &s.nt, &s.ks);
  auto* f = static_cast<const uint4*>(frag);
  auto* out8 = static_cast<uint8_t*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  if (s.ks > 1 || m > 8) return launch<4, 0>(f, r, out8, s, st);
  switch (m) {
    case 1: return launch<1, 1>(f, r, out8, s, st);
    case 2: return launch<1, 2>(f, r, out8, s, st);
    case 3: return launch<1, 3>(f, r, out8, s, st);
    case 4: return launch<1, 4>(f, r, out8, s, st);
    case 5: return launch<1, 5>(f, r, out8, s, st);
    case 6: return launch<1, 6>(f, r, out8, s, st);
    case 7: return launch<1, 7>(f, r, out8, s, st);
    default: return launch<1, 8>(f, r, out8, s, st);  // m == 8
  }
}

}  // extern "C"
