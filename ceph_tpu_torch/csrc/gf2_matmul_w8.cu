// gf2_matmul_w8 — the erasure-code GF(2) bit-matmul for w=8 byte layouts.
//
// Replaces: ceph_tpu/ec/pallas_kernels.py:_kernel (launched by _call,
// wrapped by fused_gf2_matmul_w8), the TPU kernel that unpacks each
// byte to 8 bit planes, runs an int8 matmul on the MXU, takes the
// result mod 2 and repacks.  This kernel computes the same bytes:
//
//   out[b, i, c] = pack_s( parity_j,t( BM[8i+s, 8j+t] & bit_t(data[b, j, c]) ) )
//
// What bounds it on an H100: memory.  Every call reads k*L bytes and
// writes m*L bytes per stripe, and that is all it has to move (the bit
// matrix is a few KB).  At 3.35 TB/s that is the floor.
//
// What the design does about it:
//  - No bit planes ever reach memory.  Column j of row r of BM is
//    folded on chip into a byte mask M[r][j] (bit t = BM[r, 8j+t]) and
//    replicated to all four bytes of a 32-bit word, kept in shared
//    memory.  A thread holds 4 byte columns of every data row in one
//    register word and computes output bit-row r as
//    XOR_j (word_j & M[r][j]), then folds each byte to its parity and
//    ORs it into bit s of the output byte.  Data is read once and each
//    output byte written once.
//  - Each thread owns WORDS words spaced one block apart, so every load
//    and store instruction of a warp touches 128 contiguous bytes, and
//    each mask read from shared memory serves WORDS words.
//  - Batched stripes [B, k, L] are indexed in place (grid y = stripe):
//    the host never transposes or pads the batch.
//  - Rows whose length L is not a multiple of 4 (an odd L such as 777)
//    are not 4-byte aligned: that case, and the ragged last word, go
//    through masked byte loads and stores.  Only when L % 4 == 0 and
//    both base pointers are 4-byte aligned does it use word accesses.
// Integer ops per word are about 8m*(k+8); at k=8, m=3 that is close to
// the memory time, so vectorised 16-byte accesses, a cheaper parity
// fold and tensor cores are left for later work.

#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <bool kAligned>
__device__ __forceinline__ uint32_t load_word(const uint8_t* row,
                                              long long w, long long L) {
  const long long col = 4 * w;
  if constexpr (kAligned) {
    return *reinterpret_cast<const uint32_t*>(row + col);
  } else {
    uint32_t v = 0;
#pragma unroll
    for (int q = 0; q < 4; q++) {
      if (col + q < L) v |= static_cast<uint32_t>(row[col + q]) << (8 * q);
    }
    return v;
  }
}

template <bool kAligned>
__device__ __forceinline__ void store_word(uint8_t* row, long long w,
                                           long long L, uint32_t v) {
  const long long col = 4 * w;
  if constexpr (kAligned) {
    *reinterpret_cast<uint32_t*>(row + col) = v;
  } else {
#pragma unroll
    for (int q = 0; q < 4; q++) {
      if (col + q < L) row[col + q] = static_cast<uint8_t>(v >> (8 * q));
    }
  }
}

// KMAX: data rows held in registers (k <= KMAX, the rest are zero);
// WORDS: 32-bit words of columns per thread.
template <int KMAX, int WORDS, bool kAligned>
__global__ void __launch_bounds__(kThreads)
gf2_matmul_w8_kernel(const uint8_t* __restrict__ bm,
                     const uint8_t* __restrict__ data,
                     uint8_t* __restrict__ out, int k, int m,
                     long long L) {
  // s_mask[r * KMAX + j]: byte mask of BM row r over data row j,
  // replicated to the 4 bytes of a word; zero for j >= k.
  extern __shared__ uint32_t s_mask[];
  const int nmask = 8 * m * KMAX;
  for (int t = threadIdx.x; t < nmask; t += blockDim.x) {
    const int r = t / KMAX, j = t % KMAX;
    uint32_t mk = 0;
    if (j < k) {
      const uint8_t* bits = bm + static_cast<size_t>(r) * 8 * k + 8 * j;
#pragma unroll
      for (int s = 0; s < 8; s++) mk |= static_cast<uint32_t>(bits[s] & 1) << s;
    }
    s_mask[t] = mk * 0x01010101u;
  }
  __syncthreads();

  const long long nwords = (L + 3) / 4;
  const long long b = blockIdx.y;
  const uint8_t* src = data + static_cast<size_t>(b) * k * L;
  uint8_t* dst = out + static_cast<size_t>(b) * m * L;
  const long long w0 =
      static_cast<long long>(blockIdx.x) * kThreads * WORDS + threadIdx.x;

  uint32_t d[KMAX][WORDS];
#pragma unroll
  for (int j = 0; j < KMAX; j++) {
#pragma unroll
    for (int q = 0; q < WORDS; q++) {
      const long long w = w0 + static_cast<long long>(q) * kThreads;
      d[j][q] = (j < k && w < nwords)
                    ? load_word<kAligned>(src + static_cast<size_t>(j) * L, w, L)
                    : 0u;
    }
  }

  for (int i = 0; i < m; i++) {
    uint32_t o[WORDS];
#pragma unroll
    for (int q = 0; q < WORDS; q++) o[q] = 0;
#pragma unroll
    for (int s = 0; s < 8; s++) {
      const uint32_t* mrow = s_mask + (8 * i + s) * KMAX;
      uint32_t acc[WORDS];
#pragma unroll
      for (int q = 0; q < WORDS; q++) acc[q] = 0;
#pragma unroll
      for (int j = 0; j < KMAX; j++) {
        const uint32_t mk = mrow[j];
#pragma unroll
        for (int q = 0; q < WORDS; q++) acc[q] ^= d[j][q] & mk;
      }
#pragma unroll
      for (int q = 0; q < WORDS; q++) {
        uint32_t x = acc[q];
        x ^= x >> 4;  // bit 0 of each byte ends as that byte's parity
        x ^= x >> 2;
        x ^= x >> 1;
        o[q] |= (x & 0x01010101u) << s;
      }
    }
#pragma unroll
    for (int q = 0; q < WORDS; q++) {
      const long long w = w0 + static_cast<long long>(q) * kThreads;
      if (w < nwords) store_word<kAligned>(dst + static_cast<size_t>(i) * L, w, L, o[q]);
    }
  }
}

template <int KMAX, int WORDS>
cudaError_t launch(const uint8_t* bm, const uint8_t* data, uint8_t* out,
                   int B, int k, int m, long long L, cudaStream_t stream) {
  const long long nwords = (L + 3) / 4;
  const long long per_block = static_cast<long long>(kThreads) * WORDS;
  dim3 grid(static_cast<unsigned>((nwords + per_block - 1) / per_block),
            static_cast<unsigned>(B));
  const size_t smem = static_cast<size_t>(8) * m * KMAX * sizeof(uint32_t);
  const bool aligned = (L % 4 == 0) &&
                       (reinterpret_cast<uintptr_t>(data) % 4 == 0) &&
                       (reinterpret_cast<uintptr_t>(out) % 4 == 0);
  if (aligned) {
    gf2_matmul_w8_kernel<KMAX, WORDS, true>
        <<<grid, kThreads, smem, stream>>>(bm, data, out, k, m, L);
  } else {
    gf2_matmul_w8_kernel<KMAX, WORDS, false>
        <<<grid, kThreads, smem, stream>>>(bm, data, out, k, m, L);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// out u8[B, m, L] = BM (u8 0/1 [8m, 8k]) applied to data u8[B, k, L];
// all three contiguous on the current device.  1 <= k, m <= 32,
// 1 <= B <= 65535, L >= 1 (the Python wrapper checks).  Returns the
// launch's cudaError_t; 0 is success.
int gf2_matmul_w8_launch(const void* bm, const void* data, void* out,
                         int B, int k, int m, long long L, void* stream) {
  auto* bm8 = static_cast<const uint8_t*>(bm);
  auto* in8 = static_cast<const uint8_t*>(data);
  auto* out8 = static_cast<uint8_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (k <= 4) return launch<4, 4>(bm8, in8, out8, B, k, m, L, s);
  if (k <= 8) return launch<8, 4>(bm8, in8, out8, B, k, m, L, s);
  if (k <= 16) return launch<16, 2>(bm8, in8, out8, B, k, m, L, s);
  return launch<32, 1>(bm8, in8, out8, B, k, m, L, s);
}

}  // extern "C"
