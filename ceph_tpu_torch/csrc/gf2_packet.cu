// gf2_packet — kernel K3, the erasure-code GF(2) product of the packet
// layouts (jerasure's cauchy_orig, cauchy_good, liberation, blaum_roth
// and liber8tion).
//
// Replaces: ceph_tpu/ec/engine.py:_mod2_matmul (l.124) on the packet
// rows of Layout(w, packetsize) (l.150-215), the XLA program that
// unpacks each packet row to bits, runs an int8 matmul on the MXU,
// takes it mod 2 and packs back.  The byte's bits fold into the
// columns there, so no bit mixes with another: output packet (p, r) of
// each block of w packets is the bytewise XOR of the input packets
// (c, r') whose bit BM[p*w + r][c*w + r'] is 1 (gf2_packet.cuh).  This
// kernel computes that XOR directly, on whole bytes.
//
// What bounds it on an H100: every call reads k*L and writes m*L bytes
// a stripe; the XORs (at most w*k vectors an output vector) are a few
// integer ops a byte, so memory sets the floor.
//
// What the design does about it (a simple design, right first):
//  - a thread owns one unit (V bytes at one offset of a packet column
//    in one block, V = 16 where the packet size and every address
//    allow) and reads each of its w*k input vectors from device memory
//    once, into its own column of a scratch array in shared memory;
//  - the bit matrix sits in shared memory as one mask of 32-bit words
//    a row, and each output vector is the XOR of the scratch vectors
//    its mask selects (a warp shares the mask, so the loop over its set
//    bits does not diverge);
//  - neighbouring threads take neighbouring offsets of a packet, so a
//    warp's loads and stores are contiguous runs of a packet row;
//  - the k input rows are a table of pointers passed by value, so a
//    decode's survivors are read where they lie: row c of stripe b is
//    rows[c] + b * stripe_stride.  Batched stripes [B, k, L] are rows
//    base + c * L with stride k * L; nothing is stacked or copied.
// What it leaves for later: with packets of 8 bytes a warp's loads are
// 8-byte pieces 8*w bytes apart (the rest of each sector comes from the
// cache on the next packets), and nothing overlaps a block's loads with
// its XORs.

#include <cstddef>
#include <cstdint>
#include <mutex>

#include <cuda_runtime.h>

#include "gf2_packet.cuh"

namespace {

using gf2p::kMaxRows;

struct Rows {
  const uint8_t* p[kMaxRows];
};

struct Shape {
  long long L;
  long long stripe_stride;
  long long units;  // a stripe
  int w, ps, k, m;
};

template <int V>
__global__ void __launch_bounds__(gf2p::kMaxThreads)
    gf2_packet_kernel(Rows rows, const uint32_t* __restrict__ masks,
                      uint8_t* __restrict__ out, Shape s) {
  typedef typename gf2p::VecT<V>::type T;
  extern __shared__ __align__(16) unsigned char smem[];
  const int wk = s.w * s.k, wm = s.w * s.m;
  auto* smask = reinterpret_cast<uint32_t*>(smem);
  auto* stable = reinterpret_cast<const uint8_t**>(
      smem + gf2p::mask_bytes(wm, wk));
  auto* scratch = reinterpret_cast<T*>(smem + gf2p::mask_bytes(wm, wk) +
                                       gf2p::table_bytes());
  const int n_mask = wm * gf2p::mask_words(wk);
  for (int i = threadIdx.x; i < n_mask; i += blockDim.x) smask[i] = masks[i];
  if (threadIdx.x < s.k) stable[threadIdx.x] = rows.p[threadIdx.x];
  __syncthreads();
  const long long u =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (u >= s.units) return;
  const long long b = blockIdx.y;
  const long long off = gf2p::unit_offset(u, s.w, s.ps, V);
  gf2p::packet_unit<V>(stable, b * s.stripe_stride + off,
                       out + b * s.m * s.L, off, s.L, s.w, s.ps, s.k, s.m,
                       smask, scratch, blockDim.x, threadIdx.x);
}

template <int V>
int launch(const Rows& r, const uint32_t* masks, uint8_t* out, const Shape& s,
           int B, cudaStream_t st) {
  static std::once_flag once;
  static cudaError_t attr = cudaSuccess;
  std::call_once(once, [] {
    attr = cudaFuncSetAttribute(gf2_packet_kernel<V>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                gf2p::shared_bytes(gf2p::kMaxBits,
                                                   gf2p::kMaxBits, 32, 16));
  });
  if (attr != cudaSuccess) return attr;
  const int wk = s.w * s.k, wm = s.w * s.m;
  const int nt = gf2p::block_threads(wk, V);
  const dim3 grid(static_cast<unsigned>((s.units + nt - 1) / nt),
                  static_cast<unsigned>(B));
  gf2_packet_kernel<V><<<grid, nt, gf2p::shared_bytes(wm, wk, nt, V), st>>>(
      r, masks, out, s);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// out u8[B, m, L] (contiguous) = the (w*m, w*k) bit matrix whose row
// masks are `masks` (w*m rows of mask_words(w*k) 32-bit words) applied
// to k input rows in the packet layout (w, ps): row c of stripe b is
// the L bytes at rows[c] + b * stripe_stride, or, when `rows` is null,
// at base + c * L + b * stripe_stride.  1 <= k, m <= 32; w*k, w*m <= 256;
// L a multiple of w * ps; 1 <= B <= 65535.  Returns the launch's
// cudaError_t; 0 is success.
int gf2_packet_launch(const void* masks, const void* const* rows,
                      const void* base, long long stripe_stride, void* out,
                      int B, int k, int m, int w, int ps, long long L,
                      void* stream) {
  if (k < 1 || k > kMaxRows || m < 1 || m > kMaxRows || w < 1 || ps < 1 ||
      w * k > gf2p::kMaxBits || w * m > gf2p::kMaxBits || B < 1 ||
      B > 65535 || L < 1 || L % (static_cast<long long>(w) * ps))
    return cudaErrorInvalidValue;
  Rows r{};
  unsigned long long addr_or =
      static_cast<unsigned long long>(stripe_stride) |
      reinterpret_cast<uintptr_t>(out);
  for (int c = 0; c < k; c++) {
    r.p[c] = rows != nullptr ? static_cast<const uint8_t*>(rows[c])
                             : static_cast<const uint8_t*>(base) + c * L;
    addr_or |= reinterpret_cast<uintptr_t>(r.p[c]);
  }
  Shape s{};
  s.L = L;
  s.stripe_stride = stripe_stride;
  s.w = w;
  s.ps = ps;
  s.k = k;
  s.m = m;
  const int V = gf2p::vec_bytes(ps, addr_or, B, L, w);
  s.units = gf2p::units_per_stripe(L, w, V);
  auto* mk = static_cast<const uint32_t*>(masks);
  auto* o = static_cast<uint8_t*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  switch (V) {
    case 16: return launch<16>(r, mk, o, s, B, st);
    case 8: return launch<8>(r, mk, o, s, B, st);
    case 4: return launch<4>(r, mk, o, s, B, st);
    case 2: return launch<2>(r, mk, o, s, B, st);
    default: return launch<1>(r, mk, o, s, B, st);
  }
}

// The vector width a launch of these arguments takes (the wrapper and
// chip_smoke report it).
int gf2_packet_vec_bytes(int ps, unsigned long long addr_or, long long B,
                         long long L, int w) {
  return gf2p::vec_bytes(ps, addr_or, B, L, w);
}

}  // extern "C"
