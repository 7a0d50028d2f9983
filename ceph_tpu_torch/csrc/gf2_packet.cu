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
// a stripe, so memory sets the floor; but each output piece is the XOR
// of about 8 input pieces (cauchy_good 4+3 w=8), read from shared
// memory, so a tile's XORs take longer than its loads, and a 4 MiB
// object is only ~32 KiB of input an SM, so the launch's ramp and the
// loads' latency weigh as much as its bytes.
//
// What the design does about it (gf2_packet.cuh has the index math):
//  - a persistent grid of two blocks an SM walks tiles of every stripe
//    (whole blocks of w packets, or column ranges of a large block),
//    each block the same number of tiles; each tile is staged in shared
//    memory in a ring of kStages, so a block's next tiles load while it
//    XORs one;
//  - a stage is filled asynchronously and completes an mbarrier: by
//    cp.async.bulk where the tile's runs are 16-byte aligned and at
//    least kBulkMinRun bytes, else by cp.async of 16-, 8- or 4-byte
//    pieces (which can pad the staged blocks apart, so that the 8-byte
//    packets a warp reads together sit in distinct banks), and for rows
//    at odd offsets (a decode's survivors) by plain loads and stores;
//  - the index lists (built once per matrix) become 16-bit stage
//    offsets in shared memory, read four to a load; their first values
//    are loaded before the tiles' loads go out, so they never wait
//    behind them;
//  - a warp takes one output row of 32 pieces at a time; a lane XORs its
//    piece of each input run the row names into four accumulators, rows
//    padded to 4 entries with a row of zeros so the loop has no branch,
//    and stores it straight to the output chunk (partial sectors for
//    8-byte packets, which L2 merges: measured faster than staging the
//    output for a second, ordered copy);
//  - the k input rows are a table of pointers passed by value, so a
//    decode's survivors are read where they lie: row c of stripe b is
//    rows[c] + b * stripe_stride.  Batched stripes [B, k, L] are rows
//    base + c * L with stride k * L; nothing is stacked or copied.
// What it leaves for later: fewer shared-memory reads an output byte
// (XOR schedules that reuse partial sums).

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

struct Args {
  Rows rows;
  const int* lists;  // w*m starts and ends, npad entries (gf2_packet.cuh)
  int npad;
  uint8_t* out;
  long long L;
  long long stride;  // bytes between an input row's stripes
  int w, ps, k, m;
  gf2p::Plan plan;
};

__device__ __forceinline__ uint32_t saddr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(saddr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void bar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          saddr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(saddr(bar))
               : "memory");
}

__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(saddr(bar)), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(saddr(dst)),
      "l"(src), "r"(bytes), "r"(saddr(bar))
      : "memory");
}

template <int V>
__device__ __forceinline__ void piece_copy(void* dst, const void* src) {
  if constexpr (V == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                     saddr(dst)),
                 "l"(src)
                 : "memory");
  } else if constexpr (V == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;" ::"r"(saddr(dst)),
                 "l"(src)
                 : "memory");
  } else if constexpr (V == 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(saddr(dst)),
                 "l"(src)
                 : "memory");
  } else {
    typedef typename gf2p::VecT<V>::type Vec;
    *static_cast<Vec*>(dst) = *static_cast<const Vec*>(src);
  }
}

// Fill stage `stage` of the ring with tile `id`; its barrier completes
// when the bytes have landed.
template <int V, int MODE>
__device__ __forceinline__ void stage_tile(const Args& a,
                                           const uint8_t* const* rows,
                                           uint8_t* stage, uint64_t* bar,
                                           long long id) {
  const gf2p::Plan& p = a.plan;
  const gf2p::Tile t = gf2p::tile_at(p, a.w, a.ps, id);
  const long long sb = t.b * a.stride;
  if constexpr (MODE == gf2p::kBulk) {
    if (threadIdx.x >= 32) return;
    if (threadIdx.x == 0)
      bar_expect(bar, static_cast<uint32_t>(gf2p::tile_bytes(p, t, a.w, a.k)));
    __syncwarp();
    const int runs = gf2p::runs_per_row(p, t, a.w, a.ps);
    for (int q = threadIdx.x; q < a.k * runs; q += 32) {
      const int c = q / runs;
      long long src;
      int dst, bytes;
      gf2p::run_at(p, t, a.w, a.ps, q - c * runs, &src, &dst, &bytes);
      bulk_copy(stage + c * p.rowpitch + dst, rows[c] + sb + src,
                static_cast<uint32_t>(bytes), bar);
    }
  } else {
    const int n_row = gf2p::pieces_per_row(t, a.w);
    for (int c = 0; c < a.k; c++) {
      const uint8_t* row = rows[c] + sb;
      uint8_t* srow = stage + c * p.rowpitch;
      for (int n = threadIdx.x; n < n_row; n += blockDim.x) {
        long long src;
        int dst;
        gf2p::piece_at(p, t, a.w, a.ps, n, &src, &dst);
        piece_copy<V>(srow + dst, row + src);
      }
    }
    if constexpr (MODE == gf2p::kAsync) {
      asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(
                       saddr(bar))
                   : "memory");
    } else {
      bar_arrive(bar);
    }
  }
}

// Phase marks for k3_timing.py --trace, compiled in only with
// -DGF2P_TRACE: the global timer (ns) of each block of the grid at its
// start (0), its first tiles' loads issued (1), its lists kept (2), its
// first tile landed (3) and XORed (4), and its end (5).
#ifdef GF2P_TRACE
constexpr int kTraceBlocks = 1024, kTraceMarks = 6;
__device__ unsigned long long trace_ns[kTraceBlocks][kTraceMarks];
#define GF2P_MARK(i)                                                   \
  do {                                                                 \
    __syncthreads();                                                   \
    if (threadIdx.x == 0 && blockIdx.x < kTraceBlocks) {               \
      unsigned long long t_;                                           \
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_));           \
      trace_ns[blockIdx.x][i] = t_;                                    \
    }                                                                  \
  } while (0)
#else
#define GF2P_MARK(i) \
  do {               \
  } while (0)
#endif

template <int V, int MODE>
__global__ void __launch_bounds__(gf2p::kThreads, 2)
    gf2_packet_kernel(const __grid_constant__ Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const gf2p::Plan& p = a.plan;
  GF2P_MARK(0);
  auto* bars = reinterpret_cast<uint64_t*>(smem);
  auto* rows = reinterpret_cast<const uint8_t**>(smem + 64);
  auto* bounds = reinterpret_cast<int*>(smem + p.lists_at);
  const int wm = a.w * a.m;
  auto* offs = reinterpret_cast<uint16_t*>(bounds + 2 * wm);
  uint8_t* stages = smem + p.stages_at;
  // the lists' first kListLoads values a thread go out before the tiles'
  // loads, so that they do not queue behind them
  constexpr int kListLoads = 4;
  const int n_list = 2 * wm + a.npad;
  int early[kListLoads];
#pragma unroll
  for (int j = 0; j < kListLoads; j++) {
    const int i = threadIdx.x + j * blockDim.x;
    early[j] = i < n_list ? a.lists[i] : 0;
  }
  if (threadIdx.x < a.k) rows[threadIdx.x] = a.rows.p[threadIdx.x];
  for (int s = 0; s < gf2p::kStages; s++)   // the zero rows, never copied to
    for (int i = threadIdx.x; i < p.rowpitch / 16; i += blockDim.x)
      reinterpret_cast<gf2p::U128*>(stages + s * p.stage_bytes + p.zero_at)[i] =
          gf2p::U128();
  if (threadIdx.x == 0) {
    for (int s = 0; s < gf2p::kStages; s++)
      bar_init(&bars[s], MODE == gf2p::kBulk ? 1 : blockDim.x);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const long long mine = gf2p::tiles_of(p, blockIdx.x);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (long long i = 0; i < gf2p::kStages - 1 && i < mine; i++)
    stage_tile<V, MODE>(a, rows, stages + i * p.stage_bytes, &bars[i],
                        blockIdx.x + i * gridDim.x);
  GF2P_MARK(1);
  auto keep = [&](int i, int x) {
    if (i < 2 * wm)
      bounds[i] = x;
    else
      offs[i - 2 * wm] = gf2p::entry_offset(p, x);
  };
#pragma unroll
  for (int j = 0; j < kListLoads; j++) {
    const int i = threadIdx.x + j * blockDim.x;
    if (i < n_list) keep(i, early[j]);
  }
  for (int i = threadIdx.x + kListLoads * blockDim.x; i < n_list;
       i += blockDim.x)
    keep(i, a.lists[i]);
  __syncthreads();
  GF2P_MARK(2);
  for (long long i = 0; i < mine; i++) {
    const long long next = i + gf2p::kStages - 1;
    if (next < mine) {   // into the stage tile i - 1 left
      const int s = static_cast<int>(next % gf2p::kStages);
      stage_tile<V, MODE>(a, rows, stages + s * p.stage_bytes, &bars[s],
                          blockIdx.x + next * gridDim.x);
    }
    const int s = static_cast<int>(i % gf2p::kStages);
    bar_wait(&bars[s], static_cast<uint32_t>((i / gf2p::kStages) & 1));
    if (i == 0) GF2P_MARK(3);
    const gf2p::Tile t =
        gf2p::tile_at(p, a.w, a.ps, blockIdx.x + i * gridDim.x);
    uint8_t* out = a.out + t.b * a.m * a.L;
    gf2p::lane_tile<V>(p, t, bounds, offs, wm, a.w, a.ps, a.L,
                       stages + s * p.stage_bytes, out, warp, lane);
    if (i == 0) GF2P_MARK(4);
    __syncthreads();   // the stages are free for the next tiles
  }
  GF2P_MARK(5);
}

template <int V, int MODE>
int launch(const Args& a, cudaStream_t st) {
  static std::once_flag once;
  static cudaError_t attr = cudaSuccess;
  std::call_once(once, [] {
    attr = cudaFuncSetAttribute(gf2_packet_kernel<V, MODE>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                gf2p::kSmemOne);
    if (attr == cudaSuccess)
      attr = cudaFuncSetAttribute(
          gf2_packet_kernel<V, MODE>,
          cudaFuncAttributePreferredSharedMemoryCarveout,
          cudaSharedmemCarveoutMaxShared);
  });
  if (attr != cudaSuccess) return attr;
  gf2_packet_kernel<V, MODE>
      <<<a.plan.grid, gf2p::kThreads, a.plan.smem_bytes, st>>>(a);
  return cudaGetLastError();
}

// SMs of the current device, asked once a device.
int sm_count() {
  static int count[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  if (!count[dev]) {
    int n = 0;
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        n < 1)
      return 132;
    count[dev] = n;
  }
  return count[dev];
}

}  // namespace

extern "C" {

// out u8[B, m, L] (contiguous) = the (w*m, w*k) bit matrix whose index
// lists are `lists` (w*m starts, w*m ends, npad entries: gf2_packet.cuh)
// applied to k input rows in the packet layout (w, ps): row c of stripe
// b is the L bytes at rows[c] + b * stripe_stride, or, when `rows` is
// null, at base + c * L + b * stripe_stride.  1 <= k, m <= 32; w*k,
// w*m <= 256; L a multiple of w * ps; 1 <= B <= 65535.  Returns the
// launch's cudaError_t; 0 is success.
int gf2_packet_launch(const void* lists, int npad, const void* const* rows,
                      const void* base, long long stripe_stride, void* out,
                      int B, int k, int m, int w, int ps, long long L,
                      void* stream) {
  if (k < 1 || k > kMaxRows || m < 1 || m > kMaxRows || w < 1 || ps < 1 ||
      w * k > gf2p::kMaxBits || w * m > gf2p::kMaxBits || B < 1 ||
      B > 65535 || L < 1 || L % (static_cast<long long>(w) * ps) ||
      npad < 0 || npad > w * m * (w * k + 3))
    return cudaErrorInvalidValue;
  Args a{};
  unsigned long long addr_or = static_cast<unsigned long long>(stripe_stride);
  for (int c = 0; c < k; c++) {
    a.rows.p[c] = rows != nullptr ? static_cast<const uint8_t*>(rows[c])
                                  : static_cast<const uint8_t*>(base) + c * L;
    addr_or |= reinterpret_cast<uintptr_t>(a.rows.p[c]);
  }
  // the output is written in pieces of the same width
  addr_or |= reinterpret_cast<uintptr_t>(out);
  a.lists = static_cast<const int*>(lists);
  a.npad = npad;
  a.out = static_cast<uint8_t*>(out);
  a.L = L;
  a.stride = stripe_stride;
  a.w = w;
  a.ps = ps;
  a.k = k;
  a.m = m;
  a.plan = gf2p::plan(ps, w, k, m, npad, L, B, addr_or, sm_count());
  auto st = static_cast<cudaStream_t>(stream);
  switch (a.plan.V) {
    case 16:
      return a.plan.mode == gf2p::kBulk ? launch<16, gf2p::kBulk>(a, st)
                                        : launch<16, gf2p::kAsync>(a, st);
    case 8: return launch<8, gf2p::kAsync>(a, st);
    case 4: return launch<4, gf2p::kAsync>(a, st);
    case 2: return launch<2, gf2p::kSync>(a, st);
    default: return launch<1, gf2p::kSync>(a, st);
  }
}

// The plan a launch of these arguments takes (the wrapper's `plan` and
// chip_smoke report it): V, mode, T, nr, runp, tiles, grid, smem bytes.
void gf2_packet_plan(int ps, int w, int k, int m, int npad, long long L,
                     long long B, unsigned long long addr_or,
                     long long* out) {
  const gf2p::Plan p = gf2p::plan(ps, w, k, m, npad, L, B, addr_or,
                                  sm_count());
  const long long v[] = {p.V, p.mode, p.T, p.nr, p.runp, p.tiles, p.grid,
                         p.smem_bytes};
  for (int i = 0; i < 8; i++) out[i] = v[i];
}

// The phase marks of the last launch (kTraceBlocks x kTraceMarks, ns),
// when built with -DGF2P_TRACE; returns the cudaError_t of the copy, or
// -1 in a build without the marks.
int gf2_packet_trace(unsigned long long* out) {
#ifdef GF2P_TRACE
  return cudaMemcpyFromSymbol(out, trace_ns, sizeof(trace_ns));
#else
  (void)out;
  return -1;
#endif
}

}  // extern "C"
