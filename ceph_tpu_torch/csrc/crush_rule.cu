// crush_rule — the batched CRUSH rule walk, a group of G lanes per input x.
//
// Replaces: ceph_tpu/crush/mapper_jax.py:make_single_fn (vmapped and
// jitted by build_rule_fn), the XLA program that runs crush_do_rule for
// every x of a batch with lax.while_loop retry descents.  This is a port
// of native/crush_host.cpp:do_rule_one (hash3, crush_ln, straw2_draw,
// bucket_straw2_choose, choose_firstn, choose_indep, the rule VM) with
// the same C semantics: choose_tries = total_tries + 1, a strict `>` so
// the first maximum wins, a zero-weight item draws S64_MIN, and the
// straw2 quotient is int64 division truncating toward zero.
//
// Scope: straw2 buckets with the rjenkins hash, no choose_args, and
// choose_local_tries == choose_local_fallback_tries == 0.  The Python
// wrapper (ceph_tpu_torch/crush/mapper.py) refuses any other map or rule
// before launching, result_max above kRMax and buckets wider than
// kMaxBucket.
//
// What bounds it on an H100: 32-bit integer issue.  Each straw2 item
// draw is a 3-input rjenkins hash (~180 ops in 5 serial mix rounds) and
// the crush_ln table pipeline (~15); the map (~100 KB at 10,000
// devices) stays in L1/L2 and an x moves a few dozen bytes.
//
// What the design does about it:
//  - No division on the draw path.  MapArrays.magic derives, per item
//    weight w, a magic m | l << 58 (ln.py:straw2_magic) with
//    floor(n / w) == mulhi64(n << 15, m) >> l for every n < 2^49; the
//    numerator n = 2^48 - crush_ln(u) is at most 2^48.  The C draw is
//    -floor(n / w), so the largest draw is the smallest quotient.
//  - Lanes over a bucket's items.  G lanes walk one x: in a straw2
//    choose, lane l draws items l, l+G, ... (contiguous loads across the
//    group) and keeps the smallest key (quotient << 15 | item index;
//    a zero weight carries a quotient above any real one), then a
//    __shfl_xor_sync butterfly takes the group's minimum.  Keys are
//    unique, and the lower index wins a tied quotient: C's first
//    maximum.  Everything else (the rule VM, the retry loops, is_out)
//    runs uniformly in all G lanes, so 65,536 xs make 65,536 x G
//    threads and fill the card.
//  - The rule VM's work vectors (w, o, c and the result, result_max
//    entries each) live in per-group shared memory sized by result_max
//    at launch, not in per-thread local arrays.  Every lane of a group
//    stores the same values there and reads what any lane stored, so
//    each shared store follows a __syncwarp of the group: once a lane
//    passes it, every lane has made its reads of the old value and its
//    earlier stores.  All lanes of a group take the same path through
//    the walk, so each of them reaches every __syncwarp.
//  - The two small crush_ln tables (4 KB) sit in shared memory, loaded
//    once per block; the rule's steps and tunables travel by value in
//    the kernel's parameter block (constant bank, read uniformly).

#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kGroup = 4;       // lanes per x
constexpr int kRMax = 32;       // result_max cap (MAX_RESULT in mapper.py)
constexpr int kMaxSteps = 32;   // rule steps (MAX_STEPS in mapper.py)
constexpr int kRhLhLen = 258;
constexpr int kLlLen = 256;
constexpr uint32_t kHashSeed = 0x4E67C6A7u;  // 1315423911
constexpr int32_t kItemUndef = 0x7FFFFFFE;
constexpr int32_t kItemNone = 0x7FFFFFFF;

// The straw2 key (ln.py: MAGIC_*): quotient << kIdxBits | item index.
constexpr int kIdxBits = 15;
constexpr int kMaxBucket = 1 << kIdxBits;  // MAX_BUCKET in mapper.py
constexpr int kMagicShiftAt = 58;
constexpr uint64_t kMagicMask = (1ull << kMagicShiftAt) - 1;
constexpr int kPreshift = 15;                   // 64 - 49 numerator bits
constexpr uint64_t kZeroWeightQ = (1ull << 49) - 1;  // > any quotient
constexpr uint64_t kNoKey = ~0ull;

constexpr int kOpTake = 1;
constexpr int kOpChooseFirstn = 2;
constexpr int kOpChooseIndep = 3;
constexpr int kOpEmit = 4;
constexpr int kOpChooseleafFirstn = 6;
constexpr int kOpChooseleafIndep = 7;
constexpr int kOpSetChooseTries = 8;
constexpr int kOpSetChooseleafTries = 9;
constexpr int kOpSetChooseleafVaryR = 12;
constexpr int kOpSetChooseleafStable = 13;

// Layout mirrored by mapper.py:_Program (ctypes).
struct RuleParams {
  int nsteps;
  int steps[3 * kMaxSteps];
  int total_tries, descend_once, vary_r, stable;
  int result_max, max_devices, B, S, weight_len;
};

// ---- rjenkins1 (src/crush/hash.c) ------------------------------------------

__device__ __forceinline__ void mix(uint32_t& a, uint32_t& b, uint32_t& c) {
  a = a - b - c; a ^= c >> 13;
  b = b - c - a; b ^= a << 8;
  c = c - a - b; c ^= b >> 13;
  a = a - b - c; a ^= c >> 12;
  b = b - c - a; b ^= a << 16;
  c = c - a - b; c ^= b >> 5;
  a = a - b - c; a ^= c >> 3;
  b = b - c - a; b ^= a << 10;
  c = c - a - b; c ^= b >> 15;
}

__device__ __forceinline__ uint32_t hash2(uint32_t a, uint32_t b) {
  uint32_t h = kHashSeed ^ a ^ b;
  uint32_t x = 231232, y = 1232;
  mix(a, b, h);
  mix(x, a, h);
  mix(b, y, h);
  return h;
}

__device__ __forceinline__ uint32_t hash3(uint32_t a, uint32_t b,
                                          uint32_t c) {
  uint32_t h = kHashSeed ^ a ^ b ^ c;
  uint32_t x = 231232, y = 1232;
  mix(a, b, h);
  mix(c, x, h);
  mix(y, a, h);
  mix(b, x, h);
  mix(y, c, h);
  return h;
}

// ---- 2^44 * log2(x + 1) in fixed point (src/crush/mapper.c:226-268) --------

__device__ __forceinline__ uint64_t crush_ln(uint32_t xin,
                                            const uint64_t* rh_lh,
                                            const uint64_t* ll) {
  uint32_t x = xin + 1;
  int iexpon = 15;
  if (!(x & 0x18000)) {
    const int bits = __clz(x & 0x1FFFF) - 16;  // x >= 1
    x <<= bits;
    iexpon = 15 - bits;
  }
  const uint32_t index1 = (x >> 8) << 1;
  const uint64_t rh = rh_lh[index1 - 256];
  uint64_t lh = rh_lh[index1 + 1 - 256];
  const uint64_t xl64 = (static_cast<uint64_t>(x) * rh) >> 48;
  const uint32_t index2 = xl64 & 0xFF;
  lh = (lh + ll[index2]) >> (48 - 12 - 32);
  return (static_cast<uint64_t>(iexpon) << (12 + 32)) + lh;
}

// ---- one x's walk, by a group of G lanes ------------------------------------

template <int G>
__device__ __forceinline__ uint64_t group_min(uint64_t v, unsigned mask) {
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) {
    const uint64_t o = __shfl_xor_sync(
        mask, static_cast<unsigned long long>(v), off, G);
    v = o < v ? o : v;
  }
  return v;
}

template <int G>
struct Walk {
  const int32_t* alg;
  const int32_t* btype;
  const int32_t* size;
  const int32_t* items;   // [B, S]
  const uint64_t* magic;  // [B, S] straw2 reciprocals (ln.py:straw2_magic)
  const uint32_t* weight; // [weight_len] device weights
  const uint64_t* rh_lh;
  const uint64_t* ll;
  int B, S, max_devices, weight_len;
  uint32_t x;
  int lane;       // this thread's lane in the group, [0, G)
  unsigned mask;  // the group's lanes in the warp
  int draws;      // straw2 items drawn so far, counted once per x

  // Before every store to the group's shared work vectors.
  __device__ void sync() const { __syncwarp(mask); }

  __device__ bool valid_bucket(int32_t id) const {
    return id < 0 && -1 - id < B && alg[-1 - id] != 0;
  }

  __device__ int item_type(int32_t item) const {
    if (item >= 0) return 0;
    return valid_bucket(item) ? btype[-1 - item] : -1;
  }

  // bucket_straw2_choose (mapper.c:339-362): the item with the smallest
  // quotient (the largest draw), the lowest index among ties.
  __device__ int32_t straw2_choose(int bi, uint32_t r) {
    const int sz = size[bi];
    const int32_t* ids = items + static_cast<size_t>(bi) * S;
    const uint64_t* mg = magic + static_cast<size_t>(bi) * S;
    uint64_t best = kNoKey;
    for (int i = lane; i < sz; i += G) {
      const uint64_t m = mg[i];
      uint64_t q = kZeroWeightQ;
      if (m != 0) {
        const uint32_t u =
            hash3(x, static_cast<uint32_t>(ids[i]), r) & 0xFFFF;
        const uint64_t n = (1ull << 48) - crush_ln(u, rh_lh, ll);
        q = __umul64hi(n << kPreshift, m & kMagicMask) >>
            static_cast<int>(m >> kMagicShiftAt);
      }
      const uint64_t key = q << kIdxBits | static_cast<uint64_t>(i);
      best = key < best ? key : best;
    }
    best = group_min<G>(best, mask);
    draws += sz;
    return ids[best & (kMaxBucket - 1)];
  }

  // is_out (mapper.c:402-416)
  __device__ bool is_out(int32_t item) const {
    if (item >= weight_len) return true;
    const uint32_t w = weight[item];
    if (w >= 0x10000) return false;
    if (w == 0) return true;
    return (hash2(x, static_cast<uint32_t>(item)) & 0xFFFF) >= w;
  }

  // crush_choose_firstn (mapper.c:438-626) without local retries.
  template <bool kLeaf>
  __device__ int choose_firstn(int bucket_bi, int numrep, int type,
                               int32_t* out, int outpos, int out_size,
                               int tries, int recurse_tries, int vary_r,
                               int stable, int32_t* out2, int parent_r) {
    int count = out_size;
    for (int rep = stable ? 0 : outpos; rep < numrep && count > 0; rep++) {
      int ftotal = 0;
      bool skip_rep = false;
      int32_t item = 0;
      int in_bi = bucket_bi;
      for (;;) {  // one draw per pass: descend, retry or finish
        bool collide = false, reject = false;
        const uint32_t r = rep + parent_r + ftotal;
        if (size[in_bi] == 0) {
          reject = true;
        } else {
          item = straw2_choose(in_bi, r);
          if (item >= max_devices) {
            skip_rep = true;
            break;
          }
          const int itemtype = item_type(item);
          if (itemtype != type) {
            if (item >= 0 || !valid_bucket(item)) {
              skip_rep = true;
              break;
            }
            in_bi = -1 - item;
            continue;
          }
          for (int i = 0; i < outpos; i++) {
            if (out[i] == item) {
              collide = true;
              break;
            }
          }
          if constexpr (kLeaf) {
            if (!collide) {
              if (item < 0) {
                const int sub_r =
                    vary_r ? (static_cast<int>(r) >> (vary_r - 1)) : 0;
                const int got = choose_firstn<false>(
                    -1 - item, stable ? 1 : outpos + 1, 0, out2, outpos,
                    count, recurse_tries, 0, vary_r, stable, nullptr, sub_r);
                if (got <= outpos) reject = true;
              } else {
                sync();
                out2[outpos] = item;
              }
            }
          }
          if (!reject && !collide && itemtype == 0) reject = is_out(item);
        }
        if (!reject && !collide) break;
        ftotal++;
        if (ftotal < tries) {
          in_bi = bucket_bi;  // retry the descent from the top
          continue;
        }
        skip_rep = true;
        break;
      }
      if (!skip_rep) {
        sync();
        out[outpos] = item;
        outpos++;
        count--;
      }
    }
    return outpos;
  }

  // crush_choose_indep (mapper.c:633-821), straw2 buckets only.
  template <bool kLeaf>
  __device__ void choose_indep(int bucket_bi, int left, int numrep, int type,
                               int32_t* out, int outpos, int tries,
                               int recurse_tries, int32_t* out2,
                               int parent_r) {
    const int endpos = outpos + left;
    sync();
    for (int rep = outpos; rep < endpos; rep++) {
      out[rep] = kItemUndef;
      if (kLeaf) out2[rep] = kItemUndef;
    }
    for (int ftotal = 0; left > 0 && ftotal < tries; ftotal++) {
      for (int rep = outpos; rep < endpos; rep++) {
        if (out[rep] != kItemUndef) continue;
        int in_bi = bucket_bi;
        for (;;) {
          const uint32_t r = rep + parent_r + numrep * ftotal;
          if (size[in_bi] == 0) break;
          const int32_t item = straw2_choose(in_bi, r);
          if (item >= max_devices) {
            sync();
            out[rep] = kItemNone;
            if (kLeaf) out2[rep] = kItemNone;
            left--;
            break;
          }
          const int itemtype = item_type(item);
          if (itemtype != type) {
            if (item >= 0 || !valid_bucket(item)) {
              sync();
              out[rep] = kItemNone;
              if (kLeaf) out2[rep] = kItemNone;
              left--;
              break;
            }
            in_bi = -1 - item;
            continue;
          }
          bool collide = false;
          for (int i = outpos; i < endpos; i++) {
            if (out[i] == item) {
              collide = true;
              break;
            }
          }
          if (collide) break;
          if constexpr (kLeaf) {
            if (item < 0) {
              choose_indep<false>(-1 - item, 1, numrep, 0, out2, rep,
                                  recurse_tries, 0, nullptr,
                                  static_cast<int>(r));
              if (out2[rep] == kItemNone) break;
            } else {
              sync();
              out2[rep] = item;
            }
          }
          if (itemtype == 0 && is_out(item)) break;
          sync();
          out[rep] = item;
          left--;
          break;
        }
      }
    }
    for (int rep = outpos; rep < endpos; rep++) {
      const int32_t v = out[rep];
      const int32_t v2 = kLeaf ? out2[rep] : 0;
      sync();
      out[rep] = v == kItemUndef ? kItemNone : v;
      if (kLeaf) out2[rep] = v2 == kItemUndef ? kItemNone : v2;
    }
  }

  // crush_do_rule (mapper.c:878-1080) into work[3R, 4R); returns the
  // result length.  work: the group's 4 * result_max entries.
  __device__ int do_rule(const RuleParams& p, int32_t* work) {
    const int R = p.result_max;
    int32_t* w = work;
    int32_t* o = work + R;
    int32_t* c = work + 2 * R;
    int32_t* result = work + 3 * R;
    int wsize = 0, result_len = 0;
    int choose_tries = p.total_tries + 1;  // mapper.c:906 off-by-one heritage
    int choose_leaf_tries = 0;
    int vary_r = p.vary_r, stable = p.stable;
    for (int s = 0; s < p.nsteps; s++) {
      const int op = p.steps[3 * s], arg1 = p.steps[3 * s + 1],
                arg2 = p.steps[3 * s + 2];
      switch (op) {
        case kOpTake:
          if ((arg1 >= 0 && arg1 < max_devices) || valid_bucket(arg1)) {
            sync();
            w[0] = arg1;
            wsize = 1;
          }
          break;
        case kOpSetChooseTries:
          if (arg1 > 0) choose_tries = arg1;
          break;
        case kOpSetChooseleafTries:
          if (arg1 > 0) choose_leaf_tries = arg1;
          break;
        case kOpSetChooseleafVaryR:
          if (arg1 >= 0) vary_r = arg1;
          break;
        case kOpSetChooseleafStable:
          if (arg1 >= 0) stable = arg1;
          break;
        case kOpChooseFirstn:
        case kOpChooseIndep:
        case kOpChooseleafFirstn:
        case kOpChooseleafIndep: {
          if (wsize == 0) break;
          const bool firstn = op == kOpChooseFirstn || op == kOpChooseleafFirstn;
          const bool leaf = op == kOpChooseleafFirstn || op == kOpChooseleafIndep;
          int osize = 0;
          for (int i = 0; i < wsize; i++) {
            int numrep = arg1;
            if (numrep <= 0) {
              numrep += R;
              if (numrep <= 0) continue;
            }
            if (w[i] >= 0 || !valid_bucket(w[i])) continue;
            const int bi = -1 - w[i];
            if (firstn) {
              const int recurse_tries =
                  choose_leaf_tries ? choose_leaf_tries
                                    : (p.descend_once ? 1 : choose_tries);
              if (leaf) {
                osize += choose_firstn<true>(bi, numrep, arg2, o + osize, 0,
                                             R - osize, choose_tries,
                                             recurse_tries, vary_r, stable,
                                             c + osize, 0);
              } else {
                osize += choose_firstn<false>(bi, numrep, arg2, o + osize, 0,
                                              R - osize, choose_tries,
                                              recurse_tries, vary_r, stable,
                                              nullptr, 0);
              }
            } else {
              const int out_size = numrep < R - osize ? numrep : R - osize;
              const int leaf_tries = choose_leaf_tries ? choose_leaf_tries : 1;
              if (leaf) {
                choose_indep<true>(bi, out_size, numrep, arg2, o + osize, 0,
                                   choose_tries, leaf_tries, c + osize, 0);
              } else {
                choose_indep<false>(bi, out_size, numrep, arg2, o + osize, 0,
                                    choose_tries, leaf_tries, nullptr, 0);
              }
              osize += out_size;
            }
          }
          if (leaf) {
            sync();
            for (int i = 0; i < osize; i++) o[i] = c[i];
          }
          int32_t* tmp = w;
          w = o;
          o = tmp;
          wsize = osize;
          break;
        }
        case kOpEmit:
          sync();
          for (int i = 0; i < wsize && result_len < R; i++) {
            result[result_len++] = w[i];
          }
          wsize = 0;
          break;
        default:  // noop; local-tries steps are refused by the wrapper
          break;
      }
    }
    return result_len;
  }
};

// ---- kernel and launch -----------------------------------------------------

constexpr int kThreads = 256;
static_assert(kGroup >= 1 && kGroup <= 32 && (kGroup & (kGroup - 1)) == 0,
              "kGroup must be a power of two in [1, 32]");
constexpr int kGroupsPerBlock = kThreads / kGroup;
static_assert(kGroupsPerBlock * 4 * kRMax * sizeof(int32_t) +
                      sizeof(uint64_t) * (kRhLhLen + kLlLen) <=
                  48 * 1024,
              "the work vectors at kRMax must fit the default shared memory");

template <int G>
__global__ void __launch_bounds__(kThreads)
crush_rule_kernel(const RuleParams p, const int32_t* __restrict__ alg,
                  const int32_t* __restrict__ btype,
                  const int32_t* __restrict__ size,
                  const int32_t* __restrict__ items,
                  const uint64_t* __restrict__ magic,
                  const uint32_t* __restrict__ weight,
                  const uint32_t* __restrict__ xs, int nx,
                  const uint64_t* __restrict__ ln_tabs,
                  int32_t* __restrict__ results, int32_t* __restrict__ lens,
                  int32_t* __restrict__ draws) {
  __shared__ uint64_t s_tabs[kRhLhLen + kLlLen];
  extern __shared__ int32_t s_work[];  // [groups per block][4 * result_max]
  for (int t = threadIdx.x; t < kRhLhLen + kLlLen; t += blockDim.x) {
    s_tabs[t] = ln_tabs[t];
  }
  __syncthreads();
  const int g = threadIdx.x / G;
  const int lane = threadIdx.x % G;
  const int i = blockIdx.x * (kThreads / G) + g;
  if (i >= nx) return;  // the whole group leaves together
  const int R = p.result_max;
  const unsigned mask =
      G == 32 ? 0xFFFFFFFFu
              : ((1u << G) - 1) << ((threadIdx.x & 31) & ~(G - 1));
  Walk<G> wk{alg, btype, size, items, magic, weight, s_tabs,
             s_tabs + kRhLhLen, p.B, p.S, p.max_devices, p.weight_len,
             xs[i], lane, mask, 0};
  int32_t* work = s_work + g * 4 * R;
  const int len = wk.do_rule(p, work);
  int32_t* row = results + static_cast<size_t>(i) * R;
  for (int j = lane; j < R; j += G) {
    row[j] = j < len ? work[3 * R + j] : kItemNone;
  }
  if (lane == 0) {
    lens[i] = len;
    if (draws != nullptr) draws[i] = wk.draws;
  }
}

}  // namespace

extern "C" {

// Map xs[0..nx) through the rule in *params over the SoA map (int32
// rows; u32 fields as bit patterns; magic u64[B, S] from
// ln.py:straw2_magic).  results i32[nx, result_max] padded with
// CRUSH_ITEM_NONE, lens i32[nx]; draws (nullable) i32[nx] receives each
// x's straw2 draw count.  ln_tabs: RH/LH (258) then LL (256) as u64.
// Returns the launch's cudaError_t; 0 is success.
int crush_rule_batched_launch(const void* params, const void* alg,
                              const void* btype, const void* size,
                              const void* items, const void* magic,
                              const void* weight, const void* xs, int nx,
                              const void* ln_tabs, void* results, void* lens,
                              void* draws, void* stream) {
  const RuleParams& p = *static_cast<const RuleParams*>(params);
  if (p.result_max < 1 || p.result_max > kRMax) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int blocks = (nx + kGroupsPerBlock - 1) / kGroupsPerBlock;
  const size_t smem =
      static_cast<size_t>(kGroupsPerBlock) * 4 * p.result_max * sizeof(int32_t);
  crush_rule_kernel<kGroup>
      <<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
          p, static_cast<const int32_t*>(alg),
          static_cast<const int32_t*>(btype),
          static_cast<const int32_t*>(size),
          static_cast<const int32_t*>(items),
          static_cast<const uint64_t*>(magic),
          static_cast<const uint32_t*>(weight),
          static_cast<const uint32_t*>(xs), nx,
          static_cast<const uint64_t*>(ln_tabs),
          static_cast<int32_t*>(results), static_cast<int32_t*>(lens),
          static_cast<int32_t*>(draws));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
