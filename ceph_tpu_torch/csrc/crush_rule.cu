// crush_rule — the batched CRUSH rule walk, a group of G lanes per input x.
//
// Replaces: ceph_tpu/crush/mapper_jax.py:make_single_fn (vmapped and
// jitted by build_rule_fn), the XLA program that runs crush_do_rule for
// every x of a batch with lax.while_loop retry descents.  This is a port
// of native/crush_host.cpp:do_rule_one (hash3/hash4, crush_ln, the five
// bucket chooses, choose_firstn with local retries and the perm
// fallback, choose_indep, the rule VM) with the same C semantics:
// choose_tries = total_tries + 1, a strict `>` so the first maximum
// wins, a zero-weight straw2 item draws S64_MIN, and the straw2 quotient
// is int64 division truncating toward zero.
//
// Scope: every bucket algorithm with the rjenkins hash, choose_args and
// local retries.  The Python wrapper (ceph_tpu_torch/crush/mapper.py)
// refuses other hashes, result_max above kRMax, more than kMaxSteps
// steps and buckets wider than kMaxBucket before launching.
//
// What bounds it on an H100: 32-bit integer issue.  Each straw2 item
// draw is a 3-input rjenkins hash (~180 ops in 5 serial mix rounds) and
// the crush_ln table pipeline (~15); list items and tree levels a
// 4-input hash (6 rounds), straw items and perm steps a 3-input one.
// The map (~100 KB at 10,000 devices) stays in L1/L2 and an x moves a
// few dozen bytes.
//
// What the design does about it:
//  - Two instantiations, picked at launch from the map: all straw2
//    without choose_args or local retries (kGeneral = false: no
//    algorithm switch or retry bookkeeping in the loop), and the general
//    walk for every other map.
//  - No division on the straw2 path.  MapArrays.magic derives, per item
//    weight w, a magic m | l << 58 (ln.py:straw2_magic) with
//    floor(n / w) == mulhi64(n << 15, m) >> l for every n < 2^49; the
//    numerator n = 2^48 - crush_ln(u) is at most 2^48.  The C draw is
//    -floor(n / w), so the largest draw is the smallest quotient.  With
//    choose_args the magics come from the weight sets ([B, P, S]).
//  - Lanes over a bucket's items.  G lanes walk one x: in a straw2,
//    straw or list choose, lane l draws items l, l+G, ... (contiguous
//    loads across the group) and keeps its best, then a __shfl_xor_sync
//    butterfly combines the group.  straw2 and straw keep the smallest
//    key (a quotient, or 2^48 - 1 - the straw draw, << 15 | index), so
//    the lower index wins a tie: C's first maximum.  list keeps the
//    highest qualifying index.  A tree descent is one serial chain,
//    which every lane runs alike.  A uniform (perm) choose traces its
//    entry back through the Fisher-Yates swaps with G swap hashes in
//    flight, one per lane (see perm_choose).  Everything else (the rule
//    VM, the retry loops, is_out) runs uniformly in all G lanes, so
//    65,536 xs make 65,536 x G threads and fill the card.
//  - The rule VM's work vectors (w, o, c and the result, result_max
//    entries each) live in per-group shared memory sized by result_max
//    at launch, not in per-thread local arrays.  Every lane of a group
//    stores the same values there and reads what any lane stored, so
//    each shared store follows a __syncwarp of the group: once a lane
//    passes it, every lane has made its reads of the old value and its
//    earlier stores.  All lanes of a group take the same path through
//    the walk, so each of them reaches every __syncwarp and shuffle.
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
constexpr uint64_t kStrawTop = (1ull << 48) - 1;  // > any straw draw

constexpr int kAlgUniform = 1;
constexpr int kAlgList = 2;
constexpr int kAlgTree = 3;
constexpr int kAlgStraw = 4;
constexpr int kAlgStraw2 = 5;
constexpr int kNumAlgs = 5;  // columns of draws (N_ALGS in mapper.py)

constexpr int kOpTake = 1;
constexpr int kOpChooseFirstn = 2;
constexpr int kOpChooseIndep = 3;
constexpr int kOpEmit = 4;
constexpr int kOpChooseleafFirstn = 6;
constexpr int kOpChooseleafIndep = 7;
constexpr int kOpSetChooseTries = 8;
constexpr int kOpSetChooseleafTries = 9;
constexpr int kOpSetChooseLocalTries = 10;
constexpr int kOpSetChooseLocalFallbackTries = 11;
constexpr int kOpSetChooseleafVaryR = 12;
constexpr int kOpSetChooseleafStable = 13;

// Layout mirrored by mapper.py:_Program (ctypes).
struct RuleParams {
  int nsteps;
  int steps[3 * kMaxSteps];
  int local_tries, local_fallback_tries, total_tries, descend_once, vary_r,
      stable;
  int result_max, max_devices, B, S, N, P, weight_len;
  int has_args;  // straw2 hashes arg_ids and reads the [B, P, S] magics
  int general;   // launch Walk<G, true>
};

// Layout mirrored by mapper.py:_MapPtrs: the map's device arrays (u32
// fields as bit patterns) and the straw2 magics.
struct MapPtrs {
  const int32_t* alg;            // [B]
  const int32_t* btype;          // [B]
  const int32_t* size;           // [B]
  const int32_t* nnodes;         // [B]   tree num_nodes
  const int32_t* items;          // [B, S]
  const int32_t* arg_ids;        // [B, S] choose_args ids
  const uint32_t* weights;       // [B, S] item weights (list)
  const uint32_t* sum_weights;   // [B, S] list prefix sums
  const uint32_t* straws;        // [B, S] legacy straw lengths
  const uint32_t* node_weights;  // [B, N] tree node weights
  const uint64_t* magic;         // [B, S], or [B, P, S] with has_args
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

__device__ __forceinline__ uint32_t hash4(uint32_t a, uint32_t b, uint32_t c,
                                          uint32_t d) {
  uint32_t h = kHashSeed ^ a ^ b ^ c ^ d;
  uint32_t x = 231232, y = 1232;
  mix(a, b, h);
  mix(c, d, h);
  mix(a, x, h);
  mix(y, b, h);
  mix(c, x, h);
  mix(y, d, h);
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
__device__ __forceinline__ int group_max(int v, unsigned mask) {
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) {
    const int o = __shfl_xor_sync(mask, v, off, G);
    v = o > v ? o : v;
  }
  return v;
}

template <int G, bool kGeneral>
struct Walk {
  MapPtrs m;
  const uint32_t* weight;  // [weight_len] device weights
  const uint64_t* rh_lh;
  const uint64_t* ll;
  int B, S, N, P, max_devices, weight_len;
  bool has_args;
  uint32_t x;
  int lane;       // this thread's lane in the group, [0, G)
  unsigned mask;  // the group's lanes in the warp
  int draws[kNumAlgs];  // bucket draws so far by algorithm, once per x

  // Before every store to the group's shared work vectors.
  __device__ void sync() const { __syncwarp(mask); }

  __device__ bool valid_bucket(int32_t id) const {
    return id < 0 && -1 - id < B && m.alg[-1 - id] != 0;
  }

  __device__ int item_type(int32_t item) const {
    if (item >= 0) return 0;
    return valid_bucket(item) ? m.btype[-1 - item] : -1;
  }

  // bucket_straw2_choose (mapper.c:339-362): the item with the smallest
  // quotient (the largest draw), the lowest index among ties.  ``ids``
  // are what is hashed (the items, or choose_args ids), ``mg`` the row
  // of magics of the weights drawn against.
  __device__ int32_t straw2_choose(int bi, uint32_t r, const int32_t* ids,
                                   const uint64_t* mg) {
    const int sz = m.size[bi];
    uint64_t best = kNoKey;
    for (int i = lane; i < sz; i += G) {
      const uint64_t mi = mg[i];
      uint64_t q = kZeroWeightQ;
      if (mi != 0) {
        const uint32_t u =
            hash3(x, static_cast<uint32_t>(ids[i]), r) & 0xFFFF;
        const uint64_t n = (1ull << 48) - crush_ln(u, rh_lh, ll);
        q = __umul64hi(n << kPreshift, mi & kMagicMask) >>
            static_cast<int>(mi >> kMagicShiftAt);
      }
      const uint64_t key = q << kIdxBits | static_cast<uint64_t>(i);
      best = key < best ? key : best;
    }
    best = group_min<G>(best, mask);
    draws[kAlgStraw2 - 1] += sz;
    return m.items[static_cast<size_t>(bi) * S + (best & (kMaxBucket - 1))];
  }

  // bucket_straw_choose (mapper.c:205-223): the first maximum of
  // (hash & 0xffff) * straw, a product below 2^48.
  __device__ int32_t straw_choose(int bi, uint32_t r) {
    const int sz = m.size[bi];
    const size_t row = static_cast<size_t>(bi) * S;
    uint64_t best = kNoKey;
    for (int i = lane; i < sz; i += G) {
      const uint64_t draw =
          static_cast<uint64_t>(
              hash3(x, static_cast<uint32_t>(m.items[row + i]), r) &
              0xFFFF) *
          m.straws[row + i];
      const uint64_t key =
          (kStrawTop - draw) << kIdxBits | static_cast<uint64_t>(i);
      best = key < best ? key : best;
    }
    best = group_min<G>(best, mask);
    draws[kAlgStraw - 1] += sz;
    return m.items[row + (best & (kMaxBucket - 1))];
  }

  // bucket_list_choose (mapper.c:119-142): the C loop runs from the tail
  // and returns the first hit, so the highest index whose
  // (hash & 0xffff) * sum_weight >> 16 falls below its weight; items[0]
  // if none does.
  __device__ int32_t list_choose(int bi, uint32_t r) {
    const int sz = m.size[bi];
    const size_t row = static_cast<size_t>(bi) * S;
    const uint32_t id = static_cast<uint32_t>(-1 - bi);
    int best = -1;
    for (int i = lane; i < sz; i += G) {
      const uint64_t h =
          hash4(x, static_cast<uint32_t>(m.items[row + i]), r, id) & 0xFFFF;
      if (((h * m.sum_weights[row + i]) >> 16) < m.weights[row + i]) {
        best = i;  // i rises in each lane: its last hit is its highest
      }
    }
    best = group_max<G>(best, mask);
    draws[kAlgList - 1] += sz;
    return m.items[row + (best < 0 ? 0 : best)];
  }

  // bucket_tree_choose (mapper.c:145-200): from node num_nodes >> 1 down
  // the implicit binary tree to an odd (leaf) node, left when
  // hash * node_weight >> 32 is below the left child's weight.  A serial
  // chain: every lane of the group runs it alike.
  __device__ int32_t tree_choose(int bi, uint32_t r) {
    const uint32_t* nw = m.node_weights + static_cast<size_t>(bi) * N;
    const uint32_t id = static_cast<uint32_t>(-1 - bi);
    int n = m.nnodes[bi] >> 1;
    if (n < 1) n = 1;  // a malformed tree ends at once, as in mapper_jax
    while (!(n & 1)) {
      const uint32_t t =
          __umulhi(hash4(x, static_cast<uint32_t>(n), r, id), nw[n]);
      const int half = (n & -n) >> 1;
      const int left = n - half;
      n = t < nw[left] ? left : n + half;
      draws[kAlgTree - 1]++;
    }
    return m.items[static_cast<size_t>(bi) * S + (n >> 1)];
  }

  // bucket_perm_choose (mapper.c:51-109): entry pr = r % size of the
  // bucket's Fisher-Yates permutation of x.  The C code builds the
  // permutation step by step and keeps it per bucket across calls;
  // entry pr depends only on (x, bucket, pr), so this traces it back
  // and keeps no state: step k swaps positions k and k + i_k (i_k =
  // hash3(x, id, k) % (size - k), no swap at k = size - 1), and the
  // entry at pr after steps 0..pr came from the position reached by
  // undoing them from step pr down to 0.  Each round, lane l hashes step
  // top - l and the group undoes those G steps in order by shuffles.
  // The C r = 0 shortcut (perm[0] = i_0) gives the same value.
  __device__ int32_t perm_choose(int bi, uint32_t r) {
    const int sz = m.size[bi];
    const uint32_t id = static_cast<uint32_t>(-1 - bi);
    const int pr = static_cast<int>(r % static_cast<uint32_t>(sz));
    int pos = pr;
    for (int top = pr; top >= 0; top -= G) {
      const int k = top - lane;
      uint32_t i = 0;
      if (k >= 0 && k < sz - 1) {
        i = hash3(x, id, static_cast<uint32_t>(k)) %
            static_cast<uint32_t>(sz - k);
      }
#pragma unroll
      for (int j = 0; j < G; j++) {
        const int kk = top - j;
        const int ik = kk + static_cast<int>(__shfl_sync(mask, i, j, G));
        if (kk >= 0) {
          if (pos == kk) {
            pos = ik;
          } else if (pos == ik) {
            pos = kk;
          }
        }
      }
    }
    draws[kAlgUniform - 1] += pr < sz - 1 ? pr + 1 : sz - 1;
    return m.items[static_cast<size_t>(bi) * S + pos];
  }

  // crush_bucket_choose (mapper.c:365-396); ``position`` picks the
  // choose_args weight set.
  __device__ int32_t bucket_choose(int bi, uint32_t r, int position) {
    const size_t row = static_cast<size_t>(bi) * S;
    if constexpr (!kGeneral) {
      return straw2_choose(bi, r, m.items + row, m.magic + row);
    } else {
      switch (m.alg[bi]) {
        case kAlgUniform:
          return perm_choose(bi, r);
        case kAlgList:
          return list_choose(bi, r);
        case kAlgTree:
          return tree_choose(bi, r);
        case kAlgStraw:
          return straw_choose(bi, r);
        case kAlgStraw2:
          if (has_args) {
            const int pos = position < P - 1 ? position : P - 1;
            return straw2_choose(
                bi, r, m.arg_ids + row,
                m.magic + (static_cast<size_t>(bi) * P + pos) * S);
          }
          return straw2_choose(bi, r, m.items + row, m.magic + row);
        default:
          return m.items[row];
      }
    }
  }

  // is_out (mapper.c:402-416)
  __device__ bool is_out(int32_t item) const {
    if (item >= weight_len) return true;
    const uint32_t w = weight[item];
    if (w >= 0x10000) return false;
    if (w == 0) return true;
    return (hash2(x, static_cast<uint32_t>(item)) & 0xFFFF) >= w;
  }

  // crush_choose_firstn (mapper.c:438-626).  A failed draw retries in
  // the same bucket while local retries or the perm fallback allow
  // (flocal counts them; a descent does not reset it), else descends
  // again from the top with flocal = 0.  The straw2-only walk has
  // neither (local = fallback = 0).
  template <bool kLeaf>
  __device__ int choose_firstn(int bucket_bi, int numrep, int type,
                               int32_t* out, int outpos, int out_size,
                               int tries, int recurse_tries, int local,
                               int fallback, int vary_r, int stable,
                               int32_t* out2, int parent_r) {
    int count = out_size;
    for (int rep = stable ? 0 : outpos; rep < numrep && count > 0; rep++) {
      int ftotal = 0, flocal = 0;
      bool skip_rep = false;
      int32_t item = 0;
      int in_bi = bucket_bi;
      for (;;) {  // one draw per pass: descend, retry or finish
        bool collide = false, reject = false;
        const uint32_t r = rep + parent_r + ftotal;
        if (m.size[in_bi] == 0) {
          reject = true;
        } else {
          if (kGeneral && fallback > 0 && flocal >= (m.size[in_bi] >> 1) &&
              flocal > fallback) {
            item = perm_choose(in_bi, r);
          } else {
            item = bucket_choose(in_bi, r, outpos);
          }
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
                    count, recurse_tries, 0, local, fallback, vary_r, stable,
                    nullptr, sub_r);
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
        if constexpr (kGeneral) {
          flocal++;
          if ((collide && flocal <= local) ||
              (fallback > 0 && flocal <= m.size[in_bi] + fallback)) {
            continue;  // retry in the same bucket
          }
        }
        if (ftotal < tries) {
          in_bi = bucket_bi;  // retry the descent from the top
          flocal = 0;
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

  // crush_choose_indep (mapper.c:633-821).  The choose_args position is
  // this call's outpos (mapper.c:701), not the slot.
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
          uint32_t r = rep + parent_r + numrep * ftotal;
          // a uniform bucket whose size numrep divides steps r by
          // numrep + 1 a round (mapper.c:680-685)
          if (kGeneral && m.alg[in_bi] == kAlgUniform &&
              m.size[in_bi] % numrep == 0) {
            r += ftotal;
          }
          if (m.size[in_bi] == 0) break;
          const int32_t item = bucket_choose(in_bi, r, outpos);
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
    int local = kGeneral ? p.local_tries : 0;
    int fallback = kGeneral ? p.local_fallback_tries : 0;
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
        case kOpSetChooseLocalTries:
          if (kGeneral && arg1 >= 0) local = arg1;
          break;
        case kOpSetChooseLocalFallbackTries:
          if (kGeneral && arg1 >= 0) fallback = arg1;
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
                osize += choose_firstn<true>(
                    bi, numrep, arg2, o + osize, 0, R - osize, choose_tries,
                    recurse_tries, local, fallback, vary_r, stable,
                    c + osize, 0);
              } else {
                osize += choose_firstn<false>(
                    bi, numrep, arg2, o + osize, 0, R - osize, choose_tries,
                    recurse_tries, local, fallback, vary_r, stable, nullptr,
                    0);
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
        default:  // noop
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

template <int G, bool kGeneral>
__global__ void __launch_bounds__(kThreads)
crush_rule_kernel(const RuleParams p, const MapPtrs m,
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
  Walk<G, kGeneral> wk{m,      weight,       s_tabs + 0, s_tabs + kRhLhLen,
                       p.B,    p.S,          p.N,        p.P,
                       p.max_devices, p.weight_len, p.has_args != 0,
                       xs[i],  lane,         mask,       {0, 0, 0, 0, 0}};
  int32_t* work = s_work + g * 4 * R;
  const int len = wk.do_rule(p, work);
  int32_t* row = results + static_cast<size_t>(i) * R;
  for (int j = lane; j < R; j += G) {
    row[j] = j < len ? work[3 * R + j] : kItemNone;
  }
  if (lane == 0) {
    lens[i] = len;
    if (draws != nullptr) {
      for (int a = 0; a < kNumAlgs; a++) {
        draws[static_cast<size_t>(i) * kNumAlgs + a] = wk.draws[a];
      }
    }
  }
}

}  // namespace

extern "C" {

// Map xs[0..nx) through the rule in *params over the SoA map in *map
// (int32 rows; u32 fields as bit patterns; magic u64 from
// ln.py:straw2_magic).  results i32[nx, result_max] padded with
// CRUSH_ITEM_NONE, lens i32[nx]; draws (nullable) i32[nx, 5] receives
// each x's bucket draws by algorithm (column alg - 1).  ln_tabs: RH/LH
// (258) then LL (256) as u64.  Returns the launch's cudaError_t; 0 is
// success.
int crush_rule_batched_launch(const void* params, const void* map,
                              const void* weight, const void* xs, int nx,
                              const void* ln_tabs, void* results, void* lens,
                              void* draws, void* stream) {
  const RuleParams& p = *static_cast<const RuleParams*>(params);
  const MapPtrs& m = *static_cast<const MapPtrs*>(map);
  if (p.result_max < 1 || p.result_max > kRMax || p.nsteps > kMaxSteps ||
      p.S > kMaxBucket) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int blocks = (nx + kGroupsPerBlock - 1) / kGroupsPerBlock;
  const size_t smem =
      static_cast<size_t>(kGroupsPerBlock) * 4 * p.result_max * sizeof(int32_t);
  const auto* w = static_cast<const uint32_t*>(weight);
  const auto* x = static_cast<const uint32_t*>(xs);
  const auto* tabs = static_cast<const uint64_t*>(ln_tabs);
  auto* res = static_cast<int32_t*>(results);
  auto* len = static_cast<int32_t*>(lens);
  auto* drw = static_cast<int32_t*>(draws);
  const auto s = static_cast<cudaStream_t>(stream);
  if (p.general) {
    crush_rule_kernel<kGroup, true><<<blocks, kThreads, smem, s>>>(
        p, m, w, x, nx, tabs, res, len, drw);
  } else {
    crush_rule_kernel<kGroup, false><<<blocks, kThreads, smem, s>>>(
        p, m, w, x, nx, tabs, res, len, drw);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
