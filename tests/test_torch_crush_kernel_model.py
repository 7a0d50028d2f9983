"""K2's walk (``csrc/crush_rule.cu``) built with the host compiler and run
with a group's lanes as threads, against its plain PyTorch version.

There is no ``nvcc`` here, so the kernel itself runs only on the card
(``chip_smoke.py`` phase 3).  Its device code above ``// ---- kernel and
launch`` is plain C++ once the CUDA intrinsics have host stand-ins: each
lane of a group of G is a thread, a shuffle is a store to a slot per
lane between two barriers, ``__syncwarp`` a barrier, and the work
vectors one array the threads share, as in the group's shared memory.
So the walk's logic (every bucket choose, the lane reductions, the perm
trace-back's shuffles, local retries, choose_args) is checked here
lane by lane at G = 1 and G = 4.  Tolerance zero: OSD ids.
"""

import ctypes
import json
import pathlib
import shutil
import subprocess

import numpy as np
import pytest
import torch

from conftest import GOLDEN_DIR

from ceph_tpu_torch.crush import builder as B
from ceph_tpu_torch.crush.ln import ln_tables
from ceph_tpu_torch.crush.map import CrushMap, Tunables
from ceph_tpu_torch.crush.map_arrays import encode_map, to_device
from ceph_tpu_torch.crush.mapper import (MAX_STEPS, _rule_steps,
                                         compile_rule, map_batch_plain)
from ceph_tpu_torch.tools import rule_shapes

SRC = (pathlib.Path(__file__).resolve().parent.parent
       / "ceph_tpu_torch" / "csrc" / "crush_rule.cu")

SHIM = r"""
#include <barrier>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>
#define __device__
#define __forceinline__ inline
static thread_local int t_lane;
static std::barrier<>* g_bar;
static uint64_t g_slot[32];
static inline void __syncwarp(unsigned) { g_bar->arrive_and_wait(); }
template <class T> static T exchange(T v, int src) {
  g_slot[t_lane] = static_cast<uint64_t>(v);
  g_bar->arrive_and_wait();
  const T r = static_cast<T>(g_slot[src]);
  g_bar->arrive_and_wait();
  return r;
}
static inline unsigned long long __shfl_xor_sync(unsigned, unsigned long long v,
                                                 int off, int) {
  return exchange(v, t_lane ^ off);
}
static inline int __shfl_xor_sync(unsigned, int v, int off, int) {
  return exchange(static_cast<uint32_t>(v), t_lane ^ off);
}
static inline unsigned __shfl_sync(unsigned, unsigned v, int src, int) {
  return exchange(v, src);
}
static inline int __clz(uint32_t v) { return __builtin_clz(v); }
static inline uint64_t __umul64hi(uint64_t a, uint64_t b) {
  return static_cast<uint64_t>((static_cast<unsigned __int128>(a) * b) >> 64);
}
static inline uint32_t __umulhi(uint32_t a, uint32_t b) {
  return static_cast<uint32_t>((static_cast<uint64_t>(a) * b) >> 32);
}
"""

RUNNER = r"""
}  // namespace

template <int G, bool kGen>
static void run(const RuleParams& p, const MapPtrs& m, const uint32_t* weight,
                const uint32_t* xs, int nx, const uint64_t* tabs,
                int32_t* results, int32_t* lens) {
  std::barrier<> bar(G);
  g_bar = &bar;
  std::vector<int32_t> work(4 * p.result_max);
  std::vector<std::thread> lanes;
  for (int l = 0; l < G; l++) {
    lanes.emplace_back([&, l] {
      t_lane = l;
      for (int i = 0; i < nx; i++) {
        Walk<G, kGen> wk{m, weight, tabs, tabs + kRhLhLen, p.B, p.S, p.N,
                         p.P, p.max_devices, p.weight_len, p.has_args != 0,
                         xs[i], l, 0u, {0, 0, 0, 0, 0}};
        const int len = wk.do_rule(p, work.data());
        bar.arrive_and_wait();
        if (l == 0) {
          lens[i] = len;
          for (int j = 0; j < p.result_max; j++) {
            results[i * p.result_max + j] =
                j < len ? work[3 * p.result_max + j] : kItemNone;
          }
        }
        bar.arrive_and_wait();
      }
    });
  }
  for (auto& t : lanes) t.join();
}

extern "C" int model_run(int group, const void* params, const void* map,
                         const void* weight, const void* xs, int nx,
                         const void* tabs, void* results, void* lens) {
  const auto& p = *static_cast<const RuleParams*>(params);
  const auto& m = *static_cast<const MapPtrs*>(map);
  auto* w = static_cast<const uint32_t*>(weight);
  auto* x = static_cast<const uint32_t*>(xs);
  auto* t = static_cast<const uint64_t*>(tabs);
  auto* r = static_cast<int32_t*>(results);
  auto* l = static_cast<int32_t*>(lens);
  if (group == 1) {
    p.general ? run<1, true>(p, m, w, x, nx, t, r, l)
              : run<1, false>(p, m, w, x, nx, t, r, l);
  } else if (group == 4) {
    p.general ? run<4, true>(p, m, w, x, nx, t, r, l)
              : run<4, false>(p, m, w, x, nx, t, r, l);
  } else {
    return 1;
  }
  return 0;
}
"""


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("no host C++ compiler")
    src = SRC.read_text()
    walk = src[:src.index("// ---- kernel and launch")]
    walk = walk.replace("#include <cuda_runtime.h>", "")
    out = tmp_path_factory.mktemp("k2model")
    cpp = out / "k2model.cpp"
    cpp.write_text(SHIM + walk + RUNNER)
    lib = out / "libk2model.so"
    subprocess.run(["g++", "-std=c++20", "-O1", "-shared", "-fPIC",
                    "-pthread", "-o", str(lib), str(cpp)], check=True,
                   capture_output=True, timeout=300)
    fn = ctypes.CDLL(str(lib)).model_run
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 4 + \
        [ctypes.c_int] + [ctypes.c_void_p] * 3
    fn.restype = ctypes.c_int
    return fn


def run_model(fn, group, arrays_np, prog, weight, xs):
    """The kernel's walk over ``xs`` with ``group`` lanes per x, on the
    numpy arrays of ``encode_map`` (what the wrapper hands the card)."""
    from ceph_tpu_torch.crush.mapper import _MAP_FIELDS, _MapPtrs, _Program

    keep = {name: np.ascontiguousarray(getattr(arrays_np, name))
            for name in _MAP_FIELDS}
    keep["magic"] = np.ascontiguousarray(
        arrays_np.arg_magic if prog.has_choose_args else arrays_np.magic)
    m = _MapPtrs(*[keep[name].ctypes.data
                   for name in _MAP_FIELDS + ("magic",)])
    p = _Program()
    p.nsteps = len(prog.steps)
    for i, step in enumerate(prog.steps):
        p.steps[3 * i:3 * i + 3] = step
    (p.local_tries, p.local_fallback_tries, p.total_tries, p.descend_once,
     p.vary_r, p.stable) = prog.tunables
    p.result_max, p.max_devices = prog.result_max, prog.max_devices
    p.B, p.S = arrays_np.items.shape
    p.N = arrays_np.node_weights.shape[1]
    p.P = arrays_np.arg_weights.shape[1]
    w = np.ascontiguousarray(weight, np.uint32)
    x = np.ascontiguousarray(xs, np.uint32)
    p.weight_len = w.size
    p.has_args = int(prog.has_choose_args)
    p.general = int(prog.general)
    tabs = ln_tables("cpu").numpy()
    res = np.zeros((x.size, prog.result_max), np.int32)
    lens = np.zeros(x.size, np.int32)
    assert fn(group, ctypes.byref(p), ctypes.byref(m), w.ctypes.data,
              x.ctypes.data, x.size, tabs.ctypes.data, res.ctypes.data,
              lens.ctypes.data) == 0
    return res, lens


def mixed_map(tunables=None):
    """Hosts of every algorithm (uniform where the OSDs weigh alike),
    straw and list racks, a straw2 root."""
    cmap = CrushMap(tunables)
    rng = np.random.default_rng(5)
    makers = [B.make_uniform_bucket, B.make_list_bucket, B.make_tree_bucket,
              B.make_straw_bucket, B.make_straw2_bucket]
    hosts, dev = [], 0
    for h in range(10):
        n = int(rng.integers(1, 7)) if h % 5 else 4
        osds = list(range(dev, dev + n))
        dev += n
        mk = makers[h % 5]
        if mk is B.make_uniform_bucket:
            b = mk(osds, 0x10000, 1)
        else:
            w = [int(v) for v in rng.choice([0, 0x8000, 0x10000, 0x30000],
                                            n)]
            b = mk(osds, w, 1)
        hosts.append(b)
    ids = [cmap.add_bucket(b) for b in hosts]
    racks = []
    for i, mk in enumerate((B.make_straw_bucket, B.make_list_bucket)):
        part = hosts[5 * i:5 * i + 5]
        racks.append(mk(ids[5 * i:5 * i + 5], [b.weight for b in part], 2))
    rids = [cmap.add_bucket(b) for b in racks]
    root = cmap.add_bucket(B.make_straw2_bucket(
        rids, [b.weight for b in racks], 3))
    B.add_simple_rule(cmap, root, 1, firstn=True, ruleno=0)
    B.add_simple_rule(cmap, root, 1, firstn=False, ruleno=1)
    return cmap, dev


TUNABLES = {"mixed": None, "mixed_legacy": Tunables.legacy(),
            "mixed_local": Tunables(2, 0, 19, 0, 0, 0),
            "shapes": "optimal", "shapes_legacy": "legacy",
            "shapes_local": "local"}


def load(name):
    with open(GOLDEN_DIR / f"{name}.json") as f:
        return json.load(f)


CASES = [("map_big10k", 0, 3), ("map_big10k", 1, 11), ("map_weird", 1, 4),
         ("map_list", 0, 3), ("map_straw", 1, 4), ("map_uniform", 0, 3),
         ("map_uniform", 1, 4), ("map_tree3_chooseargs", 1, 6),
         ("map_tree3_chooseargs", 2, 4), ("map_tree3_legacy", 0, 3),
         ("map_tree3_legacy", 1, 6), ("mixed", 0, 3), ("mixed", 1, 5),
         ("mixed_legacy", 0, 3), ("mixed_local", 0, 3)] + [
    (name, ruleno, numrep)
    for name in ("shapes", "shapes_legacy", "shapes_local")
    for ruleno, numrep in rule_shapes.CASES]


@pytest.mark.parametrize("group", [1, 4])
@pytest.mark.parametrize("name,ruleno,numrep", CASES)
def test_kernel_walk_matches_plain(model, group, name, ruleno, numrep):
    if name in TUNABLES:
        if name.startswith("mixed"):
            cmap, ndev = mixed_map(TUNABLES[name])
            weight = np.full(ndev, 0x10000, np.uint32)
        else:
            cmap = rule_shapes.rule_shapes_map(TUNABLES[name])
            weight = rule_shapes.weights(cmap.max_devices)
        cargs = None
    else:
        d = load(name)
        cmap = CrushMap.from_dict(d["map"])
        weight = np.asarray(d["cases"][0]["weight"], np.uint32).copy()
        cargs = cmap.choose_args.get("golden")
    rng = np.random.default_rng(group * 100 + ruleno)
    weight[rng.choice(weight.size, max(1, weight.size // 9),
                      replace=False)] = 0
    weight[rng.choice(weight.size, max(1, weight.size // 9),
                      replace=False)] = 0x8000
    xs = rng.integers(0, 2 ** 32, 96, dtype=np.uint64).astype(np.uint32)
    static, arrays = encode_map(cmap, cargs)
    prog = compile_rule(static, _rule_steps(cmap, ruleno), numrep)
    assert len(prog.steps) <= MAX_STEPS
    got = run_model(model, group, arrays, prog, weight, xs)
    want = map_batch_plain(to_device(arrays, "cpu"), prog,
                           torch.from_numpy(weight.view(np.int32)),
                           torch.from_numpy(xs.view(np.int32)))
    assert np.array_equal(got[1], want[1].numpy())
    assert np.array_equal(got[0], want[0].numpy())
