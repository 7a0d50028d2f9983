"""Time K2 on ``map_big10k`` (65,536 PGs a call, rules 0 and 1) for the
port in a given source tree, so that two trees can be compared on one
card: run it once per tree, in turns, on the same machine.

    python3 ceph_tpu_torch/k2_timing.py [--tree DIR]

``DIR`` (default: this checkout) is a tree holding ``ceph_tpu_torch``
and ``tests/golden/map_big10k.json``; its kernel is built from its own
sources.  Per rule it prints one JSON line:

- ``eager_ms``: CUDA events around 8 eager calls, per call, 5 times;
- ``graph_ms``: the same 8 calls replayed from a CUDA graph 5 times,
  per call (device time without the host's gaps);
- ``enqueue_us``: host time per call over 200 calls with no sync (the
  wrapper's Python and the launch);
- ``general``: where the tree's ``RuleProgram`` has the field and the
  map needs only the straw2 instantiation, the same three for the
  general instantiation on the same map and inputs, after checking
  that both give the same output.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

PGS = 65536
CALLS = 8
REPS = 5


def card():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()


def time_prog(torch, crush_rule_batched, arrays, prog, weight):
    batches = [torch.arange(i * PGS, (i + 1) * PGS, dtype=torch.int32,
                            device="cuda") for i in range(CALLS)]
    for b in batches:
        crush_rule_batched(arrays, prog, weight, b)
    torch.cuda.synchronize()
    eager = []
    for _ in range(REPS):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for b in batches:
            crush_rule_batched(arrays, prog, weight, b)
        e.record()
        e.synchronize()
        eager.append(s.elapsed_time(e) / CALLS)
    g = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side), torch.cuda.graph(g, stream=side):
        for b in batches:
            crush_rule_batched(arrays, prog, weight, b)
    torch.cuda.current_stream().wait_stream(side)
    g.replay()
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(REPS):
        g.replay()
    e.record()
    e.synchronize()
    t0 = time.perf_counter()
    for _ in range(200):
        crush_rule_batched(arrays, prog, weight, batches[0])
    enqueue_us = (time.perf_counter() - t0) / 200 * 1e6
    torch.cuda.synchronize()
    return {"eager_ms": sorted(eager),
            "graph_ms": s.elapsed_time(e) / (REPS * CALLS),
            "enqueue_us": enqueue_us}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    tree = os.path.abspath(ap.parse_args().tree)
    sys.path.insert(0, tree)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("k2_timing: no CUDA device is available", file=sys.stderr)
        return 2
    from ceph_tpu_torch import build
    from ceph_tpu_torch.crush.map import CrushMap
    from ceph_tpu_torch.crush.map_arrays import as_i32
    from ceph_tpu_torch.crush.mapper import BatchedMapper, crush_rule_batched

    build.build(["crush_rule"])
    with open(os.path.join(tree, "tests/golden/map_big10k.json")) as f:
        d = json.load(f)
    m = BatchedMapper(CrushMap.from_dict(d["map"]), device="cuda")
    weight = as_i32(np.asarray(d["cases"][0]["weight"], np.uint32), "cuda")
    print(f"gpu: {card()}", flush=True)
    for rule, numrep in ((0, 3), (1, 11)):
        prog = m.program(rule, numrep)
        row = {"tree": tree, "rule": rule,
               **time_prog(torch, crush_rule_batched, m.arrays, prog,
                           weight)}
        if getattr(prog, "general", True) is False:
            gprog = dataclasses.replace(prog, general=True)
            xs = torch.arange(PGS, dtype=torch.int32, device="cuda")
            a = crush_rule_batched(m.arrays, prog, weight, xs)
            b = crush_rule_batched(m.arrays, gprog, weight, xs)
            if not (torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])):
                raise AssertionError("the general instantiation differs "
                                     "from the straw2-only one")
            row["general"] = time_prog(torch, crush_rule_batched, m.arrays,
                                       gprog, weight)
        print("k2_timing " + json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
