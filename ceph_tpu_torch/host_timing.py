"""Time the host side of the port's entry points that book each call
into the perf counters and the device plane, for the port in a given
source tree, so that two trees can be compared on one card: run it once
per tree, in turns, on the same machine.

    python3 ceph_tpu_torch/host_timing.py [--tree DIR]

``DIR`` (default: this checkout) is a tree holding ``ceph_tpu_torch``;
its kernels are built from its own sources.  The map is this
checkout's ``tests/golden/map_big10k.json``.  Each output is first held
to its reference (the golden rows, the data chunks back, ``--verify``).
It prints one JSON line per entry point:

- ``rs_encode``, ``rs_decode``: ``RSCode(8, 3).encode_batched`` of 4
  stripes of 8 x 1 MiB and the decode of chunks 0 and 1 of the same
  (chip_smoke phase 4's shapes);
- ``map_batch``: ``BatchedMapper.map_batch`` of ``map_big10k`` rule 0,
  numrep 3, over 65,536 PGs (phase 4's);
- ``utilization``: ``parallel.placement.utilization``, the per-OSD
  tally of the same rule's results over 1,048,576 PGs (phase 7's and
  phase 10's), with ``bound_ms``, the results and lengths read once and
  the counts written once at 3.35 TB/s;

  each with ``enqueue_us``, the host's time a call over 200 calls with
  no sync (the entry's Python, its booking and the launch), the least
  of 5 runs, and ``ms``, CUDA events around 32 calls, a call;
- ``ec_benchmark``: isa k=8 m=3 and jerasure reed_sol_van k=4 m=2 on a
  4 MiB object, ``encode`` and ``decode_1_random``, 200 calls with
  ``--verify`` (chip_smoke phase 8's runs): ``ms``, a call on the
  tool's own clock (each call ends in a sync), for each of 3 runs.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OBJECT = 4 << 20
EC_ITERS = 200
PGS = 65536
TALLY_PGS = 1 << 20
HBM_BYTES_PER_S = 3.35e12
RS_SHAPE = (4, 8, 1 << 20)
EC_RUNS = (
    ("isa", {"k": "8", "m": "3"}),
    ("jerasure", {"technique": "reed_sol_van", "k": "4", "m": "2"}),
)


def card():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()


def times(torch, fn):
    """``enqueue_us`` and ``ms`` of ``fn`` (see the module's text)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(32):
        fn()
    e.record()
    e.synchronize()
    ms = s.elapsed_time(e) / 32
    enqueue = []
    for _ in range(5):   # the least of 5: the host is shared
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            fn()
        enqueue.append((time.perf_counter() - t0) / 200 * 1e6)
    torch.cuda.synchronize()
    return {"enqueue_us": min(enqueue), "ms": ms}


def ec_benchmark_ms(ec_benchmark, plugin, profile, workload):
    """ms a call of one ``ec_benchmark --verify`` run on the card."""
    import contextlib
    import io

    args = ["--plugin", plugin, "--device", "cuda"]
    for key, v in profile.items():
        args += ["-P", f"{key}={v}"]
    args += ["--workload", "decode" if workload != "encode" else "encode",
             "--size", str(OBJECT), "--iterations", str(EC_ITERS),
             "--verify"]
    if workload != "encode":
        args += ["--erasures", "1"]
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = ec_benchmark.main(args)
    if rc != 0:
        raise AssertionError(f"ec_benchmark {plugin} {workload} exited "
                             f"{rc}: {err.getvalue()}")
    elapsed, _ = out.getvalue().strip().split("\t")
    return float(elapsed) / EC_ITERS * 1e3


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", default=REPO)
    args = ap.parse_args(argv)
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import numpy as np
    import torch

    from ceph_tpu_torch import build
    from ceph_tpu_torch.crush.map import CrushMap
    from ceph_tpu_torch.crush.mapper import BatchedMapper
    from ceph_tpu_torch.ec.rs import RSCode
    from ceph_tpu_torch.parallel.placement import utilization
    from ceph_tpu_torch.tools import ec_benchmark

    if not torch.cuda.is_available():
        raise SystemExit("host_timing needs a CUDA card")
    assert build.__file__.startswith(tree), build.__file__
    build.build(["gf2_matmul_w8", "crush_rule"])
    dev = torch.device("cuda")
    head = {"tree": tree, "card": card()}

    code = RSCode(8, 3, device=dev)
    gen = torch.Generator(device=dev).manual_seed(4)
    stripes = torch.randint(0, 256, RS_SHAPE, dtype=torch.uint8,
                            device=dev, generator=gen)
    parity = code.encode_batched(stripes)
    B, k, L = RS_SHAPE
    data = stripes.transpose(0, 1).reshape(k, B * L)
    par2d = parity.transpose(0, 1).reshape(3, B * L)
    chunks = {i: data[i] for i in range(k)}
    chunks.update({k + i: par2d[i] for i in range(3)})
    if not torch.equal(code.decode(chunks, [0, 1])[:2], data[:2]):
        raise AssertionError("RS(8,3) decode does not give the data back")
    print(json.dumps({**head, "entry": "rs_encode",
                      **times(torch, lambda: code.encode_batched(stripes))}),
          flush=True)
    print(json.dumps({**head, "entry": "rs_decode",
                      **times(torch, lambda: code.decode(chunks, [0, 1]))}),
          flush=True)

    with open(os.path.join(REPO, "tests", "golden", "map_big10k.json")) as f:
        d = json.load(f)
    cmap, case = CrushMap.from_dict(d["map"]), d["cases"][0]
    mapper = BatchedMapper(cmap, device=dev)
    weight = torch.as_tensor(np.asarray(case["weight"], np.uint32)
                             .view(np.int32), device=dev)
    xs = torch.arange(case["x0"], case["x0"] + PGS, dtype=torch.int32,
                      device=dev)
    res, lens = mapper.map_batch(case["ruleno"], xs, case["numrep"], weight)
    for i in range(64):
        if res[i, :int(lens[i])].tolist() != case["results"][i]:
            raise AssertionError(f"map_batch row {i} differs from golden")
    print(json.dumps({**head, "entry": "map_batch", "pgs": PGS, **times(
        torch, lambda: mapper.map_batch(case["ruleno"], xs, case["numrep"],
                                        weight))}), flush=True)

    xs = torch.arange(TALLY_PGS, dtype=torch.int32, device=dev)
    res, lens = mapper.map_batch(case["ruleno"], xs, case["numrep"], weight)
    D = cmap.max_devices
    counts = utilization(res, lens, D)
    if int(counts.sum()) != int(lens.sum()):
        raise AssertionError("the tally does not count every mapping")
    bound = (res.numel() * 4 + lens.numel() * 4 + D * 8) \
        / HBM_BYTES_PER_S * 1e3
    print(json.dumps({**head, "entry": "utilization", "pgs": TALLY_PGS,
                      "bound_ms": bound,
                      **times(torch, lambda: utilization(res, lens, D))}),
          flush=True)
    del xs, res, lens

    for plugin, profile in EC_RUNS:
        for workload in ("encode", "decode_1_random"):
            ms = [ec_benchmark_ms(ec_benchmark, plugin, profile, workload)
                  for _ in range(3)]
            print(json.dumps({**head, "entry": "ec_benchmark",
                              "plugin": plugin, "profile": profile,
                              "workload": workload, "ms": ms}), flush=True)


if __name__ == "__main__":
    main()
