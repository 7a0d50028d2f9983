"""Time K3, the packet-layout kernel, for the port in a given source
tree, so that two trees can be compared on one card: run it once per
tree, in turns, on the same machine.

    python3 ceph_tpu_torch/k3_timing.py [--tree DIR] [--trace]

``DIR`` (default: this checkout) is a tree holding ``ceph_tpu_torch``;
its kernel is built from its own sources (ptxas' report printed).  The
shapes are chip_smoke phase 9's: jerasure cauchy_good k=4 m=3 w=8 at a
4 MiB object's chunks, packet sizes 8 and 2048: encode [4, 1 MiB] ->
[3, 1 MiB]; the decode of the first two chunks through the inverse, the
survivors as separate rows; and 4 stripes [4, 4, 1 MiB] at packet size
8.  Each is first held to the plain version.  Then chip_smoke phase
9's plugin profiles on K3 (jerasure's five packet techniques at
packetsize 8, an LRC layer and Clay 4+2 on cauchy_good): one encode and
one decode losing chunk 0 of a 4 MiB object, their K3 launches recorded
and replayed in a CUDA graph (``replay_ms``: device ms a call).  Per
shape it prints one JSON line:

- ``eager_ms``: CUDA events around 32 eager calls cycling 16 input sets
  (64 MiB, more than L2), per call;
- ``graph_ms``: the 16 calls replayed from a CUDA graph 5 times, per
  call (device time without the host's gaps);
- ``enqueue_us``: host time per call over 200 calls with no sync (the
  wrapper's Python and the launch), the least of 5 runs;
- ``bound_ms``: the bytes the call must move (inputs read once, outputs
  written once, the matrix's form read once) at 3.35 TB/s.

``--trace`` (a tree whose ``csrc/gf2_packet.cu`` has the phase marks)
builds a second copy of the kernel with ``-DGF2P_TRACE`` and, for the
encode at packet sizes 8 and 2048, prints when the grid's blocks reach
each phase (``trace_us``: [least, median, most] microseconds from the
first block's start): their first tiles' loads issued, the lists kept,
the first tile landed and XORed, the end.  The marks synchronise the
block, so that copy runs a little slower than the kernel.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12
SETS = 16
OBJECT = 4 << 20


def card():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()


def times(torch, fn, n_sets):
    for i in range(2):
        fn(i)
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    for i in range(32):
        fn(i % n_sets)
    e.record()
    e.synchronize()
    eager = s.elapsed_time(e) / 32
    g = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side), torch.cuda.graph(g, stream=side):
        for i in range(n_sets):
            fn(i)
    torch.cuda.current_stream().wait_stream(side)
    g.replay()
    torch.cuda.synchronize()
    s.record()
    for _ in range(5):
        g.replay()
    e.record()
    e.synchronize()
    graph = s.elapsed_time(e) / (5 * n_sets)
    enqueue = []
    for _ in range(5):   # the least of 5: the host is shared
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(200):
            fn(i % n_sets)
        enqueue.append((time.perf_counter() - t0) / 200 * 1e6)
    torch.cuda.synchronize()
    return {"eager_ms": eager, "graph_ms": graph,
            "enqueue_us": min(enqueue)}


# chip_smoke phase 9's profiles that run on K3
PLUGINS = (
    ("jerasure", {"technique": "cauchy_orig", "k": "2", "m": "2", "w": "4",
                  "packetsize": "8"}),
    ("jerasure", {"technique": "cauchy_orig", "k": "4", "m": "3", "w": "8",
                  "packetsize": "8"}),
    ("jerasure", {"technique": "cauchy_good", "k": "4", "m": "3", "w": "8",
                  "packetsize": "8"}),
    ("jerasure", {"technique": "liberation", "k": "2", "m": "2", "w": "7",
                  "packetsize": "8"}),
    ("jerasure", {"technique": "blaum_roth", "k": "2", "m": "2", "w": "6",
                  "packetsize": "8"}),
    ("jerasure", {"technique": "liber8tion", "k": "2", "m": "2", "w": "8",
                  "packetsize": "8"}),
    ("lrc", {"mapping": "DD_", "layers": json.dumps(
        [["DDc", "technique=cauchy_good packetsize=8"]])}),
    ("clay", {"k": "4", "m": "2", "technique": "cauchy_good"}),
)


def replays(torch, g, dev, name):
    """Each of PLUGINS' encode and decode (chunk 0 lost) of a 4 MiB
    object: its K3 launches, recorded through the module attribute the
    EC engine calls, replayed in a CUDA graph."""
    from ceph_tpu_torch.ec.registry import factory
    from ceph_tpu_torch.tools.ec_benchmark import payload

    raw = payload(OBJECT)
    real = g.gf2_packet
    for plugin, profile in PLUGINS:
        code = factory(plugin, profile, device=dev)
        n = code.get_chunk_count()
        chunks = code.encode(range(n), raw)
        want = {code.chunk_index(i)
                for i in range(code.get_data_chunk_count())}
        for label in ("encode", "decode"):
            calls = []

            def tap(*args):
                calls.append(args)
                return real(*args)

            tap.launches = 0   # the wrapper counts through the module name
            g.gf2_packet = tap
            try:
                if label == "decode":
                    code.decode(want, {i: c for i, c in chunks.items()
                                       if i != 0})
                else:
                    code.encode(range(n), raw)
            finally:
                g.gf2_packet = real

            def replay(i):
                for call in calls:
                    real(*call)

            rec = times(torch, replay, 1)
            print(json.dumps({
                "card": name, "plugin": plugin,
                "profile": " ".join(f"{k}={v}" for k, v in profile.items()
                                    if k != "layers"),
                "workload": label, "launches": len(calls),
                "replay_ms": rec["graph_ms"]}), flush=True)


TRACE_MARKS = ("issued", "lists", "landed", "xored", "end")


def trace(torch, g, build, dev, name, tree):
    """The encode's phase marks from a -DGF2P_TRACE copy of the kernel."""
    import ctypes

    import numpy as np

    from ceph_tpu_torch.ec.registry import factory

    src = os.path.join(tree, "ceph_tpu_torch", "csrc", "gf2_packet.cu")
    if "GF2P_TRACE" not in open(src).read():
        return
    lib_path = os.path.join(str(build.BUILD_DIR), "libgf2_packet_trace.so")
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-DGF2P_TRACE", "-o",
                    lib_path, src], check=True)
    lib = ctypes.CDLL(lib_path)
    launch = lib.gf2_packet_launch
    launch.argtypes = g._lib().gf2_packet_launch.argtypes
    launch.restype = ctypes.c_int
    marks = np.zeros((1024, 6), np.uint64)
    gen = torch.Generator(device=dev).manual_seed(9)
    for ps in (8, 2048):
        profile = {"technique": "cauchy_good", "k": "4", "m": "3", "w": "8",
                   "packetsize": str(ps)}
        bc = factory("jerasure", profile, device=dev)._code
        k, m, w = bc.k, bc.m, bc.layout.w
        L = factory("jerasure", profile, device="cpu").get_chunk_size(OBJECT)
        bm, lists = bc._enc_dev, bc._enc_frag
        npad = lists.numel() - 2 * w * m
        data = torch.randint(0, 256, (k, L), dtype=torch.uint8, device=dev,
                             generator=gen)
        out = torch.empty(m, L, dtype=torch.uint8, device=dev)
        for _ in range(3):   # the last launch's marks stay
            rc = launch(lists.data_ptr(), npad, None, data.data_ptr(), k * L,
                        out.data_ptr(), 1, k, m, w, ps, L,
                        torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                raise RuntimeError(f"traced K3 launch failed: {rc}")
        torch.cuda.synchronize()
        if not torch.equal(out, g.gf2_packet_plain(bm, data, w, ps)):
            raise AssertionError("traced K3 differs from plain")
        lib.gf2_packet_trace(marks.ctypes.data_as(
            ctypes.POINTER(ctypes.c_ulonglong)))
        grid = g.plan(ps, w, k, m, npad, L, 1,
                      data.data_ptr() | k * L)["grid"]
        t = marks[:min(grid, 1024)].astype(np.int64)
        rel = (t - t[:, 0].min()) / 1e3
        print(json.dumps({"card": name, "shape": "encode trace",
                          "packetsize": ps, "blocks": int(len(t)),
                          "trace_us": {
                              mark: [round(float(np.percentile(
                                  rel[:, j + 1], q)), 3)
                                  for q in (0, 50, 100)]
                              for j, mark in enumerate(TRACE_MARKS)}}),
              flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", default=os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--trace", action="store_true",
                    help="also the encode's phase marks (a traced build)")
    args = ap.parse_args(argv)
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import torch

    from ceph_tpu_torch import build
    from ceph_tpu_torch.ec import gf2_packet as g
    from ceph_tpu_torch.ec.registry import factory

    if not torch.cuda.is_available():
        raise SystemExit("k3_timing needs a CUDA card")
    assert g.__file__.startswith(tree), g.__file__
    build.build(["gf2_packet"], verbose=True)
    dev = torch.device("cuda")
    name = card()
    gen = torch.Generator(device=dev).manual_seed(9)
    for ps in (8, 2048):
        profile = {"technique": "cauchy_good", "k": "4", "m": "3", "w": "8",
                   "packetsize": str(ps)}
        bc = factory("jerasure", profile, device=dev)._code
        k, m, w = bc.k, bc.m, bc.layout.w
        L = factory("jerasure", profile, device="cpu").get_chunk_size(OBJECT)
        bm, aux = bc._enc_dev, bc._enc_frag
        aux_bytes = 4 * aux.numel()
        shapes = [("encode", 1)] + ([("batch", 4)] if ps == 8 else [])
        for label, B in reversed(shapes):   # the encode's sets stay
            lead = (B,) if B > 1 else ()
            sets = [torch.randint(0, 256, (*lead, k, L), dtype=torch.uint8,
                                  device=dev, generator=gen)
                    for _ in range(SETS // B)]
            for d in sets[:2]:
                if not torch.equal(g.gf2_packet(bm, d, w, ps, aux),
                                   g.gf2_packet_plain(bm, d, w, ps)):
                    raise AssertionError(f"K3 differs from plain: {label} "
                                         f"packetsize {ps}")
            rec = times(torch, lambda i: g.gf2_packet(bm, sets[i], w, ps,
                                                      aux), len(sets))
            rec["bound_ms"] = (B * (k + m) * L + aux_bytes) \
                / HBM_BYTES_PER_S * 1e3
            print(json.dumps({"tree": tree, "card": name, "shape": label,
                              "packetsize": ps, "B": B, "k": k, "m": m,
                              "L": L, **rec}), flush=True)
        full = torch.cat([sets[0], g.gf2_packet(bm, sets[0], w, ps, aux)])
        inv, iaux = bc._decode_mats(tuple(range(2, k + 2)))
        rows = [[full[i].clone() for i in range(2, k + 2)]
                for _ in range(SETS)]
        got = g.gf2_packet(inv, rows[0], w, ps, iaux)
        if not torch.equal(got, sets[0]) or not torch.equal(
                got, g.gf2_packet_plain(inv, torch.stack(rows[0]), w, ps)):
            raise AssertionError(f"K3 decode differs: packetsize {ps}")
        rec = times(torch, lambda i: g.gf2_packet(inv, rows[i], w, ps, iaux),
                    SETS)
        rec["bound_ms"] = (2 * k * L + 4 * iaux.numel()) \
            / HBM_BYTES_PER_S * 1e3
        print(json.dumps({"tree": tree, "card": name, "shape": "decode",
                          "packetsize": ps, "B": 1, "k": k, "m": k, "L": L,
                          **rec}), flush=True)
        del sets, full, rows
        torch.cuda.empty_cache()
    replays(torch, g, dev, name)
    if args.trace:
        trace(torch, g, build, dev, name, tree)


if __name__ == "__main__":
    main()
