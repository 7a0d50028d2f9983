"""EC benchmark CLI: encode/decode throughput of a plugin and profile.

The port of ``ceph_tpu/tools/ec_benchmark.py``, the role of
src/test/erasure-code/ceph_erasure_code_benchmark.cc:40-330, with its
flags: --plugin, --workload encode|decode, --size, --iterations,
--parameter k=v profile entries, --erasures N and --erasures-generation
random|exhaustive (the decode sweep), --verify (decode output checked
against the object, :225-236); and --device (the card by default; cpu
runs the kernels' plain versions).  A profile with ``engine=native``
runs the native CPU engine and needs no card.

The object is copied to the device once a call (encode) or lives there
(decode), as a client's would.  Device work is asynchronous, so the
device is synchronised before the clock starts and before it stops; a
verify compares on the device and is read after the clock stops.

Output is the reference's ``elapsed \\t KiB`` line, with GB/s on
stderr.

Usage: python -m ceph_tpu_torch.tools.ec_benchmark --plugin jerasure \\
         -P k=4 -P m=2 --workload encode --size 4194304 [--device cpu]
"""

from __future__ import annotations

import argparse
import itertools
import sys
import time

import numpy as np
import torch

from ..ec.registry import factory


def exhaustive_erasures(n: int, count: int):
    return itertools.combinations(range(n), count)


def random_erasures(n: int, count: int, iterations: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    for _ in range(iterations):
        yield tuple(sorted(rng.choice(n, count, replace=False)))


def erasure_sets(n: int, count: int, generation: str, iterations: int):
    """The decode workload's erasure sets, in order."""
    if generation == "exhaustive":
        return list(exhaustive_erasures(n, count))
    return list(random_erasures(n, count, iterations))


def payload(size: int) -> bytes:
    """The benchmark's object: ``size`` bytes from seed 1."""
    return np.random.default_rng(1).integers(
        0, 256, size, dtype=np.uint8).tobytes()


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="ec_benchmark")
    p.add_argument("--plugin", default="jerasure")
    p.add_argument("-P", "--parameter", action="append", default=[],
                   help="profile key=value")
    p.add_argument("--workload", choices=["encode", "decode"],
                   default="encode")
    p.add_argument("--size", type=int, default=1 << 20,
                   help="total object bytes per iteration")
    p.add_argument("--iterations", type=int, default=8)
    p.add_argument("--erasures", type=int, default=1)
    p.add_argument("--erasures-generation",
                   choices=["random", "exhaustive"], default="random")
    p.add_argument("--verify", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="cuda (default: kernel K1) or cpu (its plain "
                        "version)")
    args = p.parse_args(argv)

    profile = {}
    for kv in args.parameter:
        k, _, v = kv.partition("=")
        profile[k] = v
    code = factory(args.plugin, profile, device=args.device)
    dev = code.device
    n = code.get_chunk_count()
    k = code.get_data_chunk_count()

    raw = payload(args.size)
    chunks = code.encode(range(n), raw)

    total_bytes = 0
    failed = []
    if args.workload == "encode":
        _sync(dev)
        t0 = time.perf_counter()
        for _ in range(args.iterations):
            code.encode(range(n), raw)
            total_bytes += args.size
        _sync(dev)
        elapsed = time.perf_counter() - t0
    else:
        gen = erasure_sets(n, args.erasures, args.erasures_generation,
                           args.iterations)
        want = [code.chunk_index(i) for i in range(k)]
        raw_dev = torch.frombuffer(bytearray(raw), dtype=torch.uint8).to(dev)
        checks = []
        _sync(dev)
        t0 = time.perf_counter()
        for erased in gen:
            avail = {i: c for i, c in chunks.items() if i not in erased}
            out = code.decode(set(want), avail)
            if args.verify:   # a flag on the device, read after the clock
                got = torch.cat([out[i] for i in want])[:len(raw)]
                checks.append((erased, (got != raw_dev).any()))
            total_bytes += args.size
        _sync(dev)
        elapsed = time.perf_counter() - t0
        failed = [e for e, bad in checks if bool(bad)]
    if failed:
        print(f"verify failed for erasures {list(failed[0])} "
              f"({len(failed)} sets)", file=sys.stderr)
        return 1

    # the reference's output shape (benchmark.cc:184,315)
    print(f"{elapsed:.6f}\t{total_bytes // 1024}")
    print(f"# {args.plugin} {args.workload}: "
          f"{total_bytes / elapsed / 1e9:.3f} GB/s", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
