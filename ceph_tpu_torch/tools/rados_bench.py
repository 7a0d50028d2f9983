"""rados bench — the cluster throughput/latency harness.

The port of ``ceph_tpu/tools/rados_bench.py``.  The role of `rados
bench` (src/tools/rados/rados.cc:107) and its engine ObjBencher
(src/common/obj_bencher.cc): drive a cluster with N
concurrent writers/readers for a fixed duration and report throughput,
IOPS, and latency percentiles.  Works against any mon address
(a running cluster) or self-hosts a MiniCluster for one-shot runs.

The cluster's daemons and clients run their EC codes on ``device``
(``--device``, default ``cuda``; without a card the tool fails unless
``--device cpu`` is given): kernel K1 for the EC pool's jerasure
reed_sol_van code, or the host C engine where the pool's profile says
``engine=native``.

CLI:
    python -m ceph_tpu_torch.tools.rados_bench write --seconds 5 \
        --concurrent 8 --object-size 65536 [--ec] [--device cpu]
    ... seq | rand                     (read back what write created)

Output: one human summary on stderr and ONE JSON line on stdout —
the same one-line contract bench.py uses.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import threading
import time
from typing import Dict, List, Optional

from ..analysis.lockdep import make_lock


class BenchResult:
    def __init__(self, op: str, object_size: int):
        self.op = op
        self.object_size = object_size
        self.latencies: List[float] = []
        self.errors = 0
        self.wall = 0.0
        self._lock = make_lock("bench::result")

    def add(self, dt: float) -> None:
        with self._lock:
            self.latencies.append(dt)

    def add_error(self) -> None:
        with self._lock:
            self.errors += 1

    def summary(self) -> Dict:
        lat = sorted(self.latencies)
        n = len(lat)
        if n == 0:
            return {"op": self.op, "ops": 0, "errors": self.errors}
        total_bytes = n * self.object_size
        return {
            "op": self.op,
            "ops": n,
            "errors": self.errors,
            "seconds": round(self.wall, 3),
            "iops": round(n / self.wall, 1) if self.wall else None,
            "mb_per_sec": round(total_bytes / self.wall / 1e6, 2)
            if self.wall else None,
            "object_size": self.object_size,
            "lat_avg_ms": round(1e3 * sum(lat) / n, 3),
            "lat_min_ms": round(1e3 * lat[0], 3),
            "lat_p50_ms": round(1e3 * lat[n // 2], 3),
            "lat_p99_ms": round(1e3 * lat[min(n - 1,
                                              (99 * n) // 100)], 3),
            "lat_max_ms": round(1e3 * lat[-1], 3),
            "lat_stddev_ms": round(
                1e3 * statistics.pstdev(lat), 3) if n > 1 else 0.0,
        }


class ObjBencher:
    """N concurrent workers against one pool through one client map
    (each worker owns its own messenger-level concurrency through the
    shared client; placements are computed client-side per op)."""

    def __init__(self, client, pool_id: int,
                 object_size: int = 1 << 16, concurrent: int = 8,
                 prefix: Optional[str] = None):
        self.client = client
        self.pool_id = pool_id
        self.object_size = object_size
        self.concurrent = concurrent
        self.prefix = prefix or f"benchmark_data_{time.time_ns()}"
        self.written = 0

    def _run(self, op: str, seconds: float, fn) -> BenchResult:
        res = BenchResult(op, self.object_size)
        stop = time.monotonic() + seconds
        counter = [0]
        clock = make_lock("bench::counter")

        def worker(wid: int):
            while time.monotonic() < stop:
                with clock:
                    i = counter[0]
                    counter[0] += 1
                t0 = time.perf_counter()
                try:
                    fn(i)
                except Exception:
                    res.add_error()
                    continue
                res.add(time.perf_counter() - t0)

        t0 = time.monotonic()
        ths = [threading.Thread(target=worker, args=(w,))
               for w in range(self.concurrent)]
        for t in ths:
            t.start()
        for t in ths:
            t.join()
        res.wall = time.monotonic() - t0
        return res

    def write(self, seconds: float) -> BenchResult:
        blob = bytes(
            (i * 131 + 17) & 0xFF for i in range(self.object_size))

        def one(i: int) -> None:
            self.client.put(self.pool_id, f"{self.prefix}_{i}", blob)

        res = self._run("write", seconds, one)
        self.written = res.summary().get("ops", 0) + res.errors
        return res

    def write_aio(self, seconds: float) -> BenchResult:
        """Pipelined write phase: ONE submitter drives ``aio_put``,
        paced by the client's bounded in-flight window (the rados
        bench -t queue-depth semantics) so the OSD queues stay full
        instead of ping-ponging per-thread synchronous ops.  Latency
        samples are per-op submit→complete, recorded at completion."""
        blob = bytes(
            (i * 131 + 17) & 0xFF for i in range(self.object_size))
        res = BenchResult("write", self.object_size)
        stop = time.monotonic() + seconds
        i = 0
        t0 = time.monotonic()
        while time.monotonic() < stop:
            t_op = time.perf_counter()

            def done(c, t=t_op):
                if c.error is not None:
                    res.add_error()
                else:
                    res.add(time.perf_counter() - t)

            # blocks while the window is full — the submit loop runs
            # exactly at the client's queue depth
            self.client.aio_put(self.pool_id, f"{self.prefix}_{i}",
                                blob, on_complete=done)
            i += 1
        try:
            self.client.flush(timeout=60)
        except Exception:
            pass  # per-op errors were already counted by callbacks
        res.wall = time.monotonic() - t0
        self.written = i
        return res

    def seq(self, seconds: float) -> BenchResult:
        limit = max(1, self.written)

        def one(i: int) -> None:
            self.client.get(self.pool_id,
                            f"{self.prefix}_{i % limit}",
                            notfound_retries=0)

        return self._run("seq", seconds, one)

    def rand(self, seconds: float) -> BenchResult:
        import random

        limit = max(1, self.written)
        rng = random.Random(42)

        def one(i: int) -> None:
            self.client.get(
                self.pool_id,
                f"{self.prefix}_{rng.randrange(limit)}",
                notfound_retries=0)

        return self._run("rand", seconds, one)


def bench_minicluster(op: str = "write", seconds: float = 5.0,
                      concurrent: int = 8, object_size: int = 1 << 16,
                      n_osds: int = 4, ec: bool = False,
                      pg_num: int = 16, qd: Optional[int] = None,
                      qd_sweep: Optional[List[int]] = None,
                      ec_engine: str = "", device="cuda") -> Dict:
    """One-shot: boot a MiniCluster, run write (then optionally a read
    phase), return the summary dict.

    ``qd``: drive the write phase through the pipelined aio path at
    that queue depth instead of ``concurrent`` synchronous threads.
    ``qd_sweep``: run one aio write phase per depth and report the
    best (plus the whole sweep under ``qd_sweep``) — the knee of that
    curve is the cluster's write pipeline capacity.

    ``ec_engine``: EC engine profile key for the EC pool(s) —
    '', 'native', 'bitplane' or 'pallas-fused' ('', 'bitplane' and
    'pallas-fused' are kernel K1 on ``device``, 'native' the host C
    engine); the resolved choice (``ec/native_gf.engine_choice``) is
    recorded in the copy block as ``engine``.  ``device``: where the
    cluster's daemons and clients run their EC codes."""
    from ..common.config import Config
    from ..services.cluster import MiniCluster

    conf = Config()
    conf.set("osd_heartbeat_interval", 0.5)
    conf.set("osd_heartbeat_grace", 5.0)
    # the bench measures the data path, not the telemetry plane:
    # full-rate span recording is real per-op CPU on a saturated host
    # (the trace_sample_rate knob exists for exactly this call)
    conf.set("trace_sample_rate", 0.0)
    cluster = MiniCluster(n_osds=n_osds, config=conf,
                          device=device).start()
    t_boot = time.monotonic()
    try:
        if ec:
            prof = {"plugin": "jerasure",
                    "technique": "reed_sol_van",
                    "k": "2", "m": "1", "w": "8"}
            if ec_engine:
                prof["engine"] = ec_engine
            cluster.create_ec_pool(1, "bench21", prof, pg_num=pg_num)
        else:
            cluster.create_replicated_pool(
                1, pg_num=pg_num, size=min(3, n_osds))
        out: Dict = {}
        if qd_sweep:
            sweep: Dict[str, Dict] = {}
            best = None
            b = None
            for depth in qd_sweep:
                conf.set("client_aio_window", depth)
                cli = cluster.client(f"bench-qd{depth}")
                bench = ObjBencher(cli, 1, object_size=object_size,
                                   concurrent=concurrent)
                s = bench.write_aio(seconds).summary()
                s["qd"] = depth
                sweep[str(depth)] = s
                if best is None or (s.get("iops") or 0) > \
                        (best.get("iops") or 0):
                    best, b = s, bench
            out["write"] = best
            out["qd_sweep"] = {d: s.get("iops")
                               for d, s in sweep.items()}
        elif qd:
            conf.set("client_aio_window", qd)
            cli = cluster.client("bench")
            b = ObjBencher(cli, 1, object_size=object_size,
                           concurrent=concurrent)
            s = b.write_aio(seconds).summary()
            s["qd"] = qd
            out["write"] = s
        else:
            cli = cluster.client("bench")
            b = ObjBencher(cli, 1, object_size=object_size,
                           concurrent=concurrent)
            out["write"] = b.write(seconds).summary()
        if op in ("seq", "rand"):
            out[op] = getattr(b, op)(seconds).summary()

        # -- the profiling plane ----------------------------------------
        # attribution burst: a short fully-traced write burst (root
        # sampling is decided by the CLIENT's tracer, so a client
        # created after the rate flip records complete cross-daemon
        # trees even though the daemons booted at rate 0), folded
        # into the per-stage critical-path breakdown
        from . import telemetry as _tel
        from ..common import attribution as _attr

        conf.set("trace_sample_rate", 1.0)
        attr_cli = cluster.client("bench-attr")
        attr_bench = ObjBencher(attr_cli, 1,
                                object_size=object_size,
                                concurrent=2)
        attr_bench.write(min(1.0, seconds))
        conf.set("trace_sample_rate", 0.0)

        # EC write burst: the copy ledger's ec_assembly site books
        # only on the EC write lane, so a replicated-only bench run
        # would report 0 there forever.  Always push a short burst
        # through an EC pool before the ledger snapshot so every site
        # carries real traffic.
        ec_pool = 1
        if not ec:
            ec_pool = 2
            prof = {"plugin": "jerasure",
                    "technique": "reed_sol_van",
                    "k": "2", "m": "1", "w": "8"}
            if ec_engine:
                prof["engine"] = ec_engine
            cluster.create_ec_pool(ec_pool, "benchec", prof,
                                   pg_num=8)
        ec_cli = cluster.client("bench-ec")
        ObjBencher(ec_cli, ec_pool, object_size=object_size,
                   concurrent=2).write(min(1.0, seconds))

        snap = _tel.cluster_snapshot(cluster.asok_dir)
        folds = _attr.fold_spans(_tel.gather_spans(snap))
        agg = _attr.StageAggregator()
        for f in folds:
            agg.add(f)
        rep = agg.report()
        grand = sum(r["total_s"] for r in rep["stages"].values())
        out["attribution"] = {
            "n_ops": rep["n_ops"],
            "client_p50_ms": rep["total"]["p50_ms"],
            "unattr_pct": round(
                100.0 * rep["stages"]["unattributed"]["total_s"]
                / grand, 3) if grand > 0 else 0.0,
            "shares": {s: r["share"]
                       for s, r in rep["stages"].items()},
        }

        # byte-copy ledger: cluster-wide obs.copy totals normalized
        # per op
        copy_tot: Dict[str, float] = {}
        op_tot = 0.0
        for _d, data in snap.get("daemons", {}).items():
            perf = data.get("perf") or {}
            for logger, counters in perf.items():
                if not isinstance(counters, dict):
                    continue
                if logger == "obs.copy":
                    for k, v in counters.items():
                        if isinstance(v, (int, float)):
                            copy_tot[k] = copy_tot.get(k, 0) + v
                elif logger.startswith(("osd.", "client.")):
                    for k in ("ops_w", "ops_r", "ops_put",
                              "ops_get", "ops_write"):
                        v = counters.get(k)
                        if isinstance(v, (int, float)):
                            op_tot += v
        out["copy"] = {
            "bytes_copied": int(copy_tot.get("bytes_copied", 0)),
            "copies": int(copy_tot.get("copies", 0)),
            "bytes_per_op": round(
                copy_tot.get("bytes_copied", 0) / op_tot, 1)
            if op_tot > 0 else 0.0,
            "sites": {site: int(copy_tot.get(f"{site}_bytes", 0))
                      for site in ("recv", "send", "store_txn",
                                   "ec_assembly",
                                   "recovery_push")},
        }
        from ..ec.native_gf import engine_choice
        out["copy"]["engine"] = engine_choice(ec_engine)

        # profiler overhead: the same short write burst with the
        # wallclock sampler off vs on at profiler_hz (100 Hz default)
        # (its gate is 5%).  The MiniCluster is a single
        # process and sys._current_frames() is process-wide, so ONE
        # in-process sampler already observes every daemon's threads;
        # starting all N would do N× redundant GIL-bound stack walks
        # and measure the meter instead of the workload.
        # Overhead is measured counterbalanced (off, on, on, off):
        # every burst writes fresh objects, so the cluster gets
        # monotonically heavier across bursts — a naive off-then-on
        # order charges that drift to the profiler.  The ABBA order
        # gives both arms the same mean position, so linear drift
        # cancels exactly.
        prof_s = min(1.0, seconds)
        burst = max(0.25, prof_s / 2.0)
        prof_cli = cluster.client("bench-prof")

        def _burst() -> float:
            return ObjBencher(
                prof_cli, 1, object_size=object_size,
                concurrent=2).write(burst).summary().get("iops") \
                or 0.0

        targets = _tel.discover(cluster.asok_dir)
        pick = next((n for n in sorted(targets)
                     if n.startswith("osd.")),
                    min(targets, default=None))
        one = {pick: targets[pick]} if pick else {}
        off_a = _burst()
        _tel.gather_profiles(paths=one, cmd="start")
        on_a = _burst()
        on_b = _burst()
        dumps = _tel.gather_profiles(paths=one, cmd="stop")
        off_b = _burst()
        final = _tel.gather_profiles(paths=one, cmd="dump")
        samples = sum(d.get("samples", 0) for d in final.values())
        self_s = sum(d.get("self_s", 0.0) for d in final.values())
        elapsed = max((d.get("elapsed", 0.0)
                       for d in final.values()), default=0.0)
        iops_off = (off_a + off_b) / 2.0
        iops_on = (on_a + on_b) / 2.0
        # overhead_pct is the sampler's measured SELF time as a share
        # of the sampled window — the direct meter.  In this single-
        # process GIL-bound cluster every microsecond the sampler
        # holds the GIL is a microsecond stolen from the workload, so
        # self-share IS the expected throughput tax; the ABBA iops
        # pair above corroborates it but carries burst-to-burst noise
        # an order of magnitude above the effect.
        out["profiler"] = {
            "hz": conf["profiler_hz"],
            "daemons": len(dumps),
            "samples": samples,
            "self_s": round(self_s, 4),
            "iops_off": iops_off,
            "iops_on": iops_on,
            "iops_delta_pct": round(
                100.0 * (iops_off - iops_on) / iops_off, 2)
            if iops_off > 0 else 0.0,
            "overhead_pct": round(
                100.0 * self_s / elapsed, 2)
            if elapsed > 0 else 0.0,
        }

        # saturation plane: fold the run's cumulative msgr
        # books into the cluster net summary — send-stall share,
        # dispatch p99 and the worst heartbeat peers.  A fresh
        # snapshot here (not ``snap``) covers the profiler bursts
        # too; with no prev snapshot net_summary treats the books as
        # one whole-run delta over dt.
        net_snap = _tel.cluster_snapshot(cluster.asok_dir)
        out["net"] = _tel.net_summary(
            net_snap, dt=time.monotonic() - t_boot)

        out["pool"] = "ec(2,1)" if ec else "replicated(size=" + \
            str(min(3, n_osds)) + ")"
        out["n_osds"] = n_osds
        return out
    finally:
        cluster.shutdown()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="rados_bench")
    ap.add_argument("op", choices=["write", "seq", "rand"])
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--concurrent", type=int, default=8)
    ap.add_argument("--object-size", type=int, default=1 << 16)
    ap.add_argument("--osds", type=int, default=4)
    ap.add_argument("--pg-num", type=int, default=16)
    ap.add_argument("--ec", action="store_true",
                    help="bench an EC(2,1) pool instead of replicated")
    ap.add_argument("--qd", type=int, default=None,
                    help="drive writes through the pipelined aio "
                         "path at this queue depth")
    ap.add_argument("--qd-sweep", type=str, default=None,
                    help="comma-separated queue depths to sweep "
                         "(e.g. 8,16,32); reports the best")
    ap.add_argument("--device", default="cuda",
                    help="where the cluster runs its EC codes")
    args = ap.parse_args(argv)

    sweep = [int(x) for x in args.qd_sweep.split(",")] \
        if args.qd_sweep else None
    out = bench_minicluster(
        op=args.op, seconds=args.seconds, concurrent=args.concurrent,
        object_size=args.object_size, n_osds=args.osds, ec=args.ec,
        pg_num=args.pg_num, qd=args.qd, qd_sweep=sweep,
        device=args.device)
    for phase, s in out.items():
        if isinstance(s, dict):
            print(f"# {phase}: {s.get('iops')} IOPS, "
                  f"{s.get('mb_per_sec')} MB/s, avg "
                  f"{s.get('lat_avg_ms')} ms, p99 "
                  f"{s.get('lat_p99_ms')} ms", file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
