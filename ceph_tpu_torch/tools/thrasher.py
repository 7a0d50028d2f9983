"""thrasher — seeded chaos soak and failure drills over the port's
MiniCluster.

The port of ``tools/thrasher.py``: the same drills, the same defaults,
gates and records, on the port's daemons.  Every cluster a drill boots
runs its EC codes and its balancer on ``device`` (``--device``, default
``cuda``; without a card a drill fails unless ``--device cpu`` is
given): kernel K1 for the jerasure reed_sol_van pools' encodes,
degraded reads and recovery decodes, K2 for the balancer's sweeps.

The qa/tasks/thrashosds.py role as a standalone tool: concurrent
writers against a replicated and an EC pool while OSDs (and quorum
monitors) are killed/revived under them AND the fault-injection plane
(``ceph_tpu_torch/analysis/faults.py``) is armed — dropped/corrupted
frames on the wire, an injected shard-read EIO, a slowed OSD.  The
invariants checked are the storage system's whole promise:

  * every ACKED write is readable afterwards, at its acked value;
  * the cluster converges back to HEALTH_OK once the chaos stops;
  * the analysis planes stay clean (no lockdep violations, no leaked
    tracing spans);
  * every armed failpoint actually fired (a soak that injected
    nothing proved nothing).

Determinism: ONE seed drives both the thrash schedule (victim choice,
action pacing) and the fault plane's probability draws
(``faults.seed``), so a failing run reproduces from its recorded
seed::

    python -m ceph_tpu_torch.tools.thrasher --seed 8 --duration 20
    python -m ceph_tpu_torch.tools.thrasher --seed 8 --duration 20 \
        --device cpu                                  # without a card

Each run writes a ``<SERIES>_rNN.json`` record (CHAOS, DRILL, NETSPLIT,
SLODRILL, RACE or ASYNC) under ``chiprun_out/`` at the repository root
(``--out`` names another path).  NN is one past the newest record
committed at the root, so a run pairs with the records there;
``tools/perf_history.py`` reads the port's records as it reads those.

``--host-kill`` runs the whole-host failure drill instead: every OSD
under one CRUSH host bucket dies at once (the failure domain the EC
rule promises to survive), every acked write must read back degraded,
and the host revives EMPTY so the measured traffic is pure recovery.
The cycle runs twice — pipeline depth 1 (the serial per-object
baseline) and the pipelined default — so the ``DRILL`` record carries
recovery MB/s for both plus the speedup gated at >1.5x, then a
degraded-read soak races reader threads against active recovery with
shard-read EIOs armed and gates the p99 against an SLO block.

``--netsplit`` runs the directional network-partition drills on the
``net.partition`` failpoint family instead: (a) a healthy OSD loses
only its mon link — its peers still hear it, so zero false markdowns
and uninterrupted client I/O; (b) full isolation — peer reports must
get it marked down within ``osd_heartbeat_grace + 2x
osd_heartbeat_interval`` with zero acked-write loss and a clean
re-join after the heal; (c) a flapping link — repeated markdowns must
trip the ``osd_markdown_log`` dampener, raise OSD_FLAPPING, and stop
the epoch churn (``NETSPLIT`` record: ``false_markdowns`` /
``detect_s`` / ``epoch_churn``).

``--slow-ops`` runs the SLO-escalation drill instead: one OSD is
throttled (every op past ``osd_op_complaint_time``, every sent frame
dragged) under write load — SLOW_OPS must rise naming the victim,
OSD_SLOW_PING_TIME must rise from its ping lag, the send stall must
book on the victim's messenger only, and once the throttle lifts the
cluster must clear to HEALTH_OK with zero acked-write loss
(``SLODRILL`` record).

``--race-audit`` runs the chaos soak, the netsplit drills and the
SLO-escalation drill back to back with the data-race checker
(``analysis/racecheck.py``) armed over every swept daemon, then
probes the checker's overhead on a clean write lane in paired
subprocesses (checker on vs off).  The ``RACE`` record fails on any
lockset/confinement violation, any acked-write loss, or >=10% checker
overhead.

``--loop-stall`` runs the async-safety drill: the
``msgr.stall_dispatch`` failpoint delays one OSD's control-lane
dispatch callbacks inside their ``@nonblocking`` scopes
(``analysis/asyncheck.py``), the runtime enforcer must name the
victim callback mid-stall with both-end stacks, and disarming must
heal to HEALTH_OK with zero acked-write loss.  The ``ASYNC`` record
fails on any unsuppressed static BLOCK001 violation in the port
(``tools/lint_async.py``, run as a program from the repository root)
or >=5% enforcement overhead.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import random
import re
import shutil
import sys
import tempfile
import threading
import time
from typing import Dict, List, Optional, Tuple

# the repository root: the committed records' directory, and where
# the async lint runs from
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
# where a run's record goes unless --out names a path
OUT_DIR = os.path.join(_ROOT, "chiprun_out")

# --race-audit arms the data-race checker, whose guarded_by
# decorators install their descriptors at class-definition time — the
# env must be set BEFORE the first import of the package's analysis
# modules (the package's __init__ files import none) or the sweep's
# guard declarations are identity no-ops for this process
if "--race-audit" in sys.argv:
    os.environ["CEPH_TPU_RACECHECK"] = "1"
    os.environ.setdefault("CEPH_TPU_LOCKDEP", "1")
# --loop-stall arms the async-safety runtime, whose @nonblocking
# decorators are decoration-time identity no-ops when disabled — same
# before-any-import rule as the race audit
if "--loop-stall" in sys.argv:
    os.environ["CEPH_TPU_ASYNCHECK"] = "1"

from ..analysis import asyncheck, faults, lockdep, racecheck  # noqa: E402
from ..common import tracing  # noqa: E402
from ..common.admin_socket import AdminSocket  # noqa: E402
from ..common.backoff import Backoff  # noqa: E402
from ..common.config import Config  # noqa: E402
from ..osdmap.bincode_maps import payload_map  # noqa: E402
from ..services.client import ObjectNotFound, object_to_ps  # noqa: E402
from ..services.cluster import MiniCluster  # noqa: E402

# the acceptance fault mix: wire chaos probabilistic (recoverable by
# design — reconnect+replay), the destructive arms COUNTED so a soak
# can't cascade shard removals past the EC profile's m (that would
# manufacture data loss no real cluster promised to survive)
DEFAULT_SPEC = ("msgr.drop_frame=p:0.02;"
                "msgr.corrupt_frame=p:0.02;"
                "msgr.dup_frame=p:0.02;"
                "osd.slow_op=p:0.05,delay:0.03;"
                "osd.shard_read_eio=count:1")


def _conf() -> Config:
    c = Config()
    c.set("osd_heartbeat_interval", 0.2)
    c.set("osd_heartbeat_grace", 1.2)
    c.set("mon_osd_down_out_interval", 1.5)
    c.set("mon_lease", 0.3)
    c.set("mon_election_timeout", 0.5)
    # the soak's kill/revive cadence IS flapping by design (the
    # qa thrasher sets noout/nodown for the same reason): give the
    # markdown log enough budget that dampening never defers the
    # revives the verify phase depends on
    c.set("osd_max_markdown_count", 1000)
    # the balancer rides the soak with a tight loop and deviation
    # target so its pause gate is exercised while OSDs flap
    c.set("balancer_interval", 1.0)
    c.set("balancer_max_deviation", 1)
    return c


class _Writer(threading.Thread):
    """Loops put/delete (and EC partial overwrites) over its own key
    space, recording the last ACKED value per key; keys touched by an
    UNACKED attempt are 'dirty' — the op may still have landed
    durably (a legal outcome), so only readability is asserted."""

    def __init__(self, cluster: MiniCluster, wid: int, pool_id: int,
                 ec: bool):
        super().__init__(daemon=True, name=f"chaos-w{wid}")
        self.cluster = cluster
        self.wid = wid
        self.pool = pool_id
        self.ec = ec
        self.cli = cluster.client(f"chaos-w{wid}-{pool_id}")
        self.acked: Dict[str, Optional[bytes]] = {}
        self.dirty: set = set()
        self.ops = 0
        self.stop = threading.Event()

    def run(self) -> None:
        i = 0
        while not self.stop.is_set():
            key = f"w{self.wid}-k{i % 7}"
            val = f"{self.wid}:{i}:".encode() * 40
            op = None
            try:
                if i % 11 == 10:
                    op = "delete"
                    self.cli.delete(self.pool, key)
                    self.acked[key] = None
                    self.dirty.discard(key)
                else:
                    op = "put"
                    self.cli.put(self.pool, key, val)
                    self.acked[key] = val
                    self.dirty.discard(key)
                self.ops += 1
            except Exception:
                if op is not None:
                    self.dirty.add(key)
            i += 1
        self.cli.shutdown()


def _verify(cluster: MiniCluster,
            writers: List[_Writer]) -> List[tuple]:
    """Read back every acked key; returns the violations."""
    checker = cluster.client("chaos-check")
    bad: List[tuple] = []
    try:
        for w in writers:
            for key, want in w.acked.items():
                fuzzy = key in w.dirty
                bo = Backoff(base=0.2, cap=1.0, deadline=20.0)
                while True:
                    try:
                        try:
                            got = checker.get(w.pool, key,
                                              notfound_retries=0)
                        except ObjectNotFound:
                            got = None
                        if fuzzy:
                            break  # readable (or legally absent)
                        if got == want:
                            break
                        if not bo.sleep():
                            bad.append((w.pool, key, "mismatch"))
                            break
                    except Exception as e:  # Backoff-paced
                        if not bo.sleep():
                            bad.append((w.pool, key, repr(e)))
                            break
    finally:
        checker.shutdown()
    return bad


def soak(seed: int = 0, duration: float = 20.0, n_osds: int = 5,
         n_mons: int = 1, spec: str = DEFAULT_SPEC,
         settle_timeout: float = 60.0, device="cuda") -> Dict:
    """One seeded chaos soak; returns the CHAOS record dict.  The
    cluster's EC codes and its balancer run on ``device``."""
    rng = random.Random(seed)
    faults.reset()
    faults.seed(seed)
    base_lockdep = len(lockdep.violations())
    base_spans = {id(s) for _svc, s in tracing.active_spans()}

    # persistent stores: kill/revive is a daemon crash+restart over
    # the OSD's surviving disk (the thrashosds contract), NOT a disk
    # wipe.  Without this, every revive reformats the store, and two
    # kills inside one recovery window erase 2 of 3 shards — loss the
    # k=2/m=1 profile never promised to survive.
    data_root = tempfile.mkdtemp(prefix=f"chaos-s{seed}-")
    c = MiniCluster(n_osds=n_osds, hosts=n_osds, config=_conf(),
                    n_mons=n_mons, data_dir=data_root,
                    device=device).start()
    result: Dict = {"kind": "chaos", "seed": seed,
                    "duration": duration, "n_osds": n_osds,
                    "n_mons": n_mons, "spec": spec}
    try:
        c.create_replicated_pool(1, pg_num=8, size=3)
        c.create_ec_pool(2, "chaos21", {"plugin": "jerasure",
                                        "technique": "reed_sol_van",
                                        "k": "2", "m": "1", "w": "8"},
                         pg_num=8)
        writers = [_Writer(c, 0, 1, ec=False),
                   _Writer(c, 1, 1, ec=False),
                   _Writer(c, 2, 2, ec=True)]
        for w in writers:
            w.start()
        # an ACTIVE balancer rides the whole soak: its pause gate
        # (no upmap proposals while the cluster is degraded) is a
        # robustness invariant this soak asserts below
        mgr = c.start_mgr()
        bal = mgr.modules["balancer"]
        bal.active = True
        c.set_faults(spec)

        end = time.monotonic() + duration
        while time.monotonic() < end:
            victim = rng.randrange(n_osds)
            c.kill_osd(victim)
            if n_mons > 1 and rng.random() < 0.3:
                rank = rng.randrange(1, n_mons)
                if rank in c.mons and len(c.mons) == n_mons:
                    c.kill_mon(rank)
                    time.sleep(0.5 + rng.random())
                    c.revive_mon(rank)
            time.sleep(0.8 + rng.random())
            c.revive_osd(victim)
            time.sleep(0.4 + rng.random() * 0.4)

        # chaos off; give in-flight faulted ops a beat to drain so
        # the writers' LAST acked values are post-fault reality
        c.set_faults("")
        time.sleep(1.0)
        for w in writers:
            w.stop.set()
        for w in writers:
            w.join(timeout=30)
        result["ops"] = sum(w.ops for w in writers)

        # settle: all osds up, then time the HEALTH_OK convergence
        for o in range(n_osds):
            if o not in c.osds:
                c.revive_osd(o)
        t0 = time.monotonic()
        try:
            c.wait_for_health_ok(timeout=settle_timeout)
            result["health_converge_s"] = round(
                time.monotonic() - t0, 3)
            converged = True
        except TimeoutError as e:
            result["health_converge_s"] = None
            result["health_error"] = str(e)
            converged = False
        time.sleep(2.0)  # a peering pass after the last epoch

        bad = _verify(c, writers)
        result["checked"] = sum(len(w.acked) for w in writers)
        result["lost"] = len(bad)
        result["bad"] = [list(b) for b in bad[:5]]
        result["fired"] = faults.snapshot()
        armed = [p.strip().split("=")[0]
                 for p in spec.split(";") if p.strip()]
        result["unfired_armed"] = sorted(
            n for n in armed if not result["fired"].get(n))
        result["balancer_rounds"] = bal.rounds
        result["balancer_pauses"] = int(
            mgr.pc.dump().get("balancer_paused", 0))
        result["balancer_proposals"] = sum(
            p["proposed"] for p in bal.proposal_log)
        result["balancer_degraded_proposals"] = sum(
            1 for p in bal.proposal_log if p["degraded"])
    finally:
        c.shutdown()
        faults.reset()
        shutil.rmtree(data_root, ignore_errors=True)

    result["lockdep_violations"] = \
        len(lockdep.violations()) - base_lockdep
    # daemon threads die with their sockets; give them a beat before
    # judging the span plane
    deadline = time.monotonic() + 5.0
    while time.monotonic() < deadline:
        leaks = [s for _svc, s in tracing.active_spans()
                 if id(s) not in base_spans]
        if not leaks:
            break
        time.sleep(0.1)
    result["span_leaks"] = len(
        [s for _svc, s in tracing.active_spans()
         if id(s) not in base_spans])
    result["ok"] = bool(
        result.get("lost") == 0 and converged
        and result["lockdep_violations"] == 0
        and result["span_leaks"] == 0
        and not result["unfired_armed"]
        and result.get("balancer_degraded_proposals", 0) == 0)
    return result


# -- whole-host failure drill + degraded-read soak --------------------

def _drill_conf(depth: int) -> Config:
    c = _conf()
    # keep the killed host's OSDs IN while they are down: the drill
    # reads degraded against the stable mapping, then revives the
    # same OSDs empty — so the measured traffic is pure recovery
    # pushes back onto the wiped host, not a CRUSH remap shuffle
    c.set("mon_osd_down_out_interval", 60.0)
    c.set("osd_recovery_pipeline_depth", depth)
    # small units -> many of them: the pipeline's overlap (unit N+1
    # gathering while unit N decodes) is what the speedup gate
    # measures, and it needs units to overlap
    c.set("osd_recovery_batch_max_objects", 2)
    c.set("osd_recovery_sleep", 0.0)
    return c


def _percentile(sorted_vals: List[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    i = min(len(sorted_vals) - 1,
            max(0, int(round(q * (len(sorted_vals) - 1)))))
    return sorted_vals[i]


def _recovery_bytes(cluster: MiniCluster) -> int:
    return sum(int(svc.pc.dump().get("recovery_bytes", 0))
               for svc in cluster.osds.values())


def _host_members(cluster: MiniCluster, host: str) -> List[int]:
    """OSD ids under one CRUSH host bucket (the blast radius of a
    whole-host failure)."""
    crush = cluster.wrapper
    bucket = crush.get_item_id(host)
    return sorted(d for d in range(cluster.n_osds)
                  if crush.get_immediate_parent_id(d) == bucket)


def _kill_host_phase(seed: int, depth: int, n_osds: int, hosts: int,
                     n_objects: int, obj_bytes: int,
                     settle_timeout: float,
                     net_delay: float = 0.015, device="cuda") -> Dict:
    """One measured whole-host kill/recover cycle at a given pipeline
    depth: write, kill every OSD of host0, verify every acked write
    reads back degraded, revive the host EMPTY (fresh stores — real
    recovery traffic), and time the recovery to clean.

    ``net_delay`` models per-link network latency on OSD-to-OSD
    frames via the seeded ``msgr.delay_frame`` failpoint for the
    timed window.  In-process loopback RTT is microseconds, which
    hides exactly the cost the pipeline exists to overlap (helper
    reads wait on the network in any real deployment); the delay is
    identical at every depth, recorded in the output, and cleared
    before the post-recovery readback."""
    rng = random.Random(seed)
    faults.reset()
    faults.seed(seed)
    c = MiniCluster(n_osds=n_osds, hosts=hosts,
                    config=_drill_conf(depth), device=device).start()
    out: Dict = {"depth": depth}
    try:
        # k=2/m=1 with failure-domain host across `hosts` hosts: a
        # whole-host failure costs exactly ONE shard per PG — the
        # survivable worst case the profile promises
        c.create_ec_pool(3, "drill21", {"plugin": "jerasure",
                                        "technique": "reed_sol_van",
                                        "k": "2", "m": "1", "w": "8"},
                         pg_num=4)
        cli = c.client(f"drill-d{depth}")
        acked: Dict[str, bytes] = {}
        for i in range(n_objects):
            val = bytes(rng.randrange(256)
                        for _ in range(7)) * (obj_bytes // 7)
            cli.put(3, f"drill-{i}", val)
            acked[f"drill-{i}"] = val

        # expected shard layout, computed BEFORE the kill while every
        # OSD is up (a down OSD drops out of the reported up set):
        # placement is stable (down-out disabled, the kill never
        # remaps), so recovery is done exactly when every shard the
        # victims held has been rebuilt onto them
        victims = _host_members(c, "host0")
        m = payload_map(c.mon_command({"type": "get_map"}))
        pool = m.pools[3]
        expect: List[Tuple[int, str, str]] = []
        for oid in acked:
            ps = object_to_ps(oid) % pool.pg_num
            up, _p, _a, _ap = m.pg_to_up_acting_osds(3, ps)
            for pos, osd in enumerate(up):
                if osd in victims:
                    expect.append((osd, f"3.{ps}", f"{oid}.s{pos}"))

        for o in victims:
            c.kill_osd(o)
        for o in victims:
            c.wait_for_down(o, timeout=20)

        # degraded reads: every ACKED write must read back from the
        # survivors while the host is dark — zero acked-write loss
        lost = 0
        for key, want in acked.items():
            try:
                if cli.get(3, key) != want:
                    lost += 1
            except Exception:
                lost += 1
        out["lost_degraded"] = lost

        # revive the whole host with EMPTY stores and time the
        # recovery that rebuilds every lost shard from survivors.
        # The speedup gate compares gather/decode time across pipeline
        # depths, so the clock runs from the FIRST recovered byte to
        # the last rebuilt victim shard — the revive/heartbeat
        # detection latency ahead of it is identical at every depth
        # and the harness's 0.2s poll would quantize it away.
        if net_delay > 0:
            c.set_faults(f"msgr.delay_frame=p:1.0,"
                         f"delay:{net_delay},who:osd.")
            out["net_delay_s"] = net_delay
        base = _recovery_bytes(c)
        t0 = time.monotonic()
        for o in victims:
            c.revive_osd(o)

        def _rebuilt() -> bool:
            return all(c.osds[osd].store.stat(cid, sh) is not None
                       for osd, cid, sh in expect
                       if osd in c.osds)

        t_first = None
        deadline = time.monotonic() + settle_timeout
        while time.monotonic() < deadline:
            if t_first is None and _recovery_bytes(c) > base:
                t_first = time.monotonic()
            if _rebuilt():
                break
            time.sleep(0.005)  # measurement poll cadence
        t_done = time.monotonic()
        c.set_faults("")  # readback + convergence at loopback speed
        try:
            c.wait_for_recovery(3, acked, timeout=settle_timeout)
            out["detect_s"] = round((t_first or t_done) - t0, 3)
            out["recover_s"] = round(t_done - (t_first or t0), 3)
            c.wait_for_health_ok(timeout=settle_timeout)
            out["converge_s"] = round(time.monotonic() - t0, 3)
        except TimeoutError as e:
            out["error"] = str(e)
            return out
        moved = _recovery_bytes(c) - base
        out["recovered_bytes"] = moved
        out["recovery_mbps"] = round(
            moved / 1e6 / max(1e-9, out["recover_s"]), 3)

        # post-recovery readback: recovery must hand back the same
        # acked bytes it found
        lost_after = 0
        for key, want in acked.items():
            try:
                if cli.get(3, key) != want:
                    lost_after += 1
            except Exception:
                lost_after += 1
        out["lost"] = lost + lost_after
        out["checked"] = len(acked)
        rec = {}
        for svc in c.osds.values():
            for k_, v_ in svc.rec_pc.dump().items():
                if isinstance(v_, (int, float)) and v_:
                    rec[k_] = rec.get(k_, 0) + int(v_)
        out["recovery_counters"] = rec
    finally:
        c.shutdown()
        faults.reset()
    return out


def host_kill_drill(seed: int = 8, n_osds: int = 6, hosts: int = 3,
                    n_objects: int = 48, obj_bytes: int = 14 * 1024,
                    depth: int = 3, net_delay: float = 0.015,
                    settle_timeout: float = 90.0, device="cuda") -> Dict:
    """The whole-host failure drill: the same seeded kill/recover
    cycle measured twice — once serial (pipeline depth 1, the
    per-object gather-then-decode baseline) and once pipelined — so
    the record carries the recovery-MB/s speedup the pipeline gate
    red-checks (>1.5x), alongside the durability verdicts."""
    result: Dict = {"kind": "drill", "seed": seed, "n_osds": n_osds,
                    "hosts": hosts, "objects": n_objects,
                    "obj_bytes": obj_bytes}
    serial = _kill_host_phase(seed, 1, n_osds, hosts, n_objects,
                              obj_bytes, settle_timeout,
                              net_delay=net_delay, device=device)
    piped = _kill_host_phase(seed, depth, n_osds, hosts, n_objects,
                             obj_bytes, settle_timeout,
                             net_delay=net_delay, device=device)
    result["serial"] = serial
    result["pipelined"] = piped
    result["recovery_mbps_serial"] = serial.get("recovery_mbps")
    result["recovery_mbps"] = piped.get("recovery_mbps")
    result["converge_s"] = piped.get("converge_s")
    result["lost"] = (serial.get("lost", 1) + piped.get("lost", 1))
    result["checked"] = (serial.get("checked", 0)
                         + piped.get("checked", 0))
    if serial.get("recovery_mbps") and piped.get("recovery_mbps"):
        result["pipeline_speedup"] = round(
            piped["recovery_mbps"] / serial["recovery_mbps"], 3)
    result["ok"] = bool(
        result["lost"] == 0
        and serial.get("converge_s") is not None
        and piped.get("converge_s") is not None
        and result.get("pipeline_speedup", 0) > 1.5)
    return result


def degraded_read_soak(seed: int = 8, duration: float = 8.0,
                       n_osds: int = 4, n_objects: int = 48,
                       obj_bytes: int = 14 * 1024,
                       slo_p99_ms: float = 250.0,
                       eio_p: float = 0.02,
                       settle_timeout: float = 90.0,
                       device="cuda") -> Dict:
    """Degraded reads under ACTIVE recovery with helper EIOs armed:
    one OSD dies and comes back empty; while its shards rebuild
    (osd_recovery_sleep stretches the window), reader threads hammer
    the pool through the degraded path with ``osd.shard_read_eio``
    firing probabilistically.  The p99 read latency gates against the
    SLO block — recovery must not starve clients.

    The EIO arm is scoped to ONE surviving OSD: an injected shard
    EIO drops the shard for repair, so on a k=2,m=2 pool the worst
    case is the empty victim plus the scoped OSD's shards = exactly
    m losses — every object stays recoverable by construction, and
    the soak measures latency, not data loss."""
    rng = random.Random(seed)
    faults.reset()
    faults.seed(seed)
    conf = _drill_conf(depth=3)
    # stretch recovery across the soak window so every latency sample
    # really races active recovery pushes
    conf.set("osd_recovery_sleep", 0.05)
    conf.set("osd_recovery_batch_max_objects", 1)
    c = MiniCluster(n_osds=n_osds, hosts=n_osds, config=conf,
                    device=device).start()
    result: Dict = {"kind": "drill_soak", "seed": seed,
                    "duration": duration, "eio_p": eio_p}
    try:
        c.create_ec_pool(3, "soak22", {"plugin": "jerasure",
                                       "technique": "reed_sol_van",
                                       "k": "2", "m": "2", "w": "8"},
                         pg_num=4)
        cli = c.client("soak-w")
        acked: Dict[str, bytes] = {}
        for i in range(n_objects):
            val = bytes(rng.randrange(256)
                        for _ in range(7)) * (obj_bytes // 7)
            cli.put(3, f"soak-{i}", val)
            acked[f"soak-{i}"] = val
        victim = rng.randrange(n_osds)
        eio_osd = (victim + 1) % n_osds
        c.kill_osd(victim)
        c.wait_for_down(victim, timeout=20)
        c.revive_osd(victim)  # empty store: recovery starts now
        c.set_faults(
            f"osd.shard_read_eio=p:{eio_p},who:osd.{eio_osd}")

        lats: List[float] = []
        errors = [0]
        stop = threading.Event()

        def reader(wid: int) -> None:
            r = random.Random(seed * 1000 + wid)
            rcli = c.client(f"soak-r{wid}")
            keys = sorted(acked)
            while not stop.is_set():
                key = keys[r.randrange(len(keys))]
                t0 = time.monotonic()
                try:
                    got = rcli.get(3, key)
                    lats.append(time.monotonic() - t0)
                    if got != acked[key]:
                        errors[0] += 1
                except Exception:
                    errors[0] += 1

        threads = [threading.Thread(target=reader, args=(w,),
                                    daemon=True) for w in range(3)]
        for t in threads:
            t.start()
        time.sleep(duration)
        stop.set()
        for t in threads:
            t.join(timeout=20)
        c.set_faults("")

        lats.sort()
        p99 = _percentile(lats, 0.99) * 1000
        result["reads"] = len(lats)
        result["read_errors"] = errors[0]
        result["p50_ms"] = round(_percentile(lats, 0.50) * 1000, 3)
        result["p99_ms"] = round(p99, 3)
        result["fired"] = faults.snapshot()
        result["slo"] = {"metric": "degraded_read_p99_ms",
                         "limit": slo_p99_ms,
                         "value": round(p99, 3),
                         "pass": bool(lats) and p99 <= slo_p99_ms}
        # the soak must end in a healthy cluster with zero mismatches
        try:
            c.wait_for_recovery(3, acked, timeout=settle_timeout)
            c.wait_for_health_ok(timeout=settle_timeout)
            converged = True
        except TimeoutError as e:
            result["error"] = str(e)
            converged = False
        result["ok"] = bool(result["slo"]["pass"] and converged
                            and errors[0] == 0)
    finally:
        c.shutdown()
        faults.reset()
    return result


def drill(seed: int = 8, soak_duration: float = 8.0,
          slo_p99_ms: float = 250.0, device="cuda") -> Dict:
    """The full DRILL record: whole-host kill cycle (serial +
    pipelined) then the degraded-read soak, one combined verdict."""
    rec = host_kill_drill(seed=seed, device=device)
    rec["soak"] = degraded_read_soak(seed=seed,
                                     duration=soak_duration,
                                     slo_p99_ms=slo_p99_ms,
                                     device=device)
    rec["ok"] = bool(rec["ok"] and rec["soak"]["ok"])
    return rec


# -- netsplit drills (directional net.partition failpoints) -----------

def _netsplit_conf() -> Config:
    c = _conf()
    c.set("osd_heartbeat_interval", 0.25)
    c.set("osd_heartbeat_grace", 1.0)
    # the whole point: peer reports detect failure; the direct mon
    # beacon is liveness-of-last-resort only, far outside the drill
    c.set("mon_osd_report_timeout", 30.0)
    c.set("mon_osd_down_out_interval", 2.0)
    c.set("mon_osd_min_down_reporters", 2)
    return c


def _mon_partition_phase(seed: int, n_osds: int = 4,
                         hold_s: float = 5.0, device="cuda") -> Dict:
    """(a) cut the mon<->osd link of one HEALTHY osd, both ways, for
    ~5x grace: its peers still hear it, so the detector must record
    ZERO false markdowns and client I/O must keep flowing.  This is
    the exact scenario the old beacon-only detector failed (a cut mon
    link killed a serving osd)."""
    rng = random.Random(seed)
    faults.reset()
    faults.seed(seed)
    c = MiniCluster(n_osds=n_osds, hosts=n_osds,
                    config=_netsplit_conf(), device=device).start()
    out: Dict = {"phase": "mon_partition", "hold_s": hold_s}
    try:
        c.create_replicated_pool(1, pg_num=8, size=3)
        w = _Writer(c, 0, 1, ec=False)
        w.start()
        victim = rng.randrange(n_osds)
        out["victim"] = victim
        time.sleep(1.5)  # steady state: peers established, writes up
        base_md = int(c.mon.pc.dump().get("markdowns", 0))
        ops0 = w.ops
        c.set_faults(f"net.partition=p:1.0,"
                     f"pairs:osd.{victim}>mon|mon>osd.{victim}")
        went_down = False
        t_end = time.monotonic() + hold_s
        while time.monotonic() < t_end:
            if victim not in c.status()["up_osds"]:
                went_down = True
                break
            time.sleep(0.1)  # drill observation cadence
        c.set_faults("")
        out["false_markdowns"] = int(went_down) + max(
            0, int(c.mon.pc.dump().get("markdowns", 0)) - base_md)
        out["ops_during_cut"] = w.ops - ops0
        w.stop.set()
        w.join(timeout=20)
        bad = _verify(c, [w])
        out["checked"] = len(w.acked)
        out["lost"] = len(bad)
        c.wait_for_health_ok(timeout=30)
        out["ok"] = bool(out["false_markdowns"] == 0
                         and out["lost"] == 0
                         and out["ops_during_cut"] > 0)
    finally:
        c.shutdown()
        faults.reset()
    return out


def _isolation_phase(seed: int, n_osds: int = 4, device="cuda") -> Dict:
    """(b) fully isolate one osd (both directions, everyone): peers
    must report it and the mon must mark it down within
    osd_heartbeat_grace + 2*osd_heartbeat_interval; writes keep
    acking on the survivors with zero acked-write loss; after the
    heal the victim learns its markdown, re-boots, and the cluster
    reconverges to HEALTH_OK."""
    rng = random.Random(seed)
    faults.reset()
    faults.seed(seed)
    conf = _netsplit_conf()
    grace = conf["osd_heartbeat_grace"]
    interval = conf["osd_heartbeat_interval"]
    c = MiniCluster(n_osds=n_osds, hosts=n_osds, config=conf,
                    device=device).start()
    out: Dict = {"phase": "isolation",
                 "detect_bound_s": round(grace + 2 * interval, 3)}
    try:
        c.create_replicated_pool(1, pg_num=8, size=3)
        writers = [_Writer(c, 0, 1, ec=False),
                   _Writer(c, 1, 1, ec=False)]
        for w in writers:
            w.start()
        victim = rng.randrange(n_osds)
        out["victim"] = victim
        time.sleep(1.5)
        epoch0 = int(c.status()["epoch"])
        c.set_faults(f"net.partition=p:1.0,"
                     f"pairs:osd.{victim}>*|*>osd.{victim}")
        t0 = time.monotonic()
        detect = None
        deadline = t0 + 20.0
        while time.monotonic() < deadline:
            if victim not in c.status()["up_osds"]:
                detect = time.monotonic() - t0
                break
            time.sleep(0.05)  # detection-latency poll
        out["detect_s"] = round(detect, 3) if detect else None
        # hold through down->out so the markdown/out interplay runs
        # while the victim is dark, then heal: the victim's beats
        # resume, the mon nudges it the map it missed, and it re-boots
        time.sleep(conf["mon_osd_down_out_interval"] + 1.0)
        c.set_faults("")
        c.wait_for_up(victim, timeout=30)
        for w in writers:
            w.stop.set()
        for w in writers:
            w.join(timeout=20)
        bad = _verify(c, writers)
        out["checked"] = sum(len(w.acked) for w in writers)
        out["lost"] = len(bad)
        c.wait_for_health_ok(timeout=60)
        out["epoch_churn"] = int(c.status()["epoch"]) - epoch0
        out["ok"] = bool(detect is not None
                         and detect <= grace + 2 * interval
                         and out["lost"] == 0)
    finally:
        c.shutdown()
        faults.reset()
    return out


def _flap_phase(seed: int, n_osds: int = 4,
                hold_s: float = 8.0, device="cuda") -> Dict:
    """(c) a flapping link: the victim keeps its mon link but loses
    its peers, so every re-boot is followed by another reporter-quorum
    markdown.  Crossing osd_max_markdown_count must dampen the daemon
    (boot deferred + auto-out), raise OSD_FLAPPING, and STOP the epoch
    churn; once the link heals and the markdown log drains, the osd
    rejoins and health clears."""
    rng = random.Random(seed)
    faults.reset()
    faults.seed(seed)
    conf = _netsplit_conf()
    conf.set("osd_max_markdown_count", 3)
    conf.set("osd_max_markdown_period", 12.0)
    c = MiniCluster(n_osds=n_osds, hosts=n_osds, config=conf,
                    device=device).start()
    out: Dict = {"phase": "flap", "hold_s": hold_s}
    try:
        c.create_replicated_pool(1, pg_num=8, size=3)
        w = _Writer(c, 0, 1, ec=False)
        w.start()
        victim = rng.randrange(n_osds)
        out["victim"] = victim
        time.sleep(1.5)
        epoch0 = int(c.status()["epoch"])
        # peers cut both ways, mon link OPEN: markdown epochs reach
        # the victim, it re-boots, and the flap cycle spins
        c.set_faults(f"net.partition=p:1.0,"
                     f"pairs:osd.{victim}>osd.|osd.>osd.{victim}")
        time.sleep(hold_s - 3.0)
        epoch_mid = int(c.status()["epoch"])
        time.sleep(3.0)  # the dampened tail: churn must have stopped
        epoch_end = int(c.status()["epoch"])
        health = c.health()
        dump = c.mon.pc.dump()
        out["flapping_raised"] = "OSD_FLAPPING" in health.get(
            "check_codes", [])
        out["dampened"] = int(dump.get("markdowns_dampened", 0))
        out["markdowns"] = int(dump.get("markdowns", 0))
        out["epoch_churn"] = epoch_end - epoch0
        out["epoch_churn_dampened_tail"] = epoch_end - epoch_mid
        c.set_faults("")
        # rejoin waits for the oldest markdown to age out of the
        # window (the delayed re-boot role), then boot restores the
        # auto-outed weight
        c.wait_for_up(victim, timeout=30)
        w.stop.set()
        w.join(timeout=20)
        bad = _verify(c, [w])
        out["checked"] = len(w.acked)
        out["lost"] = len(bad)
        c.wait_for_health_ok(timeout=60)
        out["flapping_cleared"] = "OSD_FLAPPING" not in c.health().get(
            "check_codes", [])
        out["ok"] = bool(out["flapping_raised"]
                         and out["dampened"] >= 1
                         and out["epoch_churn_dampened_tail"] <= 2
                         and out["lost"] == 0
                         and out["flapping_cleared"])
    finally:
        c.shutdown()
        faults.reset()
    return out


def slow_ops_drill(seed: int = 8, n_osds: int = 3,
                   device="cuda") -> Dict:
    """The SLO-escalation drill (``--slow-ops``): ONE throttled OSD
    under cluster write load.  Every op on the victim sleeps past
    ``osd_op_complaint_time`` and every frame it sends drags against
    the ``msgr.delay_frame`` failpoint, so the drill must see the
    whole saturation plane fire: SLOW_OPS naming the victim and
    OSD_SLOW_PING_TIME raised by the monitor, the send stall booked
    on the victim's messenger (``dump_messenger`` over the admin
    socket) and NOT on a healthy peer's — then, once the throttle
    lifts, in-flight ops drain, the RTT windows decay, and health
    returns to HEALTH_OK with zero acked-write loss."""
    rng = random.Random(seed)
    faults.reset()
    faults.seed(seed)
    conf = _conf()
    conf.set("osd_op_complaint_time", 0.2)
    conf.set("osd_heartbeat_ping_threshold_ms", 20.0)
    c = MiniCluster(n_osds=n_osds, config=conf, device=device).start()
    out: Dict = {"kind": "slowops", "seed": seed,
                 "n_osds": n_osds}
    try:
        c.create_replicated_pool(1, pg_num=8, size=3)
        c.wait_for_health_ok()
        w = _Writer(c, 0, 1, ec=False)
        w.start()
        victim = rng.randrange(n_osds)
        out["victim"] = victim
        t0 = time.monotonic()
        c.set_faults(
            f"osd.slow_op=p:1.0,delay:0.5,who:osd.{victim};"
            f"msgr.delay_frame=p:1.0,delay:0.04,who:osd.{victim}")
        codes: set = set()
        h: Dict = {}
        deadline = time.monotonic() + 30.0
        while time.monotonic() < deadline:
            h = c.health()
            codes = set(h.get("check_codes", []))
            if {"SLOW_OPS", "OSD_SLOW_PING_TIME"} <= codes:
                break
            time.sleep(0.25)
        out["raise_s"] = round(time.monotonic() - t0, 2)
        out["slow_ops_raised"] = "SLOW_OPS" in codes
        out["ping_time_raised"] = "OSD_SLOW_PING_TIME" in codes
        checks = {ck.split(":", 1)[0]: ck
                  for ck in h.get("checks", [])}
        out["named_victim"] = \
            f"osd.{victim}" in checks.get("SLOW_OPS", "")
        # admin-socket proof the telemetry attributes the stall to
        # the right daemon, not just that health went red
        dm_v = AdminSocket.request(
            os.path.join(c.asok_dir, f"osd.{victim}.asok"),
            "dump_messenger")
        dm_h = AdminSocket.request(
            os.path.join(c.asok_dir,
                         f"osd.{(victim + 1) % n_osds}.asok"),
            "dump_messenger")
        out["victim_stall_s"] = dm_v["totals"]["send_stall_s"]
        out["healthy_stall_s"] = dm_h["totals"]["send_stall_s"]
        c.set_faults("")
        w.stop.set()
        w.join(timeout=20)
        bad = _verify(c, [w])
        out["checked"] = len(w.acked)
        out["lost"] = len(bad)
        t1 = time.monotonic()
        cleared = False
        deadline = time.monotonic() + 90.0
        while time.monotonic() < deadline:
            h = c.health()
            if h.get("status") == "HEALTH_OK":
                cleared = True
                break
            time.sleep(0.5)
        out["cleared"] = cleared
        out["clear_s"] = round(time.monotonic() - t1, 2)
        out["ok"] = bool(out["slow_ops_raised"]
                         and out["ping_time_raised"]
                         and out["named_victim"]
                         and out["victim_stall_s"]
                         > 2 * out["healthy_stall_s"]
                         and out["lost"] == 0
                         and out["cleared"])
    finally:
        c.shutdown()
        faults.reset()
    return out


def netsplit(seed: int = 8, device="cuda") -> Dict:
    """The full NETSPLIT record: mon-link cut (no false markdowns),
    full isolation (fast true-positive detection, zero acked loss),
    flapping link (dampening + OSD_FLAPPING + bounded churn)."""
    rec: Dict = {"kind": "netsplit", "seed": seed}
    a = _mon_partition_phase(seed, device=device)
    b = _isolation_phase(seed, device=device)
    fl = _flap_phase(seed, device=device)
    rec["mon_partition"] = a
    rec["isolation"] = b
    rec["flap"] = fl
    # the trajectory columns perf_history red-checks
    rec["false_markdowns"] = a.get("false_markdowns")
    rec["detect_s"] = b.get("detect_s")
    rec["epoch_churn"] = fl.get("epoch_churn")
    rec["lost"] = (a.get("lost", 1) + b.get("lost", 1)
                   + fl.get("lost", 1))
    rec["checked"] = (a.get("checked", 0) + b.get("checked", 0)
                      + fl.get("checked", 0))
    rec["ok"] = bool(a.get("ok") and b.get("ok") and fl.get("ok"))
    return rec


def write_bench(seed: int = 8, duration: float = 4.0,
                n_osds: int = 3, device="cuda") -> Dict:
    """The checker-overhead probe body (hidden ``--write-bench``): a
    steady replicated write lane, no chaos — ops/s under whatever
    ``CEPH_TPU_RACECHECK`` setting this process was started with.
    race_audit() runs it twice in subprocesses (checker armed vs not)
    and gates the delta, so the comparison is decoration-time real on
    both sides."""
    c = MiniCluster(n_osds=n_osds, hosts=n_osds,
                    config=_conf(), device=device).start()
    out: Dict = {"kind": "write_bench", "seed": seed,
                 "racecheck": racecheck.enabled()}
    try:
        c.create_replicated_pool(1, pg_num=8, size=3)
        c.wait_for_health_ok()
        cli = c.client("rc-bench")
        val = b"x" * 4096
        try:
            t0 = time.monotonic()
            ops = 0
            while time.monotonic() - t0 < duration:
                cli.put(1, f"k{ops % 64}", val)
                ops += 1
            dt = time.monotonic() - t0
        finally:
            cli.shutdown()
        out["ops"] = ops
        out["ops_per_s"] = round(ops / dt, 1)
    finally:
        c.shutdown()
    return out


def _bench_overhead(seed: int, runs: int = 3,
                    env_var: str = "CEPH_TPU_RACECHECK",
                    device="cuda") -> Dict:
    """Best-of-N write-bench ops/s with the checker named by
    ``env_var`` armed vs disarmed, each in its own subprocess (the
    guard/contract declarations are decoration-time, so an in-process
    toggle would measure nothing) whose cluster runs on ``device``.
    Shared by --race-audit (CEPH_TPU_RACECHECK) and --loop-stall
    (CEPH_TPU_ASYNCHECK)."""
    import subprocess

    def probe(armed: bool) -> float:
        env = dict(os.environ)
        env[env_var] = "1" if armed else "0"
        env.setdefault("CEPH_TPU_LOCKDEP", "1")
        best = 0.0
        for _ in range(runs):
            p = subprocess.run(
                [sys.executable, "-m", "ceph_tpu_torch.tools.thrasher",
                 "--write-bench", "--seed", str(seed),
                 "--device", str(device)],
                capture_output=True, text=True, env=env, cwd=_ROOT,
                timeout=300)
            if p.returncode != 0:
                raise RuntimeError(
                    f"write-bench subprocess failed: {p.stderr[-500:]}")
            rec = json.loads(p.stdout.strip().splitlines()[-1])
            best = max(best, float(rec["ops_per_s"]))
        return best

    on = probe(True)
    off = probe(False)
    return {"ops_per_s_checked": on, "ops_per_s_raw": off,
            "overhead_pct": round(max(0.0, (1 - on / off) * 100), 2)
            if off else None}


_LINT_LINE = re.compile(r":\d+: BLOCK\d{3} ")


def _static_async_violations() -> int:
    """The repository's async-safety lint (``tools/lint_async.py``) over
    the port, run as a program from the repository root (the package
    imports nothing of ``tools``): its violation lines, held to its
    exit code."""
    import subprocess

    p = subprocess.run(
        [sys.executable, os.path.join("tools", "lint_async.py"),
         "ceph_tpu_torch"], capture_output=True, text=True, cwd=_ROOT,
        timeout=600)
    n = sum(1 for line in p.stdout.splitlines() if _LINT_LINE.search(line))
    if p.returncode not in (0, 1) or (p.returncode == 1) != (n > 0):
        raise RuntimeError(f"tools/lint_async.py exited {p.returncode} "
                           f"with {n} violation line(s): "
                           f"{(p.stdout + p.stderr)[-500:]}")
    return n


def loop_stall_drill(seed: int = 8, n_osds: int = 3,
                     device="cuda") -> Dict:
    """The async-safety drill (``--loop-stall``): arm
    ``msgr.stall_dispatch`` over one OSD so every control-lane
    dispatch callback on the victim sleeps 0.25s INSIDE its
    ``@nonblocking`` scope (5x the 50ms budget).  The runtime
    enforcer must catch the stall in flight and name the victim
    callback (a ``handler:osd.N:<type>`` scope) with both-end stacks
    — the contract entry stack and the mid-stall witness — while the
    static pass stays clean (the delay is a fault hook, invisible to
    the call graph on purpose: this is exactly the dynamic blocking
    the runtime twin exists for).  Disarm must heal to HEALTH_OK
    with zero acked-write loss, and enforcement overhead on a clean
    write lane must stay under 5%."""
    if not asyncheck.enabled():
        raise RuntimeError(
            "loop_stall needs CEPH_TPU_ASYNCHECK=1 before ceph_tpu_torch "
            "imports (run via --loop-stall)")
    rng = random.Random(seed)
    faults.reset()
    faults.seed(seed)
    conf = _conf()
    conf.set("asyncheck_loop_budget_ms", 50.0)
    c = MiniCluster(n_osds=n_osds, config=conf, device=device).start()
    out: Dict = {"kind": "async", "seed": seed, "n_osds": n_osds,
                 "budget_ms": 50.0}
    # the static half of the gate: zero unsuppressed BLOCK001
    # reachability violations package-wide
    out["static_violations"] = _static_async_violations()
    try:
        c.create_replicated_pool(1, pg_num=8, size=3)
        c.wait_for_health_ok()
        base = asyncheck.mark()
        w = _Writer(c, 0, 1, ec=False)
        w.start()
        victim = rng.randrange(n_osds)
        out["victim"] = victim
        want = f"handler:osd.{victim}:"
        t0 = time.monotonic()
        c.set_faults(
            f"msgr.stall_dispatch=p:1.0,delay:0.25,"
            f"who:osd.{victim}")
        named: Optional[str] = None
        stalled = False
        deadline = time.monotonic() + 30.0
        while time.monotonic() < deadline:
            for r in asyncheck.violations()[base:]:
                if str(r["scope"]).startswith(want):
                    named = named or str(r["scope"])
                    if r["kind"] == "stall":
                        stalled = True
            if named and stalled:
                break
            time.sleep(0.1)
        out["raise_s"] = round(time.monotonic() - t0, 2)
        recs = [r for r in asyncheck.violations()[base:]
                if str(r["scope"]).startswith(want)]
        out["victim_scope"] = named
        out["victim_named"] = named is not None
        out["stall_witnessed"] = stalled
        out["overruns"] = len(recs)
        out["both_stacks"] = bool(recs) and all(
            r["entry_stack"] and r["witness_stack"]
            for r in recs[:10])
        # the admin surface serves the same evidence per daemon
        d = AdminSocket.request(
            os.path.join(c.asok_dir, f"osd.{victim}.asok"),
            "dump_asyncheck")
        out["dump_contracts"] = len(d.get("contracts", []))
        c.set_faults("")
        w.stop.set()
        w.join(timeout=20)
        bad = _verify(c, [w])
        out["checked"] = len(w.acked)
        out["lost"] = len(bad)
        t1 = time.monotonic()
        cleared = False
        deadline = time.monotonic() + 90.0
        while time.monotonic() < deadline:
            if c.health().get("status") == "HEALTH_OK":
                cleared = True
                break
            time.sleep(0.5)
        out["cleared"] = cleared
        out["clear_s"] = round(time.monotonic() - t1, 2)
    finally:
        c.shutdown()
        faults.reset()
    out.update(_bench_overhead(seed, env_var="CEPH_TPU_ASYNCHECK",
                               device=device))
    out["ok"] = bool(
        out["static_violations"] == 0 and out["victim_named"]
        and out["stall_witnessed"] and out["overruns"] > 0
        and out["both_stacks"] and out["lost"] == 0
        and out["cleared"] and out["overhead_pct"] is not None
        and out["overhead_pct"] < 5.0)
    return out


def race_audit(seed: int = 8, soak_duration: float = 8.0,
               device="cuda") -> Dict:
    """``--race-audit``: the full drill battery — chaos soak,
    directional netsplits, SLO-escalation — with the data-race
    checker armed over every swept daemon, then the checker-overhead
    probe on the clean write lane.  The gate (red-checked via
    RACE_rNN.json): ZERO racecheck violations, zero acked-write loss
    anywhere, and checker overhead under 10%."""
    if not (racecheck.enabled() and lockdep.enabled()):
        raise RuntimeError(
            "race_audit needs CEPH_TPU_RACECHECK=1 and lockdep "
            "armed before ceph_tpu_torch imports (run via "
            "--race-audit)")
    base = racecheck.mark()
    out: Dict = {"kind": "race", "seed": seed,
                 "racecheck_enabled": True}
    phases: Dict[str, Dict] = {}
    vmark = base
    for name, run in (
            ("chaos", lambda: soak(seed=seed, duration=soak_duration,
                                   device=device)),
            ("netsplit", lambda: netsplit(seed=seed, device=device)),
            ("slow_ops", lambda: slow_ops_drill(seed=seed,
                                                device=device))):
        rec = run()
        now = len(racecheck.violations())
        phases[name] = {"ok": bool(rec.get("ok")),
                        "lost": rec.get("lost", 0),
                        "checked": rec.get("checked", 0),
                        "violations": now - vmark}
        vmark = now
    out["phases"] = phases
    new = racecheck.violations()[base:]
    out["violations"] = len(new)
    out["violation_reports"] = [v["message"] for v in new[:5]]
    out["lost"] = sum(p["lost"] or 0 for p in phases.values())
    out["checked"] = sum(p["checked"] or 0 for p in phases.values())
    d = racecheck.dump()
    out["guarded_classes"] = len(d["guarded_classes"])
    out["guarded_fields"] = d["guarded_fields"]
    out["shared_objects"] = d["shared_objects"]
    out.update(_bench_overhead(seed, device=device))
    out["ok"] = bool(
        out["violations"] == 0 and out["lost"] == 0
        and all(p["ok"] for p in phases.values())
        and out["overhead_pct"] is not None
        and out["overhead_pct"] < 10.0)
    return out


def next_run_number(directory: str) -> int:
    """One past the newest committed record of ANY series (BENCH /
    MULTICHIP / CHAOS / DRILL) so the record pairs with its PR's
    run."""
    n = 0
    for path in glob.glob(os.path.join(directory, "*_r*.json")):
        m = re.search(r"_r(\d+)\.json$", path)
        if m:
            n = max(n, int(m.group(1)))
    return n or 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="thrasher")
    ap.add_argument("--seed", type=int, default=8,
                    help="drives the thrash schedule AND the fault "
                         "plane's probability draws (default 8)")
    ap.add_argument("--duration", type=float, default=20.0,
                    help="seconds of active chaos (default 20)")
    ap.add_argument("--osds", type=int, default=5)
    ap.add_argument("--mons", type=int, default=1)
    ap.add_argument("--spec", default=DEFAULT_SPEC,
                    help="fault_inject_spec to arm during the soak")
    ap.add_argument("--host-kill", action="store_true",
                    help="run the whole-host failure drill + "
                         "degraded-read soak instead of the chaos "
                         "soak (emits DRILL_rNN.json)")
    ap.add_argument("--netsplit", action="store_true",
                    help="run the directional network-partition "
                         "drills (mon-link cut, full isolation, "
                         "flapping link) instead of the chaos soak "
                         "(emits NETSPLIT_rNN.json)")
    ap.add_argument("--slow-ops", action="store_true",
                    help="run the SLO-escalation drill (one "
                         "throttled OSD must raise SLOW_OPS + "
                         "OSD_SLOW_PING_TIME and clear to "
                         "HEALTH_OK) instead of the chaos soak "
                         "(emits SLODRILL_rNN.json)")
    ap.add_argument("--race-audit", action="store_true",
                    help="run the chaos soak + netsplit + slow-ops "
                         "drills with the data-race checker armed, "
                         "then the checker-overhead probe; the gate "
                         "is zero violations, zero acked-write loss "
                         "and <10%% overhead (emits RACE_rNN.json)")
    ap.add_argument("--loop-stall", action="store_true",
                    help="run the async-safety drill: delay one "
                         "OSD's control-lane dispatch callbacks "
                         "inside their @nonblocking scopes; the "
                         "runtime enforcer must name the victim "
                         "callback with both-end stacks, then heal "
                         "to HEALTH_OK; gates static cleanliness "
                         "and <5%% enforcement overhead (emits "
                         "ASYNC_rNN.json)")
    ap.add_argument("--write-bench", action="store_true",
                    help=argparse.SUPPRESS)  # overhead-probe subprocess
    ap.add_argument("--slo-p99-ms", type=float, default=250.0,
                    help="degraded-read soak p99 SLO in ms "
                         "(default 250)")
    ap.add_argument("--out", default=None,
                    help="output record path (default "
                         "chiprun_out/CHAOS_rNN.json, DRILL_rNN.json, "
                         "...; NN from the newest record committed at "
                         "the repository root)")
    ap.add_argument("--device", default="cuda",
                    help="where every drill's cluster runs its EC codes "
                         "and its balancer (default cuda)")
    args = ap.parse_args(argv)
    dev = args.device

    if args.write_bench:
        # hidden overhead-probe worker: bare JSON on stdout for the
        # parent race_audit(); no record file
        print(json.dumps(write_bench(seed=args.seed, device=dev)))
        return 0

    series = "DRILL" if args.host_kill else \
        "NETSPLIT" if args.netsplit else \
        "SLODRILL" if args.slow_ops else \
        "RACE" if args.race_audit else \
        "ASYNC" if args.loop_stall else "CHAOS"
    out = args.out
    if out is None:
        n = next_run_number(_ROOT)
        os.makedirs(OUT_DIR, exist_ok=True)
        out = os.path.join(OUT_DIR, f"{series}_r{n:02d}.json")
    m = re.search(r"_r(\d+)\.json$", out)
    if args.race_audit:
        rec = race_audit(seed=args.seed, device=dev)
    elif args.loop_stall:
        rec = loop_stall_drill(seed=args.seed, device=dev)
    elif args.host_kill:
        rec = drill(seed=args.seed, slo_p99_ms=args.slo_p99_ms,
                    device=dev)
    elif args.netsplit:
        rec = netsplit(seed=args.seed, device=dev)
    elif args.slow_ops:
        rec = slow_ops_drill(seed=args.seed, device=dev)
    else:
        rec = soak(seed=args.seed, duration=args.duration,
                   n_osds=args.osds, n_mons=args.mons,
                   spec=args.spec, device=dev)
    rec["n"] = int(m.group(1)) if m else 0
    with open(out, "w") as f:
        json.dump(rec, f, indent=1)
        f.write("\n")
    if args.race_audit:
        print(f"# race seed={rec['seed']} "
              f"violations={rec.get('violations')} "
              f"lost={rec.get('lost')}/{rec.get('checked')} "
              f"guarded={rec.get('guarded_classes')}cls/"
              f"{rec.get('guarded_fields')}flds "
              f"overhead={rec.get('overhead_pct')}% "
              f"({rec.get('ops_per_s_checked')} vs "
              f"{rec.get('ops_per_s_raw')} op/s) -> "
              f"{'OK' if rec['ok'] else 'FAIL'} ({out})")
    elif args.loop_stall:
        print(f"# async seed={rec['seed']} victim=osd."
              f"{rec.get('victim')} scope={rec.get('victim_scope')} "
              f"overruns={rec.get('overruns')} "
              f"static={rec.get('static_violations')} "
              f"raise={rec.get('raise_s')}s "
              f"clear={rec.get('clear_s')}s "
              f"lost={rec.get('lost')}/{rec.get('checked')} "
              f"overhead={rec.get('overhead_pct')}% -> "
              f"{'OK' if rec['ok'] else 'FAIL'} ({out})")
    elif args.slow_ops:
        print(f"# slowops seed={rec['seed']} victim=osd."
              f"{rec.get('victim')} raise={rec.get('raise_s')}s "
              f"stall={rec.get('victim_stall_s')}s "
              f"(healthy {rec.get('healthy_stall_s')}s) "
              f"clear={rec.get('clear_s')}s "
              f"lost={rec.get('lost')}/{rec.get('checked')} -> "
              f"{'OK' if rec['ok'] else 'FAIL'} ({out})")
    elif args.netsplit:
        print(f"# netsplit seed={rec['seed']} "
              f"false_markdowns={rec.get('false_markdowns')} "
              f"detect={rec.get('detect_s')}s "
              f"(bound {rec['isolation'].get('detect_bound_s')}s) "
              f"churn={rec.get('epoch_churn')} "
              f"lost={rec.get('lost')}/{rec.get('checked')} -> "
              f"{'OK' if rec['ok'] else 'FAIL'} ({out})")
    elif args.host_kill:
        soak_rec = rec.get("soak", {})
        print(f"# drill seed={rec['seed']} "
              f"mbps={rec.get('recovery_mbps')} "
              f"(serial {rec.get('recovery_mbps_serial')}, "
              f"speedup {rec.get('pipeline_speedup')}x) "
              f"lost={rec.get('lost')}/{rec.get('checked')} "
              f"converge={rec.get('converge_s')}s "
              f"soak_p99={soak_rec.get('p99_ms')}ms -> "
              f"{'OK' if rec['ok'] else 'FAIL'} ({out})")
    else:
        print(f"# chaos seed={rec['seed']} ops={rec.get('ops')} "
              f"lost={rec.get('lost')} "
              f"converge={rec.get('health_converge_s')}s "
              f"fired={rec.get('fired')} -> "
              f"{'OK' if rec['ok'] else 'FAIL'} ({out})")
    return 0 if rec["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
