"""The port's host runtime against ``ceph_tpu``'s: Config, tracing, the
op scheduler and tracker, throttles, backoff, versions, the admin
socket, the watchdog, asyncheck, the profiler, metrics history and the
fault plane's Config and admin-socket doors.

The port keeps its own process-wide singletons (bufpool, open spans,
lockdep, racecheck), which ``tests/conftest.py`` does not watch:
``port_gates`` applies the same checks to them and is imported, autouse,
by every test file of the port's runtime and messenger.
"""

import io
import json
import random
import tempfile
import threading
import time

import numpy as np
import pytest

from ceph_tpu.analysis import asyncheck as j_asyncheck
from ceph_tpu.analysis import faults as j_faults
from ceph_tpu.analysis import watchdog as j_watchdog
from ceph_tpu.common import admin_socket as j_asok
from ceph_tpu.common import backoff as j_backoff
from ceph_tpu.common import config as j_config
from ceph_tpu.common import context as j_context
from ceph_tpu.common import metrics_history as j_mh
from ceph_tpu.common import op_queue as j_opq
from ceph_tpu.common import op_tracker as j_opt
from ceph_tpu.common import profiler as j_prof
from ceph_tpu.common import throttle as j_throttle
from ceph_tpu.common import tracing as j_tracing
from ceph_tpu.common import version as j_version
from ceph_tpu_torch.analysis import asyncheck as p_asyncheck
from ceph_tpu_torch.analysis import faults as p_faults
from ceph_tpu_torch.analysis import lockdep as p_lockdep
from ceph_tpu_torch.analysis import racecheck as p_racecheck
from ceph_tpu_torch.analysis import watchdog as p_watchdog
from ceph_tpu_torch.common import admin_socket as p_asok
from ceph_tpu_torch.common import backoff as p_backoff
from ceph_tpu_torch.common import bufpool as p_bufpool
from ceph_tpu_torch.common import config as p_config
from ceph_tpu_torch.common import context as p_context
from ceph_tpu_torch.common import metrics_history as p_mh
from ceph_tpu_torch.common import op_queue as p_opq
from ceph_tpu_torch.common import op_tracker as p_opt
from ceph_tpu_torch.common import profiler as p_prof
from ceph_tpu_torch.common import throttle as p_throttle
from ceph_tpu_torch.common import tracing as p_tracing
from ceph_tpu_torch.common import version as p_version

OPTIONS = sorted(j_config.OPTIONS)


@pytest.fixture(autouse=True)
def port_gates():
    """The lockdep, racecheck, bufpool and span gates of
    ``tests/conftest.py``, on the port's singletons: a test fails on a
    new lock-order or data-race violation, on a receive segment still
    held and on a span still open at its end (after a short drain
    window for replies in flight).  Both packages' failpoints are
    disarmed afterwards."""
    base = len(p_lockdep.violations())
    race_base = p_racecheck.mark()
    segs = len(p_bufpool.outstanding())
    spans = {id(s) for _svc, s in p_tracing.active_spans()}
    yield
    p_faults.reset()
    j_faults.reset()
    vs = p_lockdep.violations()[base:]
    if vs:
        p_lockdep.clear_violations()
        pytest.fail("port lockdep: " + "\n".join(v["message"] for v in vs))
    msg = p_racecheck.gate_check(race_base)
    if msg is not None:
        pytest.fail("port " + msg)
    deadline = time.monotonic() + 2.0
    held = p_bufpool.outstanding()
    new_spans = [s for _svc, s in p_tracing.active_spans()
                 if id(s) not in spans]
    while (len(held) > segs or new_spans) and time.monotonic() < deadline:
        time.sleep(0.02)
        held = p_bufpool.outstanding()
        new_spans = [s for _svc, s in p_tracing.active_spans()
                     if id(s) not in spans]
    if len(held) > segs:
        pytest.fail(f"port bufpool: {len(held) - segs} segment(s) still "
                    f"held: {held[:8]}")
    if new_spans:
        p_tracing.abandon_all_active()
        pytest.fail(f"port tracing: {len(new_spans)} span(s) left open: "
                    f"{[s.name for s in new_spans][:8]}")


@pytest.fixture(scope="module", autouse=True)
def _watchdogs():
    """Each package's global stall scanner (a daemon thread that every
    admin socket starts), started once for the file."""
    j_watchdog.start_global(30.0)
    p_watchdog.start_global(30.0)


def short_dir():
    """A temporary directory whose socket paths fit AF_UNIX's 107
    bytes."""
    return tempfile.TemporaryDirectory(prefix="asok", dir="/tmp")


def both(fn):
    """``fn`` applied to (ceph_tpu's module set, the port's)."""
    return fn(J), fn(P)


class _Pkg:
    def __init__(self, **mods):
        self.__dict__.update(mods)


J = _Pkg(config=j_config, tracing=j_tracing, opq=j_opq, opt=j_opt,
         throttle=j_throttle, backoff=j_backoff, version=j_version,
         asok=j_asok, context=j_context, watchdog=j_watchdog,
         asyncheck=j_asyncheck, prof=j_prof, mh=j_mh, faults=j_faults)
P = _Pkg(config=p_config, tracing=p_tracing, opq=p_opq, opt=p_opt,
         throttle=p_throttle, backoff=p_backoff, version=p_version,
         asok=p_asok, context=p_context, watchdog=p_watchdog,
         asyncheck=p_asyncheck, prof=p_prof, mh=p_mh, faults=p_faults)


# -- config -----------------------------------------------------------

def test_config_schema_equals_ceph_tpu():
    def rows(pkg):
        return [(o.name, o.type_, o.default, o.desc, o.level)
                for o in pkg.config.OPTIONS.values()]

    j, p = both(rows)
    assert p == j
    assert p_config.ENV_PREFIX == j_config.ENV_PREFIX


def _other_value(opt):
    if opt.type_ is bool:
        return not opt.default
    if opt.type_ is int:
        return opt.default + 3
    if opt.type_ is float:
        return opt.default * 2 + 0.5
    return "x,y"


@pytest.mark.parametrize("name", OPTIONS)
def test_config_set_observe_and_reset(name):
    """``set`` (from a string, as ``config set`` gives it), observers,
    ``show`` and ``rm_override`` give what ``ceph_tpu``'s give."""
    opt = j_config.OPTIONS[name]
    value = str(_other_value(opt))

    def run(pkg):
        c = pkg.config.Config()
        seen = []
        c.add_observer(name, lambda n, v: seen.append((n, v)))
        c.set(name, value)
        shown = c.show()[name]
        c.rm_override(name)
        return shown, seen, c.show()[name], c.source_of(name)

    j, p = both(run)
    assert p == j
    assert p[0]["source"] == "override" and p[3] == "default"


@pytest.mark.parametrize("form", ["json", "ini"])
def test_config_load_file(form, tmp_path):
    path = tmp_path / f"ceph.{form}"
    entries = {"debug_osd": "7", "osd_heartbeat_grace": "0.25",
               "mgr_modules": "balancer,status", "lockdep": "yes",
               "not_an_option": "1"}
    if form == "json":
        path.write_text(json.dumps(entries))
    else:
        path.write_text("[global]\n# comment\n" + "\n".join(
            f"{k.replace('_', ' ')} = {v}  ; trailing"
            for k, v in entries.items()))

    def run(pkg):
        c = pkg.config.Config()
        return c.load_file(str(path)), c.show()

    j, p = both(run)
    assert p == j and p[0] == 4
    assert p[1]["debug_osd"] == {**p[1]["debug_osd"], "value": 7,
                                 "source": "file"}


def test_config_environment(monkeypatch):
    monkeypatch.setenv(p_config.ENV_PREFIX + "DEBUG_MON", "4")
    monkeypatch.setenv(p_config.ENV_PREFIX + "PROFILER_HZ", "250")
    j, p = both(lambda pkg: pkg.config.Config().show())
    assert p == j
    assert p["debug_mon"]["source"] == "env"
    assert p["profiler_hz"]["value"] == 250.0


def test_config_takes_ceph_tpus_overrides(tmp_path):
    """Whatever ``ceph_tpu``'s ``show()`` reports as set (through
    ``load_file`` or ``set``) goes into the port's Config through the
    same door and shows the same values and sources."""
    path = tmp_path / "ceph.conf"
    path.write_text("debug_crush = 3\ntrace_ring_size = 64\n")
    ref = j_config.Config()
    ref.load_file(str(path))
    ref.set("trace_ring_size", 128)
    ref.set("fault_inject_spec", "osd.slow_op=p:0.1,delay:0.05")
    ref.set("asyncheck_loop_budget_ms", "12.5")
    port = p_config.Config()
    shown = ref.show()
    file_set = {k: v["value"] for k, v in shown.items()
                if ref.source_of(k) == "override" and k in ref._file}
    port.load_file(str(path))
    for name, row in shown.items():
        if row["source"] == "override":
            port.set(name, row["value"])
    assert port.show() == shown
    assert file_set == {"trace_ring_size": 128}


@pytest.mark.parametrize("call", ["get", "set", "source", "bad_int",
                                  "bad_float"])
def test_config_errors(call):
    def run(pkg):
        c = pkg.config.Config()
        try:
            if call == "get":
                c.get("no_such_option")
            elif call == "set":
                c.set("no_such_option", 1)
            elif call == "source":
                return c.source_of("no_such_option")
            elif call == "bad_int":
                c.set("debug_osd", "five")
            else:
                c.set("osd_heartbeat_grace", "soon")
        except (KeyError, ValueError) as e:
            return type(e).__name__, str(e)
        return None

    j, p = both(run)
    assert p == j and p is not None


# -- tracing ----------------------------------------------------------

def _span_tree(pkg, sample_rate):
    """One op's spans: a root, a nested child with tags and events, a
    child that raises, a remote child through a wire carrier, a
    require_parent span with and without a parent, and a pool worker
    adopting the root through ``scope``.  Returns the tracer's dump with
    ids renumbered in order of appearance and times dropped."""
    tr = pkg.tracing.Tracer("osd.0", ring_size=16, sample_rate=sample_rate)
    remote = pkg.tracing.Tracer("osd.1", ring_size=16)
    with tr.start_span("handle:ec_write", tags={"frm": "client.1"}) as root:
        with tr.start_span("ec.encode", tags={"bytes": 4096}) as sp:
            sp.log("prepared")
            sp.set_tag("k", 8)
        with pytest.raises(RuntimeError):
            with tr.start_span("store.write"):
                raise RuntimeError("disk")
        carrier = tr.inject(root)
        with remote.start_span("handle:sub_write", child_of=carrier,
                               require_parent=True):
            pass
        with tr.start_span("send:ack", require_parent=True):
            pass
        box = []

        def worker():
            with tr.scope(root):
                with tr.start_span("pool.job") as job:
                    box.append(job.parent_id)

        t = threading.Thread(target=worker)
        t.start()
        t.join(5)
        assert box == [root.span_id]
    noop = tr.start_span("heartbeat", require_parent=True)
    with noop:
        pass
    ids = {}

    def canon(i):
        if i is None:
            return None
        return ids.setdefault(i, len(ids))

    out = []
    for t_ in (tr, remote):
        d = t_.dump()
        out.append({
            "service": d["service"], "started": d["started"],
            "finished": d["finished"], "sampled_out": d["sampled_out"],
            "active": d["active"],
            "spans": [(s["name"], canon(s["trace_id"]), canon(s["span_id"]),
                       canon(s["parent_id"]), s["finished"], s["tags"],
                       [e["event"] for e in s["events"]])
                      for s in d["spans"]]})
    return out, tr.inject(noop)


@pytest.mark.parametrize("sample_rate", [0.0, 1.0])
def test_span_trees_equal_ceph_tpu(sample_rate):
    j, p = both(lambda pkg: _span_tree(pkg, sample_rate))
    assert p == j
    spans = p[0][0]["spans"]
    assert len(spans) == (5 if sample_rate else 0)
    assert p[1] is None  # the no-op span carries no context


# -- the op scheduler -------------------------------------------------

QOS = {"client": (40.0, 1.0, 0.0), "recovery": (20.0, 0.5, 100.0),
       "scrub": (0.0, 0.2, 50.0), "bulk": (0.0, 2.0, 0.0)}


def _mclock_order(pkg, seed, custom, requeue_every):
    """Seeded arrivals of four classes into a ``MClockQueue`` served at
    a fixed rate; every ``requeue_every``-th item raises ``Requeue`` on
    its first service and goes back to the tail of its class, as
    ``OpScheduler``'s workers put it back."""
    opq = pkg.opq
    if custom:
        q = opq.MClockQueue({c: opq.ClientInfo(*v) for c, v in QOS.items()})
    else:
        q = opq.default_osd_queue()
    rng = np.random.default_rng(seed)
    classes = sorted(QOS)
    arrivals = sorted(
        (float(t), classes[int(c)], i) for i, (t, c) in enumerate(
            zip(rng.uniform(0, 1.0, 120), rng.integers(0, 4, 120))))
    order, requeued, now, ai = [], set(), 0.0, 0
    while ai < len(arrivals) or len(q):
        while ai < len(arrivals) and arrivals[ai][0] <= now:
            t, cls, i = arrivals[ai]
            q.enqueue(cls, i, t)
            ai += 1
        got = q.dequeue(now)
        if got is not None:
            cls, item = got
            try:
                if item % requeue_every == 0 and item not in requeued:
                    requeued.add(item)
                    raise opq.Requeue()
                order.append((cls, item))
            except opq.Requeue:
                q.enqueue(cls, item, now)
            continue
        nxt = q.next_ready_at()
        now = min(now + 0.004, nxt) if nxt != float("inf") else now + 0.004
        if ai < len(arrivals) and not len(q):
            now = max(now, arrivals[ai][0])
    return order


@pytest.mark.parametrize("requeue_every", [7, 1000])
@pytest.mark.parametrize("custom", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mclock_dequeue_order_equals_ceph_tpu(seed, custom, requeue_every):
    j, p = both(lambda pkg: _mclock_order(pkg, seed, custom, requeue_every))
    assert p == j
    assert sorted(i for _c, i in p) == list(range(120))


def test_op_scheduler_requeue_and_shutdown():
    """A job that raises ``Requeue`` twice is served on its third run;
    an op queued at shutdown is drained with the abandonment error."""
    def run(pkg):
        s = pkg.opq.OpScheduler(n_workers=1)
        tries = []

        def job():
            tries.append(1)
            if len(tries) < 3:
                raise pkg.opq.Requeue()
            return "served"

        out = [s.submit("client", job), len(tries),
               s.submit("scrub", lambda: 5)]
        served = dict(s.served)
        s.shutdown()
        with pytest.raises(RuntimeError, match="shut down"):
            s.submit("client", lambda: 1)
        for w in s._workers:
            w.join(5)
        return out, served

    j, p = both(run)
    assert p == j == (["served", 3, 5], p[1])
    assert p[1]["client"] >= 3


def _inline_final_run(pkg, wait):
    """An inline ``submit`` whose job raises ``Requeue`` on its first
    run, having stopped the scheduler; its final run then blocks on an
    event the test holds.  Meanwhile another thread asks for
    ``depths()``, which takes the scheduler's cv.  Returns (whether
    ``depths()`` returned within ``wait`` s, what it returned, what
    ``submit`` returned); the event is set before the threads are
    joined, so nothing is left behind."""
    s = pkg.opq.OpScheduler(n_workers=1)
    release, in_final = threading.Event(), threading.Event()
    runs, got = [], {}

    def fn():
        runs.append(1)
        if len(runs) == 1:
            s.shutdown()          # the scheduler stops meanwhile
            raise pkg.opq.Requeue()
        in_final.set()
        release.wait(60)
        return "final"

    def submit():
        got["submit"] = s.submit("client", fn)

    def depths():
        got["depths"] = s.depths()

    sub = threading.Thread(target=submit)
    asker = threading.Thread(target=depths)
    try:
        sub.start()
        assert in_final.wait(30), "the final run never started"
        asker.start()
        asker.join(wait)
        returned = not asker.is_alive()
    finally:
        release.set()
        sub.join(30)
        if asker.ident is not None:
            asker.join(30)
        for w in s._workers:
            w.join(30)
    assert not sub.is_alive() and not asker.is_alive()
    return returned, got.get("depths"), got.get("submit"), len(runs)


def test_inline_final_run_leaves_the_cv_free():
    """R4: ``ceph_tpu``'s inline path runs a job's final run (the
    scheduler stopped while the job waited) inside ``with self._cv``,
    so every caller of the cv (``depths``, the workers, ``shutdown``)
    waits for the job; the port runs it outside the cv, as both
    packages' workers do.  The reference's stall is shown by a bounded
    wait: ``depths()`` stays blocked for the whole of it."""
    held = _inline_final_run(J, wait=1.0)
    free = _inline_final_run(P, wait=30.0)
    assert held[0] is False
    assert free[0] is True
    # once the event is set, both come to the same end
    assert held[1:] == free[1:] == ({}, "final", 2)

def _masked(obj):
    """Times dropped from tracker dumps (they differ run to run)."""
    if isinstance(obj, dict):
        return {k: _masked(v) for k, v in obj.items()
                if k not in ("time", "initiated_at", "age", "oldest_age")}
    if isinstance(obj, list):
        return [_masked(v) for v in obj]
    return obj


@pytest.mark.parametrize("slow", [0.0, 60.0])
def test_op_tracker_dumps_equal_ceph_tpu(slow):
    def run(pkg):
        t = pkg.opt.OpTracker(history_size=3, history_slow_threshold=slow,
                              slow_history_size=2)
        ops = [t.create("osd_op", f"write obj{i}") for i in range(5)]
        for i, op in enumerate(ops):
            op.mark_event("queued_for_pg")
            if i % 2 == 0:
                op.mark_event("reached_pg")
        for op in ops[:4]:
            op.finish()
        ops[0].finish()  # idempotent
        with t.create("osd_op", "read obj9") as op:
            op.mark_event("started")
        out = [t.dump_ops_in_flight(), t.dump_historic_ops(),
               t.dump_historic_slow_ops(), t.slow_summary()]
        ops[4].finish()
        return _masked(out)

    j, p = both(run)
    assert p == j
    assert p[0]["num_ops"] == 1 and p[1]["served_total"] == 5


@pytest.mark.parametrize("seq", [
    [("get_or_fail", 6), ("get_or_fail", 5), ("put", 3), ("get_or_fail", 5),
     ("current",)],
    [("get", 4, 0.01), ("get", 7, 0.01), ("reset_max", 20), ("get", 7, 0.01),
     ("current",), ("drained", 0.01)],
    [("hold", 10), ("get_or_fail", 10), ("put", 100), ("current",),
     ("reset_max", 0), ("get_or_fail", 1000), ("drained", 0.01)],
])
def test_throttle_equals_ceph_tpu(seq):
    def run(pkg):
        th = pkg.throttle.Throttle("t", 10)
        out = []
        for op, *args in seq:
            if op == "current":
                out.append(th.get_current())
            elif op == "drained":
                out.append(th.wait_until_drained(*args))
            elif op == "hold":
                with th.hold(*args):
                    out.append(th.get_current())
            else:
                out.append(getattr(th, op)(*args))
        return out

    j, p = both(run)
    assert p == j


@pytest.mark.parametrize("seed", [0, 1, 7, 42])
def test_backoff_seeded_jitter_equals_ceph_tpu(seed):
    def run(pkg):
        bo = pkg.backoff.Backoff(base=0.01, cap=0.2, deadline=60.0,
                                 rng=random.Random(seed))
        draws = [bo.next_interval() for _ in range(24)]
        spent = pkg.backoff.Backoff(base=0.01, deadline=0.0)
        return draws, spent.sleep(), spent.expired()

    j, p = both(run)
    assert p == j
    assert all(0.01 <= d <= 0.2 for d in p[0]) and p[1:] == (False, True)


@pytest.mark.parametrize("epoch", [0, 1, 123456])
def test_versions_order_as_ceph_tpu(epoch):
    v = j_version.make_version(epoch)
    assert p_version.NULL_VERSION == j_version.NULL_VERSION
    assert p_version.bump(v) == j_version.bump(v)
    mine = p_version.make_version(epoch)
    later = p_version.make_version(epoch + 1)
    assert p_version.NULL_VERSION < v <= mine < p_version.bump(mine) < later
    assert len(mine) == len(v) == 33


# -- the admin socket and the Context ---------------------------------

@pytest.fixture(scope="module")
def contexts():
    """A Context of each package with its admin socket started (the
    metrics-history sampler off: its dumps hold wall times)."""
    with short_dir() as d:
        out = []
        for pkg in (J, P):
            conf = pkg.config.Config()
            conf.set("metrics_history_interval", 0)
            ctx = pkg.context.Context("osd.3", config=conf,
                                      admin_dir=f"{d}/{len(out)}")
            ctx.start_admin_socket()
            out.append(ctx)
        yield out
        for ctx in out:
            ctx.shutdown()


def test_port_asok_directory_is_its_own():
    j = j_context.Context("osd.9").admin_socket_path
    p = p_context.Context("osd.9").admin_socket_path
    assert p != j and p.endswith("ceph_tpu_torch_asok/osd.9.asok")


@pytest.mark.parametrize("cmd,args", [
    ("help", {}),
    ("config show", {}),
    ("config get", {"key": "debug_osd"}),
    ("config set", {"key": "debug_osd", "value": "5"}),
    ("config get", {"key": "no_such_option"}),
    ("dump_blocked", {"threshold": 3600, "stacks": False}),
    ("fault", {"mode": "list"}),
    ("profile", {"cmd": "bogus"}),
    ("no such command", {}),
])
def test_admin_socket_replies_equal_ceph_tpu(contexts, cmd, args):
    replies = [ctx.start_admin_socket().request(
        ctx.admin_socket_path, cmd, **args) for ctx in contexts]
    j, p = replies
    if cmd == "no such command":
        assert p["error"] == j["error"] and "have" in p
        return
    assert p == j


def test_admin_socket_perf_and_log_dumps(contexts):
    for ctx in contexts:
        ctx.logger("osd").derr("shard write failed")
        pc = ctx.perf.create("osd")
        pc.add_u64_counter("op_w")
        pc.inc("op_w", 3)
    j, p = [c.start_admin_socket().request(c.admin_socket_path, "perf dump",
                                           logger="osd") for c in contexts]
    assert p == j == {"osd": {"op_w": 3}}
    j, p = [c.start_admin_socket().request(c.admin_socket_path, "log dump")
            for c in contexts]
    assert p["entries"] == j["entries"] >= 1
    assert "shard write failed" in p["dump"]


def test_profiler_through_the_admin_socket(contexts):
    ctx = contexts[1]
    path = ctx.admin_socket_path
    assert p_asok.AdminSocket.request(path, "profile", cmd="start",
                                      hz="200")["started"]
    time.sleep(0.05)
    assert p_asok.AdminSocket.request(path, "profile", cmd="stop") == {
        "stopped": True}
    dump = p_asok.AdminSocket.request(path, "profile", cmd="dump")
    assert dump["hz"] == 200.0 and dump["samples"] >= 1
    assert not dump["running"] and dump["folded"]


def test_context_stops_its_threads():
    with short_dir() as d:
        conf = p_config.Config()
        conf.set("metrics_history_interval", 0.05)
        ctx = p_context.Context("osd.4", config=conf, admin_dir=d)
        before = {t.name for t in threading.enumerate()}
        ctx.start_admin_socket()
        ctx.profiler.profile_start(hz=100)
        time.sleep(0.1)
        started = {t.name for t in threading.enumerate()} - before
        assert all(t.daemon for t in threading.enumerate()
                   if t.name in started)
        assert ctx.metrics_history.dump()["n"] >= 2
        ctx.shutdown()
        for t in threading.enumerate():
            if t.name in started:
                t.join(2)
        assert not {t.name for t in threading.enumerate()} & started


# -- watchdog, asyncheck, profiler, metrics history -------------------

def test_watchdog_reports_equal_ceph_tpu():
    def run(pkg):
        wd = pkg.watchdog.Watchdog(threshold=0.5, interval=60,
                                   stream=io.StringIO())
        with pkg.watchdog.section("osd.0:ec_write"):
            fresh = wd.poll(now=time.monotonic() + 1.0)
            again = wd.poll(now=time.monotonic() + 2.0)
            blocked = pkg.watchdog.dump_blocked(0.0, with_stacks=False)
        text = wd.stream.getvalue()
        return ([(r["kind"], r["name"]) for r in fresh], again,
                [s["name"] for s in blocked["stalled_sections"]],
                "=== watchdog: 1 stalled" in text)

    j, p = both(run)
    assert p == j == ([("section", "osd.0:ec_write")], [],
                      ["osd.0:ec_write"], True)


def test_asyncheck_records_equal_ceph_tpu():
    def run(pkg):
        ac = pkg.asyncheck
        base = ac.mark()
        ac.enable(True)
        try:
            with ac.scope("handler:osd.0:ping", budget_ms=0.01):
                t = time.monotonic()
                while time.monotonic() - t < 0.002:
                    pass
            sc = ac._Scope("handler:osd.0:stall", 0.001)
            with ac._slock:
                ac._scopes[id(sc)] = sc
            try:
                made = ac.Enforcer().poll(now=sc.start + 1.0)
            finally:
                with ac._slock:
                    ac._scopes.pop(id(sc), None)
            dump = ac.dump()
        finally:
            ac.enable(False)
            msg = ac.gate_check(base)
        recs = [(v["kind"], v["scope"], v["budget_ms"]) for v in
                dump["violations"][-2:]]
        return recs, [m["scope"] for m in made], sorted(dump), \
            msg is not None

    j, p = both(run)
    assert p == j
    assert p[0] == [("overrun", "handler:osd.0:ping", 0.01),
                    ("stall", "handler:osd.0:stall", 1.0)]


@pytest.mark.parametrize("name", ["msgr-dispatch:osd.1_3", "mclock-w0",
                                  "msgr-rd:client.12", "MainThread",
                                  "", "admin:/tmp/x.asok"])
def test_profiler_thread_roles_equal_ceph_tpu(name):
    assert p_prof.thread_role(name) == j_prof.thread_role(name)


def test_profiler_dump_and_flame_equal_ceph_tpu():
    dumps = {"osd.0": {"folded": ["msgr-dispatch;a.py:f;b.py:g 7",
                                  "mclock-w;c.py:h 2", "bad line x"]},
             "osd.1": {"folded": ["msgr-dispatch;a.py:f;b.py:g 3"]}}
    j, p = both(lambda pkg: (pkg.prof.merge_folded(dumps),
                             pkg.prof.render_flame(pkg.prof.merge_folded(
                                 dumps)),
                             pkg.prof.WallclockProfiler(
                                 hz=50, seed=3).profile_dump()))
    assert p == j


def _samples():
    out = []
    for i in range(4):
        out.append({"ts": 1000.0 + i, "mono": 50.0 + 0.5 * i, "perf": {
            "msgr.osd.0": {"frames_in": 10 * i * i, "bytes_in": 4096 * i,
                           "idle": 1,
                           "dispatch_lat": {"buckets": [i, 2 * i, 0],
                                            "min": 1e-6},
                           "op_lat": {"avgcount": i, "sum": 0.25 * i}},
            "obs.bufpool": {"acquires": 3 * i, "releases": 3 * i}}})
    return out


def test_metrics_history_views_equal_ceph_tpu():
    s = _samples()
    j, p = both(lambda pkg: (pkg.mh.derive_rates(s), pkg.mh.hist_deltas(s),
                             pkg.mh.derive_rates(s[:1])))
    assert p == j
    assert p[1]["msgr.osd.0.dispatch_lat"]["count"] == 9


def test_metrics_history_ring():
    h = p_mh.MetricsHistory("osd.5", interval=60, retention=3)
    for _ in range(5):
        h.sample()
    d = h.dump()
    assert (d["n"], d["retention"], d["interval"]) == (3, 3, 60)
    assert set(d["samples"][0]) == {"ts", "mono", "perf", "shapes"}
    assert set(d) == set(j_mh.MetricsHistory("x").dump())


# -- the fault plane's Config and admin-socket doors -------------------

SPECS = ["osd.slow_op=p:0.25,delay:0.01",
         "msgr.drop_frame=count:3,who:osd.2;msgr.dup_frame=p:0.5",
         "os.fsync_eio=oneshot"]


@pytest.mark.parametrize("door", ["config", "admin_socket"])
@pytest.mark.parametrize("spec", SPECS)
def test_fault_doors_arm_and_fire_as_ceph_tpu(contexts, spec, door):
    """The same spec, set through each package's Config (``install``'s
    observer) or admin socket (``wire``'s ``fault`` command), gives the
    same armed listing and, for the same seed, the same fire
    sequence."""
    names = [part.split("=")[0] for part in spec.split(";")]
    out = []
    for pkg, ctx in zip((J, P), contexts):
        pkg.faults.reset()
        path = ctx.admin_socket_path
        if door == "config":
            ctx.conf.set("fault_inject_spec", spec)
            armed = pkg.faults.list_faults()
            ctx.conf.set("fault_inject_spec", "")
            assert pkg.faults.list_faults()["armed"] == {}
            ctx.conf.set("fault_inject_spec", spec)
            pkg.faults.seed(5)
        else:
            armed = pkg.asok.AdminSocket.request(path, "fault", mode="set",
                                                 spec=spec)
            assert pkg.asok.AdminSocket.request(
                path, "fault", mode="seed", value=5) == {"seeded": 5}
        fired = [(n, w, pkg.faults.fires(n, w)) for _ in range(20)
                 for n in names for w in ("osd.1", "osd.2")]
        listing = pkg.asok.AdminSocket.request(path, "fault", mode="list")
        cleared = pkg.asok.AdminSocket.request(path, "fault", mode="clear")
        ctx.conf.set("fault_inject_spec", "")
        out.append((armed, fired, listing, cleared))
    assert out[1] == out[0]
    assert out[1][0] and any(f for *_x, f in out[1][1])
