"""The port's cluster tools held to ``ceph_tpu``'s: the counter registry,
critical-path attribution, telemetry, the ``rados`` and ``ceph_cli``
tools (``rados_bench``, which boots clusters of its own, is held in
``test_torch_wirecheck.py``).

One port ``MiniCluster`` for the file (3 OSDs, ``device="cpu"``: the
kernels' plain versions) with a replicated pool and a jerasure
reed_sol_van 2+1 pool, written through the port's client with every op
traced.  Its admin sockets give one snapshot that goes through both
packages' renderers; both packages' CLIs run against it.  Attribution is
also held on seeded span forests made with numpy.
"""

import json
import math
import time

import numpy as np
import pytest

import ceph_tpu.common.attribution as j_attr
import ceph_tpu.common.counters as j_counters
import ceph_tpu.tools.ceph_cli as j_cli
import ceph_tpu.tools.rados as j_rados
import ceph_tpu.tools.telemetry as j_tel
import ceph_tpu_torch.common.attribution as p_attr
import ceph_tpu_torch.common.counters as p_counters
import ceph_tpu_torch.tools.ceph_cli as p_cli
import ceph_tpu_torch.tools.rados as p_rados
import ceph_tpu_torch.tools.telemetry as p_tel
from ceph_tpu_torch.common.config import Config
from ceph_tpu_torch.services.cluster import MiniCluster
from test_telemetry import _validate_exposition
from test_torch_runtime import port_gates  # noqa: F401  (autouse)

REP, EC = 1, 2
EC_PROFILE = {"plugin": "jerasure", "technique": "reed_sol_van",
              "k": "2", "m": "1", "w": "8"}
OBJECT = 64 << 10
N_OBJECTS = 3
WAIT = 60.0


def _bytes(seed, size=OBJECT):
    return np.random.default_rng(seed).integers(
        0, 256, size, dtype=np.uint8).tobytes()


@pytest.fixture(scope="module")
def cluster():
    conf = Config()
    conf.set("osd_heartbeat_interval", 2.0)
    conf.set("osd_heartbeat_grace", 120.0)
    cl = MiniCluster(n_osds=3, config=conf, device="cpu").start()
    try:
        cl.create_replicated_pool(REP, pg_num=4, size=3)
        cl.create_ec_pool(EC, "ec21", dict(EC_PROFILE), pg_num=4)
        cl.wait_for_health_ok(timeout=WAIT)
        cli = cl.client("tools")
        for pool in (REP, EC):
            for i in range(N_OBJECTS):
                cli.put(pool, f"obj{i}", _bytes((pool, i)))
        yield cl
    finally:
        cl.shutdown()


@pytest.fixture(scope="module")
def snapshots(cluster):
    """Two snapshots a moment apart (daemonperf's rates), the daemons'
    metrics history."""
    prev = p_tel.cluster_snapshot(cluster.asok_dir)
    cur = p_tel.cluster_snapshot(cluster.asok_dir)
    return prev, cur, p_tel.gather_history(cluster.asok_dir)


def _close(a, b, tol=1e-12):
    """Equal structures, floats to ``tol`` (relative above 1)."""
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(
            _close(a[k], b[k], tol) for k in a)
    if isinstance(a, (list, tuple)):
        return isinstance(b, (list, tuple)) and len(a) == len(b) and all(
            _close(x, y, tol) for x, y in zip(a, b))
    if isinstance(a, float) or isinstance(b, float):
        return math.isclose(a, b, rel_tol=tol, abs_tol=tol)
    return a == b


# -- counters ------------------------------------------------------------

def test_registry_is_the_references_plus_the_port_families():
    port = {f: c for f, c in p_counters.REGISTRY.items()
            if f not in p_counters.PORT_FAMILIES}
    assert port == j_counters.REGISTRY
    assert p_counters.PORT_FAMILIES == {"device.caches"}
    assert p_counters.REGISTRY["device.caches"] == {
        k: p_counters.U64 for k in ("launch_plans", "lowered_maps",
                                    "matrices")}
    for logger in ("osd.3", "msgr.osd.0", "client.admin", "device",
                   "osd.hb.2", "osd.recovery.1", "obs.latency"):
        assert p_counters.family_of(logger) == \
            j_counters.family_of(logger)
    assert p_counters.family_of("device.caches") == "device.caches"
    assert p_counters.all_names() >= j_counters.all_names()


def test_registry_mirrors_the_stage_and_site_tables():
    from ceph_tpu_torch.common import copytrack, device_metrics

    assert set(p_counters.REGISTRY["obs.latency"]) == \
        set(p_attr.STAGES) | {"attributed_ops"}
    for site in copytrack.SITES:
        assert f"{site}_bytes" in p_counters.REGISTRY["obs.copy"]
        assert f"{site}_copies" in p_counters.REGISTRY["obs.copy"]
    assert set(p_counters.REGISTRY["device.caches"]) == \
        set(device_metrics.CACHES)


def test_default_columns_are_declared():
    assert p_tel.DEFAULT_COLUMNS == j_tel.DEFAULT_COLUMNS
    for glob, key, _hdr in p_tel.DEFAULT_COLUMNS:
        fam = glob.rstrip(".*").rstrip("*")
        assert p_counters.declared(fam, key), (glob, key)


def test_every_booked_counter_is_declared(snapshots):
    _prev, cur, _hist = snapshots
    booked = set()
    for daemon, data in cur["daemons"].items():
        for logger, counters in (data.get("perf") or {}).items():
            for key in counters:
                booked.add((logger, key))
                assert p_counters.declared(logger, key), \
                    (daemon, logger, key)
    loggers = {logger for logger, _k in booked}
    for want in ("mon", "osd.0", "msgr.osd.0", "client.tools",
                 "ec.engine", "obs.copy", "device.caches"):
        assert want in loggers, sorted(loggers)


# -- attribution on seeded span forests ----------------------------------

NAMES = ("client.put", "client.get", "call:ec_write", "call:shard_write",
         "send:map_update", "handle:ec_write", "handle:shard_write",
         "ec.encode", "store.commit", "mystery.span", None)


def span_forest(seed, n_traces=6):
    """Flat spans of ``n_traces`` traces: nested and parallel children,
    ``q_wait`` tags, names no stage knows, unfinished and missing
    timings, children outside their root (clock skew), orphans, and
    roots that are not client ops."""
    rng = np.random.default_rng(seed)
    spans = []
    sid = [0]

    def span(trace, parent, start, dur, depth):
        sid[0] += 1
        me = f"s{sid[0]}"
        name = NAMES[int(rng.integers(2, len(NAMES)))]
        s = {"trace_id": trace, "span_id": me, "parent_id": parent,
             "name": name, "start": start, "duration": dur,
             "finished": True}
        if name and name.startswith("handle:") and rng.random() < 0.7:
            s["tags"] = {"q_wait": float(rng.uniform(0, dur or 1e-3))}
        roll = rng.random()
        if roll < 0.05:
            s["duration"] = None
        elif roll < 0.08:
            s["duration"] = -1.0
        spans.append(s)
        if depth < 3:
            for _ in range(int(rng.integers(0, 4))):
                # skew: a child may start before or end after its parent
                c0 = start + float(rng.uniform(-0.1, 0.9)) * dur
                cd = float(rng.uniform(0.05, 0.6)) * dur
                span(trace, me, c0, cd, depth + 1)
        return s

    for t in range(n_traces):
        trace = f"t{seed}.{t}"
        t0 = float(rng.uniform(1e9, 1e9 + 100))
        root = span(trace, None, t0, float(rng.uniform(1e-4, 0.5)), 0)
        root["name"] = NAMES[int(rng.integers(0, 2))] \
            if rng.random() < 0.85 else "osd.scrub"
        root.pop("tags", None)
        if rng.random() < 0.15:
            root["finished"] = False
        if rng.random() < 0.2:   # an orphan whose parent was evicted
            span(trace, "gone", t0, 1e-3, 3)
    order = rng.permutation(len(spans))
    return [spans[i] for i in order]


@pytest.mark.parametrize("seed", range(8))
def test_attribution_folds_equal_the_reference(seed):
    spans = span_forest(seed)
    want = j_attr.fold_spans(spans)
    got = p_attr.fold_spans(spans)
    assert _close(got, want)
    assert got, "the forest folded nothing"
    for fold in got:
        assert math.isclose(sum(fold["stages"].values()), fold["total"],
                            rel_tol=1e-9, abs_tol=1e-12)
    for prefix in ("client.get", "osd."):
        assert _close(p_attr.fold_spans(spans, prefix),
                      j_attr.fold_spans(spans, prefix))
    # fold_tree on each reassembled root, unfinished ones included
    for tid in j_tel.find_trace_ids(spans):
        for root in j_tel.trace_tree(spans, tid):
            assert _close(p_attr.fold_tree(root), j_attr.fold_tree(root))
    agg_p, agg_j = p_attr.StageAggregator(), j_attr.StageAggregator()
    for fold in want:
        agg_j.add(fold)
        agg_p.add(fold)
    assert _close(agg_p.report(), agg_j.report())
    assert p_attr.render_report(agg_p.report()) == \
        j_attr.render_report(agg_j.report())


def test_stage_table_equals_the_reference():
    assert p_attr.STAGES == j_attr.STAGES
    for name in NAMES + ("call:x", "send:", "handle:", "client.", ""):
        assert p_attr.stage_of(name) == j_attr.stage_of(name), name


# -- telemetry over the live cluster -------------------------------------

def test_discover_finds_every_daemon(cluster):
    names = set(p_tel.discover(cluster.asok_dir))
    assert names == set(j_tel.discover(cluster.asok_dir))
    assert {"mon.0", "osd.0", "osd.1", "osd.2", "client.tools"} <= names
    assert all(len(p) < 108 for p in p_tel.discover(
        cluster.asok_dir).values())


def test_telemetry_renders_equal_the_reference(snapshots):
    prev, cur, hist = snapshots
    assert not cur["unreachable"]
    text = p_tel.to_prometheus(cur)
    assert text == j_tel.to_prometheus(cur)
    _validate_exposition(text)
    assert p_tel.daemonperf_view(prev, cur) == \
        j_tel.daemonperf_view(prev, cur)
    assert p_tel.net_summary(cur, prev=prev) == \
        j_tel.net_summary(cur, prev=prev)
    assert p_tel.net_summary(cur, dt=7.0) == j_tel.net_summary(cur, dt=7.0)
    assert p_tel.net_view(cur, prev=prev) == j_tel.net_view(cur, prev=prev)
    assert hist, "no daemon has a metrics history"
    assert p_tel.history_view(hist) == j_tel.history_view(hist)
    assert p_tel.top_view(prev, cur) == j_tel.top_view(prev, cur)
    assert p_tel.unattr_shares(cur) == j_tel.unattr_shares(cur)


def test_traces_and_latency_equal_the_reference(snapshots):
    _prev, cur, _hist = snapshots
    spans = p_tel.gather_spans(cur)
    assert spans == j_tel.gather_spans(cur)
    ids = p_tel.find_trace_ids(spans, "client.put")
    assert ids == j_tel.find_trace_ids(spans, "client.put")
    assert len(ids) >= 2 * N_OBJECTS
    for tid in ids:
        roots = p_tel.trace_tree(spans, tid)
        assert roots == j_tel.trace_tree(spans, tid)
        assert p_tel.render_trace(roots) == j_tel.render_trace(roots)
        assert p_tel.span_names(roots) == j_tel.span_names(roots)
    names = {n for tid in ids
             for n in p_tel.span_names(p_tel.trace_tree(spans, tid))}
    assert {"client.put", "ec.encode", "store.commit"} <= names
    rep = p_tel.latency_report(cur)
    assert _close(rep, j_tel.latency_report(cur))
    assert rep["n_ops"] >= 2 * N_OBJECTS
    # the port's span names fold: little of a write is unattributed
    total = sum(r["total_s"] for r in rep["stages"].values())
    assert rep["stages"]["unattributed"]["total_s"] <= 0.1 * total
    assert rep["stages"]["encode"]["count"] >= N_OBJECTS


def test_telemetry_cli_verbs(cluster, capsys):
    d = cluster.asok_dir
    assert p_tel.main(["--asok-dir", d, "prom"]) == 0
    _validate_exposition(capsys.readouterr().out)
    assert p_cli.main(["--asok-dir", d, "latency", "--json"]) == 0
    rep = json.loads(capsys.readouterr().out)
    assert rep["n_ops"] >= 2 * N_OBJECTS
    assert p_cli.main(["--asok-dir", d, "telemetry", "traces", "--root",
                       "client.put"]) == 0
    assert "ec.encode" in capsys.readouterr().out
    assert p_cli.main(["--asok-dir", d, "telemetry", "snapshot"]) == 0
    snap = json.loads(capsys.readouterr().out)
    assert set(snap["daemons"]) == set(p_tel.discover(d))
    assert p_cli.main(["--asok-dir", d, "daemonperf", "--interval",
                       "0.05"]) == 0
    assert capsys.readouterr().out.startswith("daemon")


# -- rados and ceph_cli against the live cluster -------------------------

def _mon(cluster):
    host, port = cluster.mon_addrs[0]
    return f"{host}:{port}"


def _run(main, argv, capsys):
    rc = main(argv)
    return rc, capsys.readouterr().out


def test_rados_put_by_the_port_get_by_the_reference(cluster, tmp_path,
                                                    capsys):
    mon = _mon(cluster)
    raw = _bytes((7, 0), OBJECT + 333)
    src, back = tmp_path / "in.bin", tmp_path / "out.bin"
    src.write_bytes(raw)
    assert p_rados.main(["--mon", mon, "-p", str(EC), "--device", "cpu",
                         "put", "cliobj", str(src)]) == 0
    assert j_rados.main(["--mon", mon, "-p", str(EC), "get", "cliobj",
                         str(back)]) == 0
    assert back.read_bytes() == raw
    back.unlink()
    assert p_rados.main(["--mon", mon, "-p", str(EC), "--device", "cpu",
                         "get", "cliobj", str(back)]) == 0
    assert back.read_bytes() == raw
    for pool, argv in ((REP, ["ls"]), (EC, ["ls"]), (REP, ["stat", "obj0"]),
                       (EC, ["stat", "obj1"]), (EC, ["stat", "cliobj"]),
                       (EC, ["df"])):
        p = _run(p_rados.main, ["--mon", mon, "-p", str(pool),
                                "--device", "cpu"] + argv, capsys)
        j = _run(j_rados.main, ["--mon", mon, "-p", str(pool)] + argv,
                 capsys)
        assert p == j, (argv, pool)
        if argv == ["ls"]:
            names = p[1].split()
            assert [f"obj{i}" for i in range(N_OBJECTS)] == \
                [n for n in names if n.startswith("obj")]
            assert ("cliobj" in names) == (pool == EC)
    capsys.readouterr()


def _without_times(text):
    """The output with fields that hold times left out."""
    out = []
    for line in text.splitlines():
        if any(k in line for k in ('"ts"', "stamp", "_at", "age")):
            continue
        out.append(line)
    return out


@pytest.mark.parametrize("verb", [["status"], ["health"], ["df"],
                                  ["osd", "tree"], ["pool", "ls"],
                                  ["progress"]],
                         ids=lambda v: "_".join(v))
def test_ceph_cli_equals_the_reference(cluster, capsys, verb):
    """Both CLIs print the same; a PG stats report that lands between
    the two calls changes the monitor's answer, so a pair that differs
    is asked again (a few times) before it counts as a difference."""
    mon = _mon(cluster)
    for _attempt in range(5):
        p_rc, p_out = _run(p_cli.main, ["--mon", mon] + verb, capsys)
        j_rc, j_out = _run(j_cli.main, ["--mon", mon] + verb, capsys)
        if _without_times(p_out) == _without_times(j_out):
            break
        time.sleep(0.5)
    assert p_rc == j_rc == 0
    assert _without_times(p_out) == _without_times(j_out)
    assert p_out.strip()
