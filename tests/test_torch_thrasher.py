"""The port's failure drills (``ceph_tpu_torch/tools/thrasher.py``) held
to ``tools/thrasher.py``: the fault spec and its parse through both
packages' fault planes, every drill's ``Config`` option for option,
``_percentile``, ``next_run_number``, the command line's options, and
one seeded chaos soak of the port on the CPU (``device="cpu"``: the
kernels' plain versions) whose record has the reference's keys and
loads through ``tools/perf_history.py`` as a committed record does.

One live cluster in the file (the soak's).  The drills that boot
several clusters mirror the reference's slow tests
(``test_faults.py``, ``test_recovery.py``) and, like them, are left
out of tier 1.
"""

import argparse
import dataclasses
import inspect
import json
import pathlib

import numpy as np
import pytest

import ceph_tpu.analysis.faults as j_faults
import ceph_tpu.common.config as j_config
import ceph_tpu_torch.analysis.faults as p_faults
import ceph_tpu_torch.tools.thrasher as p_thr
from test_torch_runtime import port_gates  # noqa: F401  (autouse)
from tools import perf_history
from tools import thrasher as j_thr

REPO = pathlib.Path(__file__).resolve().parents[1]
BALANCER_KEYS = {"balancer_rounds", "balancer_pauses",
                 "balancer_proposals", "balancer_degraded_proposals"}


def test_default_spec_and_its_parse_equal_the_reference():
    assert p_thr.DEFAULT_SPEC == j_thr.DEFAULT_SPEC
    want = {n: dataclasses.asdict(fp)
            for n, fp in j_faults.parse_spec(j_thr.DEFAULT_SPEC).items()}
    got = {n: dataclasses.asdict(fp)
           for n, fp in p_faults.parse_spec(p_thr.DEFAULT_SPEC).items()}
    assert got == want and len(got) == 5


@pytest.mark.parametrize("conf", ["_conf", "_drill_conf(1)",
                                  "_drill_conf(3)", "_netsplit_conf"])
def test_drill_configs_equal_the_reference(conf):
    name, _, arg = conf.partition("(")
    args = (int(arg[:-1]),) if arg else ()
    want = getattr(j_thr, name)(*args)
    got = getattr(p_thr, name)(*args)
    options = sorted(j_config.OPTIONS)
    assert {o: got[o] for o in options} == {o: want[o] for o in options}
    assert {o: got.source_of(o) for o in options} == \
        {o: want.source_of(o) for o in options}


@pytest.mark.parametrize("q", [0.0, 0.25, 0.5, 0.99, 1.0])
@pytest.mark.parametrize("n", [0, 1, 2, 7, 100, 1001])
def test_percentile_equals_the_reference(n, q):
    vals = sorted(np.random.default_rng(n).exponential(0.05, n).tolist())
    assert p_thr._percentile(vals, q) == j_thr._percentile(vals, q)


@pytest.mark.parametrize("names", [
    [], ["nope.json", "BENCH.json"], ["BENCH_r03.json"],
    ["CHAOS_r12.json", "DRILL_r11.json", "x_r7.json", "y_r007.json"],
    ["RACE_r18.json", "ASYNC_r18.json", "notes_r99.txt"]])
def test_next_run_number_equals_the_reference(tmp_path, names):
    for name in names:
        (tmp_path / name).write_text("{}")
    got = p_thr.next_run_number(str(tmp_path))
    assert got == j_thr.next_run_number(str(tmp_path))
    assert p_thr.next_run_number(str(REPO)) == \
        j_thr.next_run_number(str(REPO))


def _options(main, monkeypatch):
    """The parser ``main`` builds, caught at its ``parse_args``."""
    seen = []

    class _Caught(Exception):
        pass

    def catch(self, *a, **kw):
        seen.append(self)
        raise _Caught

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", catch)
    with pytest.raises(_Caught):
        main([])
    monkeypatch.undo()
    return {a.dest: (tuple(a.option_strings), a.default, a.type,
                     type(a).__name__, a.help == argparse.SUPPRESS)
            for a in seen[0]._actions}


def test_command_line_options_equal_the_reference_plus_device(monkeypatch):
    want = _options(j_thr.main, monkeypatch)
    got = _options(p_thr.main, monkeypatch)
    assert got.pop("device") == (("--device",), "cuda", None,
                                 "_StoreAction", False)
    assert got == want
    assert p_thr.OUT_DIR == str(REPO / "chiprun_out")


@pytest.mark.parametrize("fn", [
    "soak", "_kill_host_phase", "host_kill_drill", "degraded_read_soak",
    "drill", "_mon_partition_phase", "_isolation_phase", "_flap_phase",
    "slow_ops_drill", "netsplit", "write_bench", "_bench_overhead",
    "loop_stall_drill", "race_audit"])
def test_every_drill_defaults_to_the_card(fn):
    """Each function that boots a cluster (or, for the overhead probe,
    its subprocesses) takes the reference's parameters and ``device``,
    default ``"cuda"``."""
    want = inspect.signature(getattr(j_thr, fn)).parameters
    got = dict(inspect.signature(getattr(p_thr, fn)).parameters)
    assert got.pop("device").default == "cuda"
    assert [(p.name, p.default) for p in got.values()] == \
        [(p.name, p.default) for p in want.values()]


def test_seeded_chaos_soak_on_the_port(tmp_path):
    """The port's counterpart of ``test_faults.py``'s seeded smoke,
    through the command line: ``ok`` (no acked write lost, HEALTH_OK,
    clean lockdep and span planes, every armed failpoint fired, no
    balancer proposal while degraded), with the reference's record."""
    out = tmp_path / "CHAOS_r99.json"
    rc = p_thr.main(["--seed", "8", "--duration", "3", "--osds", "4",
                     "--device", "cpu", "--out", str(out)])
    rec = json.loads(out.read_text())
    assert rc == 0 and rec["ok"], json.dumps(rec)
    assert rec["ops"] > 0
    assert rec["fired"], "no failpoint ever fired under the spec"
    assert rec["n"] == 99 and rec["kind"] == "chaos"
    committed = json.loads((REPO / "CHAOS_r08.json").read_text())
    assert set(rec) == set(committed) | BALANCER_KEYS
    want = perf_history.load_chaos(str(REPO / "CHAOS_r08.json"))
    got = perf_history.load_chaos(str(out))
    assert got["metrics"].keys() == want["metrics"].keys()
    assert got["fail"] == []


# -- the reference's slow drills, on the port (not in tier 1) ----------
@pytest.mark.slow
def test_full_soak_on_the_port():
    rec = p_thr.soak(seed=8, duration=15.0, n_osds=5, n_mons=3,
                     settle_timeout=90.0, device="cpu")
    assert rec["ok"], rec


@pytest.mark.slow
def test_host_kill_drill_on_the_port():
    rec = p_thr.host_kill_drill(seed=8, n_objects=24,
                                settle_timeout=120.0, device="cpu")
    assert rec["lost"] == 0
    assert rec["converge_s"] is not None
    assert rec.get("pipeline_speedup", 0) > 1.5, rec


@pytest.mark.slow
def test_degraded_read_soak_on_the_port():
    rec = p_thr.degraded_read_soak(seed=8, duration=5.0,
                                   settle_timeout=120.0, device="cpu")
    assert rec["slo"]["pass"], rec
    assert rec["read_errors"] == 0
