"""The port's monitor (``ceph_tpu_torch/services/monitor.py``, with
``quorum``) against ``ceph_tpu``'s, live.

One monitor per package, started once for the file, gets the same
seeded command sequence over its own package's messenger: EC profiles
and pools (replicated and EC), OSD boots, downs, outs and reboots,
reweights, ``pg_upmap_items``, a ``pg_temp`` and pool deletes.  After
every command the replies, the committed epoch's ``Incremental`` (its
versioned envelope) and full map (its binary encoding, as the wire
carries it) and the health codes must be equal.  Then a three-monitor
quorum of each package loses its leader: the same rank must be elected
and epochs must go on committing.
"""

import tempfile
import time

import numpy as np
import pytest

import ceph_tpu.common.config as r_config
import ceph_tpu.common.context as r_context
import ceph_tpu.crush.wrapper as r_wrapper
import ceph_tpu.msg.messenger as r_msgr
import ceph_tpu.osdmap.incremental as r_inc
import ceph_tpu.osdmap.osdmap as r_osdmap
import ceph_tpu.services.cluster as r_cluster
import ceph_tpu.services.monitor as r_monitor
import ceph_tpu_torch.common.config as p_config
import ceph_tpu_torch.common.context as p_context
import ceph_tpu_torch.crush.wrapper as p_wrapper
import ceph_tpu_torch.msg.messenger as p_msgr
import ceph_tpu_torch.osdmap.incremental as p_inc
import ceph_tpu_torch.osdmap.osdmap as p_osdmap
import ceph_tpu_torch.services.cluster as p_cluster
import ceph_tpu_torch.services.monitor as p_monitor
from test_torch_messenger import _warm
from test_torch_runtime import port_gates  # noqa: F401  (autouse)

N_OSDS = 8
SEED = 13
WAIT = 60.0   # seconds any wait may take


class _Side:
    """One package's live monitor and the messenger that commands it."""

    def __init__(self, config, context, wrapper, osdmap, monitor, msgr,
                 inc):
        self.inc = inc
        conf = config.Config()
        conf.set("admin_socket", False)
        # no down OSD is marked out behind the test's back
        conf.set("mon_osd_down_out_interval", 3600.0)
        w = wrapper.CrushWrapper()
        for d in range(N_OSDS):
            w.insert_item(d, 0x10000, f"osd.{d}",
                          {"host": f"host{d}", "root": "default"})
        self.rep_rule = w.add_simple_rule("replicated_rule", "default",
                                          "host", "", "firstn")
        self.ec_rule = w.add_simple_rule("ec_rule", "default", "host", "",
                                         "indep", rule_type=3)
        self.mon = monitor.Monitor(context.Context("mon.0", config=conf),
                                   osdmap.OSDMap(w.crush))
        self.mon.start()
        self.cli = msgr.Messenger("client.admin")
        self.cli.start()
        _warm(self.cli)
        _warm(self.mon.msgr)
        deadline = time.monotonic() + WAIT
        while self.mon.last_committed() == 0:
            assert time.monotonic() < deadline, "no genesis commit"
            time.sleep(0.02)

    def call(self, msg):
        return self.cli.call(self.mon.addr, msg, timeout=10)

    def committed(self):
        """(epoch, the Incremental's envelope, the full map's bytes,
        health codes) of the newest committed epoch."""
        epoch = self.mon.last_committed()
        inc = self.call({"type": "get_inc", "epoch": epoch})
        full = self.call({"type": "get_map", "epoch": epoch})
        health = self.call({"type": "health"})
        env = self.inc.Incremental.from_dict(inc["inc"]).encode_versioned() \
            if "inc" in inc else inc
        return (epoch, env, bytes(full["map_bin"]),
                sorted(health["check_codes"]), health["status"])

    def close(self):
        self.cli.shutdown()
        self.mon.shutdown()


@pytest.fixture(scope="module")
def sides():
    ref = _Side(r_config, r_context, r_wrapper, r_osdmap, r_monitor,
                r_msgr, r_inc)
    port = _Side(p_config, p_context, p_wrapper, p_osdmap, p_monitor,
                 p_msgr, p_inc)
    yield ref, port
    ref.close()
    port.close()


def commands(rep_rule, ec_rule, seed=SEED):
    """The seeded command sequence (the same list for both packages)."""
    rng = np.random.default_rng(seed)
    out = [{"type": "ec_profile_set", "name": "rs42",
            "profile": {"plugin": "jerasure", "technique": "reed_sol_van",
                        "k": "4", "m": "2", "w": "8"}},
           {"type": "ec_profile_set", "name": "isa32",
            "profile": {"plugin": "isa", "k": "3", "m": "2"}}]
    for d in range(N_OSDS):
        out.append({"type": "boot", "osd": d,
                    "addr": ["127.0.0.1", 7000 + d]})
    out += [{"type": "pool_create", "pool_id": 1,
             "pool": {"pool_type": r_osdmap.POOL_TYPE_REPLICATED,
                      "size": 3, "min_size": 2, "pg_num": 16,
                      "crush_rule": rep_rule}},
            {"type": "pool_create", "pool_id": 2,
             "pool": {"pool_type": r_osdmap.POOL_TYPE_ERASURE, "size": 6,
                      "min_size": 4, "pg_num": 8, "crush_rule": ec_rule,
                      "erasure_code_profile": "rs42"}},
            {"type": "pool_create", "pool_id": 3,
             "pool": {"pool_type": r_osdmap.POOL_TYPE_ERASURE, "size": 5,
                      "min_size": 3, "pg_num": 8, "crush_rule": ec_rule,
                      "erasure_code_profile": "isa32"}}]
    for _ in range(24):
        osd = int(rng.integers(0, N_OSDS))
        kind = int(rng.integers(0, 7))
        if kind == 0:
            out.append({"type": "mark_down", "osd": osd})
        elif kind == 1:
            out.append({"type": "mark_out", "osd": osd})
        elif kind == 2:   # back up, and in again after an out
            out.append({"type": "boot", "osd": osd,
                        "addr": ["127.0.0.1", 7100 + osd]})
        elif kind == 3:
            out.append({"type": "reweight", "osd": osd,
                        "weight": int(rng.integers(0, 0x10001))})
        elif kind == 4:
            pool = int(rng.integers(1, 3))
            ps = int(rng.integers(0, 8))
            a, b = (int(x) for x in rng.choice(N_OSDS, 2, replace=False))
            out.append({"type": "pg_upmap_items_set", "pool": pool,
                        "ps": ps,
                        "items": [] if rng.random() < 0.2 else [[a, b]]})
        elif kind == 5:
            out.append({"type": "pg_temp_set", "pool": 1,
                        "ps": int(rng.integers(0, 16)),
                        "osds": [int(x) for x in rng.choice(
                            N_OSDS, 3, replace=False)]})
        else:
            out.append({"type": "pg_upmap_items_set", "pool": 9, "ps": 0,
                        "items": [[0, 1]]})   # refused: no pool 9
    out += [{"type": "pool_delete", "pool_id": 3},
            {"type": "pool_delete", "pool_id": 3},
            {"type": "mark_down", "osd": 0}, {"type": "mark_out", "osd": 0},
            {"type": "boot", "osd": 0, "addr": ["127.0.0.1", 7200]}]
    return out


def test_command_sequence_commits_equal_epochs(sides):
    ref, port = sides
    assert (ref.rep_rule, ref.ec_rule) == (port.rep_rule, port.ec_rule)
    assert port.committed() == ref.committed()   # genesis
    epochs = set()
    for i, cmd in enumerate(commands(ref.rep_rule, ref.ec_rule)):
        got_r, got_p = ref.call(dict(cmd)), port.call(dict(cmd))
        assert got_p == got_r, (i, cmd)
        now_r, now_p = ref.committed(), port.committed()
        assert now_p == now_r, (i, cmd)
        epochs.add(now_p[0])
    assert len(epochs) > 20
    st_r, st_p = ref.call({"type": "status"}), port.call({"type": "status"})
    assert {k: st_p[k] for k in ("epoch", "up_osds", "num_pools")} == \
        {k: st_r[k] for k in ("epoch", "up_osds", "num_pools")}


def _stable_command(cl, msg):
    """``msg``'s committed epoch, as a client gets it: once the steady
    leader is up and every live monitor has committed its last epoch,
    the command is sent; a reply of "lost quorum" (the leader waited
    out a peer's accept on a loaded host, rolled back and abdicated)
    or a call that failed over every monitor is sent again after the
    next election, until ``WAIT`` has passed."""
    deadline = time.monotonic() + WAIT
    last = None
    while time.monotonic() < deadline:
        leader = cl.wait_for_quorum(timeout=max(0.1, deadline -
                                                time.monotonic()))
        lc = leader.last_committed()
        if any(m.last_committed() < lc for m in cl.mons.values()):
            time.sleep(0.02)
            continue
        try:
            rep = cl.mon_command(msg, timeout=WAIT)
        except (OSError, TimeoutError, RuntimeError) as e:
            last = e
            continue
        if "lost quorum" in str(rep.get("error", "")):
            last = rep
            continue
        return rep["epoch"]
    raise AssertionError(f"{msg['type']} never committed: {last}")


def _quorum_failover(cluster_mod, config_mod):
    """A three-monitor quorum (no OSDs started): the steady leader's
    rank, the rank elected after it is killed, and the epochs of a
    commit before and after."""
    conf = config_mod.Config()
    conf.set("admin_socket", False)
    with tempfile.TemporaryDirectory(prefix="mq", dir="/tmp"):
        cl = cluster_mod.MiniCluster(n_osds=3, config=conf, n_mons=3)
        try:
            for mon in cl.mons.values():
                mon.start()
            first = cl.wait_for_quorum(timeout=WAIT)
            rank0 = next(r for r, m in cl.mons.items() if m is first)
            e0 = _stable_command(cl, {"type": "ec_profile_set", "name": "a",
                                      "profile": {"k": "2", "m": "1"}})
            cl.kill_mon(rank0)
            second = cl.wait_for_quorum(timeout=WAIT)
            rank1 = next(r for r, m in cl.mons.items() if m is second)
            e1 = _stable_command(cl, {"type": "ec_profile_set", "name": "b",
                                      "profile": {"k": "2", "m": "1"}})
            lc = {r: m.last_committed() for r, m in cl.mons.items()}
            deadline = time.monotonic() + WAIT
            while min(m.last_committed() for m in cl.mons.values()) < e1:
                assert time.monotonic() < deadline, "a peon fell behind"
                time.sleep(0.02)
            return rank0, rank1, e0, e1, sorted(lc)
        finally:
            cl.shutdown()


def test_three_monitors_reelect_the_same_rank():
    ref = _quorum_failover(r_cluster, r_config)
    port = _quorum_failover(p_cluster, p_config)
    rank0, rank1, e0, e1, live = port
    assert (rank0, rank1, live) == (ref[0], ref[1], ref[4]) == (0, 1, [1, 2])
    assert e1 > e0 > 0


def _weights(cl):
    """The steady leader's committed osd weights."""
    leader = cl.wait_for_quorum(timeout=WAIT)
    payload = leader.get_epoch_payload(leader.last_committed())
    return payload["map"]["osd_weight"]


def _down_osds_go_out(cluster_mod, config_mod, window):
    """A three-monitor quorum (no OSDs started) with four OSDs booted by
    command.  osd.1 is marked down and the leader's next replication
    fails once, so its auto-out commit aborts (as when it waits out a
    peer's accept); once the quorum is back, osd.2 is marked down and
    the leader, whose replications now all fail, is killed.  Returns
    the OSDs of {1, 2} that the new leader's map has out, as soon as
    both are or once ``window`` seconds have passed since the new
    quorum."""
    import threading

    conf = config_mod.Config()
    conf.set("admin_socket", False)
    # no booted OSD goes stale (none beats): only the two downs count
    conf.set("osd_heartbeat_interval", 0.5)
    conf.set("osd_heartbeat_grace", 600.0)
    conf.set("mon_osd_down_out_interval", 1.0)
    with tempfile.TemporaryDirectory(prefix="mo", dir="/tmp"):
        cl = cluster_mod.MiniCluster(n_osds=3, config=conf, n_mons=3)
        try:
            for mon in cl.mons.values():
                mon.start()
            for d in range(4):
                _stable_command(cl, {"type": "boot", "osd": d,
                                     "addr": ["127.0.0.1", 7300 + d]})
            leader = cl.wait_for_quorum(timeout=WAIT)
            _stable_command(cl, {"type": "mark_down", "osd": 1})
            fired = threading.Event()
            real = leader.quorum.replicate

            def fail_once(v, entry):
                if fired.is_set():
                    return real(v, entry)
                fired.set()
                return False

            leader.quorum.replicate = fail_once
            assert fired.wait(WAIT), "no auto-out was proposed"
            cl.wait_for_quorum(timeout=WAIT)
            leader = cl.wait_for_quorum(timeout=WAIT)
            rank = next(r for r, m in cl.mons.items() if m is leader)
            _stable_command(cl, {"type": "mark_down", "osd": 2})
            leader.quorum.replicate = lambda v, entry: False
            cl.kill_mon(rank)
            cl.wait_for_quorum(timeout=WAIT)
            deadline = time.monotonic() + window
            while True:
                w = _weights(cl)
                out = {o for o in (1, 2) if w[o] == 0}
                if out == {1, 2} or time.monotonic() > deadline:
                    return out
                time.sleep(0.05)
        finally:
            cl.shutdown()


def test_down_osds_go_out_after_an_aborted_commit_and_a_new_leader():
    """The monitor's down -> out clock.  ``ceph_tpu``'s leader drops an
    OSD's stamp when it proposes the out, so an out whose commit aborts
    is never proposed again, and a new leader has no stamp for an OSD
    marked down before it led: both OSDs stay in for good (four out
    intervals here).  The port stamps every down, in OSD from the map
    on each tick and keeps the stamp until the map has it up or out,
    as Ceph's down_pending_out does: both go out."""
    ref = _down_osds_go_out(r_cluster, r_config, window=4.0)
    port = _down_osds_go_out(p_cluster, p_config, window=WAIT)
    assert ref == set()
    assert port == {1, 2}


def _pool_after_an_aborted_profile_commit(cluster_mod, config_mod,
                                          osdmap_mod):
    """A three-monitor quorum (no OSDs started) whose leader's next
    replication fails once: ``create_ec_pool``'s profile commit aborts
    with "lost quorum".  Returns (the committed pools' profile names,
    the committed profile names) once the pool is in the map."""
    import threading

    conf = config_mod.Config()
    conf.set("admin_socket", False)
    with tempfile.TemporaryDirectory(prefix="mp", dir="/tmp"):
        cl = cluster_mod.MiniCluster(n_osds=3, config=conf, n_mons=3)
        try:
            for mon in cl.mons.values():
                mon.start()
            leader = cl.wait_for_quorum(timeout=WAIT)
            fired = threading.Event()
            real = leader.quorum.replicate

            def fail_once(v, entry):
                if fired.is_set():
                    return real(v, entry)
                fired.set()
                return False

            leader.quorum.replicate = fail_once
            cl.create_ec_pool(2, "rs21", {"plugin": "jerasure",
                                          "technique": "reed_sol_van",
                                          "k": "2", "m": "1"}, pg_num=8)
            assert fired.is_set()
            deadline = time.monotonic() + WAIT
            while True:
                leader = cl.wait_for_quorum(timeout=WAIT)
                payload = leader.get_epoch_payload(leader.last_committed())
                m = osdmap_mod.OSDMap.from_dict(payload["map"])
                if 2 in m.pools:
                    return ({p: pool.erasure_code_profile
                             for p, pool in m.pools.items()},
                            sorted(payload["ec_profiles"]))
                assert time.monotonic() < deadline, "no pool 2"
                time.sleep(0.05)
        finally:
            cl.shutdown()


def test_ec_pool_keeps_its_profile_after_an_aborted_commit():
    """``ceph_tpu``'s ``MiniCluster.create_ec_pool`` ignores the
    monitor's replies: a profile whose commit aborted is rolled back,
    and the pool that follows names a profile the map lacks (every
    OSD's recovery pass then fails on it).  The port's harness sends a
    "lost quorum" command again once a leader is back."""
    ref = _pool_after_an_aborted_profile_commit(r_cluster, r_config,
                                                r_osdmap)
    port = _pool_after_an_aborted_profile_commit(p_cluster, p_config,
                                                 p_osdmap)
    assert ref == ({2: "rs21"}, [])
    assert port == ({2: "rs21"}, ["rs21"])
