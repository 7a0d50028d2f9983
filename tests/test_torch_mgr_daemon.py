"""The port's mgr daemon and its balancer module on a live port cluster
(CPU), held to the offline balancer of both packages.

A ``MiniCluster`` (``device="cpu"``) of 6 OSDs with a replicated and an
EC pool holding a few objects starts a ``MgrDaemon``.  A forced
balancer round (``balancer execute``) must propose exactly what the port's offline ``calc_pg_upmaps`` and
``ceph_tpu``'s compute on the same map with the same options and seed;
the monitor must commit it and every OSD must see it in its map.  With
an OSD down and its PGs degraded, a round of the balancer's own loop
must pause and propose nothing.  (``ceph_tpu``'s own test of this
daemon fails on ``ceph_tpu``, so it is no oracle here.)
"""

import json
import threading
import time

import pytest

import ceph_tpu.crush.wrapper as r_wrapper
import ceph_tpu.osdmap.balancer as r_balancer
import ceph_tpu.osdmap.osdmap as r_osdmap
from ceph_tpu_torch.common.config import Config
from ceph_tpu_torch.crush.wrapper import CrushWrapper
from ceph_tpu_torch.mgr.balancer_module import diff_upmap_items
from ceph_tpu_torch.osdmap.balancer import calc_pg_upmaps
from ceph_tpu_torch.osdmap.bincode_maps import payload_map
from ceph_tpu_torch.osdmap.osdmap import OSDMap
from ceph_tpu_torch.services.cluster import MiniCluster
from test_torch_runtime import port_gates  # noqa: F401  (autouse)

WAIT = 60.0
MAX_DEV = 1
MAX_ITER = 10


def wait_for(cond, what, timeout=WAIT):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, what
        time.sleep(0.05)


def items(table):
    return {tuple(pg): [list(p) for p in v] for pg, v in table.items()}


def shutdown(cl):
    """``cl.shutdown()``, its OSDs stopped in parallel first (one at a
    time they take a few seconds of the file's budget)."""
    threads = [threading.Thread(target=svc.shutdown)
               for svc in cl.osds.values()]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    cl.osds.clear()
    cl.shutdown()


@pytest.fixture(scope="module")
def cluster():
    conf = Config()
    conf.set("osd_heartbeat_interval", 2.0)
    conf.set("osd_heartbeat_grace", 120.0)
    conf.set("mon_osd_down_out_interval", 3600.0)
    conf.set("balancer_max_deviation", MAX_DEV)
    conf.set("balancer_max_iterations", MAX_ITER)
    cl = MiniCluster(n_osds=6, config=conf, device="cpu").start()
    cl.create_replicated_pool(1, pg_num=16, size=3)
    cl.create_ec_pool(2, "rs21", {"plugin": "jerasure",
                                  "technique": "reed_sol_van", "k": "2",
                                  "m": "1", "w": "8"}, pg_num=8)
    cl.wait_for_health_ok(timeout=WAIT)
    # objects in every EC PG: a down OSD leaves its EC positions empty,
    # and those PGs degraded
    c = cl.client("mgr-test")
    for i in range(16):
        c.put(1 + i % 2, f"obj{i}", bytes([i]) * 512)
    mgr = cl.start_mgr()
    wait_for(lambda: mgr.epoch >= cl.status()["epoch"],
             "the mgr never caught up with the monitor")
    yield cl, mgr
    shutdown(cl)


def _round(mgr, force):
    """One balancer round, with the pg_upmap_items proposals it sent
    to the monitor and their replies."""
    bal = mgr.modules["balancer"]
    sent = []
    real = mgr.mon_call

    def mon_call(msg, *a, **kw):
        rep = real(msg, *a, **kw)
        if msg.get("type") == "pg_upmap_items_set":
            sent.append(((msg["pool"], msg["ps"]),
                         [list(p) for p in msg["items"]], rep))
        return rep

    mgr.mon_call = mon_call
    try:
        rec = bal.command({"argv": ["execute"]}) if force else \
            bal._run_round(force=False)
    finally:
        del mgr.mon_call
    return rec, sent


def test_forced_round_equals_offline_and_is_committed(cluster):
    cl, mgr = cluster
    bal = mgr.modules["balancer"]
    for _attempt in range(3):
        m0, _w, epoch = bal._snapshot()
        rounds0 = bal.rounds
        rec, sent = _round(mgr, force=True)
        if rec.get("epoch") == epoch:
            break
    else:
        pytest.fail("every round swept a newer map than its snapshot")
    old = {pg: list(v) for pg, v in m0.pg_upmap_items.items()}
    # the port's offline core on the same map, options and seed
    m_port = OSDMap.from_dict(json.loads(json.dumps(m0.to_dict())))
    calc_pg_upmaps(m_port, max_deviation=MAX_DEV, max_iterations=MAX_ITER,
                   wrapper=CrushWrapper(m_port.crush), use_batched=True,
                   seed=rounds0 + 1, device="cpu")
    # ceph_tpu's, on its scalar sweep (the same tallies as its batched
    # one, without a compile)
    m_ref = r_osdmap.OSDMap.from_dict(json.loads(json.dumps(m0.to_dict())))
    r_balancer.calc_pg_upmaps(
        m_ref, max_deviation=MAX_DEV, max_iterations=MAX_ITER,
        wrapper=r_wrapper.CrushWrapper(m_ref.crush), use_batched=False,
        seed=rounds0 + 1)
    want = [(pg, [list(p) for p in its])
            for pg, its in diff_upmap_items(old, m_port.pg_upmap_items)]
    assert want, "the map was balanced already: nothing to hold"
    assert items(m_port.pg_upmap_items) == items(m_ref.pg_upmap_items)
    assert [(pg, its) for pg, its, _r in sent] == want
    assert all("error" not in r for _pg, _i, r in sent), sent
    assert rec["proposed"] == len(want) and rec["balanced"] is False
    target = items(m_port.pg_upmap_items)
    wait_for(lambda: items(payload_map(cl.mon_command(
        {"type": "get_map"})).pg_upmap_items) == target,
        "the monitor never committed the proposals")
    for osd, svc in cl.osds.items():
        wait_for(lambda: svc.map is not None and
                 items(svc.map.pg_upmap_items) == target,
                 f"osd.{osd} never saw the proposals")
    wait_for(lambda: items(mgr.map.pg_upmap_items) == target,
             "the mgr never saw its own proposals")


def test_balancer_pauses_while_degraded(cluster):
    cl, mgr = cluster
    bal = mgr.modules["balancer"]
    victim = max(cl.osds)
    cl.kill_osd(victim)
    cl.mon_command({"type": "mark_down", "osd": victim})
    wait_for(lambda: "PG_DEGRADED" in cl.health()["check_codes"],
             "the PGs never reported degraded")
    proposals = len(bal.proposal_log)

    def paused_round():
        # a round whose health call timed out ends early, unpaused;
        # none may propose
        rec, sent = _round(mgr, force=False)
        assert rec is None and sent == []
        return bal.paused

    wait_for(paused_round, "the balancer never paused")
    bal.active = True   # what its health checks report on
    try:
        assert bal.health_checks() == {
            "BALANCER_PAUSED": "balancer paused while cluster is degraded"}
    finally:
        bal.active = False
    assert len(bal.proposal_log) == proposals
    assert bal.degraded_proposals == 0
