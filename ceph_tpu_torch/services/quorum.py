"""Monitor quorum — rank election + replicated epoch log.

The role of src/mon/ElectionLogic.cc + src/mon/Paxos.cc, bounded to the
shape this framework needs: N monitors (typically 3) elect the
lowest-ranked reachable monitor as leader, and every epoch commit is
replicated to a majority before it becomes visible anywhere.

Election (ElectionLogic.cc's lowest-rank-wins, epoch-numbered):
- a candidate bumps the election epoch and proposes itself to every
  peer; peers ack only proposers with a LOWER rank than their own, so
  the lowest reachable rank collects a majority.  A monitor that sees a
  proposal from a higher rank starts its own candidacy; rank-staggered
  retry deadlines break ties.
- the propose round IS the Paxos collect/last phase (Paxos.cc:330-560
  in single-decree form): every ack carries the peer's last_committed
  AND its staged-but-uncommitted entry, and victory requires a majority
  of acks — so the promise majority intersects every accept majority
  and any entry that ever reached a majority is seen and re-proposed.
  Epochs never fork.  (Round-4 advisor finding: the old design gathered
  uncommitted entries in a best-effort second round that could miss the
  one holder; piggybacking on the propose acks closes that.)
- leadership is kept alive with leases (Paxos.cc:1038 lease_*): the
  leader sends lease CALLS; peons ack.  The leader's own authority is
  extended only while a majority of peons ack within the window — an
  isolated leader demotes itself to ELECTING instead of serving stale
  reads forever (round-4 advisor finding; matches the reference where
  the leader's lease rides peon lease_ack).

Durability (MonitorDBStore role, Paxos.cc persistent accepted_pn /
uncommitted value): the election epoch (promise) and any staged entry
are persisted through ``mon.store_quorum_state`` BEFORE the ack leaves
the monitor, so leader-crash + staged-peon-restart cannot lose a
majority-staged entry and a restarted peon cannot un-promise and ack a
deposed leader's accept.

Log replication (Paxos.cc begin/accept/commit, single-decree):
- the leader sends ``mon_accept`` {epoch, version, entry} to peers; a
  peer STAGES the entry (never applies it) and acks if the epoch is
  current and the version is next-in-log.
- on majority ack the leader applies locally and broadcasts
  ``mon_commit``; peers then apply their staged entry.  A peer that
  misses the commit catches up from the lease's last_committed via
  ``mon_fetch``.
- a leader that cannot reach a majority rolls its in-memory state back
  to the last committed entry and abdicates — a partitioned minority
  can commit nothing.

The entry payload is the monitor's full epoch record (map json + inc +
addr/profile extras), so a peon's store is always a prefix of the
leader's and any monitor can serve reads and subscriptions.

The port's copy of ``ceph_tpu/services/quorum.py``, on the port's
runtime; it does no device work.
"""

from __future__ import annotations

import random
import threading
import time
from typing import Dict, List, Optional, Tuple

from ..analysis import faults
from ..analysis.lockdep import make_rlock

Addr = Tuple[str, int]

PROBING = "probing"
ELECTING = "electing"
LEADER = "leader"
PEON = "peon"


class Quorum:
    def __init__(self, mon, rank: int, addrs: List[Addr],
                 lease: float = 1.0, election_timeout: float = 1.0,
                 call_timeout: float = 1.5):
        self.mon = mon
        self.rank = rank
        self.addrs = [tuple(a) for a in addrs]
        self.n = len(addrs)
        self.majority = self.n // 2 + 1
        self.lease = lease
        self.election_timeout = election_timeout
        self.call_timeout = call_timeout

        self.state = PROBING
        self.election_epoch = 0
        self.leader_rank: Optional[int] = None
        self.lease_expiry = 0.0
        self._next_election = 0.0
        # accepted-but-uncommitted entry: {"v": int, "e": int,
        # "entry": {...}} — never applied until mon_commit
        self.uncommitted: Optional[Dict] = None
        # one promise per election epoch (Paxos: a node may ack only
        # ONE proposer per ballot, or two same-epoch candidates can
        # both assemble majorities and commit different entries at the
        # same version): rank we acked at election_epoch, or None
        self.promised_rank: Optional[int] = None
        self._lease_fetching = False
        self._lock = make_rlock("quorum::state")
        self._running = False
        self._thread: Optional[threading.Thread] = None

        # ordered=True: quorum messages from one peer must execute in
        # arrival order — a mon_accept(v+1) racing ahead of its
        # predecessor's mon_commit(v) on another dispatch worker is
        # nacked as non-contiguous, and a majority of such races makes
        # the leader spuriously abdicate (round-5 advisor medium #1)
        # control=True as well: election and lease traffic IS failure
        # detection — it must never wait for an op-pool slot behind a
        # burst of client commands (the serial lane drains on the
        # messenger's dedicated control pool)
        m = mon.msgr
        m.register("mon_probe", self._gate(self._h_probe),
                   ordered=True, control=True)
        m.register("mon_propose", self._gate(self._h_propose),
                   ordered=True, control=True)
        m.register("mon_victory", self._gate(self._h_victory),
                   ordered=True, control=True)
        m.register("mon_lease", self._gate(self._h_lease),
                   ordered=True, control=True)
        m.register("mon_fetch", self._gate(self._h_fetch),
                   ordered=True, control=True)
        m.register("mon_accept", self._gate(self._h_accept),
                   ordered=True, control=True)
        m.register("mon_commit", self._gate(self._h_commit),
                   ordered=True, control=True)

        # restore the promise + staged entry a crash may have left
        # (Paxos.cc reads accepted_pn / uncommitted from the store).
        # In __init__, NOT start(): handlers are registered above, and
        # an early mon_propose arriving before a later restore would
        # persist fresh state over the crash-saved entry.
        loader = getattr(self.mon, "load_quorum_state", None)
        if loader is not None:
            st = loader() or {}
            self.election_epoch = max(self.election_epoch,
                                      int(st.get("election_epoch", 0)))
            if st.get("promised_rank") is not None:
                self.promised_rank = int(st["promised_rank"])
            if st.get("uncommitted"):
                self.uncommitted = st["uncommitted"]

    # -- lifecycle ------------------------------------------------------
    def start(self) -> None:
        self._running = True
        self._thread = threading.Thread(target=self._tick_loop,
                                        daemon=True,
                                        name=f"mon{self.rank}-quorum")
        self._thread.start()

    def shutdown(self) -> None:
        self._running = False
        if self._thread:
            self._thread.join(timeout=2)

    # -- state queries ---------------------------------------------------
    def is_leader(self) -> bool:
        with self._lock:
            return self.state == LEADER

    def leader_addr(self) -> Optional[Addr]:
        with self._lock:
            if self.leader_rank is None:
                return None
            return self.addrs[self.leader_rank]

    def _others(self):
        return [(r, a) for r, a in enumerate(self.addrs)
                if r != self.rank]

    def _persist_locked(self) -> None:
        """Durably record (election_epoch, uncommitted) — called with
        the lock held, BEFORE the ack that makes the state externally
        visible.  No-op for storeless monitors (tests)."""
        saver = getattr(self.mon, "store_quorum_state", None)
        if saver is not None:
            saver({"election_epoch": self.election_epoch,
                   "promised_rank": self.promised_rank,
                   "uncommitted": self.uncommitted})

    # -- the ticker -------------------------------------------------------
    def _tick_loop(self) -> None:
        # rank-staggered first election so rank 0 usually wins round 1
        time.sleep(0.02 * self.rank)
        while self._running:
            try:
                self._tick()
            except Exception as e:  # a tick must never kill the thread
                self.mon.log.derr(f"quorum tick: {e!r}")
            time.sleep(self.lease / 3)  # fault-ok: election tick
            # cadence, not retry pacing against a failing peer

    def _tick(self) -> None:
        now = time.monotonic()
        with self._lock:
            state = self.state
            lease_out = now > self.lease_expiry
            due = now >= self._next_election
            # a live monitor that OUTRANKS its leader stands for
            # election (the reference re-elects when a lower rank
            # joins, ElectionLogic's lowest-rank-wins is a standing
            # invariant, not a startup accident)
            outranked = (state == PEON
                         and self.leader_rank is not None
                         and self.leader_rank > self.rank)
        if state == LEADER and lease_out:
            # a majority of peons stopped acking leases: this leader is
            # partitioned/isolated and must stop serving leader-only
            # duties instead of running on a stale map forever
            self.mon.log.dout(1, f"mon.{self.rank}: leader lease "
                                 f"lapsed (no peon-ack majority), "
                                 f"demoting")
            self.abdicate()
        elif state == LEADER:
            self._send_leases()
        elif state == PEON and lease_out:
            self.mon.log.dout(1, f"mon.{self.rank}: lease expired, "
                                 f"calling election")
            self._start_election()
        elif outranked and due:
            self._start_election()
        elif state == PROBING and due:
            # discover an existing quorum before forcing a round: a
            # RESTARTED member's immediate candidacy used to depose a
            # healthy leader (its higher-epoch propose invalidates
            # leadership on every peer) and seesaw elections for
            # seconds — the thrash-test quorum outages.  The
            # reference's probing phase (Monitor.cc handle_probe)
            # joins an established quorum without an election.
            if not self._probe():
                self._start_election()
        elif state == ELECTING and due:
            self._start_election()

    def _gate(self, handler):
        """Fault-injection door on every inbound mon-to-mon frame:
        when ``mon.isolate_rank`` fires for this rank the frame is
        swallowed — no reply, no ack (InjectedKill semantics in the
        messenger) — so peers see a partitioned monitor, not an
        error-returning one."""

        def h(msg: Dict):
            if faults._ACTIVE and faults.fires(
                    "mon.isolate_rank", f"mon.{self.rank}"):
                raise faults.InjectedKill(
                    f"mon.{self.rank} isolated")
            return handler(msg)

        return h

    # -- probe (rejoin without deposing) ----------------------------------
    def _h_probe(self, _msg: Dict) -> Dict:
        """Report current leadership (None unless the lease is live)
        so a (re)starting monitor can rejoin as a peon."""
        with self._lock:
            leader = self.leader_rank
            if self.state not in (LEADER, PEON) or \
                    time.monotonic() > self.lease_expiry:
                leader = None
            return {"leader": leader, "epoch": self.election_epoch,
                    "last_committed": self.mon.last_committed()}

    def _probe(self) -> bool:
        """Ask peers for the standing quorum; adopt it when found.
        Returns False when no live leader is known anywhere — the
        caller elects.  A provisional lease window is granted; if the
        reported leader is actually gone, its non-renewal leads to a
        normal election one window later."""
        for r, addr in self._others():
            try:
                rep = self.mon.msgr.call(
                    addr, {"type": "mon_probe"},
                    timeout=min(self.call_timeout, 0.5))
            except (OSError, TimeoutError):
                continue
            leader = rep.get("leader")
            e = int(rep.get("epoch", 0))
            with self._lock:
                if leader is None or e < self.election_epoch:
                    continue
                if int(leader) == self.rank:
                    # a peer still believes the PRE-restart us leads;
                    # leadership without a fresh collect majority is
                    # unsafe — run the election instead
                    continue
                if self.state != PROBING:
                    return True  # something else settled us meanwhile
                if e > self.election_epoch:
                    self.promised_rank = None  # new epoch, new promise
                self.election_epoch = e
                self.leader_rank = int(leader)
                self.state = PEON
                self.lease_expiry = time.monotonic() + self.lease * 3
                self._persist_locked()
            self.mon.log.dout(1, f"mon.{self.rank}: probe found "
                                 f"leader mon.{leader} at epoch {e}; "
                                 f"joining as peon")
            return True
        return False

    # -- election ---------------------------------------------------------
    def _start_election(self) -> None:
        with self._lock:
            self.election_epoch += 1
            e = self.election_epoch
            self.state = ELECTING
            self.leader_rank = None
            # standing is a promise to ourselves at this epoch: we
            # must not also ack another candidate at the same epoch
            self.promised_rank = self.rank
            # stagger retries by rank so the lowest reachable rank
            # converges first instead of livelocking
            self._next_election = time.monotonic() + \
                self.election_timeout * (1 + 0.5 * self.rank
                                         + 0.2 * random.random())
        acks = 1
        infos = [{"rank": self.rank,
                  "last_committed": self.mon.last_committed()}]
        uncommitted = []
        peer_epoch = 0
        with self._lock:
            self._persist_locked()  # durable promise for our own round
            if self.uncommitted is not None:
                uncommitted.append(self.uncommitted)
        for r, addr in self._others():
            try:
                rep = self.mon.msgr.call(
                    addr, {"type": "mon_propose", "e": e,
                           "rank": self.rank},
                    timeout=self.call_timeout)
            except (OSError, TimeoutError):
                continue
            peer_epoch = max(peer_epoch, int(rep.get("epoch", 0)))
            if rep.get("ack"):
                acks += 1
                infos.append({"rank": r,
                              "last_committed":
                                  rep.get("last_committed", 0)})
                if rep.get("uncommitted"):
                    uncommitted.append(rep["uncommitted"])
        with self._lock:
            if self.election_epoch != e or self.state != ELECTING:
                return  # a newer round superseded this one
            if acks < self.majority:
                if peer_epoch >= e:
                    # reachable peers nacked at a round at least as
                    # new as ours: an asymmetrically cut candidate
                    # (its proposes arrive, the replies home but the
                    # leader's leases never do) would otherwise
                    # re-propose forever, deposing the live leader on
                    # every retry.  Adopt the standing epoch and drop
                    # to PROBING — the probe rejoins the standing
                    # quorum as a peon WITHOUT another epoch bump.
                    if peer_epoch > e:
                        self.promised_rank = None
                    self.election_epoch = peer_epoch
                    self.state = PROBING
                    self._persist_locked()
                return  # retry (or probe) at the staggered deadline
        # the ack majority IS the collect majority: every ack carried
        # last_committed + any staged entry, so the intersection
        # argument holds without a second best-effort round
        self._win(e, infos, uncommitted)

    def _h_propose(self, msg: Dict) -> Dict:
        e, r = int(msg["e"]), int(msg["rank"])
        with self._lock:
            if e < self.election_epoch:
                return {"ack": False, "epoch": self.election_epoch}
            if e > self.election_epoch:
                self.election_epoch = e
                self.promised_rank = None  # new epoch, new promise
                # a new round invalidates current leadership
                if self.state in (LEADER, PEON):
                    self.state = ELECTING
                    self.leader_rank = None
            # one promise per epoch: two same-epoch candidates must
            # never both collect majorities (they would each replicate
            # a different entry at the same version)
            ack = r < self.rank and \
                self.promised_rank in (None, r)
            if ack:
                self.promised_rank = r
                # the promise must be durable before it leaves: a
                # restarted peon that forgot this epoch could ack a
                # deposed leader's accept at the same version
                self._persist_locked()
            else:
                # I outrank the proposer and I'm alive: stand myself
                self._next_election = time.monotonic()
            return {"ack": ack, "epoch": self.election_epoch,
                    "last_committed": self.mon.last_committed(),
                    "uncommitted": self.uncommitted}

    def _win(self, e: int, infos: List[Dict],
             uncommitted: List[Dict]) -> None:
        """Sync to the newest majority state, then declare victory.

        ``infos`` (rank, last_committed) and ``uncommitted`` come from
        the MAJORITY of propose acks — the durable collect phase — so
        the newest committed version and every possibly-majority-staged
        entry are in hand before leadership is declared."""
        best_lc = self.mon.last_committed()
        best_peer = None
        for row in infos:
            if row["rank"] != self.rank and \
                    int(row["last_committed"]) > best_lc:
                best_lc = int(row["last_committed"])
                best_peer = self.addrs[row["rank"]]
        if best_peer is not None:
            self._fetch_from(best_peer, best_lc)

        with self._lock:
            if self.election_epoch != e:
                return
            self.state = LEADER
            self.leader_rank = self.rank
            self.lease_expiry = time.monotonic() + self.lease * 3
        for r, addr in self._others():
            try:
                self.mon.msgr.call(addr,
                                   {"type": "mon_victory", "e": e,
                                    "leader": self.rank},
                                   timeout=self.call_timeout)
            except (OSError, TimeoutError):
                pass
        self.mon.log.dout(1, f"mon.{self.rank}: leader at election "
                             f"epoch {e}, last_committed {best_lc}")
        self.mon.on_leader(
            self._pick_uncommitted(uncommitted, best_lc))

    def _pick_uncommitted(self, entries: List[Dict],
                          lc: int) -> Optional[Dict]:
        """The next-in-log staged entry with the highest election
        epoch, if any (Paxos: re-propose the highest accepted value)."""
        best = None
        for u in entries:
            if int(u["v"]) != lc + 1:
                continue
            if best is None or int(u["e"]) > int(best["e"]):
                best = u
        return best

    def _fetch_from(self, addr: Addr, to_v: int) -> None:
        """Pull committed entries (last_committed, to_v] and apply."""
        frm = self.mon.last_committed()
        try:
            rep = self.mon.msgr.call(
                addr, {"type": "mon_fetch", "from_v": frm,
                       "to_v": to_v},
                timeout=self.call_timeout * 2)
        except (OSError, TimeoutError):
            return
        for row in rep.get("entries", []):
            if int(row["v"]) == self.mon.last_committed() + 1:
                self.mon.apply_committed(int(row["v"]), row["entry"])

    def _h_victory(self, msg: Dict) -> Dict:
        e, leader = int(msg["e"]), int(msg["leader"])
        with self._lock:
            if e < self.election_epoch:
                return {"ok": False, "epoch": self.election_epoch}
            if e > self.election_epoch:
                self.promised_rank = None
            self.election_epoch = e
            self.state = PEON if leader != self.rank else LEADER
            self.leader_rank = leader
            self.lease_expiry = time.monotonic() + self.lease * 3
            self._persist_locked()
        return {"ok": True,
                "last_committed": self.mon.last_committed()}

    # -- leases -----------------------------------------------------------
    def _send_leases(self) -> None:
        """Lease round as request/ack (Paxos.cc lease / lease_ack): the
        leader's OWN lease is extended only when a majority of members
        (self included) acked this round — an isolated leader stops
        being one at its next lease expiry instead of ticking itself
        alive forever."""
        with self._lock:
            e = self.election_epoch
            if self.state != LEADER:
                return
        msg = {"type": "mon_lease", "e": e, "leader": self.rank,
               "last_committed": self.mon.last_committed()}
        acks = 1
        timeout = min(self.call_timeout, max(self.lease / 2, 0.2))
        for r, addr in self._others():
            try:
                rep = self.mon.msgr.call(addr, msg, timeout=timeout)
            except (OSError, TimeoutError):
                continue
            if rep and rep.get("ok"):
                acks += 1
        if acks >= self.majority:
            with self._lock:
                if self.state == LEADER and self.election_epoch == e:
                    self.lease_expiry = time.monotonic() + \
                        self.lease * 3

    def _h_lease(self, msg: Dict) -> Dict:
        e, leader = int(msg["e"]), int(msg["leader"])
        with self._lock:
            if e < self.election_epoch:
                return {"ok": False, "epoch": self.election_epoch}
            if e > self.election_epoch or self.leader_rank != leader:
                if e > self.election_epoch:
                    self.promised_rank = None
                self.election_epoch = e
                self.leader_rank = leader
                self.state = PEON if leader != self.rank else LEADER
                self._persist_locked()
            self.lease_expiry = time.monotonic() + self.lease * 3
            leader_addr = self.addrs[leader]
        # catch up on committed entries we missed (dropped mon_commit) —
        # off-thread so a long fetch cannot stall the leader's lease
        # round into a false demotion.  Single-flight: leases arrive
        # every lease/3 and concurrent fetch threads would race
        # check-then-apply in apply_committed.
        lc = int(msg.get("last_committed", 0))
        if lc > self.mon.last_committed():
            with self._lock:
                spawn = not self._lease_fetching
                self._lease_fetching = True
            if spawn:
                threading.Thread(
                    target=self._lease_fetch, args=(leader_addr, lc),
                    daemon=True,
                    name=f"mon{self.rank}-leasefetch").start()
        return {"ok": True,
                "last_committed": self.mon.last_committed()}

    def _lease_fetch(self, addr: Addr, to_v: int) -> None:
        try:
            self._fetch_from(addr, to_v)
        finally:
            with self._lock:
                self._lease_fetching = False

    # -- replication ------------------------------------------------------
    def replicate(self, v: int, entry: Dict) -> bool:
        """Leader path: stage on a majority, then commit everywhere.
        Returns False (caller rolls back + abdicates) on lost quorum."""
        with self._lock:
            if self.state != LEADER:
                return False
            e = self.election_epoch
        acks = 1
        for r, addr in self._others():
            try:
                rep = self.mon.msgr.call(
                    addr, {"type": "mon_accept", "e": e, "v": v,
                           "entry": entry},
                    timeout=self.call_timeout)
            except (OSError, TimeoutError):
                continue
            if rep.get("ack"):
                acks += 1
        if acks < self.majority:
            return False
        with self._lock:
            if self.state != LEADER or self.election_epoch != e:
                return False
        for r, addr in self._others():
            self.mon.msgr.send(addr, {"type": "mon_commit", "e": e,
                                      "v": v})
        return True

    def _h_accept(self, msg: Dict) -> Dict:
        e, v = int(msg["e"]), int(msg["v"])
        with self._lock:
            if e < self.election_epoch or self.state == LEADER:
                return {"ack": False, "epoch": self.election_epoch}
            if v != self.mon.last_committed() + 1:
                return {"ack": False,
                        "last_committed": self.mon.last_committed()}
            self.uncommitted = {"v": v, "e": e, "entry": msg["entry"]}
            # the stage must hit the store before the ack: with it, a
            # leader crash + staged-peon restart still leaves the entry
            # recoverable by the next election's collect majority
            self._persist_locked()
            return {"ack": True}

    def _h_commit(self, msg: Dict) -> None:
        v = int(msg["v"])
        with self._lock:
            u = self.uncommitted
            if u is None or int(u["v"]) != v:
                return None
            self.uncommitted = None
            entry = u["entry"]
        if v == self.mon.last_committed() + 1:
            self.mon.apply_committed(v, entry)
        # durably clear the stage only AFTER the entry itself is
        # durable: clearing first opens a crash window where a
        # majority-staged entry vanishes from every surviving store.
        # The reverse order is safe — a stale staged copy of an
        # already-applied entry is filtered by the v == lc+1 pick.
        with self._lock:
            self._persist_locked()
        return None

    def _h_fetch(self, msg: Dict) -> Dict:
        frm, to = int(msg["from_v"]), int(msg["to_v"])
        return {"entries": self.mon.committed_entries(frm, to)}

    def abdicate(self) -> None:
        """Step down after a failed replication (lost majority)."""
        with self._lock:
            if self.state == LEADER:
                self.state = ELECTING
                self.leader_rank = None
                self._next_election = time.monotonic()
