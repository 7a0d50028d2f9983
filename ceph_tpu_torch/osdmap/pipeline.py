"""The batched placement pipeline: every PG of a pool in one pass.

The port of ``ceph_tpu/osdmap/pipeline_jax.py``: the OSDMap chain
(OSDMap.cc:2665 ``_pg_to_up_acting_osds``) for all PGs of a pool at
once, pps seed -> CRUSH -> nonexistent filter -> upmap -> up filter ->
primary affinity -> pg_temp overlay.  The reference runs it per PG on
the CPU and batches with a thread pool (ParallelPGMapper,
src/osd/OSDMapMapping.h:18).  Here the CRUSH stage is kernel K2
(``crush.mapper.crush_rule_batched``) over the PGs' pps seeds, and the
other stages are PyTorch ops over [pg_num, R] tensors on the same
device.

Exception tables (pg_upmap, pg_upmap_items, pg_temp, primary_temp) are
lowered host-side to dense per-PG tensors; a stage no PG uses is
skipped, as the JAX version compiles it out.  OSD weights, states and
affinities stay runtime tensors: mark-out and reweight re-run
``map_all`` with no other work.  Upmap and temp edits go through
``PoolMapper.refresh_tables()``, which lowers the tables again.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..crush.constants import CRUSH_ITEM_NONE as NONE
from ..crush.hash import crush_hash32_2
from ..crush.map_arrays import as_i32, encode_map
from ..crush.mapper import _rule_steps, compile_rule, crush_rule_batched
from ..device import (canonical_device, device_guard, gather,
                      resolve_device)
from ..parallel.placement import Mesh, replicate_arrays
from .osdmap import (DEFAULT_PRIMARY_AFFINITY, FLAG_HASHPSPOOL,
                     MAX_PRIMARY_AFFINITY, OSD_EXISTS, OSD_UP, OSDMap,
                     PgPool)

M32 = 0xFFFFFFFF


def _stable_mod(x, b: int, bmask: int):
    """ceph_stable_mod (src/include/rados.h:96) over an int64 tensor."""
    lo = x & bmask
    return torch.where(lo < b, lo, x & (bmask >> 1))


def _first(mask):
    """Index of the first true entry of each row (0 where none is):
    argmax over int, where the first maximum wins."""
    return mask.to(torch.int32).argmax(dim=1)


def _compact(row, keep, rlen, idx):
    """Stable left-compaction of the kept entries of each row (pools
    that can shift); the rest go, NONE pads.  Returns (row, new_len)."""
    R = idx.numel()
    keep = keep & (idx < rlen[:, None])
    order = torch.sort(torch.where(keep, idx, idx + R), dim=1,
                       stable=True).indices
    newlen = keep.sum(dim=1)
    return (torch.where(idx < newlen[:, None], row.gather(1, order), NONE),
            newlen)


def _mask_none(row, keep, rlen, idx):
    """Positional pools: entries not kept become NONE, the length
    stays."""
    return (torch.where((idx < rlen[:, None]) & keep, row, NONE), rlen)


@dataclass
class _DenseTables:
    """Host-lowered exception tables, one row per raw ps."""

    upmap: Optional[np.ndarray]        # i32[pg, R]
    upmap_len: Optional[np.ndarray]    # i32[pg]  (-1 = no entry)
    pairs: Optional[np.ndarray]        # i32[pg, P, 2]
    npairs: Optional[np.ndarray]       # i32[pg]
    temp: Optional[np.ndarray]         # i32[pg, R]
    temp_len: Optional[np.ndarray]     # i32[pg]  (-1 = no entry)
    ptemp: Optional[np.ndarray]        # i32[pg]  (-1 = no entry)


def _lower_tables(m: OSDMap, pool_id: int, pool: PgPool) -> _DenseTables:
    n = pool.pg_num
    R = pool.size

    def rows(table, name, maxw=None):
        # entries with ps >= pg_num are unreachable in the scalar path
        # (lookups go through raw_pg_to_ps < pg_num); drop them here too
        out = {ps: v for (pid, ps), v in table.items()
               if pid == pool_id and ps < n}
        if maxw is not None:
            for ps, v in out.items():
                if len(v) > maxw:
                    raise ValueError(
                        f"{name}[{pool_id}.{ps}] has {len(v)} entries, "
                        f"more than pool size {maxw}; the reference "
                        f"monitor rejects such mappings and the batched "
                        f"pipeline's fixed result width cannot hold them")
        return out

    up = rows(m.pg_upmap, "pg_upmap", R)
    items = rows(m.pg_upmap_items, "pg_upmap_items")
    temps = rows(m.pg_temp, "pg_temp", R)
    ptemps = rows(m.primary_temp, "primary_temp")

    t = _DenseTables(None, None, None, None, None, None, None)
    if up:
        t.upmap = np.full((n, R), NONE, np.int32)
        t.upmap_len = np.full(n, -1, np.int32)
        for ps, v in up.items():
            t.upmap[ps, :len(v)] = v
            t.upmap_len[ps] = len(v)
    if items:
        P = max(len(v) for v in items.values())
        t.pairs = np.zeros((n, P, 2), np.int32)
        t.npairs = np.zeros(n, np.int32)
        for ps, v in items.items():
            for j, (a, b) in enumerate(v):
                t.pairs[ps, j] = (a, b)
            t.npairs[ps] = len(v)
    if temps:
        t.temp = np.full((n, R), NONE, np.int32)
        t.temp_len = np.full(n, -1, np.int32)
        for ps, v in temps.items():
            t.temp[ps, :len(v)] = v
            t.temp_len[ps] = len(v)
    if ptemps:
        t.ptemp = np.full(n, -1, np.int32)
        for ps, v in ptemps.items():
            t.ptemp[ps] = v
    return t


@dataclass
class _Shard:
    """A range [lo, hi) of the pool's PGs on one device, with its slice
    of the pps seeds and of the exception tables."""

    dev: torch.device
    lo: int
    hi: int
    pps: torch.Tensor
    pps_i32: torch.Tensor
    idx: torch.Tensor
    trow: dict


class PoolMapper:
    """Batched ``pg_to_up_acting`` for one pool on ``device``.

    >>> pm = PoolMapper(osdmap, pool_id)
    >>> out = pm.map_all()   # dict of tensors over every PG

    The map's CRUSH arrays (with the pool's choose_args), the pps seed
    of every PG and the exception tables are lowered once and stay on
    the device.

    ``mesh`` (``parallel.placement.Mesh``; ``device`` is then its first
    device) splits the PG axis into shards of ceil(pg_num / size), each
    with its slice of the exception tables, over the mesh's devices:
    the map's arrays and the OSD vectors go to each distinct device,
    every stage runs a shard where it lies (one K2 launch a shard, all
    launched before any is waited for), and the outputs are gathered
    on the first device.  Every PG is independent, so the outputs equal
    the unsplit pipeline's.
    """

    def __init__(self, m: OSDMap, pool_id: int, mesh=None, device="cuda"):
        self.mesh = mesh
        self.device = dev = mesh.devices[0] if mesh is not None \
            else canonical_device(resolve_device(device))
        self.m = m
        self.pool_id = pool_id
        self.pool = pool = m.pools[pool_id]
        self.R = pool.size
        self.shift = pool.can_shift_osds()
        self.prog = self.arrays = None
        self._arrays_on = {}
        if pool.crush_rule in m.crush.rules:
            static, arrays = encode_map(m.crush,
                                        m.crush.choose_args.get(pool_id))
            self.prog = compile_rule(
                static, _rule_steps(m.crush, pool.crush_rule), self.R)
            self._arrays_on = replicate_arrays(
                arrays, mesh if mesh is not None else Mesh([dev]))
            self.arrays = self._arrays_on[dev]
        # pg_pool_t::raw_pg_to_pps (osd_types.cc:1798): a u32 per PG
        ps = torch.arange(pool.pg_num, dtype=torch.int64, device=dev)
        mm = _stable_mod(ps, pool.pgp_num, pool.pgp_num_mask)
        if pool.flags & FLAG_HASHPSPOOL:
            self.pps = crush_hash32_2(mm, pool_id & M32)
        else:
            self.pps = (mm + (pool_id & M32)) & M32
        self.pps_i32 = as_i32(self.pps, dev)
        self.idx = torch.arange(self.R, dtype=torch.int64, device=dev)
        self.refresh_tables()

    def refresh_tables(self):
        """Lower the exception tables again after upmap or pg_temp edits;
        a stage is skipped while its table is empty."""
        tabs = _lower_tables(self.m, self.pool_id, self.pool)
        self._trow = {k: torch.from_numpy(v).to(self.device, torch.int64)
                      for k, v in vars(tabs).items() if v is not None}
        n = self.pool.pg_num
        spans = [(self.device, 0, n)] if self.mesh is None else \
            [(d, lo, hi) for _, d, lo, hi in self.mesh.shards(n)] or \
            [(self.device, 0, 0)]
        self._shards = []
        for d, lo, hi in spans:
            with device_guard(d):
                self._shards.append(_Shard(
                    d, lo, hi, self.pps[lo:hi].to(d, non_blocking=True),
                    self.pps_i32[lo:hi].to(d, non_blocking=True),
                    self.idx.to(d, non_blocking=True),
                    {k: v[lo:hi].to(d, non_blocking=True)
                     for k, v in self._trow.items()}))

    def runtime_args(self):
        """The OSDMap's weights (u32 as int32), states and primary
        affinities (u32 as int32) as tensors on the device."""
        m = self.m
        paff = (m.osd_primary_affinity if m.osd_primary_affinity is not None
                else [DEFAULT_PRIMARY_AFFINITY] * m.max_osd)
        return (as_i32(np.asarray(m.osd_weight, np.uint32), self.device),
                as_i32(np.asarray(m.osd_state, np.int32), self.device),
                as_i32(np.asarray(paff, np.uint32), self.device))

    def _osd_ok(self, osd, state):
        """(exists, up) of each OSD id, with its range checked."""
        inr = (osd >= 0) & (osd < state.numel())
        st = state[osd.clamp(0, max(state.numel() - 1, 0))]
        return inr & ((st & OSD_EXISTS) != 0), inr & ((st & OSD_UP) != 0)

    def _weight_zero(self, osd, weight):
        """A real OSD id (not NONE, in range) whose weight is 0."""
        inr = (osd != NONE) & (osd >= 0) & (osd < weight.numel())
        return inr & (weight[osd.clamp(0, max(weight.numel() - 1, 0))] == 0)

    def map_all(self, weight=None, state=None, paff=None):
        """Map every PG of the pool.  ``weight``, ``state``, ``paff``:
        per-OSD overrides of the map's (numpy, lists or tensors; u32 as
        bit patterns); the primary-affinity stage runs when the map has
        affinities or ``paff`` is given.  Returns a dict of int32
        tensors on the device (a mesh's first device): up [pg, R],
        up_len [pg], up_primary [pg], acting [pg, R], acting_len [pg],
        acting_primary [pg]."""
        w0, s0, p0 = self.runtime_args() \
            if any(v is None for v in (weight, state, paff)) \
            else (None, None, None)
        dev = self.device
        has_aff = paff is not None or self.m.osd_primary_affinity is not None
        weight = w0 if weight is None else as_i32(weight, dev)
        state = (s0 if state is None else as_i32(state, dev)).to(torch.int64)
        paff = (p0 if paff is None else as_i32(paff, dev)).to(torch.int64) \
            & M32
        vectors = {dev: (weight, state, paff)}
        outs = []
        for sh in self._shards:
            with device_guard(sh.dev):
                if sh.dev not in vectors:
                    vectors[sh.dev] = tuple(v.to(sh.dev, non_blocking=True)
                                            for v in vectors[dev])
                outs.append(self._map_rows(sh, *vectors[sh.dev], has_aff))
        return {k: gather([o[k] for o in outs], dev) for k in outs[0]}

    def _map_rows(self, sh: _Shard, weight, state, paff, has_aff: bool):
        """The pipeline over one shard's PGs, on its device."""
        dev, idx, R, t = sh.dev, sh.idx, self.R, sh.trow
        n = sh.hi - sh.lo
        if self.prog is not None:
            raw, rlen = crush_rule_batched(self._arrays_on[dev], self.prog,
                                           weight, sh.pps_i32)
            raw, rlen = raw.to(torch.int64), rlen.to(torch.int64)
        else:
            raw = torch.full((n, R), NONE, dtype=torch.int64, device=dev)
            rlen = torch.zeros(n, dtype=torch.int64, device=dev)
        squeeze = _compact if self.shift else _mask_none

        # _remove_nonexistent_osds (OSDMap.cc:2408)
        ex, _ = self._osd_ok(raw, state)
        raw, rlen = squeeze(raw, ex, rlen, idx)

        # _apply_upmap (OSDMap.cc:2463)
        rejected = torch.zeros(n, dtype=torch.bool, device=dev)
        if "upmap" in t:
            urow, ulen = t["upmap"], t["upmap_len"]
            marked_out = self._weight_zero(urow, weight) & \
                (idx < ulen[:, None])
            # a marked-out target rejects the whole entry and skips
            # pg_upmap_items for this PG (OSDMap.cc:2472)
            rejected = (ulen >= 0) & marked_out.any(dim=1)
            use = (ulen >= 0) & ~rejected
            raw = torch.where(use[:, None],
                              torch.where(idx < ulen[:, None], urow, NONE),
                              raw)
            rlen = torch.where(use, ulen, rlen)
        if "pairs" in t:
            pairs, npairs = t["pairs"], t["npairs"]
            for p in range(pairs.shape[1]):
                frm, to = pairs[:, p, 0], pairs[:, p, 1]
                in_seg = idx < rlen[:, None]
                has_to = (in_seg & (raw == to[:, None])).any(dim=1)
                cand = in_seg & (raw == frm[:, None]) & \
                    ~self._weight_zero(to, weight)[:, None]
                do = (p < npairs) & ~has_to & cand.any(dim=1) & ~rejected
                pos = _first(cand)[:, None]
                raw = raw.scatter(1, pos, torch.where(
                    do[:, None], to[:, None], raw.gather(1, pos)))

        # _raw_to_up_osds (OSDMap.cc:2510)
        ex, upb = self._osd_ok(raw, state)
        up, ulen2 = squeeze(raw, ex & upb, rlen, idx)

        # _pick_primary (OSDMap.cc:2452)
        valid = (idx < ulen2[:, None]) & (up != NONE)
        any_valid = valid.any(dim=1)
        up_primary = torch.where(
            any_valid, up.gather(1, _first(valid)[:, None])[:, 0], -1)

        # _apply_primary_affinity (OSDMap.cc:2535); pps and OSD ids hash
        # as u32
        if has_aff:
            a = paff[up.clamp(0, paff.numel() - 1)]
            nondefault = valid & (a != DEFAULT_PRIMARY_AFFINITY)
            h = crush_hash32_2(sh.pps[:, None], up) >> 16
            accept = valid & ~((a < MAX_PRIMARY_AFFINITY) & (h >= a))
            pos = torch.where(accept.any(dim=1), _first(accept),
                              torch.where(any_valid, _first(valid), -1))
            engage = nondefault.any(dim=1) & (pos >= 0)
            posc = pos.clamp(0, R - 1).to(torch.int64)
            up_primary = torch.where(
                engage, up.gather(1, posc[:, None])[:, 0], up_primary)
            if self.shift:
                # the primary moves to the front, the ones before it
                # one place back
                src = torch.where(idx == 0, posc[:, None],
                                  torch.where(idx <= posc[:, None],
                                              (idx - 1).clamp(min=0), idx))
                up = torch.where((engage & (posc > 0))[:, None],
                                 up.gather(1, src), up)

        # _get_temp_osds overlay (OSDMap.cc:2590)
        acting, alen, acting_primary = up, ulen2, up_primary
        if "temp" in t:
            trow, tlen = t["temp"], t["temp_len"]
            tex, tup = self._osd_ok(trow, state)
            ft, flen = squeeze(trow, tex & tup, tlen.clamp(min=0), idx)
            use_t = (tlen >= 0) & (flen > 0)
            tvalid = (idx < flen[:, None]) & (ft != NONE)
            tprim = torch.where(tvalid.any(dim=1),
                                ft.gather(1, _first(tvalid)[:, None])[:, 0],
                                -1)
            acting = torch.where(use_t[:, None], ft, acting)
            alen = torch.where(use_t, flen, alen)
            acting_primary = torch.where(use_t, tprim, acting_primary)
        if "ptemp" in t:
            pt = t["ptemp"]
            acting_primary = torch.where(pt != -1, pt, acting_primary)

        out = {"up": up, "up_len": ulen2, "up_primary": up_primary,
               "acting": acting, "acting_len": alen,
               "acting_primary": acting_primary}
        return {k: v.to(torch.int32) for k, v in out.items()}
