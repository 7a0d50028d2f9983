"""Binary OSDMap / CrushMap encoding — the map half of encoding.h.

The port's copy of ``ceph_tpu/osdmap/bincode_maps.py``; a map encodes
to the same bytes in both packages.  The reference distributes maps as
versioned binary encodes (CrushWrapper::encode,
src/crush/CrushWrapper.h:1550; OSDMap::encode, src/osd/OSDMap.cc), not
as text.  The JSON dict forms (``to_dict``) stay the tool and debug
surface.

Array-heavy fields (bucket items and weights, the osd state and weight
vectors) travel as little-endian 32-bit array blobs through numpy.
"""

from __future__ import annotations

from typing import List

import numpy as np

from ..common.bincode import DecodeError, Decoder, Encoder
from ..crush.map import (Bucket, ChooseArg, ChooseArgMap, CrushMap,
                         Rule, RuleStep, Tunables)
from .osdmap import OSDMap, PgPool


def _arr(enc: Encoder, xs, dtype="<i4") -> None:
    enc.blob(np.asarray(list(xs), dtype).tobytes())


def _unarr(dec: Decoder, dtype="<i4") -> List[int]:
    blob = dec.blob()
    try:
        return np.frombuffer(blob, dtype).tolist()
    except ValueError as e:
        # a tampered length word leaves a ragged array blob; that is
        # a protocol error, not a numpy usage error
        raise DecodeError(f"{dec.struct_name}: bad array blob: {e}")


# -- crush ------------------------------------------------------------------

def encode_crush(m: CrushMap, enc: Encoder) -> None:
    enc.start(1, 1)
    t = m.tunables
    for v in (t.choose_local_tries, t.choose_local_fallback_tries,
              t.choose_total_tries, t.chooseleaf_descend_once,
              t.chooseleaf_vary_r, t.chooseleaf_stable):
        enc.u32(v)
    enc.u32(m.max_devices)
    enc.u32(len(m.buckets))
    for idx in sorted(m.buckets):
        b = m.buckets[idx]
        enc.u32(idx).u8(b.alg).u8(b.hash).u32(b.type).u32(b.weight)
        _arr(enc, b.items)
        enc.u32(b.item_weight)
        _arr(enc, b.item_weights, "<u4")
        _arr(enc, b.sum_weights, "<u4")
        _arr(enc, b.node_weights, "<u4")
        enc.u32(b.num_nodes)
        _arr(enc, b.straws, "<u4")
    enc.u32(len(m.rules))
    for rno in sorted(m.rules):
        r = m.rules[rno]
        enc.u32(rno).u32(r.type)
        flat = []
        for s in r.steps:
            flat += [s.op, s.arg1, s.arg2]
        _arr(enc, flat)
    enc.u32(len(m.choose_args))
    for key in sorted(m.choose_args, key=str):
        cam = m.choose_args[key]
        enc.str_(str(key))
        enc.u32(len(cam))
        for bi in sorted(cam):
            ca = cam[bi]
            enc.u32(bi)
            enc.u8(1 if ca.ids is not None else 0)
            if ca.ids is not None:
                _arr(enc, ca.ids)
            enc.u8(1 if ca.weight_set is not None else 0)
            if ca.weight_set is not None:
                enc.u32(len(ca.weight_set))
                for pos in ca.weight_set:
                    _arr(enc, pos, "<u4")
    enc.finish()


def decode_crush(dec: Decoder) -> CrushMap:
    dec.start(1, struct_name="osdmap.crush")
    tun = Tunables(*(dec.u32() for _ in range(6)))
    m = CrushMap(tunables=tun)
    max_devices = dec.u32()
    for _ in range(dec.u32()):
        idx = dec.u32()
        alg, hsh, type_, weight = dec.u8(), dec.u8(), dec.u32(), \
            dec.u32()
        items = _unarr(dec)
        b = Bucket(id=-1 - idx, alg=alg, hash=hsh, type=type_,
                   weight=weight, items=items,
                   item_weight=dec.u32(),
                   item_weights=_unarr(dec, "<u4"),
                   sum_weights=_unarr(dec, "<u4"),
                   node_weights=_unarr(dec, "<u4"),
                   num_nodes=dec.u32(),
                   straws=_unarr(dec, "<u4"))
        m.add_bucket(b)
    for _ in range(dec.u32()):
        rno, rtype = dec.u32(), dec.u32()
        flat = _unarr(dec)
        steps = [RuleStep(*flat[i:i + 3])
                 for i in range(0, len(flat), 3)]
        m.add_rule(Rule(steps=steps, type=rtype), rno)
    for _ in range(dec.u32()):
        key = dec.str_()
        cam = ChooseArgMap()
        for _ in range(dec.u32()):
            bi = dec.u32()
            ids = _unarr(dec) if dec.u8() else None
            ws = None
            if dec.u8():
                ws = [_unarr(dec, "<u4") for _ in range(dec.u32())]
            cam[bi] = ChooseArg(ids=ids, weight_set=ws)
        # mirror from_dict's key convention: pool ids arrive as str
        m.choose_args[int(key) if key.lstrip("-").isdigit()
                      else key] = cam
    m.max_devices = max(m.max_devices, max_devices)
    dec.finish()
    return m


# -- osdmap -----------------------------------------------------------------

def encode_osdmap(m: OSDMap, enc: Encoder) -> None:
    enc.start(1, 1)
    enc.u32(m.epoch).u32(m.max_osd)
    _arr(enc, m.osd_state, "<u4")
    _arr(enc, m.osd_weight, "<u4")
    enc.u8(1 if m.osd_primary_affinity is not None else 0)
    if m.osd_primary_affinity is not None:
        _arr(enc, m.osd_primary_affinity, "<u4")
    enc.u32(len(m.pools))
    for pid in sorted(m.pools):
        p = m.pools[pid]
        enc.u32(pid).u8(p.pool_type).u32(p.size).u32(p.min_size)
        enc.u32(p.pg_num).u32(p.pgp_num).u32(p.crush_rule)
        enc.u32(p.flags)
        enc.str_(p.erasure_code_profile)
    for table in (m.pg_upmap, m.pg_temp):
        enc.u32(len(table))
        for (pool, ps) in sorted(table):
            enc.u32(pool).u32(ps)
            _arr(enc, table[(pool, ps)])
    enc.u32(len(m.pg_upmap_items))
    for (pool, ps) in sorted(m.pg_upmap_items):
        enc.u32(pool).u32(ps)
        flat = []
        for a, b in m.pg_upmap_items[(pool, ps)]:
            flat += [a, b]
        _arr(enc, flat)
    enc.u32(len(m.primary_temp))
    for (pool, ps) in sorted(m.primary_temp):
        enc.u32(pool).u32(ps)
        enc.i64(m.primary_temp[(pool, ps)])
    encode_crush(m.crush, enc)
    enc.finish()


def decode_osdmap(dec: Decoder) -> OSDMap:
    dec.start(1, struct_name="osdmap.full")
    epoch, max_osd = dec.u32(), dec.u32()
    osd_state = _unarr(dec, "<u4")
    osd_weight = _unarr(dec, "<u4")
    affinity = _unarr(dec, "<u4") if dec.u8() else None
    pools = {}
    for _ in range(dec.u32()):
        pid = dec.u32()
        pools[pid] = PgPool(
            pool_type=dec.u8(), size=dec.u32(), min_size=dec.u32(),
            pg_num=dec.u32(), pgp_num=dec.u32(),
            crush_rule=dec.u32(), flags=dec.u32(),
            erasure_code_profile=dec.str_())
    pg_upmap = {}
    pg_temp = {}
    for table in (pg_upmap, pg_temp):
        for _ in range(dec.u32()):
            pool, ps = dec.u32(), dec.u32()
            table[(pool, ps)] = _unarr(dec)
    pg_upmap_items = {}
    for _ in range(dec.u32()):
        pool, ps = dec.u32(), dec.u32()
        flat = _unarr(dec)
        pg_upmap_items[(pool, ps)] = [
            (flat[i], flat[i + 1]) for i in range(0, len(flat), 2)]
    primary_temp = {}
    for _ in range(dec.u32()):
        pool, ps = dec.u32(), dec.u32()
        primary_temp[(pool, ps)] = dec.i64()
    crush = decode_crush(dec)
    m = OSDMap(crush)
    m.epoch = epoch
    m.max_osd = max_osd
    m.osd_state = osd_state
    m.osd_weight = osd_weight
    m.osd_primary_affinity = affinity
    m.pools = pools
    m.pg_upmap = pg_upmap
    m.pg_upmap_items = pg_upmap_items
    m.pg_temp = pg_temp
    m.primary_temp = primary_temp
    dec.finish()
    return m


def _typed(fn, buf: bytes, struct_name: str):
    """Decode with every failure surfaced as MalformedInput: bytes
    that survive the envelope but build an impossible map (a dup
    bucket id from a flipped byte, a ragged rule program) are still
    protocol errors, never raw ValueError/struct.error escapes."""
    try:
        return fn(Decoder(buf, struct_name=struct_name))
    except DecodeError:
        raise
    except (ValueError, TypeError, KeyError, IndexError,
            OverflowError) as e:
        raise DecodeError(f"{struct_name}: bad payload: {e!r}")


def osdmap_to_bytes(m: OSDMap) -> bytes:
    enc = Encoder()
    encode_osdmap(m, enc)
    return enc.bytes()


def osdmap_from_bytes(buf: bytes) -> OSDMap:
    return _typed(decode_osdmap, buf, "osdmap.full")


def crush_to_bytes(m: CrushMap) -> bytes:
    enc = Encoder()
    encode_crush(m, enc)
    return enc.bytes()


def crush_from_bytes(buf: bytes) -> CrushMap:
    return _typed(decode_crush, buf, "osdmap.crush")


def payload_map(payload: dict) -> OSDMap:
    """Decode a monitor map payload in either wire form (map_bin,
    binary) or store/debug form (map, JSON dict)."""
    if "map_bin" in payload:
        return osdmap_from_bytes(payload["map_bin"])
    return OSDMap.from_dict(payload["map"])
