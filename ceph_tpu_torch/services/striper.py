"""Striper — scale one logical object across many RADOS objects.

The role of src/libradosstriper (+ RBD stripe_unit/stripe_count, CephFS
file layouts): SURVEY §5 names striping as the reference's "one logical
object beyond one node" axis.  A striped object is cut into
``stripe_unit`` slices laid out round-robin over ``stripe_count``
backing objects per object set (the standard RADOS striping layout:
stripeno = off / unit; objectno = (stripeno / count) * count +
stripeno % count).  Size travels in a header sub-object, as
libradosstriper keeps it in an xattr of the first piece.

Each backing object then takes the normal pool data path (replicated
copies or EC shards) — striping composes with, not replaces, the EC
layer.

The port's copy of ``ceph_tpu/services/striper.py``: its EC I/O is the
port ``Client``'s, on the client's device.
"""

from __future__ import annotations

from typing import List, Tuple

from .client import Client

HEADER_SUFFIX = ".striper-header"


def _piece_name(oid: str, objectno: int) -> str:
    return f"{oid}.{objectno:016x}"


class Striper:
    def __init__(self, client: Client, stripe_unit: int = 4096,
                 stripe_count: int = 4, object_size: int = 1 << 22):
        if stripe_unit <= 0 or stripe_count <= 0:
            raise ValueError("stripe_unit/stripe_count must be > 0")
        if object_size % stripe_unit:
            raise ValueError("object_size must be a multiple of "
                             "stripe_unit")
        self.client = client
        self.unit = stripe_unit
        self.count = stripe_count
        self.object_size = object_size

    # -- layout math ---------------------------------------------------
    def extent_map(self, offset: int, length: int
                   ) -> List[Tuple[int, int, int, int]]:
        """logical [offset, offset+length) ->
        [(objectno, obj_offset, logical_offset, run_length)].

        The standard RADOS layout (file_layout_t semantics): stripes
        rotate over the ``stripe_count`` objects of the current object
        SET; the set advances only once its objects are full
        (``object_size`` bytes each)."""
        spo = self.object_size // self.unit  # stripes per object
        per_set = spo * self.count           # stripes per object set
        out = []
        end = offset + length
        while offset < end:
            stripeno = offset // self.unit
            within = offset % self.unit
            setno = stripeno // per_set
            in_set = stripeno % per_set
            stripepos = in_set % self.count
            block = in_set // self.count     # unit-block inside object
            objectno = setno * self.count + stripepos
            obj_off = block * self.unit + within
            run = min(self.unit - within, end - offset)
            out.append((objectno, obj_off, offset, run))
            offset += run
        return out

    # -- data path -----------------------------------------------------
    def write(self, pool_id: int, oid: str, data: bytes) -> None:
        pieces: dict = {}
        for objectno, obj_off, log_off, run in self.extent_map(
                0, len(data)):
            buf = pieces.setdefault(objectno, bytearray())
            if len(buf) < obj_off + run:
                buf.extend(b"\0" * (obj_off + run - len(buf)))
            buf[obj_off:obj_off + run] = data[log_off:log_off + run]
        for objectno, buf in sorted(pieces.items()):
            self.client.put(pool_id, _piece_name(oid, objectno),
                            bytes(buf))
        header = (f"{len(data)}:{self.unit}:{self.count}:"
                  f"{self.object_size}").encode()
        self.client.put(pool_id, oid + HEADER_SUFFIX, header)

    def read(self, pool_id: int, oid: str, offset: int = 0,
             length: int = -1) -> bytes:
        size, unit, count, osize = self.stat(pool_id, oid)
        if (unit, count, osize) != (self.unit, self.count,
                                    self.object_size):
            raise ValueError(
                f"layout mismatch: object striped "
                f"{unit}/{count}/{osize}, reader configured "
                f"{self.unit}/{self.count}/{self.object_size}")
        if length < 0:
            length = size - offset
        length = max(0, min(length, size - offset))
        if not length:
            return b""
        out = bytearray(length)
        cache: dict = {}
        for objectno, obj_off, log_off, run in self.extent_map(
                offset, length):
            piece = cache.get(objectno)
            if piece is None:
                piece = self.client.get(
                    pool_id, _piece_name(oid, objectno))
                cache[objectno] = piece
            chunk = piece[obj_off:obj_off + run]
            out[log_off - offset:log_off - offset + len(chunk)] = chunk
        return bytes(out)

    def stat(self, pool_id: int, oid: str
             ) -> Tuple[int, int, int, int]:
        """(size, stripe_unit, stripe_count, object_size)."""
        header = self.client.get(pool_id, oid + HEADER_SUFFIX)
        size, unit, count, osize = header.decode().split(":")
        return int(size), int(unit), int(count), int(osize)
