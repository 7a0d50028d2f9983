"""Image — the librbd analogue: a block device striped over objects.

The role of src/librbd at this framework's scope: an image is a
fixed-size virtual block device carved into stripe pieces
(``services.striper`` layout) over a pool, with a header object
carrying geometry and the snapshot table, random-offset read/write via
read-modify-write on the backing pieces, resize (shrink discards
truncated data, as the block-device contract requires), and
point-in-time snapshots with rollback.  Snapshots remember their size,
so a later shrink doesn't truncate history.

Divergence note: the reference snapshots in place via RADOS
self-managed snaps (object clones inside the same PG); here a snapshot
materializes copies under ``name@snap`` piece names — the user-visible
semantics (immutable point-in-time view, rollback, independent reads)
are preserved; the storage cost differs.

The port's copy of ``ceph_tpu/services/image.py``: its EC I/O is the
port ``Client``'s, on the client's device.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from ..common import encoding
from .client import Client, ObjectNotFound
from .striper import Striper, _piece_name

# wire/disk version of the header object (wirecheck entry
# rbd.image_header).  Writer v0 = the pre-envelope raw-dict era;
# decode stays lenient so existing images keep opening.
HEADER_V = 1


def encode_header(header: Dict) -> bytes:
    return encoding.encode(dict(header), HEADER_V, 1).encode()


def decode_header(raw: bytes) -> Dict:
    v, d = encoding.decode_any(raw, supported=HEADER_V,
                               struct="rbd.image_header")
    if not isinstance(d, dict):
        raise encoding.MalformedInput(
            f"rbd.image_header v{v}: payload is not an object")
    return d


def _header_oid(name: str) -> str:
    return f"rbd_header.{name}"


class ImageError(Exception):
    pass


class Image:
    def __init__(self, client: Client, pool_id: int, name: str,
                 header: Dict):
        self.client = client
        self.pool_id = pool_id
        self.name = name
        self._h = header
        self._parent_img: Optional["Image"] = None
        self.striper = Striper(client,
                               stripe_unit=header["stripe_unit"],
                               stripe_count=header["stripe_count"],
                               object_size=header["object_size"])

    # -- lifecycle ------------------------------------------------------
    @classmethod
    def create(cls, client: Client, pool_id: int, name: str,
               size: int, stripe_unit: int = 4096,
               stripe_count: int = 4,
               object_size: int = 1 << 16) -> "Image":
        try:
            client.get(pool_id, _header_oid(name), notfound_retries=0)
        except ObjectNotFound:
            pass  # the only evidence the image does NOT exist;
            # transient errors (TimeoutError/OSError) propagate so a
            # degraded moment can never silently clobber a header
        else:
            raise ImageError(f"image {name!r} exists")
        header = {"size": size, "stripe_unit": stripe_unit,
                  "stripe_count": stripe_count,
                  "object_size": object_size, "snaps": [],
                  "parent": None, "children": []}
        client.put(pool_id, _header_oid(name), encode_header(header))
        return cls(client, pool_id, name, header)

    @classmethod
    def open(cls, client: Client, pool_id: int, name: str) -> "Image":
        try:
            raw = client.get(pool_id, _header_oid(name))
        except ObjectNotFound:
            raise ImageError(f"no image {name!r}")
        return cls(client, pool_id, name, decode_header(raw))

    def _save_header(self) -> None:
        self.client.put(self.pool_id, _header_oid(self.name),
                        encode_header(self._h))

    def _reload_header(self) -> None:
        """The header lives in RADOS; another handle (a clone's
        flatten, a second opener) may have changed it — snapshot/clone
        bookkeeping re-reads before deciding."""
        raw = self.client.get(self.pool_id, _header_oid(self.name))
        self._h = decode_header(raw)

    # -- geometry -------------------------------------------------------
    @property
    def size(self) -> int:
        return self._h["size"]

    def resize(self, size: int) -> None:
        """Grow or shrink.  Shrinking zeroes exactly the truncated
        extents so a later grow reads zeros there (the block-device
        contract).  Striping interleaves live and truncated stripe
        units within one backing object, so truncation must patch
        per-extent — never drop whole objects."""
        old = self.size
        if size < old:
            # within one backing object, logical offsets grow with
            # obj_off, so the truncated region is a contiguous TAIL:
            # keep [0, min truncated obj_off) and drop the rest.  A
            # boundary of 0 means the whole object goes — no read
            # needed (large shrinks don't transfer the tail back).
            boundary: Dict[int, int] = {}
            for objectno, obj_off, _log_off, _run in \
                    self.striper.extent_map(size, old - size):
                cur = boundary.get(objectno)
                if cur is None or obj_off < cur:
                    boundary[objectno] = obj_off
            for objectno, keep in sorted(boundary.items()):
                piece = b"" if keep == 0 else \
                    self._piece(self.name, objectno)[:keep]
                self.client.put(self.pool_id,
                                _piece_name(self.name, objectno),
                                piece.rstrip(b"\0"))
        self._h["size"] = size
        p = self._h.get("parent")
        if p and size < p["overlap"]:
            # shrink trims the COW window: a later grow reads zeros,
            # never stale parent bytes (librbd overlap semantics)
            p["overlap"] = size
        self._save_header()

    def snaps(self) -> List[str]:
        return [s["name"] for s in self._h["snaps"]]

    def _snap(self, snap: str) -> Dict:
        for s in self._h["snaps"]:
            if s["name"] == snap:
                return s
        raise ImageError(f"no snap {snap!r}")

    # -- data path (read-modify-write over stripe pieces) ---------------
    def _piece(self, data_name: str, objectno: int) -> bytes:
        try:
            # sparse images miss pieces constantly: definitive ENOENT,
            # no backfill-race retries on this path
            return self.client.get(self.pool_id,
                                   _piece_name(data_name, objectno),
                                   notfound_retries=0)
        except ObjectNotFound:
            if data_name == self.name and self._h.get("parent"):
                return self._parent_piece(objectno)
            return b""  # sparse: unwritten pieces read as zeros

    def _parent_piece(self, objectno: int) -> bytes:
        """COW fallthrough (librbd parent overlap reads): an unwritten
        child piece reads from the parent snapshot, trimmed to the
        overlap window (shrink-then-grow must expose zeros, not stale
        parent bytes)."""
        p = self._h["parent"]
        if self._parent_img is None:
            self._parent_img = Image.open(self.client, p["pool"],
                                          p["name"])
        cache = getattr(self, "_overlap_keep", None)
        if cache is None or cache[0] != p["overlap"]:
            # one extent-map walk per overlap value, not per read
            keeps: Dict[int, int] = {}
            for objn, obj_off, _log, run in \
                    self.striper.extent_map(0, p["overlap"]):
                keeps[objn] = max(keeps.get(objn, 0), obj_off + run)
            cache = (p["overlap"], keeps)
            self._overlap_keep = cache
        keep = cache[1].get(objectno, 0)
        if keep == 0:
            return b""
        piece = self._parent_img._piece(
            f"{p['name']}@{p['snap']}", objectno)
        return piece[:keep]

    def write(self, offset: int, data: bytes) -> int:
        if offset + len(data) > self.size:
            raise ImageError("write past end of image")
        touched: Dict[int, bytearray] = {}
        for objectno, obj_off, log_off, run in \
                self.striper.extent_map(offset, len(data)):
            buf = touched.get(objectno)
            if buf is None:
                buf = bytearray(self._piece(self.name, objectno))
                touched[objectno] = buf
            if len(buf) < obj_off + run:
                buf.extend(b"\0" * (obj_off + run - len(buf)))
            buf[obj_off:obj_off + run] = \
                data[log_off - offset:log_off - offset + run]
        for objectno, buf in sorted(touched.items()):
            self.client.put(self.pool_id,
                            _piece_name(self.name, objectno),
                            bytes(buf))
        return len(data)

    def _read_pieces(self, data_name: str, offset: int, length: int,
                     limit: int) -> bytes:
        length = max(0, min(length, limit - offset))
        if not length:
            return b""
        out = bytearray(length)  # unwritten extents read as zeros
        cache: Dict[int, bytes] = {}
        for objectno, obj_off, log_off, run in \
                self.striper.extent_map(offset, length):
            piece = cache.get(objectno)
            if piece is None:
                piece = self._piece(data_name, objectno)
                cache[objectno] = piece
            chunk = piece[obj_off:obj_off + run]
            out[log_off - offset:log_off - offset + len(chunk)] = chunk
        return bytes(out)

    def read(self, offset: int, length: int) -> bytes:
        return self._read_pieces(self.name, offset, length, self.size)

    # -- snapshots -------------------------------------------------------
    def _pieces_in_use(self, size: int) -> List[int]:
        objs = set()
        for objectno, _o, _l, _r in self.striper.extent_map(0, size):
            objs.add(objectno)
        return sorted(objs)

    def snapshot(self, snap: str) -> None:
        if any(s["name"] == snap for s in self._h["snaps"]):
            raise ImageError(f"snap {snap!r} exists")
        for objectno in self._pieces_in_use(self.size):
            piece = self._piece(self.name, objectno)
            if piece:
                self.client.put(
                    self.pool_id,
                    _piece_name(f"{self.name}@{snap}", objectno),
                    piece)
        self._h["snaps"].append({"name": snap, "size": self.size})
        self._save_header()

    def read_snap(self, snap: str, offset: int, length: int) -> bytes:
        info = self._snap(snap)
        return self._read_pieces(f"{self.name}@{snap}", offset,
                                 length, info["size"])

    def rollback(self, snap: str) -> None:
        """Restore the image data (and size) to the snapshot's state."""
        info = self._snap(snap)
        for objectno in self._pieces_in_use(
                max(info["size"], self.size)):
            piece = self._piece(f"{self.name}@{snap}", objectno)
            self.client.put(self.pool_id,
                            _piece_name(self.name, objectno), piece)
        self._h["size"] = info["size"]
        self._save_header()

    # -- clones (librbd COW clone / protect / flatten) -------------------
    def protect_snap(self, snap: str) -> None:
        """Clones may only hang off protected snapshots — otherwise a
        snap removal would orphan children (librbd's protect rule)."""
        self._reload_header()
        self._snap(snap)["protected"] = True
        self._save_header()

    def unprotect_snap(self, snap: str) -> None:
        self._reload_header()
        info = self._snap(snap)
        kids = [c for c in self._h.get("children", [])
                if c["snap"] == snap]
        if kids:
            raise ImageError(
                f"snap {snap!r} has children: "
                f"{[c['name'] for c in kids]}")
        info["protected"] = False
        self._save_header()

    def clone(self, snap: str, clone_name: str) -> "Image":
        """COW clone: the child shares the parent snapshot's data and
        copies nothing; child writes land on child pieces only, child
        reads fall through to the parent inside the overlap window."""
        self._reload_header()  # a sibling clone's children record
        # must never be clobbered by a stale cached header
        info = self._snap(snap)
        if not info.get("protected"):
            raise ImageError(f"snap {snap!r} is not protected")
        child = Image.create(
            self.client, self.pool_id, clone_name, info["size"],
            stripe_unit=self._h["stripe_unit"],
            stripe_count=self._h["stripe_count"],
            object_size=self._h["object_size"])
        child._h["parent"] = {"pool": self.pool_id,
                              "name": self.name, "snap": snap,
                              "overlap": info["size"]}
        child._save_header()
        self._h.setdefault("children", []).append(
            {"name": clone_name, "snap": snap})
        self._save_header()
        return child

    def flatten(self) -> None:
        """Copy every parent-backed extent into the child and detach —
        after this the parent snapshot can be unprotected."""
        p = self._h.get("parent")
        if not p:
            return
        for objectno in self._pieces_in_use(
                min(self.size, p["overlap"]) or self.size):
            try:
                self.client.get(
                    self.pool_id, _piece_name(self.name, objectno),
                    notfound_retries=0)
            except ObjectNotFound:
                piece = self._parent_piece(objectno)
                if piece:
                    self.client.put(
                        self.pool_id,
                        _piece_name(self.name, objectno), piece)
        parent = Image.open(self.client, p["pool"], p["name"])
        parent._h["children"] = [
            c for c in parent._h.get("children", [])
            if not (c["name"] == self.name and c["snap"] == p["snap"])]
        parent._save_header()
        self._h["parent"] = None
        self._parent_img = None
        self._save_header()
