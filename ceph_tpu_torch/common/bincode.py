"""Binary versioned encoding — the encoding.h / denc.h role.

The port's copy of ``ceph_tpu/common/bincode.py``; the bytes are the
same.  The reference serializes every wire and disk structure through
ENCODE_START/ENCODE_FINISH envelopes (src/include/encoding.h:1531
region): a struct_v byte, a compat_v floor and a length, so an old
decoder can skip fields it does not know.  Here that contract is real
bytes (little-endian, length-prefixed): the WAL record format, store
checkpoints and full maps.

The primitives mirror the reference's ``encode(x, bl)`` overload set;
the envelope mirrors ENCODE_START(v, compat, bl) / DECODE_START(v, bl).
"""

from __future__ import annotations

import struct
from typing import Dict, List, Tuple

from .encoding import MalformedInput

_U8 = struct.Struct("<B")
_U16 = struct.Struct("<H")
_U32 = struct.Struct("<I")
_U64 = struct.Struct("<Q")
_I64 = struct.Struct("<q")


class Encoder:
    def __init__(self):
        self._parts: List[bytes] = []
        self._envs: List[int] = []  # indexes of length placeholders

    # -- scalars ------------------------------------------------------
    def u8(self, v: int) -> "Encoder":
        self._parts.append(_U8.pack(v))
        return self

    def u16(self, v: int) -> "Encoder":
        self._parts.append(_U16.pack(v))
        return self

    def u32(self, v: int) -> "Encoder":
        self._parts.append(_U32.pack(v))
        return self

    def u64(self, v: int) -> "Encoder":
        self._parts.append(_U64.pack(v))
        return self

    def i64(self, v: int) -> "Encoder":
        self._parts.append(_I64.pack(v))
        return self

    # -- blobs / strings ---------------------------------------------
    def blob(self, b) -> "Encoder":
        """Accepts any buffer-protocol object and stages it AS IS —
        the bufferlist::append(raw) role: views stay views until the
        single gathered join in ``bytes()``, so a WAL record over a
        pooled recv segment costs one materialisation, not two.  The
        buffer must stay valid until ``bytes()`` is called."""
        self._parts.append(_U32.pack(len(b)))
        self._parts.append(b)
        return self

    def str_(self, s: str) -> "Encoder":
        return self.blob(s.encode("utf-8"))

    # -- containers ---------------------------------------------------
    def str_blob_map(self, d: Dict[str, bytes]) -> "Encoder":
        self.u32(len(d))
        for k in sorted(d):
            self.str_(k)
            self.blob(d[k])
        return self

    def str_list(self, xs: List[str]) -> "Encoder":
        self.u32(len(xs))
        for x in xs:
            self.str_(x)
        return self

    # -- versioned envelope (ENCODE_START/FINISH) ---------------------
    def start(self, struct_v: int, compat_v: int) -> "Encoder":
        self.u8(struct_v).u8(compat_v)
        self._envs.append(len(self._parts))
        self._parts.append(b"\0\0\0\0")  # length placeholder
        return self

    def finish(self) -> "Encoder":
        at = self._envs.pop()
        length = sum(len(p) for p in self._parts[at + 1:])
        self._parts[at] = _U32.pack(length)
        return self

    def bytes(self) -> bytes:
        assert not self._envs, "unbalanced envelope"
        return b"".join(self._parts)


class DecodeError(MalformedInput):
    """Binary decode failure — a MalformedInput subtype, so transports
    and mounts handle JSON-envelope and bincode corruption as one
    typed protocol-error class."""


class Decoder:
    def __init__(self, buf: bytes, pos: int = 0,
                 struct_name: str = "structure"):
        if isinstance(buf, memoryview):
            # decode is the cold path (WAL replay, map
            # install) and every primitive below slices + unpacks —
            # normalizing once beats a view-aware copy per field
            buf = bytes(buf)
        self._b = buf
        self._pos = pos
        self._ends: List[int] = []
        self.struct_name = struct_name

    def _take(self, n: int) -> bytes:
        if self._pos + n > len(self._b):
            raise DecodeError(
                f"{self.struct_name}: truncated: need {n} at "
                f"{self._pos}/{len(self._b)}")
        v = self._b[self._pos:self._pos + n]
        self._pos += n
        return v

    def u8(self) -> int:
        return _U8.unpack(self._take(1))[0]

    def u16(self) -> int:
        return _U16.unpack(self._take(2))[0]

    def u32(self) -> int:
        return _U32.unpack(self._take(4))[0]

    def u64(self) -> int:
        return _U64.unpack(self._take(8))[0]

    def i64(self) -> int:
        return _I64.unpack(self._take(8))[0]

    def blob(self) -> bytes:
        return bytes(self._take(self.u32()))

    def str_(self) -> str:
        try:
            return self.blob().decode("utf-8")
        except UnicodeDecodeError as e:
            # tampered bytes must surface as the typed protocol error,
            # not an uncaught UnicodeDecodeError
            raise DecodeError(f"{self.struct_name}: bad utf-8: {e}")

    def str_blob_map(self) -> Dict[str, bytes]:
        return {self.str_(): self.blob() for _ in range(self.u32())}

    def str_list(self) -> List[str]:
        return [self.str_() for _ in range(self.u32())]

    def start(self, max_supported_v: int,
              struct_name: str = None) -> int:
        """DECODE_START: returns struct_v; raises when the encoder's
        compat floor is newer than what this decoder supports."""
        if struct_name is not None:
            self.struct_name = struct_name
        struct_v = self.u8()
        compat_v = self.u8()
        length = self.u32()
        if compat_v > max_supported_v:
            raise DecodeError(
                f"{self.struct_name} (writer struct_v {struct_v}) "
                f"requires decoder >= v{compat_v}, "
                f"have v{max_supported_v}")
        if self._pos + length > len(self._b):
            raise DecodeError(
                f"{self.struct_name}: envelope claims {length} bytes, "
                f"only {len(self._b) - self._pos} remain")
        self._ends.append(self._pos + length)
        return struct_v

    def finish(self) -> None:
        """DECODE_FINISH: skip fields this decoder didn't know about."""
        end = self._ends.pop()
        if self._pos > end:
            raise DecodeError(
                f"{self.struct_name}: decoded past envelope end")
        self._pos = end

    def remaining_in_envelope(self) -> int:
        return self._ends[-1] - self._pos if self._ends else \
            len(self._b) - self._pos

    @property
    def pos(self) -> int:
        return self._pos


# -- transaction codec -------------------------------------------------
# Transaction ops are tuples of (tag, str/int/bytes/dict/list fields);
# the codec writes a tagged, self-describing field list so the op set
# can grow without version bumps (Transaction::Op analogue).

_T_STR, _T_INT, _T_BYTES, _T_MAP, _T_LIST = range(5)


def encode_txn(ops: List[Tuple], enc: Encoder) -> None:
    enc.start(1, 1)
    enc.u32(len(ops))
    for op in ops:
        enc.u16(len(op))
        for field in op:
            if isinstance(field, str):
                enc.u8(_T_STR)
                enc.str_(field)
            elif isinstance(field, bool):
                raise TypeError("bool field in transaction op")
            elif isinstance(field, int):
                enc.u8(_T_INT)
                enc.i64(field)
            elif isinstance(field, (bytes, bytearray, memoryview)):
                enc.u8(_T_BYTES)
                enc.blob(field)  # staged as a view; Encoder.bytes()
                # is the one materialisation
            elif isinstance(field, dict):
                enc.u8(_T_MAP)
                enc.str_blob_map(field)
            elif isinstance(field, (list, tuple)):
                enc.u8(_T_LIST)
                enc.str_list(list(field))
            else:
                raise TypeError(f"unencodable op field {type(field)}")
    enc.finish()


def decode_txn(dec: Decoder) -> List[Tuple]:
    dec.start(1, struct_name="os.txn")
    ops = []
    for _ in range(dec.u32()):
        fields = []
        for _ in range(dec.u16()):
            tag = dec.u8()
            if tag == _T_STR:
                fields.append(dec.str_())
            elif tag == _T_INT:
                fields.append(dec.i64())
            elif tag == _T_BYTES:
                fields.append(dec.blob())
            elif tag == _T_MAP:
                fields.append(dec.str_blob_map())
            elif tag == _T_LIST:
                fields.append(dec.str_list())
            else:
                raise DecodeError(f"unknown field tag {tag}")
        ops.append(tuple(fields))
    dec.finish()
    return ops
