"""The versioned JSON envelope of the map files.

The port's copy of the functions of ``ceph_tpu/common/encoding.py``
that the map files use.  The reference wraps every wire and disk
structure in ``ENCODE_START(v, compat_v)`` / ``ENCODE_FINISH``
(src/include/encoding.h:1531): a version, the oldest reader that may
decode it, and the payload.  Here that is

    {"v": <struct version>, "compat": <oldest reader>, "data": {...}}

A reader refuses a ``compat`` above its own version, and a bare JSON
value written before the envelope decodes as writer version 0.
"""

from __future__ import annotations

import json
from typing import Any, Dict, Tuple


class MalformedInput(ValueError):
    """A blob this reader must refuse: truncated, tampered, from a newer
    writer or with a payload that does not decode."""


def encode(data: Dict[str, Any], version: int = 1,
           compat: int = 1) -> str:
    if compat > version:
        raise ValueError("compat cannot exceed version")
    return json.dumps({"v": version, "compat": compat, "data": data})


def decode(blob: str | bytes, supported: int = 1,
           struct: str = "structure") -> Tuple[int, Dict[str, Any]]:
    """(writer version, payload) of an envelope; raises MalformedInput
    when the writer demands a newer reader than ``supported``."""
    try:
        env = json.loads(blob)
        v = int(env["v"])
        compat = int(env["compat"])
        data = env["data"]
    except (KeyError, TypeError, ValueError, json.JSONDecodeError) as e:
        raise MalformedInput(f"{struct}: bad envelope: {e}")
    if compat > supported:
        raise MalformedInput(
            f"{struct} (writer v{v}) requires decoder v{compat}, "
            f"have v{supported}")
    return v, data


def is_envelope(obj: Any) -> bool:
    """True when a parsed JSON value has the envelope shape."""
    return isinstance(obj, dict) and set(obj) == {"v", "compat", "data"}


def decode_any(blob: str | bytes, supported: int = 1,
               struct: str = "structure") -> Tuple[int, Any]:
    """``decode``, and a bare JSON value (written before the envelope)
    as writer version 0."""
    try:
        parsed = json.loads(blob)
    except (TypeError, ValueError) as e:
        raise MalformedInput(f"{struct}: undecodable blob: {e}")
    if is_envelope(parsed):
        return decode(blob, supported=supported, struct=struct)
    return 0, parsed


class Versioned:
    """Mixin: a class with ``to_dict``/``from_dict`` gains its versioned
    wire form.

    Subclasses set STRUCT_V/COMPAT_V and may override
    ``upgrade(writer_v, data)`` to carry an old payload forward.  A
    payload that passes the envelope but breaks ``from_dict`` (a
    tampered field, a wrong type) is raised again as MalformedInput
    naming the struct and both versions.
    """

    STRUCT_V = 1
    COMPAT_V = 1

    def encode_versioned(self) -> str:
        return encode(self.to_dict(), self.STRUCT_V, self.COMPAT_V)

    @classmethod
    def decode_versioned(cls, blob: str | bytes):
        v, data = decode(blob, supported=cls.STRUCT_V,
                         struct=cls.__name__)
        try:
            data = cls.upgrade(v, data)
            return cls.from_dict(data)
        except MalformedInput:
            raise
        except (KeyError, TypeError, ValueError, IndexError,
                AttributeError) as e:
            raise MalformedInput(
                f"{cls.__name__} (writer v{v}, reader v"
                f"{cls.STRUCT_V}): bad payload: {e!r}")

    @classmethod
    def upgrade(cls, writer_v: int, data: Dict[str, Any]
                ) -> Dict[str, Any]:
        return data
