"""Compressor plugins — the src/compressor registry.

The port's copy of ``ceph_tpu/common/compressor.py``: the codecs the
Python runtime ships (zlib, lzma at preset 1, and the identity codec),
under the same names, so a compressed checkpoint is the same bytes in
both packages.  Further codecs register through ``register``.
"""

from __future__ import annotations

import lzma
import zlib
from typing import Callable, Dict, Tuple

_Codec = Tuple[Callable[[bytes], bytes], Callable[[bytes], bytes]]

_REGISTRY: Dict[str, _Codec] = {}


def register(name: str, compress: Callable[[bytes], bytes],
             decompress: Callable[[bytes], bytes]) -> None:
    _REGISTRY[name] = (compress, decompress)


def plugins() -> list:
    return sorted(_REGISTRY)


class Compressor:
    def __init__(self, name: str):
        if name not in _REGISTRY:
            raise KeyError(f"no compressor {name!r}; have {plugins()}")
        self.name = name
        self._c, self._d = _REGISTRY[name]

    def compress(self, data: bytes) -> bytes:
        return self._c(data)

    def decompress(self, data: bytes) -> bytes:
        return self._d(data)


register("none", lambda b: b, lambda b: b)
register("zlib", lambda b: zlib.compress(b, 6), zlib.decompress)
register("lzma", lambda b: lzma.compress(b, preset=1),
         lzma.decompress)
