"""The rjenkins1 32-bit mix hash that drives every CRUSH draw, as torch
ops.

Bit-exact with the reference (src/crush/hash.c:12-90, seed 1315423911)
and with ``ceph_tpu/crush/hash.py``.  torch has no unsigned 32-bit
arithmetic, so every value is an int64 tensor holding a u32 in
[0, 2^32): subtractions and left shifts are masked back to 32 bits, and
right shifts of such values are logical.  The same functions exist as
CUDA device code in ``csrc/crush_rule.cu`` and, on Python ints, for the
scalar ``mapper_ref`` (``hash32_*_int``).
"""

from __future__ import annotations

import torch

CRUSH_HASH_SEED = 0x4E67C6A7  # 1315423911
M32 = 0xFFFFFFFF
_X = 231232
_Y = 1232


def u32(v, like: torch.Tensor = None) -> torch.Tensor:
    """An int64 tensor of u32 values (ints, numpy or tensors; negative
    values wrap as in a C cast to ``__u32``)."""
    device = like.device if like is not None else None
    return torch.as_tensor(v, dtype=torch.int64, device=device) & M32


def _mix(a, b, c):
    """One rjenkins mix round over three u32 lanes (hash.c:12-22)."""
    a = (a - b - c) & M32
    a = a ^ (c >> 13)
    b = (b - c - a) & M32
    b = b ^ ((a << 8) & M32)
    c = (c - a - b) & M32
    c = c ^ (b >> 13)
    a = (a - b - c) & M32
    a = a ^ (c >> 12)
    b = (b - c - a) & M32
    b = b ^ ((a << 16) & M32)
    c = (c - a - b) & M32
    c = c ^ (b >> 5)
    a = (a - b - c) & M32
    a = a ^ (c >> 3)
    b = (b - c - a) & M32
    b = b ^ ((a << 10) & M32)
    c = (c - a - b) & M32
    c = c ^ (b >> 15)
    return a, b, c


def crush_hash32_2(a, b) -> torch.Tensor:
    a = u32(a)
    b = u32(b, a)
    h = CRUSH_HASH_SEED ^ a ^ b
    x, y = _X, _Y
    a, b, h = _mix(a, b, h)
    x, a, h = _mix(x, a, h)
    b, y, h = _mix(b, y, h)
    return h


def crush_hash32_3(a, b, c) -> torch.Tensor:
    a = u32(a)
    b, c = u32(b, a), u32(c, a)
    h = CRUSH_HASH_SEED ^ a ^ b ^ c
    x, y = _X, _Y
    a, b, h = _mix(a, b, h)
    c, x, h = _mix(c, x, h)
    y, a, h = _mix(y, a, h)
    b, x, h = _mix(b, x, h)
    y, c, h = _mix(y, c, h)
    return h


def crush_hash32_4(a, b, c, d) -> torch.Tensor:
    a = u32(a)
    b, c, d = u32(b, a), u32(c, a), u32(d, a)
    h = CRUSH_HASH_SEED ^ a ^ b ^ c ^ d
    x, y = _X, _Y
    a, b, h = _mix(a, b, h)
    c, d, h = _mix(c, d, h)
    a, x, h = _mix(a, x, h)
    y, b, h = _mix(y, b, h)
    c, x, h = _mix(c, x, h)
    y, d, h = _mix(y, d, h)
    return h


# -- the same hashes on Python ints (the scalar mapper_ref) -------------


def _mix_int(a, b, c):
    a = (a - b - c) & M32
    a ^= c >> 13
    b = (b - c - a) & M32
    b ^= (a << 8) & M32
    c = (c - a - b) & M32
    c ^= b >> 13
    a = (a - b - c) & M32
    a ^= c >> 12
    b = (b - c - a) & M32
    b ^= (a << 16) & M32
    c = (c - a - b) & M32
    c ^= b >> 5
    a = (a - b - c) & M32
    a ^= c >> 3
    b = (b - c - a) & M32
    b ^= (a << 10) & M32
    c = (c - a - b) & M32
    c ^= b >> 15
    return a, b, c


def hash32_2_int(a: int, b: int) -> int:
    a &= M32
    b &= M32
    h = CRUSH_HASH_SEED ^ a ^ b
    x, y = _X, _Y
    a, b, h = _mix_int(a, b, h)
    x, a, h = _mix_int(x, a, h)
    b, y, h = _mix_int(b, y, h)
    return h


def hash32_3_int(a: int, b: int, c: int) -> int:
    a &= M32
    b &= M32
    c &= M32
    h = CRUSH_HASH_SEED ^ a ^ b ^ c
    x, y = _X, _Y
    a, b, h = _mix_int(a, b, h)
    c, x, h = _mix_int(c, x, h)
    y, a, h = _mix_int(y, a, h)
    b, x, h = _mix_int(b, x, h)
    y, c, h = _mix_int(y, c, h)
    return h


def hash32_4_int(a: int, b: int, c: int, d: int) -> int:
    a &= M32
    b &= M32
    c &= M32
    d &= M32
    h = CRUSH_HASH_SEED ^ a ^ b ^ c ^ d
    x, y = _X, _Y
    a, b, h = _mix_int(a, b, h)
    c, d, h = _mix_int(c, d, h)
    a, x, h = _mix_int(a, x, h)
    y, b, h = _mix_int(y, b, h)
    c, x, h = _mix_int(c, x, h)
    y, d, h = _mix_int(y, d, h)
    return h
