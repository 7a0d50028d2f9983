"""Fixed-point 2^44*log2(x+1) — the heart of the straw2 draw — as torch
ops.

Bit-exact with the reference crush_ln (src/crush/mapper.c:226-268) and
``ceph_tpu/crush/ln.py``: normalize the 17-bit input so its top bit
sits at position 15/16, look up the coarse reciprocal/log pair, derive
the fine index from the byte above bit 48 of ``x * RH``, and assemble
``(iexpon << 44) + ((LH + LL) >> 4)``.  Values are int64; the one
64-bit product whose high bits are needed is split into 32-bit halves
so nothing overflows.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ._ln_tables import LL_TBL, RH_LH_TBL

S64_MIN = -(2 ** 63)
M32 = 0xFFFFFFFF
# straw2_magic's layout, which csrc/crush_rule.cu mirrors (kPreshift =
# 64 - MAGIC_NUM_BITS, kMagicShiftAt): numerators 2^48 - crush_ln(u)
# fit in MAGIC_NUM_BITS bits, and the shift sits from bit MAGIC_SHIFT_AT.
MAGIC_NUM_BITS = 49
MAGIC_SHIFT_AT = 58


def ln_tables(device) -> torch.Tensor:
    """int64[514]: the 258 RH/LH entries followed by the 256 LL entries
    (the layout the CUDA kernel loads into shared memory)."""
    return torch.tensor(list(RH_LH_TBL) + list(LL_TBL), dtype=torch.int64,
                        device=device)


def crush_ln(xin: torch.Tensor) -> torch.Tensor:
    """``xin``: integer tensor with values in [0, 0xffff].  Returns int64
    values in (0, 2^48]."""
    tabs = ln_tables(xin.device)
    rh_lh, ll = tabs[:len(RH_LH_TBL)], tabs[len(RH_LH_TBL):]
    x = xin.to(torch.int64) + 1
    # msb position of the (at most 17-bit) value, by binary search
    v = x & 0x1FFFF
    p = torch.zeros_like(v)
    for sh in (16, 8, 4, 2, 1):
        m = v >> sh
        take = m > 0
        p = torch.where(take, p + sh, p)
        v = torch.where(take, m, v)
    x = x << torch.where(p < 15, 15 - p, torch.zeros_like(p))
    iexpon = torch.where(p < 15, p, torch.full_like(p, 15))

    index1 = (x >> 8) << 1
    rh = rh_lh[index1 - 256]
    lh = rh_lh[index1 + 1 - 256]
    # (x * rh) >> 32, exactly: x <= 2^16 and rh <= 2^48
    hi = x * (rh >> 32) + ((x * (rh & M32)) >> 32)
    index2 = (hi >> 16) & 0xFF
    lh = (lh + ll[index2]) >> (48 - 12 - 32)
    return (iexpon << (12 + 32)) + lh


_LN16: Dict[torch.device, torch.Tensor] = {}


def ln16_table(device="cpu") -> torch.Tensor:
    """int64[65536] with ``LN16[u] == crush_ln(u)``: crush_ln's input is
    always ``hash & 0xffff`` (mapper.c:318), so the plain mapper gathers
    from this table instead of recomputing the pipeline."""
    device = torch.device(device)
    tab = _LN16.get(device)
    if tab is None:
        tab = crush_ln(torch.arange(65536, dtype=torch.int64,
                                    device=device))
        _LN16[device] = tab
    return tab


def straw2_draw(u16: torch.Tensor, weight: torch.Tensor,
                ln_tab: torch.Tensor = None) -> torch.Tensor:
    """The signed straw2 draw ``div64_s64(crush_ln(u16) - 2^48, weight)``.

    ``u16``: the masked hash draw (hash & 0xffff); ``weight``: 16.16
    item weight as u32 values.  Zero weights map to S64_MIN
    (mapper.c:349-353).  The numerator is <= 0 and the divisor > 0, so C
    truncation toward zero is ``-((2^48 - ln) // w)``."""
    tab = ln_tab if ln_tab is not None else ln16_table(u16.device)
    ln = tab[u16.to(torch.int64)]
    neg = (1 << 48) - ln
    w = weight.to(torch.int64) & M32
    wsafe = torch.where(w == 0, torch.ones_like(w), w)
    draw = -torch.div(neg, wsafe, rounding_mode="trunc")
    return torch.where(w == 0, torch.full_like(draw, S64_MIN), draw)


def straw2_magic(weights) -> np.ndarray:
    """u64 per item weight: the exact reciprocal the kernel multiplies
    by in place of the straw2 division.

    For ``w > 0``, with ``l = ceil(log2 w)`` and ``m = ceil(2^(49+l) /
    w)``, ``floor(n / w) == mulhi64(n << 15, m) >> l`` for every
    ``0 <= n < 2^49``: ``m * w - 2^(49+l) < w <= 2^l``, so ``n * m /
    2^(49+l)`` exceeds ``n / w`` by less than ``1 / w``.  Stored as ``m |
    l << 58`` (``m <= 2^50``); a zero weight gives 0.  ``weights``: u32
    values (numpy, any integer dtype; int32 bit patterns are read as
    u32)."""
    w = np.asarray(weights).astype(np.int64) & M32
    vals, inv = np.unique(w, return_inverse=True)
    table = np.zeros(len(vals), np.uint64)
    for j, v in enumerate(vals.tolist()):  # sync-ok: a numpy array of the map's weights, built on the host
        if v:
            shift = (v - 1).bit_length()
            m = -(-(1 << (MAGIC_NUM_BITS + shift)) // v)
            table[j] = m | (shift << MAGIC_SHIFT_AT)
    return table[inv.reshape(w.shape)]
