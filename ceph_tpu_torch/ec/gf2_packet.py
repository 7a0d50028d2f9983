"""The GF(2) product of the packet layouts: kernel K3 and its plain
version.

The port of ``ceph_tpu/ec/engine.py:_mod2_matmul`` applied to the rows
of ``Layout(w, packetsize)``: a (w*m, w*k) 0/1 bit matrix applied to k
chunks of L bytes (blocks of w packets of ``packetsize`` bytes; L a
multiple of w * packetsize) gives m chunks of L bytes, output packet
(p, r) of each block being the bytewise XOR of the input packets
(c, r') whose bit ``bm[p*w + r, c*w + r']`` is 1.  Encode applies the
coding bit matrix, decode the inverted survivor matrix.

``gf2_packet`` launches the hand-written CUDA kernel
(``csrc/gf2_packet.cu``) on CUDA tensors and runs ``gf2_packet_plain``
(``Layout.apply_plain``) on CPU tensors; on any other device it raises.
``gf2_packet.launches`` counts the kernel's launches.  The kernel takes
the bit matrix as index lists (the set bits of each row), which
``packet_lists`` builds on the matrix's device once per matrix.
"""

from __future__ import annotations

import array
import ctypes

import torch

from .. import build
from .gf2_kernels import COUNT_LOCK, _check_rows, _on
from .layout import Layout

MAX_ROWS = 32     # input and output chunks: the kernel's row tables
MAX_BITS = 256    # w*k and w*m: the kernel's index lists
MAX_BATCH = 65535  # stripes per launch
PLAN_FIELDS = ("vec_bytes", "mode", "blocks_per_tile", "ranges_per_block",
               "run_pieces", "tiles", "grid", "smem_bytes")
MODES = ("bulk", "async", "sync")   # how a tile is staged (gf2_packet.cuh)


def gf2_packet_plain(bm_bits: torch.Tensor, data: torch.Tensor, w: int,
                     packetsize: int) -> torch.Tensor:
    """Plain PyTorch version: ``Layout(w, packetsize)``'s rows, the
    product mod 2, packed back.  ``data`` u8[k, L] or u8[B, k, L] ->
    u8[m, L] or u8[B, m, L]."""
    return Layout(w, packetsize).apply_plain(bm_bits, data)


def _check_bm(bm_bits: torch.Tensor, w: int):
    if bm_bits.dtype != torch.uint8:
        raise TypeError(f"gf2_packet takes a uint8 bit matrix, got "
                        f"{bm_bits.dtype}")
    if w < 1 or bm_bits.dim() != 2 or bm_bits.shape[0] % w \
            or bm_bits.shape[1] % w:
        raise ValueError(f"bit matrix must be (w*m, w*k) with w={w}, got "
                         f"{tuple(bm_bits.shape)}")
    return bm_bits.shape[1] // w, bm_bits.shape[0] // w


def _check_limits(k: int, m: int, w: int):
    if k > MAX_ROWS or m > MAX_ROWS or w * k > MAX_BITS \
            or w * m > MAX_BITS:
        raise ValueError(f"kernel takes k, m <= {MAX_ROWS} and w*k, w*m <= "
                         f"{MAX_BITS}; got w={w}, k={k}, m={m}")


_launch = None


def _lib():
    """The kernel's library, its two entry points typed once."""
    global _launch
    lib = build.load("gf2_packet")
    if _launch is None:
        fn = lib.gf2_packet_launch
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.gf2_packet_plan.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
            ctypes.c_ulonglong, ctypes.POINTER(ctypes.c_longlong)]
        lib.gf2_packet_plan.restype = None
        _launch = fn
    return lib


def index_lists(bm_bits: torch.Tensor, w: int) -> torch.Tensor:
    """Row lists of a 0/1 bit matrix (w*m, w*k), by PyTorch ops on its
    device: int32[2*w*m + npad], the w*m starts of the rows' lists, the
    w*m ends, then each row's set bits in column order, column c*w + r'
    as ``(c << 16) | r'``, each row starting at a multiple of 4 entries
    (pads, -1, between rows)."""
    rows = bm_bits.shape[0]
    nz = (bm_bits & 1).nonzero()  # sync-ok: once per matrix (row-major order)
    counts = torch.bincount(nz[:, 0], minlength=rows)  # sync-ok: once per matrix
    padded = (counts + 3) // 4 * 4
    starts = padded.cumsum(0) - padded
    col = nz[:, 1]
    first = (counts.cumsum(0) - counts)[nz[:, 0]]
    at = starts[nz[:, 0]] + torch.arange(len(nz), device=nz.device) - first
    entries = torch.full((int(padded.sum()),), -1, dtype=torch.int64,  # sync-ok: the lists' length, once per matrix
                         device=bm_bits.device)
    entries[at] = (torch.div(col, w, rounding_mode="floor") << 16) | (col % w)
    return torch.cat([starts, starts + counts, entries]).to(
        torch.int32).contiguous()


def packet_lists(bm_bits: torch.Tensor, w: int) -> torch.Tensor:
    """The bit matrix as kernel K3 takes it (``index_lists``), built on
    the matrix's device once per matrix.  None for a matrix on the CPU,
    where the plain version needs none.  Raises ``ValueError`` for a
    matrix past the kernel's limits."""
    k, m = _check_bm(bm_bits, w)
    if bm_bits.device.type == "cpu":
        return None
    if bm_bits.device.type != "cuda":
        raise ValueError(f"unsupported device {bm_bits.device}")
    _check_limits(k, m, w)
    return index_lists(bm_bits, w)


def plan(packetsize: int, w: int, k: int, m: int, npad: int, L: int,
         B: int, addr_or: int) -> dict:
    """The plan K3 takes for a launch whose lists hold ``npad`` entries
    (``index_lists``: ``numel() - 2*w*m``) and whose row addresses and
    stripe stride OR to ``addr_or`` (``gf2_packet.cuh``'s ``plan`` on
    the current card): ``PLAN_FIELDS``, with ``mode`` named."""
    out = (ctypes.c_longlong * len(PLAN_FIELDS))()
    _lib().gf2_packet_plan(packetsize, w, k, m, npad, L, B, addr_or, out)
    rec = dict(zip(PLAN_FIELDS, out))
    rec["mode"] = MODES[rec["mode"]]
    return rec


def _stream(index: int) -> int:
    """The current stream of device ``index``, by the call PyTorch's own
    generated kernels use: microseconds less a call than
    ``torch.cuda.current_stream(index).cuda_stream``."""
    return torch._C._cuda_getCurrentRawStream(index)


def gf2_packet(bm_bits: torch.Tensor, data, w: int, packetsize: int,
               lists: torch.Tensor = None) -> torch.Tensor:
    """(w*m, w*k) 0/1 bit matrix applied in the packet layout (w,
    packetsize) to u8[k, L] (or u8[B, k, L] stripes, or a sequence of k
    u8[L] rows) -> u8[m, L] (or u8[B, m, L]).  Kernel K3 on CUDA
    tensors, the plain version on CPU tensors.

    Rows given one by one (a decode's survivors) are read where they
    lie: the kernel takes a table of their addresses.  ``lists``:
    ``packet_lists(bm_bits, w)``, built here when not given (CUDA
    only)."""
    k, m = _check_bm(bm_bits, w)
    if packetsize < 1:
        raise ValueError(f"packetsize must be positive, got {packetsize}")
    if isinstance(data, (list, tuple)):
        _check_rows(data, k)
        device, L, B = data[0].device, data[0].shape[0], 1
    else:
        if data.dtype != torch.uint8:
            raise TypeError(f"gf2_packet takes uint8 data, got {data.dtype}")
        if data.dim() not in (2, 3) or data.shape[-2] != k:
            raise ValueError(f"data must be [k, L] or [B, k, L] with "
                             f"k={k}, got {tuple(data.shape)}")
        device, L = data.device, data.shape[-1]
        B = data.shape[0] if data.dim() == 3 else 1
    if L % (w * packetsize):
        raise ValueError(f"chunk size {L} not a multiple of "
                         f"w*packetsize={w * packetsize}")
    if bm_bits.device != device:
        raise ValueError(f"bit matrix on {bm_bits.device}, data on "
                         f"{device}")
    if device.type == "cpu":
        if isinstance(data, (list, tuple)):
            data = torch.stack(list(data))
        return gf2_packet_plain(bm_bits, data, w, packetsize)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    if isinstance(data, torch.Tensor) and not data.is_contiguous():
        raise ValueError("gf2_packet needs contiguous data")
    _check_limits(k, m, w)
    if B > MAX_BATCH:
        raise ValueError(f"at most {MAX_BATCH} stripes per launch, got {B}")
    lead = (B,) if isinstance(data, torch.Tensor) and data.dim() == 3 else ()
    out = torch.empty(*lead, m, L, dtype=torch.uint8, device=device)
    if B == 0 or L == 0:
        return out
    if isinstance(data, torch.Tensor):   # rows in place: base + c * L
        table, base, stride = None, data.data_ptr(), k * L
    else:
        rows = array.array("Q", map(torch.Tensor.data_ptr, data))
        table, base, stride = rows.buffer_info()[0], None, 0
    if lists is None:
        lists = packet_lists(bm_bits, w)
    npad = lists.numel() - 2 * w * m
    if (lists.dtype != torch.int32 or lists.device != device
            or not 0 <= npad <= w * m * (w * k + 3)
            or not lists.is_contiguous()):
        raise ValueError("lists are not packet_lists(bm_bits, w) on the "
                         "data's device")
    if _launch is None:
        _lib()
    current = torch.cuda.current_device()
    if device.index is None or device.index == current:
        rc = _launch(lists.data_ptr(), npad, table, base, stride,
                     out.data_ptr(), B, k, m, w, packetsize, L,
                     _stream(current))
    else:
        with _on(device):
            rc = _launch(lists.data_ptr(), npad, table, base, stride,
                         out.data_ptr(), B, k, m, w, packetsize, L,
                         _stream(device.index))
    if rc != 0:
        raise RuntimeError(f"gf2_packet launch failed: cudaError {rc}")
    with COUNT_LOCK:
        gf2_packet.launches += 1
    return out


gf2_packet.launches = 0
