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
the bit matrix as one mask of 32-bit words a row, which
``packet_masks`` builds on the matrix's device once per matrix.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import build
from .gf2_kernels import _check_rows, _on
from .layout import Layout

MAX_ROWS = 32     # input and output chunks: the kernel's row tables
MAX_BITS = 256    # w*k and w*m: the kernel's masks and scratch
MAX_BATCH = 65535  # stripes per launch


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


def _lib():
    lib = build.load("gf2_packet")
    fn = lib.gf2_packet_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p),
                       ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.gf2_packet_vec_bytes.argtypes = [
            ctypes.c_int, ctypes.c_ulonglong, ctypes.c_longlong,
            ctypes.c_longlong, ctypes.c_int]
        lib.gf2_packet_vec_bytes.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _bit_weights(device: torch.device) -> torch.Tensor:
    return torch.ones(32, dtype=torch.int64, device=device) \
        << torch.arange(32, dtype=torch.int64, device=device)


def mask_words(bm_bits: torch.Tensor) -> torch.Tensor:
    """Row masks of a 0/1 bit matrix (R, C), by PyTorch ops on its
    device: int32[R * ceil(C / 32)], bit i of word q of row o being
    ``bm[o, 32q + i]`` (int32 bit patterns of the kernel's u32 words)."""
    rows, cols = bm_bits.shape
    nw = (cols + 31) // 32
    bits = torch.zeros((rows, nw * 32), dtype=torch.int64,
                       device=bm_bits.device)
    bits[:, :cols] = bm_bits & 1
    words = (bits.view(rows, nw, 32) * _bit_weights(bm_bits.device)).sum(-1)
    words = torch.where(words >= 1 << 31, words - (1 << 32), words)
    return words.to(torch.int32).reshape(-1).contiguous()


def packet_masks(bm_bits: torch.Tensor, w: int) -> torch.Tensor:
    """The bit matrix as kernel K3 takes it (``mask_words``), built on
    the matrix's device once per matrix.  None for a matrix on the CPU,
    where the plain version needs none.  Raises ``ValueError`` for a
    matrix past the kernel's limits."""
    k, m = _check_bm(bm_bits, w)
    if bm_bits.device.type == "cpu":
        return None
    if bm_bits.device.type != "cuda":
        raise ValueError(f"unsupported device {bm_bits.device}")
    _check_limits(k, m, w)
    return mask_words(bm_bits)


def vec_bytes(packetsize: int, addr_or: int, B: int, L: int, w: int) -> int:
    """The vector width (bytes a thread) K3 takes for a launch whose row
    addresses and stride OR to ``addr_or``."""
    return _lib().gf2_packet_vec_bytes(packetsize, addr_or, B, L, w)


def gf2_packet(bm_bits: torch.Tensor, data, w: int, packetsize: int,
               masks: torch.Tensor = None) -> torch.Tensor:
    """(w*m, w*k) 0/1 bit matrix applied in the packet layout (w,
    packetsize) to u8[k, L] (or u8[B, k, L] stripes, or a sequence of k
    u8[L] rows) -> u8[m, L] (or u8[B, m, L]).  Kernel K3 on CUDA
    tensors, the plain version on CPU tensors.

    Rows given one by one (a decode's survivors) are read where they
    lie: the kernel takes a table of their addresses.  ``masks``:
    ``packet_masks(bm_bits, w)``, built here when not given (CUDA
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
        table = (ctypes.c_void_p * k)(*[r.data_ptr() for r in data])
        base, stride = None, 0
    if masks is None:
        masks = packet_masks(bm_bits, w)
    nw = (w * k + 31) // 32
    if (masks.dtype != torch.int32 or masks.device != device
            or masks.numel() != w * m * nw or not masks.is_contiguous()):
        raise ValueError("masks are not packet_masks(bm_bits, w) on the "
                         "data's device")
    with _on(device):
        stream = torch.cuda.current_stream(device.index).cuda_stream
        rc = _lib().gf2_packet_launch(masks.data_ptr(), table, base, stride,
                                      out.data_ptr(), B, k, m, w, packetsize,
                                      L, stream)
    if rc != 0:
        raise RuntimeError(f"gf2_packet launch failed: cudaError {rc}")
    gf2_packet.launches += 1
    return out


gf2_packet.launches = 0
