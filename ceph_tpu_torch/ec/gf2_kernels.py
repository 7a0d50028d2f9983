"""The GF(2) bit-matmul for w=8 byte layouts: kernel K1 and its plain
version.

The port of ``ceph_tpu/ec/pallas_kernels.py:fused_gf2_matmul_w8``.  An
(8m, 8k) 0/1 bit matrix applied to k chunks of L bytes gives m chunks of
L bytes: each byte is 8 LSB-first bit planes, the product is taken mod
2, and each group of 8 output planes is packed back to a byte.  The
same function serves encode (the coding bit matrix) and decode (the
inverted survivor matrix).

``gf2_matmul_w8`` launches the hand-written CUDA kernel
(``csrc/gf2_matmul_w8.cu``) on CUDA tensors and runs
``gf2_matmul_w8_plain`` on CPU tensors; on any other device it raises.
``gf2_matmul_w8.launches`` counts the kernel's launches (under a lock:
many daemon threads launch at once).  The kernel
takes the bit matrix as tensor-core fragments, which
``gf2_fragments`` builds on the card once per matrix.

``gf2_matmul_words`` runs the w=16 and w=32 word layouts on the same
kernel.  With wb = w / 8, de-interleave each chunk into wb virtual
chunks (virtual chunk (c, t) holds bytes t, t + wb, t + 2 wb, ... of
chunk c): row ``c*w + 8t + s`` of ``Layout(w).to_rows`` is then bit s
of virtual chunk ``c*wb + t``, K1's w=8 row order.  So the same
(w*m, w*k) bit matrix, applied by K1 to the k*wb virtual chunks, gives
the m*wb output virtual chunks, which interleave back into the m
chunks.  The de-interleave and the interleave are strided PyTorch
copies around K1.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools

import torch

from .. import build
from ..analysis.lockdep import make_lock
from .layout import Layout

MAX_K = 32   # input rows: the kernel's table of row pointers
MAX_M = 32   # output rows
MAX_BATCH = 65535  # stripes per launch


# guards the wrappers' launch counts (K1's here, K3's in gf2_packet)
COUNT_LOCK = make_lock("ec::launch_count")


def gf2_matmul_w8_plain(bm_bits: torch.Tensor,
                        data: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: unpack, matmul, ``& 1``, pack.

    ``bm_bits`` (8m, 8k) 0/1, ``data`` u8[k, L] or u8[B, k, L] ->
    u8[m, L] or u8[B, m, L].  The matmul runs in float32, which is exact
    here: every sum is at most 8k < 2^24."""
    k8 = bm_bits.shape[1]
    k, L = k8 // 8, data.shape[-1]
    lead = tuple(data.shape[:-2])
    bits = torch.arange(8, dtype=torch.int32, device=data.device)
    d = data.to(torch.int32)
    planes = (d.unsqueeze(-2) >> bits[:, None]) & 1   # [..., k, 8, L]
    planes = planes.reshape(*lead, 8 * k, L).to(torch.float32)
    bm = (bm_bits.to(torch.int32) & 1).to(torch.float32)
    acc = torch.matmul(bm, planes)                    # [..., 8m, L]
    par = acc.to(torch.int32) & 1
    m = bm_bits.shape[0] // 8
    par = par.reshape(*lead, m, 8, L)
    return (par << bits[:, None]).sum(dim=-2).to(torch.uint8)


def _check_bm(bm_bits: torch.Tensor):
    if bm_bits.dtype != torch.uint8:
        raise TypeError(f"gf2_matmul_w8 takes a uint8 bit matrix, got "
                        f"{bm_bits.dtype}")
    if bm_bits.dim() != 2 or bm_bits.shape[0] % 8 or bm_bits.shape[1] % 8:
        raise ValueError(f"bit matrix must be (8m, 8k), got "
                         f"{tuple(bm_bits.shape)}")
    return bm_bits.shape[1] // 8, bm_bits.shape[0] // 8


def _check_rows(rows, k: int):
    """k input rows given one by one: uint8, 1-D, one length, contiguous,
    on one device."""
    if len(rows) != k:
        raise ValueError(f"bit matrix takes k={k} rows, got {len(rows)}")
    first = rows[0]
    for r in rows:
        if not isinstance(r, torch.Tensor) or r.dtype != torch.uint8:
            raise TypeError(f"rows must be uint8 tensors, got "
                            f"{getattr(r, 'dtype', type(r))}")
        if r.dim() != 1 or r.shape != first.shape:
            raise ValueError(f"rows must be 1-D of one length, got "
                             f"{tuple(r.shape)} beside {tuple(first.shape)}")
        if r.device != first.device:
            raise ValueError(f"rows on {r.device} and {first.device}")
        if not r.is_contiguous():
            raise ValueError("gf2_matmul_w8 needs contiguous rows")


def _lib():
    lib = build.load("gf2_matmul_w8")
    fn = lib.gf2_matmul_w8_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p),
                       ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_longlong, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.gf2_fragments_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.gf2_fragments_bytes.restype = ctypes.c_longlong
        lib.gf2_fragments_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_void_p]
        lib.gf2_fragments_launch.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _fragment_bytes(k: int, m: int) -> int:
    return _lib().gf2_fragments_bytes(k, m)


def _on(device: torch.device):
    """Make ``device`` the current one for a launch, when it is not."""
    if device.index is None or device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def gf2_fragments(bm_bits: torch.Tensor) -> torch.Tensor:
    """The bit matrix as kernel K1 takes it on the card: the A fragments
    of its tensor-core products (``csrc/gf2_layout.cuh``), built by a
    small kernel.  A caller that applies one matrix many times (the EC
    engine) builds them once and passes them to ``gf2_matmul_w8``.  None
    for a matrix on the CPU, where the plain version needs none.

    They are built on the current stream: a launch on another stream
    must wait for that one first (the engine synchronizes it once)."""
    k, m = _check_bm(bm_bits)
    if bm_bits.device.type == "cpu":
        return None
    if bm_bits.device.type != "cuda":
        raise ValueError(f"unsupported device {bm_bits.device}")
    if not bm_bits.is_contiguous():
        raise ValueError("gf2_fragments needs a contiguous bit matrix")
    if k > MAX_K or m > MAX_M:
        raise ValueError(f"kernel takes k, m <= {MAX_K}, {MAX_M}; "
                         f"got k={k}, m={m}")
    frag = torch.empty(_fragment_bytes(k, m), dtype=torch.uint8,
                       device=bm_bits.device)
    with _on(bm_bits.device):
        stream = torch.cuda.current_stream(bm_bits.device.index).cuda_stream
        rc = _lib().gf2_fragments_launch(bm_bits.data_ptr(), k, m,
                                         frag.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"gf2_fragments launch failed: cudaError {rc}")
    return frag


def gf2_matmul_w8(bm_bits: torch.Tensor, data,
                  fragments: torch.Tensor = None) -> torch.Tensor:
    """(8m, 8k) 0/1 bit matrix applied to u8[k, L] (or u8[B, k, L]
    stripes, or a sequence of k u8[L] rows) -> u8[m, L] (or u8[B, m,
    L]).  Kernel K1 on CUDA tensors, the plain version on CPU tensors.

    Rows given one by one (a decode's survivors) are read where they
    lie: the kernel takes a table of their addresses, and nothing is
    stacked on the card.  ``fragments``: ``gf2_fragments(bm_bits)``,
    built here when not given (CUDA only)."""
    k, m = _check_bm(bm_bits)
    if isinstance(data, (list, tuple)):
        _check_rows(data, k)
        device, L, B = data[0].device, data[0].shape[0], 1
    else:
        if data.dtype != torch.uint8:
            raise TypeError(f"gf2_matmul_w8 takes uint8 data, got "
                            f"{data.dtype}")
        if data.dim() not in (2, 3) or data.shape[-2] != k:
            raise ValueError(f"data must be [k, L] or [B, k, L] with "
                             f"k={k}, got {tuple(data.shape)}")
        device, L = data.device, data.shape[-1]
        B = data.shape[0] if data.dim() == 3 else 1
    if bm_bits.device != device:
        raise ValueError(f"bit matrix on {bm_bits.device}, data on "
                         f"{device}")
    if device.type == "cpu":
        if isinstance(data, (list, tuple)):
            data = torch.stack(list(data))
        return gf2_matmul_w8_plain(bm_bits, data)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    if not bm_bits.is_contiguous() or (
            isinstance(data, torch.Tensor) and not data.is_contiguous()):
        raise ValueError("gf2_matmul_w8 needs contiguous tensors")
    if k > MAX_K or m > MAX_M:
        raise ValueError(f"kernel takes k, m <= {MAX_K}, {MAX_M}; "
                         f"got k={k}, m={m}")
    if B > MAX_BATCH:
        raise ValueError(f"at most {MAX_BATCH} stripes per launch, got {B}")
    lead = (B,) if isinstance(data, torch.Tensor) and data.dim() == 3 else ()
    out = torch.empty(*lead, m, L, dtype=torch.uint8, device=device)
    if B == 0 or L == 0:
        return out
    if isinstance(data, torch.Tensor):   # rows in place: base + j * L
        table, base, stride = None, data.data_ptr(), k * L
    else:
        table = (ctypes.c_void_p * k)(*[r.data_ptr() for r in data])
        base, stride = None, 0
    if fragments is None:
        fragments = gf2_fragments(bm_bits)
    if (fragments.dtype != torch.uint8 or fragments.device != device
            or fragments.numel() != _fragment_bytes(k, m)
            or fragments.data_ptr() % 16):
        raise ValueError("fragments are not gf2_fragments(bm_bits) on the "
                         "data's device")
    with _on(device):
        # by index: a few microseconds a call less than by torch.device
        stream = torch.cuda.current_stream(device.index).cuda_stream
        rc = _lib().gf2_matmul_w8_launch(fragments.data_ptr(), table, base,
                                         stride, out.data_ptr(), B, k, m, L,
                                         stream)
    if rc != 0:
        raise RuntimeError(f"gf2_matmul_w8 launch failed: cudaError {rc}")
    with COUNT_LOCK:
        gf2_matmul_w8.launches += 1
    return out


gf2_matmul_w8.launches = 0


def virtual_chunks(data, wb: int) -> torch.Tensor:
    """u8[..., k, L] (or a sequence of k u8[L] rows) -> u8[..., k*wb,
    L/wb]: virtual chunk c*wb + t holds bytes t, t + wb, ... of chunk c.
    One strided copy."""
    if isinstance(data, (list, tuple)):
        return torch.stack([r.view(-1, wb).t() for r in data]).reshape(
            len(data) * wb, -1)
    *lead, k, L = data.shape
    return data.reshape(*lead, k, L // wb, wb).transpose(-1, -2).reshape(
        *lead, k * wb, L // wb)


def interleave_words(out: torch.Tensor, wb: int) -> torch.Tensor:
    """Inverse of ``virtual_chunks``: u8[..., m*wb, N] -> u8[..., m,
    N*wb].  One strided copy."""
    *lead, mwb, N = out.shape
    return out.reshape(*lead, mwb // wb, wb, N).transpose(-1, -2).reshape(
        *lead, mwb // wb, N * wb)


def gf2_matmul_words_plain(bm_bits: torch.Tensor, data: torch.Tensor,
                           w: int) -> torch.Tensor:
    """Plain PyTorch version of the w=16/32 word layouts:
    ``Layout(w)``'s rows, the product mod 2, packed back."""
    return Layout(w).apply_plain(bm_bits, data)


def gf2_matmul_words(bm_bits: torch.Tensor, data, w: int,
                     fragments: torch.Tensor = None) -> torch.Tensor:
    """(w*m, w*k) 0/1 bit matrix applied in the word layout w (16 or 32)
    to u8[k, L] (or u8[B, k, L], or a sequence of k u8[L] rows; L a
    multiple of w/8) -> u8[m, L] (or u8[B, m, L]).  On CUDA tensors
    kernel K1 over the virtual chunks (``fragments``: ``gf2_fragments(
    bm_bits)``), so k*w/8 and m*w/8 are at most 32 there; the plain
    version on CPU tensors."""
    if w not in (16, 32):
        raise ValueError(f"word layouts are w=16 and w=32, got w={w}")
    wb = w // 8
    first = data[0] if isinstance(data, (list, tuple)) else data
    if first.shape[-1] % wb:
        raise ValueError(f"chunk size {first.shape[-1]} not a multiple of "
                         f"word size {wb}")
    if first.device.type == "cpu":
        if isinstance(data, (list, tuple)):
            _check_rows(data, bm_bits.shape[1] // w)
            data = torch.stack(list(data))
        return gf2_matmul_words_plain(bm_bits, data, w)
    if isinstance(data, (list, tuple)):
        _check_rows(data, bm_bits.shape[1] // w)
    # the module's attribute, looked up at the call, so that a caller
    # that swaps it (chip_smoke's tap) sees these launches too
    out = gf2_matmul_w8(bm_bits, virtual_chunks(data, wb), fragments)
    return interleave_words(out, wb)
