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
``gf2_matmul_w8.launches`` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes

import torch

from .. import build

MAX_K = 32   # data rows the kernel keeps in registers
MAX_M = 32   # output rows: 8m bit rows of masks in shared memory
MAX_BATCH = 65535  # stripes per launch (the grid's y extent)


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


def _check(bm_bits: torch.Tensor, data: torch.Tensor):
    if bm_bits.dtype != torch.uint8 or data.dtype != torch.uint8:
        raise TypeError(f"gf2_matmul_w8 takes uint8 tensors, got "
                        f"{bm_bits.dtype} and {data.dtype}")
    if bm_bits.dim() != 2 or bm_bits.shape[0] % 8 or bm_bits.shape[1] % 8:
        raise ValueError(f"bit matrix must be (8m, 8k), got "
                         f"{tuple(bm_bits.shape)}")
    m, k = bm_bits.shape[0] // 8, bm_bits.shape[1] // 8
    if data.dim() not in (2, 3) or data.shape[-2] != k:
        raise ValueError(f"data must be [k, L] or [B, k, L] with k={k}, "
                         f"got {tuple(data.shape)}")
    if bm_bits.device != data.device:
        raise ValueError(f"bit matrix on {bm_bits.device}, data on "
                         f"{data.device}")
    return k, m


def _lib():
    lib = build.load("gf2_matmul_w8")
    fn = lib.gf2_matmul_w8_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_longlong, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def gf2_matmul_w8(bm_bits: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """(8m, 8k) 0/1 bit matrix applied to u8[k, L] (or u8[B, k, L]
    stripes) -> u8[m, L] (or u8[B, m, L]).  Kernel K1 on CUDA tensors,
    the plain version on CPU tensors."""
    k, m = _check(bm_bits, data)
    if data.device.type == "cpu":
        return gf2_matmul_w8_plain(bm_bits, data)
    if data.device.type != "cuda":
        raise ValueError(f"unsupported device {data.device}")
    if not (bm_bits.is_contiguous() and data.is_contiguous()):
        raise ValueError("gf2_matmul_w8 needs contiguous tensors")
    if k > MAX_K or m > MAX_M:
        raise ValueError(f"kernel takes k, m <= {MAX_K}, {MAX_M}; "
                         f"got k={k}, m={m}")
    B = data.shape[0] if data.dim() == 3 else 1
    L = data.shape[-1]
    if B > MAX_BATCH:
        raise ValueError(f"at most {MAX_BATCH} stripes per launch, got {B}")
    out = torch.empty(*data.shape[:-2], m, L, dtype=torch.uint8,
                      device=data.device)
    if B == 0 or L == 0:
        return out
    launch = _lib()
    with torch.cuda.device(data.device):
        stream = torch.cuda.current_stream(data.device).cuda_stream
        rc = launch(bm_bits.data_ptr(), data.data_ptr(), out.data_ptr(),
                    B, k, m, L, stream)
    if rc != 0:
        raise RuntimeError(f"gf2_matmul_w8 launch failed: cudaError {rc}")
    gf2_matmul_w8.launches += 1
    return out


gf2_matmul_w8.launches = 0
