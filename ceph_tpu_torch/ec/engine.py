"""The EC execution engine: a GF(2)-linear code as one bit product.

The port of ``ceph_tpu/ec/engine.py``.  Every code is GF(2)-linear, so
encode is the coding bit matrix CB (w*m x w*k) applied to the k data
chunks' rows, and decode picks k surviving chunks, inverts their rows of
``[I; CB]`` over GF(2) on the host (cached per erasure signature, the
reference's ErasureCodeIsaTableCache flow), and applies the inverse.
The layout (``layout.Layout``) says what a row is, and which kernel
applies a matrix on the card:

- w=8 bytes: kernel K1 (``gf2_kernels.gf2_matmul_w8``);
- w=16/32 words: K1 over the chunks' virtual chunks
  (``gf2_kernels.gf2_matmul_words``);
- packets (w, packetsize): kernel K3 (``gf2_packet.gf2_packet``).

Each takes its kernel's plain version on CPU tensors.

``BitCode.encode_batched_sharded`` splits a stripe batch over the
devices of a mesh (``parallel.placement.Mesh``), one launch a shard on
its device, and gathers the parities on the mesh's first device.

Every encode and decode books into the ``ec.engine`` perf counters and
the device plane (``common.device_metrics``) at ``ceph_tpu``'s entry
points, under its signatures; the times are the host's clock around the
launch (its enqueue time), with no synchronisation added.
"""

from __future__ import annotations

import time
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from ..common import device_metrics
from ..common.perf_counters import collection
from ..device import (canonical_device, device_guard, gather,
                      resolve_device)
from ..parallel.meshctx import get_mesh as _data_plane_mesh
from . import gf2_kernels, gf2_packet
from .gfw import gf2_mat_inv
from .layout import Layout

DECODE_CACHE_SIZE = 512  # erasure signatures kept per code

# -- instrumentation (process-global, ``ceph_tpu``'s names).  A
# signature's first call books under jit_compiles/jit_compile_time (on
# the card it builds the kernel library and the matrix's kernel form),
# so steady-state latency histograms hold steady calls only.
_pc = collection().create("ec.engine")
for _k in ("encode_ops", "decode_ops", "encode_bytes",
           "decode_bytes", "jit_compiles"):
    _pc.add_u64_counter(_k)
for _k in ("encode_time", "decode_time", "jit_compile_time"):
    _pc.add_time(_k)
_pc.add_histogram("encode_lat")
_pc.add_histogram("decode_lat")
# stripes per batched-encode dispatch (1 = the per-stripe path)
_pc.add_histogram("ec_batch_size", min_value=1)
# signatures already seen; a race only double-counts a first call
_seen_sigs: set = set()
# each kind's counter, byte, time and latency keys
_KEYS = {kind: (f"{kind}_ops", f"{kind}_bytes", f"{kind}_time",
                f"{kind}_lat") for kind in ("encode", "decode")}


def book_batch(n_stripes: int) -> None:
    """Record one batched-encode dispatch of ``n_stripes`` stripes (the
    EncodeBatcher and the engine's batched paths book here; per-stripe
    fallbacks book 1)."""
    _pc.hist_add("ec_batch_size", n_stripes)


def encode_batched_sharded(code: "BitCode", stripes, mesh):
    """Module-level handle for ``BitCode.encode_batched_sharded``, the
    name the contract registry addresses the sharded encode by."""
    return code.encode_batched_sharded(stripes, mesh)


def _account(kind: str, sig: tuple, dt: float, nbytes: int,
             jitted: bool = True, nbytes_out: int = 0,
             device_ids=None) -> None:
    """Shared by every EC engine (``BitCode`` here and ``native_gf``'s
    host engine, which passes jitted=False: it has no first-call build
    to keep apart and books nothing into the device plane).  Mesh calls
    pass ``device_ids`` (mesh positions) so each books a row."""
    ops, nb, tkey, lat = _KEYS[kind]
    if jitted and sig not in _seen_sigs:
        _seen_sigs.add(sig)
        _pc.update(((ops, 1), (nb, nbytes), ("jit_compiles", 1),
                    ("jit_compile_time", dt)))
    else:
        _pc.update(((ops, 1), (nb, nbytes), (tkey, dt)), ((lat, dt),))
    if jitted:
        if device_ids:
            device_metrics.record_mesh_launch(
                "ec.engine", sig, dt, device_ids,
                h2d_bytes=nbytes, d2h_bytes=nbytes_out, kind=kind)
        else:
            device_metrics.record_launch(
                "ec.engine", sig, dt,
                h2d_bytes=nbytes, d2h_bytes=nbytes_out, kind=kind)


def device_matrix(bm: np.ndarray, device: torch.device,
                  layout: Layout = None):
    """A 0/1 bit matrix on ``device`` with its kernel's form of it (K1's
    fragments for a word or byte layout, K3's index lists for a packet
    layout; None on the CPU), for a caller that applies it many times.
    K1's fragments are built on the current stream, which is waited for
    once here, so a launch on any stream may use them."""
    t = torch.from_numpy(np.ascontiguousarray(bm, np.uint8)).to(device)
    device_metrics.note_rebuild("matrices")
    if layout is not None and layout.is_packet:
        aux = gf2_packet.packet_lists(t, layout.w)
    else:
        aux = gf2_kernels.gf2_fragments(t)
    if aux is not None:
        torch.cuda.current_stream(device).synchronize()  # sync-ok: once per matrix, so any stream may read its fragments
    return t, aux


def apply(layout: Layout, bm: torch.Tensor, aux, data) -> torch.Tensor:
    """``bm`` applied in ``layout`` to ``data`` (u8[k, L], u8[B, k, L]
    or a sequence of k u8[L] rows, read where they lie) by the layout's
    route; ``aux`` from ``device_matrix``."""
    if layout.is_packet:
        return gf2_packet.gf2_packet(bm, data, layout.w, layout.packetsize,
                                     aux)
    if layout.w == 8:
        return gf2_kernels.gf2_matmul_w8(bm, data, aux)
    return gf2_kernels.gf2_matmul_words(bm, data, layout.w, aux)


class BitCode:
    """A systematic GF(2)-linear code executed as bit products.

    ``coding_bm``: (w*m, w*k) 0/1 coding bit matrix (rows produce the m
    parity chunks' rows from the k data chunks' rows) in ``layout``
    (w=8 bytes by default).  Tensors the methods return live on
    ``device``.
    """

    def __init__(self, k: int, m: int, coding_bm: np.ndarray,
                 layout: Layout = None, device="cuda"):
        self.device = resolve_device(device)
        self.k, self.m = k, m
        self.layout = layout if layout is not None else Layout(8)
        w = self.layout.w
        coding_bm = np.asarray(coding_bm, np.uint8) & 1
        if coding_bm.shape != (w * m, w * k):
            raise ValueError(f"coding bit matrix must be {(w * m, w * k)}, "
                             f"got {coding_bm.shape}")
        self.coding_bm = coding_bm
        self.full_bm = np.concatenate(
            [np.eye(w * k, dtype=np.uint8), coding_bm], axis=0)
        # the kernel's form of it: the matrix and its fragments or lists
        self._enc_dev, self._enc_frag = device_matrix(coding_bm, self.device,
                                                      self.layout)
        self._dec_cache: Dict[Tuple[int, ...], tuple] = {}
        # the coding matrix on each other device of a mesh
        self._mesh_mats: Dict[torch.device, tuple] = {}
        # ceph_tpu's signature flag: the fused w=8 kernel runs (K1 on
        # the card; its plain version on the CPU, as XLA's matmul runs
        # off the TPU)
        self._fused = self.device.type == "cuda" and \
            not self.layout.is_packet and w == 8

    def _tensor(self, data) -> torch.Tensor:
        t = torch.as_tensor(data, dtype=torch.uint8, device=self.device)
        return t.contiguous()

    def _apply(self, bm, aux, data) -> torch.Tensor:
        first = data[0] if isinstance(data, (list, tuple)) else data
        self.layout.check(first.shape[-1])
        return apply(self.layout, bm, aux, data)

    def _sig(self, tag: str, mat_shape, shape, *extra) -> tuple:
        """``ceph_tpu``'s signature of a call (the shape key its jit
        cache and its counters use)."""
        return (tag, tuple(mat_shape), tuple(shape), self.layout.w,
                self.layout.packetsize, *extra, self._fused)

    def _check_stripes(self, stripes: torch.Tensor) -> None:
        if stripes.dim() != 3 or stripes.shape[1] != self.k:
            raise ValueError(f"expected [B, k={self.k}, L], got "
                             f"{tuple(stripes.shape)}")

    # -- encode -------------------------------------------------------
    def encode(self, data) -> torch.Tensor:
        """u8[k, L] (or a sequence of k u8[L] rows, read where they lie)
        -> parity u8[m, L]."""
        if isinstance(data, (list, tuple)):
            data = [self._tensor(r) for r in data]
            L = data[0].shape[-1]
        else:
            data = self._tensor(data)
            if data.dim() != 2 or data.shape[0] != self.k:
                raise ValueError(f"expected [k={self.k}, L], got "
                                 f"{tuple(data.shape)}")
            L = data.shape[1]
        t0 = time.monotonic()
        out = self._apply(self._enc_dev, self._enc_frag, data)
        _account("encode", self._sig("enc", self.coding_bm.shape,
                                     (self.k, L)),
                 time.monotonic() - t0, self.k * L, nbytes_out=self.m * L)
        return out

    def encode_batched(self, stripes, mesh=None) -> torch.Tensor:
        """u8[B, k, L] -> parity u8[B, m, L] in one kernel launch.  The
        kernel indexes the stripes in place, so nothing is transposed or
        copied on the way (but a word layout's virtual chunks);
        byte-identical to B ``encode`` calls.

        ``mesh``: a mesh of more than one device (or, when None, the
        process-default ``parallel.placement.data_plane_mesh()`` when
        it has more than one) routes through
        ``encode_batched_sharded``."""
        if mesh is None:
            mesh = _data_plane_mesh()
        if mesh is not None and mesh.size > 1:
            return self.encode_batched_sharded(stripes, mesh)
        stripes = self._tensor(stripes)
        self._check_stripes(stripes)
        B, k, L = stripes.shape
        t0 = time.monotonic()
        out = self._apply(self._enc_dev, self._enc_frag, stripes)
        _account("encode", self._sig("encb", self.coding_bm.shape,
                                     (B, k, L)),
                 time.monotonic() - t0, B * k * L, nbytes_out=B * self.m * L)
        book_batch(B)
        return out

    def _matrices_on(self, device: torch.device) -> tuple:
        """The coding matrix and its kernel form on ``device``: the
        code's own on its device, a copy made once on any other."""
        if device == canonical_device(self.device):
            return self._enc_dev, self._enc_frag
        mats = self._mesh_mats.get(device)
        if mats is None:
            mats = self._mesh_mats[device] = device_matrix(
                self.coding_bm, device, self.layout)
        return mats

    def encode_batched_sharded(self, stripes, mesh) -> torch.Tensor:
        """The mesh path of ``encode_batched``: u8[B, k, L] (a tensor on
        any device, or host memory) split into shards of ceil(B / n)
        stripes over the n devices of ``mesh``, one launch a shard on
        its device (all launched before any is waited for), and the
        parities u8[B, m, L] gathered on the mesh's first device.  A
        one-shard call is one launch and returns its output as it is.

        ``ceph_tpu`` pads B with zero stripes to ``pad_batch(B, n)``;
        here nothing is padded (each stripe is independent, so the
        bytes are the same), but the call books that padded signature."""
        from ..parallel.meshctx import pad_batch

        if not isinstance(stripes, torch.Tensor):
            stripes = torch.as_tensor(np.ascontiguousarray(stripes,
                                                           np.uint8))
        if stripes.dtype != torch.uint8:
            raise TypeError(f"stripes must be uint8, got {stripes.dtype}")
        self._check_stripes(stripes)
        B, k, L = stripes.shape
        self.layout.check(L)
        t0 = time.monotonic()
        outs = []
        for _, dev, lo, hi in mesh.shards(B):
            bm, aux = self._matrices_on(dev)
            with device_guard(dev):
                part = stripes[lo:hi].to(dev, non_blocking=True).contiguous()
                outs.append(apply(self.layout, bm, aux, part))
        out = gather(outs, mesh.devices[0]) if outs else torch.empty(
            (0, self.m, L), dtype=torch.uint8, device=mesh.devices[0])
        _account("encode",
                 self._sig("encb_mesh", self.coding_bm.shape,
                           (pad_batch(B, mesh.size), k, L), mesh.size),
                 time.monotonic() - t0, B * k * L,
                 nbytes_out=B * self.m * L, device_ids=mesh.device_ids)
        book_batch(B)
        return out

    def all_chunks(self, data) -> torch.Tensor:
        """u8[k, L] -> u8[k+m, L]: systematic data + parity."""
        data = self._tensor(data)
        return torch.cat([data, self.encode(data)], dim=0)

    # -- decode -------------------------------------------------------
    def _decode_mats(self, present: Tuple[int, ...]):
        """The GF(2) decode matrix for k survivors, inverted on the host
        and cached by erasure signature with its kernel's form of it:
        (inverse, fragments or lists or None)."""
        mats = self._dec_cache.get(present)
        if mats is None:
            w = self.layout.w
            rows = np.concatenate(
                [self.full_bm[c * w:(c + 1) * w] for c in present], axis=0)
            mats = device_matrix(gf2_mat_inv(rows), self.device,
                                 self.layout)
            if len(self._dec_cache) >= DECODE_CACHE_SIZE:
                self._dec_cache.pop(next(iter(self._dec_cache)))
            self._dec_cache[present] = mats
        return mats

    def decode_data(self, chunks: Dict[int, object]) -> torch.Tensor:
        """Recover all k data chunks u8[k, L] from any k available
        chunks.  ``chunks``: {chunk_id: u8[L]}."""
        avail = sorted(chunks)
        if len(avail) < self.k:
            raise ValueError("need at least k chunks")
        present = tuple(avail[:self.k])
        inv, aux = self._decode_mats(present)
        rows = [self._tensor(chunks[i]) for i in present]
        L = rows[0].shape[-1]
        # the kernel reads the survivors where they lie (a table of row
        # pointers); nothing is stacked on the card but a word layout's
        # virtual chunks
        t0 = time.monotonic()
        out = self._apply(inv, aux, rows)
        _account("decode", self._sig("dec", inv.shape, (self.k, L)),
                 time.monotonic() - t0, self.k * L, nbytes_out=self.k * L)
        return out

    def decode(self, want: Sequence[int],
               chunks: Dict[int, object]) -> Dict[int, torch.Tensor]:
        """Reconstruct the wanted chunk ids (data and/or parity).
        Returns {chunk_id: u8[L]}."""
        have = {i: self._tensor(c) for i, c in chunks.items()}
        missing = [i for i in want if i not in have]
        if missing:
            if all(i in have for i in range(self.k)):
                # only parity is lost: the data rows are its input as
                # they are, and the inverse would be the identity
                data = [have[i] for i in range(self.k)]
            else:
                data = self.decode_data(have)
                for i in range(self.k):
                    if i not in have:
                        have[i] = data[i]
            if any(i >= self.k for i in missing):
                parity = self.encode(data)
                for i in missing:
                    if i >= self.k:
                        have[i] = parity[i - self.k]
        return {i: have[i] for i in want}
