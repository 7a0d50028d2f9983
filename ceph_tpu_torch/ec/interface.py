"""The ErasureCode interface contract and base-class semantics.

The port of ``ceph_tpu/ec/interface.py``: the reference's
``ErasureCodeInterface`` (src/erasure-code/ErasureCodeInterface.h:
170-462) and the shared behaviour of its ``ErasureCode`` base class
(src/erasure-code/ErasureCode.cc:42-348): profile parsing, the chunk
``mapping=`` remap, aligned ``encode_prepare`` padding, trivial-copy
decode and the default ``minimum_to_decode``.

Chunks live on the code's device.  Every method that takes chunks takes
``bytes``, numpy arrays or ``torch.uint8`` tensors, and returns
``torch.uint8`` tensors on ``self.device``: an object is copied to the
card once (``encode_prepare``), its chunks stay there between calls,
and only a caller at the edge (a tool writing files) copies them back.
The device is set by the registry (``factory(plugin, profile,
device=...)``), never by a profile key.

An object of size S is carved into k data chunks of
``get_chunk_size(S)`` bytes (zero-padded) plus m coding chunks; chunk i
of the encoded layout holds object range [i*chunk_size,
(i+1)*chunk_size) (ErasureCodeInterface.h:39-74).
"""

from __future__ import annotations

import warnings
from typing import Dict, Iterable, List, Sequence, Set, Tuple

import numpy as np
import torch

ErasureCodeProfile = Dict[str, str]

DEFAULT_RULE_ROOT = "default"
DEFAULT_RULE_FAILURE_DOMAIN = "host"


class ErasureCodeError(Exception):
    def __init__(self, errno_: int, msg: str):
        super().__init__(msg)
        self.errno = errno_


def flat_u8(data) -> torch.Tensor:
    """``bytes``, an array or a tensor as a 1-D uint8 tensor where it
    lies, without a copy (a read-only buffer is wrapped as it is: the
    callers only read it)."""
    if isinstance(data, torch.Tensor):
        return data.to(torch.uint8).reshape(-1)
    if isinstance(data, (bytes, bytearray, memoryview)):
        arr = np.frombuffer(data, np.uint8)
    else:
        arr = np.asarray(data, np.uint8).reshape(-1)
    if arr.flags.writeable:
        return torch.from_numpy(arr)
    with warnings.catch_warnings():
        # PyTorch warns that writes through a read-only buffer would be
        # undefined; nothing here writes through it
        warnings.simplefilter("ignore", UserWarning)
        return torch.from_numpy(arr)


def as_chunk(data, device: torch.device) -> torch.Tensor:
    """One chunk, as a contiguous 1-D uint8 tensor on ``device``."""
    return flat_u8(data).to(device).contiguous()


class ChunkBuffers(dict):
    """The ``decoded``/``chunks`` map a plugin fills: chunk ids in
    ``range(n)`` that were never set read as zeros, allocated on first
    read.  The reference zero-fills a buffer for every chunk up front
    (ErasureCode.cc:205-241); here only the buffers a plugin reads
    before it writes them are made."""

    def __init__(self, known: Dict[int, torch.Tensor], n: int, size: int,
                 device: torch.device):
        super().__init__(known)
        self.n, self.size, self.device = n, size, device

    def __missing__(self, i):
        if not 0 <= i < self.n:
            raise KeyError(i)
        buf = torch.zeros(self.size, dtype=torch.uint8, device=self.device)
        self[i] = buf
        return buf


class ErasureCode:
    """Base class: everything but the code-specific matrix.
    ``device``: where the chunks live; a plugin resolves it when it
    builds its code (an ``engine=native`` code lives on the CPU)."""

    def __init__(self, device="cuda"):
        self.chunk_mapping: List[int] = []
        self._profile: ErasureCodeProfile = {}
        self.rule_root = DEFAULT_RULE_ROOT
        self.rule_failure_domain = DEFAULT_RULE_FAILURE_DOMAIN
        self.rule_device_class = ""
        self.device = device

    # -- profile ------------------------------------------------------
    def init(self, profile: ErasureCodeProfile) -> None:
        """Parse the profile; raises ErasureCodeError on bad input
        (the reference returns -EINVAL and fills *ss)."""
        self.rule_root = profile.get("crush-root", DEFAULT_RULE_ROOT)
        self.rule_failure_domain = profile.get(
            "crush-failure-domain", DEFAULT_RULE_FAILURE_DOMAIN)
        self.rule_device_class = profile.get("crush-device-class", "")
        self._parse_mapping(profile)
        self._profile = dict(profile)

    def get_profile(self) -> ErasureCodeProfile:
        return self._profile

    def _parse_mapping(self, profile: ErasureCodeProfile) -> None:
        """profile ``mapping=DD_D...``: data chunks go to the 'D'
        positions, coding chunks to the rest (ErasureCode.cc:260-279)."""
        mapping = profile.get("mapping")
        if not mapping:
            return
        data_pos = [i for i, c in enumerate(mapping) if c == "D"]
        coding_pos = [i for i, c in enumerate(mapping) if c != "D"]
        self.chunk_mapping = data_pos + coding_pos

    def chunk_index(self, i: int) -> int:
        return self.chunk_mapping[i] if i < len(self.chunk_mapping) else i

    @staticmethod
    def sanity_check_k_m(k: int, m: int) -> None:
        if k < 2:
            raise ErasureCodeError(-22, f"k={k} must be >= 2")
        if m < 1:
            raise ErasureCodeError(-22, f"m={m} must be >= 1")

    # -- geometry (code-specific) --------------------------------------
    def get_chunk_count(self) -> int:
        raise NotImplementedError

    def get_data_chunk_count(self) -> int:
        raise NotImplementedError

    def get_coding_chunk_count(self) -> int:
        return self.get_chunk_count() - self.get_data_chunk_count()

    def get_sub_chunk_count(self) -> int:
        return 1

    def get_chunk_size(self, object_size: int) -> int:
        raise NotImplementedError

    # -- CRUSH rule ----------------------------------------------------
    def create_rule(self, name: str, crush) -> int:
        """add_simple_rule(root, failure-domain, class, "indep")
        (ErasureCode.cc:64-82); ``crush`` is the port's CrushWrapper."""
        return crush.add_simple_rule(
            name, self.rule_root, self.rule_failure_domain,
            self.rule_device_class, "indep", rule_type=3)

    # -- minimum_to_decode --------------------------------------------
    def _minimum_to_decode(self, want_to_read: Set[int],
                           available: Set[int]) -> Set[int]:
        """Default: wanted chunks if all available, else the first k
        available (ErasureCode.cc:102-119)."""
        if want_to_read <= available:
            return set(want_to_read)
        k = self.get_data_chunk_count()
        if len(available) < k:
            raise ErasureCodeError(-5, "not enough chunks to decode")
        return set(sorted(available)[:k])

    def minimum_to_decode(
            self, want_to_read: Set[int], available: Set[int]
    ) -> Dict[int, List[Tuple[int, int]]]:
        """chunk id -> [(sub_chunk_offset, count)]
        (ErasureCode.cc:121-137)."""
        ids = self._minimum_to_decode(set(want_to_read), set(available))
        sub = [(0, self.get_sub_chunk_count())]
        return {i: list(sub) for i in sorted(ids)}

    def minimum_to_decode_with_cost(
            self, want_to_read: Set[int],
            available: Dict[int, int]) -> Set[int]:
        """Equal-cost default (ErasureCode.cc:139-148)."""
        return self._minimum_to_decode(set(want_to_read),
                                       set(available.keys()))

    # -- encode -------------------------------------------------------
    def _tensor(self, data) -> torch.Tensor:
        return as_chunk(data, self.device)

    def _buffers(self, known: Dict[int, torch.Tensor],
                 size: int) -> ChunkBuffers:
        return ChunkBuffers(known, self.get_chunk_count(), size,
                            self.device)

    def encode_prepare(self, raw) -> torch.Tensor:
        """Split and zero-pad into k aligned data chunks
        (ErasureCode.cc:150-185): u8[k, chunk_size] on the code's
        device, written by one copy of the object."""
        src = flat_u8(raw)
        n = src.numel()
        k = self.get_data_chunk_count()
        blocksize = self.get_chunk_size(n)
        out = torch.empty(k * blocksize, dtype=torch.uint8,
                          device=self.device)
        out[:n].copy_(src)
        out[n:].zero_()
        return out.view(k, blocksize)

    def _encoded_ids(self) -> Set[int]:
        return {self.chunk_index(i) for i in range(self.get_chunk_count())}

    def encode(self, want_to_encode: Iterable[int],
               raw) -> Dict[int, torch.Tensor]:
        """Full encode flow (ErasureCode.cc:187-203): prepare, run the
        code, return only the wanted chunks keyed by encoded index
        (mapping applied)."""
        want = set(want_to_encode)
        data = self.encode_prepare(raw)
        k = self.get_data_chunk_count()
        chunks = self._buffers(
            {self.chunk_index(i): data[i] for i in range(k)}, data.shape[1])
        self.encode_chunks(want, chunks)
        ids = self._encoded_ids()
        return {i: chunks[i] for i in want if i in ids}

    def encode_chunks(self, want_to_encode: Set[int],
                      chunks: Dict[int, torch.Tensor]) -> None:
        raise NotImplementedError

    def encode_batched(self, want_to_encode: Iterable[int],
                       raws: Sequence, mesh=None
                       ) -> List[Dict[int, torch.Tensor]]:
        """Batched full-object encode: one ``encode_chunks`` call for B
        same-size objects, byte-identical to B ``encode`` calls.

        Every code with one sub-chunk is bytewise-linear with aligned
        chunk sizes, so the objects' data chunks lie side by side (chunk
        i of the whole is every object's chunk i, u8[k, B*L]), go
        through the code once (one K1 launch a product, the rows read
        where they lie) and the parities split back as views.
        Sub-chunked codes (Clay: its coupling geometry follows the chunk
        length) and mixed sizes fall back to one ``encode`` an object.

        ``mesh``: a mesh of more than one device (explicit, or the
        process-default data-plane mesh when None) splits the stripe
        batch u8[B, k, L] over its devices through the engine's
        ``encode_batched_sharded``, for the plugins whose parity is one
        ``BitCode`` (jerasure and isa, as in ``ceph_tpu``); layered and
        sub-chunked plugins keep the path above."""
        raws = list(raws)
        want = set(want_to_encode)
        if len(raws) <= 1 or self.get_sub_chunk_count() != 1 or \
                len({flat_u8(r).numel() for r in raws}) != 1:
            return [self.encode(want, r) for r in raws]
        if mesh is None:
            from ..parallel.meshctx import get_mesh

            mesh = get_mesh()
        code = self._mesh_code()
        if mesh is not None and mesh.size > 1 and code is not None:
            return self._encode_batched_mesh(want, raws, code, mesh)
        k = self.get_data_chunk_count()
        parts = [self.encode_prepare(r) for r in raws]
        B, L = len(parts), parts[0].shape[1]
        cat = torch.stack(parts, dim=1).view(k, B * L)
        del parts
        chunks = self._buffers(
            {self.chunk_index(i): cat[i] for i in range(k)}, B * L)
        self.encode_chunks(want, chunks)
        ids = self._encoded_ids()
        return [{i: chunks[i][b * L:(b + 1) * L] for i in want if i in ids}
                for b in range(B)]

    def _mesh_code(self):
        """The code ``encode_batched`` shards over a mesh: None here;
        a plugin whose parity is one ``BitCode`` returns it."""
        return None

    def _encode_batched_mesh(self, want: Set[int], raws, code,
                             mesh) -> List[Dict[int, torch.Tensor]]:
        """The mesh half of ``encode_batched``: the prepared objects
        stacked into the stripe batch u8[B, k, L], split over the mesh
        by the engine, and each object's chunks assembled as
        ``encode_chunks`` would (parity j at ``chunk_index(k + j)``).
        The parities live on the mesh's first device."""
        parts = [self.encode_prepare(r) for r in raws]
        stripes = torch.stack(parts)                     # u8[B, k, L]
        parity = code.encode_batched_sharded(stripes, mesh)  # u8[B, m, L]
        k = self.get_data_chunk_count()
        n = self.get_chunk_count()
        out: List[Dict[int, torch.Tensor]] = []
        for b in range(len(parts)):
            chunks = {self.chunk_index(i): stripes[b, i] for i in range(k)}
            for j in range(k, n):
                chunks[self.chunk_index(j)] = parity[b, j - k]
            out.append({i: chunks[i] for i in want if i in chunks})
        return out

    # -- decode -------------------------------------------------------
    def decode(self, want_to_read: Iterable[int], chunks: Dict[int, object],
               chunk_size: int = 0) -> Dict[int, torch.Tensor]:
        return self._decode(set(want_to_read), chunks)

    def _decode(self, want_to_read: Set[int],
                chunks: Dict[int, object]) -> Dict[int, torch.Tensor]:
        """Trivial copy when everything wanted is present, else
        decode_chunks (ErasureCode.cc:205-241)."""
        if want_to_read <= set(chunks):
            return {i: self._tensor(chunks[i]) for i in want_to_read}
        chunks = {i: self._tensor(c) for i, c in chunks.items()}
        blocksize = next(iter(chunks.values())).numel()
        decoded = self._buffers(dict(chunks), blocksize)
        self.decode_chunks(want_to_read, chunks, decoded)
        return {i: decoded[i] for i in want_to_read}

    def decode_chunks(self, want_to_read: Set[int],
                      chunks: Dict[int, torch.Tensor],
                      decoded: Dict[int, torch.Tensor]) -> None:
        raise NotImplementedError

    def get_chunk_mapping(self) -> List[int]:
        return self.chunk_mapping

    def decode_concat(self, chunks: Dict[int, object]) -> torch.Tensor:
        """Recover and concatenate the data chunks in mapping order
        (ErasureCode.cc:281-304, ErasureCodeInterface.h:460): u8 on the
        code's device, where the reference returns a buffer."""
        k = self.get_data_chunk_count()
        want = [self.chunk_index(i) for i in range(k)]
        decoded = self.decode(set(want), chunks)
        return torch.cat([decoded[i] for i in want])

    # -- profile field parsing (to_int/to_bool, ErasureCode.cc:288-346)
    @staticmethod
    def to_int(name: str, profile: ErasureCodeProfile,
               default: int) -> int:
        v = profile.get(name, "")
        if v == "":
            profile[name] = str(default)
            return default
        try:
            return int(v)
        except ValueError:
            raise ErasureCodeError(
                -22, f"could not convert {name}={v} to int")

    @staticmethod
    def to_bool(name: str, profile: ErasureCodeProfile,
                default: bool) -> bool:
        v = profile.get(name, "")
        if v == "":
            return default
        return v.lower() in ("yes", "true", "1", "on")
