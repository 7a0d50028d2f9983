"""The CLAY plugin: coupled-layer MSR regenerating codes, on K1.

The port of ``ceph_tpu/ec/clay.py``, after
src/erasure-code/clay/ErasureCodeClay.{h,cc}: chunks split into
``sub_chunk_no = q^t`` sub-chunks on a (q x t) node grid; encode and
decode work plane by plane through pairwise-coupling transforms (a
k=2, m=2 "pft" code), with a scalar MDS code (jerasure, isa or shec)
across each plane's uncoupled values.  Single-node repair reads only d
helpers x (1/q of each chunk) (minimum_to_repair, :324-363).

Ported one to one: the parse/q/t/nu geometry (:188-300), is_repair
(:302-322), get_repair_subchunks (:365-380), repair and
repair_one_lost_chunk (:404-645), decode_layered / decode_erasures /
decode_uncoupled (:648-760), the type-1, coupled and uncoupled pair
transforms (:776-875) and the plane order (:763-773, :877-888).  Where
the reference mutates bufferlist views in place, this port writes K1's
results back into slices of the chunk tensors (``copy_``).

Both sub-codes come from the port's registry on this code's device (an
``engine=`` key of the profile is theirs too).  Every pair transform
and plane decode is its own small K1 launch over one sub-chunk, so a
call's time is set by launches and the host loop, not by the kernel.
"""

from __future__ import annotations

from typing import Dict, List, Set, Tuple

import torch

from .interface import ErasureCode, ErasureCodeError, ErasureCodeProfile

DEFAULT_K = 4
DEFAULT_M = 2


class ErasureCodeClay(ErasureCode):
    def __init__(self, device="cuda"):
        super().__init__(device)
        self.k = 0
        self.m = 0
        self.d = 0
        self.q = 0
        self.t = 0
        self.nu = 0
        self.sub_chunk_no = 0
        self.mds: ErasureCode | None = None
        self.pft: ErasureCode | None = None

    # -- profile (:188-300) -------------------------------------------
    def init(self, profile: ErasureCodeProfile) -> None:
        self.parse(profile)
        super().init(profile)

    def parse(self, profile: ErasureCodeProfile) -> None:
        from .registry import factory

        self.k = self.to_int("k", profile, DEFAULT_K)
        self.m = self.to_int("m", profile, DEFAULT_M)
        self.sanity_check_k_m(self.k, self.m)
        self.d = self.to_int("d", profile, self.k + self.m - 1)

        plugin = profile.get("scalar_mds", "") or "jerasure"
        if plugin not in ("jerasure", "isa", "shec"):
            raise ErasureCodeError(
                -22, f"scalar_mds {plugin} not supported; use "
                     f"jerasure, isa or shec")
        tech = profile.get("technique", "")
        if not tech:
            tech = "reed_sol_van" if plugin in ("jerasure", "isa") \
                else "single"
        allowed = {
            "jerasure": ("reed_sol_van", "reed_sol_r6_op",
                         "cauchy_orig", "cauchy_good", "liber8tion"),
            "isa": ("reed_sol_van", "cauchy"),
            "shec": ("single", "multiple"),
        }[plugin]
        if tech not in allowed:
            raise ErasureCodeError(
                -22, f"technique {tech} not supported for {plugin}")

        if self.d < self.k or self.d > self.k + self.m - 1:
            raise ErasureCodeError(
                -22, f"value of d {self.d} must be within "
                     f"[{self.k},{self.k + self.m - 1}]")
        self.q = self.d - self.k + 1
        self.nu = (self.q - (self.k + self.m) % self.q) \
            if (self.k + self.m) % self.q else 0
        if self.k + self.m + self.nu > 254:
            raise ErasureCodeError(-22, "k+m+nu must be <= 254")

        mds_profile = {"plugin": plugin, "technique": tech,
                       "k": str(self.k + self.nu), "m": str(self.m),
                       "w": "8"}
        pft_profile = {"plugin": plugin, "technique": tech,
                       "k": "2", "m": "2", "w": "8"}
        if plugin == "shec":
            mds_profile["c"] = "2"
            pft_profile["c"] = "2"
        if profile.get("engine"):
            mds_profile["engine"] = pft_profile["engine"] = profile["engine"]
        self.mds = factory(plugin, mds_profile, device=self.device)
        self.pft = factory(plugin, pft_profile, device=self.device)
        self.device = self.mds.device

        self.t = (self.k + self.m + self.nu) // self.q
        self.sub_chunk_no = self.q ** self.t

    # -- geometry -----------------------------------------------------
    def get_chunk_count(self) -> int:
        return self.k + self.m

    def get_data_chunk_count(self) -> int:
        return self.k

    def get_sub_chunk_count(self) -> int:
        return self.sub_chunk_no

    def get_chunk_size(self, object_size: int) -> int:
        """:90-96: aligned so each sub-chunk is a whole scalar-code
        word block."""
        align = self.sub_chunk_no * self.k * \
            self.pft.get_chunk_size(1)
        padded = ((object_size + align - 1) // align) * align
        return padded // self.k

    # -- plane helpers ------------------------------------------------
    def get_plane_vector(self, z: int) -> List[int]:
        z_vec = [0] * self.t
        for i in range(self.t):
            z_vec[self.t - 1 - i] = z % self.q
            z = z // self.q
        return z_vec

    def get_max_iscore(self, erased: Set[int]) -> int:
        weight = [0] * self.t
        score = 0
        for i in erased:
            if weight[i // self.q] == 0:
                weight[i // self.q] = 1
                score += 1
        return score

    def _plane_order(self, erased: Set[int]) -> List[int]:
        order = [0] * self.sub_chunk_no
        for z in range(self.sub_chunk_no):
            z_vec = self.get_plane_vector(z)
            order[z] = sum(1 for i in erased
                           if i % self.q == z_vec[i // self.q])
        return order

    def _zeros(self, size: int) -> torch.Tensor:
        return torch.zeros(size, dtype=torch.uint8, device=self.device)

    # -- pairwise transform helper ------------------------------------
    def _pft_decode(self, erased: Set[int],
                    known: Dict[int, torch.Tensor],
                    out_views: Dict[int, torch.Tensor]) -> None:
        """Run the 2x2 pairwise code and copy the results back into the
        sub-chunk views (the reference mutates through bufferlist
        views).  The inner code writes new tensors into ``decoded`` and
        reads ``known`` where it lies, so nothing is copied first."""
        decoded = {i: known[i] if i in known else out_views[i]
                   for i in range(4)}
        self.pft.decode_chunks(erased, dict(known), decoded)
        for i in erased:
            out_views[i].copy_(decoded[i])

    # -- uncoupled scalar decode (:742-760) ----------------------------
    def _decode_uncoupled(self, U: Dict[int, torch.Tensor],
                          erased: Set[int], z: int,
                          sc_size: int) -> None:
        known = {}
        decoded = {}
        for i in range(self.q * self.t):
            view = U[i][z * sc_size:(z + 1) * sc_size]
            if i not in erased:
                known[i] = view
            decoded[i] = view
        self.mds.decode_chunks(set(erased), known, decoded)
        for i in erased:
            U[i][z * sc_size:(z + 1) * sc_size].copy_(decoded[i])

    # -- coupled<->uncoupled transforms (:776-875) ---------------------
    def _swap_idx(self, x: int, zy: int) -> Tuple[int, int, int, int]:
        if zy > x:
            return 1, 0, 3, 2
        return 0, 1, 2, 3

    def _get_uncoupled_from_coupled(self, chunks, U, x, y, z, z_vec,
                                    sc_size) -> None:
        node_xy = y * self.q + x
        node_sw = y * self.q + z_vec[y]
        z_sw = z + (x - z_vec[y]) * self.q ** (self.t - 1 - y)
        i0, i1, i2, i3 = self._swap_idx(x, z_vec[y])
        known = {
            i0: chunks[node_xy][z * sc_size:(z + 1) * sc_size],
            i1: (
                chunks[node_sw][z_sw * sc_size:(z_sw + 1) * sc_size]),
        }
        out = {
            i2: U[node_xy][z * sc_size:(z + 1) * sc_size],
            i3: U[node_sw][z_sw * sc_size:(z_sw + 1) * sc_size],
        }
        self._pft_decode({2, 3}, known, out)

    def _get_coupled_from_uncoupled(self, chunks, U, x, y, z, z_vec,
                                    sc_size) -> None:
        node_xy = y * self.q + x
        node_sw = y * self.q + z_vec[y]
        z_sw = z + (x - z_vec[y]) * self.q ** (self.t - 1 - y)
        assert z_vec[y] < x
        known = {
            2: U[node_xy][z * sc_size:(z + 1) * sc_size],
            3: (
                U[node_sw][z_sw * sc_size:(z_sw + 1) * sc_size]),
        }
        out = {
            0: chunks[node_xy][z * sc_size:(z + 1) * sc_size],
            1: chunks[node_sw][z_sw * sc_size:(z_sw + 1) * sc_size],
        }
        self._pft_decode({0, 1}, known, out)

    def _recover_type1(self, chunks, U, x, y, z, z_vec,
                       sc_size) -> None:
        node_xy = y * self.q + x
        node_sw = y * self.q + z_vec[y]
        z_sw = z + (x - z_vec[y]) * self.q ** (self.t - 1 - y)
        i0, i1, i2, i3 = self._swap_idx(x, z_vec[y])
        known = {
            i1: (
                chunks[node_sw][z_sw * sc_size:(z_sw + 1) * sc_size]),
            i2: U[node_xy][z * sc_size:(z + 1) * sc_size],
        }
        out = {
            i0: chunks[node_xy][z * sc_size:(z + 1) * sc_size],
            i3: self._zeros(sc_size),
        }
        self._pft_decode({i0}, known, out)

    # -- layered decode (:648-741) -------------------------------------
    def _decode_layered(self, erased: Set[int],
                        chunks: Dict[int, torch.Tensor]) -> None:
        size = chunks[0].numel()
        assert size % self.sub_chunk_no == 0
        sc_size = size // self.sub_chunk_no
        erased = set(erased)
        assert erased
        # pad erasures to exactly m with shortened/parity nodes
        for i in range(self.k + self.nu, self.q * self.t):
            if len(erased) >= self.m:
                break
            erased.add(i)
        assert len(erased) == self.m

        U = {i: self._zeros(size) for i in range(self.q * self.t)}
        order = self._plane_order(erased)
        max_iscore = self.get_max_iscore(erased)

        for iscore in range(max_iscore + 1):
            for z in range(self.sub_chunk_no):
                if order[z] == iscore:
                    self._decode_erasures(erased, z, chunks, U, sc_size)
            for z in range(self.sub_chunk_no):
                if order[z] != iscore:
                    continue
                z_vec = self.get_plane_vector(z)
                for node_xy in sorted(erased):
                    x = node_xy % self.q
                    y = node_xy // self.q
                    node_sw = y * self.q + z_vec[y]
                    if z_vec[y] != x:
                        if node_sw not in erased:
                            self._recover_type1(chunks, U, x, y, z,
                                                z_vec, sc_size)
                        elif z_vec[y] < x:
                            self._get_coupled_from_uncoupled(
                                chunks, U, x, y, z, z_vec, sc_size)
                    else:
                        chunks[node_xy][z * sc_size:(z + 1) * sc_size] \
                            .copy_(U[node_xy][z * sc_size:(z + 1) * sc_size])

    def _decode_erasures(self, erased: Set[int], z: int, chunks, U,
                         sc_size: int) -> None:
        z_vec = self.get_plane_vector(z)
        for x in range(self.q):
            for y in range(self.t):
                node_xy = self.q * y + x
                node_sw = self.q * y + z_vec[y]
                if node_xy in erased:
                    continue
                if z_vec[y] < x:
                    self._get_uncoupled_from_coupled(
                        chunks, U, x, y, z, z_vec, sc_size)
                elif z_vec[y] == x:
                    U[node_xy][z * sc_size:(z + 1) * sc_size].copy_(
                        chunks[node_xy][z * sc_size:(z + 1) * sc_size])
                else:
                    if node_sw in erased:
                        self._get_uncoupled_from_coupled(
                            chunks, U, x, y, z, z_vec, sc_size)
        self._decode_uncoupled(U, erased, z, sc_size)

    # -- encode/decode entry points (:129-185) -------------------------
    def encode_chunks(self, want_to_encode: Set[int],
                      chunks_io: Dict[int, torch.Tensor]) -> None:
        """The parity nodes decoded as erasures of the data.  Only erased
        nodes are written, so the data chunks are read where they lie;
        the parity and shortening nodes are new zeroed buffers."""
        chunk_size = chunks_io[self.chunk_index(0)].numel()
        chunks: Dict[int, torch.Tensor] = {
            i: chunks_io[self.chunk_index(i)] for i in range(self.k)}
        for i in range(self.k, self.k + self.nu + self.m):
            chunks[i] = self._zeros(chunk_size)
        parity_nodes = {i + self.nu
                        for i in range(self.k, self.k + self.m)}
        self._decode_layered(parity_nodes, chunks)
        for i in range(self.k, self.k + self.m):
            chunks_io[self.chunk_index(i)] = chunks[i + self.nu]

    def decode_chunks(self, want_to_read: Set[int],
                      chunks_avail: Dict[int, torch.Tensor],
                      decoded: Dict[int, torch.Tensor]) -> None:
        """Every erased node on a new buffer, zeroed as the reference's
        decode buffers are; the others are read where they lie."""
        chunk_size = next(iter(chunks_avail.values())).numel()
        erased = set()
        grid: Dict[int, torch.Tensor] = {}
        for i in range(self.k + self.m):
            node = i if i < self.k else i + self.nu
            enc = self.chunk_index(i)  # encoded-position remap
            if enc in chunks_avail:
                grid[node] = chunks_avail[enc]
            else:
                erased.add(node)
                grid[node] = self._zeros(chunk_size)
        for i in range(self.k, self.k + self.nu):
            grid[i] = self._zeros(chunk_size)
        self._decode_layered(erased, grid)
        for i in range(self.k + self.m):
            node = i if i < self.k else i + self.nu
            decoded[self.chunk_index(i)] = grid[node]

    # -- repair path (:302-645) ----------------------------------------
    def is_repair(self, want_to_read: Set[int],
                  available: Set[int]) -> bool:
        if set(want_to_read) <= set(available):
            return False
        if len(want_to_read) > 1:
            return False
        i = next(iter(want_to_read))
        lost = i if i < self.k else i + self.nu
        for x in range(self.q):
            node = (lost // self.q) * self.q + x
            node = node if node < self.k else node - self.nu
            if node != i and node not in available:
                return False
        return len(available) >= self.d

    def get_repair_subchunks(self, lost_node: int
                             ) -> List[Tuple[int, int]]:
        y_lost = lost_node // self.q
        x_lost = lost_node % self.q
        seq = self.q ** (self.t - 1 - y_lost)
        num_seq = self.q ** y_lost
        out = []
        index = x_lost * seq
        for _ in range(num_seq):
            out.append((index, seq))
            index += self.q * seq
        return out

    def get_repair_sub_chunk_count(self,
                                   want_to_read: Set[int]) -> int:
        weight = [0] * self.t
        for i in want_to_read:
            weight[i // self.q] += 1
        count = 1
        for y in range(self.t):
            count *= (self.q - weight[y])
        return self.sub_chunk_no - count

    def minimum_to_decode(self, want_to_read: Set[int],
                          available: Set[int]
                          ) -> Dict[int, List[Tuple[int, int]]]:
        """:98-104: bandwidth-optimal repair plan when possible."""
        if self.is_repair(set(want_to_read), set(available)):
            return self._minimum_to_repair(set(want_to_read),
                                           set(available))
        return super().minimum_to_decode(want_to_read, available)

    def _minimum_to_repair(self, want_to_read: Set[int],
                           available: Set[int]
                           ) -> Dict[int, List[Tuple[int, int]]]:
        i = next(iter(want_to_read))
        lost = i if i < self.k else i + self.nu
        sub_ind = self.get_repair_subchunks(lost)
        minimum: Dict[int, List[Tuple[int, int]]] = {}
        for j in range(self.q):
            if j != lost % self.q:
                rep = (lost // self.q) * self.q + j
                if rep < self.k:
                    minimum[rep] = list(sub_ind)
                elif rep >= self.k + self.nu:
                    minimum[rep - self.nu] = list(sub_ind)
        for chunk in sorted(available):
            if len(minimum) >= self.d:
                break
            minimum.setdefault(chunk, list(sub_ind))
        assert len(minimum) == self.d
        return minimum

    def decode(self, want_to_read, chunks: Dict[int, object],
               chunk_size: int = 0):
        """:98-125: helpers holding only repair sub-chunks route to the
        repair path."""
        want = set(want_to_read)
        avail = set(chunks)
        chunks = {i: self._tensor(c) for i, c in chunks.items()}
        first_len = next(iter(chunks.values())).numel()
        if self.is_repair(want, avail) and chunk_size > first_len:
            return self._repair(want, chunks, chunk_size)
        return self._decode(want, chunks)

    def _repair(self, want_to_read: Set[int],
                chunks: Dict[int, torch.Tensor],
                chunk_size: int) -> Dict[int, torch.Tensor]:
        assert len(want_to_read) == 1 and len(chunks) == self.d
        repair_sub_no = self.get_repair_sub_chunk_count(want_to_read)
        repair_blocksize = next(iter(chunks.values())).numel()
        assert repair_blocksize % repair_sub_no == 0
        sub_chunksize = repair_blocksize // repair_sub_no
        chunksize = self.sub_chunk_no * sub_chunksize
        assert chunksize == chunk_size

        recovered: Dict[int, torch.Tensor] = {}
        helper: Dict[int, torch.Tensor] = {}
        aloof: Set[int] = set()
        lost_id = -1
        repair_sub_ind: List[Tuple[int, int]] = []
        for i in range(self.k + self.m):
            node = i if i < self.k else i + self.nu
            if i in chunks:
                helper[node] = chunks[i]
            elif i != next(iter(want_to_read)):
                aloof.add(node)
            else:
                lost_id = node
                recovered[node] = self._zeros(chunksize)
                repair_sub_ind = self.get_repair_subchunks(node)
        for i in range(self.k, self.k + self.nu):
            helper[i] = self._zeros(repair_blocksize)
        assert len(helper) + len(aloof) + len(recovered) == \
            self.q * self.t

        self._repair_one_lost_chunk(recovered, aloof, helper,
                                    repair_blocksize, repair_sub_ind)
        i = next(iter(want_to_read))
        return {i: recovered[lost_id]}

    def _repair_one_lost_chunk(self, recovered, aloof, helper,
                               repair_blocksize, repair_sub_ind
                               ) -> None:
        q, t = self.q, self.t
        repair_subchunks = self.sub_chunk_no // q
        sub_sz = repair_blocksize // repair_subchunks

        ordered_planes: Dict[int, Set[int]] = {}
        repair_plane_to_ind: Dict[int, int] = {}
        plane_ind = 0
        for index, count in repair_sub_ind:
            for j in range(index, index + count):
                z_vec = self.get_plane_vector(j)
                order = sum(1 for node in recovered
                            if node % q == z_vec[node // q])
                order += sum(1 for node in aloof
                             if node % q == z_vec[node // q])
                assert order > 0
                ordered_planes.setdefault(order, set()).add(j)
                repair_plane_to_ind[j] = plane_ind
                plane_ind += 1
        assert plane_ind == repair_subchunks

        U = {i: self._zeros(self.sub_chunk_no * sub_sz)
             for i in range(q * t)}

        (lost_chunk,) = recovered.keys()
        erasures = {lost_chunk - lost_chunk % q + i for i in range(q)}
        erasures |= aloof

        order = 1
        while order in ordered_planes:
            for z in sorted(ordered_planes[order]):
                z_vec = self.get_plane_vector(z)
                for y in range(t):
                    for x in range(q):
                        node_xy = y * q + x
                        if node_xy in erasures:
                            continue
                        z_sw = z + (x - z_vec[y]) * q ** (t - 1 - y)
                        node_sw = y * q + z_vec[y]
                        i0, i1, i2, i3 = self._swap_idx(x, z_vec[y])
                        hslice = helper[node_xy][
                            repair_plane_to_ind[z] * sub_sz:
                            (repair_plane_to_ind[z] + 1) * sub_sz]
                        if node_sw in aloof:
                            known = {
                                i0: hslice,
                                i3: (
                                    U[node_sw][z_sw * sub_sz:
                                               (z_sw + 1) * sub_sz]),
                            }
                            out = {
                                i2: U[node_xy][z * sub_sz:
                                               (z + 1) * sub_sz],
                                i1: self._zeros(sub_sz),
                            }
                            self._pft_decode({i2}, known, out)
                        elif z_vec[y] != x:
                            sw_slice = helper[node_sw][
                                repair_plane_to_ind[z_sw] * sub_sz:
                                (repair_plane_to_ind[z_sw] + 1)
                                * sub_sz]
                            known = {i0: hslice,
                                     i1: sw_slice}
                            out = {
                                i2: U[node_xy][z * sub_sz:
                                               (z + 1) * sub_sz],
                                i3: self._zeros(sub_sz),
                            }
                            self._pft_decode({i2}, known, out)
                        else:
                            U[node_xy][z * sub_sz:(z + 1) * sub_sz] \
                                .copy_(hslice)
                assert len(erasures) <= self.m
                self._decode_uncoupled(U, erasures, z, sub_sz)
                for i in sorted(erasures):
                    x, y = i % q, i // q
                    node_sw = y * q + z_vec[y]
                    z_sw = z + (x - z_vec[y]) * q ** (t - 1 - y)
                    i0, i1, i2, i3 = self._swap_idx(x, z_vec[y])
                    if i in aloof:
                        continue
                    if x == z_vec[y]:  # hole-dot pair (type 0)
                        recovered[i][z * sub_sz:(z + 1) * sub_sz].copy_(
                            U[i][z * sub_sz:(z + 1) * sub_sz])
                    else:
                        assert y == lost_chunk // q
                        assert node_sw == lost_chunk
                        known = {
                            i0: (helper[i][
                                repair_plane_to_ind[z] * sub_sz:
                                (repair_plane_to_ind[z] + 1)
                                * sub_sz]),
                            i2: (U[i][z * sub_sz:
                                              (z + 1) * sub_sz]),
                        }
                        out = {
                            i1: recovered[node_sw][
                                z_sw * sub_sz:(z_sw + 1) * sub_sz],
                            i3: self._zeros(sub_sz),
                        }
                        self._pft_decode({i1}, known, out)
            order += 1


def make_clay(profile: ErasureCodeProfile,
              device="cuda") -> ErasureCodeClay:
    inst = ErasureCodeClay(device)
    inst.init(profile)
    return inst
