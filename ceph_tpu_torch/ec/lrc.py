"""The LRC plugin: layered locally-repairable codes.

The port of ``ceph_tpu/ec/lrc.py``, after
src/erasure-code/lrc/ErasureCodeLrc.{h,cc}: a stack of layers, each a
whole inner erasure code (jerasure by default) over a subset of the
chunk positions given by a ``chunks_map`` string over {D, c, _}.  A
single lost chunk is repaired from its local layer alone, reading fewer
chunks than the global k.

Profile forms, as in the reference:
- the k/m/l form (parse_kml, ErasureCodeLrc.cc:290-391): builds
  ``mapping``, a global layer plus (k+m)/l local layers, and the
  crush steps for locality-aware placement;
- explicit ``mapping=`` and ``layers=[[chunks_map, profile], ...]``
  JSON (layers_parse :140, layers_init :210).

Ported: the _minimum_to_decode layer walk with its three cases
(:563-731), the encode from the deepest covering layer (:734-768), the
decode that feeds each layer's recoveries to the layers above
(:771-857), and the multi-step rule (create_rule :44-110) on the port's
``CrushWrapper``.  Every layer's inner code comes from the port's
registry on this code's device; an ``engine=`` key of the profile is
the default of each layer's, so that ``engine=native`` makes the whole
code a CPU oracle.
"""

from __future__ import annotations

import json
from typing import Dict, List, Set, Tuple

import torch

from ..crush import constants as C
from ..crush.map import Rule, RuleStep
from .interface import ErasureCode, ErasureCodeError, ErasureCodeProfile

DEFAULT_KML = -1


class Layer:
    """One code layer over a subset of chunk positions."""

    def __init__(self, chunks_map: str, profile: ErasureCodeProfile):
        self.chunks_map = chunks_map
        self.profile = dict(profile)
        self.data = [i for i, c in enumerate(chunks_map) if c == "D"]
        self.coding = [i for i, c in enumerate(chunks_map) if c == "c"]
        self.chunks = self.data + self.coding
        self.chunks_as_set = set(self.chunks)
        self.erasure_code: ErasureCode | None = None


class ErasureCodeLrc(ErasureCode):
    def __init__(self, device="cuda"):
        super().__init__(device)
        self.engine = ""
        self.layers: List[Layer] = []
        self.chunk_count_ = 0
        self.data_chunk_count_ = 0
        self.rule_steps: List[Tuple[str, str, int]] = []  # (op,type,n)

    # -- profile ------------------------------------------------------
    def init(self, profile: ErasureCodeProfile) -> None:
        self.engine = profile.get("engine", "")
        self.parse_kml(profile)
        mapping = profile.get("mapping")
        if not mapping:
            raise ErasureCodeError(-22, "LRC profile needs mapping= "
                                        "or k/m/l")
        layers_json = profile.get("layers")
        if not layers_json:
            raise ErasureCodeError(-22, "LRC profile needs layers= "
                                        "or k/m/l")
        self.layers_parse(layers_json)
        self.chunk_count_ = len(mapping)
        self.data_chunk_count_ = mapping.count("D")
        self.layers_sanity_checks(layers_json)
        self.layers_init()
        if not self.rule_steps:
            self.rule_steps = [("chooseleaf",
                                profile.get("crush-failure-domain",
                                            "host"), 0)]
        super().init(profile)

    def parse_kml(self, profile: ErasureCodeProfile) -> None:
        """Generated form (ErasureCodeLrc.cc:290-391)."""
        k = int(profile.get("k", DEFAULT_KML))
        m = int(profile.get("m", DEFAULT_KML))
        l = int(profile.get("l", DEFAULT_KML))
        if k == DEFAULT_KML and m == DEFAULT_KML and l == DEFAULT_KML:
            return
        if DEFAULT_KML in (k, m, l):
            raise ErasureCodeError(
                -22, "all of k, m, l must be set or none of them")
        for key in ("mapping", "layers", "crush-steps"):
            if key in profile:
                raise ErasureCodeError(
                    -22, f"the {key} parameter cannot be set when "
                         f"k, m, l are set")
        if l == 0 or (k + m) % l:
            raise ErasureCodeError(-22, "k + m must be a multiple of l")
        groups = (k + m) // l
        if k % groups:
            raise ErasureCodeError(
                -22, "k must be a multiple of (k + m) / l")
        if m % groups:
            raise ErasureCodeError(
                -22, "m must be a multiple of (k + m) / l")

        mapping = ""
        for _ in range(groups):
            mapping += "D" * (k // groups) + "_" * (m // groups) + "_"
        profile["mapping"] = mapping

        layers = []
        # global layer
        glob = ""
        for _ in range(groups):
            glob += "D" * (k // groups) + "c" * (m // groups) + "_"
        layers.append([glob, ""])
        # local layers
        for i in range(groups):
            local = ""
            for j in range(groups):
                local += ("D" * l + "c") if i == j else "_" * (l + 1)
            layers.append([local, ""])
        profile["layers"] = json.dumps(layers)

        locality = profile.get("crush-locality", "")
        failure_domain = profile.get("crush-failure-domain", "host")
        if locality:
            self.rule_steps = [("choose", locality, groups),
                               ("chooseleaf", failure_domain, l + 1)]
        elif failure_domain:
            self.rule_steps = [("chooseleaf", failure_domain, 0)]

    def layers_parse(self, description: str) -> None:
        try:
            arr = json.loads(description)
        except json.JSONDecodeError as e:
            raise ErasureCodeError(-22, f"layers is not valid JSON: {e}")
        if not isinstance(arr, list):
            raise ErasureCodeError(-22, "layers must be a JSON array")
        for pos, entry in enumerate(arr):
            if not isinstance(entry, list) or not entry:
                raise ErasureCodeError(
                    -22, f"layers[{pos}] must be a non-empty array")
            chunks_map = entry[0]
            if not isinstance(chunks_map, str):
                raise ErasureCodeError(
                    -22, f"layers[{pos}][0] must be a string")
            prof: ErasureCodeProfile = {}
            if len(entry) > 1:
                second = entry[1]
                if isinstance(second, dict):
                    prof = {str(a): str(b) for a, b in second.items()}
                elif isinstance(second, str):
                    if second:
                        for kv in second.split():
                            a, _, b = kv.partition("=")
                            prof[a] = b
                else:
                    raise ErasureCodeError(
                        -22, f"layers[{pos}][1] must be a string or "
                             f"object")
            self.layers.append(Layer(chunks_map, prof))

    def layers_sanity_checks(self, description: str) -> None:
        if not self.layers:
            raise ErasureCodeError(-22, "at least one layer required")
        for layer in self.layers:
            if len(layer.chunks_map) != self.chunk_count_:
                raise ErasureCodeError(
                    -22, f"layer {layer.chunks_map!r} must be "
                         f"{self.chunk_count_} characters long")

    def layers_init(self) -> None:
        from .registry import factory

        for layer in self.layers:
            prof = layer.profile
            prof.setdefault("k", str(len(layer.data)))
            prof.setdefault("m", str(len(layer.coding)))
            prof.setdefault("plugin", "jerasure")
            prof.setdefault("technique", "reed_sol_van")
            if self.engine:
                prof.setdefault("engine", self.engine)
            layer.erasure_code = factory(prof["plugin"], prof,
                                         device=self.device)
        self.device = self.layers[0].erasure_code.device

    # -- geometry -----------------------------------------------------
    def get_chunk_count(self) -> int:
        return self.chunk_count_

    def get_data_chunk_count(self) -> int:
        return self.data_chunk_count_

    def get_chunk_size(self, object_size: int) -> int:
        """Delegates to the first (global) layer
        (ErasureCodeLrc.cc:556)."""
        return self.layers[0].erasure_code.get_chunk_size(object_size)

    # -- minimum_to_decode (the local-repair win) ----------------------
    def _minimum_to_decode(self, want_to_read: Set[int],
                           available: Set[int]) -> Set[int]:
        """ErasureCodeLrc.cc:563-731, three cases."""
        n = self.get_chunk_count()
        erasures_total = {i for i in range(n) if i not in available}
        erasures_not_recovered = set(erasures_total)
        erasures_want = erasures_total & set(want_to_read)

        # Case 1: nothing wanted is missing
        if not erasures_want:
            return set(want_to_read)

        # Case 2: recover wanted erasures with as few chunks as possible
        minimum: Set[int] = set()
        for layer in reversed(self.layers):
            layer_want = set(want_to_read) & layer.chunks_as_set
            if not layer_want:
                continue
            layer_erasures = layer_want & erasures_want
            if not layer_erasures:
                layer_minimum = layer_want
            else:
                erasures = layer.chunks_as_set & erasures_not_recovered
                if len(erasures) > \
                        layer.erasure_code.get_coding_chunk_count():
                    continue  # too many for this layer; try upper
                layer_minimum = layer.chunks_as_set \
                    - erasures_not_recovered
                erasures_not_recovered -= erasures
                erasures_want -= erasures
            minimum |= layer_minimum
        if not erasures_want:
            minimum |= set(want_to_read)
            minimum -= erasures_total
            return minimum

        # Case 3: recover anything recoverable hoping it helps above
        erasures_total = {i for i in range(n) if i not in available}
        for layer in reversed(self.layers):
            layer_erasures = layer.chunks_as_set & erasures_total
            if not layer_erasures:
                continue
            if len(layer_erasures) <= \
                    layer.erasure_code.get_coding_chunk_count():
                erasures_total -= layer_erasures
        if not erasures_total:
            return set(available)

        raise ErasureCodeError(
            -5, f"not enough chunks in {sorted(available)} to read "
                f"{sorted(want_to_read)}")

    # -- data path ----------------------------------------------------
    def encode_chunks(self, want_to_encode: Set[int],
                      chunks: Dict[int, torch.Tensor]) -> None:
        """ErasureCodeLrc.cc:734-768: start from the deepest layer that
        covers everything wanted, then encode every layer above."""
        top = len(self.layers)
        for layer in reversed(self.layers):
            top -= 1
            if set(want_to_encode) <= layer.chunks_as_set:
                break
        for layer in self.layers[top:]:
            layer_chunks = {j: chunks[c]
                            for j, c in enumerate(layer.chunks)}
            layer_want = {j for j, c in enumerate(layer.chunks)
                          if c in want_to_encode}
            layer.erasure_code.encode_chunks(layer_want, layer_chunks)
            for j, c in enumerate(layer.chunks):
                chunks[c] = layer_chunks[j]

    def decode_chunks(self, want_to_read: Set[int],
                      chunks: Dict[int, torch.Tensor],
                      decoded: Dict[int, torch.Tensor]) -> None:
        """ErasureCodeLrc.cc:771-857: each layer's recoveries feed the
        layers above via ``decoded``."""
        n = self.get_chunk_count()
        erasures = {i for i in range(n) if i not in chunks}
        want_err = erasures & set(want_to_read)
        for layer in reversed(self.layers):
            layer_erasures = layer.chunks_as_set & erasures
            if len(layer_erasures) > \
                    layer.erasure_code.get_coding_chunk_count():
                continue  # too many erasures for this layer
            if not layer_erasures:
                continue  # nothing to do here
            layer_chunks = {}
            layer_decoded = {}
            layer_want = set()
            for j, c in enumerate(layer.chunks):
                if c not in erasures:
                    layer_chunks[j] = decoded[c]
                if c in want_to_read:
                    layer_want.add(j)
                layer_decoded[j] = decoded[c]
            layer.erasure_code.decode_chunks(layer_want, layer_chunks,
                                             layer_decoded)
            for j, c in enumerate(layer.chunks):
                decoded[c] = layer_decoded[j]
                erasures.discard(c)
            want_err = erasures & set(want_to_read)
            if not want_err:
                break
        if want_err:
            raise ErasureCodeError(
                -5, f"unable to read {sorted(want_err)}")

    # -- rule generation (ErasureCodeLrc.cc:44-110) --------------------
    def create_rule(self, name: str, crush) -> int:
        root = crush.get_item_id(self.rule_root)
        if self.rule_device_class:
            if not crush.class_exists(self.rule_device_class):
                raise ErasureCodeError(
                    -2, f"no device class {self.rule_device_class!r}")
            cid = crush.get_or_create_class_id(self.rule_device_class)
            crush.populate_classes()
            shadow = crush.class_bucket.get((root, cid))
            if shadow is None:
                raise ErasureCodeError(
                    -22, f"root {self.rule_root} has no "
                         f"{self.rule_device_class} devices")
            root = shadow
        steps = [
            RuleStep(C.CRUSH_RULE_SET_CHOOSELEAF_TRIES, 5, 0),
            RuleStep(C.CRUSH_RULE_SET_CHOOSE_TRIES, 100, 0),
            RuleStep(C.CRUSH_RULE_TAKE, root, 0),
        ]
        for op_name, type_name, nrep in self.rule_steps:
            op = (C.CRUSH_RULE_CHOOSELEAF_INDEP
                  if op_name == "chooseleaf"
                  else C.CRUSH_RULE_CHOOSE_INDEP)
            steps.append(
                RuleStep(op, nrep, crush.get_type_id(type_name)))
        steps.append(RuleStep(C.CRUSH_RULE_EMIT, 0, 0))
        rid = crush.crush.add_rule(Rule(steps=steps, type=3))
        crush.rule_name_map[rid] = name
        return rid


def make_lrc(profile: ErasureCodeProfile, device="cuda") -> ErasureCodeLrc:
    inst = ErasureCodeLrc(device)
    inst.init(profile)
    return inst
