"""The rule-shape map: rule shapes that no golden map has, for holding
the rule walk's engines to each other.

``rule_shapes.txt`` is a crushtool text map of 24 OSDs in every bucket
algorithm, with 13 rules: the set steps of ops 8-13, several take/emit
steps, numrep beyond the hierarchy, and takes of a device, of an empty
bucket and of a missing one.  The text compiler takes only buckets it
knows, so the bucket ``spare`` is removed after compiling: rule 11 then
takes a missing bucket.
"""

from __future__ import annotations

import pathlib

import numpy as np

from ..crush.map import CrushMap, Tunables

TEXT = pathlib.Path(__file__).with_name("rule_shapes.txt")

# (rule, numrep) of every rule; rule 2 also at 10, past the 8 hosts
CASES = ((0, 3), (1, 4), (2, 3), (2, 10), (3, 5), (4, 3), (5, 4), (6, 6),
         (7, 5), (8, 5), (9, 2), (10, 4), (11, 3), (12, 3))

# the text's own (optimal) tunables, the legacy ones, and two local
# retries with one local fallback try
TUNABLES = {"optimal": None, "legacy": Tunables.legacy(),
            "local": Tunables(2, 1, 19, 0, 0, 0)}


def text() -> str:
    return TEXT.read_text()


def remove_spare(w):
    """Remove the bucket ``spare`` from a compiled ``CrushWrapper`` (of
    this package or of one with the same interface), in place; returns
    ``w``."""
    del w.crush.buckets[-1 - w.get_item_id("spare")]
    return w


def rule_shapes_map(tunables: str = "optimal") -> CrushMap:
    """The map compiled by this package's compiler, ``spare`` removed,
    under the named profile of ``TUNABLES``."""
    from .compiler import compile_crushmap

    cmap = remove_spare(compile_crushmap(text())).crush
    if TUNABLES[tunables] is not None:
        cmap.tunables = TUNABLES[tunables]
    return cmap


def weights(n_devices: int) -> np.ndarray:
    """16.16 device weights with osd.5 and osd.17 out and osd.10 at
    half."""
    w = np.full(n_devices, 0x10000, np.uint32)
    w[[5, 17]] = 0
    w[10] = 0x8000
    return w
