"""Synthetic cluster maps for offline balancer runs.

The port's copy of ``ceph_tpu/mgr/synthetic.py`` (the osdmaptool
``--createsimple``/``--test-map-pgs`` role, src/tools/osdmaptool.cc:330):
an N-OSD host/rack/root hierarchy with seeded uneven device weights
(heterogeneous capacities are what the balancer exists to even out),
optionally split into device classes with a rule and pool per class
(shadow trees), and optionally a compat ``choose_args`` weight set.
The same seed gives the same map as ``ceph_tpu``'s.
"""

from __future__ import annotations

import random
from typing import Dict, List, Optional, Tuple

from ..crush.wrapper import CrushWrapper
from ..osdmap.balancer import weight_set_to_choose_args
from ..osdmap.osdmap import OSDMap, PgPool

# heterogeneous capacity mix: 1x / 2x / 4x TiB-class devices
_WEIGHT_STEPS = (0x10000, 0x20000, 0x40000)


def make_synthetic_map(n_osds: int = 1000, osds_per_host: int = 4,
                       hosts_per_rack: int = 10, pg_num: int = 2048,
                       size: int = 3, seed: int = 0,
                       uneven: bool = True,
                       device_classes: Optional[List[str]] = None,
                       failure_domain: str = "host",
                       with_choose_args: bool = False
                       ) -> Tuple[OSDMap, CrushWrapper, Dict[str, int]]:
    """Build (OSDMap, CrushWrapper, {rule_name: ruleno}).

    One pool per rule: pool 1 on the plain ``failure_domain`` rule;
    with ``device_classes`` (e.g. ``["ssd", "hdd"]``) devices
    alternate classes round-robin and each class gets its own rule and
    pool (pg_num / 4, at least 8).  ``with_choose_args`` installs a
    compat weight set equal to the real weights."""
    rng = random.Random(seed)
    w = CrushWrapper()
    weights: List[int] = []
    for dev in range(n_osds):
        host = dev // osds_per_host
        rack = host // hosts_per_rack
        wt = rng.choice(_WEIGHT_STEPS) if uneven else 0x10000
        weights.append(wt)
        w.insert_item(dev, wt, f"osd.{dev}",
                      {"host": f"host{host}", "rack": f"rack{rack}",
                       "root": "default"})
        if device_classes:
            w.set_item_class(dev,
                             device_classes[dev % len(device_classes)])
    rules: Dict[str, int] = {}
    rules["repl"] = w.add_simple_rule("repl", "default",
                                      failure_domain, "", "firstn")
    if device_classes:
        for cls in device_classes:
            rules[f"repl-{cls}"] = w.add_simple_rule(
                f"repl-{cls}", "default", failure_domain, cls,
                "firstn")

    m = OSDMap(w.crush)
    for dev in range(n_osds):
        m.add_osd(dev)
    m.pools[1] = PgPool(size=size, pg_num=pg_num,
                        crush_rule=rules["repl"])
    if device_classes:
        pid = 2
        for cls in device_classes:
            m.pools[pid] = PgPool(size=size,
                                  pg_num=max(8, pg_num // 4),
                                  crush_rule=rules[f"repl-{cls}"])
            pid += 1
    if with_choose_args:
        ws = {dev: weights[dev] / 0x10000 for dev in range(n_osds)}
        m.crush.choose_args["compat"] = weight_set_to_choose_args(
            w, ws)
    return m, w, rules
