"""CrushLocation: where a daemon lives in the hierarchy.

The port's copy of ``ceph_tpu/crush/location.py``, on the port's
``CrushWrapper`` (the role of src/crush/CrushLocation.cc): each OSD
declares its position as ``type=name`` pairs ("root=default rack=r1
host=node3"), from the ``crush_location`` config option; on boot the
map is updated with create-or-move semantics (``ceph osd crush
create-or-move``), so daemons land in the right failure domain.
"""

from __future__ import annotations

from typing import Dict

from .wrapper import CrushWrapper


def parse_loc(spec: str) -> Dict[str, str]:
    """'root=default host=node1' -> {'root': 'default', ...}
    (CrushLocation::update_from_conf parsing; '=' required)."""
    out: Dict[str, str] = {}
    for token in spec.replace(",", " ").split():
        key, sep, value = token.partition("=")
        if not sep or not key or not value:
            raise ValueError(f"bad crush location token {token!r}")
        out[key] = value
    return out


def format_loc(loc: Dict[str, str]) -> str:
    return " ".join(f"{k}={v}" for k, v in sorted(loc.items()))


def default_location(hostname: str,
                     root: str = "default") -> Dict[str, str]:
    """The reference's fallback: host=<hostname> root=default."""
    return {"host": hostname, "root": root}


def _lowest_existing(wrapper: CrushWrapper,
                     loc: Dict[str, str]):
    """The id of loc's lowest bucket if it already exists — a PURE
    lookup (no bucket creation/linking side effects)."""
    order = sorted((wrapper.get_type_id(t), n) for t, n in loc.items())
    if not order:
        raise ValueError("empty crush location")
    _tid, name = order[0]
    return wrapper.get_item_id(name) if wrapper.name_exists(name) \
        else None


def create_or_move_item(wrapper: CrushWrapper, item: int, weight: int,
                        name: str, loc: Dict[str, str]) -> bool:
    """`ceph osd crush create-or-move` semantics: insert when absent,
    relocate (keeping the existing weight AND device class) when the
    direct parent differs.  Returns True when the map changed; a
    no-move call leaves the map untouched (no speculative bucket
    creation)."""
    if not wrapper.name_map.get(item):
        wrapper.insert_item(item, weight, name, loc)
        return True
    parent = wrapper.get_immediate_parent_id(item)
    if parent is not None and \
            parent == _lowest_existing(wrapper, loc):
        return False
    cur_weight = wrapper.get_item_weight(item)
    cur_class = wrapper.get_item_class(item)
    wrapper.remove_item(item)
    wrapper.insert_item(item, cur_weight, name, loc)
    if cur_class is not None:  # remove_item pops the class; restore
        wrapper.set_item_class(item, cur_class)
    return True
