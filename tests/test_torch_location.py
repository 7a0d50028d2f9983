"""The port's ``crush/location.py`` against ``ceph_tpu``'s.

The same location strings parse and format alike, and the same
sequence of ``create_or_move_item`` calls leaves both packages'
``CrushWrapper`` with the same map (``to_dict``), the same return values
and the same errors.
"""

import pytest

from ceph_tpu.crush import location as jloc
from ceph_tpu.crush.wrapper import CrushWrapper as JWrapper

from ceph_tpu_torch.crush import location as ploc
from ceph_tpu_torch.crush.wrapper import CrushWrapper as PWrapper


@pytest.mark.parametrize("spec", [
    "root=default rack=r1 host=node3", "host=a,rack=b", "host=a",
    "  root=default   host=n1 ", "datacenter=dc1,root=default,host=x"])
def test_parse_and_format_equal(spec):
    got, want = ploc.parse_loc(spec), jloc.parse_loc(spec)
    assert got == want and list(got) == list(want)
    assert ploc.format_loc(got) == jloc.format_loc(want)


@pytest.mark.parametrize("spec", ["hostnoequals", "host=", "=x",
                                  "root=default bad"])
def test_bad_tokens_raise_alike(spec):
    with pytest.raises(ValueError) as got:
        ploc.parse_loc(spec)
    with pytest.raises(ValueError) as want:
        jloc.parse_loc(spec)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("host,root", [("n1", "default"), ("h7", "ssd")])
def test_default_location_equal(host, root):
    assert ploc.default_location(host, root) == \
        jloc.default_location(host, root)


# (item, weight, location) calls, in order: inserts, no-op calls (one
# with an extra level that does not exist), moves across hosts and
# racks, a move back
MOVES = [
    (0, 0x20000, "root=default host=h1"),
    (1, 0x10000, "root=default host=h1"),
    (2, 0x18000, "root=default rack=r1 host=h2"),
    (0, 0x20000, "root=default host=h1"),
    (0, 0x10000, "root=default rack=rX host=h1"),
    (0, 0x99999, "root=default host=h2"),
    (1, 0x10000, "root=default rack=r2 host=h3"),
    (2, 0x30000, "root=default rack=r2 host=h3"),
    (0, 0x10000, "root=default host=h1"),
]


@pytest.mark.parametrize("with_class", [False, True])
def test_create_or_move_sequence_equal(with_class):
    jw, pw = JWrapper(), PWrapper()
    for step, (item, weight, spec) in enumerate(MOVES):
        got = ploc.create_or_move_item(pw, item, weight, f"osd.{item}",
                                       ploc.parse_loc(spec))
        want = jloc.create_or_move_item(jw, item, weight, f"osd.{item}",
                                        jloc.parse_loc(spec))
        assert got == want, step
        if with_class and step == 1:
            pw.set_item_class(0, "ssd")
            jw.set_item_class(0, "ssd")
        assert pw.to_dict() == jw.to_dict(), step
    assert pw.get_item_weight(0) == jw.get_item_weight(0) == 0x20000
    if with_class:
        assert pw.get_item_class(0) == "ssd"


def test_empty_location_raises_alike():
    jw, pw = JWrapper(), PWrapper()
    ploc.create_or_move_item(pw, 0, 0x10000, "osd.0", {"host": "h"})
    jloc.create_or_move_item(jw, 0, 0x10000, "osd.0", {"host": "h"})
    with pytest.raises(ValueError, match="empty crush location"):
        ploc.create_or_move_item(pw, 0, 0x10000, "osd.0", {})
    with pytest.raises(ValueError, match="empty crush location"):
        jloc.create_or_move_item(jw, 0, 0x10000, "osd.0", {})
