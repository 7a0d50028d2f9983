"""The port's ``CrushWrapper`` and bucket edit primitives against
``ceph_tpu``'s.

The same edit sequences run on both wrappers and must leave equal
``to_dict()`` after every step: inserts, moves, swaps, removes,
reweights, renames, device classes with their shadow trees, and simple
rules.  ``try_remap_rule`` must give the same mapping on the small
cases of tests/test_wrapper.py and on the 2,000-trial randomized
differential of tests/test_balancer.py on ``map_big10k``.  Everything
compared is an integer, a name or an id: tolerance zero.
"""

import json
import random

import pytest

from conftest import GOLDEN_DIR

from ceph_tpu.crush import builder as jbuilder
from ceph_tpu.crush import constants as C
from ceph_tpu.crush.map import CrushMap as JCrushMap
from ceph_tpu.crush.mapper_ref import crush_do_rule as jdo_rule
from ceph_tpu.crush.wrapper import CrushWrapper as JWrapper

from ceph_tpu_torch.crush import builder as pbuilder
from ceph_tpu_torch.crush.map import CrushMap as PCrushMap
from ceph_tpu_torch.crush.wrapper import CrushWrapper as PWrapper


def both(fn):
    """``fn(Wrapper)`` on each package's wrapper class."""
    return fn(JWrapper), fn(PWrapper)


def build_cluster(W, hosts=4, osds_per_host=2, racks=1):
    w = W()
    dev = 0
    for h in range(hosts):
        for _ in range(osds_per_host):
            w.insert_item(dev, 0x10000 * (1 + dev % 3), f"osd.{dev}",
                          {"host": f"host{h}", "rack": f"rack{h % racks}",
                           "root": "default"})
            dev += 1
    return w


def same(jw, pw):
    assert jw.to_dict() == pw.to_dict()


# each step takes a wrapper and edits it the same way on both packages
EDITS = {
    "insert_new_chain": lambda w: w.insert_item(
        50, 0x18000, "osd.50", {"host": "hostx", "rack": "rack9",
                                "root": "default"}),
    "insert_other_root": lambda w: w.insert_item(
        51, 0x10000, "osd.51", {"host": "hosty", "root": "other"}),
    "adjust_weight": lambda w: w.adjust_item_weight(3, 0x30000),
    "remove_item": lambda w: w.remove_item(5),
    "move_bucket": lambda w: w.move_bucket(w.get_item_id("host1"),
                                           {"rack": "rack1",
                                            "root": "default"}),
    "swap_bucket": lambda w: w.swap_bucket(w.get_item_id("host0"),
                                           w.get_item_id("host2")),
    "rename": lambda w: w.rename_item("host3", "hostD"),
    "reweight": lambda w: (w.get_bucket(w.get_item_id("host0"))
                           .item_weights.__setitem__(0, 0x50000),
                           w.reweight()),
}


@pytest.mark.parametrize("step", sorted(EDITS))
def test_edit_step_equal(step):
    """One edit on a two-rack cluster: equal maps and names after it."""
    jw, pw = both(lambda W: build_cluster(W, hosts=4, racks=2))
    same(jw, pw)
    EDITS[step](jw)
    EDITS[step](pw)
    same(jw, pw)


def test_edit_sequence_with_classes_and_rules():
    """Every edit in turn, with device classes and class rules, both
    wrappers after each step, then ``do_rule`` on every rule."""
    def start(W):
        w = build_cluster(W, hosts=6, osds_per_host=3, racks=3)
        EDITS["insert_new_chain"](w)
        EDITS["insert_other_root"](w)
        for d in list(range(18)) + [50, 51]:
            w.set_item_class(d, ("ssd", "hdd", "nvme")[d % 3])
        w.add_simple_rule("any", "default", "host", "", "firstn")
        w.add_simple_rule("ssd", "default", "host", "ssd", "firstn")
        w.add_simple_rule("hdd-ec", "default", "rack", "hdd", "indep",
                          rule_type=3)
        w.add_simple_rule("nvme-osd", "default", "", "nvme", "firstn")
        return w

    jw, pw = both(start)
    same(jw, pw)
    for step in ("adjust_weight", "remove_item", "move_bucket",
                 "swap_bucket", "rename", "reweight"):
        EDITS[step](jw)
        EDITS[step](pw)
        same(jw, pw)
    jw.populate_classes()
    pw.populate_classes()
    same(jw, pw)
    weight = [0x10000] * 52
    for rule in sorted(jw.crush.rules):
        for x in range(64):
            assert jw.do_rule(rule, x, 3, weight) == \
                pw.do_rule(rule, x, 3, weight)


def outcome(fn):
    """fn()'s result, or the type of the exception it raised."""
    try:
        return fn()
    except (ValueError, KeyError, IndexError) as e:
        return type(e)


def test_insert_after_classes_same_outcome():
    """A new bucket allocated after the shadow trees were built takes an
    index that the shadow-id registry holds, so the next shadow rebuild
    meets a duplicate id: ``ceph_tpu`` raises there, and so must the
    port."""
    def run(W):
        w = build_cluster(W, hosts=4, osds_per_host=2)
        for d in range(8):
            w.set_item_class(d, "ssd" if d % 2 else "hdd")
        w.add_simple_rule("ssd", "default", "host", "ssd", "firstn")
        w.insert_item(9, 0x10000, "osd.9", {"host": "hostn",
                                            "root": "default"})
        return outcome(lambda: w.to_dict())

    j, p = both(run)
    assert j == p


def test_shadow_ids_stable_across_rebuilds():
    """Shadow buckets keep their registry ids through topology edits,
    as K2's arrays and the class rules need."""
    def run(W):
        w = build_cluster(W, hosts=4, osds_per_host=2)
        for d in range(8):
            w.set_item_class(d, "ssd" if d % 2 == 0 else "hdd")
        rid = w.add_simple_rule("ssdr", "default", "host", "ssd",
                                "firstn")
        before = dict(w.class_bucket)
        w.adjust_item_weight(0, 0x80000)
        w.remove_item(2)
        res = [w.do_rule(rid, x, 3, [0x10000] * 8) for x in range(32)]
        return before, dict(w.class_bucket), res, w.to_dict()

    j, p = both(run)
    assert j == p
    assert j[0] == j[1]


def test_jax_wrapper_dict_loads_into_the_port():
    jw = build_cluster(JWrapper, hosts=4, racks=2)
    for d in range(8):
        jw.set_item_class(d, "ssd" if d % 2 else "hdd")
    jw.add_simple_rule("r", "default", "host", "ssd", "firstn")
    from ceph_tpu.crush.map import ChooseArg, ChooseArgMap
    cam = ChooseArgMap()
    cam[0] = ChooseArg(ids=None, weight_set=[[0x8000, 0x10000]])
    jw.crush.choose_args[1] = cam
    d = jw.to_dict()
    pw = PWrapper.from_dict(json.loads(json.dumps(d)))
    assert pw.to_dict() == d
    assert pw.class_bucket == jw.class_bucket
    assert pw.crush.choose_args[1][0].weight_set == [[0x8000, 0x10000]]
    back = JWrapper.from_dict(json.loads(json.dumps(pw.to_dict())))
    assert back.to_dict() == d


ALGS = ("uniform", "list", "tree", "straw", "straw2")


def make_bucket(B, alg):
    items, weights = [0, 1, 2, 3, 4], [0x10000, 0x20000, 0x8000, 0x10000,
                                       0x30000]
    if alg == "uniform":
        return B.make_uniform_bucket(items, 0x10000, 1, bid=-1)
    if alg == "straw" and B is jbuilder:   # ceph_tpu has no straw maker
        from ceph_tpu.crush.map import Bucket
        return Bucket(id=-1, alg=C.CRUSH_BUCKET_STRAW, type=1, items=items,
                      item_weights=list(weights),
                      straws=jbuilder.calc_straw(weights),
                      weight=sum(weights))
    return getattr(B, f"make_{alg}_bucket")(items, weights, 1, bid=-1)


@pytest.mark.parametrize("alg", ALGS)
def test_bucket_edit_primitives(alg):
    """add, adjust and remove on every bucket algorithm rebuild the same
    payload (list sums, straw lengths) in both packages, or fail alike
    (a tree bucket keeps no item_weights for the edits to index)."""
    jb, pb = make_bucket(jbuilder, alg), make_bucket(pbuilder, alg)
    assert jb.to_dict() == pb.to_dict()
    w = 0x10000 if alg == "uniform" else 0x28000
    w2 = 0x10000 if alg == "uniform" else 0x48000
    results = []
    for B, b in ((jbuilder, jb), (pbuilder, pb)):
        results.append((outcome(lambda: B.bucket_add_item(b, 7, w)),
                        outcome(lambda: B.bucket_adjust_item_weight(
                            b, 2, w2)),
                        outcome(lambda: B.bucket_remove_item(b, 1)),
                        b.to_dict(),
                        [outcome(lambda: b.item_weight_at(i))
                         for i in range(-1, 7)]))
    assert results[0] == results[1]


def test_reweight_bucket_recursive():
    def run(B, Map):
        cmap = Map()
        hosts = [cmap.add_bucket(B.make_tree_bucket(
            [2 * h, 2 * h + 1], [0x10000, 0x20000], 1)) for h in range(3)]
        root = B.make_list_bucket(hosts, [1, 1, 1], 3)
        cmap.add_bucket(root)
        cmap.buckets[0].node_weights[1] = 0x70000  # stale inner weight
        B.reweight_bucket(cmap, root)
        return cmap.to_dict()

    assert run(jbuilder, JCrushMap) == run(pbuilder, PCrushMap)


# -- try_remap_rule -------------------------------------------------------

REMAP_CASES = [
    # (overfull, underfull, more_underfull, orig): tests/test_wrapper.py
    ({0}, [6], [], [0, 2, 4]),
    ({0}, [1], [], [0, 2, 4]),
    ({0}, [2, 6], [], [0, 2, 4]),
    ({0}, [], [], [0, 2, 4]),
    ({0}, [], [1], [0, 2, 4]),
    ({0}, [], [6], [0, 2, 4]),
    ({0, 2}, [6, 7, 1], [3], [0, 2, 4]),
]


@pytest.mark.parametrize("case", range(len(REMAP_CASES)))
def test_try_remap_rule_small(case):
    over, under, more, orig = REMAP_CASES[case]

    def run(W):
        w = W()
        for d in range(8):
            w.insert_item(d, 0x10000, f"osd.{d}",
                          {"host": f"host{d // 2}", "root": "default"})
        rid = w.add_simple_rule("r", "default", "host", "", "firstn")
        return w.try_remap_rule(rid, 3, set(over), list(under),
                                list(more), list(orig))

    j, p = both(run)
    assert j == p


def test_try_remap_rule_collision_case():
    """size == hosts: the only underfull candidate collides with a
    retained member's host (tests/test_balancer.py)."""
    def run(W):
        w = W()
        for d in range(6):
            w.insert_item(d, 0x10000, f"osd.{d}",
                          {"host": f"host{d // 2}", "root": "default"})
        rid = w.add_simple_rule("repl", "default", "host", "", "firstn")
        return (w.try_remap_rule(rid, 3, {0}, [3], [], [0, 2, 4]),
                w.try_remap_rule(rid, 3, {0}, [1], [], [0, 2, 4]))

    j, p = both(run)
    assert j == p == ([0, 2, 4], [1, 2, 4])


def test_try_remap_rule_randomized_big10k():
    """The 2,000-trial randomized differential of tests/test_balancer.py
    on ``map_big10k``: the same orig, overfull and underfull sets into
    both wrappers give the same mapping, and it exercises remaps."""
    with open(GOLDEN_DIR / "map_big10k.json") as f:
        d = json.load(f)
    jmap = JCrushMap.from_dict(d["map"])
    jw, pw = JWrapper(jmap), PWrapper(PCrushMap.from_dict(d["map"]))
    case = d["cases"][0]
    ruleno, numrep = case["ruleno"], case["numrep"]
    weights = [0x10000] * jmap.max_devices
    rng = random.Random(1234)

    def host_of(osd):
        return jw.get_parent_of_type(osd, 1, ruleno)

    checked = remapped = 0
    for trial in range(2000):
        x = rng.randrange(1 << 30)
        orig = jdo_rule(jmap, ruleno, x, numrep, weights)
        if len(orig) < numrep:
            continue
        overfull = set(rng.sample(orig, rng.randint(1, len(orig))))
        used_hosts = {host_of(o) for o in orig}
        underfull = []
        while len(underfull) < 8:
            cand = rng.randrange(jmap.max_devices)
            if cand not in orig and host_of(cand) not in used_hosts:
                underfull.append(cand)
        want = jw.try_remap_rule(ruleno, numrep, overfull, underfull, [],
                                 list(orig))
        got = pw.try_remap_rule(ruleno, numrep, overfull, underfull, [],
                                list(orig))
        assert got == want, (trial, orig, got, want)
        checked += 1
        remapped += sum(a != b for a, b in zip(orig, want))
    assert checked >= 1900 and remapped >= 1000, (checked, remapped)


def test_get_parent_of_type_and_leaves():
    jw, pw = both(lambda W: build_cluster(W, hosts=6, racks=3))
    for w in (jw, pw):
        w.add_simple_rule("r", "default", "host", "", "firstn")
    root = jw.get_item_id("default")
    assert jw.get_leaves(root) == pw.get_leaves(root)
    for t in (1, 2, 3):
        assert jw.get_children_of_type(root, t) == \
            pw.get_children_of_type(root, t)
        for osd in range(12):
            assert jw.get_parent_of_type(osd, t) == \
                pw.get_parent_of_type(osd, t)
            assert jw.get_parent_of_type(osd, t, 0) == \
                pw.get_parent_of_type(osd, t, 0)
