"""The port's crush map compiler against ``ceph_tpu``'s.

``decompile_crushmap`` must give byte-equal text for the same map, and
``compile_crushmap`` of the same text must give wrappers with equal
``to_dict()``: on all nine golden maps (named as an operator would name
them), on the maps ``crushtool --build`` makes, on a map with device
classes (class takes resolve to the same shadow ids, pinned ``id ...
class ...`` lines are honoured) and on the rule-shape map of
``ceph_tpu_torch/tools/rule_shapes.txt``.  Bad text raises the same error
with the same line number.
"""

import json

import pytest

from conftest import GOLDEN_DIR

from ceph_tpu.crush.map import CrushMap as JCrushMap
from ceph_tpu.crush.wrapper import CrushWrapper as JWrapper
from ceph_tpu.tools import compiler as jcomp
from ceph_tpu.tools import crushtool as jtool

from ceph_tpu_torch.crush.map import CrushMap as PCrushMap
from ceph_tpu_torch.crush.wrapper import CrushWrapper as PWrapper
from ceph_tpu_torch.tools import compiler as pcomp
from ceph_tpu_torch.tools import crushtool as ptool
from ceph_tpu_torch.tools import rule_shapes

GOLDEN_MAPS = ("map_big10k", "map_flat12", "map_tree3", "map_weird",
               "map_list", "map_straw", "map_uniform",
               "map_tree3_chooseargs", "map_tree3_legacy")

CLASS_SAMPLE = """\
# begin crush map
tunable choose_local_tries 0
tunable choose_local_fallback_tries 0
tunable choose_total_tries 50
tunable chooseleaf_descend_once 1
tunable chooseleaf_vary_r 1
tunable chooseleaf_stable 1
tunable straw_calc_version 1

# devices
device 0 osd.0 class ssd
device 1 osd.1 class ssd
device 2 osd.2 class hdd
device 3 osd.3 class hdd
device 4 osd.4 class nvme
device 6 osd.6

# types
type 0 osd
type 1 host
type 2 root

# buckets
host host0 {
\tid -1
\tid -10 class ssd
\talg straw2
\thash 0
\titem osd.0 weight 1.000
\titem osd.2 weight 1.000
\titem osd.4 weight 0.500
}
host host1 {
\tid -2
\talg straw2
\thash 0
\titem osd.1 weight 2.000
\titem osd.3 weight 1.000 pos 1
\titem osd.6
}
root default {
\tid -3
\tid -20 class hdd
\t# weight 5.500
\talg straw2
\thash 0
\titem host0 weight 2.500
\titem host1 weight 4.000
}

# rules
rule replicated_rule {
\tid 0
\ttype replicated
\tmin_size 1
\tmax_size 10
\tstep take default
\tstep chooseleaf firstn 0 type host
\tstep emit
}
rule ssd_rule {
\tid 1
\ttype replicated
\tstep take default class ssd
\tstep chooseleaf firstn 0 type host
\tstep emit
}
rule hdd_ec {
\tid 4
\ttype erasure
\tstep set_chooseleaf_tries 5
\tstep set_choose_tries 100
\tstep take default class hdd
\tstep chooseleaf indep 0 type osd
\tstep emit
}
rule nvme_host0 {
\tid 2
\ttype 5
\tstep take host0 class nvme
\tstep choose firstn 1 type osd
\tstep emit
}
# end crush map
"""


def named(pkg, name):
    """Golden map ``name`` in a CrushWrapper of package ``pkg`` ("j" or
    "p"), its devices named osd.N and its buckets <type><index>."""
    with open(GOLDEN_DIR / f"{name}.json") as f:
        d = json.load(f)["map"]
    cmap = (JCrushMap if pkg == "j" else PCrushMap).from_dict(d)
    w = (JWrapper if pkg == "j" else PWrapper)(cmap)
    for dev in range(cmap.max_devices):
        w.set_item_name(dev, f"osd.{dev}")
    for i, b in sorted(cmap.buckets.items()):
        w.set_item_name(b.id, f"{w.get_type_name(b.type)}{i}")
    return w


def assert_same_compile(text):
    got, want = pcomp.compile_crushmap(text), jcomp.compile_crushmap(text)
    assert got.to_dict() == want.to_dict()
    out = pcomp.decompile_crushmap(got)
    assert out == jcomp.decompile_crushmap(want)
    return got, out


@pytest.mark.parametrize("name", GOLDEN_MAPS)
def test_golden_map_text_equal(name):
    pw, jw = named("p", name), named("j", name)
    text = pcomp.decompile_crushmap(pw)
    assert text == jcomp.decompile_crushmap(jw)
    got, again = assert_same_compile(text)
    assert again == text
    assert sorted(got.crush.rules) == sorted(pw.crush.rules)
    for rno, rule in pw.crush.rules.items():
        assert [(s.op, s.arg1, s.arg2) for s in rule.steps] == \
            [(s.op, s.arg1, s.arg2) for s in got.crush.rules[rno].steps]


BUILD_SPECS = [
    (12, ["host", "straw2", "4", "root", "straw2", "0"]),
    (30, ["host", "straw2", "4", "rack", "straw2", "3", "root", "straw2",
          "0"]),
    (7, ["host", "straw2", "2", "root", "straw2", "0"]),
    (5, ["root", "straw2", "0"]),
    (64, ["host", "straw2", "8", "rack", "straw2", "4", "row", "straw2",
          "2", "root", "straw2", "0"]),
]


@pytest.mark.parametrize("num_osds,layers", BUILD_SPECS,
                         ids=[f"{n}-{len(l) // 3}" for n, l in BUILD_SPECS])
@pytest.mark.parametrize("with_rule", [False, True])
def test_build_map_text_equal(tmp_path, num_osds, layers, with_rule):
    files = {}
    for tag, tool in (("j", jtool), ("p", ptool)):
        out = tmp_path / f"{tag}.json"
        assert tool.main(["--build", "--num-osds", str(num_osds), "-o",
                          str(out)] + layers) == 0
        if with_rule:
            leaf = layers[0] if len(layers) > 3 else "osd"
            assert tool.main(["-i", str(out), "--create-replicated-rule",
                              "replicated_rule", layers[-3], leaf]) == 0
        files[tag] = out
    assert json.loads(files["j"].read_text()) == \
        json.loads(files["p"].read_text())
    pw = ptool.load_map(str(files["p"]))
    text = pcomp.decompile_crushmap(pw)
    assert text == jcomp.decompile_crushmap(jtool.load_map(str(files["j"])))
    try:
        jcomp.compile_crushmap(text)
    except jcomp.CompileError:
        # --build fills its last host with devices it does not name:
        # neither compiler reads such text back
        assert_same_error(text)
    else:
        assert assert_same_compile(text)[1] == text


def test_class_takes_resolve_to_the_same_shadow_ids():
    got, text = assert_same_compile(CLASS_SAMPLE)
    root, host0 = got.get_item_id("default"), got.get_item_id("host0")
    want = {1: ("ssd", root), 4: ("hdd", root), 2: ("nvme", host0)}
    for rno, (cls, orig) in want.items():
        shadow = got.class_bucket[(orig, got.get_or_create_class_id(cls))]
        takes = [s.arg1 for s in got.crush.rules[rno].steps if s.op == 1]
        assert takes == [shadow]
    # the pinned ids
    assert got.class_bucket[(host0, got.get_or_create_class_id("ssd"))] \
        == -10
    assert got.class_bucket[(root, got.get_or_create_class_id("hdd"))] \
        == -20
    # a second round trip keeps the text
    assert assert_same_compile(text)[1] == text


def test_rule_shapes_map_text_equal():
    got, text = assert_same_compile(rule_shapes.text())
    assert len(got.crush.rules) == 13
    assert assert_same_compile(text)[1] == text


BAD_TEXTS = [
    "nonsense line\n",
    "tunable bogus_knob 1\n",
    "tunable choose_total_tries\n",
    "tunable choose_total_tries x\n",
    "device 0\n",
    "type 0\n",
    "type 0 osd\nhost h {\n\titem osd.9 weight 1.0\n}\n",
    "type 0 osd\ntype 1 host\nhost h {\n\tid -1\n",
    "type 0 osd\nwidget h {\n}\n",
    "type 0 osd\ntype 1 host\nhost h {\n\tid -1\n\talg bogus\n}\n",
    "type 0 osd\ntype 1 host\nhost h {\n\tid -1\n\tbar 1\n}\n",
    "device 0 osd.0\ndevice 1 osd.1\ntype 0 osd\ntype 1 host\n"
    "host h {\n\tid -1\n\talg uniform\n\titem osd.0 weight 1.0\n"
    "\titem osd.1 weight 2.0\n}\n",
    "type 0 osd\nrule r {\n\tid 0\n\tfoo\n}\n",
    "type 0 osd\nrule r {\n\tid 0\n\tstep bogus\n}\n",
    "type 0 osd\nrule r {\n\tid 0\n\tstep choose sideways 1 type osd\n}\n",
    "type 0 osd\nrule r {\n\tid 0\n\tstep choose firstn 1 kind osd\n}\n",
    "type 0 osd\nrule r {\n\tid 0\n\tstep choose firstn 1 type rack\n}\n",
    "type 0 osd\nrule r {\n\tid 0\n\tstep emit\n",
    "type 0 osd\ntype 1 root\nroot d {\n\tid -1\n}\nrule r {\n\tid 0\n"
    "\tstep take nowhere\n\tstep emit\n}\n",
    "device 0 osd.0 class ssd\ntype 0 osd\ntype 1 root\nroot d {\n"
    "\tid -1\n\titem osd.0 weight 1.0\n}\nrule r {\n\tid 0\n"
    "\tstep take d class hdd\n\tstep emit\n}\n",
]


def assert_same_error(text):
    with pytest.raises(Exception) as got:
        pcomp.compile_crushmap(text)
    with pytest.raises(Exception) as want:
        jcomp.compile_crushmap(text)
    assert type(got.value).__name__ == type(want.value).__name__
    assert str(got.value) == str(want.value)
    assert getattr(got.value, "lineno", None) == \
        getattr(want.value, "lineno", None)


@pytest.mark.parametrize("text", BAD_TEXTS)
def test_bad_text_raises_alike(text):
    assert_same_error(text)


def test_compile_error_is_a_value_error_with_its_line():
    with pytest.raises(pcomp.CompileError) as e:
        pcomp.compile_crushmap("type 0 osd\n\n# c\nbogus {\n}\n")
    assert isinstance(e.value, ValueError)
    assert e.value.lineno == 4 and str(e.value).startswith("line 4: ")
