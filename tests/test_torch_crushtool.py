"""The port's ``crushtool`` against ``ceph_tpu``'s, verb by verb.

On the same arguments both tools must write the same files, print the
same text and return the same exit code: ``-c``/``-d``/``-o``,
``--build``, ``--create-replicated-rule`` (with ``--device-class``),
``--reweight``, ``--tree``, ``--test`` with its flags, ``--compare``,
and the errors (a map without rules, ``--build`` without
``--num-osds``).  Where text holds mappings, ``ceph_tpu``'s tool runs
``--scalar`` (its batched and native engines print numpy ints); the
port's runs on the CPU with ``--device cpu``, ``--native`` and
``--scalar``.  Without a card the port's ``--test`` fails unless one of
those is given.
"""

import json

import pytest
import torch

from conftest import GOLDEN_DIR

from ceph_tpu.crush.map import CrushMap as JCrushMap
from ceph_tpu.crush.wrapper import CrushWrapper as JWrapper
from ceph_tpu.tools import crushtool as jtool

from ceph_tpu_torch.tools import crushtool as ptool
from ceph_tpu_torch.tools import rule_shapes
from test_torch_ref_native import ref_native_built  # noqa: F401  (autouse)

PORT_ENGINES = {"cpu": ["--device", "cpu"], "native": ["--native"],
                "scalar": ["--scalar"]}


def run(tool, args, capfd):
    """(exit code, stdout, stderr) of one call; an exception that
    escapes ``main`` (as it would end the process) gives its type's name
    and message in place of the exit code."""
    try:
        rc = tool.main([str(a) for a in args])
    except Exception as e:  # compared between the two tools
        rc = (type(e).__name__, str(e))
    out = capfd.readouterr()
    return rc, out.out, out.err


def both(args_of, capfd, port_extra=(), ref_extra=()):
    """Run ``args_of(tag)`` through both tools; returns the two results
    (rc, stdout, stderr)."""
    j = run(jtool, args_of("j") + list(ref_extra), capfd)
    p = run(ptool, args_of("p") + list(port_extra), capfd)
    return j, p


@pytest.fixture
def maps(tmp_path):
    """Map files both tools read: the rule-shape text map, its compiled
    JSON, and map_flat12 as a named CrushWrapper JSON."""
    text = tmp_path / "shapes.txt"
    text.write_text(rule_shapes.text())
    with open(GOLDEN_DIR / "map_flat12.json") as f:
        w = JWrapper(JCrushMap.from_dict(json.load(f)["map"]))
    for d in range(w.crush.max_devices):
        w.set_item_name(d, f"osd.{d}")
    for i, b in sorted(w.crush.buckets.items()):
        w.set_item_name(b.id, f"host{i}")
    flat = tmp_path / "flat12.json"
    flat.write_text(json.dumps(w.to_dict()))
    return {"text": text, "flat": flat}


def test_compile_and_decompile(maps, tmp_path, capfd):
    j, p = both(lambda t: ["-c", maps["text"], "-o", tmp_path / f"{t}.json"],
                capfd)
    assert j == p == (0, "", "")
    assert json.loads((tmp_path / "j.json").read_text()) == \
        json.loads((tmp_path / "p.json").read_text())
    # to stdout, and to a file
    j, p = both(lambda t: ["-d", tmp_path / f"{t}.json"], capfd)
    assert j == p and j[0] == 0 and j[1].startswith("# begin crush map")
    j, p = both(lambda t: ["-d", tmp_path / f"{t}.json", "-o",
                           tmp_path / f"{t}.txt"], capfd)
    assert j == p == (0, "", "")
    assert (tmp_path / "j.txt").read_text() == (tmp_path / "p.txt").read_text()
    # a text map decompiles too (read through the compiler)
    j, p = both(lambda t: ["-d", maps["text"]], capfd)
    assert j == p and j[0] == 0


def test_compile_default_output(maps, tmp_path, monkeypatch, capfd):
    out = {}
    for tag, tool in (("j", jtool), ("p", ptool)):
        d = tmp_path / tag
        d.mkdir()
        monkeypatch.chdir(d)
        assert run(tool, ["-c", maps["text"]], capfd)[0] == 0
        out[tag] = json.loads((d / "crushmap.json").read_text())
    assert out["j"] == out["p"]


@pytest.mark.parametrize("num_osds,layers", [
    (12, ["host", "straw2", "4", "root", "straw2", "0"]),
    (30, ["host", "straw2", "4", "rack", "straw2", "3", "root", "straw2",
          "0"]),
    (9, ["root", "straw2", "0"]),
])
def test_build_rule_reweight_tree(tmp_path, capfd, num_osds, layers):
    def f(t, name):
        return tmp_path / f"{t}.{name}"

    j, p = both(lambda t: ["--build", "--num-osds", num_osds, "-o",
                           f(t, "json")] + layers, capfd)
    assert j == p == (0, "", "")
    leaf = layers[0] if len(layers) > 3 else "osd"
    j, p = both(lambda t: ["-i", f(t, "json"), "--create-replicated-rule",
                           "replicated_rule", layers[-3], leaf, "-o",
                           f(t, "rule.json")], capfd)
    assert j == p == (0, "", "")
    for t in "jp":   # in place: the input file is rewritten
        tool = jtool if t == "j" else ptool
        assert run(tool, ["-i", f(t, "json"), "--create-replicated-rule",
                          "second", layers[-3], leaf], capfd)[0] == 0
        assert run(tool, ["-i", f(t, "json"), "--reweight", "-o",
                          f(t, "rw.json")], capfd)[0] == 0
    for name in ("json", "rule.json", "rw.json"):
        assert json.loads(f("j", name).read_text()) == \
            json.loads(f("p", name).read_text())
    j, p = both(lambda t: ["-i", f(t, "rw.json"), "--tree"], capfd)
    assert j == p and j[0] == 0 and j[1]
    # the built map's --test, through the compiled text too
    j, p = both(lambda t: ["-d", f(t, "rule.json"), "-o", f(t, "txt")],
                capfd)
    j, p = both(lambda t: ["-c", f(t, "txt"), "-o", f(t, "c.json")], capfd)
    assert j == p
    if j[0] == 0:
        args = ["--test", "--num-rep", 3, "--max-x", 255,
                "--show-statistics", "--show-utilization"]
        for extra in PORT_ENGINES.values():
            j, p = both(lambda t: ["-i", f(t, "c.json")] + args, capfd,
                        extra, ["--scalar"])
            assert j == p and j[0] == 0


def test_build_errors(tmp_path, capfd):
    for args in (["--build", "-o", tmp_path / "x.json"],
                 ["--build", "--num-osds", 4, "-o", tmp_path / "x.json",
                  "host", "straw", "2", "root", "straw2", "0"],
                 ["--build", "--num-osds", 4, "host", "straw2"]):
        with pytest.raises(SystemExit) as want:
            jtool.main([str(a) for a in args])
        with pytest.raises(SystemExit) as got:
            ptool.main([str(a) for a in args])
        assert str(got.value) == str(want.value)


def test_device_class_rule(maps, tmp_path, capfd):
    text = rule_shapes.text().replace(
        "device 0 osd.0\n", "device 0 osd.0 class ssd\n").replace(
        "device 9 osd.9\n", "device 9 osd.9 class ssd\n")
    src = tmp_path / "cls.txt"
    src.write_text(text)
    for t, tool in (("j", jtool), ("p", ptool)):
        assert run(tool, ["-c", src, "-o", tmp_path / f"{t}.json"],
                   capfd)[0] == 0
    j, p = both(lambda t: ["-i", tmp_path / f"{t}.json",
                           "--create-replicated-rule", "fast", "default",
                           "host", "--device-class", "ssd"], capfd)
    assert j == p == (0, "", "")
    assert json.loads((tmp_path / "j.json").read_text()) == \
        json.loads((tmp_path / "p.json").read_text())
    j, p = both(lambda t: ["-d", tmp_path / f"{t}.json"], capfd)
    assert j == p and "step take default class ssd" in j[1]


TEST_ARGS = [
    ["--num-rep", 3, "--max-x", 511, "--show-statistics",
     "--show-utilization"],
    ["--rule", 1, "--min-rep", 2, "--max-rep", 5, "--min-x", 100,
     "--max-x", 300, "--show-statistics", "--show-bad-mappings"],
    ["--num-rep", 3, "--max-x", 63, "--pool", 5, "--show-mappings",
     "--show-bad-mappings"],
    ["--rule", 0, "--num-rep", 4, "--max-x", 255, "--weight", 3, "0.5",
     "--weight", 7, "0", "--show-utilization", "--show-statistics"],
    ["--num-rep", 2, "--min-x", 2 ** 31 - 20, "--max-x", 2 ** 31 + 20,
     "--show-mappings"],
]


@pytest.mark.parametrize("engine", sorted(PORT_ENGINES))
@pytest.mark.parametrize("args", TEST_ARGS, ids=range(len(TEST_ARGS)))
def test_test_text_equal(maps, capfd, engine, args):
    j, p = both(lambda t: ["-i", maps["flat"], "--test"] + args, capfd,
                PORT_ENGINES[engine], ["--scalar"])
    assert j == p and j[0] == 0


@pytest.mark.parametrize("engine", sorted(PORT_ENGINES))
def test_rule_shapes_text_equal(maps, capfd, engine):
    """All 13 rules of the text map (numrep 3: bad mappings on most)."""
    j, p = both(lambda t: ["-i", maps["text"], "--test", "--max-x", 127,
                           "--show-statistics", "--show-bad-mappings",
                           "--show-utilization"], capfd,
                PORT_ENGINES[engine], ["--scalar"])
    assert j == p and j[0] == 0 and "bad mapping" in j[1]


@pytest.mark.parametrize("engine", sorted(PORT_ENGINES))
def test_compare_text_equal(maps, tmp_path, capfd, engine):
    other = tmp_path / "other.json"
    w = jtool.load_map(str(maps["flat"]))
    w.adjust_item_weight(4, 0x8000)
    other.write_text(json.dumps(w.to_dict()))
    for extra in ([], ["--rule", 1, "--num-rep", 4]):
        j, p = both(lambda t: ["-i", maps["flat"], "--compare", other,
                               "--max-x", 511] + extra, capfd,
                    PORT_ENGINES[engine], ["--scalar"])
        assert j == p and j[0] == 0 and "mappings differ" in j[1]


def test_map_without_rules_exits_1(tmp_path, capfd):
    out = tmp_path / "b.json"
    assert ptool.main(["--build", "--num-osds", "8", "-o", str(out), "host",
                       "straw2", "2", "root", "straw2", "0"]) == 0
    j, p = both(lambda t: ["-i", out, "--test"], capfd, ["--device", "cpu"],
                ["--scalar"])
    assert j == p and j[0] == 1 and "no rules" in j[2]


def test_no_input_prints_help_and_exits_1(capfd):
    j = run(jtool, [], capfd)
    p = run(ptool, [], capfd)
    assert j[0] == p[0] == 1
    assert j[1].startswith("usage: crushtool") and \
        p[1].startswith("usage: crushtool")
    assert "--device" in p[1]   # the port's one added flag


def test_test_asks_for_the_card(maps, capfd):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ptool.main(["-i", str(maps["flat"]), "--test"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ptool.main(["-i", str(maps["flat"]), "--compare", str(maps["flat"])])
    for extra in (["--scalar"], ["--native"], ["--device", "cpu"]):
        assert ptool.main(["-i", str(maps["flat"]), "--test",
                           "--max-x", "15"] + extra) == 0
