"""The port's ``osdmaptool`` against ``ceph_tpu``'s, verb by verb.

On the same input the two tools must write the same ``--createsimple``
map file and the same ``--upmap`` command file, print the same
``--test-map-pgs`` and ``--test-map-pgs-dump`` text, and clean up the
same ``pg_upmap_items`` with ``--upmap-cleanup`` (``--clobber`` writes
the map back).  ``ceph_tpu``'s tool runs its scalar sweep (``--scalar``;
its batched sweep gives the same text, tests/test_tools.py); the
port's runs both on the CPU (``--device cpu``).  Each package's
``OSDMap.to_json`` is read by the other.  Without a card and without
``--device cpu`` the port's tool fails.
"""

import io
import json

import numpy as np
import pytest
import torch

from ceph_tpu.osdmap.osdmap import OSD_UP
from ceph_tpu.osdmap.osdmap import OSDMap as JOSDMap
from ceph_tpu.tools import osdmaptool as jtool

from ceph_tpu_torch.osdmap.osdmap import OSDMap as POSDMap
from ceph_tpu_torch.osdmap.pipeline import PoolMapper
from ceph_tpu_torch.tools import crushtool as pcrush
from ceph_tpu_torch.tools import osdmaptool as ptool

PORT_MODES = {"batched": ["--device", "cpu"],
              "scalar": ["--device", "cpu", "--scalar"]}


def run(tool, args, capfd, extra=()):
    rc = tool.main([str(a) for a in args] + list(extra))
    return rc, capfd.readouterr().out


@pytest.fixture
def simple(tmp_path, capfd):
    """Both tools' --createsimple files for 12 OSDs, pg_bits 4."""
    jf, pf = tmp_path / "j.json", tmp_path / "p.json"
    out_j = run(jtool, [jf, "--createsimple", 12, "--pg-bits", 4], capfd)
    out_p = run(ptool, [pf, "--createsimple", 12, "--pg-bits", 4,
                        "--device", "cpu"], capfd)
    return jf, pf, out_j, out_p


def test_createsimple_file_equal(simple):
    jf, pf, out_j, out_p = simple
    assert json.loads(jf.read_text()) == json.loads(pf.read_text())
    assert out_j[0] == out_p[0] == 0
    assert out_j[1].replace(str(jf), "F") == out_p[1].replace(str(pf), "F")


def weighted(path, seed):
    """Skew the map's weights in place (both tools then read it)."""
    d = json.loads(path.read_text())
    m = JOSDMap.from_dict(d)
    rng = __import__("random").Random(seed)
    for b in m.crush.buckets.values():
        b.item_weights = [w * rng.choice((1, 2, 4)) if it >= 0 else w
                          for it, w in zip(b.items, b.item_weights)]
    m.pools[2] = type(m.pools[1])(size=2, pg_num=64, crush_rule=0)
    path.write_text(json.dumps(m.to_dict()))


@pytest.mark.parametrize("mode", sorted(PORT_MODES))
@pytest.mark.parametrize("upmap_args", [
    ["--upmap-deviation", 1, "--upmap-max", 16],
    ["--upmap-deviation", 2, "--upmap-max", 8, "--upmap-pool", 2],
    [],
], ids=["dev1", "pool2", "defaults"])
def test_upmap_commands_equal(simple, tmp_path, capfd, mode, upmap_args):
    jf, pf, _, _ = simple
    weighted(jf, 3)
    pf.write_text(jf.read_text())
    jc, pc = tmp_path / "j.sh", tmp_path / "p.sh"
    rj = run(jtool, [jf, "--upmap", jc, "--scalar"] + upmap_args, capfd)
    rp = run(ptool, [pf, "--upmap", pc] + upmap_args, capfd,
             PORT_MODES[mode])
    assert rj == rp
    assert jc.read_text() == pc.read_text()
    if upmap_args:
        assert "pg-upmap-items" in pc.read_text()


@pytest.mark.parametrize("use_batched", [True, False],
                         ids=["batched", "scalar"])
@pytest.mark.parametrize("pool", [None, 2])
def test_test_map_pgs_text_equal(simple, capfd, use_batched, pool):
    """The stats text (written to the stdout bound when the tool was
    imported, so each tool's ``test_map_pgs`` writes into a buffer
    here), and both ``main``s accept the verb."""
    jf, pf, _, _ = simple
    weighted(jf, 5)
    pf.write_text(jf.read_text())
    jbuf, pbuf = io.StringIO(), io.StringIO()
    jtool.test_map_pgs(JOSDMap.from_dict(json.loads(jf.read_text())),
                       pool, use_batched=False, out=jbuf)
    ptool.test_map_pgs(POSDMap.from_dict(json.loads(pf.read_text())),
                       pool, use_batched=use_batched, out=pbuf,
                       device="cpu")
    assert jbuf.getvalue() == pbuf.getvalue()
    assert "avg" in pbuf.getvalue() and "size" in pbuf.getvalue()
    sel = [] if pool is None else ["--pool", pool]
    mode = "batched" if use_batched else "scalar"
    assert run(ptool, [pf, "--test-map-pgs"] + sel, capfd,
               PORT_MODES[mode])[0] == 0


def test_test_map_pgs_dump_equal(simple, capfd):
    jf, pf, _, _ = simple
    rj = run(jtool, [jf, "--test-map-pgs-dump", "--scalar"], capfd)
    rp = run(ptool, [pf, "--test-map-pgs-dump", "--device", "cpu"],
             capfd)
    assert rj == rp and len(rp[1].splitlines()) == 12 << 4


def test_upmap_cleanup_equal(simple, capfd):
    """Entries naming a missing pool, a PG past pg_num or a missing OSD
    are dropped or trimmed alike; --clobber writes the same map back."""
    jf, pf, _, _ = simple
    d = json.loads(jf.read_text())
    d["pg_upmap_items"] = [[[1, 3], [[0, 5]]], [[1, 4], [[0, 40], [1, 6]]],
                           [[1, 999], [[2, 3]]], [[7, 0], [[1, 2]]],
                           [[1, 5], [[50, 51]]]]
    d["osd_state"][6] = 0   # osd.6 no longer exists
    for f in (jf, pf):
        f.write_text(json.dumps(d))
    rj = run(jtool, [jf, "--upmap-cleanup", "--clobber"], capfd)
    rp = run(ptool, [pf, "--upmap-cleanup", "--clobber", "--device", "cpu"],
             capfd)
    assert rj == rp and "removed 4" in rp[1]
    assert json.loads(jf.read_text()) == json.loads(pf.read_text())


def test_mark_up_in_and_export_crush_equal(simple, tmp_path, capfd):
    jf, pf, _, _ = simple
    for f in (jf, pf):
        d = json.loads(f.read_text())
        d["osd_state"][2] = 1
        d["osd_weight"][3] = 0
        f.write_text(json.dumps(d))
    jx, px = tmp_path / "jc.json", tmp_path / "pc.json"
    run(jtool, [jf, "--mark-up-in", "--clobber", "--export-crush", jx],
        capfd)
    run(ptool, [pf, "--mark-up-in", "--clobber", "--export-crush", px,
                "--device", "cpu"], capfd)
    assert json.loads(jf.read_text()) == json.loads(pf.read_text())
    assert json.loads(jx.read_text()) == json.loads(px.read_text())


def test_import_crush_not_yet(simple, tmp_path, capfd):
    """--import-crush, which waited for crushtool's compiler: a text map
    (and a JSON map) replaces the crush map as in ``ceph_tpu``'s tool,
    and --clobber writes the same map file."""
    jf, pf, _, _ = simple
    cj, text = tmp_path / "c.json", tmp_path / "c.txt"
    for args in (["--build", "--num-osds", "12", "-o", str(cj), "host",
                  "straw2", "3", "root", "straw2", "0"],
                 ["-i", str(cj), "--create-replicated-rule", "rep", "root",
                  "host"],
                 ["-d", str(cj), "-o", str(text)]):
        assert pcrush.main(args) == 0
    text.write_text(text.read_text().replace("weight 1.00000",
                                             "weight 2.00000", 3))
    for src in (text, cj):
        rj = run(jtool, [jf, "--import-crush", src, "--clobber"], capfd)
        rp = run(ptool, [pf, "--import-crush", src, "--clobber"], capfd)
        assert rj == rp == (0, "")
        assert json.loads(jf.read_text()) == json.loads(pf.read_text())
        rj = run(jtool, [jf, "--test-map-pgs-dump", "--scalar"], capfd)
        rp = run(ptool, [pf, "--test-map-pgs-dump", "--device", "cpu"],
                 capfd)
        assert rj == rp and rp[1]


def test_json_envelope_read_both_ways():
    m = ptool.create_simple(6, 2)
    m.pg_upmap_items[(1, 3)] = [(0, 5)]
    m.pg_temp[(1, 2)] = [1, 2, 3]
    m.set_primary_affinity(4, 0x8000)
    j = JOSDMap.from_json(m.to_json())
    assert j.to_dict() == m.to_dict()
    assert POSDMap.from_json(j.to_json()).to_dict() == j.to_dict()
    # a bare to_dict (writer v0) reads too
    assert POSDMap.from_json(json.dumps(j.to_dict())).to_dict() == \
        j.to_dict()


def test_tool_needs_a_card_or_device_cpu(simple):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    _, pf, _, _ = simple
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ptool.main([str(pf), "--test-map-pgs"])


def busy_map(path, seed):
    """A map whose every pipeline stage has work: down and out OSDs,
    primary affinities, an EC pool beside the replicated one, upmaps,
    upmap items, pg_temp and primary_temp."""
    rng = np.random.default_rng(seed)
    m = JOSDMap.from_dict(json.loads(path.read_text()))
    m.osd_state[3] &= ~OSD_UP
    m.osd_weight[5] = 0
    m.set_primary_affinity(1, 0x4000)
    m.set_primary_affinity(7, 0)
    m.pools[2] = type(m.pools[1])(pool_type=3, size=4, pg_num=48,
                                  pgp_num=40, crush_rule=0)
    for pool, n in ((1, m.pools[1].pg_num), (2, 48)):
        for ps in rng.choice(n, 6, replace=False):
            m.pg_upmap_items[(pool, int(ps))] = [
                (int(rng.integers(12)), int(rng.integers(12)))]
        for ps in rng.choice(n, 4, replace=False):
            m.pg_temp[(pool, int(ps))] = [int(o) for o in
                                          rng.choice(12, 3, replace=False)]
        for ps in rng.choice(n, 2, replace=False):
            m.pg_upmap[(pool, int(ps))] = [int(o) for o in
                                           rng.choice(12, 3, replace=False)]
        m.primary_temp[(pool, int(rng.integers(n)))] = int(rng.integers(12))
    path.write_text(json.dumps(m.to_dict()))


@pytest.mark.parametrize("pool", [None, 1, 2])
@pytest.mark.parametrize("seed", [0, 1])
def test_dump_is_one_map_all_a_pool(simple, capfd, monkeypatch, pool, seed):
    """--test-map-pgs-dump sweeps each pool with one PoolMapper.map_all
    on --device and prints what the scalar pipeline prints, in both
    packages."""
    jf, pf, _, _ = simple
    busy_map(jf, seed)
    pf.write_text(jf.read_text())
    calls = []
    map_all = PoolMapper.map_all

    def counted(self, *a, **k):
        calls.append(self.pool_id)
        return map_all(self, *a, **k)

    monkeypatch.setattr(PoolMapper, "map_all", counted)
    sel = [] if pool is None else ["--pool", pool]
    rj = run(jtool, [jf, "--test-map-pgs-dump", "--scalar"] + sel, capfd)
    rp = run(ptool, [pf, "--test-map-pgs-dump", "--device", "cpu"] + sel,
             capfd)
    assert calls == ([1, 2] if pool is None else [pool])
    rs = run(ptool, [pf, "--test-map-pgs-dump", "--scalar"] + sel, capfd)
    assert calls == ([1, 2] if pool is None else [pool])
    assert rj == rp == rs and rp[0] == 0
    assert len(rp[1].splitlines()) == {None: 240, 1: 192, 2: 48}[pool]


def test_scalar_asks_for_no_card(simple, tmp_path, capfd):
    """--scalar runs the scalar pipeline on the host: no --device needed,
    and a device that could not be used is never resolved."""
    jf, pf, _, _ = simple
    weighted(jf, 3)
    pf.write_text(jf.read_text())
    for dev in ([], ["--device", "nonsense"]):
        for verb in (["--test-map-pgs"], ["--test-map-pgs-dump"],
                     ["--upmap", tmp_path / "u.sh"]):
            assert run(ptool, [pf] + verb + ["--scalar"] + dev,
                       capfd)[0] == 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ptool.main([str(pf), "--test-map-pgs-dump"])
