"""The port's tools that need no shared cluster, held to ``ceph_tpu``'s:
the wire-format registry against ``ceph_tpu``'s and the committed
corpus, and ``rados_bench`` (its summary, and one short run on a
cluster of its own in each package).

For each of the registered wire and disk types: the port's example
encodes byte-equal to ``ceph_tpu``'s and to
``tests/corpus/encodings/<type>/<struct_v>/example.bin``, each package
decodes the other's blob, and the port's ``check()`` (the five
conformance properties) finds nothing.  The archived older-version blobs
decode in the port; ``ceph_cli dencoder`` works on the port's registry
and prints what ``ceph_tpu``'s does (but on two types, where
``ceph_tpu``'s raises).
"""

import json
import pathlib

import numpy as np
import pytest

import ceph_tpu.analysis.wirecheck as j_wire
import ceph_tpu.tools.ceph_cli as j_cli
import ceph_tpu.tools.rados_bench as j_bench
import ceph_tpu_torch.analysis.wirecheck as p_wire
import ceph_tpu_torch.tools.ceph_cli as p_cli
import ceph_tpu_torch.tools.rados_bench as p_bench
from test_torch_runtime import port_gates  # noqa: F401  (autouse)

CORPUS = pathlib.Path(__file__).resolve().parent / "corpus" / "encodings"
NAMES = p_wire.registered_names()


def _blob(entry):
    return p_wire._to_bytes(entry.encode(entry.factory()))


def test_registry_names_equal_the_reference():
    assert NAMES == j_wire.registered_names()
    assert len(NAMES) == 19
    assert p_wire.covered_classes() == j_wire.covered_classes()
    assert p_wire.frame_type_names() == j_wire.frame_type_names()
    for p, j in zip(p_wire.entries(), j_wire.entries()):
        assert (p.name, p.kind, p.struct_v, p.compat_v, p.reencode,
                p.covers, p.frame_types, p.legacy) == \
            (j.name, j.kind, j.struct_v, j.compat_v, j.reencode,
             j.covers, j.frame_types, j.legacy)


@pytest.mark.parametrize("name", NAMES)
def test_encode_equals_the_reference_and_the_corpus(name):
    p, j = p_wire.get(name), j_wire.get(name)
    blob = _blob(p)
    assert blob == j_wire._to_bytes(j.encode(j.factory()))
    assert blob == (CORPUS / name / str(p.struct_v) /
                    "example.bin").read_bytes()
    # each package reads the other's blob back to the same object
    assert p.extract(p.decode(blob)) == p.extract(p.factory())
    assert j.extract(j.decode(blob)) == j.extract(j.factory())
    # and the forged v+1 and future-compat blobs alike
    for forge in ("forge_forward", "forge_compat"):
        if getattr(p, forge) is not None:
            assert getattr(p, forge)(blob) == getattr(j, forge)(blob)


@pytest.mark.parametrize("name", NAMES)
def test_port_check_is_clean(name):
    assert p_wire.check(p_wire.get(name)) == []


def _archived():
    out = []
    for name in NAMES:
        e = p_wire.get(name)
        for vdir in sorted((CORPUS / name).iterdir()):
            if vdir.is_dir() and int(vdir.name) < e.struct_v:
                out += [(name, path) for path in sorted(vdir.glob("*.bin"))]
    return out


@pytest.mark.parametrize("name,path", _archived(),
                         ids=[f"{n}-v{p.parent.name}"
                              for n, p in _archived()])
def test_archived_blobs_decode_in_the_port(name, path):
    raw = path.read_bytes()
    p, j = p_wire.get(name), j_wire.get(name)
    assert p.extract(p.decode(raw)) == j.extract(j.decode(raw))


def test_mutations_fail_clean_like_the_reference():
    """The corruption battery is the same, and every blob of it fails
    (or decodes) the same way in both packages."""
    for name in NAMES:
        p, j = p_wire.get(name), j_wire.get(name)
        blob = _blob(p)
        muts = list(p_wire._mutations(p, blob))
        assert muts == list(j_wire._mutations(j, blob))
        for mut in muts:
            outcome = []
            for e in (p, j):
                try:
                    outcome.append(("ok", e.extract(e.decode(mut))))
                except ValueError as ex:   # MalformedInput of either
                    outcome.append(("refused", type(ex).__name__))
            assert outcome[0] == outcome[1], (name, mut[:16])


def _run(main, argv, capsys):
    rc = main(argv)
    return rc, capsys.readouterr().out


def test_dencoder_list_and_encode(capsys):
    got = _run(p_cli.main, ["dencoder", "list"], capsys)
    assert got == _run(j_cli.main, ["dencoder", "list"], capsys)
    assert got[0] == 0 and len(got[1].splitlines()) == len(NAMES)
    for name in NAMES:
        got = _run(p_cli.main, ["dencoder", "encode", name], capsys)
        assert got == (0, _blob(p_wire.get(name)).hex() + "\n")


# ``ceph_tpu``'s dencoder raises TypeError printing these two: neither
# decoded object has a JSON form (a ``Keyring``; a checkpoint's
# ``_Object``s).  The port prints the entry's comparable form.
NO_JSON_IN_THE_REFERENCE = ("msg.auth.keyring", "os.wal_checkpoint")


@pytest.mark.parametrize("name", NAMES)
def test_dencoder_decode_equals_the_reference(name, tmp_path, capsys):
    hexfile = tmp_path / "blob.hex"
    hexfile.write_text(_blob(p_wire.get(name)).hex())
    got = _run(p_cli.main, ["dencoder", "decode", name, str(hexfile)],
               capsys)
    assert got[0] == 0 and json.loads(got[1]) is not None
    if name in NO_JSON_IN_THE_REFERENCE:
        with pytest.raises(TypeError):
            j_cli.main(["dencoder", "decode", name, str(hexfile)])
    else:
        assert got == _run(j_cli.main, ["dencoder", "decode", name,
                                        str(hexfile)], capsys)
    hexfile.write_text("00ff" * 3)
    assert p_cli.main(["dencoder", "decode", name, str(hexfile)]) == 1
    capsys.readouterr()


def test_dencoder_roundtrip_verb(capsys):
    rc, out = _run(p_cli.main, ["dencoder", "roundtrip"], capsys)
    assert rc == 0
    assert out.splitlines() == [f"{n}: ok" for n in NAMES]


# -- rados_bench ---------------------------------------------------------

@pytest.mark.parametrize("n", [0, 1, 2, 7, 101])
def test_bench_summary_equals_the_reference(n):
    lat = np.random.default_rng(n).exponential(0.02, n).tolist()
    p, j = p_bench.BenchResult("write", 4 << 20), \
        j_bench.BenchResult("write", 4 << 20)
    for res in (p, j):
        for x in lat:
            res.add(x)
        res.errors = n % 3
        res.wall = 1.5 if n else 0.0
    assert p.summary() == j.summary()


def _key_tree(d):
    if isinstance(d, dict):
        return {k: _key_tree(v) for k, v in d.items()
                if k != "per_daemon"}
    return None


def test_bench_minicluster_record_matches_the_reference():
    """One short EC bench of each package: no errors, and records of
    the same key tree (the net summary's per-daemon rows compared by
    their daemon names)."""
    p = p_bench.bench_minicluster(seconds=0.3, object_size=64 << 10,
                                  ec=True, device="cpu")
    j = j_bench.bench_minicluster(seconds=0.3, object_size=64 << 10,
                                  ec=True)
    assert p["write"]["errors"] == 0 and p["write"]["ops"] >= 1
    assert _key_tree(p) == _key_tree(j)
    assert set(p["net"]["per_daemon"]) == set(j["net"]["per_daemon"])
    assert p["copy"]["engine"] == "bitplane"
    assert p["attribution"]["n_ops"] >= 1
    assert p["attribution"]["unattr_pct"] <= 10.0
    assert p["pool"] == j["pool"] and p["n_osds"] == j["n_osds"]


def test_bench_cli_device_defaults_to_the_card(monkeypatch, capsys):
    """The CLI hands ``bench_minicluster`` the card unless ``--device``
    says otherwise."""
    seen = {}

    def fake(**kw):
        seen.update(kw)
        return {}

    monkeypatch.setattr(p_bench, "bench_minicluster", fake)
    assert p_bench.main(["write", "--ec", "--seconds", "1"]) == 0
    assert seen["device"] == "cuda" and seen["ec"]
    assert p_bench.main(["seq", "--device", "cpu"]) == 0
    assert seen["device"] == "cpu" and seen["op"] == "seq"
    assert capsys.readouterr().out == "{}\n{}\n"
