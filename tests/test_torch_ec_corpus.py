"""The port's ``ec_non_regression --check --device cpu`` over the EC
corpus in ``tests/corpus/``: the five w=8 directories (jerasure
reed_sol_van, isa, lrc, shec, clay), archived from the reference C, and
the packet directory (jerasure cauchy_good, w=8, packetsize 8) must
check clean byte for byte (every chunk re-encoded, every single erasure
decoded), as ``ceph_tpu``'s checker does."""

import pathlib
import shutil

import pytest

from ceph_tpu.tools import ec_non_regression as jnonreg

from ceph_tpu_torch.tools import ec_non_regression

CORPUS = pathlib.Path(__file__).resolve().parent / "corpus"
W8 = ["clay-k=4-m=2", "isa-k=8-m=3",
      "jerasure-k=4-m=2-technique=reed_sol_van-w=8", "lrc-k=4-l=3-m=2",
      "shec-c=2-k=4-m=3"]
PACKET = "jerasure-k=4-m=3-packetsize=8-technique=cauchy_good-w=8"


@pytest.mark.parametrize("name", W8)
def test_w8_entry_checks_clean(name):
    assert ec_non_regression.check_entry(CORPUS / name, device="cpu") == []
    assert jnonreg.check_entry(CORPUS / name) == []


def test_check_cli_over_the_w8_directories(tmp_path, capsys):
    for name in W8:
        shutil.copytree(CORPUS / name, tmp_path / name)
    assert ec_non_regression.main(
        ["--check", "--device", "cpu", "--base", str(tmp_path)]) == 0
    assert "checked 5 corpus entries: OK" in capsys.readouterr().out


def test_packet_directory_checks_clean(tmp_path, capsys):
    assert ec_non_regression.check_entry(CORPUS / PACKET, device="cpu") == []
    assert jnonreg.check_entry(CORPUS / PACKET) == []
    for name in W8 + [PACKET]:
        shutil.copytree(CORPUS / name, tmp_path / name)
    assert ec_non_regression.main(
        ["--check", "--device", "cpu", "--base", str(tmp_path)]) == 0
    assert "checked 6 corpus entries: OK" in capsys.readouterr().out


def test_create_then_check_round_trips(tmp_path):
    """An entry the port archives checks clean in both packages."""
    assert ec_non_regression.main(
        ["--create", "--plugin", "isa", "-P", "k=4", "-P", "m=2",
         "--device", "cpu", "--base", str(tmp_path)]) == 0
    (entry,) = tmp_path.iterdir()
    assert entry.name == "isa-k=4-m=2"
    assert ec_non_regression.check_entry(entry, device="cpu") == []
    assert jnonreg.check_entry(entry) == []


def test_empty_or_missing_corpus_fails(tmp_path):
    assert ec_non_regression.check_all(tmp_path / "none", "cpu")
    assert ec_non_regression.check_all(tmp_path, "cpu")
