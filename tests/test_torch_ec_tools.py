"""The port's ``ec_benchmark`` beside ``ceph_tpu``'s
(``tests/test_tools.py``'s case, on the CPU): the reference's
``elapsed \\t KiB`` output, ``--verify`` over exhaustive and random
erasures, the engine choice, and the device default: the tool asks for
the card unless told ``--device cpu``, while ``engine=native`` asks for
none."""

import pytest
import torch

from ceph_tpu.tools import ec_benchmark as jec_benchmark

from ceph_tpu_torch.ec import registry
from ceph_tpu_torch.tools import ec_benchmark, ec_non_regression
from test_torch_ref_native import ref_native_built  # noqa: F401  (autouse)


def _line(capsys):
    """(elapsed, KiB) of the reference's line; the rate on stderr."""
    cap = capsys.readouterr()
    assert " GB/s" in cap.err
    out = cap.out.strip().split("\t")
    return float(out[0]), int(out[1])


@pytest.mark.parametrize("args", [
    ["--plugin", "jerasure", "-P", "k=4", "-P", "m=2", "--workload",
     "encode", "--size", "8192", "--iterations", "2"],
    ["--plugin", "lrc", "-P", "k=4", "-P", "m=2", "-P", "l=3",
     "--workload", "decode", "--size", "4096", "--erasures", "1",
     "--erasures-generation", "exhaustive", "--verify"],
    ["--plugin", "isa", "-P", "k=8", "-P", "m=3", "--workload", "decode",
     "--size", "10000", "--erasures", "3", "--erasures-generation",
     "exhaustive", "--verify"],
    ["--plugin", "clay", "-P", "k=4", "-P", "m=2", "--workload", "decode",
     "--size", "5000", "--erasures", "2", "--iterations", "5",
     "--verify"],
    ["--plugin", "shec", "-P", "k=4", "-P", "m=3", "-P", "c=2",
     "--workload", "encode", "--size", "3000", "--iterations", "3"],
    ["--plugin", "jerasure", "-P", "technique=cauchy_good", "-P", "k=4",
     "-P", "m=3", "-P", "packetsize=8", "--workload", "decode", "--size",
     "9000", "--erasures", "3", "--erasures-generation", "exhaustive",
     "--verify"],
    ["--plugin", "jerasure", "-P", "technique=liberation", "-P", "k=2",
     "-P", "m=2", "-P", "w=7", "-P", "packetsize=8", "--workload",
     "encode", "--size", "5000", "--iterations", "2"],
    ["--plugin", "jerasure", "-P", "k=3", "-P", "m=2", "-P", "w=16",
     "--workload", "decode", "--size", "7001", "--erasures", "2",
     "--erasures-generation", "exhaustive", "--verify"],
    ["--plugin", "shec", "-P", "k=4", "-P", "m=3", "-P", "c=2", "-P",
     "w=32", "--workload", "decode", "--size", "6000", "--erasures", "2",
     "--iterations", "6", "--verify"],
], ids=["jerasure-encode", "lrc-decode", "isa-decode", "clay-decode",
        "shec-encode", "cauchy_good-decode", "liberation-encode",
        "w16-decode", "shec-w32-decode"])
def test_output_matches_jax_package(args, capsys):
    assert jec_benchmark.main(args) == 0
    j_elapsed, j_kib = _line(capsys)
    assert ec_benchmark.main(args + ["--device", "cpu"]) == 0
    elapsed, kib = _line(capsys)
    assert elapsed > 0 and j_elapsed > 0
    assert kib == j_kib


def test_erasure_sets_match_jax_package():
    assert ec_benchmark.erasure_sets(11, 3, "exhaustive", 0) == \
        list(jec_benchmark.exhaustive_erasures(11, 3))
    assert ec_benchmark.erasure_sets(6, 2, "random", 50) == \
        list(jec_benchmark.random_erasures(6, 2, 50))


def test_verify_catches_a_wrong_decode(monkeypatch, capsys):
    """--verify fails the run when a decode returns other bytes."""
    from ceph_tpu_torch.ec.jerasure import SingleCode

    real = SingleCode.decode_chunks

    def corrupt(self, want, chunks, decoded):
        real(self, want, chunks, decoded)
        for i in decoded:
            if i not in chunks:
                decoded[i] = decoded[i] ^ 1

    monkeypatch.setattr(SingleCode, "decode_chunks", corrupt)
    assert ec_benchmark.main(
        ["--plugin", "isa", "--workload", "decode", "--size", "4096",
         "--erasures", "1", "--erasures-generation", "exhaustive",
         "--verify", "--device", "cpu"]) == 1
    assert "verify failed" in capsys.readouterr().err


def test_native_engine_needs_no_card(capsys):
    args = ["--plugin", "isa", "-P", "k=4", "-P", "m=2", "-P",
            "engine=native", "--workload", "decode", "--size", "8192",
            "--erasures", "2", "--erasures-generation", "exhaustive",
            "--verify"]
    assert ec_benchmark.main(args) == 0
    assert _line(capsys)[1] == 15 * 8
    code = registry.factory("jerasure", {"engine": "native"})
    assert code.device.type == "cpu"


def test_default_device_is_the_card(monkeypatch, tmp_path):
    """Every plugin entry point and both tools raise without a card,
    and no environment variable moves them: CEPH_TPU_EC_ENGINE is not
    read."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    monkeypatch.setenv("CEPH_TPU_EC_ENGINE", "native")
    for plugin, profile in (("jerasure", {}), ("isa", {}),
                            ("lrc", {"k": "4", "m": "2", "l": "3"}),
                            ("shec", {}), ("clay", {})):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            registry.factory(plugin, profile)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        registry.profile_factory({"plugin": "isa"})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ec_benchmark.main(["--plugin", "isa", "--size", "4096"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ec_non_regression.check_entry(
            ec_non_regression.DEFAULT_BASE / "isa-k=8-m=3")
