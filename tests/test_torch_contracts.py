"""The port's kernel contracts (``ceph_tpu_torch.analysis.contracts``),
the counterpart of ``ceph_tpu``'s jaxcheck, on the CPU.

Every kernel entry of the port has a contract; each holds on the CPU
(the kernels' plain versions; ``chip_smoke.py`` phase 10 runs the same
on the card); the checker catches an int64 or float lane, a wrong shape
and an output on the wrong device; the steady-state gate catches a new
signature and a rebuilt cache.
"""

import numpy as np
import pytest
import torch

from ceph_tpu.analysis import jaxcheck

from ceph_tpu_torch.analysis import contracts
from ceph_tpu_torch.ec.rs import RSCode
from test_torch_ref_native import ref_native_built  # noqa: F401  (autouse)

EXPECTED_CONTRACTS = {
    "ec.gf2_matmul_w8", "ec.gf2_matmul_words", "ec.gf2_packet",
    "ec.engine.bitcode", "ec.engine.encode_batched",
    "ec.engine.encode_batched_sharded", "ec.rs", "ec.jerasure", "ec.isa",
    "ec.lrc", "ec.shec", "ec.clay", "ec.native_gf",
    "crush.crush_rule_batched", "crush.mapper", "crush.mapper_spec",
    "parallel.sharded_rule_fn", "osdmap.pipeline",
}

# ceph_tpu's contracts and the port's that hold the same entry
SHARED = {
    "ec.engine.encode_batched": "ec.engine.encode_batched",
    "ec.engine.encode_batched_sharded": "ec.engine.encode_batched_sharded",
    "ec.jerasure": "ec.jerasure", "ec.isa": "ec.isa", "ec.lrc": "ec.lrc",
    "ec.shec": "ec.shec", "ec.clay": "ec.clay",
    "ec.native_gf": "ec.native_gf", "ec.rs_jax": "ec.rs",
    "ec.pallas": "ec.gf2_matmul_w8", "crush.mapper_jax": "crush.mapper",
    "crush.mapper_spec": "crush.mapper_spec",
    "parallel.sharded_rule_fn": "parallel.sharded_rule_fn",
}


def test_every_kernel_has_a_contract():
    assert set(contracts.contracts()) == EXPECTED_CONTRACTS


def test_every_shared_entry_of_ceph_tpu_has_its_counterpart():
    assert set(SHARED) <= set(jaxcheck.contracts())
    assert set(SHARED.values()) <= EXPECTED_CONTRACTS


@pytest.mark.parametrize("name", sorted(EXPECTED_CONTRACTS))
def test_contract_holds(name):
    violations = contracts.verify(name, "cpu")
    assert not violations, "\n".join(str(v) for v in violations)


def test_verify_all_holds_on_the_cpu():
    assert contracts.verify_all("cpu") == []


def _bad(name, cases):
    contracts.register_contract(name, lambda dev: cases)
    try:
        return contracts.verify(name, "cpu")
    finally:
        contracts._REGISTRY.pop(name, None)


@pytest.mark.parametrize("dtype", [torch.int64, torch.float32,
                                   torch.float64, torch.int16])
def test_checker_catches_a_drifted_lane(dtype):
    """An output that leaves the integer lanes is caught, whether or
    not the contract declared it."""
    x = torch.zeros(8, dtype=torch.uint8)
    drifted = str(dtype).replace("torch.", "")
    vs = _bad("_test.lane", [
        contracts.Case("undeclared", lambda t: t.to(dtype), (x,),
                       [((8,), "uint8")]),
        contracts.Case("declared", lambda t: t.to(dtype), (x,),
                       [((8,), drifted)]),
    ])
    msgs = [v.message for v in vs]
    assert any("mismatch" in m for m in msgs)
    assert sum("integer-lane drift" in m for m in msgs) == 2


def test_allow64_opts_a_case_out():
    x = torch.zeros(4, dtype=torch.int32)
    assert _bad("_test.allow", [contracts.Case(
        "i64", lambda t: t.to(torch.int64), (x,), [((4,), "int64")],
        allow64=True)]) == []


def test_checker_catches_shape_failure_and_case_errors():
    x = torch.zeros(8, dtype=torch.uint8)

    def boom(t):
        raise RuntimeError("kernel fault")

    vs = _bad("_test.shape", [
        contracts.Case("shape", lambda t: torch.zeros(9, dtype=torch.uint8),
                       (x,), [((8,), "uint8")]),
        contracts.Case("raises", boom, (x,), [((8,), "uint8")]),
        contracts.Case("dict", lambda t: {"b": t, "a": t[:2]}, (x,),
                       [((2,), "uint8"), ((8,), "uint8")]),
    ])
    assert [v.case for v in vs] == ["shape", "raises"]
    assert "kernel fault" in vs[1].message

    def broken(dev):
        raise ValueError("no map")

    contracts.register_contract("_test.cases", broken)
    try:
        (v,) = contracts.verify("_test.cases", "cpu")
        assert v.case == "<build>" and "no map" in v.message
    finally:
        contracts._REGISTRY.pop("_test.cases", None)
    with pytest.raises(KeyError):
        contracts.verify("_test.none", "cpu")


def test_checker_catches_an_output_on_the_wrong_device():
    x = torch.zeros(4, dtype=torch.uint8)
    vs = _bad("_test.device", [
        contracts.Case("meta", lambda t: t.to("meta"), (x,),
                       [((4,), "uint8")]),
        contracts.Case("host", lambda t: t, (x,), [((4,), "uint8")],
                       host=True),
    ])
    assert [v.case for v in vs] == ["meta"]
    assert "expected cpu" in vs[0].message


# -- steady-state gate -------------------------------------------------------

def _fresh_rs():
    """Shapes no other test books (the counters are process-global)."""
    return RSCode(5, 2, device="cpu")


def test_steady_state_clean_after_warmup():
    code = _fresh_rs()
    data = np.random.default_rng(7).integers(0, 256, (5, 1184),
                                             dtype=np.uint8)
    code.encode(data)
    base = len(contracts.recompile_violations())
    with contracts.steady_state("torch-rs-steady"):
        for _ in range(3):
            code.encode(data)
    assert contracts.recompile_violations()[base:] == []


def test_recompile_gate_catches_shape_instability():
    code = _fresh_rs()
    base = len(contracts.recompile_violations())
    with contracts.steady_state("torch-rs-shape-unstable"):
        for L in (1216, 1248, 1280):
            code.encode(np.zeros((5, L), np.uint8))
    caught = contracts.recompile_violations()[base:]
    contracts.clear_recompile_violations()
    assert caught and "torch-rs-shape-unstable" in caught[-1]["label"]
    assert "ec.engine.jit_compiles" in caught[-1]["message"]


def test_gate_catches_a_rebuilt_decode_matrix():
    """A new erasure signature inside the window builds a device
    matrix: caught, though the decode's shape signature is warm."""
    code = _fresh_rs()
    full = code.all_chunks(np.zeros((5, 320), np.uint8))
    chunks = {i: full[i] for i in range(7)}
    code.decode(chunks, [0, 1])
    base = len(contracts.recompile_violations())
    with contracts.steady_state("torch-decode-new-erasures"):
        code.decode(chunks, [2, 3])
    caught = contracts.recompile_violations()[base:]
    contracts.clear_recompile_violations()
    assert caught and "device.caches.matrices" in caught[-1]["message"]
    assert "ec.engine.jit_compiles" not in caught[-1]["message"]


@pytest.mark.parametrize("cache", ["launch_plans", "lowered_maps",
                                   "matrices"])
def test_gate_watches_every_cache(cache):
    """Each cache the port builds (K2's launch plans, lowered maps,
    device bit matrices) is watched: one build inside the window is
    caught.  (K2's plan is built only on the card: phase 10 runs the
    gate there.)"""
    from ceph_tpu_torch.common import device_metrics

    assert cache in device_metrics.CACHES
    base = len(contracts.recompile_violations())
    with contracts.steady_state(f"torch-{cache}"):
        device_metrics.note_rebuild(cache)
    caught = contracts.recompile_violations()[base:]
    contracts.clear_recompile_violations()
    assert caught and f"device.caches.{cache}" in caught[-1]["message"]
