"""Kernel contracts and the steady-state gate of the port.

The counterpart of ``ceph_tpu/analysis/jaxcheck.py``.  On the TPU the
silent faults are recompilation storms and dtype drift; the port's are
the same two in its own form:

- **Contract registry.**  Every kernel entry of the port registers its
  cases: the entry run on tiny inputs on a device, and the exact shapes
  and dtypes of every output leaf (tensors in tuples, lists and dicts,
  in key order).  ``verify(name, device)`` and ``verify_all(device)``
  run them on the card (the kernels), by default, or on the CPU (the
  plain versions) when asked for with ``device="cpu"``.  An integer lane may be uint8, int32 or uint32 only: an
  output that drifts to a 64-bit or float dtype is a violation even
  where the declared dtype says so (``allow64`` opts a case out).  An
  output must also lie on the device the case ran on, unless the case
  is a host engine's.
- **Steady-state gate.**  ``steady_state()`` marks a phase that must
  not build anything for the first time: no new shape signature in the
  ``ec.engine`` / ``crush.mapper`` counters (``jit_compiles``), and no
  rebuilt launch plan, lowered map or device bit matrix (the
  ``device.caches`` counters).  Growth inside the window is recorded
  in ``recompile_violations()``; the caller fails on it.

The static half of this layer is ``analysis/lint_torch.py``.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device

# dtypes an integer kernel may produce: EC chunk bytes, CRUSH results
_INTEGER_LANES = ("uint8", "int32", "uint32")


@dataclass
class ContractViolation:
    contract: str
    case: str
    message: str

    def __str__(self) -> str:
        return f"[{self.contract}/{self.case}] {self.message}"


@dataclass
class Case:
    """One (entry, input point) check: ``fn(*args)`` must return leaves
    of exactly ``want`` [(shape, dtype)].  ``host`` marks a host
    engine, whose outputs are on the CPU whatever the device;
    ``allow64`` exempts the case from the integer-lane check."""

    label: str
    fn: Callable
    args: Sequence = field(default_factory=tuple)
    want: Sequence[Tuple[Tuple[int, ...], str]] = ()
    host: bool = False
    allow64: bool = False


_REGISTRY: Dict[str, Callable[[torch.device], List[Case]]] = {}


def register_contract(name: str,
                      make_cases: Callable[[torch.device], List[Case]]
                      ) -> None:
    """``make_cases(device)`` returns the contract's cases; it runs at
    verify time, so registering costs nothing at import."""
    _REGISTRY[name] = make_cases


def contracts() -> List[str]:
    return sorted(_REGISTRY)


def _leaves(out) -> List[torch.Tensor]:
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, dict):
        return [t for k in sorted(out) for t in _leaves(out[k])]
    if isinstance(out, (list, tuple)):
        return [t for o in out for t in _leaves(o)]
    raise TypeError(f"output leaf of type {type(out).__name__} is not a "
                    f"tensor")


def _dtype(t: torch.Tensor) -> str:
    return str(t.dtype).replace("torch.", "")


def _run_case(contract: str, case: Case,
              device: torch.device) -> List[ContractViolation]:
    try:
        leaves = _leaves(case.fn(*case.args))
    except Exception as e:
        return [ContractViolation(contract, case.label,
                                  f"entry failed: {e!r}")]
    out: List[ContractViolation] = []
    specs = [(tuple(t.shape), _dtype(t)) for t in leaves]
    want = [(tuple(s), str(d)) for s, d in case.want]
    if specs != want:
        out.append(ContractViolation(
            contract, case.label,
            f"output signature mismatch: got {specs}, want {want}"))
    if not case.allow64:
        for shape, dtype in specs:
            if dtype not in _INTEGER_LANES:
                out.append(ContractViolation(
                    contract, case.label,
                    f"integer-lane drift: output {shape} has dtype "
                    f"{dtype} (allowed: {_INTEGER_LANES})"))
    where = "cpu" if case.host else device.type
    for t in leaves:
        if t.device.type != where:
            out.append(ContractViolation(
                contract, case.label,
                f"output on {t.device}, expected {where}"))
            break
    return out


def verify(name: str, device="cuda") -> List[ContractViolation]:
    """The contract ``name``'s cases on ``device``; raises without a
    card unless ``device="cpu"``."""
    make_cases = _REGISTRY.get(name)
    if make_cases is None:
        raise KeyError(f"no contract {name!r}; have {contracts()}")
    dev = resolve_device(device)
    try:
        cases = make_cases(dev)
    except Exception as e:
        return [ContractViolation(name, "<build>",
                                  f"the contract's cases failed to build: {e!r}")]
    out: List[ContractViolation] = []
    for case in cases:
        out.extend(_run_case(name, case, dev))
    return out


def verify_all(device="cuda") -> List[ContractViolation]:
    """Every registered contract on ``device``; empty when every entry
    gives its declared shapes and dtypes there."""
    resolve_device(device)
    out: List[ContractViolation] = []
    for name in contracts():
        out.extend(verify(name, device))
    return out


# ---------------------------------------------------------------------------
# steady-state gate
# ---------------------------------------------------------------------------

_recompile_violations: List[Dict] = []

# the loggers that book a signature's first call (``jit_compiles``)
_COMPILE_COUNTERS = ("ec.engine", "crush.mapper")


def compile_counters() -> Dict[str, float]:
    """Snapshot of every first-call and cache-build counter that exists
    (a logger appears when its module is first imported)."""
    from ..common import device_metrics
    from ..common.perf_counters import collection

    dumped = collection().dump()
    out: Dict[str, float] = {}
    for name in _COMPILE_COUNTERS:
        pc = dumped.get(name, {})
        if "jit_compiles" in pc:
            out[f"{name}.jit_compiles"] = pc["jit_compiles"]
    caches = dumped.get("device.caches", {})
    for key in device_metrics.CACHES:
        out[f"device.caches.{key}"] = caches.get(key, 0)
    return out


@contextlib.contextmanager
def steady_state(label: str = ""):
    """Wrap a phase that must build nothing: every signature it
    launches has been seen and every cache it reads is built (warm-up
    ran outside the window).  A new signature or a rebuilt cache inside
    records a violation."""
    before = compile_counters()
    yield
    after = compile_counters()
    grew = {key: (before.get(key, 0), val)
            for key, val in after.items() if val > before.get(key, 0)}
    if grew:
        detail = ", ".join(f"{key} {int(a)}->{int(b)}"
                           for key, (a, b) in sorted(grew.items()))
        _recompile_violations.append({
            "label": label or "<steady-state>",
            "message": (f"steady-state phase {label or '?'!r} built "
                        f"something for the first time: {detail} — a "
                        f"shape-unstable call or a cache rebuilt per "
                        f"call"),
            "counters": grew,
        })


def recompile_violations() -> List[Dict]:
    return list(_recompile_violations)


def clear_recompile_violations() -> None:
    del _recompile_violations[:]


# ---------------------------------------------------------------------------
# builtin contracts: every kernel entry of the port
# ---------------------------------------------------------------------------

def _u8(device, *shape, seed=0) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8)) \
        .to(device)


def _bits(device, rows, cols, seed=1) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, 2, (rows, cols),
                                         dtype=np.uint8)).to(device)


def _contract_gf2_matmul_w8(dev) -> List[Case]:
    from ..ec import gf2_kernels

    out = []
    for k, m, L in ((4, 2, 512), (8, 3, 1000)):
        bm = _bits(dev, 8 * m, 8 * k)
        data = _u8(dev, k, L)
        out.append(Case(f"k={k},m={m},L={L}", gf2_kernels.gf2_matmul_w8,
                        (bm, data), [((m, L), "uint8")]))
        out.append(Case(f"k={k},m={m},L={L}/rows", gf2_kernels.gf2_matmul_w8,
                        (bm, list(data)), [((m, L), "uint8")]))
    bm = _bits(dev, 16, 32)
    out.append(Case("k=4,m=2,B=3,L=256", gf2_kernels.gf2_matmul_w8,
                    (bm, _u8(dev, 3, 4, 256)), [((3, 2, 256), "uint8")]))
    return out


def _contract_gf2_matmul_words(dev) -> List[Case]:
    from ..ec import gf2_kernels

    out = []
    for w, k, m, L in ((16, 3, 2, 256), (32, 4, 3, 512)):
        bm = _bits(dev, w * m, w * k)
        out.append(Case(f"w={w},k={k},m={m},L={L}",
                        gf2_kernels.gf2_matmul_words,
                        (bm, _u8(dev, k, L), w), [((m, L), "uint8")]))
    return out


def _contract_gf2_packet(dev) -> List[Case]:
    from ..ec import gf2_packet

    out = []
    for w, k, m, ps, nb in ((8, 4, 2, 8, 4), (7, 3, 2, 16, 2)):
        bm = _bits(dev, w * m, w * k)
        L = w * ps * nb
        out.append(Case(f"w={w},k={k},m={m},ps={ps},L={L}",
                        gf2_packet.gf2_packet,
                        (bm, _u8(dev, k, L), w, ps), [((m, L), "uint8")]))
    bm = _bits(dev, 16, 32)
    out.append(Case("w=8,k=4,m=2,ps=8,B=2", gf2_packet.gf2_packet,
                    (bm, _u8(dev, 2, 4, 256), 8, 8),
                    [((2, 2, 256), "uint8")]))
    return out


def _bitcodes(dev):
    """(label, BitCode, chunk length) for the three layout families."""
    from ..ec import gf
    from ..ec.engine import BitCode
    from ..ec.gfw import GFW
    from ..ec.layout import Layout
    from ..ec.matrices import (cauchy_good_coding_matrix,
                               reed_sol_vandermonde_coding_matrix)

    out = [("w8(k=4,m=2)", BitCode(
        4, 2, gf.expand_bitmatrix(gf.rs_vandermonde_matrix(4, 2)[4:]),
        Layout(8), device=dev), 1024)]
    out.append(("w16(k=3,m=2)", BitCode(
        3, 2, GFW(16).expand_bitmatrix(
            reed_sol_vandermonde_coding_matrix(3, 2, 16)),
        Layout(16), device=dev), 512))
    out.append(("packet(w=8,ps=8,k=4,m=2)", BitCode(
        4, 2, GFW(8).expand_bitmatrix(cauchy_good_coding_matrix(4, 2, 8)),
        Layout(8, 8), device=dev), 256))
    return out


def _contract_bitcode(dev) -> List[Case]:
    out = []
    for label, bc, L in _bitcodes(dev):
        k, m = bc.k, bc.m
        data = _u8(dev, k, L)
        full = torch.cat([data, bc.encode(data)])
        erased = {0, k}
        avail = {i: full[i] for i in range(k + m) if i not in erased}
        out.append(Case(f"{label}/encode", bc.encode, (data,),
                        [((m, L), "uint8")]))
        out.append(Case(f"{label}/decode_data[erased=[0,{k}]]",
                        bc.decode_data, (avail,), [((k, L), "uint8")]))
        out.append(Case(f"{label}/decode[erased=[0,{k}]]", bc.decode,
                        (sorted(erased), avail),
                        [((L,), "uint8")] * 2))
    return out


def _contract_encode_batched(dev) -> List[Case]:
    out = []
    for label, bc, L in _bitcodes(dev):
        for B in (1, 5):
            out.append(Case(
                f"{label}/B={B}", lambda s, bc=bc: bc.encode_batched(s,
                                                                      None),
                (_u8(dev, B, bc.k, L),), [((B, bc.m, L), "uint8")]))
    return out


def _contract_encode_batched_sharded(dev) -> List[Case]:
    from ..ec.engine import encode_batched_sharded
    from ..parallel.placement import make_mesh

    out = []
    for label, bc, L in _bitcodes(dev):
        for n_dev in (1, 2):
            mesh = make_mesh([dev] * n_dev, axis_name="ec")
            for B in (4, 3):
                out.append(Case(
                    f"{label}/B={B}/ndev={n_dev}",
                    lambda s, bc=bc, mesh=mesh: encode_batched_sharded(
                        bc, s, mesh),
                    (_u8(dev, B, bc.k, L),), [((B, bc.m, L), "uint8")]))
    return out


def _contract_rs(dev) -> List[Case]:
    from ..ec.rs import RSCode

    out = []
    for k, m in ((2, 1), (4, 2), (8, 3)):
        code = RSCode(k, m, device=dev)
        L = 512
        data = _u8(dev, k, L)
        full = code.all_chunks(data)
        chunks = {i: full[i] for i in range(k + m)}
        erasures = [0, k] if m > 1 else [0]
        out.append(Case(f"rs(k={k},m={m})/encode", code.encode, (data,),
                        [((m, L), "uint8")]))
        out.append(Case(f"rs(k={k},m={m})/encode_batched",
                        code.encode_batched, (_u8(dev, 3, k, L),),
                        [((3, m, L), "uint8")]))
        out.append(Case(f"rs(k={k},m={m})/decode[erased={erasures}]",
                        code.decode, (chunks, erasures),
                        [((k, L), "uint8")]))
    return out


def _plugin_cases(tag: str, plugin, erased) -> List[Case]:
    """Encode of a 4 KiB object and a decode of ``erased`` through the
    plugin's own entry points."""
    n = plugin.get_chunk_count()
    raw = _u8("cpu", 4096, seed=3).numpy().tobytes()
    L = plugin.get_chunk_size(len(raw))
    chunks = plugin.encode(range(n), raw)
    avail = {i: c for i, c in chunks.items() if i not in erased}
    return [
        Case(f"{tag}/encode", plugin.encode, (range(n), raw),
             [((L,), "uint8")] * n),
        Case(f"{tag}/decode[erased={sorted(erased)}]", plugin.decode,
             (set(erased), avail), [((L,), "uint8")] * len(erased)),
    ]


def _contract_plugin(plugin_name: str, profiles, erase_two: bool):
    def build(dev) -> List[Case]:
        from ..ec.registry import factory

        out = []
        for prof in profiles:
            plugin = factory(plugin_name, dict(prof), device=dev)
            k = plugin.get_data_chunk_count()
            m = plugin.get_chunk_count() - k
            erased = {0, k} if erase_two and m > 1 else {0}
            tag = ",".join(f"{key}={v}" for key, v in sorted(prof.items()))
            out.extend(_plugin_cases(f"{plugin_name}({tag})", plugin,
                                     erased))
        return out

    return build


_JERASURE = [
    {"technique": "reed_sol_van", "k": "2", "m": "1", "w": "8"},
    {"technique": "reed_sol_van", "k": "4", "m": "2", "w": "8"},
    {"technique": "reed_sol_van", "k": "3", "m": "2", "w": "16"},
    {"technique": "reed_sol_van", "k": "3", "m": "2", "w": "32"},
    {"technique": "reed_sol_r6_op", "k": "4", "m": "2", "w": "8"},
    {"technique": "cauchy_good", "k": "4", "m": "2", "w": "8",
     "packetsize": "8"},
    {"technique": "cauchy_orig", "k": "3", "m": "2", "w": "8",
     "packetsize": "8"},
    {"technique": "liberation", "k": "3", "m": "2", "w": "7",
     "packetsize": "8"},
    {"technique": "blaum_roth", "k": "3", "m": "2", "w": "6",
     "packetsize": "8"},
    {"technique": "liber8tion", "k": "4", "m": "2", "w": "8",
     "packetsize": "8"},
]
_ISA = [{"technique": "reed_sol_van", "k": "7", "m": "3"},
        {"technique": "reed_sol_van", "k": "4", "m": "2"},
        {"technique": "cauchy", "k": "4", "m": "2"}]
_LRC = [{"k": "4", "m": "2", "l": "3"}, {"k": "2", "m": "2", "l": "2"}]
_SHEC = [{"k": "4", "m": "3", "c": "2"}, {"k": "6", "m": "2", "c": "1"}]
_CLAY = [{"k": "4", "m": "2"}, {"k": "3", "m": "3", "d": "5"}]


def _contract_native_gf(dev) -> List[Case]:
    """The host GF(2^8) engine: its outputs are host tensors."""
    from ..ec import gf
    from ..ec.native_gf import NativeMatrixCode

    out = []
    for k, m in ((4, 2), (8, 3)):
        code = NativeMatrixCode(k, m, gf.rs_vandermonde_matrix(k, m)[k:])
        L = 64
        data = np.zeros((k, L), np.uint8)
        full = torch.cat([torch.from_numpy(data), code.encode(data)])
        chunks = {i: full[i] for i in range(2, k + m)}
        out.append(Case(f"native(k={k},m={m})/encode", code.encode,
                        (data,), [((m, L), "uint8")], host=True))
        out.append(Case(f"native(k={k},m={m})/decode[erased=[0,1]]",
                        code.decode_data, (chunks,), [((k, L), "uint8")],
                        host=True))
    return out


def _sample_map():
    from ..crush.builder import sample_cluster_map

    return sample_cluster_map(racks=2, hosts_per_rack=2, osds_per_host=2)


def _contract_crush_rule_batched(dev) -> List[Case]:
    from ..crush.map_arrays import as_i32
    from ..crush.mapper import BatchedMapper, crush_rule_batched

    cmap = _sample_map()
    bm = BatchedMapper(cmap, device=dev)
    w = as_i32(np.full(cmap.max_devices, 0x10000, np.uint32), dev)
    out = []
    for ruleno in (0, 1):
        for R, n in ((3, 64), (5, 256)):
            prog = bm.program(ruleno, R)
            xs = as_i32(np.arange(n, dtype=np.uint32), dev)
            out.append(Case(f"rule{ruleno}/R={R}/N={n}", crush_rule_batched,
                            (bm.arrays, prog, w, xs),
                            [((n, R), "int32"), ((n,), "int32")]))
    return out


def _contract_crush_mapper(dev) -> List[Case]:
    from ..crush.mapper import BatchedMapper

    cmap = _sample_map()
    bm = BatchedMapper(cmap, device=dev)
    w = np.full(cmap.max_devices, 0x10000, np.uint32)
    return [Case(f"rule{ruleno}/R={R}/N={n}", bm.map_batch,
                 (ruleno, np.arange(n, dtype=np.uint32), R, w),
                 [((n, R), "int32"), ((n,), "int32")])
            for ruleno in (0, 1) for R, n in ((3, 64), (5, 100))]


def _contract_crush_mapper_spec(dev) -> List[Case]:
    from ..crush.mapper_spec import SpeculativeMapper

    cmap = _sample_map()
    sm = SpeculativeMapper(cmap, k_tries=1, device=dev)
    w = np.full(cmap.max_devices, 0x10000, np.uint32)
    return [Case(f"rule0/R=3/N=64", sm.map_batch,
                 (0, np.arange(64, dtype=np.uint32), 3, w),
                 [((64, 3), "int32"), ((64,), "int32")])]


def _contract_sharded_rule_fn(dev) -> List[Case]:
    from ..parallel.placement import make_mesh, sharded_rule_fn

    cmap = _sample_map()
    w = np.full(cmap.max_devices, 0x10000, np.uint32)
    out = []
    for n_dev in (1, 2):
        mesh = make_mesh([dev] * n_dev)
        for gather in (False, True):
            fn, static, arrays = sharded_rule_fn(
                cmap, 0, 3, mesh, gather_stats=gather, masked=True)
            N = 64
            valid = torch.arange(N) < 50
            want = [((N, 3), "int32"), ((N,), "int32")]
            if gather:
                want.append(((static.max_devices,), "int32"))
            out.append(Case(
                f"rule0/R=3/N={N}/ndev={n_dev}/gather={gather}", fn,
                (arrays, w, np.arange(N, dtype=np.uint32), valid), want))
    return out


def _contract_pipeline(dev) -> List[Case]:
    from ..osdmap.osdmap import OSDMap, PgPool, POOL_TYPE_REPLICATED
    from ..osdmap.pipeline import PoolMapper
    from ..parallel.placement import make_mesh

    m = OSDMap(_sample_map())
    for o in range(m.crush.max_devices):
        m.add_osd(o)
    m.pools[1] = PgPool(pool_type=POOL_TYPE_REPLICATED, size=3, pg_num=50,
                        crush_rule=0)
    m.pg_upmap_items[(1, 3)] = [(0, 7)]
    m.pg_temp[(1, 7)] = [1, 2, 3]
    keys = ("acting", "acting_len", "acting_primary", "up", "up_len",
            "up_primary")
    want = [((50, 3), "int32") if k in ("acting", "up") else ((50,), "int32")
            for k in keys]
    return [Case(f"pool1/pg_num=50/mesh={n_dev}",
                 PoolMapper(m, 1, mesh=make_mesh([dev] * n_dev)
                            if n_dev else None, device=dev).map_all,
                 (), want)
            for n_dev in (0, 3)]


def _register_builtin_contracts() -> None:
    register_contract("ec.gf2_matmul_w8", _contract_gf2_matmul_w8)
    register_contract("ec.gf2_matmul_words", _contract_gf2_matmul_words)
    register_contract("ec.gf2_packet", _contract_gf2_packet)
    register_contract("ec.engine.bitcode", _contract_bitcode)
    register_contract("ec.engine.encode_batched", _contract_encode_batched)
    register_contract("ec.engine.encode_batched_sharded",
                      _contract_encode_batched_sharded)
    register_contract("ec.rs", _contract_rs)
    register_contract("ec.jerasure",
                      _contract_plugin("jerasure", _JERASURE, True))
    register_contract("ec.isa", _contract_plugin("isa", _ISA, True))
    register_contract("ec.lrc", _contract_plugin("lrc", _LRC, False))
    register_contract("ec.shec", _contract_plugin("shec", _SHEC, False))
    register_contract("ec.clay", _contract_plugin("clay", _CLAY, False))
    register_contract("ec.native_gf", _contract_native_gf)
    register_contract("crush.crush_rule_batched",
                      _contract_crush_rule_batched)
    register_contract("crush.mapper", _contract_crush_mapper)
    register_contract("crush.mapper_spec", _contract_crush_mapper_spec)
    register_contract("parallel.sharded_rule_fn", _contract_sharded_rule_fn)
    register_contract("osdmap.pipeline", _contract_pipeline)


_register_builtin_contracts()
