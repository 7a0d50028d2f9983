"""The port's flagship step against ``__graft_entry__.entry()``'s on the
same inputs, the port's isolation from JAX, and its device default.

Outputs are OSD indices and parity bytes, so the tolerance is zero.
"""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from __graft_entry__ import entry

from ceph_tpu_torch.analysis import contracts
from ceph_tpu_torch.convert import bitcode_from_numpy, map_arrays_from_numpy
from ceph_tpu_torch.crush.builder import sample_cluster_map
from ceph_tpu_torch.crush.map_arrays import as_i32
from ceph_tpu_torch.crush.mapper import BatchedMapper, build_rule_fn
from ceph_tpu_torch.crush.mapper_spec import (SpeculativeMapper,
                                              build_spec_rule_fn)
from ceph_tpu_torch.crush.wrapper import CrushWrapper
from ceph_tpu_torch.ec import gf
from ceph_tpu_torch.ec.engine import BitCode, Layout
from ceph_tpu_torch.ec.rs import RSCode
from ceph_tpu_torch.flagship import flagship, spec_cross_check
from ceph_tpu_torch.mgr.balancer_module import evaluate, run_offline
from ceph_tpu_torch.osdmap.balancer import build_pgs_by_osd, calc_pg_upmaps
from ceph_tpu_torch.osdmap.osdmap import OSDMap, PgPool
from ceph_tpu_torch.osdmap.pipeline import PoolMapper
from ceph_tpu_torch.parallel.placement import PlacementPlane
from ceph_tpu_torch.tools import crushtool
from ceph_tpu_torch.tools.tester import CrushTester
from test_torch_ref_native import ref_native_built  # noqa: F401  (autouse)

REPO = pathlib.Path(__file__).resolve().parent.parent
CPU = "cpu"


def _inputs(seed, n_osds=48):
    rng = np.random.default_rng(seed)
    weight = np.full(n_osds, 0x10000, np.uint32)
    weight[rng.choice(n_osds, 5, replace=False)] = 0
    weight[rng.choice(n_osds, 5, replace=False)] = 0x6000
    xs = rng.integers(0, 2 ** 32, 256, dtype=np.uint64).astype(np.uint32)
    stripes = rng.integers(0, 256, (8, 4096), dtype=np.uint8)
    return weight, xs, stripes


@pytest.mark.parametrize("seed", [0, 1])
def test_step_matches_jax_entry(seed):
    jstep, (A, _, _, _) = entry()
    weight, xs, stripes = _inputs(seed)
    jres, jlens, jparity = jstep(A, jnp.asarray(weight), jnp.asarray(xs),
                                 jnp.asarray(stripes))

    fs = flagship(device=CPU)
    res, lens, parity = fs.step(fs.arrays, as_i32(weight, CPU),
                                as_i32(xs, CPU), stripes)
    assert np.array_equal(res.numpy(), np.asarray(jres))
    assert np.array_equal(lens.numpy(), np.asarray(jlens))
    assert np.array_equal(parity.numpy(), np.asarray(jparity))


def test_step_defaults_mirror_entry():
    fs = flagship(device=CPU)
    arrays, weight, xs, stripes = fs.example_args()
    res, lens, parity = fs.step(arrays, weight, xs, stripes)
    assert res.shape == (256, 3) and (lens == 3).all()
    assert parity.shape == (3, 4096) and not parity.any()


def test_step_batched_stripes_equal_per_stripe_encode():
    fs = flagship(device=CPU)
    weight, xs, _ = _inputs(2)
    rng = np.random.default_rng(2)
    stripes = rng.integers(0, 256, (4, 8, 1000), dtype=np.uint8)
    _, _, parity = fs.step(fs.arrays, as_i32(weight, CPU), as_i32(xs, CPU),
                           stripes)
    assert parity.shape == (4, 3, 1000)
    for b in range(4):
        assert np.array_equal(parity[b].numpy(),
                              gf.encode_ref(fs.code.G, stripes[b]))


def test_port_never_imports_jax_or_the_jax_package(tmp_path):
    """Every module of the port imports without jax or ceph_tpu, and the
    native engine's host build (into a fresh directory) runs g++ alone:
    never ``native/Makefile`` or its generator, which imports
    ceph_tpu."""
    modules = sorted(
        "ceph_tpu_torch." + str(p.relative_to(REPO / "ceph_tpu_torch"))
        .replace(os.sep, ".")[:-3]
        for p in (REPO / "ceph_tpu_torch").rglob("*.py")
        if p.name != "__init__.py")
    code = (
        "import importlib, sys\n"
        f"for name in {modules!r}:\n"
        "    importlib.import_module(name)\n"
        "from ceph_tpu_torch.analysis import wirecheck\n"
        "assert len(wirecheck.entries()) == 19\n"
        "bad = [m for m in sys.modules if m == 'jax' or\n"
        "       m.startswith('jax.') or m == 'ceph_tpu' or\n"
        "       m.startswith('ceph_tpu.')]\n"
        "assert not bad, bad\n"
        "import pathlib, subprocess\n"
        "from ceph_tpu_torch import build\n"
        f"build.BUILD_DIR = pathlib.Path({str(tmp_path)!r})\n"
        "ran = []\n"
        "real = subprocess.run\n"
        "def spy(cmd, *a, **k):\n"
        "    ran.append(list(map(str, cmd)))\n"
        "    return real(cmd, *a, **k)\n"
        "subprocess.run = spy\n"
        "from ceph_tpu_torch.crush import native\n"
        "assert native.threads() >= 1\n"
        "assert len(ran) == 1 and ran[0][0].endswith('g++'), ran\n"
        "assert not any('make' in c or 'gen_ln_tables' in c\n"
        "               for c in ran[0]), ran\n"
        "bad = [m for m in sys.modules if m == 'jax' or\n"
        "       m.startswith('jax.') or m == 'ceph_tpu' or\n"
        "       m.startswith('ceph_tpu.')]\n"
        "assert not bad, bad\n"
        "print(len(sys.modules))\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    for name in ("crush.mapper", "crush.mapper_ref", "crush.builder",
                 "crush.map", "crush.wrapper", "common.encoding",
                 "osdmap.osdmap", "osdmap.pipeline", "osdmap.balancer",
                 "mgr.synthetic", "mgr.balancer_module",
                 "tools.osdmaptool", "convert", "flagship",
                 "crush.location", "crush.native", "parallel.placement",
                 "tools.compiler", "tools.tester", "tools.crushtool",
                 "tools.rule_shapes", "ec.gfw", "ec.matrices",
                 "ec.native_gf", "ec.interface", "ec.registry",
                 "ec.jerasure", "ec.isa", "ec.shec", "ec.lrc", "ec.clay",
                 "ec.stripe", "tools.ec_benchmark",
                 "tools.ec_non_regression", "ec.layout", "ec.gf2_packet",
                 "crush.mapper_spec", "common.bincode", "common.log",
                 "common.compressor", "common.copytrack",
                 "osdmap.incremental", "osdmap.bincode_maps",
                 "services.pg_log", "analysis.faults",
                 "analysis.racecheck", "os.objectstore", "os.memstore",
                 "os.kv", "os.wal_store", "tools.objectstore_tool",
                 "common.backoff", "common.version", "common.throttle",
                 "common.config", "common.tracing", "analysis.watchdog",
                 "analysis.asyncheck", "common.admin_socket",
                 "common.metrics_history", "common.profiler",
                 "common.context", "common.op_tracker", "common.op_queue",
                 "common.bufpool", "msg.auth", "msg.messenger",
                 "services.recovery", "services.quorum",
                 "services.heartbeat", "services.map_follower",
                 "services.monitor", "services.osd_service",
                 "services.client", "services.cluster",
                 "services.striper", "services.image", "mgr.daemon",
                 "common.counters", "common.attribution",
                 "analysis.wirecheck", "tools.telemetry", "tools.rados",
                 "tools.rados_bench", "tools.ceph_cli"):
        assert "ceph_tpu_torch." + name in modules


def test_entry_points_default_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    cmap = sample_cluster_map()
    crush_file = tmp_path / "crush.json"
    crush_file.write_text(json.dumps(CrushWrapper(cmap).to_dict()))
    bm = gf.expand_bitmatrix(gf.rs_vandermonde_matrix(8, 3)[8:])
    osdmap = OSDMap(cmap)
    for o in range(48):
        osdmap.add_osd(o)
    osdmap.pools[1] = PgPool(size=3, pg_num=16)
    calls = [
        lambda: RSCode(8, 3),
        lambda: BitCode(8, 3, bm),
        lambda: bitcode_from_numpy(bm, 8, 3),
        lambda: BatchedMapper(cmap),
        lambda: build_rule_fn(cmap, 0, 3),
        lambda: flagship(),
        lambda: PoolMapper(osdmap, 1),
        lambda: build_pgs_by_osd(osdmap),
        lambda: calc_pg_upmaps(osdmap),
        lambda: evaluate(osdmap),
        lambda: run_offline(osdmap),
        lambda: CrushTester(CrushWrapper(cmap)).test_rule(0, 3),
        lambda: CrushTester(CrushWrapper(cmap)).compare(
            CrushTester(CrushWrapper(cmap)), 0, 3),
        lambda: crushtool.main(["-i", str(crush_file), "--test"]),
        lambda: BitCode(2, 2, np.zeros((16, 16), np.uint8), Layout(8, 8)),
        lambda: BitCode(2, 2, np.zeros((32, 32), np.uint8), Layout(16)),
        lambda: SpeculativeMapper(cmap),
        lambda: build_spec_rule_fn(cmap, 0, 3),
        lambda: spec_cross_check(16),
        lambda: contracts.verify_all(),
        lambda: contracts.verify("ec.gf2_matmul_w8"),
        lambda: PlacementPlane(cmap),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    # the oracle engines ask for no card
    tester = CrushTester(CrushWrapper(cmap))
    assert tester.test_rule(0, 3, 0, 15, scalar=True).total == 16
    assert tester.test_rule(0, 3, 0, 15, native=True).total == 16
    assert build_pgs_by_osd(osdmap, use_batched=False)
    assert calc_pg_upmaps(osdmap, use_batched=False) == 0
    assert evaluate(osdmap, use_batched=False)["mapped_pgs"] == 16
    run_offline(osdmap, use_batched=False, max_rounds=1)
    out = PoolMapper(osdmap, 1, device=CPU).map_all()
    assert out["up"].device.type == "cpu" and out["up"].shape == (16, 3)
    from ceph_tpu.crush.map_arrays import encode_map as jencode_map
    from ceph_tpu.crush.builder import sample_cluster_map as jsample

    with pytest.raises(RuntimeError, match="no CUDA device"):
        map_arrays_from_numpy(*jencode_map(jsample()))
