"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` source has a plain C interface.  It is compiled by
``nvcc`` for ``sm_90a`` into a shared library of its own, at first use,
into ``_build/`` beside this file (git ignores it), and loaded with
``ctypes``.  The library's name carries a digest of its source, the
headers beside it (``csrc/*.cuh``) and the flags, so an edited source
is never served by a stale build.  A build
or load that fails raises: nothing falls back to the CPU.

One host target sits beside them: the native CPU CRUSH engine
(``native/crush_host.cpp``, OpenMP), compiled by ``g++`` the same way
(``build_host``/``load_host``).  Its ``#include "crush_ln_tables.h"``
finds the header in the source's own directory first, so the source is
copied into a staging directory under ``_build/`` beside a header
written from the port's own ``crush/_ln_tables.py``; ``native/``'s
Makefile and header are never used.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time
from typing import Dict, Iterable, Optional

from .analysis.lockdep import make_lock

PKG = pathlib.Path(__file__).resolve().parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"

SOURCES = {
    "gf2_matmul_w8": CSRC / "gf2_matmul_w8.cu",
    "crush_rule": CSRC / "crush_rule.cu",
    "gf2_packet": CSRC / "gf2_packet.cu",
}
HOST_SOURCE = PKG.parent / "native" / "crush_host.cpp"
GXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-fopenmp", "-shared")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_lock = make_lock("build::libs")
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def lib_path(name: str) -> pathlib.Path:
    src = SOURCES[name]
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):   # what a source includes
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Optional[Iterable[str]] = None,
          verbose: bool = False) -> Dict[str, float]:
    """Compile the named kernels (all of them by default) that are not
    built yet: one ``nvcc`` per source, all started together.  Returns
    the seconds each build took; raises with the compiler's output if
    any build fails.  ``verbose`` prints ptxas' register and spill
    report for each kernel."""
    names = list(SOURCES if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])]
        if verbose:
            cmd.insert(1, "-Xptxas=-v")
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), tmp, out)
    took, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        took[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"nvcc {name} exited {proc.returncode}:\n{log}")
            continue
        if verbose and log:
            print(f"# nvcc {name}:\n{log}", flush=True)
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return took


def load(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(lib_path(name)))
            _libs[name] = lib
        return lib


# -- the native host engine -------------------------------------------


def ln_tables_header() -> str:
    """``crush_ln_tables.h``: the straw2 ln tables as C arrays, from the
    port's ``crush/_ln_tables.py`` (the layout ``native/gen_ln_tables.py``
    writes)."""
    from .crush._ln_tables import LL_TBL, RH_LH_TBL

    def emit(name, values):
        lines = [f"static const uint64_t {name}[{len(values)}] = {{"]
        for i in range(0, len(values), 4):
            lines.append("    " + ", ".join(
                f"{v}ULL" for v in values[i:i + 4]) + ",")
        lines.append("};")
        return "\n".join(lines)

    return ("#pragma once\n#include <cstdint>\n\n"
            + emit("CRUSH_LL_TBL", LL_TBL) + "\n\n"
            + emit("CRUSH_RH_LH_TBL", RH_LH_TBL) + "\n")


def host_lib_path() -> pathlib.Path:
    h = hashlib.sha256(HOST_SOURCE.read_bytes())
    h.update(ln_tables_header().encode())
    h.update(" ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"libcrush_host-{h.hexdigest()[:16]}.so"


def build_host() -> float:
    """Compile the native engine if it is not built yet; returns the
    seconds it took.  Raises with the compiler's output if it fails."""
    out = host_lib_path()
    if out.exists():
        return 0.0
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the native CRUSH engine cannot "
                           "be built")
    t0 = time.perf_counter()
    stage = BUILD_DIR / f"{out.stem}.{os.getpid()}.{threading.get_ident()}"
    stage.mkdir(parents=True, exist_ok=True)
    try:
        (stage / "crush_ln_tables.h").write_text(ln_tables_header())
        src = stage / HOST_SOURCE.name
        shutil.copyfile(HOST_SOURCE, src)
        tmp = stage / out.name
        run = subprocess.run([gxx, *GXX_FLAGS, "-o", str(tmp), str(src)],
                             capture_output=True, text=True, timeout=600)
        if run.returncode != 0:
            raise RuntimeError(f"g++ crush_host exited {run.returncode}:\n"
                               f"{run.stdout}{run.stderr}")
        # one rename: a process building beside this one (the tests run
        # in several) never loads a half-written library
        os.replace(tmp, out)
    finally:
        shutil.rmtree(stage, ignore_errors=True)
    return time.perf_counter() - t0


def load_host() -> ctypes.CDLL:
    """The loaded native engine, built first if needed."""
    with _lock:
        lib = _libs.get("crush_host")
        if lib is None:
            build_host()
            lib = ctypes.CDLL(str(host_lib_path()))
            _libs["crush_host"] = lib
        return lib
