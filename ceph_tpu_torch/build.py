"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` source has a plain C interface.  It is compiled by
``nvcc`` for ``sm_90a`` into a shared library of its own, at first use,
into ``_build/`` beside this file (git ignores it), and loaded with
``ctypes``.  The library's name carries a digest of its source, the
headers beside it (``csrc/*.cuh``) and the flags, so an edited source
is never served by a stale build.  A build
or load that fails raises: nothing falls back to the CPU.
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

PKG = pathlib.Path(__file__).resolve().parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"

SOURCES = {
    "gf2_matmul_w8": CSRC / "gf2_matmul_w8.cu",
    "crush_rule": CSRC / "crush_rule.cu",
}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
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
