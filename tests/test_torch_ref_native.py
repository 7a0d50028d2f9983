"""``ceph_tpu``'s native library (``native/libcrush_host.so``), loaded
safely while several test processes start at once.

``ceph_tpu.crush.native.ensure_built`` runs ``make`` in ``native/`` and
loads the library it writes in place.  In a fresh checkout the test
workers start together: one worker's ``make`` can still be writing the
library when another's ``make`` finds it present and that worker loads
the half-written file.  ``ensure_built`` then gives up on the native
engine for the rest of that process, and every later test there that
holds the port to ``ceph_tpu``'s native mapper or GF engine fails with
"native crush mapper unavailable".

``ensure_ref_native`` serialises the port's test processes on a lock of
the Makefile, waits while another process's build is under way (the
table header is written, the library not yet), and when a load failed
because a build elsewhere replaced the file under it, lets
``ensure_built`` try again once that build is done.  The port test
files that call ``ceph_tpu``'s native code import ``ref_native_built``,
autouse.
"""

import fcntl
import json
import time

import numpy as np
import pytest

from ceph_tpu.crush import native as ref_native

BUILD_WAIT_S = 300


def ensure_ref_native():
    """The loaded ``ceph_tpu`` native library; raises if it cannot be
    built within ``BUILD_WAIT_S``."""
    header = ref_native.NATIVE_DIR / "crush_ln_tables.h"
    deadline = time.monotonic() + BUILD_WAIT_S
    while True:
        with open(ref_native.NATIVE_DIR / "Makefile", "rb") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            settle = time.monotonic() + 30
            while header.exists() and not ref_native.LIB_PATH.exists() \
                    and time.monotonic() < settle:
                time.sleep(0.2)  # another process is compiling it
            lib = ref_native.ensure_built()
        if lib is not None:
            return lib
        if time.monotonic() > deadline:
            raise RuntimeError("ceph_tpu's native library did not build")
        # the load failed on a library another process was still writing;
        # the flag would keep this process off the native engine for good
        ref_native._build_failed = False
        time.sleep(0.5)


@pytest.fixture(scope="module", autouse=True)
def ref_native_built():
    ensure_ref_native()


def test_ref_native_loads_and_maps():
    """Loaded once, the library stays loaded and maps a golden map's
    rule as the port's native engine does."""
    from ceph_tpu.crush.map import CrushMap as JCrushMap
    from ceph_tpu_torch.crush import native as p_native
    from ceph_tpu_torch.crush.map import CrushMap
    from conftest import GOLDEN_DIR

    lib = ensure_ref_native()
    assert lib is ref_native.ensure_built()
    d = json.loads((GOLDEN_DIR / "map_tree3.json").read_text())["map"]
    cmap = CrushMap.from_dict(d)
    xs = np.arange(512, dtype=np.uint32)
    weight = np.full(cmap.max_devices, 0x10000, np.uint32)
    jres, jlens = ref_native.NativeMapper(JCrushMap.from_dict(d)).map_batch(
        0, xs, 3, weight)
    res, lens = p_native.NativeMapper(cmap).map_batch(0, xs, 3, weight)
    assert np.array_equal(lens, jlens) and np.array_equal(res, jres)
