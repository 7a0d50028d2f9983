"""The port's host-sync lint (``ceph_tpu_torch.analysis.lint_torch``):
the port is clean under it, each rule fires on a snippet, the
suppression mark works, ``__init__`` is exempt, and the command line
exits 0 on the package and 1 on a bad file.  The repository's own
static lints (``tools/lint_*.py`` but the JAX one) find nothing in the
port either.
"""

import pathlib
import subprocess
import sys
import textwrap

import importlib

import pytest

from ceph_tpu_torch.analysis import lint_torch

REPO = pathlib.Path(__file__).resolve().parents[1]
HOT = "ceph_tpu_torch/ec/engine.py"       # a hot module's path
COLD = "ceph_tpu_torch/tools/tester.py"   # not a hot module


def _lint(src, rel=HOT):
    return lint_torch.lint_source(textwrap.dedent(src), rel)


def test_the_port_is_clean():
    vs = lint_torch.lint_paths([REPO / "ceph_tpu_torch"])
    assert vs == [], "\n".join(map(str, vs))


@pytest.mark.parametrize("lint", ["lint_async", "lint_concurrency",
                                  "lint_faults", "lint_obs", "lint_wire",
                                  "lint_config"])
def test_the_port_is_clean_under_the_repository_lints(lint):
    """``tools/lint_jax.py`` has no place here: the port has
    ``lint_torch``."""
    if str(REPO) not in sys.path:
        sys.path.insert(0, str(REPO))
    mod = importlib.import_module(f"tools.{lint}")
    vs = mod.lint_paths([REPO / "ceph_tpu_torch"])
    assert vs == [], "\n".join(map(str, vs))


def test_hot_modules_exist():
    for rel in lint_torch.HOT_MODULES:
        assert (REPO / "ceph_tpu_torch" / rel).is_file(), rel


SYNCS = [
    "n = x.item()",
    "rows = x.tolist()",
    "h = x.cpu()",
    "a = x.numpy()",
    "torch.cuda.synchronize()",
    "torch.cuda.current_stream().synchronize()",
    "ev.synchronize()",
    "n = int(x.sum())",
    "f = float(torch.mean(x))",
    "b = bool(mask.any())",
    "n = int(lens.max()) + 1",
    "c = torch.bincount(flat, minlength=9)",
    "i = x.nonzero()",
    "s = torch.masked_select(x, mask)",
    "u = torch.unique(x)",
    "y = x[x > 0]",
    "y = x[~mask]",
    "y = x[:, mask & (x < 3)]",
]


@pytest.mark.parametrize("stmt", SYNCS)
def test_torch002_fires_in_a_hot_module(stmt):
    src = f"def f(x, mask, lens, ev):\n    {stmt}\n"
    (v,) = _lint(src)
    assert v.code == "TORCH002" and v.line == 2


@pytest.mark.parametrize("stmt", SYNCS)
def test_torch002_is_quiet_in_other_modules(stmt):
    assert _lint(f"def f(x, mask, lens, ev):\n    {stmt}\n", COLD) == []


@pytest.mark.parametrize("stmt", [
    "n = int(n_items)", "n = int(x.shape[0])", "f = float('1.5')",
    "b = bool(flag)", "n = len(rows)", "k = x.numel()",
    "u = np.unique(rows)", "y = x[n_items & 3]", "y = x[rows]"])
def test_torch002_host_values_are_not_syncs(stmt):
    assert _lint(f"def f(x, n_items, flag, rows):\n    {stmt}\n") == []


@pytest.mark.parametrize("stmt", SYNCS)
def test_sync_ok_mark_suppresses(stmt):
    src = f"def f(x, mask, lens, ev):\n    {stmt}  # sync-ok: once a map\n"
    assert _lint(src) == []


def test_init_bodies_are_exempt():
    src = """
    class C:
        def __init__(self, x):
            self.n = int(x.sum())
            self.rows = x.tolist()

        def hot(self, x):
            return x.tolist()
    """
    (v,) = _lint(src)
    assert v.code == "TORCH002" and v.line == 8


@pytest.mark.parametrize("rel", [HOT, COLD])
def test_torch001_device_call_under_a_lock(rel):
    src = """
    def f(self, x):
        with self._qlock:
            y = torch.zeros(4)
        z = torch.ones(4)
        with self._lock:
            def later():
                return torch.ones(2)
        return later
    """
    (v,) = _lint(src, rel)
    assert v.code == "TORCH001" and v.line == 4 and "line 3" in v.message


def test_torch001_in_a_messenger_handler():
    src = """
    def _h_write(self, msg):
        return torch.as_tensor(msg.data)

    def write(self, msg):
        return torch.as_tensor(msg.data)
    """
    (v,) = _lint(src, COLD)
    assert v.code == "TORCH001" and v.line == 3


def test_torch001_suppressed_on_the_with_line():
    src = """
    def f(self):
        with self.mutex:  # sync-ok: the launch is the guarded state
            return torch.zeros(1)
    """
    assert _lint(src, COLD) == []


def test_syntax_error_is_reported():
    (v,) = _lint("def f(:\n")
    assert v.code == "TORCH000"


def test_command_line(tmp_path):
    ok = subprocess.run([sys.executable, "-m",
                         "ceph_tpu_torch.analysis.lint_torch"],
                        cwd=str(REPO), capture_output=True, text=True,
                        timeout=120)
    assert ok.returncode == 0 and "clean" in ok.stdout
    bad = tmp_path / "ec" / "engine.py"
    bad.parent.mkdir()
    bad.write_text("def f(x):\n    return x.item()\n")
    out = subprocess.run([sys.executable, "-m",
                          "ceph_tpu_torch.analysis.lint_torch",
                          str(tmp_path)], cwd=str(REPO),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 1 and "TORCH002" in out.stdout
