#!/usr/bin/env python
"""Host-sync lint of the port — the counterpart of ``tools/lint_jax.py``.

AST checks for the bug classes that never fail a test but serialise the
card behind the host:

TORCH001  a ``torch.*`` call lexically inside a ``with <lock>`` block or
          inside a messenger handler (a function named ``_h_*``).  A
          launch, an allocation or a copy there can block on the card
          (or on a kernel build) while every thread waits on the lock.

TORCH002  a host sync in a hot module: ``.item()``, ``.tolist()``,
          ``.cpu()``, ``.numpy()``, ``.synchronize()`` (and
          ``torch.cuda.synchronize``), ``bincount`` (on the card it
          reads its input's max and min back to the host), ``nonzero``,
          ``masked_select`` and ``unique`` (their output's length is
          read back), indexing by a mask written in place (``x[a > b]``,
          ``x[~m]``, ``x[~m & (a < b)]``: a mask held in a name is not
          seen), and ``float()``/``int()``/``bool()`` of a tensor
          expression (one that calls ``torch.*`` or a reduction method
          such as ``.sum()`` or ``.any()``).  Each drains the launch queue and
          turns an overlapped pipeline into lockstep.  ``__init__``
          bodies are exempt (setup is not the hot path).

Suppression: ``# sync-ok: <reason>`` on the flagged line (for TORCH001
also on the ``with`` or ``def`` line).  The reason is the record of why
the sync is deliberate.

Usage:
    python -m ceph_tpu_torch.analysis.lint_torch [paths...]
                                        # default: the ceph_tpu_torch package
Exit status 1 when violations are found.
"""

from __future__ import annotations

import ast
import pathlib
import sys
from dataclasses import dataclass
from typing import Iterable, List, Optional

SUPPRESS_MARK = "sync-ok:"

# modules where a host sync is a throughput bug: the EC engine and its
# kernels' wrappers, the CRUSH mappers, the pipeline and the mesh plane
HOT_MODULES = (
    "ec/engine.py",
    "ec/gf2_kernels.py",
    "ec/gf2_packet.py",
    "crush/mapper.py",
    "crush/mapper_spec.py",
    "crush/ln.py",
    "crush/hash.py",
    "osdmap/pipeline.py",
    "parallel/placement.py",
)

_SYNC_METHODS = {"item", "tolist", "cpu", "numpy", "synchronize",
                 "bincount", "nonzero", "masked_select", "unique",
                 "unique_consecutive"}
_SCALAR_CASTS = {"float", "int", "bool"}
# methods whose result is a tensor reduction: a cast of one is a sync
_REDUCTIONS = {"sum", "max", "min", "any", "all", "mean", "prod",
               "count_nonzero", "argmax", "argmin", "norm", "amax", "amin"}
# lock-ish context-manager spellings (as tools/lint_jax.py)
LOCKISH_MARKERS = ("lock", "_cv", "_cond", "_serial", "mutex")


@dataclass
class Violation:
    path: str
    line: int
    code: str
    message: str

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: {self.code} {self.message}"


def _suppressed(src_lines: List[str], *linenos: int) -> bool:
    return any(1 <= ln <= len(src_lines) and SUPPRESS_MARK in src_lines[ln - 1]
               for ln in linenos)


def _is_lockish(expr: ast.AST) -> bool:
    tail = ast.unparse(expr).split("(", 1)[0].rsplit(".", 1)[-1].lower()
    return any(m in tail for m in LOCKISH_MARKERS)


def _dotted_root(expr: ast.AST) -> Optional[str]:
    while isinstance(expr, ast.Attribute):
        expr = expr.value
    if isinstance(expr, ast.Call):
        return _dotted_root(expr.func)
    return expr.id if isinstance(expr, ast.Name) else None


def _is_torch_call(node: ast.Call) -> bool:
    return isinstance(node.func, ast.Attribute) and \
        _dotted_root(node.func) == "torch"


def _is_numpy_function(f: ast.Attribute) -> bool:
    """``np.unique`` and the like: a host function, not a tensor's."""
    return isinstance(f.value, ast.Name) and f.value.id in ("np", "numpy")


def _mask_expr(expr: ast.AST) -> bool:
    """Is ``expr`` a boolean mask written in place: a comparison, an
    inversion, or ``&``/``|``/``^`` of them."""
    if isinstance(expr, ast.Compare):
        return True
    if isinstance(expr, ast.UnaryOp):
        return isinstance(expr.op, ast.Invert)
    if isinstance(expr, ast.BinOp) and \
            isinstance(expr.op, (ast.BitAnd, ast.BitOr, ast.BitXor)):
        return _mask_expr(expr.left) or _mask_expr(expr.right)
    return False


def _tensor_expr(expr: ast.AST) -> bool:
    """Does ``expr`` compute a tensor: a ``torch.*`` call or a reduction
    method call anywhere in it."""
    for sub in ast.walk(expr):
        if isinstance(sub, ast.Call):
            if _is_torch_call(sub):
                return True
            if isinstance(sub.func, ast.Attribute) and \
                    sub.func.attr in _REDUCTIONS:
                return True
    return False


class _FileLinter(ast.NodeVisitor):
    def __init__(self, rel: str, src: str):
        self.rel = rel
        self.lines = src.splitlines()
        self.out: List[Violation] = []
        self.hot = any(rel.endswith(m) for m in HOT_MODULES)
        self._with_lock_stack: List[int] = []
        self._handler_stack: List[int] = []   # def lines of _h_* handlers
        self._init_depth = 0

    def _emit(self, code: str, node: ast.AST, message: str,
              *extra_lines: int) -> None:
        if not _suppressed(self.lines, node.lineno, *extra_lines):
            self.out.append(Violation(self.rel, node.lineno, code, message))

    def visit_Call(self, node: ast.Call) -> None:
        if _is_torch_call(node):
            if self._with_lock_stack:
                self._emit(
                    "TORCH001", node,
                    f"device call {ast.unparse(node.func)!r} while a lock "
                    f"is held (with-block at line "
                    f"{self._with_lock_stack[-1]}): a launch or copy can "
                    f"block every thread behind this lock",
                    self._with_lock_stack[-1])
            elif self._handler_stack:
                self._emit(
                    "TORCH001", node,
                    f"device call {ast.unparse(node.func)!r} inside a "
                    f"messenger handler: device work on a dispatch worker "
                    f"blocks the daemon's message plane",
                    self._handler_stack[-1])
        if self.hot and not self._init_depth:
            f = node.func
            if isinstance(f, ast.Attribute) and f.attr in _SYNC_METHODS \
                    and not _is_numpy_function(f):
                self._emit("TORCH002", node,
                           f"host sync {ast.unparse(f)!r}() in a hot "
                           f"module: drains the launch queue")
            elif isinstance(f, ast.Name) and f.id in _SCALAR_CASTS and \
                    node.args and _tensor_expr(node.args[0]):
                self._emit("TORCH002", node,
                           f"{f.id}() of a tensor in a hot module: a "
                           f"device-to-host read of a scalar")
        self.generic_visit(node)

    def visit_Subscript(self, node: ast.Subscript) -> None:
        if self.hot and not self._init_depth:
            idx = node.slice
            parts = idx.elts if isinstance(idx, ast.Tuple) else [idx]
            if any(_mask_expr(p) for p in parts):
                self._emit("TORCH002", node,
                           f"mask index {ast.unparse(idx)!r} in a hot "
                           f"module: the selection's length is read back "
                           f"to the host")
        self.generic_visit(node)

    def visit_With(self, node: ast.With) -> None:
        lockish = any(_is_lockish(item.context_expr) for item in node.items)
        for item in node.items:
            self.visit(item)
        if lockish:
            self._with_lock_stack.append(node.lineno)
        for stmt in node.body:
            self.visit(stmt)
        if lockish:
            self._with_lock_stack.pop()

    def _visit_function(self, node) -> None:
        is_handler = node.name.startswith("_h_")
        is_init = node.name == "__init__"
        # a nested def is a fresh frame: locks held around the def are
        # not held when it runs
        saved, self._with_lock_stack = self._with_lock_stack, []
        if is_handler:
            self._handler_stack.append(node.lineno)
        self._init_depth += is_init
        self.generic_visit(node)
        self._init_depth -= is_init
        if is_handler:
            self._handler_stack.pop()
        self._with_lock_stack = saved

    visit_FunctionDef = _visit_function
    visit_AsyncFunctionDef = _visit_function


def lint_source(src: str, rel: str) -> List[Violation]:
    """Lint one module's source as if it lived at ``rel`` (a path whose
    tail decides whether it is a hot module)."""
    try:
        tree = ast.parse(src, filename=rel)
    except SyntaxError as e:
        return [Violation(rel, e.lineno or 0, "TORCH000",
                          f"unparseable: {e.msg}")]
    linter = _FileLinter(rel, src)
    linter.visit(tree)
    return sorted(linter.out, key=lambda v: v.line)


def lint_paths(paths: Iterable[pathlib.Path]) -> List[Violation]:
    out: List[Violation] = []
    for p in map(pathlib.Path, paths):
        files = sorted(p.rglob("*.py")) if p.is_dir() else [p]
        root = p.parent if p.is_dir() else None
        for f in files:
            rel = str(f.relative_to(root)) if root else str(f)
            out.extend(lint_source(f.read_text(), rel))
    return out


def package_root() -> pathlib.Path:
    return pathlib.Path(__file__).resolve().parents[1]


def main(argv: List[str]) -> int:
    targets = [pathlib.Path(a) for a in argv] or [package_root()]
    violations = lint_paths(targets)
    for v in violations:
        print(v)
    if violations:
        print(f"{len(violations)} host-sync lint violation(s)")
        return 1
    print("host-sync lint clean")
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
