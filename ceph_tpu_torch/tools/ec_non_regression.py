"""EC non-regression corpus: archived encodings held across versions.

The port of ``ceph_tpu/tools/ec_non_regression.py``, the role of
src/test/erasure-code/ceph_erasure_code_non_regression.cc with the
ceph-erasure-code-corpus submodule: encode a fixed payload under a
profile, archive the chunks, and on every later version encode again
and compare byte for byte, then decode the archived chunks with each
one erased.  Entries live under ``tests/corpus/<slug>/``:
``profile.json``, ``data.bin`` and ``chunk.<i>``.

The codes run on ``--device`` (the card by default; cpu for the
kernels' plain versions); chunks are copied back only to be compared
with or written to files.  An entry whose code cannot be built fails
with the plugin's error.

Usage:
  python -m ceph_tpu_torch.tools.ec_non_regression --create \\
      --plugin jerasure -P k=4 -P m=2 [--base DIR] [--device cpu]
  python -m ceph_tpu_torch.tools.ec_non_regression --check \\
      [--base DIR] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

import numpy as np

from ..ec.interface import ErasureCodeError
from ..ec.registry import factory

DEFAULT_BASE = pathlib.Path(__file__).resolve().parents[2] \
    / "tests" / "corpus"
PAYLOAD_SIZE = 31 * 1024 + 7  # deliberately unaligned


def _payload(seed: int = 0xC0) -> bytes:
    return np.random.default_rng(seed).integers(
        0, 256, PAYLOAD_SIZE, dtype=np.uint8).tobytes()


def _slug(plugin: str, profile: dict) -> str:
    parts = [plugin] + [f"{k}={profile[k]}"
                        for k in sorted(profile) if k != "plugin"]
    return "-".join(parts).replace("/", "_")


def _bytes(chunk) -> bytes:
    return chunk.cpu().numpy().tobytes()


def create_entry(base: pathlib.Path, plugin: str, profile: dict,
                 device="cuda") -> pathlib.Path:
    code = factory(plugin, dict(profile), device=device)
    raw = _payload()
    n = code.get_chunk_count()
    chunks = code.encode(range(n), raw)
    entry = base / _slug(plugin, profile)
    entry.mkdir(parents=True, exist_ok=True)
    (entry / "profile.json").write_text(json.dumps(
        {"plugin": plugin, "profile": profile,
         "payload_size": len(raw)}, indent=1))
    (entry / "data.bin").write_bytes(raw)
    for i in range(n):
        (entry / f"chunk.{i}").write_bytes(_bytes(chunks[i]))
    return entry


def check_entry(entry: pathlib.Path, device="cuda") -> list:
    """Returns a list of failure strings (empty = pass)."""
    meta = json.loads((entry / "profile.json").read_text())
    code = factory(meta["plugin"], dict(meta["profile"]), device=device)
    raw = (entry / "data.bin").read_bytes()
    n = code.get_chunk_count()
    failures = []
    chunks = code.encode(range(n), raw)
    archived = {}
    for i in range(n):
        want = (entry / f"chunk.{i}").read_bytes()
        archived[i] = np.frombuffer(want, np.uint8)
        if _bytes(chunks[i]) != want:
            failures.append(f"{entry.name}: chunk {i} re-encode "
                            f"differs from archive")
    # decode the ARCHIVED chunks (what old clusters actually stored)
    for erased in range(n):
        avail = {i: c for i, c in archived.items() if i != erased}
        try:
            got = _bytes(code.decode_concat(avail))[:len(raw)]
        except ErasureCodeError as e:
            failures.append(f"{entry.name}: decode with chunk "
                            f"{erased} erased failed: {e}")
            continue
        if got != raw:
            failures.append(f"{entry.name}: decode with chunk "
                            f"{erased} erased returned wrong bytes")
    return failures


def check_all(base: pathlib.Path, device="cuda") -> list:
    """A gate that compared nothing must FAIL: a missing or empty
    corpus reports itself instead of passing vacuously.  An entry whose
    code cannot be built reports the plugin's error."""
    if not base.is_dir():
        return [f"corpus base {base} does not exist"]
    # only EC parity entries (marked by profile.json) belong to this
    # checker; tests/corpus/encodings/ is the wire corpus
    entries = sorted(p for p in base.iterdir()
                     if p.is_dir() and (p / "profile.json").exists())
    if not entries:
        return [f"corpus base {base} has no entries"]
    failures = []
    for entry in entries:
        try:
            failures.extend(check_entry(entry, device))
        except ErasureCodeError as e:
            failures.append(f"{entry.name}: error {e.errno}: {e}")
    return failures


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="ec_non_regression")
    p.add_argument("--base", default=str(DEFAULT_BASE))
    p.add_argument("--create", action="store_true")
    p.add_argument("--check", action="store_true")
    p.add_argument("--plugin", default="jerasure")
    p.add_argument("-P", "--parameter", action="append", default=[])
    p.add_argument("--device", default="cuda",
                   help="cuda (default: kernel K1) or cpu (its plain "
                        "version)")
    args = p.parse_args(argv)
    base = pathlib.Path(args.base)

    if args.create:
        profile = {}
        for kv in args.parameter:
            k, _, v = kv.partition("=")
            profile[k] = v
        entry = create_entry(base, args.plugin, profile, args.device)
        print(f"archived {entry}")
        return 0
    if args.check:
        failures = check_all(base, args.device)
        for f in failures:
            print(f"FAIL: {f}", file=sys.stderr)
        n = (sum(1 for p_ in base.iterdir() if p_.is_dir())
             if base.is_dir() else 0)
        print(f"checked {n} corpus entries: "
              f"{'FAIL' if failures else 'OK'}")
        return 1 if failures else 0
    p.print_help()
    return 1


if __name__ == "__main__":
    sys.exit(main())
