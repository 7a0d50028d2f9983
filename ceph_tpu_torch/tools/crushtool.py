"""crushtool: compile, decompile, test and build crush maps.

The port of ``ceph_tpu/tools/crushtool.py`` (the role of
src/tools/crushtool.cc:365-1333), with its verbs, files and output:

  -c <text>  -o <out.json>    compile a text map to a JSON map
  -d <map>   [-o <out.txt>]   decompile to text
  -i <map> --test [...]       the CrushTester sweep
  -i <map> --compare <map2>   the mapping diff between two maps
  -i <map> --build --num-osds N layer1 straw2 4 layer2 straw2 0 ...
  -i <map> --reweight         recompute bucket weights bottom-up
  -i <map> --tree             topology dump (the CrushTreeDumper role)
  -i <map> --create-replicated-rule NAME ROOT TYPE [--device-class C]

Map files are ``CrushWrapper.to_dict()`` JSON (or text maps), the same
files ``ceph_tpu``'s tool reads and writes.  ``--test`` and
``--compare`` sweep on ``--device`` (default ``cuda``: kernel K2;
without a card the tool fails unless ``--device cpu`` is given, which
runs the plain walk); ``--scalar`` (the scalar ``mapper_ref``) and
``--native`` (the native C++ engine) are CPU engines and never ask for
a card.

Usage: python -m ceph_tpu_torch.tools.crushtool ...
"""

from __future__ import annotations

import argparse
import json
import sys

from ..crush.builder import build_hierarchy
from ..crush.map import CrushMap
from ..crush.wrapper import CrushWrapper
from .compiler import compile_crushmap, decompile_crushmap
from .tester import CrushTester, format_report


def load_map(path: str) -> CrushWrapper:
    with open(path) as f:
        content = f.read()
    stripped = content.lstrip()
    if stripped.startswith("{"):
        d = json.loads(content)
        if "map" in d:
            return CrushWrapper.from_dict(d)
        return CrushWrapper(CrushMap.from_dict(d))
    return compile_crushmap(content)


def save_map(w: CrushWrapper, path: str) -> None:
    with open(path, "w") as f:
        json.dump(w.to_dict(), f)


def cmd_build(args) -> CrushWrapper:
    """--build: synthetic uniform hierarchy (crushtool.cc:135)."""
    w = CrushWrapper(CrushMap(), types={0: "osd"})
    spec = []
    layers = args.layers
    if len(layers) % 3:
        raise SystemExit("--build layers: <name> <alg> <size> triples")
    for i in range(0, len(layers), 3):
        name, alg, size = layers[i], layers[i + 1], int(layers[i + 2])
        if alg != "straw2":
            raise SystemExit(f"--build: only straw2 supported, "
                             f"got {alg}")
        type_id = i // 3 + 1
        w.set_type_name(type_id, name)
        spec.append((type_id,
                     size if size > 0 else args.num_osds))
    # fan-outs: size 0 means "all remaining" (one root)
    n = args.num_osds
    fixed = []
    for type_id, size in spec:
        if size == 0 or size >= n:
            fixed.append((type_id, n))
            n = 1
        else:
            fixed.append((type_id, size))
            n = (n + size - 1) // size
    root = build_hierarchy(w.crush, fixed)
    w.set_item_name(root, layers[-3] if layers else "root")
    for d in range(args.num_osds):
        w.set_item_name(d, f"osd.{d}")
    return w


def cmd_tree(w: CrushWrapper, out) -> None:
    """CrushTreeDumper-style topology listing."""
    def walk(bid: int, depth: int):
        name = w.get_item_name(bid)
        if bid >= 0:
            weight = 0
            p = w.get_immediate_parent_id(bid)
            if p is not None:
                b = w.get_bucket(p)
                weight = b.item_weight_at(b.items.index(bid))
            cls = w.get_item_class(bid)
            out.write(f"{'  ' * depth}{bid}\t{weight / 0x10000:.5f}"
                      f"\t{name}{' class ' + cls if cls else ''}\n")
            return
        b = w.get_bucket(bid)
        out.write(f"{'  ' * depth}{bid}\t{b.weight / 0x10000:.5f}"
                  f"\t{w.get_type_name(b.type)} {name}\n")
        for child in b.items:
            walk(child, depth + 1)

    roots = [b.id for b in w.crush.buckets.values()
             if w.get_immediate_parent_id(b.id) is None
             and b.id not in w._shadow_ids]
    for r in sorted(roots, reverse=True):
        walk(r, 0)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="crushtool")
    p.add_argument("-i", "--infn", help="input map (json or text)")
    p.add_argument("-o", "--outfn", help="output file")
    p.add_argument("-c", "--compile", dest="compilefn",
                   help="compile text map")
    p.add_argument("-d", "--decompile", dest="decompilefn",
                   help="decompile map")
    p.add_argument("--test", action="store_true")
    p.add_argument("--compare", help="second map to compare against")
    p.add_argument("--build", action="store_true")
    p.add_argument("--num-osds", type=int, default=0)
    p.add_argument("layers", nargs="*",
                   help="--build: <name> <alg> <size> triples")
    p.add_argument("--reweight", action="store_true")
    p.add_argument("--tree", action="store_true")
    p.add_argument("--create-replicated-rule", nargs=3,
                   metavar=("NAME", "ROOT", "FAILURE_DOMAIN"),
                   help="add a simple replicated rule "
                        "(crushtool.cc:1161 add_rule verb)")
    p.add_argument("--device-class", default="",
                   help="device class for --create-replicated-rule")
    # tester flags (crushtool.cc --test family)
    p.add_argument("--rule", type=int, default=-1)
    p.add_argument("--num-rep", type=int, default=0)
    p.add_argument("--min-rep", type=int, default=0)
    p.add_argument("--max-rep", type=int, default=0)
    p.add_argument("--min-x", type=int, default=0)
    p.add_argument("--max-x", type=int, default=1023)
    p.add_argument("--pool", type=int, default=None)
    p.add_argument("--weight", nargs=2, action="append", default=[],
                   metavar=("DEV", "WEIGHT"))
    p.add_argument("--show-utilization", action="store_true")
    p.add_argument("--show-statistics", action="store_true")
    p.add_argument("--show-mappings", action="store_true")
    p.add_argument("--show-bad-mappings", action="store_true")
    p.add_argument("--scalar", action="store_true",
                   help="sweep with the scalar mapper_ref on the CPU")
    p.add_argument("--native", action="store_true",
                   help="sweep with the native C++ engine on the CPU "
                        "(built with g++ at first use)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu: where the other sweeps "
                        "run")
    args = p.parse_args(argv)

    if args.compilefn:
        with open(args.compilefn) as f:
            w = compile_crushmap(f.read())
        save_map(w, args.outfn or "crushmap.json")
        return 0

    if args.decompilefn:
        w = load_map(args.decompilefn)
        text = decompile_crushmap(w)
        if args.outfn:
            with open(args.outfn, "w") as f:
                f.write(text)
        else:
            sys.stdout.write(text)
        return 0

    if args.build:
        if not args.num_osds:
            raise SystemExit("--build requires --num-osds")
        w = cmd_build(args)
        save_map(w, args.outfn or "crushmap.json")
        return 0

    if not args.infn:
        p.print_help()
        return 1
    w = load_map(args.infn)

    if args.create_replicated_rule:
        name, root, fd = args.create_replicated_rule
        w.add_simple_rule(name, root, fd, args.device_class, "firstn")
        save_map(w, args.outfn or args.infn)
        return 0

    if args.reweight:
        w.reweight()
        save_map(w, args.outfn or args.infn)
        return 0

    if args.tree:
        cmd_tree(w, sys.stdout)
        return 0

    if args.compare:
        other = load_map(args.compare)
        ta, tb = CrushTester(w), CrushTester(other)
        rules = [args.rule] if args.rule >= 0 \
            else sorted(w.crush.rules)
        for rno in rules:
            nrep = args.num_rep or 3
            diff, total = ta.compare(tb, rno, nrep, args.min_x,
                                     args.max_x, scalar=args.scalar,
                                     native=args.native,
                                     device=args.device)
            print(f"rule {rno}: {diff}/{total} mappings differ "
                  f"({100.0 * diff / max(1, total):.2f}%)")
        return 0

    if args.test:
        tester = CrushTester(w)
        for dev, wt in args.weight:
            tester.set_device_weight(int(dev), float(wt))
        rules = [args.rule] if args.rule >= 0 \
            else sorted(w.crush.rules)
        if not rules:
            print("crushtool: map has no rules; nothing to test "
                  "(use --create-replicated-rule)", file=sys.stderr)
            return 1
        min_rep = args.min_rep or args.num_rep or 3
        max_rep = args.max_rep or args.num_rep or 3
        for rno in rules:
            for nrep in range(min_rep, max_rep + 1):
                rep = tester.test_rule(
                    rno, nrep, args.min_x, args.max_x,
                    pool=args.pool, scalar=args.scalar,
                    native=args.native,
                    collect_mappings=args.show_mappings,
                    device=args.device)
                print(format_report(
                    rep, w,
                    show_utilization=args.show_utilization,
                    show_statistics=args.show_statistics,
                    show_bad_mappings=args.show_bad_mappings,
                    show_mappings=args.show_mappings))
        return 0

    p.print_help()
    return 1


if __name__ == "__main__":
    sys.exit(main())
