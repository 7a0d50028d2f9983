#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (``ceph_tpu_torch``) on one NVIDIA GPU
and check every kernel of its main path.

Run from the root of the repository:

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. Build the CUDA kernels from ``ceph_tpu_torch/csrc`` (one nvcc each,
   started together).
   It prints ptxas' register report and K1's SASS instruction mix.
2. K1 ``gf2_matmul_w8`` against its plain PyTorch version on the card,
   byte for byte: (k, m, L) in {(4,2,512), (8,3,2048), (8,3,777),
   (8,3,4 MiB)}, a batch of odd-length stripes, the 64x64 decode
   inverse for erasures [0, 1], random 0/1 bit matrices at (k, m) in
   {(8,3), (8,8), (8,16), (32,32), (5,7)} (L = 777, 4096, 65,552 and a
   batch),
   all 55 2-erasure inverses of RS(8,3) at L = 777 with the survivors
   as separate tensors, survivors at odd offsets of one buffer, and
   the main path's two shapes (encode of 4 x 8 x 1 MiB, decode of
   8 x 4 MiB).
3. K2 ``crush_rule_batched`` against its plain version on ``map_big10k``
   (rules 0 and 1) for 4,096 random xs and for the main path's 65,536
   PGs, on a copy of the map whose straw2 draws tie (``tie_map``) for
   the same 65,536 PGs, then against every golden case of all nine
   maps in ``tests/golden`` (every bucket algorithm, choose_args,
   legacy tunables).  Then three full-size variants of ``map_big10k``
   (10,000 OSDs, 521 buckets), with 2% of OSDs out and 1% at half
   weight: ``map_big10k_mixed`` (hosts uniform, list, tree and straw in
   turn, straw racks, straw2 root) under optimal and under legacy
   tunables, and ``map_big10k`` with a crush-compat choose_args set (1
   weight set for rule 0, 11 for rule 1).  For each, rules 0 and 1 over
   65,536 PGs: K2 equal to the plain version on all of them and to the
   port's scalar ``mapper_ref`` on the first 4,096, then timed beside
   the all-straw2 map.
4. The main path at full width, with every launch counter set to 0
   first: the flagship step (CRUSH ``map_big10k`` rule 0, numrep 3, over
   65,536 PGs, plus RS(8,3) ``encode_batched`` of 4 stripes x 8 x 1 MiB)
   for 8 iterations, rule 1 (numrep 11) over the same PGs, and RS
   ``decode`` of erasures [0, 1], each timed on the host clock and
   encode and decode also by CUDA events per call.  The decode must
   give the data back and allocate no more than its k x L output (the
   survivors are read in place), and the first 256 PGs of both rules
   must match the golden vectors (as ``bench.py:_golden_check`` does).
5. The placement pipeline, with the launch counters set to 0 again: an
   OSDMap on ``map_big10k`` (2% of OSDs down, 1% out, 0.5% at weight
   0x8000, 5% with a primary affinity), a replicated pool (size 3, rule
   0, 262,144 PGs) and an EC 8+3 pool (size 11, rule 1, 65,536 PGs,
   pgp_num 49,152), pg_upmap_items on 1% of the PGs, pg_upmap on 0.1%,
   pg_temp on 1%, primary_temp on 0.1%, some aimed at out OSDs.
   ``PoolMapper.map_all`` on the card must equal the scalar
   ``OSDMap.pg_to_up_acting_osds`` on every PG with an entry and 4,096
   more per pool, again after an upmap edit and ``refresh_tables``;
   then ``map_all`` is timed per pool (PGs/s).
6. The upmap balancer, with K2's launch count set to 0 again.  (a)
   ``run_offline`` (max_deviation 1, 10 iterations, 3 rounds, seed 10,
   patience 2) on ``make_synthetic_map``'s 1,000 OSDs (250 hosts, 25
   racks, 1x/2x/4x weights, ssd and hdd classes: pool 1 of 32,768 PGs on
   the plain rule, pools 2 and 3 of 8,192 on the class rules, through
   the shadow trees), on the card and then, in a worker, on the CPU
   (the plain walk; started after the card's run is timed and waited
   for before (b), so no timed part shares the host with it): the
   records must be equal but for their host-clock fields, and so must the final pg_upmap_items; every changed PG (up
   to 4,096 a pool) of mappers built before the run must, after
   ``refresh_tables``, equal the scalar pipeline; before the run K2
   must equal its plain walk on each pool (the shadow trees).  (b) On
   phase 5's cluster through its cached mappers: ``evaluate`` of both
   pools, an upmap edit, ``evaluate`` again, then ``calc_pg_upmaps``
   (max_deviation 5, 10 iterations, pool 1: osdmaptool's defaults);
   the changed PGs must equal the scalar pipeline and pool 1's stddev
   must fall if anything changed.  Each part's time is split into
   ``map_all`` (CUDA events), the host tally and the optimizer's search.
7. crushtool on ``map_big10k``, with K2's count at 0: ``CrushTester``
   sweeps of rule 0 over 1 M PGs and rule 1 over 262,144, every row held
   to the native engine and the plain walk, reports and text equal to
   ``--native``; ``--pool``, ``--compare`` and the sample map built with
   crushtool's own verbs.
8. The EC plugins, with K1's count at 0: ``ec_benchmark --verify`` on
   the card for seven profiles (``BASELINE.json`` configs 2-4: jerasure
   reed_sol_van 4+2, isa 8+3, lrc 4/2/3; the corpus's shec 4/3/2 and
   clay 4+2; isa cauchy 8+3, jerasure reed_sol_r6_op 8+2): encode of a
   4 MiB object 100 times, decode of 100 random single erasures and of
   every set of m erasures (c for SHEC); ``encode_batched`` of 64 x 4
   MiB objects (isa 8+3); ``ec_non_regression --check`` of the five w=8
   corpus directories.  Then, with the kernel's calls tapped and not
   counted: every
   chunk of those encodes and decodes equal to the same profile on the
   native engine (SHEC, which has none, on the CPU) and to the object,
   and the first 64 KiB columns of every K1 product equal to its plain
   version on the card; each call's K1 launches replayed in a CUDA
   graph for their device time, the object's copy to the card timed
   apart.  Last, each plugin's ``create_rule`` (and an LRC rule with
   locality and an isa rule on a device class) on ``map_big10k``, 65,536
   PGs through K2 equal to the native engine.
9. The other EC layouts and the speculative mapper.  With K1's and K3's
   counts at 0: ``ec_benchmark --verify`` on the card (encode and random
   single-erasure decodes of a 4 MiB object, 50 calls each) for
   ``ceph_tpu``'s ten-point jerasure grid (w=8, w=16/32 words on K1 over
   virtual chunks, the five packet techniques on K3), SHEC at w=16 and
   w=32, an LRC layer and Clay's sub-codes on cauchy_good, and
   ``ec_non_regression --check`` of the packet corpus directory.  Then,
   with the kernels' calls tapped and not counted: each profile on the
   card equal to the same profile on the CPU for a 64 KiB object (every
   erasure of up to m chunks on one profile a layout: w=16, w=32,
   packets, SHEC w=16), a 4 MiB object encoded and decoded back, every K3
   product and each K1 product's first columns equal to the plain
   version; K3 at each vector width it is built for (16, 8, 4, 2, 1
   bytes: batched stripes, packet size 6, rows at odd offsets) against
   its plain version; each call's launches replayed in a CUDA graph; K3
   alone at a 4 MiB object (cauchy_good k=4 m=3, packet sizes 8 and 2048, encode
   and decode) and the word route's copies and K1 apart.  Last, with
   K2's count at 0, ``flagship.spec_cross_check``: the speculative
   mapper on ``map_big10k`` rule 0 over 65,536 PGs equal to K2 and to
   the golden rows; K=8, rule 1 and the tie map too; both timed, with
   the speculative mapper's rounds and host syncs.

10. The mesh data plane, with every launch count at 0, on ``map_big10k``
   and 4 MiB objects, each over a one-device mesh and over [cuda:0,
   cuda:0] (two shards on the one card): ``PlacementPlane.map_batch``
   (rule 0, numrep 3, 1,048,576 xs, with the tally) equal to
   ``BatchedMapper`` plus ``utilization`` and to the golden rows, one
   and two K2 launches a call; ``encode_batched_sharded`` of RS(8,3) on
   [64, 8, 512 KiB] equal to ``encode_batched``, one and two K1
   launches; both timed by CUDA events beside the host time the device
   plane booked, K2 and K1 alone and their bounds.  Then over the two
   shards: ``ErasureCode.encode_batched(mesh=)`` of 64 x 4 MiB objects
   (isa 8+3 on K1, jerasure cauchy_good 4+2 packetsize 8 on K3),
   ``PoolMapper(mesh=)`` on phase 5's cluster (pools 1 and 2) and
   ``CrushTester.test_rule(mesh=)`` over 1 M PGs, each equal to the call
   without a mesh; the ``EncodeBatcher`` under 16 threads of 4 writes
   (isa 8+3, every chunk equal to ``encode``); ``contracts.verify_all``
   and the steady-state gate on the card (not counted); last the device
   plane's report (``per_device``, ``mesh_device_report``, the counter
   dump).

11. Map epochs and the stores, with every launch count at 0, on phase
   5's cluster: a primary map makes 24 epochs (OSDs down, then out, a
   host down, out and back, reweights, primary affinity, pg_upmap_items,
   pg_upmap, pg_temp and primary_temp set and removed, the EC pool's
   pgp_num raised, a host's CRUSH weight halved, 8 OSDs added to the
   CRUSH map, a third pool created and deleted; every ``Incremental``
   field filled), each a ``diff_maps`` delta in its versioned envelope,
   every 8th epoch also the full map's bincode, committed one
   ``KVTransaction`` an epoch to a ``KeyValueDB`` over a ``WALStore``
   (a checkpoint after 12).  The store is mounted again without its
   final checkpoint and replayed: every blob equal to the one written;
   ``objectstore_tool --op list`` on a copy lists it.  A follower starts
   from the store's first full map and, for each later epoch, decodes
   and applies the delta, keeps, refreshes or rebuilds its
   ``PoolMapper`` of each pool (a kept or refreshed one lowers nothing:
   the same ``prog``, ``arrays`` and ``pool``, no ``encode_map`` or
   ``compile_rule``) and runs ``map_all`` on the card.  After every
   epoch its rows equal those of a fresh ``PoolMapper`` of the primary's
   map through its bytes, on every PG of every pool, and the scalar
   ``pg_to_up_acting_osds`` (CRUSH stage on the native engine; 64 PGs a
   pool through mapper_ref itself) on the epoch's exception PGs, up to
   2,048 on changed OSDs and 2,048 random ones; its map encodes to the
   primary's bytes.  Then a second follower, with the oracle's workers
   idle, times each epoch on the host clock (decode, apply, the mappers,
   ``map_all`` of every pool), and ``map_all`` and K2 per pool by CUDA
   events.

12. Client EC writes over the wire, with K1's and K3's counts at 0
   before each run: a lossless primary ``Messenger`` built from a port
   ``Context`` (its Config, tracer and perf collection, an admin socket,
   a ``Throttle`` on ``ec_write``) and 16 lossy client messengers.  For
   isa 8+3 (K1) and jerasure cauchy_good 4+2 packetsize 8 (K3), 1, 4
   and 16 clients each send 16 writes of a 4 MiB object (one of 8 made
   from a seed); the primary's handler (``wire_ec_write``) encodes the
   object, a memoryview into its receive segment, through an
   ``EncodeBatcher`` in an ``ec.encode`` span, brings the chunks back in
   one copy, books both copies and replies with each chunk's crc32c
   (the bytes on every 8th write).  Then the same writes to a wire-only
   primary that computes the object's crc32c on the host.  Every reply
   equals the same profile on the CPU; K1's or K3's launches equal the
   batcher's groups (``ec.engine`` counters); no receive segment is
   held and no span open at the end; ``perf dump`` and
   ``dump_messenger`` are read through the admin socket.  Each run
   prints writes/s, object GB/s, the median per-write split (request
   on the wire, to the handler, ``encode_prepare``'s copy, batcher and
   kernel, the copy back, crc32c, the reply), the bufpool's hit rate,
   the copies booked an object and the kernels' share of the wall time
   (the run's launches replayed in one CUDA graph, timed by CUDA
   events).
13. A live cluster on the card (``phase_cluster``): a ``MiniCluster`` of
   3 monitors and 12 OSDs on 12 hosts with ``device`` the card, a
   replicated pool (size 3), isa 8+3 (K1) and jerasure cauchy_good 4+2
   packetsize 8 (K3), 32 PGs each.  8 clients write 16 objects of 4 MiB
   to each EC pool and read them back; one read-modify-write a pool; an
   image of 16 MiB on the isa pool in 4 MiB objects.  Two OSDs holding
   shards are killed (marked down) one after the other, every object
   read degraded after each; the monitor marks them out after
   ``mon_osd_down_out_interval``, both come back with empty stores and
   recovery rebuilds their shards.  Then the mgr forces a balancer
   round.  Every read equals the bytes written; every shard in every
   store, before the kills and after recovery, equals the same profile's
   chunk on the CPU (sha256, computed in the workers); the proposals
   equal the offline ``calc_pg_upmaps`` on the same map and the monitor
   commits them; K1's and K3's launches equal the EC engine's calls by
   route and kind (encode and decode both), K2's the balancer's
   ``map_all`` calls; no segment is held and no span open at the end.
   It prints writes/s, GB/s and write latencies, degraded-read and
   recovery times, the balancer round's seconds and the kernels' share
   of the data path's wall time (a CUDA graph of the run's launches).
14. The cluster tools.  (a) Before phase 13, ``rados_bench``'s CLI in
   this process with its own cluster (4 OSDs, pg_num 16, jerasure
   reed_sol_van 2+1 on K1 on the card) at upstream ``rados bench``'s 4
   MiB objects and 16 ops in flight, 5 s a run (upstream: 60):
   ``seq`` (16 writer threads, then 16 readers) and ``write`` through
   the aio window at queue depth 16, every count at 0 before each.  No
   op class has an error, the copy ledger's engine is ``bitplane``, K1's
   launches equal the EC engine's booked calls and every 8th launch
   equals the plain version byte for byte (``SampledTap``; not
   counted); each record prints on a ``rados_bench:`` line.  (b) On
   phase 13's cluster once its balancer round is committed (a hook of
   ``phase_cluster``, before the shutdown), with every count at 0
   (phase 13's put back after): ``ObjBencher`` write then seq, 5 s
   each, 4 MiB objects, 16 in flight, on the isa 8+3 (K1) and
   cauchy_good 4+2 (K3) pools; ``rados`` put/get/stat/ls/df of a 4 MiB
   object on the card; ``ceph_cli`` status, health, df, osd tree, pool
   ls, balancer status and dencoder list; ``telemetry`` snapshot, prom
   (held to the Prometheus text grammar) and latency.  Every bench
   object reads back equal to its bytes, every shard in every store
   equals the CPU encode (phase 13's objects too), K1's and K3's
   launches equal the EC engine's calls by route; each pool's writes
   fold into stages (``common/attribution.py``) with at most 10%
   unattributed, printed on a ``cluster_stages:`` line.
15. The failure drills of ``ceph_tpu_torch/tools/thrasher.py`` on the
   card (``phase_drills``), at the reference CLI's defaults (seed 8),
   every launch count at 0 before each.  In this process, with every K1
   and K2 launch held to its plain version (``SampledTap`` at every
   launch, ``K2Tap``; not counted), K1's launches equal to the EC
   engine's calls and K2's to ``PoolMapper.map_all``'s: (a) the chaos
   soak (5 OSDs, 1 mon, 20 s; writers on a replicated pool and on
   jerasure reed_sol_van 2+1 on K1 while OSDs are killed and revived and
   frames dropped, corrupted and duplicated; the active balancer's
   sweeps on K2); (b) the whole-host kill at recovery pipeline depths 1
   and 3, then the degraded-read soak on a 2+2 pool with shard-read
   EIOs armed; (c) the netsplit drills and the slow-ops drill.  Then (d)
   ``--loop-stall`` and ``--race-audit`` as subprocesses of the CLI,
   both at once (their checkers read their switches at import), each
   record read back from ``chiprun_out/``.  Every durability and correctness
   verdict is asserted (no acked write lost, convergence, no false
   markdown, OSD_FLAPPING raised and cleared, no lockdep, racecheck or
   span leak, no balancer proposal while degraded, no static BLOCK001);
   the speed and overhead gates are measurements, printed with their
   verdicts on a ``drill:`` line a record.

The scalar oracles run in worker processes (spawned, stopped at the
end) beside the card's work.
Tolerance is zero everywhere: every output is an integer.  Kernel times
(``ms``) come from CUDA events around eager calls; K1's are also timed
around replays of a CUDA graph of its launches (``graph_ms``: device
time without the host's gaps).  Each
bound is the larger of bytes moved over the card's memory rate and
operations over its peak rate for their type (published H100 SXM
figures; K1's 1-bit products are counted at the int8 rate, which is
lower).  It prints
the card's name and power limit, one line per kernel, one ``kernels``
JSON line (K1's launches: phases 4, 8, 9, 10, 12, 13, 14 and 15; K2's:
phase 4's, one a ``map_all`` call in phases 5, 6, 11, 13 and 15, one a
sweep in phase 7, one a rule in phase 8, phase 9's cross-check and one
a shard in phase 10; K3's: phases 9, 10, 12, 13 and 14), K2's variants, the
flagship rates, the pipeline's rates, the balancer's records and time
split, crushtool's record, one ``ec_plugins`` line per profile and
workload, phase 9's ``layouts``, ``k3``, ``words`` and ``spec`` lines,
phase 10's ``mesh`` lines, phase 11's ``epoch`` lines and its
``epochs_phase`` record, phase 12's ``wire`` lines and its
``wire_phase`` record, phase 13's ``cluster`` lines and its
``cluster_phase`` record, phase 14's ``rados_bench`` and
``cluster_stages`` lines and its ``tools_phase`` record, phase 15's
``drill`` lines and its ``drills_phase`` record, and last the contract
line
``{"ok": true, "device": {...}}``.  Without a CUDA device, or without
the rest of the repository beside it, it exits non-zero and prints no
result.
"""

import copy
import concurrent.futures
import itertools
import json
import multiprocessing
import os
import pickle
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(REPO, "tests", "golden")

# Published NVIDIA H100 SXM peaks (data sheet, dense, at 700 W).
HBM_BYTES_PER_S = 3.35e12
INT8_TENSOR_OPS_PER_S = 1979e12
# 64 INT32 lanes per SM against 128 FP32 lanes whose 67 TFLOP/s counts
# an FMA as 2: one integer op per lane per clock is 67e12 / 4.
INT32_OPS_PER_S = 67e12 / 4
# Integer ops of one bucket draw in csrc/crush_rule.cu, by bucket
# algorithm (the columns of ``draws``).  hash3 is 3 xors plus 5 mix
# rounds of 36 ops (183), hash4 4 xors plus 6 rounds (220).
#  1 uniform, a perm step: hash3, a u32 modulo (~20), the trace-back's
#    2 compares and 2 selects: 207.
#  2 list, an item: hash4, mask, multiply, shift, compare, select: 225.
#  3 tree, a level: hash4, multiply-high, the child's index (ctz-free:
#    and, negate, shift, subtract, add), compare, select: 228.
#  4 straw, an item: hash3, mask, multiply, subtract, shift, or, compare,
#    select: 190.
#  5 straw2, an item: hash3, crush_ln about 15, the quotient counted as 1
#    (a multiply-high by the item's magic; kept at 1 from when it was a
#    division, so bounds compare), mask/compare/select 3: 202.
OPS_PER_DRAW = {1: 207, 2: 225, 3: 228, 4: 190, 5: 202}
K2_LANES_PER_PG = 4  # kGroup in csrc/crush_rule.cu

GOLDEN_MAPS = ("map_big10k", "map_flat12", "map_tree3", "map_weird",
               "map_list", "map_straw", "map_uniform",
               "map_tree3_chooseargs", "map_tree3_legacy")
PGS = 65536
ORACLE_XS = 4096   # inputs per variant and rule held to mapper_ref
# Phase 5: the pipeline on map_big10k.  262,144 PGs is ~100 PG replicas
# per OSD (mon_target_pg_per_osd) x 10,000 OSDs / 3, to a power of two.
POOL_REP = dict(pool_id=1, size=3, rule=0, pg_num=262144, pgp_num=262144)
POOL_EC = dict(pool_id=2, size=11, rule=1, pg_num=65536, pgp_num=49152)
ITERS = 8
EC_B, EC_K, EC_M, EC_CHUNK = 4, 8, 3, 1 << 20


def log(msg):
    print(msg, flush=True)


def gpu_name_and_limit():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters, warmup=1):
    """Mean milliseconds of ``fn(i)`` over ``iters`` calls, by CUDA
    events around the whole run, after ``warmup`` calls."""
    import torch

    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i)
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / iters


def sass_mix(lib, pattern):
    """SASS opcode counts of each kernel in ``lib`` whose name matches
    ``pattern``, by ``cuobjdump -sass``: {name: (whole kernel, the span
    from its first to its last BMMA)}; {} without cuobjdump."""
    import re
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return {}
    run = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                         text=True, timeout=120)
    if run.returncode:
        log(f"sass: cuobjdump exited {run.returncode}: "
            f"{run.stderr.strip()[:200]}")
        return {}
    text = run.stdout
    ops, name = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            name = name if re.search(pattern, name) else None
            if name:
                ops[name] = []
            continue
        op = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                      r"([A-Z][A-Z0-9_]*)", line)
        if name and op:
            ops[name].append(op.group(1))

    def count(seq):
        out = {}
        for o in seq:
            out[o] = out.get(o, 0) + 1
        return dict(sorted(out.items(), key=lambda kv: -kv[1]))

    mix = {}
    for name, seq in ops.items():
        mma = [i for i, o in enumerate(seq) if o == "BMMA"]
        span = seq[mma[0]:mma[-1] + 1] if mma else []
        mix[name] = (count(seq), count(span))
    return mix


def log_k1_sass():
    """K1's instruction mix.  A kernel compiled for its m (k <= 8,
    m <= 8) unrolls the loop over output rows, so the span from its first
    to its last BMMA is one warp's 128-column chunk for all m rows: an
    opcode's count there x 32 lanes / 128 columns / m is its lane-ops
    per byte column and output row.  The m=any kernel (KS=4, every
    other shape) runs its span once per pass of 4 output rows."""
    import re

    from ceph_tpu_torch import build

    mix = sass_mix(build.lib_path("gf2_matmul_w8"), "gf2_matmul_w8_kernel")
    if not mix:
        log("sass: no instruction mix")
    for name, (whole, span) in sorted(mix.items()):
        t = re.search(r"ILi(\d+)ELi(\d+)ELb(\d)E", name)
        m = t.group(2) if t and t.group(2) != "0" else "any"
        label = (f"KS={t.group(1)} m={m} aligned={t.group(3)}") if t else name
        log(f"sass gf2_matmul_w8_kernel {label}: {sum(whole.values())} "
            f"instructions, {sum(span.values())} from first to last BMMA "
            + json.dumps(span))


def cuda_graph_ms(fn, iters, replays=5):
    """Mean device milliseconds of ``fn(i)``: ``iters`` calls captured in
    one CUDA graph, replayed ``replays`` times between two CUDA events,
    so the host's time between launches does not count."""
    import torch

    fn(0)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        with torch.cuda.graph(graph, stream=side):
            for i in range(iters):
                fn(i)
    torch.cuda.current_stream().wait_stream(side)
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / (replays * iters)


def max_abs_err(a, b):
    import torch

    if a.shape != b.shape:
        raise AssertionError(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    if a.numel() == 0:
        return 0
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max().item())


def load_map(name):
    from ceph_tpu_torch.crush.map import CrushMap

    with open(os.path.join(GOLDEN, f"{name}.json")) as f:
        d = json.load(f)
    return CrushMap.from_dict(d["map"]), d["cases"]


def tie_map(cmap):
    """A copy of ``map_big10k`` whose straw2 draws tie across a lane
    group: the hosts of one rack and the OSDs of one host weigh 0 (every
    draw is S64_MIN, so the first item must win), one host has a single
    OSD of weight 0xFFFFFFFF among 1.0s (it wins from whichever lane
    holds it), and one host's OSDs all weigh 0xFFFFFFFF (quotients of at
    most 2^16, so equal ones meet and the lower index must win)."""
    t = copy.deepcopy(cmap)
    racks = sorted(i for i, b in t.buckets.items() if b.type == 2)
    hosts = sorted(i for i, b in t.buckets.items() if b.type == 1)
    rack = t.buckets[racks[0]]
    rack.item_weights = [0] * rack.size
    zero, single, heavy = (t.buckets[hosts[k]] for k in (30, 60, 90))
    zero.item_weights = [0] * zero.size
    single.item_weights[single.size - 3] = 0xFFFFFFFF
    heavy.item_weights = [0xFFFFFFFF] * heavy.size
    return t


def mixed_big10k(cmap, tunables=None):
    """``map_big10k`` rebuilt with the port's builder: its host buckets
    take uniform (their OSDs weigh the same), list, tree and straw in
    turn, its racks are straw, its root stays straw2; the same items,
    weights, ids and rules, under ``tunables`` (default: the map's)."""
    from ceph_tpu_torch.crush import builder as B
    from ceph_tpu_torch.crush.map import CrushMap

    t = CrushMap(copy.deepcopy(tunables or cmap.tunables))
    host_makers = (None, B.make_list_bucket, B.make_tree_bucket,
                   B.make_straw_bucket)
    n_host = 0
    for i in sorted(cmap.buckets):
        b = cmap.buckets[i]
        if b.type == 1:
            mk = host_makers[n_host % 4]
            n_host += 1
            if mk is None:
                if len(set(b.item_weights)) != 1:
                    raise AssertionError("a uniform host needs equal "
                                         "OSD weights")
                nb = B.make_uniform_bucket(b.items, b.item_weights[0],
                                           b.type, bid=b.id)
            else:
                nb = mk(b.items, b.item_weights, b.type, bid=b.id)
        elif b.type == 2:
            nb = B.make_straw_bucket(b.items, b.item_weights, b.type,
                                     bid=b.id)
        else:
            nb = B.make_straw2_bucket(b.items, b.item_weights, b.type,
                                      bid=b.id)
        t.add_bucket(nb)
    t.rules = copy.deepcopy(cmap.rules)
    t.max_devices = cmap.max_devices
    return t


def compat_choose_args(cmap, positions, seed):
    """A choose_args set as the mgr balancer's crush-compat mode writes
    one: for every bucket a weight set of ``positions`` rows, each the
    item weights perturbed by up to 15% (from ``seed``), and ids (the
    device ids, and shadow ids 10,000 below each child bucket's)."""
    from ceph_tpu_torch.crush.map import ChooseArg, ChooseArgMap

    rng = np.random.default_rng(seed)
    cam = ChooseArgMap()
    for i in sorted(cmap.buckets):
        b = cmap.buckets[i]
        rows = [[max(1, int(w * f)) for w, f in
                 zip(b.item_weights, rng.uniform(0.85, 1.15, b.size))]
                for _ in range(positions)]
        ids = [it - 10000 if it < 0 else it for it in b.items]
        cam[i] = ChooseArg(ids=ids, weight_set=rows)
    return cam


def _oracle_rule(cmap, ruleno, numrep, weight, cargs, xs):
    """A worker's share of the scalar oracle: mapper_ref over ``xs``."""
    from ceph_tpu_torch.crush.mapper_ref import crush_do_rule

    return [crush_do_rule(cmap, ruleno, int(x), numrep, weight,
                          choose_args=cargs) for x in xs]


def _oracle_pgs(blob, pool_id, pss):
    """A worker's share of the scalar oracle: pg_to_up_acting_osds of
    the pickled OSDMap ``blob`` over ``pss``."""
    m = pickle.loads(blob)
    return [m.pg_to_up_acting_osds(pool_id, int(ps)) for ps in pss]


def oracle(pool, fn, head, items, chunk=256):
    """Submit ``fn(*head, chunk)`` for the chunks of ``items`` to the
    process pool; returns a callable that waits and gives the list of
    all results in order."""
    futs = [pool.submit(fn, *head, items[i:i + chunk])
            for i in range(0, len(items), chunk)]
    return lambda: [r for f in futs for r in f.result()]


def golden_check(case, res, lens, label, n=256):
    res, lens = res[:n].cpu().numpy(), lens[:n].cpu().numpy()
    for i in range(n):
        want = case["results"][i]
        got = [int(v) for v in res[i, :lens[i]]]
        if got != want:
            raise AssertionError(f"golden mismatch at x={case['x0'] + i} "
                                 f"on {label}: {got} != {want}")


# -- phase 2 ----------------------------------------------------------


def phase_k1(dev):
    import torch

    from ceph_tpu_torch.ec import gf
    from ceph_tpu_torch.ec.engine import BitCode
    from ceph_tpu_torch.ec.gf2_kernels import (gf2_fragments, gf2_matmul_w8,
                                               gf2_matmul_w8_plain)

    rng = np.random.default_rng(1)
    err = 0

    def check(bm, data, label, quiet=False):
        nonlocal err
        got = gf2_matmul_w8(bm, data)
        if isinstance(data, (list, tuple)):
            data = torch.stack(list(data))
        want = gf2_matmul_w8_plain(bm, data)
        e = max_abs_err(got, want)
        if e:
            raise AssertionError(f"K1 differs from plain on {label}: {e}")
        err = max(err, e)
        if not quiet:
            log(f"k1 check {label}: equal")
        return got

    for k, m, L in ((4, 2, 512), (8, 3, 2048), (8, 3, 777),
                    (8, 3, 4 << 20)):
        G = gf.rs_vandermonde_matrix(k, m)
        bm = torch.from_numpy(gf.expand_bitmatrix(G[k:])).to(dev)
        data = torch.from_numpy(
            rng.integers(0, 256, (k, L), dtype=np.uint8)).to(dev)
        check(bm, data, f"k={k} m={m} L={L}")
    bm83 = gf.expand_bitmatrix(gf.rs_vandermonde_matrix(8, 3)[8:])
    stripes = torch.from_numpy(
        rng.integers(0, 256, (3, 8, 777), dtype=np.uint8)).to(dev)
    check(torch.from_numpy(bm83).to(dev), stripes, "B=3 k=8 m=3 L=777")

    code = BitCode(8, 3, bm83, device=dev)
    data = torch.from_numpy(
        rng.integers(0, 256, (8, 777), dtype=np.uint8)).to(dev)
    full = code.all_chunks(data)
    inv, inv_frag = code._decode_mats(tuple(range(2, 10)))
    got = check(inv, full[2:10].contiguous(), "decode inverse 64x64 "
                "erasures [0, 1] L=777")
    if not torch.equal(got, data):
        raise AssertionError("K1 decode did not give the data back")

    # any bit matrix, not only GF(2^8)-derived ones: random 0/1 matrices,
    # unaligned (777), one tile (4096), many tiles with a ragged last one
    # (65,552) and a batch
    for k, m in ((8, 3), (8, 8), (8, 16), (32, 32), (5, 7)):
        rbm = torch.from_numpy(
            rng.integers(0, 2, (8 * m, 8 * k), dtype=np.uint8)).to(dev)
        for shape in ((k, 777), (k, 4096), (k, 65552), (3, k, 4112)):
            rdata = torch.from_numpy(
                rng.integers(0, 256, shape, dtype=np.uint8)).to(dev)
            check(rbm, rdata, f"random bit matrix k={k} m={m} {list(shape)}",
                  quiet=True)
        log(f"k1 check random bit matrix k={k} m={m} at L = 777, 4096, "
            f"65552 and [3, {k}, 4112]: equal")

    # every 2-erasure signature of RS(8,3), survivors as separate tensors
    n_sig = 0
    for lost in itertools.combinations(range(11), 2):
        present = [i for i in range(11) if i not in lost][:8]
        inv_l, _ = code._decode_mats(tuple(present))
        rows = [full[i].clone() for i in present]
        got = check(inv_l, rows, f"erasures {list(lost)}", quiet=True)
        if not torch.equal(got, data):
            raise AssertionError(f"K1 decode of erasures {list(lost)} did "
                                 f"not give the data back")
        n_sig += 1
    log(f"k1 check all {n_sig} 2-erasure inverses of RS(8,3) at L=777, "
        f"survivors as separate tensors: equal, data back")

    # survivors at unaligned offsets of one buffer, small and large
    for L in (777, 1 << 20):
        dat = torch.from_numpy(
            rng.integers(0, 256, (8, L), dtype=np.uint8)).to(dev)
        ful = code.all_chunks(dat)
        buf = torch.zeros(8 * (L + 5) + 3, dtype=torch.uint8, device=dev)
        rows = []
        for n, i in enumerate(range(2, 10)):
            off = 3 + n * (L + 5)
            buf[off:off + L] = ful[i]
            rows.append(buf[off:off + L])
        got = check(inv, rows, f"decode, survivors at odd offsets of one "
                    f"buffer, L={L}")
        if not torch.equal(got, dat):
            raise AssertionError("K1 decode from unaligned survivors did "
                                 "not give the data back")

    # time at the main path's shape: 4 stripes x 8 x 1 MiB -> 4 x 3 x 1 MiB,
    # cycling 4 input sets (176 MiB) so no launch finds its data in L2
    bm = torch.from_numpy(bm83).to(dev)
    gen = torch.Generator(device=dev).manual_seed(2)
    bufs = [torch.randint(0, 256, (EC_B, EC_K, EC_CHUNK), dtype=torch.uint8,
                          device=dev, generator=gen) for _ in range(4)]
    # the main path's shapes: encode_batched [4, 8, 1 MiB] and the decode
    # of erasures [0, 1] over [8, 4 MiB] through the 64x64 inverse
    check(bm, bufs[0], f"main-path encode [{EC_B}, {EC_K}, {EC_CHUNK}]")
    flat = bufs[1].transpose(0, 1).reshape(EC_K, EC_B * EC_CHUNK)
    survivors = code.all_chunks(flat)[2:10].contiguous()
    got = check(inv, survivors,
                f"main-path decode [{EC_K}, {EC_B * EC_CHUNK}]")
    if not torch.equal(got, flat):
        raise AssertionError("K1 main-path decode did not give the data "
                             "back")
    dec_ms = cuda_ms(lambda i: gf2_matmul_w8(inv, survivors, inv_frag), 10)
    dec_graph_ms = cuda_graph_ms(
        lambda i: gf2_matmul_w8(inv, survivors, inv_frag), 10)
    dec_plain_ms = cuda_ms(lambda i: gf2_matmul_w8_plain(inv, survivors), 2)
    dec_t_bytes = (2 * survivors.numel() + inv.numel()) \
        / HBM_BYTES_PER_S * 1e3
    dec_t_ops = 2 * inv.numel() * survivors.shape[1] \
        / INT8_TENSOR_OPS_PER_S * 1e3
    dec_bound_ms = max(dec_t_bytes, dec_t_ops)
    log(f"k1 decode [{EC_K}, {EC_B * EC_CHUNK}] through the 64x64 inverse: "
        f"kernel_ms={dec_ms:.4f} graph_ms={dec_graph_ms:.4f} "
        f"plain_ms={dec_plain_ms:.3f} "
        f"bound_ms={dec_bound_ms:.4f} "
        f"({'bytes' if dec_t_bytes >= dec_t_ops else 'operations'})")
    del flat, survivors, got
    bm_frag = gf2_fragments(bm)
    ms = cuda_ms(lambda i: gf2_matmul_w8(bm, bufs[i % 4], bm_frag), 20,
                 warmup=2)
    graph_ms = cuda_graph_ms(
        lambda i: gf2_matmul_w8(bm, bufs[i % 4], bm_frag), 20)
    log(f"k1 encode [{EC_B}, {EC_K}, {EC_CHUNK}]: kernel_ms={ms:.4f} "
        f"graph_ms={graph_ms:.4f}")
    plain_ms = cuda_ms(lambda i: gf2_matmul_w8_plain(bm, bufs[i % 4]), 3)
    nbytes = EC_B * (EC_K + EC_M) * EC_CHUNK + bm.numel()
    ops = 2 * (8 * EC_M) * (8 * EC_K) * EC_B * EC_CHUNK
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT8_TENSOR_OPS_PER_S * 1e3
    del bufs
    torch.cuda.empty_cache()
    return {"name": "gf2_matmul_w8", "route": "cuda",
            "source": "ceph_tpu_torch/csrc/gf2_matmul_w8.cu",
            "replaces": "ceph_tpu/ec/pallas_kernels.py:34",
            "max_abs_err": err, "ms": ms, "graph_ms": graph_ms,
            "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None,
            "shape": f"[{EC_B}, {EC_K}, {EC_CHUNK}] -> "
                     f"[{EC_B}, {EC_M}, {EC_CHUNK}] u8; decode "
                     f"[{EC_K}, {EC_B * EC_CHUNK}] through the 64x64 "
                     f"inverse: kernel_ms={dec_ms:.4f} "
                     f"graph_ms={dec_graph_ms:.4f} "
                     f"plain_ms={dec_plain_ms:.3f} "
                     f"bound_ms={dec_bound_ms:.4f}"}


# -- phase 3 ----------------------------------------------------------


def k2_bound_ms(arrays, prog, n, weight, draws):
    """K2's least time on the card for ``n`` xs: the larger of the bytes
    it must move (xs in, results and lengths out, the weights and the
    map arrays it reads, the ln tables) over the memory rate and the
    integer ops of this run's bucket draws (``draws`` i32[n, 5], by
    algorithm) over the INT32 rate.  Returns (bound_ms, bound_by, ops
    per x)."""
    import torch

    names = ["alg", "btype", "size", "items"]
    if prog.general:
        names += ["nnodes", "weights", "sum_weights", "straws",
                  "node_weights"] + (["arg_ids"] if prog.has_choose_args
                                     else [])
    magic = arrays.arg_magic if prog.has_choose_args else arrays.magic
    nbytes = (n * 4 * (2 + prog.result_max) + weight.numel() * 4
              + sum(getattr(arrays, k).numel() * 4 for k in names)
              + magic.numel() * 8 + 514 * 8)
    per_alg = draws.to(torch.int64).sum(0).tolist()
    ops = sum(per_alg[a] * OPS_PER_DRAW[a + 1] for a in range(5))
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT32_OPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", ops / n)


def time_k2(arrays, prog, weight, label):
    """K2 at the main path's shape (65,536 PGs, ``ITERS`` batches): its
    ms by CUDA events, the plain version's, and the bound."""
    import torch

    from ceph_tpu_torch.crush.mapper import (N_ALGS, crush_rule_batched,
                                             map_batch_plain)

    dev = weight.device
    batches = [torch.arange(i * PGS, (i + 1) * PGS, dtype=torch.int32,
                            device=dev) for i in range(ITERS)]
    draws = torch.zeros((PGS, N_ALGS), dtype=torch.int32, device=dev)
    bounds = []
    for b in batches:
        crush_rule_batched(arrays, prog, weight, b, draws=draws)
        bounds.append(k2_bound_ms(arrays, prog, PGS, weight, draws))
    ms = cuda_ms(lambda i: crush_rule_batched(arrays, prog, weight,
                                              batches[i % ITERS]),
                 ITERS, warmup=1)
    plain_ms = cuda_ms(lambda i: map_batch_plain(arrays, prog, weight,
                                                 batches[0]), 1)
    bound_ms = sum(b[0] for b in bounds) / len(bounds)
    ops_per_pg = sum(b[2] for b in bounds) / len(bounds)
    out = {"label": label, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": bound_ms, "bound_by": bounds[0][1],
           "ops_per_pg": ops_per_pg, "general": prog.general}
    log(f"k2 time {label}: kernel_ms={ms:.4f} plain_ms={plain_ms:.3f} "
        f"bound_ms={bound_ms:.4f} ({out['bound_by']}) "
        f"ops_per_pg={ops_per_pg:.1f} general={prog.general}")
    return out


def k2_variants(cmap):
    """The full-size variants of ``map_big10k`` beside the all-straw2
    map: (label, map, choose_args for rule 0, for rule 1)."""
    from ceph_tpu_torch.crush.map import Tunables

    return [
        ("map_big10k_mixed", mixed_big10k(cmap), None, None),
        ("map_big10k_mixed legacy", mixed_big10k(cmap, Tunables.legacy()),
         None, None),
        ("map_big10k choose_args", cmap, compat_choose_args(cmap, 1, 7),
         compat_choose_args(cmap, 11, 8)),
    ]


def variant_weight(n):
    """Device weights for the variants: 2% of OSDs out, 1% at half."""
    rng = np.random.default_rng(9)
    w = np.full(n, 0x10000, np.uint32)
    w[rng.choice(n, n // 50, replace=False)] = 0
    w[rng.choice(n, n // 100, replace=False)] = 0x8000
    return w


def phase_k2(dev, pool):
    import torch

    from ceph_tpu_torch.crush.map_arrays import as_i32
    from ceph_tpu_torch.crush.mapper import (BatchedMapper,
                                             crush_rule_batched,
                                             map_batch_plain)

    err = 0
    cmap, cases = load_map("map_big10k")

    # the scalar oracle's share, submitted first: the workers run while
    # the card does the rest
    vweight_np = variant_weight(cmap.max_devices)
    variants = k2_variants(cmap)
    oracle_xs = np.arange(ORACLE_XS, dtype=np.uint32)
    pending = {}
    for label, vmap, ca0, ca1 in variants:
        for ruleno, numrep, ca in ((0, 3, ca0), (1, 11, ca1)):
            pending[label, ruleno] = oracle(
                pool, _oracle_rule, (vmap, ruleno, numrep,
                                     vweight_np.tolist(), ca),
                oracle_xs.tolist())

    mapper = BatchedMapper(cmap, device=dev)
    weight = as_i32(np.asarray(cases[0]["weight"], np.uint32), dev)
    rng = np.random.default_rng(3)
    xs = as_i32(rng.integers(0, 2 ** 32, 4096, dtype=np.uint64)
                .astype(np.uint32), dev)
    pgs = torch.arange(PGS, dtype=torch.int32, device=dev)

    def check(arrays, prog, w, x, label):
        nonlocal err
        got = crush_rule_batched(arrays, prog, w, x)
        want = map_batch_plain(arrays, prog, w, x)
        e = max(max_abs_err(got[0], want[0]), max_abs_err(got[1], want[1]))
        if e:
            raise AssertionError(f"K2 differs from plain on {label}: {e}")
        err = max(err, e)
        log(f"k2 check {label}: equal")
        return got

    for ruleno, numrep in ((0, 3), (1, 11)):
        prog = mapper.program(ruleno, numrep)
        for label, x in (("4096 random xs", xs),
                         (f"main-path PGs [0, {PGS})", pgs)):
            check(mapper.arrays, prog, weight, x,
                  f"map_big10k rule {ruleno} numrep {numrep} {label}")

    tmapper = BatchedMapper(tie_map(cmap), device=dev)
    for ruleno, numrep in ((0, 3), (1, 11)):
        check(tmapper.arrays, tmapper.program(ruleno, numrep), weight, pgs,
              f"tie map rule {ruleno} numrep {numrep} main-path PGs "
              f"[0, {PGS})")

    for name in GOLDEN_MAPS:
        gmap, gcases = load_map(name)
        gm = BatchedMapper(gmap, choose_args=gmap.choose_args.get("golden"),
                           device=dev)
        for case in gcases:
            n = case["x1"] - case["x0"]
            xs_c = np.arange(case["x0"], case["x1"], dtype=np.uint32)
            res, lens = gm.map_batch(case["ruleno"], xs_c, case["numrep"],
                                     np.asarray(case["weight"], np.uint32))
            golden_check(case, res, lens, f"{name} rule {case['ruleno']}",
                         n=n)
        log(f"k2 golden {name}: {len(gcases)} cases equal")

    # rule shapes no golden map has, from the text map: the set steps of
    # ops 8-13, several takes and emits, numrep beyond the hierarchy,
    # takes of a device, an empty bucket and a missing one; under each
    # tunable profile of rule_shapes; K2 against the plain walk on 4,096
    # xs (2^31 and 2^32 - 1 among them) and against mapper_ref on the
    # first 256
    from ceph_tpu_torch.crush.mapper_ref import crush_do_rule
    from ceph_tpu_torch.tools import rule_shapes

    sxs = np.concatenate([np.asarray([0, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 1],
                                     np.uint32),
                          rng.integers(0, 2 ** 32, 4092, dtype=np.uint64)
                          .astype(np.uint32)])
    n_shapes = 0
    for tname in rule_shapes.TUNABLES:
        smap = rule_shapes.rule_shapes_map(tname)
        sw_np = rule_shapes.weights(smap.max_devices)
        sm = BatchedMapper(smap, device=dev)
        sw = as_i32(sw_np, dev)
        for ruleno, numrep in rule_shapes.CASES:
            label = f"rule shapes ({tname} tunables) rule {ruleno} numrep " \
                    f"{numrep}"
            res, lens = check(sm.arrays, sm.program(ruleno, numrep), sw,
                              as_i32(sxs, dev), f"{label}, 4096 xs")
            res, lens = res[:256].cpu().numpy(), lens[:256].cpu().numpy()
            for i, x in enumerate(sxs[:256].tolist()):
                want = crush_do_rule(smap, ruleno, x, numrep, sw_np.tolist())
                if res[i, :lens[i]].tolist() != want:
                    raise AssertionError(f"K2 differs from mapper_ref on "
                                         f"{label} at x={x}")
            n_shapes += 1
    log(f"k2 rule shapes: {n_shapes} cases equal to the plain walk and "
        f"mapper_ref")

    # the full-size variants: K2 against the plain walk on 65,536 PGs and
    # its first ORACLE_XS outputs against mapper_ref; timed once every
    # oracle is done, so that no worker competes with the host's launches
    vweight = as_i32(vweight_np, dev)
    timed = []
    for label, vmap, ca0, ca1 in variants:
        for ruleno, numrep, ca in ((0, 3, ca0), (1, 11, ca1)):
            vm = BatchedMapper(vmap, choose_args=ca, device=dev)
            prog = vm.program(ruleno, numrep)
            tag = f"{label} rule {ruleno} numrep {numrep}"
            res, lens = check(vm.arrays, prog, vweight, pgs,
                              f"{tag} main-path PGs [0, {PGS})")
            res = res[:ORACLE_XS].cpu().numpy()
            lens = lens[:ORACLE_XS].cpu().numpy()
            want = pending.pop((label, ruleno))()
            for i, w in enumerate(want):
                if res[i, :lens[i]].tolist() != w:
                    raise AssertionError(
                        f"K2 differs from mapper_ref on {tag} at x={i}: "
                        f"{res[i, :lens[i]].tolist()} != {w}")
            log(f"k2 check {tag}: first {ORACLE_XS} equal to mapper_ref")
            timed.append((vm.arrays, prog, tag))
    rows = [time_k2(arrays, prog, vweight, tag)
            for arrays, prog, tag in timed]

    # time at the main path's shape: rule 0, numrep 3, 65,536 PGs
    main = time_k2(mapper.arrays, mapper.program(0, 3), weight,
                   "map_big10k rule 0 numrep 3 (straw2)")
    return {"name": "crush_rule_batched", "route": "cuda",
            "source": "ceph_tpu_torch/csrc/crush_rule.cu",
            "replaces": "ceph_tpu/crush/mapper_jax.py:628",
            "max_abs_err": err, "ms": main["ms"], "graph_ms": None,
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": None,
            "shape": f"map_big10k rule 0 numrep 3, {PGS} PGs, "
                     f"{main['ops_per_pg']:.1f} ops per PG, "
                     f"{K2_LANES_PER_PG} lanes per PG",
            "variants": rows}


# -- phase 4 ----------------------------------------------------------


def phase_flagship(dev):
    import torch

    from ceph_tpu_torch.crush.map_arrays import as_i32
    from ceph_tpu_torch.crush.mapper import build_rule_fn
    from ceph_tpu_torch.ec import gf
    from ceph_tpu_torch.flagship import flagship

    cmap, cases = load_map("map_big10k")
    fs = flagship(cmap, ruleno=0, result_max=3, device=dev)
    rule1, _, _ = build_rule_fn(cmap, 1, 11, device=dev)
    weight = as_i32(np.asarray(cases[0]["weight"], np.uint32), dev)
    batches = [torch.arange(i * PGS, (i + 1) * PGS, dtype=torch.int32,
                            device=dev) for i in range(ITERS)]
    gen = torch.Generator(device=dev).manual_seed(4)
    stripes = torch.randint(0, 256, (EC_B, EC_K, EC_CHUNK),
                            dtype=torch.uint8, device=dev, generator=gen)
    fs.step(fs.arrays, weight, batches[0], stripes)   # warm-up
    rule1(fs.arrays, weight, batches[0])
    torch.cuda.synchronize()

    t0 = time.perf_counter()
    for i in range(ITERS):
        res, lens, parity = fs.step(fs.arrays, weight, batches[i], stripes)
        if i == 0:
            res0, lens0 = res, lens
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / ITERS

    t0 = time.perf_counter()
    for b in batches:
        res1, lens1 = rule1(fs.arrays, weight, b)
        if b is batches[0]:
            res1_0, lens1_0 = res1, lens1
    torch.cuda.synchronize()
    rule1_rate = PGS * ITERS / (time.perf_counter() - t0)

    t0 = time.perf_counter()
    for b in batches:
        fs.rule_fn(fs.arrays, weight, b)
    torch.cuda.synchronize()
    rule0_rate = PGS * ITERS / (time.perf_counter() - t0)

    t0 = time.perf_counter()
    for _ in range(ITERS):
        parity = fs.code.encode_batched(stripes)
    torch.cuda.synchronize()
    enc_gbps = EC_B * EC_K * EC_CHUNK * ITERS / (time.perf_counter() - t0) / 1e9

    data = stripes.transpose(0, 1).reshape(EC_K, EC_B * EC_CHUNK)
    par2d = parity.transpose(0, 1).reshape(EC_M, EC_B * EC_CHUNK)
    chunks = {i: data[i] for i in range(EC_K)}
    chunks.update({EC_K + i: par2d[i] for i in range(EC_M)})
    fs.code.decode(chunks, [0, 1])   # warm-up: inverts and caches the matrix
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(ITERS):
        out = fs.code.decode(chunks, [0, 1])
    torch.cuda.synchronize()
    dec_gbps = EC_K * EC_B * EC_CHUNK * ITERS / (time.perf_counter() - t0) / 1e9
    # device time per call, by CUDA events around the same calls
    enc_dev_ms = cuda_ms(lambda i: fs.code.encode_batched(stripes), ITERS)
    dec_dev_ms = cuda_ms(lambda i: fs.code.decode(chunks, [0, 1]), ITERS)
    # decode allocates its k x L output and nothing more: the survivors
    # are read where they lie, not stacked
    del out
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    out = fs.code.decode(chunks, [0, 1])
    torch.cuda.synchronize()
    dec_alloc = torch.cuda.max_memory_allocated(dev) - base
    if dec_alloc > EC_K * EC_B * EC_CHUNK:
        raise AssertionError(f"decode allocated {dec_alloc} bytes, more "
                             f"than its k x L = {EC_K * EC_B * EC_CHUNK}")

    # outputs: shapes, golden vectors, parity against the host GF(2^8)
    # reference on a slice, decode round trip
    if res0.shape != (PGS, 3) or lens0.shape != (PGS,):
        raise AssertionError("flagship CRUSH output has the wrong shape")
    if parity.shape != (EC_B, EC_M, EC_CHUNK):
        raise AssertionError("flagship parity has the wrong shape")
    golden_check(cases[0], res0, lens0, "flagship map_big10k rule 0")
    golden_check(cases[1], res1_0, lens1_0, "flagship map_big10k rule 1")
    cut = 4096
    want = gf.encode_ref(fs.code.G, stripes[0, :, :cut].cpu().numpy())
    if not np.array_equal(parity[0, :, :cut].cpu().numpy(), want):
        raise AssertionError("flagship parity differs from encode_ref")
    if not torch.equal(out, data):
        raise AssertionError("decode of erasures [0, 1] did not give the "
                             "data back")
    return {"step_ms": step_s * 1e3,
            "crush_rule0_mappings_per_s": rule0_rate,
            "crush_rule1_mappings_per_s": rule1_rate,
            "ec_encode_gbps": enc_gbps, "ec_decode_gbps": dec_gbps,
            "ec_encode_device_ms_per_call": enc_dev_ms,
            "ec_decode_device_ms_per_call": dec_dev_ms,
            "ec_decode_bytes_allocated": dec_alloc}


# -- phase 5 ----------------------------------------------------------


def build_cluster(cmap, seed=12):
    """An OSDMap on ``map_big10k``: every OSD exists; from ``seed`` 2% are
    down, 1% out, 0.5% at weight 0x8000 and 5% carry a non-default
    primary affinity; the replicated and the EC pool of phase 5.
    Returns (map, out OSDs)."""
    from ceph_tpu_torch.osdmap.osdmap import (OSD_UP, OSDMap, PgPool,
                                              POOL_TYPE_ERASURE,
                                              POOL_TYPE_REPLICATED)

    m = OSDMap(cmap)
    n = cmap.max_devices
    for o in range(n):
        m.add_osd(o)
    rng = np.random.default_rng(seed)
    for o in rng.choice(n, n * 2 // 100, replace=False):
        m.osd_state[o] &= ~OSD_UP
    out = rng.choice(n, n // 100, replace=False)
    for o in out:
        m.osd_weight[o] = 0
    for o in rng.choice(n, n // 200, replace=False):
        m.osd_weight[o] = 0x8000
    for o in rng.choice(n, n * 5 // 100, replace=False):
        m.set_primary_affinity(int(o), int(rng.integers(0, 0x10000)))
    for spec, ptype in ((POOL_REP, POOL_TYPE_REPLICATED),
                        (POOL_EC, POOL_TYPE_ERASURE)):
        m.pools[spec["pool_id"]] = PgPool(
            pool_type=ptype, size=spec["size"], pg_num=spec["pg_num"],
            pgp_num=spec["pgp_num"], crush_rule=spec["rule"])
    return m, [int(o) for o in out]


def add_exceptions(m, pool_id, up, ulen, rng, out_osds, frac=1.0,
                   temps=True):
    """Exception entries on ``frac`` x (1% pg_upmap_items, 0.1%
    pg_upmap and, with ``temps``, 1% pg_temp, 0.1% primary_temp) of the
    pool's PGs, from ``rng``; a tenth of the upmap targets are out OSDs.  ``up``/``ulen``:
    the pool's mapping without exceptions (the items' sources).  Returns
    the PGs that got an entry."""
    pool = m.pools[pool_id]
    n, R, D = pool.pg_num, pool.size, m.max_osd

    def pick(count):
        return [int(p) for p in rng.choice(n, max(1, int(count * frac)),
                                           replace=False)]

    def target():
        return int(out_osds[rng.integers(len(out_osds))]) \
            if rng.random() < 0.1 else int(rng.integers(D))

    touched = set()
    for ps in pick(n // 100):
        k = max(int(ulen[ps]), 1)
        m.pg_upmap_items[(pool_id, ps)] = [
            (int(up[ps, rng.integers(k)]), target())
            for _ in range(1 + ps % 2)]
        touched.add(ps)
    for ps in pick(n // 1000):
        osds = [int(o) for o in rng.choice(D, R, replace=False)]
        if rng.random() < 0.2:
            osds[int(rng.integers(R))] = int(
                out_osds[rng.integers(len(out_osds))])
        m.pg_upmap[(pool_id, ps)] = osds
        touched.add(ps)
    if not temps:
        return touched
    for ps in pick(n // 100):
        m.pg_temp[(pool_id, ps)] = [int(o) for o in
                                    rng.choice(D, R, replace=False)]
        touched.add(ps)
    for ps in pick(n // 1000):
        m.primary_temp[(pool_id, ps)] = int(rng.integers(D))
        touched.add(ps)
    return touched


def check_pool(pool, m, pool_id, out, pss, label):
    """``out`` (PoolMapper.map_all) against the scalar
    pg_to_up_acting_osds on the PGs ``pss``, in the process pool."""
    pss = sorted(pss)
    want = oracle(pool, _oracle_pgs, (pickle.dumps(m), pool_id), pss,
                  chunk=512)
    host = {k: v.cpu().numpy() for k, v in out.items()}
    for ps, (up, upp, act, actp) in zip(pss, want()):
        got = (host["up"][ps, :host["up_len"][ps]].tolist(),
               int(host["up_primary"][ps]),
               host["acting"][ps, :host["acting_len"][ps]].tolist(),
               int(host["acting_primary"][ps]))
        if got != (up, upp, act, actp):
            raise AssertionError(f"PoolMapper differs from "
                                 f"pg_to_up_acting_osds on {label} pg "
                                 f"{pool_id}.{ps}: {got} != "
                                 f"{(up, upp, act, actp)}")
    log(f"pipeline check {label}: {len(pss)} PGs equal to "
        f"pg_to_up_acting_osds")


def phase_pipeline(dev, pool):
    """PoolMapper.map_all on the card against the scalar
    pg_to_up_acting_osds, for both pools, before and after an upmap
    edit, then timed.  Returns (rows, K2's launches from map_all: one a
    call, asserted; the bare K2 timing beside it is not counted, the
    map, its cached PoolMappers by pool)."""
    from ceph_tpu_torch.crush.mapper import crush_rule_batched
    from ceph_tpu_torch.osdmap.pipeline import PoolMapper

    cmap, _ = load_map("map_big10k")
    m, out_osds = build_cluster(cmap)
    rng = np.random.default_rng(13)
    touched = {}
    calls = 0  # map_all calls
    for spec in (POOL_REP, POOL_EC):
        pid = spec["pool_id"]
        base = {k: v.cpu().numpy()
                for k, v in PoolMapper(m, pid, device=dev).map_all().items()}
        calls += 1
        touched[pid] = add_exceptions(m, pid, base["up"], base["up_len"],
                                      rng, out_osds)
    rows, mappers = [], {}
    for spec in (POOL_REP, POOL_EC):
        pid, n = spec["pool_id"], spec["pg_num"]
        label = (f"pool {pid} ({'replicated' if pid == 1 else 'EC 8+3'}, "
                 f"size {spec['size']}, pg_num {n}, pgp_num "
                 f"{spec['pgp_num']})")
        pm = mappers[pid] = PoolMapper(m, pid, device=dev)
        out = pm.map_all()
        for k, v in out.items():
            want = (n, spec["size"]) if k in ("up", "acting") else (n,)
            if tuple(v.shape) != want or v.device.type != dev.type:
                raise AssertionError(f"map_all {k}: {tuple(v.shape)} on "
                                     f"{v.device}")
        sample = set(int(p) for p in rng.choice(n, ORACLE_XS,
                                                replace=False))
        pss = sample | touched[pid]
        check_pool(pool, m, pid, out, pss,
                   f"{label}, every exception PG and {ORACLE_XS} more")
        # an upmap edit: new pg_upmap_items and pg_upmap on a few PGs
        host = {k: v.cpu().numpy() for k, v in out.items()}
        edited = add_exceptions(m, pid, host["up"], host["up_len"], rng,
                                out_osds, frac=0.05, temps=False)
        pm.refresh_tables()
        check_pool(pool, m, pid, pm.map_all(), pss | edited,
                   f"{label} after an upmap edit and refresh_tables")
        w, st, pa = pm.runtime_args()
        ms = cuda_ms(lambda i: pm.map_all(w, st, pa), ITERS, warmup=1)
        calls += 2 + ITERS + 1
        launches = crush_rule_batched.launches
        if launches != calls:
            raise AssertionError(f"{calls} map_all calls launched K2 "
                                 f"{launches} times")
        k2_ms = cuda_ms(lambda i: crush_rule_batched(pm.arrays, pm.prog, w,
                                                     pm.pps_i32),
                        ITERS, warmup=1)
        crush_rule_batched.launches = launches
        row = {"pool": pid, "pg_num": n, "size": spec["size"],
               "map_all_ms": ms, "pgs_per_s": n / ms * 1e3,
               "k2_ms": k2_ms,
               "exception_pgs": len(touched[pid]),
               "checked_pgs": len(pss | edited)}
        log(f"pipeline {label}: map_all_ms={ms:.4f} "
            f"pgs_per_s={row['pgs_per_s']:.1f} k2_ms={k2_ms:.4f} "
            f"({len(touched[pid])} PGs with exception entries)")
        rows.append(row)
    return rows, calls, m, mappers


# -- phase 6 ----------------------------------------------------------

# 6a: 250 hosts of 4 OSDs in 25 racks, 1x/2x/4x weights, ssd and hdd
# classes; pool 1 (32,768 PGs) on the plain rule, pools 2 and 3 (8,192
# each) on the class rules: ~147 PG replicas an OSD, inside Ceph's
# mon_target_pg_per_osd 100 / mon_max_pg_per_osd 250 band.
SYNTH = dict(n_osds=1000, osds_per_host=4, hosts_per_rack=10,
             pg_num=32768, seed=10, uneven=True,
             device_classes=["ssd", "hdd"])
# max_deviation 1 is bench.py's balancer lane; max_iterations 10 is
# Ceph's upmap_max_optimizations default; 3 rounds (10 until phase 15
# came: the CPU run of the same rounds is phase 6's longest wait)
OFFLINE = dict(max_deviation=1, max_iterations=10, max_rounds=3, seed=10,
               patience=2)
# 6b: osdmaptool --upmap's defaults on pool 1 of phase 5's cluster
UPMAP_BIG = dict(max_deviation=5, max_iterations=10, only_pools={1})
TIMING = ("sweep_s", "sweep_mappings_per_sec")
CHANGED_MAX = 4096  # changed PGs held to the scalar pipeline, per check


class SplitTimer:
    """While active, splits the balancer's time: every
    ``PoolMapper.map_all`` (CUDA events, the card synchronised after
    each call so that the host tally is timed alone), the host tally
    (``balancer._tally``: the copy to the host and the grouping) and
    ``calc_pg_upmaps`` (its own sweep's map_all and tally subtracted,
    the rest is the optimizer's search).  ``calls`` counts every
    map_all call; ``zero`` restarts the split."""

    def __init__(self, dev):
        self.dev = dev
        self.calls = 0
        self.zero()

    def zero(self):
        self.calls0 = self.calls
        self.map_all_ms = 0.0    # device time, CUDA events
        self.map_all_s = 0.0     # host clock around each call + sync
        self.tally_s = 0.0
        self.search_s = 0.0

    def __enter__(self):
        import torch

        from ceph_tpu_torch.mgr import balancer_module
        from ceph_tpu_torch.osdmap import balancer, pipeline

        cuda = self.dev.type == "cuda"
        saved = (pipeline.PoolMapper.map_all, balancer._tally,
                 balancer_module.calc_pg_upmaps)
        self._restore = lambda: (
            setattr(pipeline.PoolMapper, "map_all", saved[0]),
            setattr(balancer, "_tally", saved[1]),
            setattr(balancer_module, "calc_pg_upmaps", saved[2]))

        def map_all(pm, *a, **k):
            t0 = time.perf_counter()
            if cuda:
                start = torch.cuda.Event(enable_timing=True)
                stop = torch.cuda.Event(enable_timing=True)
                start.record()
            out = saved[0](pm, *a, **k)
            if cuda:
                stop.record()
                stop.synchronize()
                self.map_all_ms += start.elapsed_time(stop)
            self.map_all_s += time.perf_counter() - t0
            self.calls += 1
            return out

        def tally(*a):
            t0 = time.perf_counter()
            saved[1](*a)
            self.tally_s += time.perf_counter() - t0

        def calc(*a, **k):
            return self.calc(saved[2], *a, **k)

        pipeline.PoolMapper.map_all = map_all
        balancer._tally = tally
        balancer_module.calc_pg_upmaps = calc
        return self

    def __exit__(self, *exc):
        self._restore()

    def calc(self, fn, *a, **k):
        """``fn`` (calc_pg_upmaps), its search time booked."""
        t0 = time.perf_counter()
        sweep0 = self.map_all_s + self.tally_s
        out = fn(*a, **k)
        self.search_s += (time.perf_counter() - t0
                          - (self.map_all_s + self.tally_s - sweep0))
        return out

    def split(self, wall_s):
        return {"wall_s": wall_s, "map_all_calls": self.calls - self.calls0,
                "map_all_device_ms": self.map_all_ms,
                "map_all_host_s": self.map_all_s, "tally_s": self.tally_s,
                "search_s": self.search_s,
                "other_host_s": wall_s - self.map_all_s - self.tally_s
                - self.search_s}


def _offline_cpu(synth, offline):
    """Phase 6a's run on the CPU (the port's plain walk), in a worker:
    (record, final pg_upmap_items, seconds)."""
    from ceph_tpu_torch.mgr.balancer_module import run_offline
    from ceph_tpu_torch.mgr.synthetic import make_synthetic_map

    m, w, _ = make_synthetic_map(**synth)
    t0 = time.perf_counter()
    rec = run_offline(m, w, device="cpu", **offline)
    return rec, sorted(m.pg_upmap_items.items()), time.perf_counter() - t0


def check_changed(pool, m, mappers, changed, label):
    """The cached ``mappers``' rows, after ``refresh_tables``, against the
    scalar pipeline on the changed PGs (the first ``CHANGED_MAX`` of each
    pool).  Returns the number checked."""
    n = 0
    for pid in sorted({p for p, _ in changed}):
        pss = sorted(ps for p, ps in changed if p == pid)[:CHANGED_MAX]
        mappers[pid].refresh_tables()
        check_pool(pool, m, pid, mappers[pid].map_all(), pss,
                   f"{label}, pool {pid}, {len(pss)} changed PGs")
        n += len(pss)
    return n


def changed_pgs(before, after):
    return {pg for pg in set(before) | set(after)
            if before.get(pg) != after.get(pg)}


def phase_balancer_offline(dev, pool):
    """6a: ``run_offline`` on the card, then in a worker on the CPU (started
    once the card's run is timed, so that nothing shares the host with
    it); every changed PG held to the scalar pipeline.  Returns (the
    record with its time split, map_all calls, a function that waits for
    the CPU run, holds the card's record and final upmaps to it and adds
    its times)."""
    from ceph_tpu_torch.crush.mapper import (crush_rule_batched,
                                             map_batch_plain)
    from ceph_tpu_torch.mgr.balancer_module import run_offline
    from ceph_tpu_torch.mgr.synthetic import make_synthetic_map
    from ceph_tpu_torch.osdmap.pipeline import PoolMapper

    m, w, _ = make_synthetic_map(**SYNTH)
    # mappers built on the start state: after the run their tables are
    # stale until refresh_tables
    mappers = {pid: PoolMapper(m, pid, device=dev) for pid in m.pools}
    # K2 against its plain walk on the shadow trees (not counted)
    launches = crush_rule_batched.launches
    for pid, pm in mappers.items():
        weight = pm.runtime_args()[0]
        got = crush_rule_batched(pm.arrays, pm.prog, weight, pm.pps_i32)
        want = map_batch_plain(pm.arrays, pm.prog, weight, pm.pps_i32)
        if max(max_abs_err(got[0], want[0]), max_abs_err(got[1], want[1])):
            raise AssertionError(f"K2 differs from plain on 6a pool {pid}")
        log(f"k2 check 6a pool {pid} (rule {m.pools[pid].crush_rule}, "
            f"{m.pools[pid].pg_num} PGs, {len(m.crush.buckets)} buckets "
            f"with the shadow trees): equal")
    crush_rule_batched.launches = launches
    with SplitTimer(dev) as timer:
        for pm in mappers.values():
            pm.map_all()
        timer.zero()
        t0 = time.perf_counter()
        rec = run_offline(m, w, device=dev, **OFFLINE)
        wall = time.perf_counter() - t0
        split = timer.split(wall)
        cpu_run = pool.submit(_offline_cpu, SYNTH, OFFLINE)
        checked = check_changed(pool, m, mappers,
                                changed_pgs({}, m.pg_upmap_items),
                                "balancer 6a")
        calls = timer.calls
    traj = rec["stddev_trajectory"]
    if rec["upmaps"] and not all(b < a for a, b in zip(traj, traj[1:])):
        raise AssertionError(f"6a stddev trajectory not falling: {traj}")
    out = {**rec, "split": split,
           "round_s": wall / max(1, rec["rounds"]),
           "changed_pgs_checked": checked}
    log(f"balancer 6a: {rec['rounds']} rounds, {rec['upmaps']} upmaps, "
        f"stddev {rec['initial_stddev']} -> {rec['final_stddev']}, "
        f"converged={rec['converged']}; wall {wall:.3f} s, "
        f"{wall / max(1, rec['rounds']):.3f} s a round "
        f"(map_all {split['map_all_device_ms']:.2f} ms device / "
        f"{split['map_all_host_s']:.3f} s host over "
        f"{split['map_all_calls']} calls, tally {split['tally_s']:.3f} s, "
        f"search {split['search_s']:.3f} s, other host "
        f"{split['other_host_s']:.3f} s)")

    def against_cpu():
        cpu_rec, cpu_items, cpu_s = cpu_run.result()
        card = {k: v for k, v in rec.items() if k not in TIMING}
        plain = {k: v for k, v in cpu_rec.items() if k not in TIMING}
        if card != plain:
            raise AssertionError(f"6a record on the card {card} != on the "
                                 f"CPU {plain}")
        if sorted(m.pg_upmap_items.items()) != cpu_items:
            raise AssertionError("6a final pg_upmap_items differ between "
                                 "the card and the CPU")
        out.update(cpu_run_s=cpu_s, cpu_sweep_s=cpu_rec["sweep_s"])
        log(f"balancer 6a: record and pg_upmap_items equal to the CPU "
            f"run's ({cpu_s:.1f} s, sweeps {cpu_rec['sweep_s']} s)")

    return out, calls, against_cpu


def phase_balancer_big(dev, pool, m, mappers):
    """6b: ``evaluate`` of phase 5's cluster through its cached mappers,
    an upmap edit, ``evaluate`` again, then one ``calc_pg_upmaps`` with
    osdmaptool's defaults on pool 1; changed PGs held to the scalar
    pipeline, pool 1's stddev must fall if anything changed."""
    from ceph_tpu_torch.crush.wrapper import CrushWrapper
    from ceph_tpu_torch.mgr.balancer_module import evaluate
    from ceph_tpu_torch.osdmap.balancer import (build_pgs_by_osd,
                                                calc_pg_upmaps)

    w = CrushWrapper(m.crush)
    start = dict(m.pg_upmap_items)
    rng = np.random.default_rng(14)
    with SplitTimer(dev) as timer:
        t0 = time.perf_counter()
        ev1 = evaluate(m, w, mappers=mappers, device=dev)
        eval1_s = time.perf_counter() - t0
        # an upmap edit on 0.1% of pool 1's PGs: each moves its first OSD
        # to a random one
        pool1 = m.pools[1]
        for ps in rng.choice(pool1.pg_num, pool1.pg_num // 1000,
                             replace=False):
            pg = (1, int(ps))
            if pg in m.pg_upmap or pg in m.pg_upmap_items:
                continue
            up = m.pg_to_up_acting_osds(1, int(ps))[0]
            if up:
                m.pg_upmap_items[pg] = [(up[0], int(rng.integers(
                    m.max_osd)))]
        t0 = time.perf_counter()
        ev2 = evaluate(m, w, mappers=mappers, device=dev)
        eval2_s = time.perf_counter() - t0
        before = dict(m.pg_upmap_items)
        t0 = time.perf_counter()
        changed = timer.calc(calc_pg_upmaps, m, wrapper=w, mappers=mappers,
                             device=dev, **UPMAP_BIG)
        calc_s = time.perf_counter() - t0
        split = timer.split(eval1_s + eval2_s + calc_s)
        # one of calc_pg_upmaps' per-try copies of the tally, alone
        tally = build_pgs_by_osd(m, {1}, True, mappers, device=dev)
        t0 = time.perf_counter()
        {o: set(p) for o, p in tally.items()}
        copy_s = time.perf_counter() - t0
        ev3 = evaluate(m, w, only_pools={1}, mappers=mappers, device=dev)
        checked = check_changed(pool, m, mappers,
                                changed_pgs(start, m.pg_upmap_items),
                                "balancer 6b")
        calls = timer.calls
    sd_before, sd_after = ev2["pools"][1]["stddev"], ev3["stddev"]
    if changed and not sd_after < sd_before:
        raise AssertionError(f"6b: {changed} changes, pool 1 stddev "
                             f"{sd_before} -> {sd_after}")
    if len(changed_pgs(before, m.pg_upmap_items)) > changed:
        raise AssertionError("6b: more PGs changed than calc_pg_upmaps "
                             "reported")
    out = {"pgs": ev1["mapped_pgs"], "stddev_eval1": ev1["stddev"],
           "stddev_eval2": ev2["stddev"], "eval1_s": eval1_s,
           "eval2_s": eval2_s, "calc_s": calc_s, "changes": changed,
           "pool1_stddev_before": sd_before, "pool1_stddev_after": sd_after,
           "split": split, "temp_copy_s": copy_s,
           "changed_pgs_checked": checked,
           "params": {k: sorted(v) if isinstance(v, set) else v
                      for k, v in UPMAP_BIG.items()}}
    log(f"balancer 6b: evaluate {ev1['mapped_pgs']} PGs {eval1_s:.3f} s, "
        f"after an edit {eval2_s:.3f} s; calc_pg_upmaps {calc_s:.3f} s, "
        f"{changed} changes, pool 1 stddev {sd_before:.4f} -> "
        f"{sd_after:.4f} (map_all {split['map_all_device_ms']:.2f} ms "
        f"device / {split['map_all_host_s']:.3f} s host, tally "
        f"{split['tally_s']:.3f} s, search {split['search_s']:.3f} s, "
        f"other host {split['other_host_s']:.3f} s; one copy of pool 1's "
        f"tally {copy_s:.3f} s)")
    return out, calls


# -- phase 7 ----------------------------------------------------------

# BASELINE.json config 5's scale: 1 M PGs through rule 0; rule 1 (EC 8+3,
# indep numrep 11) over a quarter of that
SWEEP_REP = 1 << 20
SWEEP_EC = 1 << 18
SWEEP_ROWS = 65536    # the chunk of rows held to the plain walk on the card
C_MAPPINGS_PER_S = 85099.6   # BASELINE_MEASURED.json, one thread of C


def run_tool(tool, args):
    """(exit code, stdout) of ``tool.main(args)``."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = tool.main([str(a) for a in args])
    return rc, buf.getvalue()


def same_report(a, b, label):
    """Two RuleReports equal field for field (bad rows as arrays)."""
    if (a.total, a.size_counts) != (b.total, b.size_counts) or \
            not np.array_equal(a.device_stored, b.device_stored) or \
            not np.array_equal(a.device_expected, b.device_expected):
        raise AssertionError(f"crushtool {label}: reports differ")
    ab, bb = a.bad_rows, b.bad_rows
    if (ab is None) != (bb is None) or ab is not None and not all(
            np.array_equal(u, v) for u, v in zip(ab, bb)):
        raise AssertionError(f"crushtool {label}: bad rows differ")


def host_median(fn, runs=5):
    """Median host seconds of ``fn()`` (ending in a synchronise) over
    ``runs`` calls after one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    took = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        took.append(time.perf_counter() - t0)
    return float(np.median(took))


def phase_crushtool(dev, workdir, card, n_rep=SWEEP_REP, n_ec=SWEEP_EC,
                    n_rows=SWEEP_ROWS):
    """crushtool and CrushTester on ``map_big10k`` and on the sample map
    made with crushtool's own verbs; returns (record, card sweeps made:
    one K2 launch each)."""
    import torch

    from ceph_tpu_torch import build
    from ceph_tpu_torch.crush import native
    from ceph_tpu_torch.crush.hash import hash32_2_int
    from ceph_tpu_torch.crush.map_arrays import as_i32
    from ceph_tpu_torch.crush.mapper import (N_ALGS, BatchedMapper,
                                             crush_rule_batched,
                                             map_batch_plain)
    from ceph_tpu_torch.crush.wrapper import CrushWrapper
    from ceph_tpu_torch.parallel.placement import utilization
    from ceph_tpu_torch.tools import crushtool
    from ceph_tpu_torch.tools.tester import CrushTester

    t_phase = time.perf_counter()
    native_build_s = build.build_host()
    threads = native.threads()
    sweeps = 0
    cmap, _ = load_map("map_big10k")
    w = CrushWrapper(cmap)
    big = os.path.join(workdir, "map_big10k.json")
    with open(big, "w") as f:
        json.dump(w.to_dict(), f)
    tester = CrushTester(crushtool.load_map(big))
    out = {"card": card, "native_threads": threads,
           "native_build_s": native_build_s}

    for ruleno, numrep, n in ((0, 3, n_rep), (1, 11, n_ec)):
        tag = f"rule {ruleno} numrep {numrep} x 0..{n - 1}"
        # test_rule's two halves, so that every row can be checked
        xs, rows, lens = tester.sweep(ruleno, numrep, 0, n - 1, device=dev)
        sweeps += 1
        rep = tester.report(ruleno, numrep, 0, n - 1, xs, rows, lens)
        nxs, nrows, nlens = tester.sweep(ruleno, numrep, 0, n - 1,
                                         native=True)
        nat = tester.report(ruleno, numrep, 0, n - 1, nxs, nrows, nlens)
        same_report(rep, nat, f"{tag} card/native")
        if not (torch.equal(rows.cpu(), nrows)
                and torch.equal(lens.cpu(), nlens)):
            raise AssertionError(f"crushtool {tag}: the card's rows differ "
                                 f"from the native engine's")
        # every row against the plain walk on the card, in chunks
        bm = tester.mapper(dev)
        prog = bm.program(ruleno, numrep)
        weight = as_i32(np.asarray(tester.weights, np.uint32), dev)
        xs32 = as_i32(xs, dev)
        for lo in range(0, n, n_rows):
            prows, plens = map_batch_plain(bm.arrays, prog, weight,
                                           xs32[lo:lo + n_rows])
            if max_abs_err(rows[lo:lo + n_rows], prows) or \
                    max_abs_err(lens[lo:lo + n_rows], plens):
                raise AssertionError(f"crushtool {tag}: the card's rows "
                                     f"from x={lo} differ from the plain "
                                     f"walk's")
        log(f"crushtool {tag}: report equal to the native engine's "
            f"(sizes {rep.size_counts}, {len(rep.bad)} bad); all {n} rows "
            f"equal to native's and to the plain walk's on the card")

        # timings, all after a warm-up: test_rule, sweep and report on
        # the host clock (each ending in a sync); K2, the xs and the
        # stats pass's device ops alone by CUDA events; the native
        # engine on the host clock
        rec = {"pgs": n}
        rec["test_rule_s"] = host_median(
            lambda: tester.test_rule(ruleno, numrep, 0, n - 1, device=dev))
        rec["sweep_host_s"] = host_median(lambda: tester.sweep(
            ruleno, numrep, 0, n - 1, device=dev))
        sweeps += 12
        rec["report_host_s"] = host_median(lambda: tester.report(
            ruleno, numrep, 0, n - 1, xs, rows, lens))
        # bare launches, to time K2 and find its bound: not the
        # crushtool path's, so the count is restored after them
        launches = crush_rule_batched.launches
        rec["k2_ms"] = cuda_ms(lambda i: crush_rule_batched(
            bm.arrays, prog, weight, xs32), 5)
        draws = torch.zeros((n, N_ALGS), dtype=torch.int32, device=dev)
        crush_rule_batched(bm.arrays, prog, weight, xs32, draws=draws)
        crush_rule_batched.launches = launches
        rec["k2_bound_ms"], rec["k2_bound_by"], _ = k2_bound_ms(
            bm.arrays, prog, n, weight, draws)
        rec["xs_ms"] = cuda_ms(lambda i: as_i32(torch.arange(
            0, n, dtype=torch.int64, device=dev) & 0xFFFFFFFF, dev), 5)
        n_dev = tester.w.crush.max_devices
        rec["stats_device_ms"] = cuda_ms(lambda i: (
            utilization(rows, lens, n_dev),
            torch.bincount(lens.to(torch.int64)),
            (lens != numrep).nonzero()), 5)
        rec["tally_bound_ms"] = tally_bound_ms(rows, lens, n_dev)
        # what the sweep and the report, timed apart, leave of a call:
        # negative where the host's work overlaps the card's in a call
        rec["rest_s"] = rec["test_rule_s"] - rec["sweep_host_s"] \
            - rec["report_host_s"]
        rec["mapper_setup_s"] = host_median(
            lambda: BatchedMapper(cmap, device=dev))
        rec["native_s"] = host_median(lambda: tester.test_rule(
            ruleno, numrep, 0, n - 1, native=True), runs=3)
        rec["mappings_per_s"] = n / rec["test_rule_s"]
        rec["native_mappings_per_s"] = n / rec["native_s"]
        rec["vs_c_thread"] = rec["mappings_per_s"] / C_MAPPINGS_PER_S
        rec["vs_native"] = rec["native_s"] / rec["test_rule_s"]
        out[f"rule{ruleno}"] = rec
        log(f"crushtool {tag}: test_rule {rec['test_rule_s'] * 1e3:.3f} ms "
            f"({rec['mappings_per_s']:.4g} mappings/s, "
            f"{rec['vs_c_thread']:.1f}x a C thread) = sweep "
            f"{rec['sweep_host_s'] * 1e3:.3f} ms + report "
            f"{rec['report_host_s'] * 1e3:.3f} ms + rest "
            f"{rec['rest_s'] * 1e3:.3f} ms; device: xs "
            f"{rec['xs_ms']:.4f} ms, K2 {rec['k2_ms']:.4f} ms (bound "
            f"{rec['k2_bound_ms']:.4f}, {rec['k2_bound_by']}), stats ops "
            f"{rec['stats_device_ms']:.4f} ms (the tally's byte bound "
            f"{rec['tally_bound_ms']:.4f} ms); map lowering (once a "
            f"tester) {rec['mapper_setup_s'] * 1e3:.2f} ms; native "
            f"{rec['native_s'] * 1e3:.1f} ms on {threads} threads "
            f"({rec['native_mappings_per_s']:.4g} mappings/s): the card "
            f"{rec['vs_native']:.1f}x; on {card}")

    # crushtool's text: card and native byte-equal
    for ruleno, numrep, n in ((0, 3, n_rep), (1, 11, n_ec)):
        args = ["-i", big, "--test", "--rule", ruleno, "--num-rep", numrep,
                "--max-x", n - 1, "--show-statistics", "--show-utilization",
                "--show-bad-mappings"]
        card_out = run_tool(crushtool, args + ["--device", dev.type])
        sweeps += 1
        if card_out[0] != 0 or card_out != run_tool(crushtool,
                                                    args + ["--native"]):
            raise AssertionError(f"crushtool --test rule {ruleno}: the "
                                 f"card's text differs from native's")
        log(f"crushtool --test rule {ruleno} numrep {numrep} over {n} x: "
            f"{len(card_out[1].splitlines())} lines, byte-equal to "
            f"--native")

    # --pool: the xs hashed on the card
    xs, _, _ = tester.sweep(0, 3, 0, 4095, pool=1, device=dev)
    sweeps += 1
    if xs.cpu().tolist() != [hash32_2_int(x, 1) for x in range(4096)]:
        raise AssertionError("crushtool --pool 1: the card's xs differ "
                             "from hash32_2_int")
    same_report(tester.test_rule(0, 3, 0, 4095, pool=1, device=dev),
                tester.test_rule(0, 3, 0, 4095, pool=1, native=True),
                "--pool 1 card/native")
    sweeps += 1
    log("crushtool --pool 1: 4096 hashed xs equal to hash32_2_int, report "
        "equal to native")

    # --compare against a copy with one host at half weight
    w2 = crushtool.load_map(big)
    host = w2.get_bucket(min(b.id for b in w2.crush.buckets.values()
                             if b.type == 1))
    for item, wt in list(zip(host.items, host.item_weights)):
        w2.adjust_item_weight(item, wt // 2)
    other = os.path.join(workdir, "map_big10k_half_host.json")
    crushtool.save_map(w2, other)
    args = ["-i", big, "--compare", other, "--rule", 0, "--num-rep", 3,
            "--max-x", n_rep - 1]
    card_cmp = run_tool(crushtool, args + ["--device", dev.type])
    sweeps += 2
    if card_cmp[0] != 0 or card_cmp != run_tool(crushtool,
                                                args + ["--native"]):
        raise AssertionError("crushtool --compare: card and native differ")
    out["compare"] = card_cmp[1].strip()
    log(f"crushtool --compare, host {host.id} at half weight: "
        f"{out['compare']} (equal to --native)")

    # BASELINE.json config 1's sample map, made with crushtool's verbs
    s1, s2 = (os.path.join(workdir, f"sample{i}.json") for i in (1, 2))
    stxt = os.path.join(workdir, "sample.txt")
    for args in (["--build", "--num-osds", 12, "-o", s1, "host", "straw2",
                  4, "root", "straw2", 0],
                 ["-i", s1, "--create-replicated-rule", "replicated_rule",
                  "root", "host"],
                 ["-d", s1, "-o", stxt], ["-c", stxt, "-o", s2]):
        if run_tool(crushtool, args)[0] != 0:
            raise AssertionError(f"crushtool {args[:2]} failed")
    args = ["-i", s2, "--test", "--num-rep", 3, "--max-x", 1023,
            "--show-statistics", "--show-utilization"]
    card_out = run_tool(crushtool, args + ["--device", dev.type])
    sweeps += 1
    if card_out != run_tool(crushtool, args + ["--native"]) or \
            "result size == 3:\t1024/1024" not in card_out[1]:
        raise AssertionError("crushtool sample map: card and native text "
                             "differ, or a mapping fell short")
    log("crushtool sample map (--build 12 OSDs, 3 straw2 hosts, "
        "--create-replicated-rule, -d, -c): --test of 1024 x equal to "
        "--native, every mapping of size 3")
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"crushtool phase: {out['phase_s']:.1f} s")
    return out, sweeps


# -- phase 8 ----------------------------------------------------------

EC_OBJECT = 4 << 20   # the default RADOS object size of RBD and CephFS
EC_ITERS = 100      # 200 until phase 15 came (PERF.md section 4)
EC_NATIVE_ITERS = 20  # the native engine's timed calls (encode, random)
EC_BATCH = 64
EC_CHECK = 1 << 16    # columns of each K1 product held to its plain version
EC_RULE_PGS = 65536
# (label, plugin, profile, BASELINE.json config or None, erasures of the
# exhaustive decode sweep: m, or c for SHEC, whose durability it is)
EC_PROFILES = (
    ("jerasure reed_sol_van k=4 m=2", "jerasure",
     {"technique": "reed_sol_van", "k": "4", "m": "2"}, 2, 2),
    ("isa reed_sol_van k=8 m=3", "isa", {"k": "8", "m": "3"}, 3, 3),
    ("lrc k=4 m=2 l=3", "lrc", {"k": "4", "m": "2", "l": "3"}, 4, 2),
    ("shec k=4 m=3 c=2", "shec", {"k": "4", "m": "3", "c": "2"}, None, 2),
    ("clay k=4 m=2", "clay", {"k": "4", "m": "2"}, None, 2),
    ("isa cauchy k=8 m=3", "isa",
     {"technique": "cauchy", "k": "8", "m": "3"}, None, 3),
    ("jerasure reed_sol_r6_op k=8 m=2", "jerasure",
     {"technique": "reed_sol_r6_op", "k": "8", "m": "2"}, None, 2),
)
# rules only: an LRC rule with locality (choose indep racks, then
# chooseleaf indep hosts) and an isa rule through a device class's
# shadow tree
EC_RULE_ONLY = (
    ("lrc k=4 m=2 l=3 crush-locality=rack", "lrc",
     {"k": "4", "m": "2", "l": "3", "crush-locality": "rack"}),
    ("isa k=8 m=3 crush-device-class=ssd", "isa",
     {"k": "8", "m": "3", "crush-device-class": "ssd"}),
)
CORPUS_W8 = ("clay-k=4-m=2", "isa-k=8-m=3",
             "jerasure-k=4-m=2-technique=reed_sol_van-w=8",
             "lrc-k=4-l=3-m=2", "shec-c=2-k=4-m=3")
CORPUS_PACKET = "jerasure-k=4-m=3-packetsize=8-technique=cauchy_good-w=8"


class K1Tap:
    """Replaces ``gf2_kernels.gf2_matmul_w8`` (which every plugin calls
    through its module) while open.  ``check``: each product's first
    ``EC_CHECK`` columns are held to the plain version on the same
    device.  ``record``: each launch's arguments are kept, to be
    replayed.  The launches made meanwhile add to the tap's own count,
    never to the kernel's."""

    def __init__(self, check=False, record=False):
        self.check, self.record = check, record
        self.calls, self.products = [], 0

    def __enter__(self):
        import torch

        from ceph_tpu_torch.ec import gf2_kernels

        self.mod, self.real = gf2_kernels, gf2_kernels.gf2_matmul_w8
        real, plain = self.real, gf2_kernels.gf2_matmul_w8_plain

        def tap(bm, data, fragments=None):
            out = real(bm, data, fragments)
            if self.record:
                self.calls.append((bm, data, fragments))
            if self.check:
                rows = torch.stack([r[:EC_CHECK] for r in data]) \
                    if isinstance(data, (list, tuple)) \
                    else data[..., :EC_CHECK]
                if max_abs_err(out[..., :EC_CHECK], plain(bm, rows)):
                    raise AssertionError(
                        f"K1 differs from its plain version on a plugin's "
                        f"product {tuple(bm.shape)}")
                self.products += 1
            return out

        tap.launches = 0
        self.mod.gf2_matmul_w8 = tap
        return self

    def __exit__(self, *exc):
        self.mod.gf2_matmul_w8 = self.real
        return False

    def replay(self, i=0):
        for bm, data, frag in self.calls:
            self.real(bm, data, frag)

    def bound_ms(self):
        """The recorded launches' byte bound: each input row read once,
        each output row and the bit matrix written or read once."""
        nbytes = 0
        for bm, data, _ in self.calls:
            k, m = bm.shape[1] // 8, bm.shape[0] // 8
            cols = data[0].numel() if isinstance(data, (list, tuple)) \
                else data.numel() // k
            nbytes += (k + m) * cols + bm.numel()
        return nbytes / HBM_BYTES_PER_S * 1e3


def tally_bound_ms(rows, lens, n_dev):
    """``utilization``'s byte bound: the results and the lengths (int32)
    read once, the int64 counts written once."""
    return (rows.numel() * 4 + lens.numel() * 4 + n_dev * 8) \
        / HBM_BYTES_PER_S * 1e3


def run_tool_err(tool, args):
    """(exit code, stdout, stderr) of ``tool.main(args)``."""
    import contextlib
    import io

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = tool.main([str(a) for a in args])
    return rc, out.getvalue(), err.getvalue()


def ec_bench_args(plugin, profile, workload, device, erasures=None,
                  exhaustive=False, iters=EC_ITERS):
    args = ["--plugin", plugin, "--device", device]
    for key, v in profile.items():
        args += ["-P", f"{key}={v}"]
    args += ["--workload", workload, "--size", EC_OBJECT, "--iterations",
             iters, "--verify"]
    if erasures:
        args += ["--erasures", erasures]
    if exhaustive:
        args += ["--erasures-generation", "exhaustive"]
    return args


def ec_tool_rate(tool, args, label):
    """(GB/s, seconds) of an ec_benchmark run from its reference line."""
    rc, out, err = run_tool_err(tool, args)
    if rc != 0:
        raise AssertionError(f"ec_benchmark {label} exited {rc}: {err}")
    elapsed, kib = out.strip().split("\t")
    return int(kib) * 1024 / float(elapsed) / 1e9, float(elapsed)


def ec_workloads(n, erasures):
    """(name, ec_benchmark erasure flags, the erasure sets it decodes)."""
    from ceph_tpu_torch.tools.ec_benchmark import erasure_sets

    return (("encode", {}, None),
            ("decode_1_random", {"erasures": 1},
             erasure_sets(n, 1, "random", EC_ITERS)),
            (f"decode_{erasures}_exhaustive",
             {"erasures": erasures, "exhaustive": True},
             erasure_sets(n, erasures, "exhaustive", 0)))


def ec_check_bytes(code, oracle, raw, workloads, label):
    """Every chunk of an encode of ``raw`` and every decode of the
    workloads' erasure sets on the card equal to ``oracle``'s (the
    same profile on the native engine, or on the CPU), and to the
    object; each K1 product's first columns equal to the plain
    version's on the card.  Returns the products checked."""
    import torch

    n = code.get_chunk_count()
    want = {code.chunk_index(i) for i in range(code.get_data_chunk_count())}
    with K1Tap(check=True) as tap:
        card = code.encode(range(n), raw)
        ref = oracle.encode(range(n), raw)
        for i in range(n):
            if not torch.equal(card[i].cpu(), ref[i].cpu()):
                raise AssertionError(f"{label}: chunk {i} differs from the "
                                     f"oracle's")
        sets = sorted({e for _, _, es in workloads if es for e in es})
        for erased in sets:
            avail = {i: c for i, c in card.items() if i not in erased}
            got = code.decode(want, avail)
            exp = oracle.decode(want, {i: ref[i] for i in avail})
            for i in want:
                if not torch.equal(got[i].cpu(), exp[i].cpu()):
                    raise AssertionError(f"{label}: decode of {erased} "
                                         f"differs from the oracle's")
            back = code.decode_concat(avail).cpu().numpy().tobytes()
            if back[:len(raw)] != raw:
                raise AssertionError(f"{label}: decode of {erased} did not "
                                     f"give the object back")
    return tap.products, len(sets)


def ec_call_times(code, raw, sets):
    """One encode (``sets`` None) or one decode of the first of ``sets``
    that loses a data chunk: its K1 launches replayed in a CUDA graph
    (device ms a call), and the copy of the object to the card alone
    (ms, encode only)."""
    import torch

    n = code.get_chunk_count()
    dev = code.device
    chunks = code.encode(range(n), raw)
    want = {code.chunk_index(i) for i in range(code.get_data_chunk_count())}
    erased = None if sets is None else next(
        (e for e in sets if want & set(e)), sets[0])
    with K1Tap(record=True) as tap:
        if erased is None:
            code.encode(range(n), raw)
        else:
            code.decode(want, {i: c for i, c in chunks.items()
                               if i not in erased})
    k1_ms = cuda_graph_ms(tap.replay, 1) if tap.calls else 0.0
    src = torch.frombuffer(bytearray(raw), dtype=torch.uint8)
    h2d_ms = cuda_ms(lambda i: src.to(dev), 10) if erased is None else None
    return k1_ms, len(tap.calls), tap.bound_ms(), h2d_ms


def big10k_wrapper():
    """``map_big10k`` as a named CrushWrapper: its root is ``default``
    and every even OSD is of class ``ssd``, every odd one ``hdd``."""
    from ceph_tpu_torch.crush.wrapper import CrushWrapper

    cmap, cases = load_map("map_big10k")
    w = CrushWrapper(cmap)
    (root,) = [b.id for b in cmap.buckets.values() if b.type == 3]
    w.set_item_name(root, "default")
    for o in range(cmap.max_devices):
        w.set_item_class(o, "ssd" if o % 2 == 0 else "hdd")
    return w, np.asarray(cases[0]["weight"], np.uint32)


def phase_ec_plugins(dev, workdir, card):
    """The EC plugins on the card: ec_benchmark for every profile, the
    batched encode, the corpus and each plugin's rule through K2.
    Returns (records, K1 launches of the main path, K2 launches)."""
    import shutil

    import torch

    from ceph_tpu_torch.crush import mapper, native
    from ceph_tpu_torch.crush.mapper import BatchedMapper
    from ceph_tpu_torch.ec import gf2_kernels
    from ceph_tpu_torch.ec.registry import factory
    from ceph_tpu_torch.tools import ec_benchmark, ec_non_regression

    t_phase = time.perf_counter()
    out = {"card": card, "native_threads": native.threads(), "runs": []}
    raw = ec_benchmark.payload(EC_OBJECT)

    # the main path, with K1's count at 0: ec_benchmark runs on the card,
    # then the batched encode and the corpus
    gf2_kernels.gf2_matmul_w8.launches = 0
    for label, plugin, profile, config, erasures in EC_PROFILES:
        code = factory(plugin, profile, device=dev)
        for wl, flags, sets in ec_workloads(code.get_chunk_count(),
                                            erasures):
            gbps, secs = ec_tool_rate(ec_benchmark, ec_bench_args(
                plugin, profile, wl.split("_")[0], dev.type, **flags),
                f"{label} {wl}")
            calls = len(sets) if sets else EC_ITERS
            out["runs"].append({"profile": label, "baseline_config": config,
                                "workload": wl, "gbps": gbps,
                                "ms_per_call": secs / calls * 1e3,
                                "calls": calls})
    isa = factory("isa", {"k": "8", "m": "3"}, device=dev)
    rng = np.random.default_rng(8)
    raws = [rng.integers(0, 256, EC_OBJECT, dtype=np.uint8).tobytes()
            for _ in range(EC_BATCH)]
    n = isa.get_chunk_count()
    batched = isa.encode_batched(range(n), raws)   # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    batched = isa.encode_batched(range(n), raws)
    torch.cuda.synchronize()
    batch_s = time.perf_counter() - t0
    corpus_ok = os.path.join(workdir, "corpus_w8")
    for name in CORPUS_W8:
        shutil.copytree(os.path.join(REPO, "tests", "corpus", name),
                        os.path.join(corpus_ok, name))
    rc, text, err = run_tool_err(ec_non_regression, [
        "--check", "--device", dev.type, "--base", corpus_ok])
    if rc != 0 or "checked 5 corpus entries: OK" not in text:
        raise AssertionError(f"ec_non_regression --check of the w=8 "
                             f"corpus: {rc} {text} {err}")
    k1_launches = gf2_kernels.gf2_matmul_w8.launches
    if k1_launches < 1:
        raise AssertionError("gf2_matmul_w8 was not launched on the EC "
                             "plugins' path")
    log(f"ec corpus: ec_non_regression --check --device {dev.type} of "
        f"{len(CORPUS_W8)} w=8 directories: {text.strip()}")

    # checks, with K1's count set aside: every profile's bytes against
    # the native engine (SHEC, which has none, against the CPU), each
    # product against the plain version; then device times
    for label, plugin, profile, config, erasures in EC_PROFILES:
        code = factory(plugin, profile, device=dev)
        oracle = factory(plugin, profile, device="cpu") if plugin == "shec" \
            else factory(plugin, {**profile, "engine": "native"})
        wls = ec_workloads(code.get_chunk_count(), erasures)
        products, n_sets = ec_check_bytes(code, oracle, raw, wls, label)
        native_by = "the CPU (no native engine)" if plugin == "shec" \
            else "native"
        log(f"ec check {label}: encode and {n_sets} decodes of a "
            f"{EC_OBJECT}-byte object equal to {native_by} and to the "
            f"object; {products} K1 products' first {EC_CHECK} columns "
            f"equal to the plain version")
        for rec in out["runs"]:
            if rec["profile"] != label:
                continue
            wl = rec["workload"]
            sets = dict((w, s) for w, _, s in wls)[wl]
            (rec["k1_ms"], rec["k1_launches_per_call"],
             rec["k1_bound_ms"], rec["h2d_ms"]) = ec_call_times(code, raw,
                                                                sets)
            if plugin != "shec":
                flags = dict((w, f) for w, f, _ in wls)[wl]
                rec["native_gbps"], _ = ec_tool_rate(
                    ec_benchmark, ec_bench_args(
                        plugin, {**profile, "engine": "native"},
                        wl.split("_")[0], "cpu", iters=EC_NATIVE_ITERS,
                        **flags), f"{label} {wl} native")
            else:
                rec["native_gbps"] = None
            log("ec_plugins: " + json.dumps({"card": card, **rec}))

    # the batched encode, held to per-object encodes and the native engine
    nat = factory("isa", {"k": "8", "m": "3", "engine": "native"})
    for b in range(EC_BATCH):
        one = isa.encode(range(n), raws[b])
        ref = nat.encode(range(n), raws[b])
        for i in range(n):
            if not (torch.equal(batched[b][i], one[i])
                    and torch.equal(batched[b][i].cpu(), ref[i])):
                raise AssertionError(f"encode_batched object {b} chunk {i} "
                                     f"differs from encode or native")
    with K1Tap(record=True) as tap:
        isa.encode_batched(range(n), raws)
    srcs = [torch.frombuffer(bytearray(r), dtype=torch.uint8) for r in raws]
    h2d_ms = cuda_ms(lambda i: [s.to(dev) for s in srcs], 3)
    rec = {"profile": "isa reed_sol_van k=8 m=3", "baseline_config": 3,
           "workload": f"encode_batched {EC_BATCH} x {EC_OBJECT}",
           "gbps": EC_BATCH * EC_OBJECT / batch_s / 1e9,
           "ms_per_call": batch_s * 1e3,
           "k1_ms": cuda_graph_ms(tap.replay, 1),
           "k1_launches_per_call": len(tap.calls),
           "k1_bound_ms": tap.bound_ms(), "h2d_ms": h2d_ms}
    t0 = time.perf_counter()
    for b in range(EC_BATCH):
        nat.encode(range(n), raws[b])
    rec["native_gbps"] = EC_BATCH * EC_OBJECT / (time.perf_counter() - t0) \
        / 1e9
    out["runs"].append(rec)
    log("ec_plugins: " + json.dumps({"card": card, **rec}))
    del batched, raws, srcs

    # each plugin's rule on map_big10k through K2, against native
    w, weight = big10k_wrapper()
    mapper.crush_rule_batched.launches = 0
    rules = []
    for label, plugin, profile, *_ in EC_PROFILES + EC_RULE_ONLY:
        code = factory(plugin, profile, device=dev)
        rules.append((label, code.create_rule(f"ec {label}", w),
                      code.get_chunk_count()))
    w._refresh_shadow()
    bm = BatchedMapper(w.crush, device=dev)
    nm = native.NativeMapper(w.crush)
    xs = np.arange(EC_RULE_PGS, dtype=np.uint32)
    for label, rid, size in rules:
        res, lens = bm.map_batch(rid, xs, size, weight)
        nres, nlens = nm.map_batch(rid, xs, size, weight)
        res, lens = res.cpu().numpy(), lens.cpu().numpy()
        cols = np.arange(size)[None, :]
        if not (np.array_equal(lens, nlens) and np.array_equal(
                np.where(cols < lens[:, None], res, 0),
                np.where(cols < nlens[:, None], nres, 0))):
            raise AssertionError(f"rule of {label}: K2 differs from native")
        log(f"ec rule {label}: rule {rid} "
            f"{[(s.op, s.arg1, s.arg2) for s in w.crush.rules[rid].steps]}"
            f" over {EC_RULE_PGS} PGs, {int((lens == size).sum())} full: "
            f"K2 equal to native")
    k2_launches = mapper.crush_rule_batched.launches
    if k2_launches != len(rules):
        raise AssertionError(f"{len(rules)} EC rules launched K2 "
                             f"{k2_launches} times")
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"ec plugins phase: {out['phase_s']:.1f} s")
    return out, k1_launches, k2_launches

# -- phase 9 ----------------------------------------------------------

LAYOUT_ITERS = 50          # calls of each ec_benchmark run
LAYOUT_SMALL = 64 << 10    # the object of the checks against the CPU
K3_SETS = 16               # input sets K3's timing cycles through (> L2)
# (plugin, profile, decode every erasure of up to m chunks against the
# CPU: one profile a layout): ceph_tpu's jerasure grid
# (tests/test_jerasure.py), SHEC's wide words, an LRC layer and Clay's
# sub-codes on a packet technique
LAYOUT_PROFILES = (
    ("jerasure", {"technique": "reed_sol_van", "k": "2", "m": "2",
                  "w": "8"}, False),
    ("jerasure", {"technique": "reed_sol_van", "k": "3", "m": "2",
                  "w": "16"}, True),
    ("jerasure", {"technique": "reed_sol_van", "k": "4", "m": "3",
                  "w": "32"}, True),
    ("jerasure", {"technique": "reed_sol_r6_op", "k": "4", "m": "2",
                  "w": "8"}, False),
    ("jerasure", {"technique": "cauchy_orig", "k": "2", "m": "2", "w": "4",
                  "packetsize": "8"}, False),
    ("jerasure", {"technique": "cauchy_orig", "k": "4", "m": "3", "w": "8",
                  "packetsize": "8"}, False),
    ("jerasure", {"technique": "cauchy_good", "k": "4", "m": "3", "w": "8",
                  "packetsize": "8"}, True),
    ("jerasure", {"technique": "liberation", "k": "2", "m": "2", "w": "7",
                  "packetsize": "8"}, False),
    ("jerasure", {"technique": "blaum_roth", "k": "2", "m": "2", "w": "6",
                  "packetsize": "8"}, False),
    ("jerasure", {"technique": "liber8tion", "k": "2", "m": "2", "w": "8",
                  "packetsize": "8"}, False),
    ("shec", {"k": "4", "m": "3", "c": "2", "w": "16"}, True),
    ("shec", {"k": "4", "m": "3", "c": "2", "w": "32"}, False),
    ("lrc", {"mapping": "DD_", "layers": json.dumps(
        [["DDc", "technique=cauchy_good packetsize=8"]])}, False),
    ("clay", {"k": "4", "m": "2", "technique": "cauchy_good"}, False),
)


def layout_label(plugin, profile):
    return " ".join([plugin] + [f"{k}={v}" for k, v in profile.items()
                                if k != "layers"])


class K3Tap:
    """Replaces ``gf2_packet.gf2_packet`` (which the EC engine calls
    through its module) while open.  ``check``: every product, all its
    columns, is held to the plain version on the same device.
    ``record``: each launch's arguments are kept, to be replayed.  The
    launches made meanwhile add to the tap's own count, never to the
    kernel's."""

    def __init__(self, check=False, record=False):
        self.check, self.record = check, record
        self.calls, self.products = [], 0

    def __enter__(self):
        import torch

        from ceph_tpu_torch.ec import gf2_packet

        self.mod, self.real = gf2_packet, gf2_packet.gf2_packet
        real, plain = self.real, gf2_packet.gf2_packet_plain

        def tap(bm, data, w, ps, lists=None):
            out = real(bm, data, w, ps, lists)
            if self.record:
                self.calls.append((bm, data, w, ps, lists))
            if self.check:
                rows = torch.stack(list(data)) \
                    if isinstance(data, (list, tuple)) else data
                if max_abs_err(out, plain(bm, rows, w, ps)):
                    raise AssertionError(
                        f"K3 differs from its plain version on a plugin's "
                        f"product {tuple(bm.shape)} w={w} packetsize={ps}")
                self.products += 1
            return out

        tap.launches = 0
        self.mod.gf2_packet = tap
        return self

    def __exit__(self, *exc):
        self.mod.gf2_packet = self.real
        return False

    def replay(self, i=0):
        for call in self.calls:
            self.real(*call)

    def bound_ms(self):
        """The recorded launches' byte bound: each input row read once,
        each output row written once, the index lists read once."""
        nbytes = 0
        for bm, data, w, _, lists in self.calls:
            k, m = bm.shape[1] // w, bm.shape[0] // w
            cols = data[0].numel() if isinstance(data, (list, tuple)) \
                else data.numel() // k
            nbytes += (k + m) * cols + (0 if lists is None
                                        else 4 * lists.numel())
        return nbytes / HBM_BYTES_PER_S * 1e3


def layout_erasures(code, profile, every):
    """The erasure sets a check decodes: every set of up to m chunks, or
    every single one and the first set of m (c for SHEC)."""
    n = code.get_chunk_count()
    m = n - code.get_data_chunk_count()
    if every:
        return [e for c in range(1, m + 1)
                for e in itertools.combinations(range(n), c)]
    most = int(profile.get("c", m))
    return [(i,) for i in range(n)] + [tuple(range(most))]


def layout_check(code, cpu, profile, every, small, raw, label):
    """The profile on the card against the same profile on the CPU (the
    plain versions) on ``small``: every chunk of an encode and of each
    decode, the same errors; then ``raw`` (4 MiB) encoded and decoded
    with its first m chunks (c for SHEC) lost, the object back.  Every
    K1 product's first columns and every K3 product are held to the
    plain version on the card meanwhile.  Returns (decodes, K1 products,
    K3 products)."""
    import torch

    from ceph_tpu_torch.ec.interface import ErasureCodeError

    n = code.get_chunk_count()
    decodes = 0
    with K1Tap(check=True) as t1, K3Tap(check=True) as t3:
        card = code.encode(range(n), small)
        ref = cpu.encode(range(n), small)
        for i in range(n):
            if not torch.equal(card[i].cpu(), ref[i]):
                raise AssertionError(f"{label}: chunk {i} differs from the "
                                     f"CPU's")
        for erased in layout_erasures(code, profile, every):
            avail = {i: c for i, c in card.items() if i not in erased}
            # a set the code cannot decode (SHEC) must fail alike
            try:
                got = code.decode(set(range(n)), avail)
            except ErasureCodeError as e:
                got = e.errno
            try:
                exp = cpu.decode(set(range(n)), {i: ref[i] for i in avail})
            except ErasureCodeError as e:
                exp = e.errno
            if isinstance(got, int) or isinstance(exp, int):
                if got != exp:
                    raise AssertionError(f"{label}: decode of {erased}: "
                                         f"{got} on the card, {exp} on "
                                         f"the CPU")
                continue
            for i in range(n):
                if not torch.equal(got[i].cpu(), exp[i]):
                    raise AssertionError(f"{label}: decode of {erased} "
                                         f"differs from the CPU's")
            decodes += 1
        card = code.encode(range(n), raw)
        most = int(profile.get("c", n - code.get_data_chunk_count()))
        avail = {i: c for i, c in card.items() if i >= most}
        back = code.decode_concat(avail).cpu().numpy().tobytes()
        if back[:len(raw)] != raw:
            raise AssertionError(f"{label}: decode of the {len(raw)}-byte "
                                 f"object did not give it back")
    return decodes, t1.products, t3.products


def layout_call_times(code, raw, decode):
    """One encode, or one decode losing chunk 0: its K1 and K3 launches
    replayed in a CUDA graph (device ms a call), their counts and byte
    bound."""
    n = code.get_chunk_count()
    chunks = code.encode(range(n), raw)
    want = {code.chunk_index(i) for i in range(code.get_data_chunk_count())}
    with K1Tap(record=True) as t1, K3Tap(record=True) as t3:
        if decode:
            code.decode(want, {i: c for i, c in chunks.items() if i != 0})
        else:
            code.encode(range(n), raw)

    def replay(i):
        t1.replay()
        t3.replay()

    k_ms = cuda_graph_ms(replay, 1) if t1.calls or t3.calls else 0.0
    return k_ms, len(t1.calls), len(t3.calls), t1.bound_ms() + t3.bound_ms()


# K3's variants (csrc/gf2_packet.cuh's plan) at w=8, k=4, m=3, each held
# to the plain version on the card: (label, packet size, stripes, L, row
# offset (None: stripes in place), the plan's piece width, staging and
# tiles ("blocks": whole blocks, "ranges": column ranges of a block))
K3_VARIANTS = (
    ("bulk, a run a row", 128, 1, 1 << 20, None, 16, "bulk", "blocks"),
    ("bulk, a run a padded block", 112, 1, 896 * 1171, None, 16, "bulk",
     "blocks"),
    ("cp.async 16, padded blocks", 16, 1, 1 << 20, None, 16, "async",
     "blocks"),
    ("bulk, column ranges", 2048, 1, 1 << 20, None, 16, "bulk", "ranges"),
    ("bulk, ranges ending inside a block", 2064, 1, 16512 * 64, None, 16,
     "bulk", "ranges"),
    ("bulk, 4 stripes", 2048, 4, 1 << 20, None, 16, "bulk", "ranges"),
    ("cp.async 8, the last tile short", 8, 1, 1 << 20, None, 8, "async",
     "blocks"),
    ("cp.async 8, 4 stripes", 8, 4, 1 << 20, None, 8, "async", "blocks"),
    ("cp.async 4, rows 4 bytes off", 8, 1, 1 << 20, 4, 4, "async",
     "blocks"),
    ("plain 2, packet size 6", 6, 1, 48 * 21846, None, 2, "sync", "blocks"),
    ("plain 1, rows at odd offsets", 8, 1, 64 * 1000, 1, 1, "sync",
     "blocks"),
)


def check_k3_widths(dev):
    """K3 in each of its variants (``K3_VARIANTS``: the piece widths 16,
    8, 4, 2 and 1; bulk, cp.async and plain staging; whole-block tiles,
    the last one short, and column ranges, the last of a block short;
    one stripe, 4 stripes in place and rows read where they lie) against
    the plain version on a random bit matrix (w=8, k=4, m=3).  Returns
    the labels run."""
    import torch

    from ceph_tpu_torch.ec.gf2_packet import (gf2_packet, gf2_packet_plain,
                                              index_lists, packet_lists, plan)

    w, k, m = 8, 4, 3
    rng = np.random.default_rng(11)
    bm = torch.from_numpy(rng.integers(0, 2, (w * m, w * k),
                                       dtype=np.uint8)).to(dev)
    lists = packet_lists(bm, w)
    npad = index_lists(bm, w).numel() - 2 * w * m
    gen = torch.Generator(device=dev).manual_seed(11)
    run = []
    for label, ps, B, L, off, V, mode, tiles in K3_VARIANTS:
        data = torch.randint(0, 256, (B, k, L), dtype=torch.uint8,
                             device=dev, generator=gen)
        arg = data if B > 1 else data[0]
        addr = data.data_ptr() | k * L
        if off is not None:
            buf = torch.zeros(k * (L + off) + off, dtype=torch.uint8,
                              device=dev)
            arg, addr = [], 0
            for c in range(k):
                at = off + c * (L + off)
                buf[at:at + L] = data[0, c]
                arg.append(buf[at:at + L])
                addr |= arg[-1].data_ptr()
        got = plan(ps, w, k, m, npad, L, B, addr)
        if (got["vec_bytes"], got["mode"],
                "blocks" if got["blocks_per_tile"] else "ranges") \
                != (V, mode, tiles):
            raise AssertionError(f"K3 {label}: planned {got}")
        exp = gf2_packet_plain(bm, data if B > 1 else data[0], w, ps)
        if max_abs_err(gf2_packet(bm, arg, w, ps, lists), exp):
            raise AssertionError(f"K3 differs from plain: {label}")
        run.append(f"{label} ({got['tiles']} tiles)")
    del data, exp
    return run


def time_k3(dev, profile, batch=False):
    """K3 alone at a 4 MiB object's chunks of ``profile``: encode
    [k, L] cycling K3_SETS input sets, and the decode of its first two
    chunks through the inverse with the survivors as separate rows, each
    held to the plain version first; with ``batch``, also 4 stripes
    [4, k, L] in place, cycling K3_SETS / 4 sets."""
    import torch

    from ceph_tpu_torch.ec.gf2_packet import (gf2_packet, gf2_packet_plain,
                                              index_lists, plan)
    from ceph_tpu_torch.ec.registry import factory

    bc = factory("jerasure", profile, device=dev)._code
    k, m, w, ps = bc.k, bc.m, bc.layout.w, bc.layout.packetsize
    L = factory("jerasure", profile, device="cpu").get_chunk_size(EC_OBJECT)
    bm, lists = bc._enc_dev, bc._enc_frag
    npad = index_lists(bm, w).numel() - 2 * w * m
    gen = torch.Generator(device=dev).manual_seed(9)
    sets = [torch.randint(0, 256, (k, L), dtype=torch.uint8, device=dev,
                          generator=gen) for _ in range(K3_SETS)]
    for d in sets[:2]:
        if max_abs_err(gf2_packet(bm, d, w, ps, lists),
                       gf2_packet_plain(bm, d, w, ps)):
            raise AssertionError(f"K3 differs from plain on [{k}, {L}]")
    pl = plan(ps, w, k, m, npad, L, 1, sets[0].data_ptr() | k * L)
    rec = {"w": w, "packetsize": ps, "k": k, "m": m, "L": L,
           "vec_bytes": pl["vec_bytes"], "mode": pl["mode"],
           "tiles": pl["tiles"]}
    rec["ms"] = cuda_ms(lambda i: gf2_packet(bm, sets[i % K3_SETS], w, ps,
                                             lists), 32, warmup=2)
    rec["graph_ms"] = cuda_graph_ms(
        lambda i: gf2_packet(bm, sets[i % K3_SETS], w, ps, lists), K3_SETS)
    rec["plain_ms"] = cuda_ms(lambda i: gf2_packet_plain(
        bm, sets[i % K3_SETS], w, ps), 3)
    lists_bytes = 0 if lists is None else 4 * lists.numel()
    rec["bound_ms"] = ((k + m) * L + lists_bytes) / HBM_BYTES_PER_S * 1e3
    full = torch.cat([sets[0], gf2_packet(bm, sets[0], w, ps, lists)])
    inv, ilists = bc._decode_mats(tuple(range(2, k + 2)))
    rows = [full[i].clone() for i in range(2, k + 2)]
    got = gf2_packet(inv, rows, w, ps, ilists)
    if max_abs_err(got, gf2_packet_plain(inv, torch.stack(rows), w, ps)) \
            or not torch.equal(got, sets[0]):
        raise AssertionError("K3 decode differs from plain or did not give "
                             "the data back")
    rec["decode_ms"] = cuda_ms(lambda i: gf2_packet(inv, rows, w, ps,
                                                    ilists), 32, warmup=2)
    rec["decode_graph_ms"] = cuda_graph_ms(
        lambda i: gf2_packet(inv, rows, w, ps, ilists), 16)
    rec["decode_bound_ms"] = (2 * k * L + (
        0 if ilists is None else 4 * ilists.numel())) / HBM_BYTES_PER_S * 1e3
    del sets, full, rows
    if batch:   # 4 stripes in place, the streaming rate past the tail
        n = K3_SETS // 4
        stripes = [torch.randint(0, 256, (4, k, L), dtype=torch.uint8,
                                 device=dev, generator=gen)
                   for _ in range(n)]
        if max_abs_err(gf2_packet(bm, stripes[0], w, ps, lists),
                       gf2_packet_plain(bm, stripes[0], w, ps)):
            raise AssertionError(f"K3 differs from plain on [4, {k}, {L}]")
        rec["batch_ms"] = cuda_ms(lambda i: gf2_packet(
            bm, stripes[i % n], w, ps, lists), 16, warmup=2)
        rec["batch_graph_ms"] = cuda_graph_ms(
            lambda i: gf2_packet(bm, stripes[i % n], w, ps, lists), n)
        rec["batch_bound_ms"] = (4 * (k + m) * L + lists_bytes) \
            / HBM_BYTES_PER_S * 1e3
        del stripes
    torch.cuda.empty_cache()
    return rec


def time_words(dev, profile):
    """The word route at a 4 MiB object's chunks of ``profile``: the
    de-interleave copy, K1 over the virtual chunks and the interleave
    copy apart, and the whole ``gf2_matmul_words`` call, held to the
    plain version first."""
    import torch

    from ceph_tpu_torch.ec.gf2_kernels import (gf2_matmul_w8,
                                               gf2_matmul_words,
                                               gf2_matmul_words_plain,
                                               interleave_words,
                                               virtual_chunks)
    from ceph_tpu_torch.ec.registry import factory

    bc = factory("jerasure", profile, device=dev)._code
    k, m, w = bc.k, bc.m, bc.layout.w
    wb = w // 8
    L = factory("jerasure", profile, device="cpu").get_chunk_size(EC_OBJECT)
    bm, frag = bc._enc_dev, bc._enc_frag
    gen = torch.Generator(device=dev).manual_seed(10)
    data = torch.randint(0, 256, (k, L), dtype=torch.uint8, device=dev,
                         generator=gen)
    want = gf2_matmul_words_plain(bm, data, w)
    if max_abs_err(gf2_matmul_words(bm, data, w, frag), want):
        raise AssertionError(f"the w={w} route differs from plain")
    virt = virtual_chunks(data, wb)
    outv = gf2_matmul_w8(bm, virt, frag)
    rec = {"w": w, "k": k, "m": m, "L": L,
           "deinterleave_ms": cuda_ms(lambda i: virtual_chunks(data, wb), 20),
           "k1_ms": cuda_ms(lambda i: gf2_matmul_w8(bm, virt, frag), 20),
           "k1_graph_ms": cuda_graph_ms(
               lambda i: gf2_matmul_w8(bm, virt, frag), 20),
           "interleave_ms": cuda_ms(lambda i: interleave_words(outv, wb), 20),
           "ms": cuda_ms(lambda i: gf2_matmul_words(bm, data, w, frag), 20),
           "plain_ms": cuda_ms(lambda i: gf2_matmul_words_plain(bm, data, w),
                               3),
           "bound_ms": (k + m) * L / HBM_BYTES_PER_S * 1e3}
    return rec


def phase_layouts(dev, workdir, card):
    """The w=16/32 word layouts on K1 and the packet layouts on K3: the
    plugins through ec_benchmark and the packet corpus directory through
    ec_non_regression (the main path, with K1's and K3's counts at 0),
    then the checks against the CPU and the plain versions, and the
    times.  Returns (record, K1 launches, K3 launches, K3's kernel
    entry)."""
    import shutil

    import torch

    from ceph_tpu_torch.ec import gf2_kernels, gf2_packet
    from ceph_tpu_torch.ec.registry import factory
    from ceph_tpu_torch.tools import ec_benchmark, ec_non_regression

    t_phase = time.perf_counter()
    out = {"card": card, "runs": []}
    raw = ec_benchmark.payload(EC_OBJECT)
    small = np.random.default_rng(9).integers(
        0, 256, LAYOUT_SMALL, dtype=np.uint8).tobytes()

    # the main path, with K1's and K3's counts at 0
    gf2_kernels.gf2_matmul_w8.launches = 0
    gf2_packet.gf2_packet.launches = 0
    for plugin, profile, _ in LAYOUT_PROFILES:
        label = layout_label(plugin, profile)
        for wl, flags in (("encode", {}), ("decode_1_random",
                                           {"erasures": 1})):
            gbps, secs = ec_tool_rate(ec_benchmark, ec_bench_args(
                plugin, profile, wl.split("_")[0], dev.type,
                iters=LAYOUT_ITERS, **flags), f"{label} {wl}")
            out["runs"].append({"profile": label, "workload": wl,
                                "gbps": gbps, "calls": LAYOUT_ITERS,
                                "ms_per_call": secs / LAYOUT_ITERS * 1e3})
    corpus = os.path.join(workdir, "corpus_packet")
    shutil.copytree(os.path.join(REPO, "tests", "corpus", CORPUS_PACKET),
                    os.path.join(corpus, CORPUS_PACKET))
    rc, text, err = run_tool_err(ec_non_regression, [
        "--check", "--device", dev.type, "--base", corpus])
    if rc != 0 or "checked 1 corpus entries: OK" not in text:
        raise AssertionError(f"ec_non_regression --check of the packet "
                             f"directory: {rc} {text} {err}")
    k1_launches = gf2_kernels.gf2_matmul_w8.launches
    k3_launches = gf2_packet.gf2_packet.launches
    if k1_launches < 1 or k3_launches < 1:
        raise AssertionError(f"the layouts' path launched K1 {k1_launches} "
                             f"and K3 {k3_launches} times")
    log(f"layouts corpus: ec_non_regression --check --device {dev.type} "
        f"of {CORPUS_PACKET}: {text.strip()}")

    # checks, with the counts set aside
    for plugin, profile, every in LAYOUT_PROFILES:
        label = layout_label(plugin, profile)
        code = factory(plugin, profile, device=dev)
        cpu = factory(plugin, profile, device="cpu")
        decodes, p1, p3 = layout_check(code, cpu, profile, every, small, raw,
                                       label)
        log(f"layouts check {label}: encode and {decodes} decodes of a "
            f"{LAYOUT_SMALL}-byte object equal to the CPU's"
            f"{' (every erasure of up to m chunks)' if every else ''}, the "
            f"{EC_OBJECT}-byte object back; {p1} K1 and {p3} K3 products "
            f"equal to the plain versions")
        for rec in out["runs"]:
            if rec["profile"] == label:
                (rec["kernel_ms"], rec["k1_launches_per_call"],
                 rec["k3_launches_per_call"], rec["kernel_bound_ms"]) = \
                    layout_call_times(code, raw, rec["workload"] != "encode")
                log("layouts: " + json.dumps({"card": card, **rec}))

    variants = check_k3_widths(dev)
    log(f"k3 check: equal to the plain version in each variant: "
        f"{'; '.join(variants)}")

    # K3 alone, and the word route's parts
    corpus_profile = {"technique": "cauchy_good", "k": "4", "m": "3",
                      "w": "8", "packetsize": "8"}
    k3 = time_k3(dev, corpus_profile, batch=True)
    k3_2048 = time_k3(dev, {"technique": "cauchy_good", "k": "4",
                            "m": "3"})
    log("k3: " + json.dumps({"card": card, **k3}))
    log("k3 packetsize 2048: " + json.dumps({"card": card, **k3_2048}))
    out["words"] = []
    for prof in ({"technique": "reed_sol_van", "k": "4", "m": "2",
                  "w": "16"},
                 {"technique": "reed_sol_van", "k": "4", "m": "3",
                  "w": "32"}):
        rec = time_words(dev, prof)
        out["words"].append(rec)
        log("words: " + json.dumps({"card": card, **rec}))
    torch.cuda.empty_cache()
    entry = {"name": "gf2_packet", "route": "cuda",
             "source": "ceph_tpu_torch/csrc/gf2_packet.cu",
             "replaces": "ceph_tpu/ec/engine.py:124",
             "launches": k3_launches, "max_abs_err": 0,
             "ms": k3["ms"], "graph_ms": k3["graph_ms"],
             "plain_ms": k3["plain_ms"], "bound_ms": k3["bound_ms"],
             "bound_by": "bytes", "library_ms": None,
             "shape": f"encode [{k3['k']}, {k3['L']}] -> [{k3['m']}, "
                      f"{k3['L']}] u8, w={k3['w']} packetsize="
                      f"{k3['packetsize']} ({k3['vec_bytes']}-byte "
                      f"pieces, {k3['mode']} staging, {k3['tiles']} "
                      f"tiles); decode through the inverse: kernel_ms="
                      f"{k3['decode_ms']:.4f} graph_ms="
                      f"{k3['decode_graph_ms']:.4f} bound_ms="
                      f"{k3['decode_bound_ms']:.4f}; 4 stripes [4, "
                      f"{k3['k']}, {k3['L']}]: kernel_ms="
                      f"{k3['batch_ms']:.4f} graph_ms="
                      f"{k3['batch_graph_ms']:.4f} bound_ms="
                      f"{k3['batch_bound_ms']:.4f}; packetsize 2048: "
                      f"kernel_ms={k3_2048['ms']:.4f} graph_ms="
                      f"{k3_2048['graph_ms']:.4f} bound_ms="
                      f"{k3_2048['bound_ms']:.4f}"}
    out["k3"], out["k3_packetsize_2048"] = k3, k3_2048
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"layouts phase: {out['phase_s']:.1f} s")
    return out, k1_launches, k3_launches, entry


def phase_spec(dev):
    """The speculative mapper on ``map_big10k``: the flagship's
    cross-check (rule 0 over 65,536 PGs, K=1, against K2; K2's count at
    0), the golden rows, K=8, rule 1 (indep, numrep 11) and the tie map
    against K2, then both timed.  Returns (record, K2 launches)."""
    import torch

    from ceph_tpu_torch.crush import mapper
    from ceph_tpu_torch.crush.map_arrays import as_i32
    from ceph_tpu_torch.crush.mapper import BatchedMapper
    from ceph_tpu_torch.crush.mapper_spec import SpeculativeMapper
    from ceph_tpu_torch.flagship import spec_cross_check

    t_phase = time.perf_counter()
    cmap, cases = load_map("map_big10k")
    mapper.crush_rule_batched.launches = 0
    res, lens, spec1 = spec_cross_check(PGS, k_tries=1, device=dev)
    k2_launches = mapper.crush_rule_batched.launches
    if k2_launches != 1:
        raise AssertionError(f"the cross-check launched K2 {k2_launches} "
                             f"times")
    out = {"pgs": PGS, "k1_rounds": spec1.rounds, "k1_syncs": spec1.syncs}
    golden_check(cases[0], res, lens, "speculative map_big10k rule 0")
    bm = BatchedMapper(cmap, device=dev)
    xs = torch.arange(PGS, dtype=torch.int32, device=dev)
    checks = []
    for label, m, ruleno, case in (
            ("rule 0 K=8", SpeculativeMapper(cmap, k_tries=8, device=dev),
             0, cases[0]),
            ("rule 1 K=8", SpeculativeMapper(cmap, k_tries=8, device=dev),
             1, cases[1]),
            ("tie map rule 0 K=8",
             SpeculativeMapper(tie_map(cmap), k_tries=8, device=dev), 0,
             None)):
        weight = as_i32(np.asarray(cases[0 if case is None else ruleno]
                                   ["weight"], np.uint32), dev)
        nrep = 3 if ruleno == 0 else 11
        ref = bm if case is not None else BatchedMapper(m.cmap, device=dev)
        want, wlens = ref.map_batch(ruleno, xs, nrep, weight)
        got, glens = m.map_batch(ruleno, xs, nrep, weight)
        if not (torch.equal(got, want) and torch.equal(glens, wlens)):
            raise AssertionError(f"speculative {label} differs from K2")
        if case is not None:
            golden_check(case, got, glens, f"speculative {label}")
        checks.append(f"{label} ({m.rounds} rounds, {m.syncs} syncs)")
    log(f"spec check: map_big10k over {PGS} PGs equal to K2: rule 0 K=1 "
        f"({spec1.rounds} rounds, {spec1.syncs} syncs), "
        + ", ".join(checks) + "; rules 0 and 1 equal to the golden rows")
    w0 = as_i32(np.asarray(cases[0]["weight"], np.uint32), dev)
    out["k2_ms"] = cuda_ms(lambda i: bm.map_batch(0, xs, 3, w0), 10)
    for k_tries in (1, 8):
        sm = SpeculativeMapper(cmap, k_tries=k_tries, device=dev)
        out[f"spec_k{k_tries}_ms"] = cuda_ms(
            lambda i: sm.map_batch(0, xs, 3, w0), 3)
        out[f"spec_k{k_tries}_rounds"] = sm.rounds
        out[f"spec_k{k_tries}_syncs"] = sm.syncs
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    log("spec: " + json.dumps(out))
    return out, k2_launches



# -- phase 10 ---------------------------------------------------------

MESH_XS = 1 << 20            # xs through the placement plane (rule 0)
MESH_STRIPES = (64, 8, 512 << 10)   # RS(8,3) stripes of the sharded encode
MESH_OBJECTS = 64            # 4 MiB objects of the plugins' mesh encode
MESH_THREADS, MESH_WRITES = 16, 4   # the EncodeBatcher's writers
MESH_ITERS = 10
MESH_PROFILES = (("isa", {"k": "8", "m": "3"}),
                 ("jerasure", {"technique": "cauchy_good", "k": "4",
                               "m": "2", "packetsize": "8"}))


def launch_counts():
    """(K1, K2, K3) launch counts."""
    from ceph_tpu_torch.crush import mapper
    from ceph_tpu_torch.ec import gf2_kernels, gf2_packet

    return (gf2_kernels.gf2_matmul_w8.launches,
            mapper.crush_rule_batched.launches, gf2_packet.gf2_packet.launches)


def set_launch_counts(counts):
    from ceph_tpu_torch.crush import mapper
    from ceph_tpu_torch.ec import gf2_kernels, gf2_packet

    (gf2_kernels.gf2_matmul_w8.launches, mapper.crush_rule_batched.launches,
     gf2_packet.gf2_packet.launches) = counts


def swap_launch_counts(counts):
    """Set the (K1, K2, K3) launch counts to ``counts`` and return what
    they were, in one step under the lock K1's and K3's wrappers count
    under (daemon threads launch meanwhile; K2's launches come from the
    caller's thread)."""
    from ceph_tpu_torch.ec import gf2_kernels

    with gf2_kernels.COUNT_LOCK:
        old = launch_counts()
        set_launch_counts(counts)
    return old


def counted(fn, want, label):
    """``fn()``, asserting the (K1, K2, K3) launches it made."""
    before = launch_counts()
    out = fn()
    got = tuple(a - b for a, b in zip(launch_counts(), before))
    if got != want:
        raise AssertionError(f"{label}: launches (K1, K2, K3) {got}, "
                             f"expected {want}")
    return out


def booked_ms(table_before, key):
    """Mean host ms a call that the device plane booked under ``key``
    since ``table_before`` (the enqueue time around the launches)."""
    from ceph_tpu_torch.common import device_metrics

    now = device_metrics.shape_table()[key]
    old = table_before.get(key, {"count": 0, "time_s": 0.0})
    return (now["time_s"] - old["time_s"]) / (now["count"] - old["count"]) \
        * 1e3


def mesh_cluster(cmap, dev):
    """Phase 5's cluster (``build_cluster`` with its exception entries)
    for a phase 10 run on its own."""
    from ceph_tpu_torch.osdmap.pipeline import PoolMapper

    m, out_osds = build_cluster(cmap)
    rng = np.random.default_rng(13)
    for spec in (POOL_REP, POOL_EC):
        pid = spec["pool_id"]
        base = PoolMapper(m, pid, device=dev).map_all()
        add_exceptions(m, pid, base["up"].cpu().numpy(),
                       base["up_len"].cpu().numpy(), rng, out_osds)
    return m


def phase_mesh(dev, card, m=None):
    """The mesh data plane on ``map_big10k`` and 4 MiB objects, on a
    one-device mesh and on [dev, dev] (two shards on one card): the
    placement plane against ``BatchedMapper`` and the golden rows, the
    sharded RS(8,3) encode against ``encode_batched``, the plugins'
    ``encode_batched(mesh=)``, ``PoolMapper(mesh=)`` on phase 5's
    cluster ``m``, ``CrushTester.test_rule(mesh=)``, the EncodeBatcher
    under 16 threads, the contracts and the steady-state gate on the
    card, then the device plane's report.  Every call's launches are
    asserted; bare kernel timings and the contracts' launches are taken
    back out of the counts.  Returns the record."""
    import threading

    import torch

    from ceph_tpu_torch.analysis import contracts
    from ceph_tpu_torch.common import device_metrics
    from ceph_tpu_torch.common.perf_counters import collection
    from ceph_tpu_torch.crush.map_arrays import as_i32
    from ceph_tpu_torch.crush.mapper import (N_ALGS, BatchedMapper,
                                             crush_rule_batched)
    from ceph_tpu_torch.ec import engine
    from ceph_tpu_torch.ec.batcher import EncodeBatcher
    from ceph_tpu_torch.ec.registry import factory
    from ceph_tpu_torch.ec.rs import RSCode
    from ceph_tpu_torch.osdmap.pipeline import PoolMapper
    from ceph_tpu_torch.parallel.meshctx import pad_batch
    from ceph_tpu_torch.parallel.placement import (PlacementPlane,
                                                   make_mesh,
                                                   mesh_device_report,
                                                   utilization)
    from ceph_tpu_torch.tools.tester import CrushTester

    t_phase = time.perf_counter()
    out = {"card": card}
    meshes = {1: make_mesh([dev]), 2: make_mesh([dev, dev])}

    # -- the placement plane: rule 0, numrep 3, 1 M xs, with the tally
    cmap, cases = load_map("map_big10k")
    D = cmap.max_devices
    w = as_i32(np.asarray(cases[0]["weight"], np.uint32), dev)
    xs = torch.arange(MESH_XS, dtype=torch.int32, device=dev)
    bm = BatchedMapper(cmap, device=dev)
    want_res, want_lens = counted(lambda: bm.map_batch(0, xs, 3, w),
                                  (0, 1, 0), "BatchedMapper")
    want_counts = utilization(want_res, want_lens, D).to(torch.int32)
    planes = {}
    for n_dev, mesh in meshes.items():
        plane = planes[n_dev] = PlacementPlane(cmap, mesh=mesh)
        res, lens, tally = counted(
            lambda: plane.map_batch(0, xs, 3, w, gather_stats=True),
            (0, n_dev, 0), f"plane on {n_dev} shard(s)")
        if not (torch.equal(res, want_res) and torch.equal(lens, want_lens)
                and tally.dtype == torch.int32
                and torch.equal(tally, want_counts)):
            raise AssertionError(f"the plane on {n_dev} shard(s) differs "
                                 f"from BatchedMapper + utilization")
        golden_check(cases[0], res, lens, f"plane on {n_dev} shard(s)")
    table = device_metrics.shape_table()
    for n_dev, plane in planes.items():
        out[f"plane{n_dev}_ms"] = cuda_ms(
            lambda i: counted(lambda: plane.map_batch(
                0, xs, 3, w, gather_stats=True), (0, n_dev, 0), "timed"),
            MESH_ITERS)
        out[f"plane{n_dev}_booked_ms"] = booked_ms(
            table, f"crush.mapper|{(0, 3, pad_batch(MESH_XS, n_dev), n_dev, True)}")
    saved = launch_counts()
    prog = bm.program(0, 3)
    out["k2_ms"] = cuda_ms(lambda i: crush_rule_batched(bm.arrays, prog, w,
                                                        xs), MESH_ITERS)
    out["tally_ms"] = cuda_ms(lambda i: utilization(want_res, want_lens, D),
                              MESH_ITERS)
    out["tally_bound_ms"] = tally_bound_ms(want_res, want_lens, D)
    draws = torch.zeros((MESH_XS, N_ALGS), dtype=torch.int32, device=dev)
    crush_rule_batched(bm.arrays, prog, w, xs, draws=draws)
    out["k2_bound_ms"], out["k2_bound_by"], _ = k2_bound_ms(
        bm.arrays, prog, MESH_XS, w, draws)
    del draws
    set_launch_counts(saved)
    log(f"mesh plane: map_big10k rule 0, {MESH_XS} xs, equal to "
        f"BatchedMapper, its tally and the golden rows on 1 and 2 shards; "
        f"plane1_ms={out['plane1_ms']:.4f} (booked "
        f"{out['plane1_booked_ms']:.4f} host) plane2_ms="
        f"{out['plane2_ms']:.4f} (booked {out['plane2_booked_ms']:.4f}) "
        f"k2_ms={out['k2_ms']:.4f} tally_ms={out['tally_ms']:.4f} "
        f"tally_bound_ms={out['tally_bound_ms']:.4f} "
        f"k2_bound_ms={out['k2_bound_ms']:.4f} ({out['k2_bound_by']})")

    # -- the sharded encode: RS(8,3) over [64, 8, 512 KiB]
    bc = RSCode(8, 3, device=dev)._bit
    gen = torch.Generator(device=dev).manual_seed(10)
    stripes = torch.randint(0, 256, MESH_STRIPES, dtype=torch.uint8,
                            device=dev, generator=gen)
    B, k, L = MESH_STRIPES
    want_par = counted(lambda: bc.encode_batched(stripes), (1, 0, 0),
                       "encode_batched")
    for n_dev, mesh in meshes.items():
        got = counted(lambda: bc.encode_batched_sharded(stripes, mesh),
                      (n_dev, 0, 0), f"sharded encode on {n_dev}")
        if not torch.equal(got, want_par):
            raise AssertionError(f"the sharded encode on {n_dev} shard(s) "
                                 f"differs from encode_batched")
    table = device_metrics.shape_table()
    for n_dev, mesh in meshes.items():
        out[f"encode{n_dev}_ms"] = cuda_ms(
            lambda i: counted(lambda: bc.encode_batched_sharded(
                stripes, mesh), (n_dev, 0, 0), "timed"), MESH_ITERS)
        sig = bc._sig("encb_mesh", bc.coding_bm.shape,
                      (pad_batch(B, n_dev), k, L), n_dev)
        out[f"encode{n_dev}_booked_ms"] = booked_ms(
            table, f"ec.engine|encode:{sig}")
    saved = launch_counts()
    out["k1_ms"] = cuda_ms(lambda i: bc.encode_batched(stripes), MESH_ITERS)
    set_launch_counts(saved)
    out["k1_bound_ms"] = B * (k + 3) * L / HBM_BYTES_PER_S * 1e3
    del stripes, want_par, got
    log(f"mesh encode: RS(8,3) {list(MESH_STRIPES)} equal to "
        f"encode_batched on 1 and 2 shards; encode1_ms="
        f"{out['encode1_ms']:.4f} (booked {out['encode1_booked_ms']:.4f} "
        f"host) encode2_ms={out['encode2_ms']:.4f} (booked "
        f"{out['encode2_booked_ms']:.4f}) k1_ms={out['k1_ms']:.4f} "
        f"k1_bound_ms={out['k1_bound_ms']:.4f} (bytes)")

    # -- the plugins over the two-shard mesh: 64 x 4 MiB objects
    rng = np.random.default_rng(11)
    objs = np.frombuffer(rng.bytes(MESH_OBJECTS * EC_OBJECT), np.uint8) \
        .reshape(MESH_OBJECTS, EC_OBJECT)
    raws = list(objs)
    for plugin, profile in MESH_PROFILES:
        code = factory(plugin, dict(profile), device=dev)
        n = code.get_chunk_count()
        route = (0, 0, 1) if code._code.layout.is_packet else (1, 0, 0)
        plain = counted(lambda: code.encode_batched(range(n), raws),
                        route, f"{plugin} encode_batched")
        two = tuple(2 * r for r in route)
        meshed = counted(lambda: code.encode_batched(range(n), raws,
                                                     mesh=meshes[2]),
                         two, f"{plugin} encode_batched over the mesh")
        for a, b in zip(plain, meshed):
            if sorted(a) != sorted(b) or \
                    not all(torch.equal(a[i], b[i]) for i in a):
                raise AssertionError(f"{plugin} {profile}: the mesh "
                                     f"encode differs")
        del plain, meshed
    log(f"mesh plugins: encode_batched of {MESH_OBJECTS} x 4 MiB over 2 "
        f"shards equal to the call without a mesh: "
        + ", ".join(f"{p} {sorted(prof.items())}"
                    for p, prof in MESH_PROFILES))

    # -- PoolMapper over the two-shard mesh, phase 5's cluster
    m = m if m is not None else mesh_cluster(cmap, dev)
    for spec in (POOL_REP, POOL_EC):
        pid = spec["pool_id"]
        a = counted(lambda: PoolMapper(m, pid, device=dev).map_all(),
                    (0, 1, 0), f"pool {pid} map_all")
        pm2 = PoolMapper(m, pid, mesh=meshes[2])
        b = counted(pm2.map_all, (0, 2, 0), f"pool {pid} map_all (mesh)")
        if sorted(a) != sorted(b) or not all(torch.equal(a[k_], b[k_])
                                             for k_ in a):
            raise AssertionError(f"PoolMapper(mesh=) differs on pool {pid}")
    log(f"mesh pipeline: PoolMapper(mesh={meshes[2]}) on phase 5's "
        f"cluster equal to the call without a mesh for pools 1 and 2")

    # -- CrushTester over the two-shard mesh
    wrapper, _ = big10k_wrapper()
    tester = CrushTester(wrapper)
    reps = [counted(lambda: tester.test_rule(0, 3, 0, MESH_XS - 1,
                                             device=dev), (0, 1, 0),
                    "test_rule"),
            counted(lambda: tester.test_rule(0, 3, 0, MESH_XS - 1,
                                             mesh=meshes[2]), (0, 2, 0),
                    "test_rule over the mesh")]
    a, b = reps
    if (a.total, a.size_counts, a.bad) != (b.total, b.size_counts, b.bad) \
            or not np.array_equal(a.device_stored, b.device_stored):
        raise AssertionError("CrushTester.test_rule(mesh=) differs")
    log(f"mesh crushtool: test_rule(mesh=) over {MESH_XS} PGs equal to the "
        f"call without a mesh ({len(a.bad)} bad mappings)")

    # -- the EncodeBatcher: 16 threads x 4 writes of 4 MiB, isa 8+3
    code = factory("isa", {"k": "8", "m": "3"}, device=dev)
    want_ids = set(range(code.get_chunk_count()))
    sizes, singles = [], []
    real_batched, real_encode = code.encode_batched, code.encode

    def tap_batched(want, rs, mesh=None):
        sizes.append(len(rs))
        return real_batched(want, rs, mesh=mesh)

    def tap_encode(want, raw):
        singles.append(1)
        return real_encode(want, raw)

    code.encode_batched, code.encode = tap_batched, tap_encode
    batcher = EncodeBatcher(max_delay_us=2000, mesh=meshes[2])
    outs = [None] * (MESH_THREADS * MESH_WRITES)
    errs = []

    def writer(t):
        try:
            for j in range(MESH_WRITES):
                i = t * MESH_WRITES + j
                outs[i] = batcher.encode(code, want_ids, raws[i])
        except Exception as e:  # raised below
            errs.append(e)

    threads = [threading.Thread(target=writer, args=(t,))
               for t in range(MESH_THREADS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    code.encode_batched, code.encode = real_batched, real_encode
    if errs:
        raise errs[0]
    for raw, got in zip(raws, outs):
        ref = code.encode(want_ids, raw)
        if sorted(ref) != sorted(got) or \
                not all(torch.equal(ref[i], got[i]) for i in ref):
            raise AssertionError("an EncodeBatcher write differs from "
                                 "encode")
    out["batcher"] = {"dispatches": len(sizes) + len(singles),
                      "batched": sizes, "single": len(singles)}
    log(f"mesh batcher: {MESH_THREADS} threads x {MESH_WRITES} writes of "
        f"4 MiB, isa 8+3, every chunk equal to encode: "
        + json.dumps(out["batcher"]))
    del raws, objs, outs

    # -- contracts and the steady-state gate on the card (not counted)
    saved = launch_counts()
    violations = contracts.verify_all(dev)
    if violations:
        raise AssertionError("contracts on the card:\n"
                             + "\n".join(map(str, violations)))
    base = len(contracts.recompile_violations())
    plane = planes[1]
    with contracts.steady_state("chip_smoke mesh steady state"):
        for n_dev, plane in planes.items():
            plane.map_batch(0, xs, 3, w, gather_stats=True)
        stripes = torch.zeros(MESH_STRIPES, dtype=torch.uint8, device=dev)
        for mesh in meshes.values():
            bc.encode_batched_sharded(stripes, mesh)
    bad = contracts.recompile_violations()[base:]
    if bad:
        raise AssertionError(f"steady state on the card: {bad}")
    set_launch_counts(saved)
    log(f"mesh contracts: verify_all('{dev}') holds "
        f"({len(contracts.contracts())} contracts); the steady-state gate "
        f"saw no rebuild")

    # -- the device plane's report
    device_metrics.sample_memory()
    dump = collection().dump()
    log("mesh per_device: " + json.dumps(device_metrics.per_device()))
    log("mesh device report: " + json.dumps(mesh_device_report(meshes[2])))
    log("mesh counters: " + json.dumps(
        {k: dump[k] for k in ("ec.engine", "crush.mapper", "device",
                              "device.caches")}))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    log("mesh: " + json.dumps(out))
    return out

# -- phase 11 ---------------------------------------------------------

EPOCH_POOL3 = dict(pool_id=3, size=3, rule=0, pg_num=8192, pgp_num=8192)
EPOCH_FULL_EVERY = 8   # a full map goes into the store every 8th epoch
EPOCH_CHECKPOINT = 12  # the store checkpoints after this many epochs
EPOCH_RANDOM = 2048    # random PGs a pool and epoch held to the scalar pipeline
EPOCH_CHANGED = 2048   # at most this many PGs a pool on the epoch's changed OSDs
#                        (both 4096 until phase 15 came)
EPOCH_REF = 64         # of the checked PGs, a pool and epoch, through mapper_ref
EPOCH_ITERS = 8        # timed map_all calls a pool
EPOCH_CHUNK = 1024     # PGs a scalar oracle task
INC_FIELDS = ("new_max_osd", "new_pools", "old_pools", "new_state",
              "new_weight", "new_primary_affinity", "new_pg_upmap",
              "old_pg_upmap", "new_pg_upmap_items", "old_pg_upmap_items",
              "new_pg_temp", "new_primary_temp", "new_crush")
TABLE_FIELDS = ("new_pg_upmap", "old_pg_upmap", "new_pg_upmap_items",
                "old_pg_upmap_items", "new_pg_temp", "new_primary_temp")


def native_rows(m, pool_id):
    """The raw CRUSH rows of every PG of a pool on the native engine
    (host): (i32 [pg_num, size], i32 [pg_num])."""
    from ceph_tpu_torch.crush.native import NativeMapper

    pool = m.pools[pool_id]
    pps = [pool.raw_pg_to_pps(pool_id, ps) for ps in range(pool.pg_num)]
    return NativeMapper(m.crush, m.crush.choose_args.get(pool_id)).map_batch(
        pool.crush_rule, pps, pool.size, m.osd_weight)


def epoch_changes(pool3=EPOCH_POOL3):
    """Phase 11's epochs, in order: (kind, change) pairs, where
    ``change(m, rng, st)`` edits the primary's map ``m`` in place (``st``
    carries what earlier changes did).  Each is a change a cluster
    sees; together they fill every field of an ``Incremental``."""
    import dataclasses

    from ceph_tpu_torch.crush.builder import bucket_add_item
    from ceph_tpu_torch.crush.constants import CRUSH_BUCKET_UNIFORM
    from ceph_tpu_torch.crush.wrapper import CrushWrapper
    from ceph_tpu_torch.osdmap.osdmap import (DEFAULT_PRIMARY_AFFINITY,
                                              OSD_UP, PgPool,
                                              POOL_TYPE_REPLICATED)

    def pick(rng, xs, k):
        xs = list(xs)
        return [int(x) for x in rng.choice(xs, min(k, len(xs)),
                                           replace=False)]

    def some(rng, xs, frac):
        xs = list(xs)
        return pick(rng, xs, max(1, int(len(xs) * frac)))

    def live(m):  # existing, up and in
        return [o for o in range(m.max_osd)
                if m.exists(o) and m.is_up(o) and m.osd_weight[o] > 0]

    def pgs(m, rng, frac):  # frac of every pool's PGs
        return [(pid, ps) for pid in sorted(m.pools)
                for ps in some(rng, range(m.pools[pid].pg_num), frac)]

    def leaf_bucket(m, rng):  # a host: a bucket of devices
        hosts = sorted(i for i, b in m.crush.buckets.items()
                       if b.items and min(b.items) >= 0)
        return m.crush.buckets[hosts[int(rng.integers(len(hosts)))]]

    def down(m, rng, st):
        st["down"] = some(rng, live(m), 0.005)
        for o in st["down"]:
            m.osd_state[o] &= ~OSD_UP

    def out(m, rng, st):
        for o in st["down"]:
            m.osd_weight[o] = 0

    def reweight(m, rng, st):
        for o in some(rng, live(m), 0.005):
            m.osd_weight[o] = int(rng.integers(0x4000, 0x10000))

    def affinity(m, rng, st):
        st["aff"] = some(rng, range(m.max_osd), 0.05)
        for o in st["aff"]:
            m.set_primary_affinity(o, int(rng.integers(0, 0x10000)))

    def upmap_items(m, rng, st, frac=0.01):
        rows = {pid: native_rows(m, pid) for pid in sorted(m.pools)}
        osds = live(m)
        for pid, ps in pgs(m, rng, frac):
            res, lens = rows[pid]
            frm = int(res[ps, rng.integers(max(int(lens[ps]), 1))])
            m.pg_upmap_items[(pid, ps)] = [
                (frm, osds[int(rng.integers(len(osds)))])]
            st.setdefault("items", []).append((pid, ps))

    def upmap_items_rm(m, rng, st):
        for pg in st["items"][::2]:
            m.pg_upmap_items.pop(pg, None)

    def upmap(m, rng, st):
        osds = live(m)
        st["upmap"] = pgs(m, rng, 0.001)
        for pid, ps in st["upmap"]:
            m.pg_upmap[(pid, ps)] = pick(rng, osds, m.pools[pid].size)

    def upmap_rm(m, rng, st):
        for pg in st["upmap"]:
            m.pg_upmap.pop(pg, None)

    def pg_temp(m, rng, st):
        osds = live(m)
        st["temp"] = pgs(m, rng, 0.01)
        for pid, ps in st["temp"]:
            m.pg_temp[(pid, ps)] = pick(rng, osds, m.pools[pid].size)

    def pg_temp_clear(m, rng, st):
        for pg in st["temp"]:
            m.pg_temp.pop(pg, None)

    def primary_temp(m, rng, st):
        osds = live(m)
        st["ptemp"] = pgs(m, rng, 0.001)
        for pg in st["ptemp"]:
            m.primary_temp[pg] = osds[int(rng.integers(len(osds)))]

    def primary_temp_rm(m, rng, st):
        for pg in st["ptemp"]:
            m.primary_temp.pop(pg, None)

    def pgp_num(m, rng, st):
        for pid, pool in list(m.pools.items()):
            if pool.pgp_num < pool.pg_num:
                m.pools[pid] = dataclasses.replace(
                    pool, pgp_num=min(pool.pg_num,
                                      pool.pgp_num + pool.pg_num // 8))

    def crush_weight(m, rng, st):
        host, w = leaf_bucket(m, rng), CrushWrapper(m.crush)
        for pos, o in enumerate(list(host.items)):
            w.adjust_item_weight(o, max(1, host.item_weight_at(pos) // 2))

    def host_down(m, rng, st):
        st["host"] = [o for o in leaf_bucket(m, rng).items if m.exists(o)]
        for o in st["host"]:
            m.osd_state[o] &= ~OSD_UP

    def host_out(m, rng, st):
        for o in st["host"]:
            m.osd_weight[o] = 0

    def host_back(m, rng, st):
        for o in st["host"]:
            m.osd_state[o] |= OSD_UP
            m.osd_weight[o] = 0x10000

    def new_osds(m, rng, st):
        host, w, n0 = leaf_bucket(m, rng), CrushWrapper(m.crush), m.max_osd
        for o in range(n0, n0 + 8):
            if host.alg == CRUSH_BUCKET_UNIFORM:  # one weight for all
                bucket_add_item(host, o, host.item_weight)
            else:  # weight 0, then up the tree as an operator would
                bucket_add_item(host, o, 0)
                w.adjust_item_weight(o, 0x10000)
        m.crush.max_devices = max(m.crush.max_devices, n0 + 8)
        for o in range(n0, n0 + 8):
            m.add_osd(o)

    def pool_create(m, rng, st):
        m.pools[pool3["pool_id"]] = PgPool(
            pool_type=POOL_TYPE_REPLICATED, size=pool3["size"],
            pg_num=pool3["pg_num"], pgp_num=pool3["pgp_num"],
            crush_rule=pool3["rule"])

    def pool_delete(m, rng, st):
        del m.pools[pool3["pool_id"]]

    def up(m, rng, st):
        for o in st["down"]:
            m.osd_state[o] |= OSD_UP

    def back_in(m, rng, st):
        for o in st["down"]:
            m.osd_weight[o] = 0x10000

    def affinity_reset(m, rng, st):
        for o in st["aff"][::2]:
            m.set_primary_affinity(o, DEFAULT_PRIMARY_AFFINITY)

    def mixed(m, rng, st):  # a flap and new upmap items in one epoch
        for o in some(rng, live(m), 0.002):
            m.osd_state[o] &= ~OSD_UP
        upmap_items(m, rng, st, frac=0.005)

    return [("down", down), ("out", out), ("reweight", reweight),
            ("affinity", affinity), ("upmap_items", upmap_items),
            ("upmap", upmap), ("pg_temp", pg_temp),
            ("primary_temp", primary_temp),
            ("upmap_items_rm", upmap_items_rm),
            ("pg_temp_clear", pg_temp_clear),
            ("primary_temp_rm", primary_temp_rm), ("pgp_num", pgp_num),
            ("crush_weight", crush_weight), ("host_down", host_down),
            ("host_out", host_out), ("new_osds", new_osds),
            ("pool_create", pool_create), ("upmap_rm", upmap_rm),
            ("pool_delete", pool_delete), ("host_back", host_back),
            ("up", up), ("in", back_in), ("affinity_reset", affinity_reset),
            ("mixed", mixed)]


def make_epochs(m, seed=11, pool3=EPOCH_POOL3):
    """Drive the primary's map ``m`` through ``epoch_changes``: yields
    (epoch, kind, Incremental, map) for each, the delta from
    ``diff_maps`` of the map before and after (its epoch one more), and
    the map the epoch leaves (``m`` itself; it keeps changing)."""
    from ceph_tpu_torch.osdmap.incremental import diff_maps

    rng = np.random.default_rng(seed)
    st = {}
    for kind, change in epoch_changes(pool3):
        old = copy.deepcopy(m)
        change(m, rng, st)
        m.epoch += 1
        yield m.epoch, kind, diff_maps(old, m), m


def mapper_action(inc, pool_id):
    """What the follower does with its cached ``PoolMapper`` of a pool
    after applying ``inc``: "rebuild" when the delta replaces the CRUSH
    map, the OSD count or the pool (``apply_incremental`` swaps those
    objects, and a mapper keeps the ones it was built from), "refresh"
    when it edits the pool's exception tables, else "reuse" (states,
    weights and affinities are read at each call)."""
    if inc.new_crush is not None or inc.new_max_osd is not None or \
            pool_id in inc.new_pools or pool_id in inc.old_pools:
        return "rebuild"
    for f in TABLE_FIELDS:
        if any(pg[0] == pool_id for pg in getattr(inc, f)):
            return "refresh"
    return "reuse"


def _oracle_epoch(blob, pool_id, raw, pss):
    """A worker's share of phase 11's scalar oracle: pg_to_up_acting_osds
    of the pickled OSDMap ``blob`` over ``pss``, its CRUSH stage answered
    from ``raw`` ({pps: row} from the native engine), or through
    mapper_ref itself when ``raw`` is None."""
    from ceph_tpu_torch.osdmap import osdmap

    m = pickle.loads(blob)
    if raw is None:
        return [m.pg_to_up_acting_osds(pool_id, int(ps)) for ps in pss]

    def lookup(cmap, ruleno, x, numrep, weight, choose_args=None):
        return list(raw[x])

    real, osdmap.crush_do_rule = osdmap.crush_do_rule, lookup
    try:
        return [m.pg_to_up_acting_osds(pool_id, int(ps)) for ps in pss]
    finally:
        osdmap.crush_do_rule = real


def epoch_check_pgs(inc, pool_id, pg_num, prev, rng):
    """The PGs of a pool that phase 11 holds to the scalar pipeline after
    ``inc``: its exception entries, up to EPOCH_CHANGED PGs whose
    previous rows (``prev``: host up/acting, or None) hold an OSD whose
    state, weight or affinity changed, and EPOCH_RANDOM more."""
    pss = {pg[1] for f in TABLE_FIELDS for pg in getattr(inc, f)
           if pg[0] == pool_id and pg[1] < pg_num}
    changed = sorted(set(inc.new_state) | set(inc.new_weight)
                     | set(inc.new_primary_affinity))
    if changed and prev is not None:
        hit = np.isin(prev["up"], changed).any(1) | \
            np.isin(prev["acting"], changed).any(1)
        on = np.flatnonzero(hit)
        if len(on) > EPOCH_CHANGED:
            on = rng.choice(on, EPOCH_CHANGED, replace=False)
        pss |= {int(p) for p in on}
    pss |= {int(p) for p in rng.choice(pg_num, min(EPOCH_RANDOM, pg_num),
                                       replace=False)}
    return sorted(pss)


def follow_epoch(fm, mappers, inc, dev):
    """The follower's mappers after ``inc`` was applied to its map
    ``fm``: each pool's ``PoolMapper`` in ``mappers`` kept, refreshed or
    rebuilt by ``mapper_action`` (built for a new pool, dropped for a
    deleted one), a kept or refreshed one asserted to hold the same
    ``prog``, ``arrays`` and ``pool``.  Returns {pool: action}."""
    from ceph_tpu_torch.osdmap.pipeline import PoolMapper

    actions = {}
    for pid in sorted(set(mappers) | set(fm.pools)):
        if pid not in fm.pools:
            del mappers[pid]
            actions[pid] = "drop"
            continue
        act = actions[pid] = "rebuild" if pid not in mappers \
            else mapper_action(inc, pid)
        if act == "rebuild":
            mappers[pid] = PoolMapper(fm, pid, device=dev)
            continue
        pm = mappers[pid]
        kept = (pm.prog, pm.arrays, pm.pool)
        if act == "refresh":
            pm.refresh_tables()
        if any(a is not b for a, b in zip((pm.prog, pm.arrays, pm.pool),
                                          kept)):
            raise AssertionError(f"epoch {inc.epoch}: pool {pid}'s mapper "
                                 f"lowered its map again on {act}")
    return actions


def _strongest(actions):
    """An epoch's class: the costliest thing its mappers did."""
    for a in ("rebuild", "refresh"):
        if a in actions.values():
            return a
    return "reuse"


def phase_epochs(dev, pool, m):
    """Map epochs on the card.  A primary map (phase 5's cluster ``m``)
    makes 24 epochs (``epoch_changes``), each a ``diff_maps`` delta
    encoded with ``encode_versioned`` and, every 8th epoch, the full map
    (``osdmap_to_bytes``), committed one ``KVTransaction`` an epoch to a
    ``KeyValueDB`` over a ``WALStore`` (a checkpoint after 12 epochs; no
    final one).  The store is mounted again and replayed: every blob
    equal to the one written; ``objectstore_tool --op list`` lists a copy
    of it.  A follower starts from epoch 1's full map out of the store
    and, for each later epoch, decodes the delta, applies it, keeps,
    refreshes or rebuilds its ``PoolMapper`` of each pool
    (``mapper_action``) and runs ``map_all`` on the card.  After every
    epoch, for every pool: the follower's rows equal those of a fresh
    ``PoolMapper`` of the primary's map through its bytes, on every PG,
    and the scalar ``pg_to_up_acting_osds`` of that map on the PGs of
    ``epoch_check_pgs`` (its CRUSH stage from the native engine, since
    mapper_ref takes 5-17 ms a PG; EPOCH_REF of them through mapper_ref
    itself); the follower's map encodes to the primary's bytes, and
    equals the store's full map where there is one; a kept or refreshed
    mapper keeps its lowered map (the same ``prog``, ``arrays`` and
    ``pool``; no ``encode_map`` or ``compile_rule`` call).  Returns
    (record, K2's launches: one a ``map_all``, asserted)."""
    import shutil
    import tempfile

    import torch

    from ceph_tpu_torch.crush import mapper
    from ceph_tpu_torch.crush.native import NativeMapper
    from ceph_tpu_torch.os.kv import KeyValueDB, KVTransaction
    from ceph_tpu_torch.os.wal_store import WALStore
    from ceph_tpu_torch.osdmap import pipeline
    from ceph_tpu_torch.osdmap.bincode_maps import (osdmap_from_bytes,
                                                    osdmap_to_bytes)
    from ceph_tpu_torch.osdmap.incremental import (Incremental,
                                                   apply_incremental)

    t_phase = time.perf_counter()

    def ms(t):
        return (time.perf_counter() - t) * 1e3

    m = copy.deepcopy(m)
    e0 = m.epoch
    calls = 0  # map_all calls
    lowered = {"encode_map": 0, "compile_rule": 0}

    def counting(name, fn):
        def wrapped(*a, **k):
            lowered[name] += 1
            return fn(*a, **k)
        return wrapped

    real = pipeline.encode_map, pipeline.compile_rule
    pipeline.encode_map = counting("encode_map", real[0])
    pipeline.compile_rule = counting("compile_rule", real[1])
    tool = None
    tmp = tempfile.TemporaryDirectory()
    try:
        # 1-2: the primary's epochs, committed to the store
        path = os.path.join(tmp.name, "mon.wal")
        store = WALStore(path)
        store.mkfs()
        store.mount()
        kv = KeyValueDB(store)
        bare = copy.deepcopy(m)
        for table in (bare.pg_upmap, bare.pg_upmap_items, bare.pg_temp,
                      bare.primary_temp):
            table.clear()
        bare_bytes = len(osdmap_to_bytes(bare))  # no exception tables
        primary_bytes = {e0: osdmap_to_bytes(m)}
        written = {f"full_{e0:08d}": primary_bytes[e0]}
        t = time.perf_counter()
        kv.submit_transaction(KVTransaction().set(
            "osdmap", f"full_{e0:08d}", primary_bytes[e0]))
        gen = {e0: {"kind": "initial", "commit_ms": ms(t),
                    "full_bytes": len(primary_bytes[e0])}}
        filled = set()
        for e, kind, inc, pm_ in make_epochs(m):
            row = gen[e] = {"kind": kind}
            blob = inc.encode_versioned().encode()
            primary_bytes[e] = osdmap_to_bytes(pm_)
            txn = KVTransaction().set("osdmap", f"inc_{e:08d}", blob)
            written[f"inc_{e:08d}"] = blob
            if (e - e0) % EPOCH_FULL_EVERY == 0:
                txn.set("osdmap", f"full_{e:08d}", primary_bytes[e])
                written[f"full_{e:08d}"] = primary_bytes[e]
                row["full_bytes"] = len(primary_bytes[e])
            t = time.perf_counter()
            kv.submit_transaction(txn)
            row["commit_ms"] = ms(t)
            row["inc_bytes"] = len(blob)
            row["fields"] = [f for f in INC_FIELDS
                             if getattr(inc, f) not in (None, {}, [])]
            filled.update(row["fields"])
            if e - e0 == EPOCH_CHECKPOINT:
                t = time.perf_counter()
                store.checkpoint()
                row["checkpoint_ms"] = ms(t)
        if filled != set(INC_FIELDS):
            raise AssertionError(f"the epochs left Incremental fields "
                                 f"empty: {set(INC_FIELDS) - filled}")
        last = max(primary_bytes)
        del store, kv  # dropped without umount: no final checkpoint

        t = time.perf_counter()
        store = WALStore(path)
        store.mount()
        mount_ms = ms(t)
        kv = KeyValueDB(store)
        back = kv.get_by_prefix("osdmap")
        same = sum(back.get(k) == v for k, v in written.items())
        if back != written:
            raise AssertionError(f"the store gave back {len(back)} blobs, "
                                 f"{same} of the {len(written)} written")
        copy_path = os.path.join(tmp.name, "copy.wal")
        shutil.copytree(path, copy_path)
        tool = subprocess.Popen(
            [sys.executable, "-m", "ceph_tpu_torch.tools.objectstore_tool",
             "--data-path", copy_path, "--op", "list"],
            cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        log(f"epochs store: {len(written)} blobs of {last - e0} epochs "
            f"({sum(map(len, written.values()))} bytes), mount and replay "
            f"{mount_ms:.3f} ms, every blob equal")

        # 3-4: the follower, checked after every epoch
        rng = np.random.default_rng(14)
        fm = osdmap_from_bytes(kv.get("osdmap", f"full_{e0:08d}"))
        mappers = {pid: pipeline.PoolMapper(fm, pid, device=dev)
                   for pid in sorted(fm.pools)}
        prev = {pid: {k: v.cpu().numpy() for k, v in pm.map_all().items()}
                for pid, pm in mappers.items()}
        calls += len(mappers)
        checks, n_actions = [], {}
        for e in range(e0 + 1, last + 1):
            kind = gen[e]["kind"]
            inc = Incremental.decode_versioned(
                kv.get("osdmap", f"inc_{e:08d}"))
            apply_incremental(fm, inc)
            before = dict(lowered)
            actions = follow_epoch(fm, mappers, inc, dev)
            if "rebuild" not in actions.values() and lowered != before:
                raise AssertionError(f"epoch {e} ({kind}): {actions} "
                                     f"lowered the map: {lowered}, was "
                                     f"{before}")
            for a in actions.values():
                n_actions[a] = n_actions.get(a, 0) + 1
            outs = {pid: pm.map_all() for pid, pm in mappers.items()}
            calls += len(outs)

            # (b) the primary's map through its bytes, and a fresh mapper
            if osdmap_to_bytes(fm) != primary_bytes[e]:
                raise AssertionError(f"epoch {e}: the follower's map does "
                                     f"not encode to the primary's")
            pmap = osdmap_from_bytes(primary_bytes[e])
            full = kv.get("osdmap", f"full_{e:08d}")
            if full is not None and \
                    osdmap_from_bytes(full).to_dict() != fm.to_dict():
                raise AssertionError(f"epoch {e}: the follower's map "
                                     f"differs from the store's full map")
            for pid in sorted(outs):
                fresh = pipeline.PoolMapper(pmap, pid, device=dev).map_all()
                calls += 1
                for k, v in fresh.items():
                    if not torch.equal(v, outs[pid][k]):
                        raise AssertionError(
                            f"epoch {e} ({kind}) pool {pid}: the follower's "
                            f"{k} differs from a fresh PoolMapper's")

            # (c) the scalar pipeline of the primary's map, in the workers
            blob = pickle.dumps(pmap)
            checked = {}
            for pid in sorted(outs):
                p = pmap.pools[pid]
                host = {k: v.cpu().numpy() for k, v in outs[pid].items()}
                pss = epoch_check_pgs(inc, pid, p.pg_num, prev.get(pid), rng)
                prev[pid] = host
                pps = [p.raw_pg_to_pps(pid, ps) for ps in pss]
                res, lens = NativeMapper(
                    pmap.crush, pmap.crush.choose_args.get(pid)).map_batch(
                    p.crush_rule, pps, p.size, pmap.osd_weight)
                got = {ps: (host["up"][ps, :host["up_len"][ps]].tolist(),
                            int(host["up_primary"][ps]),
                            host["acting"][ps, :host["acting_len"][ps]]
                            .tolist(), int(host["acting_primary"][ps]))
                       for ps in pss}
                for i in range(0, len(pss), EPOCH_CHUNK):
                    raw = {x: res[j, :lens[j]].tolist() for j, x in
                           enumerate(pps[i:i + EPOCH_CHUNK], start=i)}
                    part = pss[i:i + EPOCH_CHUNK]
                    checks.append((e, pid, part, got, False, pool.submit(
                        _oracle_epoch, blob, pid, raw, part)))
                ref = sorted(int(x) for x in rng.choice(
                    pss, min(EPOCH_REF, len(pss)), replace=False))
                checks.append((e, pid, ref, got, True, pool.submit(
                    _oracle_epoch, blob, pid, None, ref)))
                checked[pid] = len(pss)
            log(f"epoch {e} {kind}: mappers {json.dumps(actions)}, "
                f"every PG equal to a fresh PoolMapper, "
                f"{json.dumps(checked)} PGs to the scalar pipeline")
        n_rows = n_ref = 0
        for e, pid, pss, got, by_ref, fut in checks:
            for ps, want in zip(pss, fut.result()):
                if got[ps] != tuple(want):
                    raise AssertionError(
                        f"epoch {e} pool {pid} pg {ps}: the follower's "
                        f"{got[ps]} != pg_to_up_acting_osds {want}")
            n_rows += 0 if by_ref else len(pss)
            n_ref += len(pss) if by_ref else 0
        log(f"epochs check: {n_rows} (epoch, pool, PG) rows equal to "
            f"pg_to_up_acting_osds (CRUSH stage on the native engine), "
            f"{n_ref} of them again through mapper_ref")

        # 5: timing, a second follower with the workers idle
        torch.cuda.synchronize()
        t = time.perf_counter()
        fm = osdmap_from_bytes(kv.get("osdmap", f"full_{e0:08d}"))
        first_decode_ms = ms(t)
        t = time.perf_counter()
        mappers = {pid: pipeline.PoolMapper(fm, pid, device=dev)
                   for pid in sorted(fm.pools)}
        for pm in mappers.values():
            pm.map_all()
        calls += len(mappers)
        torch.cuda.synchronize()
        first_map_ms = ms(t)
        rows = []
        for e in range(e0 + 1, last + 1):
            t_e = time.perf_counter()
            inc = Incremental.decode_versioned(
                kv.get("osdmap", f"inc_{e:08d}"))
            decode_ms = ms(t_e)
            t = time.perf_counter()
            apply_incremental(fm, inc)
            apply_ms = ms(t)
            t = time.perf_counter()
            actions = follow_epoch(fm, mappers, inc, dev)
            mapper_ms = ms(t)
            t = time.perf_counter()
            for pm in mappers.values():
                pm.map_all()
            calls += len(mappers)
            torch.cuda.synchronize()
            map_ms = ms(t)
            row = {"epoch": e, "kind": gen[e]["kind"], "actions": actions,
                   "decode_ms": decode_ms, "apply_ms": apply_ms,
                   "mapper_ms": mapper_ms, "map_all_host_ms": map_ms,
                   "epoch_ms": ms(t_e), "commit_ms": gen[e]["commit_ms"],
                   "inc_bytes": gen[e]["inc_bytes"]}
            full = kv.get("osdmap", f"full_{e:08d}")
            if full is not None:
                t = time.perf_counter()
                osdmap_from_bytes(full)
                row["full_decode_ms"] = ms(t)
            rows.append(row)
            log(f"epoch {e} {row['kind']} timed: " + json.dumps(
                {k: v for k, v in row.items() if k not in ("epoch", "kind")}))

        # map_all by CUDA events (counted), K2 alone (not counted)
        per_pool = {}
        for pid, pm in mappers.items():
            map_all_ms = cuda_ms(lambda i: pm.map_all(), EPOCH_ITERS)
            calls += EPOCH_ITERS + 1
            launches = mapper.crush_rule_batched.launches
            w = pm.runtime_args()[0]
            k2_ms = cuda_ms(lambda i: mapper.crush_rule_batched(
                pm.arrays, pm.prog, w, pm.pps_i32), EPOCH_ITERS)
            mapper.crush_rule_batched.launches = launches
            per_pool[pid] = {"pg_num": pm.pool.pg_num, "size": pm.R,
                             "map_all_ms": map_all_ms, "k2_ms": k2_ms}
        out, err = tool.communicate(timeout=300)
        rc, tool = tool.returncode, None
        if rc != 0:
            raise AssertionError(f"objectstore_tool exited {rc}: {err}")
        listing = json.loads(out)
        if listing.get("kv") != ["osdmap"]:
            raise AssertionError(f"objectstore_tool --op list: {listing}")
    finally:
        pipeline.encode_map, pipeline.compile_rule = real
        if tool is not None:
            tool.kill()
            tool.communicate()
        tmp.cleanup()
    launches = mapper.crush_rule_batched.launches
    if launches != calls:
        raise AssertionError(f"{calls} map_all calls of phase 11 launched "
                             f"K2 {launches} times")
    k2_epoch = sum(p["k2_ms"] for p in per_pool.values())
    by_class = {}
    for r in rows:
        by_class.setdefault(_strongest(r["actions"]), []).append(r)
    keys = ("decode_ms", "apply_ms", "mapper_ms", "map_all_host_ms",
            "epoch_ms", "commit_ms", "inc_bytes")
    summary = {c: {"epochs": len(v),
                   **{k: float(np.median([r[k] for r in v])) for k in keys}}
               for c, v in by_class.items()}
    for c in summary.values():
        c["k2_share"] = k2_epoch / c["epoch_ms"]
    rec = {"epochs": last - e0, "mount_replay_ms": mount_ms,
           "first_decode_ms": first_decode_ms,
           "first_mappers_ms": first_map_ms,
           "full_decode_ms": [r["full_decode_ms"] for r in rows
                              if "full_decode_ms" in r],
           "full_map_bytes": {e: g["full_bytes"] for e, g in gen.items()
                              if "full_bytes" in g},
           "bare_map_bytes": bare_bytes,
           "checkpoint_ms": gen[e0 + EPOCH_CHECKPOINT]["checkpoint_ms"],
           "by_class": summary, "mapper_actions": n_actions,
           "map_all": per_pool, "k2_ms_an_epoch": k2_epoch,
           "checked_rows": n_rows, "checked_by_mapper_ref": n_ref,
           "map_all_calls": calls,
           "phase_s": time.perf_counter() - t_phase}
    return rec, calls


# -- phase 12 ---------------------------------------------------------

WIRE_OBJECT = EC_OBJECT     # 4 MiB: the default object size of RBD and CephFS
WIRE_WRITERS = (1, 4, 16)   # client messengers writing at once
WIRE_WRITES = 16            # writes a client (32 until phase 15 came)
WIRE_OBJECTS = 8            # distinct objects: client c's write i sends
                            # object (7c + i) % 8
WIRE_CHUNKS_EVERY = 8       # every 8th write's reply carries the chunk bytes
WIRE_THROTTLE = 512 << 20   # bytes of ec_write frames in flight at the primary
WIRE_PROFILES = MESH_PROFILES   # isa 8+3 (K1), cauchy_good 4+2 (K3)
WIRE_SPLIT = ("wire_in", "to_handler", "prepare_copy", "batch_kernel",
              "copy_back", "crc", "reply")


class KernelClock:
    """Replaces ``gf2_kernels.gf2_matmul_w8`` and ``gf2_packet.gf2_packet``
    while open, recording each call's arguments (and its host time) on
    the way to the real wrapper.  A wrapper counts its launches on the
    name its module holds, the tap's while open: they go to the real
    wrapper's count when the clock closes.  ``ms()``, called while
    open, is the device time of the recorded launches replayed back to
    back in one CUDA graph (the host's time between them, and the other
    threads' work on the stream, left out; the replays count no launch);
    on the CPU, the calls' summed host time."""

    def __init__(self, dev):
        import threading

        self.dev = dev
        self.calls = []
        self.host_s = 0.0
        self.recording = True   # False: calls pass through unrecorded
        self._lock = threading.Lock()   # daemon threads launch at once

    def _wrap(self, real):
        def tap(*args, **kw):
            t = time.perf_counter()
            out = real(*args, **kw)
            dt = time.perf_counter() - t
            with self._lock:
                if self.recording:
                    self.host_s += dt
                    self.calls.append((real, args, kw))
            return out

        tap.launches = 0
        return tap

    def __enter__(self):
        from ceph_tpu_torch.ec import gf2_kernels, gf2_packet

        self.real = (gf2_kernels.gf2_matmul_w8, gf2_packet.gf2_packet)
        self.taps = (self._wrap(self.real[0]), self._wrap(self.real[1]))
        gf2_kernels.gf2_matmul_w8, gf2_packet.gf2_packet = self.taps
        return self

    def __exit__(self, *exc):
        from ceph_tpu_torch.ec import gf2_kernels, gf2_packet

        gf2_kernels.gf2_matmul_w8, gf2_packet.gf2_packet = self.real
        for real, tap in zip(self.real, self.taps):
            real.launches += tap.launches
        self.calls = []
        return False

    def ms(self):
        if self.dev.type != "cuda":
            return self.host_s * 1e3
        if not self.calls:
            return 0.0
        counts = [tap.launches for tap in self.taps]
        calls = list(self.calls)

        def replay(_i):
            for real, args, kw in calls:
                real(*args, **kw)

        try:
            return cuda_graph_ms(replay, 1, replays=3)
        finally:
            for tap, n in zip(self.taps, counts):
                tap.launches = n


class WirePrimary:
    """Phase 12's primary: a lossless ``Messenger`` built from a port
    ``Context`` (its Config, tracer and perf collection, an admin socket
    in ``admin_dir``, a ``Throttle`` on ``ec_write``), an
    ``EncodeBatcher`` and the codes by profile name.  ``encode=False``
    makes it the wire-only primary (``wire_crc_write``)."""

    def __init__(self, codes, admin_dir, encode=True, name="osd.0"):
        from ceph_tpu_torch.common import copytrack
        from ceph_tpu_torch.common.config import Config
        from ceph_tpu_torch.common.context import Context
        from ceph_tpu_torch.common.throttle import Throttle
        from ceph_tpu_torch.ec.batcher import EncodeBatcher
        from ceph_tpu_torch.msg.messenger import Messenger

        conf = Config()
        self.ctx = Context(name, config=conf, admin_dir=admin_dir)
        self.asok = self.ctx.start_admin_socket()
        self.throttle = Throttle("ec_write", WIRE_THROTTLE)
        self.msgr = Messenger(name, lossless=True, tracer=self.ctx.tracer,
                              perf=self.ctx.perf,
                              throttles={"ec_write": self.throttle})
        self.msgr.wire(self.asok)
        self.ctx.tracer.wire(self.asok)
        self.copy_pc = copytrack.ledger(self.ctx.perf)
        self.batcher = EncodeBatcher(
            max_delay_us=conf["ec_encode_batch_max_delay_us"])
        self.codes = dict(codes)
        self.prep = {}
        for code in self.codes.values():
            self._time_prepare(code)
        handler = wire_ec_write if encode else wire_crc_write
        self.msgr.register("ec_write", lambda msg: handler(self, msg))
        self.msgr.start()

    def _time_prepare(self, code):
        """``encode_prepare``'s host time, by the object it was given
        (its copy onto the card reads the pageable receive segment and
        returns once it has read it)."""
        real = code.encode_prepare

        def timed(raw):
            t = time.monotonic()
            out = real(raw)
            self.prep[id(raw)] = time.monotonic() - t
            return out

        code.encode_prepare = timed

    def shutdown(self):
        self.msgr.shutdown()
        self.ctx.shutdown()


def _handle_times(prim):
    """(receipt, handler start) on the primary's clock: the handler span's
    ``q_wait`` tag is the wait from frame receipt to handler start."""
    t_h0 = time.monotonic()
    sp = prim.ctx.tracer.current()
    q_wait = sp.tags.get("q_wait", 0.0) if sp is not None else 0.0
    return t_h0 - q_wait, t_h0


def wire_ec_write(prim, msg):
    """The primary's EC write (the shape of the OSD's, without the
    store): the object, a memoryview into the frame's receive segment,
    goes through the ``EncodeBatcher`` inside an ``ec.encode`` span; the
    chunks come back to the host in one copy; both copies are booked in
    the ``ec_assembly`` ledger; the reply holds each chunk's crc32c, and
    the chunk bytes on every ``WIRE_CHUNKS_EVERY``-th write."""
    import torch

    from ceph_tpu_torch.common import copytrack
    from ceph_tpu_torch.ec.stripe import crc32c

    t_rx, t_h0 = _handle_times(prim)
    code = prim.codes[msg["profile"]]
    buf = msg["data"]
    n, k = code.get_chunk_count(), code.get_data_chunk_count()
    with prim.ctx.tracer.start_span(
            "ec.encode", require_parent=True,
            tags={"bytes": len(buf), "k": k, "m": n - k}):
        chunks = prim.batcher.encode(code, range(n), buf)
        t_enc = time.monotonic()
        host = torch.stack([chunks[p] for p in range(n)]).cpu().numpy()
    t_back = time.monotonic()
    prep = prim.prep.pop(id(buf), 0.0)
    copytrack.book_pc(prim.copy_pc, "ec_assembly", len(buf) + host.nbytes,
                      copies=2)
    reply = {"crc": [crc32c(host[p]) for p in range(n)]}
    if msg["seq"] % WIRE_CHUNKS_EVERY == 0:
        reply["chunks"] = [memoryview(host[p]) for p in range(n)]
    t_h1 = time.monotonic()
    reply["t"] = {"rx": t_rx, "h0": t_h0, "prep": prep, "enc": t_enc,
                  "back": t_back, "h1": t_h1}
    return reply


def wire_crc_write(prim, msg):
    """The wire-only primary's handler: crc32c of the received object on
    the host, nothing else."""
    from ceph_tpu_torch.ec.stripe import crc32c

    t_rx, t_h0 = _handle_times(prim)
    crc = crc32c(msg["data"])
    t_h1 = time.monotonic()
    return {"crc": [crc], "t": {"rx": t_rx, "h0": t_h0, "prep": 0.0,
                                "enc": t_h0, "back": t_h0, "h1": t_h1}}


def wire_expected(codes_cpu, objects):
    """Each object's chunks from the same profile on the CPU (the plain
    versions), their crc32c, and the object's own crc32c."""
    from ceph_tpu_torch.ec.stripe import crc32c

    exp = {}
    for name, code in codes_cpu.items():
        n = code.get_chunk_count()
        rows = []
        for raw in objects:
            ch = code.encode(range(n), raw)
            host = np.stack([ch[p].numpy() for p in range(n)])
            rows.append((host, [crc32c(host[p]) for p in range(n)]))
        exp[name] = rows
    exp[None] = [(None, [crc32c(raw)]) for raw in objects]
    return exp


def wire_run(prim, clients, profile, objects, expected, writes=WIRE_WRITES,
             timeout=120.0):
    """``clients`` each send ``writes`` ``ec_write`` calls of ``profile``
    (None: the wire-only primary) at once; every reply is held to
    ``expected``.  Returns (per-write records, wall seconds)."""
    import threading

    recs, errs = [], []
    lock = threading.Lock()
    start = threading.Barrier(len(clients) + 1)

    def client(c, cli):
        try:
            start.wait()
            for i in range(writes):
                obj = (7 * c + i) % len(objects)
                t0 = time.monotonic()
                rep = cli.call(prim.msgr.addr,
                               {"type": "ec_write", "profile": profile,
                                "seq": i, "obj": obj, "data": objects[obj]},
                               timeout=timeout)
                t1 = time.monotonic()
                if "error" in rep:
                    raise AssertionError(f"primary: {rep['error']}")
                host, crcs = expected[profile][obj]
                if rep["crc"] != crcs:
                    raise AssertionError(
                        f"{profile or 'wire-only'}: client {c} write {i} "
                        f"crc32c {rep['crc']} != {crcs}")
                if "chunks" in rep:
                    got = [bytes(b) for b in rep["chunks"]]
                    if got != [host[p].tobytes() for p in range(len(got))]:
                        raise AssertionError(
                            f"{profile}: client {c} write {i}: chunk bytes "
                            f"differ from the CPU's")
                t = rep["t"]
                rec = {"wire_in": t["rx"] - t0,
                       "to_handler": t["h0"] - t["rx"],
                       "prepare_copy": t["prep"],
                       "batch_kernel": t["enc"] - t["h0"] - t["prep"],
                       "copy_back": t["back"] - t["enc"],
                       "crc": t["h1"] - t["back"], "reply": t1 - t["h1"],
                       "total": t1 - t0}
                with lock:
                    recs.append(rec)
        except Exception as e:  # raised below
            errs.append(e)

    threads = [threading.Thread(target=client, args=(c, cli))
               for c, cli in enumerate(clients)]
    for t in threads:
        t.start()
    start.wait()
    t0 = time.perf_counter()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    if errs:
        raise errs[0]
    return recs, wall


def wire_quiesced(timeout=5.0):
    """Wait for the port's receive segments to be released and its spans
    to finish (a reply goes out before its segment is released);
    returns what is still outstanding."""
    from ceph_tpu_torch.common import bufpool, tracing

    deadline = time.monotonic() + timeout
    while True:
        segs = bufpool.outstanding()
        spans = tracing.active_spans()
        if (not segs and not spans) or time.monotonic() > deadline:
            return segs, spans
        time.sleep(0.02)


def _bufpool_counts():
    from ceph_tpu_torch.common.perf_counters import collection

    d = collection().dump().get("obs.bufpool", {})
    return d.get("pool_hits", 0), d.get("pool_misses", 0)


def _engine_counts():
    from ceph_tpu_torch.common.perf_counters import collection

    d = collection().dump()["ec.engine"]
    return d["encode_ops"], sum(d["ec_batch_size"]["buckets"])


def phase_wire(dev, admin_dir, card, writers=WIRE_WRITERS,
               writes=WIRE_WRITES, size=WIRE_OBJECT):
    """Phase 12: client EC writes over the messenger into K1 and K3.

    ``max(writers)`` lossy client messengers write ``size``-byte objects
    to a lossless primary (``WirePrimary``) that encodes each with isa
    8+3 (K1) and jerasure cauchy_good 4+2 packetsize 8 (K3) on ``dev``;
    then the same writes to a wire-only primary.  Every reply is held to
    the same profile on the CPU; the receive segments, the spans, the
    launches (one K1 or K3 launch a batcher group, from the
    ``ec.engine`` counters) and the admin socket's ``perf dump`` and
    ``dump_messenger`` are checked.  Returns (report, K1 launches, K3
    launches)."""
    import torch

    from ceph_tpu_torch.common.admin_socket import AdminSocket
    from ceph_tpu_torch.ec.registry import factory
    from ceph_tpu_torch.msg.messenger import Messenger

    t_phase = time.perf_counter()
    rng = np.random.default_rng(12)
    objects = [rng.integers(0, 256, size, dtype=np.uint8).tobytes()
               for _ in range(WIRE_OBJECTS)]
    names = [layout_label(p, prof) for p, prof in WIRE_PROFILES]
    codes = {nm: factory(p, dict(prof), device=dev)
             for nm, (p, prof) in zip(names, WIRE_PROFILES)}
    expected = wire_expected(
        {nm: factory(p, dict(prof), device="cpu")
         for nm, (p, prof) in zip(names, WIRE_PROFILES)}, objects)
    clients = [Messenger(f"client.{c}") for c in range(max(writers))]
    for cli in clients:
        cli.start()
    prims = {"ec": WirePrimary(codes, admin_dir),
             "wire": WirePrimary({}, admin_dir, encode=False, name="osd.1")}
    out = {"card": card, "object_bytes": size, "writes_per_client": writes,
           "runs": []}
    k1_total = k3_total = 0
    try:
        # a warm-up write of each profile (the kernels' first calls)
        for nm in names:
            wire_run(prims["ec"], clients[:1], nm, objects, expected, 1)
        for prof in names + [None]:
            prim = prims["ec" if prof else "wire"]
            for w in writers:
                hits0, miss0 = _bufpool_counts()
                copies0 = prim.copy_pc.dump()["copies"]
                ops0, groups0 = _engine_counts()
                set_launch_counts((0, 0, 0))
                with KernelClock(dev) as clock:
                    recs, wall = wire_run(prim, clients[:w], prof, objects,
                                          expected, writes)
                    kernel_ms = clock.ms()
                k1, _, k3 = launch_counts()
                ops, groups = _engine_counts()
                ops, groups = ops - ops0, groups - groups0
                hits, miss = _bufpool_counts()
                hits, miss = hits - hits0, miss - miss0
                n_w = len(recs)
                if prof is not None:
                    kern = k1 if prof.startswith("isa") else k3
                    other = k3 if prof.startswith("isa") else k1
                    if kern != groups or ops != groups or other or kern < 1:
                        raise AssertionError(
                            f"wire {prof} x{w}: launches (K1, K3) "
                            f"({k1}, {k3}) for {groups} batcher groups and "
                            f"{ops} encode calls")
                    k1_total += k1
                    k3_total += k3
                elif k1 or k3:
                    raise AssertionError("the wire-only run launched a kernel")
                run = {"profile": prof or "wire-only", "writers": w,
                       "writes": n_w, "wall_s": wall,
                       "writes_per_s": n_w / wall,
                       "object_GB_per_s": n_w * size / wall / 1e9,
                       "median_ms": {key: float(np.median(
                           [r[key] for r in recs])) * 1e3
                           for key in WIRE_SPLIT + ("total",)},
                       "bufpool_hit_rate": hits / max(1, hits + miss),
                       "copies_per_object": (prim.copy_pc.dump()["copies"]
                                             - copies0) / n_w,
                       "launches": {"k1": k1, "k3": k3},
                       "batcher_groups": groups,
                       "kernel_ms": kernel_ms,
                       "kernel_ms_per_launch": kernel_ms / max(1, k1 + k3),
                       "kernel_share": kernel_ms / 1e3 / wall}
                out["runs"].append(run)
                log("wire: " + json.dumps(run))
        segs, spans = wire_quiesced()
        if segs:
            raise AssertionError(f"receive segments still held: {segs[:4]}")
        if spans:
            raise AssertionError(f"spans left open: "
                                 f"{[s.name for _, s in spans][:4]}")
        asok = prims["ec"].ctx.admin_socket_path
        perf = AdminSocket.request(asok, "perf dump")
        frames = perf["msgr.osd.0"]["frames_in"]
        msgr = AdminSocket.request(asok, "dump_messenger")
        n_ec = len(names) * (sum(writers) * writes + 1)
        if frames < n_ec or msgr["totals"]["frames_in"] != frames:
            raise AssertionError(f"admin socket: perf dump frames_in "
                                 f"{frames}, dump_messenger "
                                 f"{msgr['totals']['frames_in']}, "
                                 f"{n_ec} writes sent")
        out["asok"] = {"frames_in": frames,
                       "connections": msgr["num_connections"],
                       "ec_assembly_copies":
                           perf["obs.copy"]["ec_assembly_copies"],
                       "bufpool": perf["obs.bufpool"]}
    finally:
        for cli in clients:
            cli.shutdown()
        for prim in prims.values():
            prim.shutdown()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    out["phase_s"] = time.perf_counter() - t_phase
    return out, k1_total, k3_total


CLUSTER_OSDS = 12          # 12 OSDs on 12 hosts, failure domain host
CLUSTER_MONS = 3
CLUSTER_PG_NUM = 32        # Quincy's osd_pool_default_pg_num
CLUSTER_CLIENTS = 8
CLUSTER_OBJECTS = 16       # objects written to each EC pool (64 until
#                            phase 15 came: PERF.md section 4)
CLUSTER_OBJECT = EC_OBJECT  # 4 MiB: RBD's and CephFS's object size
CLUSTER_IMAGE = 16 << 20   # the image's size, in 4 MiB objects (was 64 MiB)
CLUSTER_RMW = (3 << 19, 1 << 20)   # (offset, length) of the overwrite
CLUSTER_REP = 1            # the replicated pool (size 3)
CLUSTER_EC = (             # (pool id, profile name, profile, kernel)
    (2, "isa8_3", {"plugin": "isa", "k": "8", "m": "3"}, "k1"),
    (3, "cauchy4_2", {"plugin": "jerasure", "technique": "cauchy_good",
                      "k": "4", "m": "2", "w": "8", "packetsize": "8"},
     "k3"),
)
CLUSTER_WAIT = 120.0       # seconds any wait of the phase may take
CLUSTER_OUT_S = 5.0        # mon_osd_down_out_interval
CLUSTER_ROUNDS = 5         # balancer rounds before one commits whole


def cluster_object(spec):
    """An object's bytes from its spec: ("rng", seed, size[, (offset,
    length, seed)]) draws ``size`` bytes from ``seed`` and overwrites
    ``length`` bytes at ``offset`` with bytes drawn from the second
    seed; ("slice", seed, size, lo, hi) is bytes [lo, hi) of such a draw;
    ("bytes", raw) is ``raw``."""
    if spec[0] == "bytes":
        return bytes(spec[1])
    rng = np.random.default_rng(spec[1])
    data = rng.integers(0, 256, spec[2], dtype=np.uint8)
    if spec[0] == "slice":
        return data[spec[3]:spec[4]].tobytes()
    if len(spec) > 3:
        off, ln, seed = spec[3]
        data[off:off + ln] = np.random.default_rng(seed).integers(
            0, 256, ln, dtype=np.uint8)
    return data.tobytes()


def cluster_digests(profile, spec):
    """sha256 of each chunk of ``spec``'s object under ``profile`` on the
    CPU (the plain versions), in chunk order; None for a replicated
    object, whose one shard is the object itself."""
    import hashlib

    import torch

    from ceph_tpu_torch.ec.registry import profile_factory

    torch.set_num_threads(1)   # one core a worker
    raw = cluster_object(spec)
    if profile is None:
        return [hashlib.sha256(raw).hexdigest()]
    code = profile_factory(dict(profile), device="cpu")
    n = code.get_chunk_count()
    chunks = code.encode(range(n), raw)
    return [hashlib.sha256(chunks[p].numpy().tobytes()).hexdigest()
            for p in range(n)]


def cluster_shards(cl):
    """{(pool, oid, shard): [(osd, sha256, bytes)]} of every shard in
    every live OSD's store (a shard held twice, by a stray and its new
    holder, is listed once a holder)."""
    import hashlib

    out = {}
    for osd, svc in sorted(cl.osds.items()):
        st = svc.store
        for cid in st.list_collections():
            pool = int(cid.split(".")[0])
            for name in st.list_objects(cid):
                oid, _, shard = name.rpartition(".s")
                if not shard.isdigit():
                    continue
                raw = bytes(st.read(cid, name))
                out.setdefault((pool, oid, int(shard)), []).append(
                    (osd, hashlib.sha256(raw).hexdigest(), len(raw)))
    return out


def check_cluster_shards(cl, expected, label):
    """Every shard in every store equals the CPU's chunk, and every
    object's every chunk is in some store.  Returns {(pool, oid, shard):
    {holder: bytes}}."""
    held = cluster_shards(cl)
    for (pool, oid, shard), holders in held.items():
        want = expected.get((pool, oid))
        if want is None:
            raise AssertionError(f"{label}: unknown shard {oid}.s{shard} "
                                 f"in pool {pool}")
        for osd, digest, _n in holders:
            if digest != want[shard]:
                raise AssertionError(
                    f"{label}: pool {pool} {oid}.s{shard} on osd.{osd} "
                    f"differs from the CPU's chunk")
    for (pool, oid), want in expected.items():
        for shard in range(len(want)):
            if (pool, oid, shard) not in held:
                raise AssertionError(f"{label}: pool {pool} {oid}.s{shard} "
                                     f"is in no store")
    return {key: {osd: n for osd, _d, n in holders}
            for key, holders in held.items()}


def cluster_settled(cl):
    """True when every PG has reported active+clean to the monitor."""
    pgs = cl.health()["pgmap"]
    return pgs["pgs_reported"] == pgs["pgs_total"] and \
        set(pgs["by_state"]) == {"active+clean"}


def cluster_landed(cl, specs, profiles):
    """True when every object of ``specs`` has every shard on the OSD of
    its up set's position, all at one version."""
    from ceph_tpu_torch.services.client import object_to_ps

    m = _map_of(cl)
    for (pool, oid) in specs:
        ps = object_to_ps(oid) % m.pools[pool].pg_num
        up, _p, _a, _ap = m.pg_to_up_acting_osds(pool, ps)
        versions = set()
        for pos, osd in enumerate(up):
            svc = cl.osds.get(osd)
            if svc is None:
                return False
            shard = pos if profiles[pool] is not None else 0
            try:
                v = svc.store.getattr(f"{pool}.{ps}", f"{oid}.s{shard}",
                                      "v")
            except KeyError:
                return False
            if v is None:
                return False
            versions.add(v)
        if len(versions) != 1:
            return False
    return True


class EngineTally:
    """Counts the EC engine's calls by kind and route while open: each
    booking of ``ec.engine._account`` is one launch of K3 (a packet
    layout) or K1 (w=8), for encode or decode."""

    def __init__(self):
        import threading

        self.counts = {}
        self._lock = threading.Lock()

    def __enter__(self):
        from ceph_tpu_torch.ec import engine

        self.real = engine._account

        def tap(kind, sig, *a, **kw):
            route = "k3" if sig[4] else "k1"   # sig[4]: the packet size
            with self._lock:
                self.counts[(route, kind)] = \
                    self.counts.get((route, kind), 0) + 1
            return self.real(kind, sig, *a, **kw)

        engine._account = tap
        return self

    def __exit__(self, *exc):
        from ceph_tpu_torch.ec import engine

        engine._account = self.real
        return False

    def get(self, route, kind):
        return self.counts.get((route, kind), 0)


def _map_of(cl):
    from ceph_tpu_torch.osdmap.bincode_maps import payload_map

    return payload_map(cl.mon_command({"type": "get_map"}))


def _wait_for(cond, what, timeout=CLUSTER_WAIT):
    """Wait for ``cond()`` (polled every 50 ms) under a deadline."""
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            raise TimeoutError(f"phase 13: {what} after {timeout} s")
        time.sleep(0.05)


def _pmap(fn, items, n):
    """``fn`` over ``items`` on ``n`` threads (item i on thread i % n);
    returns the results in order, raising the first error."""
    import threading

    out = [None] * len(items)
    errs = []

    def run(t):
        try:
            for i in range(t, len(items), n):
                out[i] = fn(t, items[i])
        except Exception as e:  # raised below
            errs.append(e)

    threads = [threading.Thread(target=run, args=(t,)) for t in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errs:
        raise errs[0]
    return out


def _ms_stats(xs):
    xs = np.asarray(xs, dtype=np.float64) * 1e3
    return {"p50_ms": float(np.percentile(xs, 50)),
            "p99_ms": float(np.percentile(xs, 99)),
            "mean_ms": float(xs.mean()), "n": int(xs.size)}


def phase_cluster(dev, card, pool=None, osds=CLUSTER_OSDS, mons=CLUSTER_MONS,
                  pg_num=CLUSTER_PG_NUM, clients=CLUSTER_CLIENTS,
                  objects=CLUSTER_OBJECTS, size=CLUSTER_OBJECT,
                  image=CLUSTER_IMAGE, rmw=CLUSTER_RMW, tools=None):
    """Phase 13: a live ``MiniCluster`` on ``dev``.

    ``mons`` monitors, ``osds`` OSDs on as many hosts, a replicated pool
    (size 3) and two EC pools (isa 8+3, K1; jerasure cauchy_good 4+2
    packetsize 8, K3) of ``pg_num`` PGs.  ``clients`` clients write
    ``objects`` seeded objects of ``size`` bytes to each EC pool, read
    them back, overwrite part of one (read-modify-write) in each, and an
    image on the isa pool writes and reads ``image`` bytes.  One OSD is
    killed (marked down), every object read degraded; a second, and
    again.  Once the monitor has marked both out
    (``mon_osd_down_out_interval``) both come back with empty stores
    (replaced disks: with 11 of 12 hosts in, CRUSH leaves a position of
    some 8+3 PG empty) and recovery rebuilds every lost shard.  Then
    the mgr runs one forced balancer round, held to the offline
    ``calc_pg_upmaps`` on the same map, and the monitor commits it.

    Every read is held to the bytes written; every shard in every store,
    before the kills and after recovery, to the same profile's encode on
    the CPU (sha256 of each chunk, computed in ``pool``'s workers when
    given); K1's and K3's launches to the EC engine's calls by route and
    kind, and K2's to the balancer's ``map_all`` calls.

    ``tools(cl, clis, profiles, expected)``, when given, runs once the
    balancer's round is committed, before the shutdown (phase 14 (b) on
    this cluster: no second cluster is booted); its calls are left out
    of the kernels' device time, its record goes under ``"tools"`` and
    the launches it counted there (``"launches"``) are left out of this
    phase's ``launches`` record.  Returns (report, (K1, K2, K3)
    launches of this phase and ``tools``)."""
    import torch

    from ceph_tpu_torch.common.config import Config
    from ceph_tpu_torch.common.perf_counters import collection
    from ceph_tpu_torch.services.client import object_to_ps
    from ceph_tpu_torch.services.cluster import MiniCluster
    from ceph_tpu_torch.services.image import Image, encode_header

    t_phase = time.perf_counter()
    conf = Config()
    # failure detection is the monitor's command here (mark_down), so
    # pings are sparse and their grace wide: 12 OSDs in one process
    # pinging every 0.5 s fill every OSD's control lane (both packages),
    # and neither a loaded host nor the killed OSDs may be marked down
    # before the degraded reads are done
    conf.set("osd_heartbeat_interval", 5.0)
    conf.set("osd_heartbeat_grace", 600.0)
    # and their RTT warning (OSD_SLOW_PING_TIME) as wide: one process's
    # 12 OSDs answer pings in 2-3 s after the writes, and phase 14's
    # `ceph_cli health` must find the cluster HEALTH_OK
    conf.set("osd_heartbeat_ping_threshold_ms", 30000.0)
    # and the monitors' leases are long: a busy host must not send the
    # quorum into elections (no monitor is killed here)
    conf.set("mon_lease", 3.0)
    conf.set("mon_election_timeout", 3.0)
    # the monitor marks a down OSD out after this (an out remaps EC
    # positions, and a read finds fewer than k shards until recovery has
    # moved them: the OSDs are marked down once the reads are done)
    conf.set("mon_osd_down_out_interval", CLUSTER_OUT_S)
    # recovery slots an OSD grants: Quincy's osd_recovery_max_active_ssd
    # (an 8+3 PG reserves a slot on all 11 of its OSDs; at the HDD
    # default of 3 the cluster recovers three PGs at a time)
    conf.set("osd_max_recovery_ops", 10)
    # and PGs an OSD recovers at once (Quincy's default is 1; its
    # high_recovery_ops profile lifts it)
    conf.set("osd_max_backfills", 4)
    conf.set("balancer_max_deviation", 1)
    # spans an OSD keeps (the default is 512): phase 14 folds the traces
    # of a 10 s write burst to 12 OSDs
    conf.set("trace_ring_size", 8192)
    cl = MiniCluster(n_osds=osds, config=conf, n_mons=mons,
                     device=dev).start()
    out = {"card": card, "osds": osds, "mons": mons, "pg_num": pg_num,
           "clients": clients, "objects_per_pool": objects,
           "object_bytes": size, "image_bytes": image}
    specs = {}          # (pool, oid) -> the object's spec
    down = False
    profiles = {CLUSTER_REP: None}
    digests = {}
    try:
        cl.create_replicated_pool(CLUSTER_REP, pg_num=pg_num, size=3)
        for pid, name, prof, _k in CLUSTER_EC:
            cl.create_ec_pool(pid, name, dict(prof), pg_num=pg_num)
            profiles[pid] = prof
        # the new PGs peer before the first write
        cl.wait_for_health_ok(timeout=CLUSTER_WAIT)
        clis = [cl.client(f"c{j}") for j in range(clients)]
        out["setup_s"] = time.perf_counter() - t_phase
        for pid, _n, _p, _k in CLUSTER_EC:
            for i in range(objects):
                specs[(pid, f"obj{i}")] = ("rng", (13, pid, i), size)
        ec_pids = [pid for pid, *_ in CLUSTER_EC]
        names = sorted({oid for _p, oid in specs})
        rmw_oid = names[0]
        unit = 4 << 20 if image % (4 << 20) == 0 else image // 4
        img_seed = (13, 0, 1)

        def expect(key, spec):
            if pool is None:
                digests[key] = cluster_digests(profiles[key[0]], spec)
            else:
                digests[key] = pool.submit(cluster_digests,
                                           profiles[key[0]], spec)

        # the CPU's chunks of every object, in the workers while the
        # cluster runs (an overwritten object's are asked for again)
        for key, spec in specs.items():
            expect(key, spec)
        set_launch_counts((0, 0, 0))
        tally = EngineTally()
        ops0 = collection().dump()["ec.engine"]
        with tally, KernelClock(dev) as clock:
            t_data0 = time.monotonic()
            # 1. every client writes its share to each EC pool at once
            for pid in ec_pids:
                keys = [k for k in specs if k[0] == pid]

                def put(t, key):
                    raw = cluster_object(specs[key])
                    t0 = time.monotonic()
                    clis[t].put(key[0], key[1], raw)
                    return time.monotonic() - t0

                t0 = time.perf_counter()
                lat = _pmap(put, keys, clients)
                wall = time.perf_counter() - t0
                out[f"write_pool{pid}"] = {
                    "writes": len(keys), "wall_s": wall,
                    "writes_per_s": len(keys) / wall,
                    "object_GB_per_s": len(keys) * size / wall / 1e9,
                    **_ms_stats(lat)}
                log(f"cluster: pool {pid} writes " + json.dumps(
                    out[f"write_pool{pid}"]))

            def read_all(label):
                keys = sorted(specs)

                def get(t, key):
                    t0 = time.monotonic()
                    got = clis[t].get(key[0], key[1])
                    dt = time.monotonic() - t0
                    if got != cluster_object(specs[key]):
                        raise AssertionError(f"{label}: pool {key[0]} "
                                             f"{key[1]} read back wrong")
                    return dt

                t0 = time.perf_counter()
                lat = _pmap(get, keys, clients)
                wall = time.perf_counter() - t0
                rec = {"reads": len(keys), "wall_s": wall,
                       "reads_per_s": len(keys) / wall, **_ms_stats(lat)}
                log(f"cluster: {label} " + json.dumps(rec))
                return rec

            out["read"] = read_all("reads")
            # 2. one read-modify-write a pool
            off, ln = rmw
            for pid in ec_pids:
                key = (pid, rmw_oid)
                new = ("rng", (13, pid, 9999), ln)
                t0 = time.monotonic()
                clis[0].write(pid, rmw_oid, off, cluster_object(new))
                out[f"rmw_pool{pid}_ms"] = (time.monotonic() - t0) * 1e3
                specs[key] = specs[key] + ((off, ln, (13, pid, 9999)),)
                expect(key, specs[key])
                if clis[0].get(pid, rmw_oid) != cluster_object(specs[key]):
                    raise AssertionError(f"pool {pid}: the overwritten "
                                         f"object reads back wrong")
            # 3. an RBD-style image on the isa pool: 4 MiB objects
            img = Image.create(clis[0], ec_pids[0], "img", image,
                               stripe_unit=unit, stripe_count=1,
                               object_size=unit)
            data = cluster_object(("rng", img_seed, image))
            t0 = time.monotonic()
            img.write(0, data)
            t1 = time.monotonic()
            if img.read(0, image) != data:
                raise AssertionError("the image reads back wrong")
            t2 = time.monotonic()
            out["image"] = {"write_s": t1 - t0, "read_s": t2 - t1,
                            "write_MB_per_s": image / (t1 - t0) / 1e6,
                            "read_MB_per_s": image / (t2 - t1) / 1e6}
            log("cluster: image " + json.dumps(out["image"]))
            for j in range(image // unit):
                specs[(ec_pids[0], f"img.{j:016x}")] = (
                    "slice", img_seed, image, j * unit, (j + 1) * unit)
            specs[(ec_pids[0], "rbd_header.img")] = (
                "bytes", encode_header(img._h))
            for key, spec in specs.items():
                if key not in digests:   # the image's objects
                    expect(key, spec)
            t_check = time.perf_counter()
            # every shard of every object in place before the kills: a
            # write is acked once k shards land (a sub-write can time
            # out on a busy host), and recovery completes the rest
            t0 = time.monotonic()
            _wait_for(lambda: cluster_landed(cl, specs, profiles),
                      "the writes' shards never all landed")
            out["landed_wait_s"] = time.monotonic() - t0
            expected = {key: (d.result() if hasattr(d, "result") else d)
                        for key, d in digests.items()}
            before = check_cluster_shards(cl, expected, "before the kills")
            out["shards_checked_before"] = len(before)
            out["check_before_s"] = time.perf_counter() - t_check

            # 4. kill two OSDs that hold shards, degraded-read everything
            m = _map_of(cl)
            victims = []
            for pid in ec_pids:
                ps = object_to_ps(names[1]) % m.pools[pid].pg_num
                up, _p, _a, _ap = m.pg_to_up_acting_osds(pid, ps)
                victims += [o for o in up if o not in victims]
            victims = victims[:2]
            t_kill = time.monotonic()
            # (the map still has them up: a read finds them gone and
            # decodes from the others)
            for n_kill, victim in enumerate(victims, 1):
                cl.kill_osd(victim)
                out[f"degraded_read_{n_kill}"] = read_all(
                    f"degraded reads, {n_kill} OSD(s) down")
            # 5. marked down, the monitor marks both out after
            # mon_osd_down_out_interval; both come back empty (new
            # disks: with 11 of 12 hosts in, CRUSH leaves a position of
            # an 8+3 PG empty, so the pool would never be whole)
            for victim in victims:
                cl.mon_command({"type": "mark_down", "osd": victim})
            _wait_for(lambda: all(_map_of(cl).osd_weight[v] == 0
                                  for v in victims),
                      "the monitor has not marked the OSDs out")
            t_out = time.monotonic()
            for v in victims:
                cl.revive_osd(v)
            for pid in [CLUSTER_REP] + ec_pids:
                objs = {oid: 0 for p, oid in specs if p == pid}
                cl.wait_for_recovery(pid, objs, timeout=CLUSTER_WAIT)
            t_clean = time.monotonic()
            data_wall = t_clean - t_data0
            t0 = time.perf_counter()
            after = check_cluster_shards(cl, expected, "after recovery")
            # a shard is rebuilt where a holder has it now that did not
            # before the kills, or that came back with an empty store
            rebuilt = [(key, osd, n) for key, holders in after.items()
                       for osd, n in holders.items()
                       if osd in victims or osd not in before.get(key, {})]
            rebuilt_bytes = sum(n for _k, _o, n in rebuilt)
            out["recovery"] = {
                "killed": victims, "revived_empty": victims,
                "rebuilt_shards": len(rebuilt),
                "rebuilt_MB": rebuilt_bytes / 1e6,
                "from_kill_s": t_clean - t_kill,
                "from_out_s": t_clean - t_out,
                "MB_per_s_from_out": rebuilt_bytes / 1e6 / (t_clean - t_out)}
            log("cluster: recovery " + json.dumps(out["recovery"]))
            out["check_after_s"] = time.perf_counter() - t0
            if not rebuilt:
                raise AssertionError("recovery rebuilt no shard")
            if launch_counts()[1]:
                raise AssertionError("phase 13: K2 ran on the data path")
            # 6. the mgr: one forced balancer round, held to
            # calc_pg_upmaps, once every PG has settled (the commits of
            # a busy cluster's monitors time out)
            t0 = time.perf_counter()
            _wait_for(lambda: cluster_settled(cl),
                      "the PGs never settled after recovery")
            out["settle_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            out["balancer"], k2_bal = cluster_balancer(cl, conf, dev)
            out["balancer"]["card"] = card
            out["balancer"]["step_s"] = time.perf_counter() - t0
            log("cluster: balancer " + json.dumps(out["balancer"]))
            if tools is not None:
                clock.recording = False
                out["tools"] = tools(cl, clis, profiles, expected)
                clock.recording = True
            down = True
            t0 = time.perf_counter()
            cl.shutdown()
            out["shutdown_s"] = time.perf_counter() - t0
            # every launch of the run against the EC engine's calls, by
            # route and kind, and K2's against the balancer's sweeps
            ops1 = collection().dump()["ec.engine"]
            k1, k2, k3 = launch_counts()
            calls = {f"{r}_{k}": tally.get(r, k) for r in ("k1", "k3")
                     for k in ("encode", "decode")}
            booked = (ops1["encode_ops"] - ops0["encode_ops"]
                      + ops1["decode_ops"] - ops0["decode_ops"])
            if (k1 != calls["k1_encode"] + calls["k1_decode"]
                    or k3 != calls["k3_encode"] + calls["k3_decode"]
                    or k1 + k3 != booked or k2 != k2_bal
                    or min(calls.values()) < 1):
                raise AssertionError(f"phase 13: launches (K1, K2, K3) "
                                     f"{(k1, k2, k3)}, engine calls "
                                     f"{calls}, booked {booked}, balancer "
                                     f"K2 {k2_bal}")
            theirs = out.get("tools", {}).get("launches", {})
            out["launches"] = {key: n - theirs.get(key, 0) for key, n in
                               {"k1": k1, "k3": k3, **calls}.items()}
            # the kernels' device time with the cluster stopped: no
            # other thread may touch the card while the graph captures
            t0 = time.perf_counter()
            kernel_ms = clock.ms()
            out["replay_s"] = time.perf_counter() - t0
            if launch_counts() != (k1, k2, k3):
                raise AssertionError("phase 13: the graph replay counted "
                                     "launches")
    finally:
        if not down:
            cl.shutdown()
    segs, spans = wire_quiesced()
    if segs:
        raise AssertionError(f"phase 13: receive segments still held: "
                             f"{segs[:4]}")
    if spans:
        raise AssertionError(f"phase 13: spans left open: "
                             f"{[s.name for _, s in spans][:4]}")
    if dev.type == "cuda":
        torch.cuda.synchronize()
    out["kernel_ms"] = kernel_ms
    out["data_wall_s"] = data_wall
    out["kernel_share"] = kernel_ms / 1e3 / data_wall
    out["phase_s"] = time.perf_counter() - t_phase
    return out, (k1, k2, k3)


def _committed_on_a_monitor(cl, target, only=None):
    """True when some monitor's committed pg_upmap_items equal
    ``target`` (on the PGs of ``only`` when given: a PG missing from
    ``target`` must have no entry).  Each monitor is asked on its own:
    the first to answer may be one that lost quorum in an earlier round
    and has not caught up with the quorum's commits."""
    from ceph_tpu_torch.osdmap.bincode_maps import payload_map
    from ceph_tpu_torch.services.map_follower import failover_call

    for mon in list(cl.mons.values()):
        try:
            rep, _ = failover_call(mon.msgr, [mon.addr], {"type": "get_map"},
                                   timeout=5.0, tries=1)
        except (OSError, TimeoutError, RuntimeError):
            continue
        if "error" in rep:
            continue
        got = {pg: [list(p) for p in v]
               for pg, v in payload_map(rep).pg_upmap_items.items()}
        if only is not None:
            got = {pg: v for pg, v in got.items() if pg in only}
            want = {pg: v for pg, v in target.items() if pg in only}
        else:
            want = target
        if got == want:
            return True
    return False


def cluster_balancer(cl, conf, dev):
    """Step 6 of phase 13: start the mgr, force one balancer round and
    hold its proposal to the offline ``calc_pg_upmaps`` on the same map
    (same options, same seed); wait until the monitor has committed
    it (a round whose commit the monitor aborted is followed by
    another, at most ``CLUSTER_ROUNDS``).  Returns (record, K2
    launches), each round's launches asserted equal to its ``map_all``
    calls."""
    from ceph_tpu_torch.crush import mapper
    from ceph_tpu_torch.crush.wrapper import CrushWrapper
    from ceph_tpu_torch.mgr.balancer_module import diff_upmap_items
    from ceph_tpu_torch.osdmap.balancer import calc_pg_upmaps
    from ceph_tpu_torch.osdmap.osdmap import OSDMap
    from ceph_tpu_torch.osdmap.pipeline import PoolMapper

    mgr = cl.start_mgr()
    bal = mgr.modules["balancer"]
    _wait_for(lambda: mgr.epoch >= _map_of(cl).epoch,
              "the mgr has not caught up with the monitor")
    maps, sent, broke = [], [], []
    real_map_all = PoolMapper.map_all
    real_mon_call = mgr.mon_call

    def map_all(self, *a, **kw):
        maps.append(self.pool_id)
        return real_map_all(self, *a, **kw)

    def mon_call(msg, *a, **kw):
        upmap = msg.get("type") == "pg_upmap_items_set"
        try:
            rep = real_mon_call(msg, *a, **kw)
        except Exception as e:
            # the round stops proposing here; the rest waits for the
            # next round
            if upmap:
                broke.append(((msg["pool"], msg["ps"]), repr(e)))
            raise
        if upmap:
            sent.append(((msg["pool"], msg["ps"]), msg["items"], rep))
        return rep

    k2_total = rounds = proposed = 0
    for _attempt in range(CLUSTER_ROUNDS):
        m0, _w0, epoch = bal._snapshot()
        rounds0 = bal.rounds
        maps.clear()
        sent.clear()
        broke.clear()
        k2_before = launch_counts()[1]
        PoolMapper.map_all = map_all
        mgr.mon_call = mon_call
        try:
            t0 = time.perf_counter()
            rec = bal.command({"argv": ["execute"]})
            round_s = time.perf_counter() - t0
        finally:
            PoolMapper.map_all = real_map_all
            del mgr.mon_call
        k2_round = launch_counts()[1] - k2_before
        if k2_round != len(maps) or k2_round < 1:
            raise AssertionError(f"phase 13: {len(maps)} map_all calls of "
                                 f"the balancer launched K2 {k2_round} "
                                 f"times")
        k2_total += k2_round
        rounds += 1
        if rec.get("epoch") != epoch:
            continue   # the round swept a newer map than the snapshot
        old = {pg: list(v) for pg, v in m0.pg_upmap_items.items()}
        m_off = OSDMap.from_dict(m0.to_dict())
        # the offline run's K2 launches do not count; K2's count alone
        # goes back (recovery after an earlier round's commit launches
        # K1 and K3 meanwhile)
        k2_offline = mapper.crush_rule_batched.launches
        calc_pg_upmaps(m_off, max_deviation=int(conf[
            "balancer_max_deviation"]), max_iterations=int(conf[
            "balancer_max_iterations"]), wrapper=CrushWrapper(m_off.crush),
            use_batched=True, seed=rounds0 + 1, device=dev)
        mapper.crush_rule_batched.launches = k2_offline
        want = diff_upmap_items(old, m_off.pg_upmap_items)
        got = [(pg, [list(p) for p in items]) for pg, items, _r in sent]
        # a proposal whose call raised ends the round: what it sent
        # before must be the offline proposals' first ones
        held = [(pg, [list(p) for p in items]) for pg, items in want]
        if got != (held[:len(got)] if broke else held):
            raise AssertionError(f"phase 13: the balancer proposed {got}, "
                                 f"offline calc_pg_upmaps {want}: {rec}")
        proposed += len(got)
        refused = [(pg, r) for pg, _i, r in sent if "error" in r] + broke
        if not refused:
            break
        # a commit the monitor aborted (its quorum lapsed under load):
        # the next round starts from what it did commit
        log(f"cluster: the monitor refused balancer proposals {refused}; "
            f"another round")
    else:
        raise AssertionError(f"phase 13: no balancer round of "
                             f"{CLUSTER_ROUNDS} was committed whole")
    if not proposed:
        raise AssertionError(f"phase 13: the balancer proposed nothing: "
                             f"{rec}")
    target = {pg: [list(p) for p in v]
              for pg, v in m_off.pg_upmap_items.items()}
    # after a refused round a new leader may still commit a refused
    # proposal it finds accepted (the Paxos re-propose), so the map is
    # held to the last round's proposals there, and whole otherwise
    only = {pg for pg, _items in want} if rounds > 1 else None
    _wait_for(lambda: _committed_on_a_monitor(cl, target, only),
              "the monitor has not committed the balancer's upmaps")
    return {"round_s": round_s, "rounds": rounds, "proposed": proposed,
            "k2_launches": k2_total, "map_all_calls_last_round": len(maps),
            "stddev_before": rec.get("stddev_before"),
            "stddev_after": rec.get("stddev_after")}, k2_total


# -- phase 14: the cluster tools -----------------------------------------
BENCH_OBJECT = 4 << 20    # upstream `rados bench`'s object size (-b)
BENCH_OPS = 16            # and its ops in flight (-t)
BENCH_SECONDS = 5         # upstream's duration is 60 s (10 until phase 15)
TOOLS_SECONDS = 5         # ObjBencher's write and seq on phase 13's cluster
#                           (10 until phase 15)
TAP_EVERY = 8             # every 8th K1 launch held to the plain version
TOOLS_UNATTRIBUTED = 0.10  # the most of a write's time no stage may name

_PROM_METRIC = r"[a-zA-Z_:][a-zA-Z0-9_:]*"
_PROM_LABELS = (r"\{[a-zA-Z_][a-zA-Z0-9_]*="
                r'"(?:[^"\\\n]|\\\\|\\"|\\n)*"'
                r"(?:,[a-zA-Z_][a-zA-Z0-9_]*="
                r'"(?:[^"\\\n]|\\\\|\\"|\\n)*")*\}')
_PROM_SAMPLE = (rf"^{_PROM_METRIC}(?:{_PROM_LABELS})? "
                r"[-+]?(?:[0-9.eE+-]+|Inf|NaN)$")


def check_exposition(text):
    """The Prometheus text exposition grammar ``ceph_tpu``'s telemetry
    tests hold its output to: one HELP and one TYPE line a family, before
    its samples; well-formed samples with escaped label values.  Returns
    the number of samples."""
    import re

    seen = {"HELP": set(), "TYPE": set()}
    samples = 0
    if not text.endswith("\n"):
        raise AssertionError("prom: the exposition does not end a line")
    for line in text.splitlines():
        m = re.match(rf"^# (HELP|TYPE) ({_PROM_METRIC})(?: (.*))?$", line)
        if m:
            if m.group(2) in seen[m.group(1)]:
                raise AssertionError(f"prom: a second # {m.group(1)} for "
                                     f"{m.group(2)}")
            seen[m.group(1)].add(m.group(2))
            if m.group(1) == "TYPE" and m.group(3) not in (
                    "counter", "gauge", "histogram", "summary", "untyped"):
                raise AssertionError(f"prom: bad type {line!r}")
            continue
        if not re.match(_PROM_SAMPLE, line):
            raise AssertionError(f"prom: bad sample {line!r}")
        name = re.match(_PROM_METRIC, line).group(0)
        if name not in seen["TYPE"] and \
                re.sub(r"_(bucket|sum|count)$", "", name) not in seen["TYPE"]:
            raise AssertionError(f"prom: sample {name} has no # TYPE")
        samples += 1
    if seen["HELP"] != seen["TYPE"]:
        raise AssertionError("prom: HELP and TYPE families differ")
    return samples


class SampledTap:
    """Replaces ``gf2_kernels.gf2_matmul_w8`` while open: every
    ``every``-th call (the first included) has its product held byte for
    byte to the plain version on the same inputs, on the same device.  A
    wrapper counts its launches on the name its module holds, the tap's
    while open; they go to the real wrapper's count on close, and the
    plain version counts none.  Daemon threads call at once, so a
    mismatch is recorded (``bad``), not raised in the caller's thread.
    ``nbytes`` sums the calls' byte bound: each input row read once,
    each output row and the bit matrix written or read once."""

    def __init__(self, every=TAP_EVERY):
        import threading

        self.every, self.calls, self.checked, self.bad = every, 0, 0, []
        self.nbytes = 0
        self._lock = threading.Lock()

    def __enter__(self):
        import torch

        from ceph_tpu_torch.ec import gf2_kernels

        self.mod, self.real = gf2_kernels, gf2_kernels.gf2_matmul_w8
        real, plain = self.real, gf2_kernels.gf2_matmul_w8_plain

        def tap(bm, data, fragments=None):
            out = real(bm, data, fragments)
            k, m = bm.shape[1] // 8, bm.shape[0] // 8
            cols = data[0].numel() if isinstance(data, (list, tuple)) \
                else data.numel() // k
            with self._lock:
                i = self.calls
                self.calls += 1
                self.nbytes += (k + m) * cols + bm.numel()
            if i % self.every == 0:
                rows = torch.stack(list(data)) \
                    if isinstance(data, (list, tuple)) else data
                same = torch.equal(out, plain(bm, rows))
                with self._lock:
                    self.checked += 1
                    if not same:
                        self.bad.append(tuple(bm.shape) + tuple(rows.shape))
            return out

        tap.launches = 0
        self.tap = tap
        self.mod.gf2_matmul_w8 = tap
        return self

    def __exit__(self, *exc):
        self.mod.gf2_matmul_w8 = self.real
        self.real.launches += self.tap.launches
        return False


def _engine_ops():
    """The EC engine's booked encode and decode calls so far."""
    from ceph_tpu_torch.common.perf_counters import collection
    from ceph_tpu_torch.ec import engine  # noqa: F401  (its logger)

    d = collection().dump()["ec.engine"]
    return d["encode_ops"] + d["decode_ops"]


def _cli(main, argv):
    """``main(argv)`` in this process, its standard output captured:
    (exit code, output)."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


def phase_rados_bench(dev, card, size=BENCH_OBJECT, ops=BENCH_OPS,
                      seconds=BENCH_SECONDS, device="cuda"):
    """Phase 14 (a): ``rados_bench``'s CLI in this process, with its own
    cluster defaults (4 OSDs, pg_num 16, the EC pool jerasure
    reed_sol_van 2+1), at upstream's 4 MiB objects and 16 ops in flight:
    ``seq`` (16 writer threads, then 16 readers) and ``write`` through the
    aio window at queue depth 16.  Each run: no op class has an error,
    the copy ledger's engine is ``bitplane`` (K1), K1's launches equal
    the EC engine's booked calls (all on K1's route) and every
    ``TAP_EVERY``-th launch equals the plain version.  Returns (records,
    K1 launches)."""
    from ceph_tpu_torch.tools import rados_bench

    t_phase = time.perf_counter()
    runs = {
        "seq": ["seq", "--ec", "--object-size", str(size), "--concurrent",
                str(ops), "--seconds", str(seconds), "--device", device],
        "write": ["write", "--ec", "--object-size", str(size), "--qd",
                  str(ops), "--seconds", str(seconds), "--device", device],
    }
    out = {"card": card}
    k1_total = 0
    for label, argv in runs.items():
        set_launch_counts((0, 0, 0))
        ops0 = _engine_ops()
        t0 = time.perf_counter()
        with EngineTally() as tally, SampledTap() as tap:
            rc, text = _cli(rados_bench.main, argv)
        wall = time.perf_counter() - t0
        k1, k2, k3 = launch_counts()
        booked = _engine_ops() - ops0
        if rc != 0:
            raise AssertionError(f"phase 14: rados_bench {label} exit {rc}")
        rec = json.loads(text.strip().splitlines()[-1])
        classes = [c for c in ("write", "seq") if c in rec]
        errors = {c: rec[c]["errors"] for c in classes}
        calls = tally.get("k1", "encode") + tally.get("k1", "decode")
        if any(errors.values()) or not classes:
            raise AssertionError(f"phase 14: rados_bench {label} errors "
                                 f"{errors}")
        if rec["copy"]["engine"] != "bitplane":
            raise AssertionError(f"phase 14: rados_bench {label} ran on "
                                 f"{rec['copy']['engine']}")
        if (k1 < 1 or k1 != booked or k1 != calls or k1 != tap.calls
                or (k2, k3) != (0, 0)):
            raise AssertionError(f"phase 14: rados_bench {label} launches "
                                 f"(K1, K2, K3) {(k1, k2, k3)}, engine "
                                 f"calls {calls}, booked {booked}, tapped "
                                 f"{tap.calls}")
        if tap.bad or tap.checked < 1:
            raise AssertionError(f"phase 14: K1 differs from its plain "
                                 f"version on {tap.bad[:4]} (checked "
                                 f"{tap.checked})")
        rec.update(argv=argv, wall_s=wall, k1_launches=k1,
                   k1_checked=tap.checked, card=card)
        log("rados_bench: " + json.dumps(rec))
        out[label] = rec
        k1_total += k1
    out["phase_s"] = time.perf_counter() - t_phase
    return out, k1_total


def _pool_traces(snap, pool_id, root="client.put"):
    """The snapshot cut to the traces whose root is ``root`` on
    ``pool_id`` (the client tags its root span with the pool)."""
    from ceph_tpu_torch.tools import telemetry

    tids = {s["trace_id"] for s in telemetry.gather_spans(snap)
            if not s.get("parent_id") and s.get("name") == root
            and (s.get("tags") or {}).get("pool") == pool_id}
    daemons = {}
    for name, data in snap["daemons"].items():
        tr = data.get("tracing") or {}
        daemons[name] = {"tracing": {
            "spans": [s for s in tr.get("spans", [])
                      if s.get("trace_id") in tids],
            "active": []}}
    return {"ts": snap["ts"], "daemons": daemons, "unreachable": []}


def stage_split(report):
    """A ``latency_report`` reduced to the ``cluster_stages:`` line's
    fields; fails if ``unattributed`` holds over ``TOOLS_UNATTRIBUTED`` of
    the folded time (the port's span names no longer fold)."""
    total = sum(r["total_s"] for r in report["stages"].values())
    un = report["stages"]["unattributed"]["total_s"] / total if total else 0.0
    if report["n_ops"] < 1 or un > TOOLS_UNATTRIBUTED:
        raise AssertionError(f"phase 14: {report['n_ops']} folded writes, "
                             f"unattributed {un:.1%}")
    return {"n_ops": report["n_ops"],
            "op_p50_ms": report["total"]["p50_ms"],
            "op_p99_ms": report["total"]["p99_ms"],
            "unattributed_share": un,
            "stages": {s: {k: r[k] for k in ("share", "p50_ms", "p99_ms",
                                             "count")}
                       for s, r in report["stages"].items()}}


def phase_tools(cl, clis, profiles, expected, pool, card, device="cuda",
                seconds=TOOLS_SECONDS, size=BENCH_OBJECT, ops=BENCH_OPS):
    """Phase 14 (b), on phase 13's live cluster once its balancer round is
    committed.  With every launch count at 0 (phase 13's are put back
    after, this phase's added): ``ObjBencher`` write then seq for
    ``seconds`` on each EC pool (isa 8+3 on K1, cauchy_good 4+2 on K3),
    ``size`` objects, ``ops`` in flight, the write's traces folded into
    stages by ``telemetry.latency_report``; ``rados`` put/get/stat/ls/df
    of one object on the isa pool; ``ceph_cli`` status, health, df, osd
    tree, pool ls, balancer status, dencoder list; ``telemetry``
    snapshot, prom and latency.  Every bench object reads back equal to
    its bytes; every shard in every store equals the CPU encode (phase
    13's objects too); K1's and K3's launches equal the EC engine's
    calls by route.  ``expected`` (phase 13's digests) gains this
    phase's objects.  Returns the record, its launches under
    ``"launches"``."""
    import tempfile

    from ceph_tpu_torch.ec import gf2_kernels
    from ceph_tpu_torch.tools import ceph_cli, rados, rados_bench, telemetry

    t_phase = time.perf_counter()
    out = {"card": card, "seconds": seconds, "object_bytes": size,
           "ops_in_flight": ops}
    # the balancer's upmaps move EC positions: reads wait for them
    t0 = time.perf_counter()
    cl.wait_for_health_ok(timeout=CLUSTER_WAIT)
    _wait_for(lambda: cluster_settled(cl),
              "the PGs never settled after the balancer")
    out["settle_s"] = time.perf_counter() - t0
    ec_pids = [pid for pid, *_ in CLUSTER_EC]
    blob = bytes((i * 131 + 17) & 0xFF for i in range(size))
    spec = ("rng", (14, ec_pids[0], 0), size)
    # the CPU's chunks, in the workers (or here, before the counts
    # start: a CPU encode books an engine call and launches nothing)
    jobs = {pid: (profiles[pid], ("bytes", blob)) for pid in ec_pids}
    jobs["rados14"] = (profiles[ec_pids[0]], spec)
    digests = {key: (pool.submit(cluster_digests, *job) if pool is not None
                     else cluster_digests(*job))
               for key, job in jobs.items()}
    saved = swap_launch_counts((0, 0, 0))
    ops0 = _engine_ops()
    mon = "%s:%d" % tuple(cl.mon_addrs[0])
    quorum = ",".join("%s:%d" % tuple(a) for a in cl.mon_addrs)
    stages = {}
    with EngineTally() as tally:
        cli = cl.client("bench14")
        written = {}
        for pid in ec_pids:
            b = rados_bench.ObjBencher(cli, pid, object_size=size,
                                       concurrent=ops, prefix=f"bench14_{pid}")
            w = b.write(seconds).summary()
            snap = telemetry.cluster_snapshot(cl.asok_dir)
            rep = telemetry.latency_report(_pool_traces(snap, pid),
                                           root_prefix="client.put")
            stages[pid] = stage_split(rep)
            r = b.seq(seconds).summary()
            if w["errors"] or r["errors"] or not w["ops"] or not r["ops"]:
                raise AssertionError(f"phase 14: pool {pid} ObjBencher "
                                     f"write {w}, seq {r}")
            written[pid] = b.written
            out[f"objbench_pool{pid}"] = {"write": w, "seq": r}
            log(f"tools: pool {pid} ObjBencher " + json.dumps(
                out[f"objbench_pool{pid}"]))
        # rados: one object through the CLI on the isa pool
        raw = cluster_object(spec)
        with tempfile.TemporaryDirectory() as d:
            src, back = os.path.join(d, "in"), os.path.join(d, "out")
            with open(src, "wb") as f:
                f.write(raw)
            base = ["--mon", mon, "-p", str(ec_pids[0]), "--device", device]
            verbs = {"put": ["put", "rados14", src],
                     "get": ["get", "rados14", back],
                     "stat": ["stat", "rados14"], "ls": ["ls"], "df": ["df"]}
            for verb, argv in verbs.items():
                rc, text = _cli(rados.main, base + argv)
                if rc != 0:
                    raise AssertionError(f"phase 14: rados {verb} exit {rc}")
                if verb == "stat" and text.split() != ["rados14", "size",
                                                       str(size)]:
                    raise AssertionError(f"phase 14: rados stat {text!r}")
                if verb == "ls" and "rados14" not in text.split():
                    raise AssertionError("phase 14: rados ls misses the "
                                         "object")
            with open(back, "rb") as f:
                if f.read() != raw:
                    raise AssertionError("phase 14: rados get returned other "
                                         "bytes")
        # every bench object read back, 8 threads
        keys = [(pid, f"bench14_{pid}_{i}") for pid in ec_pids
                for i in range(written[pid])]
        t0 = time.perf_counter()

        def get(t, key):
            if clis[t].get(key[0], key[1]) != blob:
                raise AssertionError(f"phase 14: pool {key[0]} {key[1]} "
                                     f"reads back wrong")

        _pmap(get, keys, len(clis))
        out["read_back"] = {"objects": len(keys),
                            "wall_s": time.perf_counter() - t0}
    k1, k2, k3 = swap_launch_counts((0, 0, 0))
    booked = _engine_ops() - ops0
    calls = {f"{r}_{k}": tally.get(r, k) for r in ("k1", "k3")
             for k in ("encode", "decode")}
    # phase 13's counts back, with this phase's and any launched since
    with gf2_kernels.COUNT_LOCK:
        set_launch_counts(tuple(a + b + c for a, b, c in zip(
            saved, (k1, k2, k3), launch_counts())))
    if (k1 != calls["k1_encode"] + calls["k1_decode"]
            or k3 != calls["k3_encode"] + calls["k3_decode"]
            or k1 + k3 != booked or k2 or k1 < 1 or k3 < 1):
        raise AssertionError(f"phase 14: launches (K1, K2, K3) "
                             f"{(k1, k2, k3)}, engine calls {calls}, "
                             f"booked {booked}")
    out["launches"] = {"k1": k1, "k3": k3, **calls}
    # every shard of every object in every store, against the CPU
    t0 = time.perf_counter()
    digests = {key: (d.result() if hasattr(d, "result") else d)
               for key, d in digests.items()}
    expected[(ec_pids[0], "rados14")] = digests["rados14"]
    for pid, oid in keys:
        expected[(pid, oid)] = digests[pid]
    mine = dict.fromkeys(keys + [(ec_pids[0], "rados14")])
    _wait_for(lambda: cluster_landed(cl, mine, profiles),
              "phase 14: the bench's shards never all landed")
    held = check_cluster_shards(cl, expected, "phase 14")
    out["shards_checked"] = len(held)
    out["check_s"] = time.perf_counter() - t0
    # ceph_cli, then telemetry over the admin sockets, once the ops the
    # bench left slow (SLOW_OPS) and its shards' recovery have cleared:
    # `health` exits 1 on anything but HEALTH_OK
    t0 = time.perf_counter()
    cl.wait_for_health_ok(timeout=CLUSTER_WAIT)
    out["health_wait_s"] = time.perf_counter() - t0
    verbs = (["--mon", quorum, "status"], ["--mon", quorum, "health"],
             ["--mon", quorum, "df"], ["--mon", quorum, "osd", "tree"],
             ["--mon", quorum, "pool", "ls"],
             ["--asok-dir", cl.asok_dir, "balancer", "status"],
             ["dencoder", "list"])
    for argv in verbs:
        rc, text = _cli(ceph_cli.main, argv)
        if rc != 0 or not text.strip():
            raise AssertionError(f"phase 14: ceph_cli {argv} exit {rc}: "
                                 f"{text[-2000:]}")
    out["ceph_cli"] = [" ".join(v[2:] if v[0].startswith("--") else v)
                       for v in verbs]
    rc, text = _cli(telemetry.main, ["--asok-dir", cl.asok_dir, "snapshot"])
    snap = json.loads(text)
    if rc != 0 or snap["unreachable"] or len(snap["daemons"]) < len(cl.osds):
        raise AssertionError(f"phase 14: telemetry snapshot exit {rc}, "
                             f"unreachable {snap.get('unreachable')}")
    rc, text = _cli(telemetry.main, ["--asok-dir", cl.asok_dir, "prom"])
    out["prom_samples"] = check_exposition(text)
    if rc != 0 or out["prom_samples"] < 1:
        raise AssertionError(f"phase 14: telemetry prom exit {rc}")
    rc, text = _cli(telemetry.main, ["--asok-dir", cl.asok_dir, "latency",
                                     "--json"])
    if rc != 0:
        raise AssertionError(f"phase 14: telemetry latency exit {rc}")
    out["cluster_latency"] = stage_split(json.loads(text))
    out["daemons"] = len(snap["daemons"])
    out["phase_s"] = time.perf_counter() - t_phase
    log("cluster_stages: " + json.dumps({"card": card, "pools": {
        f"{pid}:{CLUSTER_EC[i][1]}": stages[pid]
        for i, pid in enumerate(ec_pids)},
        "all_traces": out["cluster_latency"]}))
    return out


# -- phase 15: the failure drills ----------------------------------------
DRILL_SEED = 8        # the thrasher CLI's default --seed
DRILL_SOAK_S = 20.0   # and its default --duration (5 OSDs, 1 mon)
DRILL_CLI_TIMEOUT = 900   # seconds a drill's subprocess may take


class K2Tap:
    """Replaces ``pipeline.crush_rule_batched`` (through which
    ``PoolMapper.map_all`` launches K2) while open: every launch's rows
    and lengths are held to ``map_batch_plain`` on the same inputs, on
    the same device, and every ``map_all`` call is counted.  The real
    wrapper counts its own launches; the plain version counts none.  The
    mgr's thread calls, so a mismatch is recorded (``bad``), not
    raised.  Each launch also counts its bucket draws, whose bound
    (``k2_bound_ms``) adds to ``bound_ms``."""

    def __enter__(self):
        import threading

        import torch

        from ceph_tpu_torch.crush import mapper
        from ceph_tpu_torch.osdmap import pipeline

        self.calls = self.maps = 0
        self.bound_ms = 0.0
        self.bad = []
        self._lock = threading.Lock()
        self.mod, self.real = pipeline, pipeline.crush_rule_batched
        self.real_map_all = pipeline.PoolMapper.map_all
        real, real_map_all = self.real, self.real_map_all
        plain = mapper.map_batch_plain

        def tap(arrays, prog, weight, xs, draws=None):
            if draws is None and xs.device.type == "cuda":
                draws = torch.zeros((xs.numel(), 5), dtype=torch.int32,
                                    device=xs.device)
            res, lens = real(arrays, prog, weight, xs, draws)
            want = plain(arrays, prog, weight, xs)
            err = max(max_abs_err(res, want[0]), max_abs_err(lens, want[1]))
            bound = k2_bound_ms(arrays, prog, xs.numel(), weight,
                                draws)[0] if draws is not None else 0.0
            with self._lock:
                self.calls += 1
                self.bound_ms += bound
                if err:
                    self.bad.append((tuple(res.shape), err))
            return res, lens

        def map_all(pm, *a, **kw):
            with self._lock:
                self.maps += 1
            return real_map_all(pm, *a, **kw)

        self.mod.crush_rule_batched = tap
        self.mod.PoolMapper.map_all = map_all
        return self

    def __exit__(self, *exc):
        self.mod.crush_rule_batched = self.real
        self.mod.PoolMapper.map_all = self.real_map_all
        return False


def _drill_tapped(label, run):
    """``run()`` (one drill, in this process) with every launch count at
    0 and every K1 and K2 launch held to its plain version; asserts K1's
    launches equal the EC engine's calls (none on K3's route) and K2's
    the ``map_all`` calls.  Returns (record, seconds, (K1, K2)
    launches, (K1, K2) launches held, (K1, K2) bound ms of all the
    launches)."""
    set_launch_counts((0, 0, 0))
    t0 = time.perf_counter()
    with EngineTally() as tally, SampledTap(every=1) as k1tap, \
            K2Tap() as k2tap:
        rec = run()
    took = time.perf_counter() - t0
    k1, k2, k3 = launch_counts()
    calls = tally.get("k1", "encode") + tally.get("k1", "decode")
    routed = tally.get("k3", "encode") + tally.get("k3", "decode")
    if k1 != calls or k1 != k1tap.calls or k3 or routed:
        raise AssertionError(f"phase 15: {label} launches (K1, K2, K3) "
                             f"{(k1, k2, k3)}, EC engine calls {calls} on "
                             f"K1's route and {routed} on K3's, tapped "
                             f"{k1tap.calls}")
    if k2 != k2tap.maps or k2 != k2tap.calls:
        raise AssertionError(f"phase 15: {label} launched K2 {k2} times "
                             f"for {k2tap.maps} map_all calls (tapped "
                             f"{k2tap.calls})")
    if k1tap.bad or k1tap.checked != k1 or k2tap.bad:
        raise AssertionError(f"phase 15: {label}: K1 differs from its "
                             f"plain version on {k1tap.bad[:4]} "
                             f"({k1tap.checked} of {k1} held), K2 on "
                             f"{k2tap.bad[:4]}")
    return rec, took, (k1, k2), (k1tap.checked, k2tap.calls), \
        (k1tap.nbytes / HBM_BYTES_PER_S * 1e3, k2tap.bound_ms)


def _require(label, verdicts, rec):
    failed = [name for name, held in verdicts.items() if not held]
    if failed:
        raise AssertionError(f"phase 15: {label}: {failed} did not hold: "
                             f"{json.dumps(rec)[:3000]}")


def _gate(value, held):
    """A speed or overhead gate of a record: a measurement, printed
    with its verdict."""
    return {"value": value, "met": bool(held)}


def _drill_clis(flags, device):
    """``python -m ceph_tpu_torch.tools.thrasher <flag> --device
    <device>`` from the repository root (its checkers read their
    switches at import) for each (flag, series) of ``flags``, all started
    together; returns {flag: (record, seconds)}.  Every process is
    stopped before it returns, with the overhead probes each drill
    starts (each drill leads a process group of its own)."""
    from ceph_tpu_torch.tools import thrasher

    os.makedirs(thrasher.OUT_DIR, exist_ok=True)
    n = thrasher.next_run_number(REPO)
    runs = {}
    try:
        for flag, series in flags:
            out = os.path.join(thrasher.OUT_DIR, f"{series}_r{n:02d}.json")
            argv = [sys.executable, "-m", "ceph_tpu_torch.tools.thrasher",
                    flag, "--seed", str(DRILL_SEED), "--device", device,
                    "--out", out]
            runs[flag] = (subprocess.Popen(
                argv, cwd=REPO, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True, start_new_session=True),
                out, time.perf_counter())
        done = {}
        for flag, (proc, out, t0) in runs.items():
            stdout, stderr = proc.communicate(timeout=DRILL_CLI_TIMEOUT)
            took = time.perf_counter() - t0
            summary = (stdout.strip().splitlines() or [""])[-1]
            log(f"drill {flag}: exit {proc.returncode} in {took:.1f} s: "
                f"{summary}")
            if proc.returncode not in (0, 1) or not os.path.exists(out):
                raise AssertionError(f"phase 15: thrasher {flag} exit "
                                     f"{proc.returncode}: {stderr[-2000:]}")
            with open(out) as f:
                rec = json.load(f)
            if (proc.returncode == 0) != bool(rec["ok"]):
                raise AssertionError(f"phase 15: thrasher {flag} exit "
                                     f"{proc.returncode} with ok "
                                     f"{rec['ok']}")
            done[flag] = (rec, took)
        return done
    finally:
        import signal

        for proc, _out, _t0 in runs.values():
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()


def phase_drills(dev, card, device="cuda", soak_s=DRILL_SOAK_S):
    """Phase 15: every drill of ``ceph_tpu_torch/tools/thrasher.py`` on
    the card, at the reference CLI's defaults (seed 8).  In this process,
    each with every launch count at 0 and every K1 and K2 launch held to
    its plain version (``_drill_tapped``): (a) the chaos soak (5 OSDs, 1
    mon, ``soak_s`` s; a replicated pool and jerasure reed_sol_van 2+1 on
    K1, the active balancer's sweeps on K2); (b) ``drill``: the
    whole-host kill at pipeline depths 1 and 3, then the degraded-read
    soak on a 2+2 pool; (c) ``netsplit`` and ``slow_ops_drill``.  Then
    (d) ``--loop-stall`` and ``--race-audit`` as subprocesses of the CLI,
    both at once (each times its checker's overhead against its own
    unarmed probes).  Every durability and correctness verdict is asserted; the speed and
    overhead gates are measurements, printed with their verdicts.
    Returns (record, (K1, K2) launches)."""
    from ceph_tpu_torch.tools import thrasher

    t_phase = time.perf_counter()
    seconds, launches, held, bounds, oks = {}, {}, {}, {}, {}

    def tapped(label, run):
        rec, seconds[label], launches[label], held[label], bounds[label] = \
            _drill_tapped(label, run)
        oks[label] = rec["ok"]
        return rec

    # (a) the chaos soak
    chaos = tapped("chaos", lambda: thrasher.soak(
        seed=DRILL_SEED, duration=soak_s, n_osds=5, n_mons=1,
        device=device))
    _require("chaos", {
        "lost == 0": chaos.get("lost") == 0,
        "converged": chaos.get("health_converge_s") is not None,
        "unfired_armed == []": chaos["unfired_armed"] == [],
        "lockdep_violations == 0": chaos["lockdep_violations"] == 0,
        "span_leaks == 0": chaos["span_leaks"] == 0,
        "balancer_degraded_proposals == 0":
            chaos.get("balancer_degraded_proposals") == 0,
        "K1 launched": launches["chaos"][0] >= 1,
        "K2 launched": launches["chaos"][1] >= 1}, chaos)
    log("drill: " + json.dumps({
        "card": card, "kind": "chaos", "seconds": seconds["chaos"],
        "launches": dict(zip(("k1", "k2"), launches["chaos"])),
        "held": dict(zip(("k1", "k2"), held["chaos"])), **chaos}))

    # (b) the whole-host kill at depths 1 and 3, then the degraded reads
    rec = tapped("host_kill", lambda: thrasher.drill(seed=DRILL_SEED,
                                                     device=device))
    serial, piped, soak = rec["serial"], rec["pipelined"], rec["soak"]
    _require("host_kill", {
        "lost == 0 (depth 1)": serial.get("lost", 1) == 0,
        "lost == 0 (depth 3)": piped.get("lost", 1) == 0,
        "converge_s (depth 1)": serial.get("converge_s") is not None,
        "converge_s (depth 3)": piped.get("converge_s") is not None,
        "read_errors == 0": soak.get("read_errors") == 0,
        "the soak converged": "error" not in soak,
        "K1 launched": launches["host_kill"][0] >= 1}, rec)
    speedup = rec.get("pipeline_speedup")
    log("drill: " + json.dumps({
        "card": card, "kind": "drill", "seconds": seconds["host_kill"],
        "launches": dict(zip(("k1", "k2"), launches["host_kill"])),
        "held": dict(zip(("k1", "k2"), held["host_kill"])),
        "recovery_mbps_serial": rec.get("recovery_mbps_serial"),
        "recovery_mbps": rec.get("recovery_mbps"),
        "pipeline_speedup": _gate(speedup, (speedup or 0) > 1.5),
        "detect_s": [serial.get("detect_s"), piped.get("detect_s")],
        "recover_s": [serial.get("recover_s"), piped.get("recover_s")],
        "converge_s": [serial.get("converge_s"), piped.get("converge_s")],
        "recovery_counters": [serial.get("recovery_counters"),
                              piped.get("recovery_counters")],
        "read_p50_ms": soak.get("p50_ms"), "read_p99_ms": soak.get("p99_ms"),
        "reads": soak.get("reads"), "slo": soak.get("slo"),
        "ok": rec["ok"], "record": rec}))

    # (c) the netsplits and the SLO escalation
    ns = tapped("netsplit", lambda: thrasher.netsplit(seed=DRILL_SEED,
                                                      device=device))
    flap, iso = ns["flap"], ns["isolation"]
    _require("netsplit", {
        "lost == 0": ns["lost"] == 0,
        "false_markdowns == 0": ns["false_markdowns"] == 0,
        "OSD_FLAPPING raised": flap.get("flapping_raised") is True,
        "OSD_FLAPPING cleared": flap.get("flapping_cleared") is True}, ns)
    detect = ns.get("detect_s")
    log("drill: " + json.dumps({
        "card": card, "kind": "netsplit", "seconds": seconds["netsplit"],
        "launches": dict(zip(("k1", "k2"), launches["netsplit"])),
        "detect_s": _gate(detect, detect is not None
                          and detect <= iso["detect_bound_s"]),
        "detect_bound_s": iso["detect_bound_s"],
        "epoch_churn": ns.get("epoch_churn"),
        "epoch_churn_dampened_tail": flap.get("epoch_churn_dampened_tail"),
        "phases_ok": {k: ns[k].get("ok")
                      for k in ("mon_partition", "isolation", "flap")},
        "ok": ns["ok"], "record": ns}))
    slow = tapped("slow_ops", lambda: thrasher.slow_ops_drill(
        seed=DRILL_SEED, device=device))
    _require("slow_ops", {"lost == 0": slow["lost"] == 0,
                          "cleared to HEALTH_OK": slow["cleared"] is True},
             slow)
    log("drill: " + json.dumps({
        "card": card, "kind": "slowops", "seconds": seconds["slow_ops"],
        "launches": dict(zip(("k1", "k2"), launches["slow_ops"])),
        "raise_s": slow.get("raise_s"), "clear_s": slow.get("clear_s"),
        "victim_stall_s": slow.get("victim_stall_s"),
        "healthy_stall_s": slow.get("healthy_stall_s"),
        "ok": slow["ok"], "record": slow}))

    # (d) the checkers' drills, each in a process of its own, both at once
    clis = _drill_clis((("--loop-stall", "ASYNC"), ("--race-audit", "RACE")),
                       device)
    stall, seconds["loop_stall"] = clis["--loop-stall"]
    oks["loop_stall"] = stall["ok"]
    _require("loop_stall", {
        "static_violations == 0": stall["static_violations"] == 0,
        "victim_named": stall["victim_named"] is True,
        "stall_witnessed": stall["stall_witnessed"] is True,
        "both_stacks": stall["both_stacks"] is True,
        "lost == 0": stall["lost"] == 0,
        "cleared": stall["cleared"] is True}, stall)
    pct = stall.get("overhead_pct")
    log("drill: " + json.dumps({
        "card": card, "kind": "async", "seconds": seconds["loop_stall"],
        "overhead_pct": _gate(pct, pct is not None and pct < 5.0),
        "raise_s": stall.get("raise_s"), "clear_s": stall.get("clear_s"),
        "ok": stall["ok"], "record": stall}))
    race, seconds["race_audit"] = clis["--race-audit"]
    oks["race_audit"] = race["ok"]
    _require("race_audit", {"violations == 0": race["violations"] == 0,
                            "lost == 0": race["lost"] == 0}, race)
    pct = race.get("overhead_pct")
    log("drill: " + json.dumps({
        "card": card, "kind": "race", "seconds": seconds["race_audit"],
        "overhead_pct": _gate(pct, pct is not None and pct < 10.0),
        "phases_ok": {k: v["ok"] for k, v in race["phases"].items()},
        "ok": race["ok"], "record": race}))

    k1 = sum(n[0] for n in launches.values())
    k2 = sum(n[1] for n in launches.values())
    # the least time a launch could take, on average over the phase's
    # launches (bytes for K1; K2's from its counted draws)
    per_launch = {
        name: sum(b[i] for b in bounds.values()) / n if n else None
        for i, (name, n) in enumerate((("k1", k1), ("k2", k2)))}
    out = {"card": card, "phase_s": time.perf_counter() - t_phase,
           "bound_ms_per_launch": per_launch,
           "seconds": seconds, "ok": oks,
           "launches": {"k1": k1, "k2": k2,
                        "by_drill": {d: dict(zip(("k1", "k2"), n))
                                     for d, n in launches.items()}},
           "held": {"k1": sum(n[0] for n in held.values()),
                    "k2": sum(n[1] for n in held.values())}}
    return out, (k1, k2)


def main():
    import tempfile

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from ceph_tpu_torch import build
    from ceph_tpu_torch.crush import mapper
    from ceph_tpu_torch.ec import gf2_kernels

    card = gpu_name_and_limit()
    log(f"gpu: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda}")
    dev = torch.device("cuda")

    t0 = time.perf_counter()
    took = build.build(verbose=True)
    log(f"build: {time.perf_counter() - t0:.1f} s "
        + json.dumps({k: round(v, 1) for k, v in took.items()}))
    log_k1_sass()

    # the scalar oracles (mapper_ref, pg_to_up_acting_osds) run in worker
    # processes beside the card's work
    workers = max(1, min(7, (os.cpu_count() or 2) - 1))
    pool = concurrent.futures.ProcessPoolExecutor(
        max_workers=workers, mp_context=multiprocessing.get_context("spawn"))
    try:
        k1 = phase_k1(dev)
        k2 = phase_k2(dev, pool)

        # the main paths, each with every launch count at 0 before it
        gf2_kernels.gf2_matmul_w8.launches = 0
        mapper.crush_rule_batched.launches = 0
        flag = phase_flagship(dev)
        k1["launches"] = gf2_kernels.gf2_matmul_w8.launches
        k2["launches"] = mapper.crush_rule_batched.launches
        gf2_kernels.gf2_matmul_w8.launches = 0
        mapper.crush_rule_batched.launches = 0
        pipe, pipe_launches, big_map, big_mappers = phase_pipeline(dev,
                                                                   pool)
        if pipe_launches < 1:
            raise AssertionError("crush_rule_batched was not launched on "
                                 "the pipeline path")
        k2["launches"] += pipe_launches

        # the balancer: one K2 launch a map_all call, asserted
        mapper.crush_rule_batched.launches = 0
        offline, calls_a, against_cpu = phase_balancer_offline(dev, pool)
        against_cpu()  # 6b's host times are taken without the CPU run
        big, calls_b = phase_balancer_big(dev, pool, big_map, big_mappers)
        bal_launches = mapper.crush_rule_batched.launches
        if bal_launches != calls_a + calls_b or bal_launches < 1:
            raise AssertionError(f"{calls_a + calls_b} map_all calls of the "
                                 f"balancer launched K2 {bal_launches} "
                                 f"times")
        k2["launches"] += bal_launches

        # crushtool: one K2 launch a sweep on the card, asserted
        mapper.crush_rule_batched.launches = 0
        with tempfile.TemporaryDirectory() as workdir:
            tool, sweeps = phase_crushtool(dev, workdir, card)
        tool_launches = mapper.crush_rule_batched.launches
        if tool_launches != sweeps or tool_launches < 1:
            raise AssertionError(f"{sweeps} card sweeps of crushtool "
                                 f"launched K2 {tool_launches} times")
        tool["k2_launches"] = tool_launches
        k2["launches"] += tool_launches

        # the EC plugins: K1's count at 0 before their main path, K2's
        # before their rules
        with tempfile.TemporaryDirectory() as workdir:
            ec, ec_k1, ec_k2 = phase_ec_plugins(dev, workdir, card)
        k1["launches"] += ec_k1
        k2["launches"] += ec_k2
        ec["k1_launches"], ec["k2_launches"] = ec_k1, ec_k2

        # the w=16/32 and packet layouts: K1's and K3's counts at 0
        # before their main path; the speculative mapper: K2's before
        # the cross-check
        with tempfile.TemporaryDirectory() as workdir:
            lay, lay_k1, lay_k3, k3 = phase_layouts(dev, workdir, card)
        k1["launches"] += lay_k1
        lay["k1_launches"], lay["k3_launches"] = lay_k1, lay_k3
        spec, spec_k2 = phase_spec(dev)
        k2["launches"] += spec_k2

        # the mesh data plane: every count at 0 before it
        set_launch_counts((0, 0, 0))
        mesh = phase_mesh(dev, card, big_map)
        mesh["launches"] = dict(zip(("k1", "k2", "k3"), launch_counts()))
        for k, n in zip((k1, k2, k3), launch_counts()):
            k["launches"] += n

        # map epochs and the stores: every count at 0 before them
        set_launch_counts((0, 0, 0))
        epochs, epoch_calls = phase_epochs(dev, pool, big_map)
        if launch_counts() != (0, epoch_calls, 0) or epoch_calls < 1:
            raise AssertionError(f"phase 11: launches (K1, K2, K3) "
                                 f"{launch_counts()}, expected (0, "
                                 f"{epoch_calls}, 0)")
        epochs["k2_launches"] = epoch_calls
        k2["launches"] += epoch_calls

        # client EC writes over the messenger: every count at 0 before
        # each run, K1's and K3's launches asserted against the batcher
        with tempfile.TemporaryDirectory() as admin_dir:
            wire, wire_k1, wire_k3 = phase_wire(dev, admin_dir, card)
        wire["launches"] = {"k1": wire_k1, "k3": wire_k3}
        k1["launches"] += wire_k1
        k3["launches"] += wire_k3

        # rados bench's CLI on its own cluster, before phase 13's is up
        # (the profiler's bursts sample every thread of the process):
        # every count at 0 before each run, K1's launches asserted
        # against the EC engine's calls, every 8th against the plain
        # version
        bench, bench_k1 = phase_rados_bench(dev, card)
        k1["launches"] += bench_k1

        # a live cluster: every count at 0 before it, K1's and K3's
        # launches asserted against the EC engine's calls, K2's against
        # the balancer's map_all calls; phase 14's tools run on it before
        # its shutdown, their counts at 0 before them
        def tools(cl, clis, profiles, expected):
            return phase_tools(cl, clis, profiles, expected, pool, card)

        set_launch_counts((0, 0, 0))
        cluster, (cl_k1, cl_k2, cl_k3) = phase_cluster(dev, card, pool,
                                                       tools=tools)
        cluster["launches"].update(k2=cl_k2)
        for k, n in zip((k1, k2, k3), (cl_k1, cl_k2, cl_k3)):
            k["launches"] += n
        live = cluster.pop("tools")
    finally:
        pool.shutdown(wait=True, cancel_futures=True)

    # the failure drills: every count at 0 before each, K1's launches
    # asserted against the EC engine's calls and K2's against the
    # balancer's map_all calls, every launch held to its plain version
    drills, (dr_k1, dr_k2) = phase_drills(dev, card)
    k1["launches"] += dr_k1
    k2["launches"] += dr_k2
    for k in (k1, k2, k3):
        if k["launches"] < 1:
            raise AssertionError(f"{k['name']} was not launched on the "
                                 f"main path")
        log(f"kernel {k['name']}: kernel_ms={k['ms']:.4f} "
            f"plain_ms={k['plain_ms']:.3f} bound_ms={k['bound_ms']:.4f} "
            f"({k['bound_by']}) launches={k['launches']} at {k['shape']}")
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "graph_ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms")
    log(json.dumps({"kernels": [{key: k[key] for key in keys}
                                for k in (k1, k2, k3)]}))
    log("k2_variants: " + json.dumps({"card": card,
                                       "variants": k2["variants"]}))
    log("flagship: " + json.dumps({"card": card, **flag}))
    log("pipeline: " + json.dumps({"card": card, "pools": pipe}))
    log("balancer: " + json.dumps({"card": card, "offline": offline,
                                    "big10k": big,
                                    "k2_launches": bal_launches}))
    log("crushtool: " + json.dumps(tool))
    log("ec_plugins_phase: " + json.dumps(
        {key: ec[key] for key in ("card", "native_threads", "phase_s",
                                  "k1_launches", "k2_launches")}))
    log("layouts_phase: " + json.dumps(
        {key: lay[key] for key in ("card", "phase_s", "k1_launches",
                                   "k3_launches")}))
    log("mesh_phase: " + json.dumps(
        {key: mesh[key] for key in ("card", "phase_s", "launches")}))
    log("epochs_phase: " + json.dumps({"card": card, **epochs}))
    log("wire_phase: " + json.dumps(
        {key: wire[key] for key in ("card", "phase_s", "launches", "asok")}))
    log("cluster_phase: " + json.dumps(cluster))
    log("tools_phase: " + json.dumps({
        "card": card, "phase_s": bench["phase_s"] + live["phase_s"],
        "rados_bench_s": bench["phase_s"], "live_s": live["phase_s"],
        "launches": {"k1": bench_k1 + live["launches"]["k1"],
                     "k3": live["launches"]["k3"]}, "live": live}))
    log("drills_phase: " + json.dumps(drills))
    log(f"gpu: {card}")
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
