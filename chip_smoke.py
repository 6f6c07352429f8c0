#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`cozo_tpu_torch`) on one card.

    python3 chip_smoke.py            # full size: 1,183,514 x 100 cosine

Phases, each reported on its own line; any failure exits non-zero:
  1. build every kernel under cozo_tpu_torch/csrc/ (one nvcc per source,
     all started together) and print the build seconds and what ptxas
     says of registers, spills and shared memory;
  2. hold every kernel against its plain PyTorch version on the card.
     `fused_sweep`: every route at small shapes that reach each route and
     edge (B = 1, a ragged last query tile, one segment, an odd number of
     segments, d_pad 16 / 48 / 64 / 128 / 144 / 256 / 768, an all-dead
     segment): the ids carried in the packed output agree on >= 99.9% of
     entries, no dead row is live, two runs of a shape are bit-identical.
     `beam_search`: small built indexes covering L2 / IP / Cosine, B = 1,
     a flat index, d not a multiple of 4, d = 768, removed rows, beam 8,
     64, 200 (the build's k = ef) and 2048, one and sixteen entries
     expanded a round, neighbour lists 128 wide (more candidates nearer
     than the beam's last than the kernel places by counting: its sorted
     merge), many duplicate rows:
     ids equal on >= 99% of (query, rank) entries, distances within 1e-4
     where ids match, no dead row returned, two runs identical.
     The graph kernels: `graph_pagerank` (dangling and isolated nodes,
     padding edges, 0 steps, nodes without in-edges, every node dangling
     but one, a hub of 600 in-edges; L1 <= 1e-5, the same top 100, and
     the same bits from a build with bins of 1,024 nodes),
     `graph_sssp` (a hub past 1,024 in-edges, 1 to 9 sources in one and
     two groups, `max_iters` cuts at 1, 2 and 3 steps, uniform, dyadic,
     random and negative weights; the wrapper's route share and every
     step pushed or pulled; distances, parents and steps equal),
     `graph_labelprop` (rows 8 to 8,192 wide, dense layout and lanes, 64
     labels, all distinct, three or one, a row of padding, a row without
     a valid slot, a planted tie, negative weights; labels equal), two
     runs of each bit-identical.  `minhash`: empty docs first, inside and last,
     one doc, a single-token doc, a 100,000-token doc (past one
     shared-memory tile), D = 1,024, n_perm 1, 32, 100, 128 and 256,
     hashes 0, all ones and the top bit alone or cleared: signatures
     bit-equal to the plain version and to the host `minhash_segments`,
     two runs bit-identical;
  5. (run before phase 3) drive the Db through CozoScript, the script of
     `benches/bench_hybrid_1m.py` phases 1-4 at full size: `glove_like`
     data (seed 42), `Db("mem")` on the card, ingest by `:put` batches of
     50,000 ndarray rows, `::hnsw create` (the DDL's device bulk build,
     written as the packed KV image), the vector-pivot join of 4,096
     stored queries (cold, warm, after the index cache is rebuilt from KV;
     recall@10 >= 0.999 against the exact f32 lane), the small join
     (B = 16, the beam-search kernel; ids equal to `HnswIndex.search`
     called directly), the 2-hop (its second hop through the kernel), 8
     threads of small joins against the sequential answers, then `:put`
     and `:rm` through the Db (the mirror updated in place); prints a
     `db` JSON line;
  6. (run before phase 3) the graph rules through that Db over the
     index's level-0 graph, read straight from the index relation
     (`bench_hybrid_1m.py` phase 5 without its `:put prox`): PageRank
     and LabelPropagation (undirected) held to the plain versions on the
     same CSR, ShortestPathDijkstra from 4 stored starts to 64 stored
     goals held to a host BFS; each cold and warm; prints a `graph` line;
  3. drive the index's main path through the user entry points on the
     index phase 5 built (the same data, `bulk_build(wave=8192)`): then
     `sweep_search` with the f32 lane as ground truth and the fused,
     bf16+rerank, raw bf16 and i8+rerank lanes at B=16,384 (one warm call
     and `--reps` timed reps for the fused lane, 3 for the others),
     holding each lane's recall@10 to its bar; then `HnswIndex.search`
     alone: the quant lane (the f32 budget lowered for that call), small
     batches (B = 16, 1, 4, 63) through the beam-search kernel with
     recall beside the host search's, latency per call beside the
     kernel's own time, and the device mirror's incremental update after
     inserts and removals.  Each
     kernel's launch count is zeroed just before its path and read just
     after;
  3b. the quant lane at its own width: a 768-wide cosine table of
     2,097,152 rows (cut from the JAX package's 10M-row configuration),
     `QuantSweepTable.load` + `quant_search`, recall against
     `brute_force_knn`;
  3c. the int8 build: 262,144 x 100 rows with the budget lowered, against
     the f32 build of the same rows;
  7. the shapes of `benches/graph_scale_bench.py` through the entry
     points: PageRank and SSSP at 4,928,571 nodes / 69M edges,
     LabelPropagation on the 50M-edge hub graph, each cold and warm and
     held to the plain versions; prints a `scale` line;
  8. the text indexes: `benches/bench_lsh_1m.py` through `Db("mem")`,
     nothing cut (1,000,000 docs, 1,000 planted near-duplicates; ingest by
     `:put` batches of 50,000, `::lsh create` with 128 permutations at
     threshold 0.7, whose backfill runs the `minhash` kernel once a chunk
     of 32,768 docs, the serving image, 200 single queries and the
     1,000-query batched join, each planted-duplicate recall >= 0.95, no
     serving-image fallback); the stored signatures of every doc held to
     the host `minhash_segments`; then `::fts create` on 50,000 of the
     docs and 10 single-term searches, each equal to a scan; prints an
     `lsh` line;
  4. time each kernel at its shape (the main-path shape for the routes the
     main path takes; the graph kernels at phase 7's, `minhash` at phase
     8's first backfill chunk, with a chunk's upload and copy back) with
     CUDA events, beside its bound and its plain version, and the fused
     routes and PageRank beside a one-call PyTorch yardstick (for
     PageRank one cuSPARSE SpMV a step, also on phase 6's graph, after a
     line on its binned layout: bins, bytes, slices, build ms and
     transient memory); besides,
     the label pick at every lane of phases 6 and 7 at random and at
     converged labels (replayed from a CUDA graph: no host time between
     launches) and SSSP with 4 sources on phase 6's graph, each solve
     with a line of its steps (frontier, route, device ms under the
     rule, pushed and pulled, from `torch.profiler`);
  5. print the kernels' JSON line, the card's name and power limit, and
     as the last line {"ok": true, "device": {...}}.

`--kernels-only` skips phases 3-3c, times the fused main-path route on a
random table of the main-path shape and `beam_search` (kernel and call) on
a built index of 262,144 rows: a quick check of the kernels alone, which
prints no `{"ok": ...}` line.  `--graph-only` runs phases 1, 2 (the graph
kernels), 5 on a Db of `--n` rows, 6, 7 and the graph kernels' timings,
and prints no `{"ok": ...}` line either; `--lsh-only` runs phases 1, 2
(`minhash`), 8 and the `minhash` timing, and prints none either.
"""

import argparse
import itertools
import json
import os
import subprocess
import sys
import time
import warnings
from concurrent.futures import ThreadPoolExecutor

import numpy as np

N, D, NQ, K = 1_183_514, 100, 16_384, 10
MIN_N = 262_144  # more than one 131,072-row chunk
PEAK_BF16 = 989e12  # H100 SXM dense bf16 FLOP/s
PEAK_BYTES = 3.35e12  # H100 SXM HBM3 bytes/s
PEAK_F32 = 67e12  # H100 SXM f32 FLOP/s outside the tensor cores
BARS = {"fused+rerank": 0.999, "bf16+rerank": 0.999, "bf16-raw": 0.962,
        "i8+rerank": 0.998, "quant": 0.98}
OTHER_LANE_REPS = 3  # timed reps of the lanes beside the fused one
QUANT_N, QUANT_D, QUANT_NQ, QUANT_GT = 2_097_152, 768, 4096, 1024
I8_BUILD_N = 262_144


def say(msg):
    print(msg, flush=True)


def smi_line():
    """The card's name and power limit as nvidia-smi prints them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return smi.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps):
    """Mean device milliseconds of `fn()` over `reps` launches after one
    warm call (CUDA events around the whole run)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def graph_ms(fn, reps):
    """Mean device milliseconds of `fn()` over `reps` calls captured in one
    CUDA graph and replayed after a warm replay: no host work between the
    launches, so a kernel shorter than its call's host overhead is timed,
    not the host."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    graph.replay()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def kernel_times(fn, first):
    """[(kernel name, device ms)] of the kernels one call of `fn()` runs, in
    launch order, from `torch.profiler` (CUPTI): the second of two calls
    profiled after a warm one, from its kernel named `first` (the profiler
    may miss the first kernels it traces)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    evs.sort(key=lambda e: e.time_range.start)
    starts = [i for i, e in enumerate(evs) if first in e.name]
    return [(e.name, e.time_range.elapsed_us() / 1e3)
            for e in evs[starts[-1] if starts else len(evs):]]


def phase_build():
    from cozo_tpu_torch.ops import _build

    names = sorted(f[:-3] for f in os.listdir(_build.CSRC) if f.endswith(".cu"))
    # and the PageRank build at phase 2's second bin size
    builds = [(name, ()) for name in names] + [("graph_pagerank",
                                                PR_BIN_SIZE_2)]
    t0 = time.time()
    with ThreadPoolExecutor(len(builds)) as ex:
        list(ex.map(lambda b: _build.build(*b), builds))
    say(f"phase 1 build: {len(names)} kernel(s) {names} and graph_pagerank "
        f"{PR_BIN_SIZE_2} in {time.time() - t0:.1f}s")
    for name, (secs, log) in sorted(_build.BUILD_INFO.items()):
        for line in log.splitlines():
            if "Used" in line or "spill" in line:
                say(f"  ptxas {name}: {line.strip()}")
            elif "Potential Performance Loss" in line:
                # e.g. asynchronous products serialised: slow, not wrong
                say(f"  ptxas {name} WARNING: {line.strip()[:200]}")


def compare_fused(out_k, out_p, n_total, dead):
    """Agreement of the kernel's packed output with the plain version's:
    shares of entries that are bit-equal, close (1e-6) and carry the same
    id; live entries that name a dead row; the largest difference."""
    import torch

    from cozo_tpu_torch.ops import fused_sweep as fs

    exact = (out_k == out_p).float().mean()
    close = torch.isclose(out_k, out_p, rtol=1e-6, atol=1e-6).float().mean()
    seg_base = (torch.arange(out_k.shape[1], device=out_k.device) >> 1) * fs.SEG

    def ids(o):
        return seg_base[None, :] + (o.view(torch.int32) & (fs.SEG - 1))

    ik = ids(out_k)
    same_ids = (ik == ids(out_p)).float().mean()
    live = out_k > fs.NEG_FILL * 0.5
    dead_hits = int(((ik >= n_total - dead) & live).sum()) if dead else 0
    err = float((out_k - out_p).abs().max())
    return {"exact": float(exact), "isclose": float(close),
            "ids": float(same_ids), "dead_hits": dead_hits, "err": err}


def agreement_ok(c):
    return c["ids"] >= 0.999 and c["dead_hits"] == 0


def say_agreement(head, c):
    say(f"{head}: exact {c['exact']:.6f} isclose(1e-6) {c['isclose']:.6f} "
        f"ids {c['ids']:.6f} dead_hits {c['dead_hits']} "
        f"max_abs_err {c['err']:.3e}")


# (B, n_total, d_pad, dead rows at the table's end): every route and edge
PHASE2_SHAPES = (
    (512, 16_384, 128, 100),
    (1, 256, 128, 0),          # B = 1, one segment, a grid of one block
    (77, 1_280, 128, 3),       # ragged query tile, odd number of segments
    (200, 4_096, 16, 0),       # d_pad below the 64-wide box (zero fill)
    (77, 4_096, 48, 0),
    (130, 2_048, 64, 300),     # last segment all dead
    (300, 1_280, 256, 0),      # kloop, odd number of segments
    (64, 512, 144, 260),       # kloop, d_pad not a multiple of 64, dead segment
    (1, 256, 768, 0),
    (700, 131_072, 768, 3),
)


def random_case(B, n_total, d_pad, dead, dev, seed=0):
    import torch

    from cozo_tpu_torch.ops import fused_sweep as fs

    g = torch.Generator(device=dev).manual_seed(seed)
    tbl = torch.randn(n_total, d_pad, generator=g, device=dev)
    tbl = tbl.to(torch.bfloat16)
    qs = torch.randn(B, d_pad, generator=g, device=dev).to(torch.bfloat16)
    bias = torch.zeros(n_total, device=dev)
    if dead:
        bias[n_total - dead:] = fs.NEG_FILL
    return qs, tbl, bias


def phase_kernel_vs_plain(dev):
    import torch

    from cozo_tpu_torch.ops import fused_sweep as fs

    reached = set()
    for B, n_total, d_pad, dead in PHASE2_SHAPES:
        qs, tbl, bias = random_case(B, n_total, d_pad, dead, dev)
        route = fs.route(B, n_total, d_pad)
        before = fs.fused_sweep.route_launches[route]
        out_k = fs.fused_sweep(qs, tbl, bias)
        out_again = fs.fused_sweep(qs, tbl, bias)
        out_p = fs.fused_sweep_plain(qs, tbl, bias)
        torch.cuda.synchronize()
        counted = fs.fused_sweep.route_launches[route] - before
        same_twice = bool(torch.equal(out_k, out_again))
        c = compare_fused(out_k, out_p, n_total, dead)
        say_agreement(f"phase 2 fused_sweep[{route}] vs plain B={B} "
                      f"n_total={n_total} d_pad={d_pad} dead={dead} "
                      f"two runs identical {same_twice}", c)
        if not (agreement_ok(c) and same_twice and counted == 2):
            raise SystemExit("phase 2 failed: kernel disagrees with plain")
        reached.add(route)
    if reached != set(fs.ROUTES):
        raise SystemExit(f"phase 2 failed: routes reached {sorted(reached)}")


# (distance, n, d, m, B, ef, k, flat, removed rows, expand, duplicate rows):
# every metric and edge
BEAM_CASES = (
    ("L2", 6000, 100, 16, 16, 64, 10, False, 0, 8, 0),
    ("IP", 5000, 24, 8, 1, 64, 10, False, 0, 8, 0),        # B = 1
    ("Cosine", 5000, 37, 8, 8, 64, 10, False, 60, 8, 0),   # d % 4 != 0, removals
    ("L2", 5000, 16, 8, 5, 8, 3, True, 0, 8, 0),           # flat index, beam 8
    ("Cosine", 8000, 100, 16, 63, 64, 10, False, 100, 8, 0),
    ("IP", 5000, 48, 4, 7, 8, 5, True, 25, 8, 0),
    ("Cosine", 5000, 768, 8, 3, 64, 10, False, 0, 8, 0),   # wide rows
    # beam 2048: a table of 8192 slots, shared memory past the 48 KB default
    ("IP", 5000, 32, 8, 2, 2048, 10, False, 30, 8, 0),
    # 512 candidates a round into a wide beam: more of them nearer than the
    # beam's last than are placed by counting, so the list is sorted
    ("L2", 6000, 32, 32, 4, 512, 10, False, 0, 8, 0),
    ("L2", 5000, 20, 64, 3, 64, 10, False, 0, 16, 0),      # m0 = 128, expand 16
    ("Cosine", 5000, 12, 16, 6, 64, 10, False, 0, 1, 0),   # expand 1
    ("L2", 6000, 100, 16, 4, 200, 200, False, 0, 8, 0),    # the build's k = ef
    # a third of the rows are copies: equal distances, the tie rule decides
    ("L2", 6000, 16, 8, 8, 32, 10, False, 20, 8, 2000),
)


def beam_args(index, qs_np, k, ef, expand=8):
    """The kernel's arguments as `hnsw_search_device` makes them."""
    import torch

    from cozo_tpu_torch.ops import vector_search as vs

    dev = vs._device_arrays(index)
    beam, max_iters, expand = vs.beam_params(k, ef, expand)
    q = torch.from_numpy(np.ascontiguousarray(qs_np, dtype=np.float32)).to(
        dev["vectors"].device)
    return (dev["vectors"], dev["nb0"], dev["up_nb"], dev["alive"],
            dev["entry"], q, k, beam, dev["n_levels"],
            vs.DIST_KINDS[index.distance], max_iters, expand)


def beam_case(distance, n, d, m, B, ef, k, flat, removed, expand, dup):
    """A small built index and B queries near its rows, for one entry of
    BEAM_CASES."""
    from cozo_tpu_torch import HnswIndex

    rng = np.random.default_rng(n + d + B)
    data = rng.standard_normal((n, d)).astype(np.float32)
    if dup:
        data[n - dup:] = data[rng.integers(0, n - dup, dup)]
    index = HnswIndex(dim=d, m=m, ef_construction=50, distance=distance)
    index.bulk_build(data, wave=2048)
    for s in range(0, 3 * removed, 3):
        index.remove(s)
    if flat:  # the same points without upper levels
        index.neighbors = index.neighbors[:1]
        index.levels[:n] = np.minimum(index.levels[:n], 0)
        index.version += 1
    qs = data[rng.integers(0, n, B)] + \
        0.1 * rng.standard_normal((B, d)).astype(np.float32)
    return index, qs


def compare_beam(out_k, out_p, alive):
    """Agreement of the kernel's (ids, dists) with the plain version's."""
    import torch

    ik, dk = out_k
    ip, dp = out_p
    same = ik == ip
    both = same & torch.isfinite(dk) & torch.isfinite(dp)
    err = float((dk - dp)[both].abs().max()) if bool(both.any()) else 0.0
    dead_hits = int((~alive[ik.clamp(min=0).long()] & (ik >= 0)).sum())
    return {"ids": float(same.float().mean()),
            "rows_exact": float(same.all(1).float().mean()),
            "err": err, "dead_hits": dead_hits,
            "inf_equal": bool(torch.equal(torch.isinf(dk), torch.isinf(dp)))}


def beam_ok(c):
    return (c["ids"] >= 0.99 and c["err"] <= 1e-4 and c["dead_hits"] == 0
            and c["inf_equal"])


def phase_beam_vs_plain():
    import torch

    from cozo_tpu_torch.ops import vector_search as vs

    for case in BEAM_CASES:
        distance, n, d, m, B, ef, k, flat, removed, expand, dup = case
        index, qs = beam_case(*case)
        args = beam_args(index, qs, k, ef, expand)
        before = vs.beam_search.launches
        out_k = vs.beam_search(*args)
        out_again = vs.beam_search(*args)
        stats = vs.beam_search.last_stats.sum(0).tolist()
        out_p = vs.beam_search_plain(*args)
        torch.cuda.synchronize()
        counted = vs.beam_search.launches - before
        same_twice = all(torch.equal(a, b) for a, b in zip(out_k, out_again))
        c = compare_beam(out_k, out_p, args[3])
        say(f"phase 2 beam_search vs plain {distance} n={n} d={d} m={m} "
            f"levels={args[8]} B={B} beam={args[7]} k={k} expand={expand} "
            f"removed={removed} copies={dup}: "
            f"ids {c['ids']:.6f} rows exact {c['rows_exact']:.4f} "
            f"max_abs_err {c['err']:.3e} dead_hits {c['dead_hits']} "
            f"two runs identical {same_twice} (descent steps, rounds, rows, "
            f"lists: {stats})")
        if not (beam_ok(c) and same_twice and counted == 2
                and (args[8] == 0) == flat):
            raise SystemExit("phase 2 failed: beam_search disagrees with plain")


# ------------------------------------------------------------ graph kernels

# PageRank: (nodes, edges, steps, nodes without out-edges, extra in-edges
# of node 1)
GRAPH_PR_CASES = ((300, 2500, 10, 30, 0), (97, 40, 3, 9, 0),
                  (500, 9000, 0, 50, 0),
                  (1000, 1500, 10, 0, 0),     # most nodes one in-edge or none
                  (300, 2000, 10, 296, 0),    # every node dangling but one
                  (500, 4000, 10, 20, 600),   # a hub of 600 in-edges
                  (20_000, 300_000, 10, 2_000, 0))
# the second bin size phase 2 builds `graph_pagerank` at (its own is
# graph_algos.PR_BIN_NODES): the same bits
PR_BIN_SIZE_2 = ("-DCOZO_PR_BIN_NODES=1024",)
# SSSP: (nodes, edges, hub in-degree, weights, sources, max_iters)
GRAPH_SSSP_CASES = (
    (400, 3000, 0, "dyadic", (0,), 512),
    (400, 3000, 2600, "uniform", (5, 0, 399, 7, 8, 9, 10, 11), 512),
    (400, 3000, 1100, "random", (3, 2), 512),   # a hub past ELL_CAP_MAX
    (400, 3000, 0, "random", (0, 1, 2), 2),     # cut before convergence
    (300, 200, 0, "uniform", (4,), 512),        # most nodes unreached
    (400, 3000, 1100, "dyadic", (9, 1, 2, 3, 4, 5, 6, 7, 9), 512),  # 2 groups
    (400, 3000, 0, "negative", (0, 1, 2, 3, 4, 5, 6, 7), 512),  # 1 group
    (400, 3000, 0, "dyadic", (0,), 1),          # cut after one step
    (400, 3000, 1100, "negative", (6, 6), 3),   # cut after three
    (20_000, 200_000, 3000, "random", (1, 2, 3, 4, 5, 6, 7, 8, 9), 512),
)
# the kernel's route share (csrc/graph_sssp.cu `push_share`) phase 2 and
# the host tests force besides the rule: every step a push, every one a pull
SSSP_FORCED_SHARES = {"push": 2.0, "pull": -1.0}
# label pick: row widths (<= 128: the dense layout, wider: lanes)
GRAPH_LP_WIDTHS = (8, 16, 32, 64, 128, 256, 2048, 8192)
# label pick: the labels of the neighbours (`lp_inputs`)
GRAPH_LP_LABELS = ("mixed", "distinct", "three", "one")
PR_L1_TOL = 1e-5  # PageRank kernel against plain: ranks sum to 1


def graph_csr(n, e, seed, hub=0, dangling=0):
    """A random CSR of n nodes and e edges: nodes below `dangling` have no
    out-edge, the last 3 no edge at all, node 1 `hub` extra in-edges."""
    rng = np.random.default_rng(seed)
    src = rng.integers(dangling, n - 3, e)
    dst = rng.integers(0, n - 3, e)
    if hub:
        dst[:hub] = 1
    order = np.argsort(src, kind="stable")
    src, dst = src[order], dst[order]
    indptr = np.zeros(n + 1, np.int64)
    np.add.at(indptr, src + 1, 1)
    return np.cumsum(indptr), dst


def pr_inputs(n, e, dangling, dev, hub=0):
    from cozo_tpu_torch.ops import graph_algos as ga

    ip, d = graph_csr(n, e, n + e, hub=hub, dangling=dangling)
    return ga._pagerank_stage(ip, d, None, dev)


def sssp_weights(kind, ip, d, seed):
    rng = np.random.default_rng(seed)
    e = len(d)
    if kind == "uniform":
        return np.full(e, 1.5, np.float32)
    if kind == "dyadic":
        return rng.integers(1, 32, e).astype(np.float32) / 8
    if kind == "negative":
        # k/8 in [-1, 3) on the edges to a larger node id, 64 on the others:
        # every cycle takes one of the latter, and none is negative
        w = rng.integers(-8, 24, e).astype(np.float32) / 8
        w[d <= np.repeat(np.arange(len(ip) - 1), np.diff(ip))] = 64.0
        return w
    return rng.uniform(0.1, 3.0, e).astype(np.float32)


def sssp_inputs(case, dev):
    """(staged EllGraph, sources, max_iters) of a GRAPH_SSSP_CASES entry."""
    from cozo_tpu_torch.ops import graph_algos as ga

    n, e, hub, kind, sources, max_iters = case
    ip, d = graph_csr(n, e, n + e + hub, hub=hub)
    g = ga._sssp_ell_stage(ip, d, sssp_weights(kind, ip, d, hub), None,
                           dev, False)
    return g, list(sources), max_iters


def lp_inputs(H, W, weighted, seed, dev, kind="mixed"):
    """One pick's inputs: rows of W slots over labels of `kind` (64 that
    repeat and tie, all distinct, three, or one), a quarter of the slots
    padding, a row of padding only, a row with a planted tie of two
    labels, weights k/8 with zeros and negatives (a row without a valid
    slot).  W <= 128: the dense layout (row h is node h, `has_in`, a
    tenth of the rows without in-edges); wider: a lane (`idx`, with a
    padding row)."""
    import torch

    rng = np.random.default_rng(seed)
    dense = W <= 128
    n_pad = max(256, H) if dense else 4096
    n_real = n_pad - 5
    labels = {"mixed": lambda: rng.integers(0, 64, n_pad),
              "distinct": lambda: rng.permutation(n_pad),
              "three": lambda: rng.integers(0, 3, n_pad),
              "one": lambda: np.full(n_pad, 7)}[kind]().astype(np.int32)
    labels[-1] = n_pad - 1  # the dummy keeps its own label
    nb = rng.integers(0, n_real, (H, W)).astype(np.int32)
    nb[rng.random((H, W)) < 0.25] = n_pad - 1
    nb[0, :] = n_pad - 1
    # planted tie: half the slots name a node of label 70, half one of 65
    labels[[n_real - 1, n_real - 2]] = (70, 65)
    nb[2, : W // 2] = n_real - 1
    nb[2, W // 2:] = n_real - 2
    w = None
    if weighted:
        w = rng.integers(-2, 9, (H, W)).astype(np.float32) / 8
        w[1, :] = 0.0
        w[2, :] = 0.5
        w = torch.from_numpy(w).to(dev)
    idx = has_in = None
    if dense:
        has_in = torch.from_numpy(rng.random(H) < 0.9).to(dev)
        has_in[2] = True
    else:
        idx_h = rng.choice(n_real - 2, H, replace=False).astype(np.int32)
        idx_h[-1] = n_pad - 1  # a padding row
        idx = torch.from_numpy(idx_h).to(dev)
    return (torch.from_numpy(labels).to(dev), torch.from_numpy(nb).to(dev),
            w, idx, has_in, n_real)


def pagerank_agreement(got, want, n):
    """(L1 distance of the rank vectors, whether the top-100 nodes are the
    same up to ties at the 100th rank)."""
    import torch

    got, want = got[:n].double(), want[:n].double()
    l1 = float((got - want).abs().sum())
    k = min(100, n)
    top_g = set(torch.topk(got, k).indices.tolist())
    top_p = set(torch.topk(want, k).indices.tolist())
    kth = float(torch.topk(want, k).values[-1])
    tie = 2 * l1 + 1e-12
    same = all(abs(float(want[i]) - kth) <= tie for i in top_g ^ top_p)
    return l1, same


def phase_graph_vs_plain(dev):
    """Phase 2 for the graph kernels: each against its plain version on
    the card, two runs of each shape bit-identical."""
    import torch

    from cozo_tpu_torch.ops import _build
    from cozo_tpu_torch.ops import graph_algos as ga

    pr_lib2 = ga._bind_pagerank(_build.load("graph_pagerank", PR_BIN_SIZE_2))
    bins2 = pr_lib2.cozo_pagerank_bin_nodes()
    for n, e, steps, dangling, hub in GRAPH_PR_CASES:
        staged = pr_inputs(n, e, dangling, dev, hub)
        got = ga.pagerank_steps(*staged, n, steps, 0.85)
        again = ga.pagerank_steps(*staged, n, steps, 0.85)
        want = ga.pagerank_plain(*staged, n, steps, 0.85)
        other = ga._pagerank_launch(
            pr_lib2, *staged[:3],
            *ga._pagerank_bins(staged[0], staged[1], n, bins2), n, steps,
            0.85, ga._stream(staged[0]))
        torch.cuda.synchronize()
        l1, top = pagerank_agreement(got, want, n)
        twice = bool(torch.equal(got, again))
        same_bins = bool(torch.equal(got, other))
        pad0 = not bool(got[n:].any())
        say(f"phase 2 graph_pagerank vs plain n={n} e={e} steps={steps} "
            f"dangling={dangling} hub={hub}: L1 {l1:.3e} (tol {PR_L1_TOL}) "
            f"top-100 same {top}, padding 0 {pad0}, two runs identical "
            f"{twice}, bins of {ga.PR_BIN_NODES} and {bins2} nodes "
            f"identical {same_bins}")
        if not (l1 <= PR_L1_TOL and top and twice and pad0 and same_bins):
            raise SystemExit("phase 2 failed: graph_pagerank disagrees")
    sssp_lib = ga._bind_sssp(_build.load("graph_sssp"))
    for case in GRAPH_SSSP_CASES:
        g, sources, max_iters = sssp_inputs(case, dev)
        got = ga.sssp_ell(g, sources, max_iters)
        again = ga.sssp_ell(g, sources, max_iters)
        want = ga.sssp_ell_plain(g, sources, max_iters)
        # every step a push, every step a pull: the same bits
        forced = {route: ga._sssp_launch(sssp_lib, g, sources, max_iters,
                                         ga._stream(g.flat_src), share)
                  for route, share in SSSP_FORCED_SHARES.items()}
        torch.cuda.synchronize()
        equal = all(torch.equal(r[0], want[0]) and torch.equal(r[1], want[1])
                    and r[2] == want[2] for r in [got, *forced.values()])
        twice = torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])
        reached = int(torch.isfinite(got[0]).sum())
        say(f"phase 2 graph_sssp vs plain n={case[0]} e={case[1]} "
            f"hub={case[2]} weights={case[3]} S={len(sources)} "
            f"max_iters={max_iters}: steps {got[2]} (plain {want[2]}), "
            f"reached {reached} of {len(sources) * case[0]}, level-2 "
            f"buckets {len(g.l2_desc)}, dist and parents equal (the rule, "
            f"push forced, pull forced) {equal}, two runs identical {twice}")
        if not (equal and twice):
            raise SystemExit("phase 2 failed: graph_sssp disagrees")
    for W, weighted, kind in itertools.product(GRAPH_LP_WIDTHS, (False, True),
                                               GRAPH_LP_LABELS):
        H = 4096 if W <= 128 else (512 if W <= 256 else 16)
        labels, nb, w, idx, has_in, n_real = lp_inputs(H, W, weighted, W,
                                                       dev, kind)
        outs = []
        for _ in range(2):
            out = labels.clone()
            ga.lp_pick(labels, nb, w, idx, has_in, n_real, out)
            outs.append(out)
        want = labels.clone()
        ga.lp_pick_plain(labels, nb, w, idx, has_in, n_real, want)
        torch.cuda.synchronize()
        equal = torch.equal(outs[0], want)
        twice = torch.equal(outs[0], outs[1])
        changed = int((outs[0] != labels).sum())
        say(f"phase 2 graph_labelprop vs plain W={W} H={H} "
            f"{'weighted' if weighted else 'unit'} {kind} labels "
            f"{'dense' if idx is None else 'lane'}: labels equal {equal} "
            f"({changed} changed), two runs identical {twice}")
        if not (equal and twice and changed):
            raise SystemExit("phase 2 failed: graph_labelprop disagrees")


# MinHash segment-min cases of phase 2: (name, doc lengths, n_perm).  A
# tuple lists every doc's length; a dict draws `n` lengths in [lo, hi).
MINHASH_CASES = (
    ("empty docs first, inside and last, one-token docs",
     (0, 5, 0, 17, 1, 3, 0, 9, 1, 0, 0), 100),
    ("one doc", (7,), 1),
    ("a single-token doc", (1,), 32),
    ("a doc past one shared-memory tile", (3, 100_000, 0, 4), 128),
    ("D = 1,024 (the JAX tail-fix case)", {"n": 1024, "lo": 1, "hi": 9}, 256),
    ("a backfill-like batch", {"n": 5000, "lo": 8, "hi": 18}, 128),
    ("empty docs at n_perm 32", {"n": 300, "lo": 0, "hi": 4}, 32),
)
# hashes every case carries: 0, all ones, and the top bit alone and
# cleared, so xors with the seeds set and clear the top bit
MINHASH_EDGE_HASHES = (0, 0xFFFFFFFF, 0x80000000, 0x7FFFFFFF)


def minhash_inputs(lens, seed):
    """(flat hashes [T] u32, doc starts [D] i64) for a MINHASH_CASES
    entry's lengths."""
    rng = np.random.default_rng(seed)
    if isinstance(lens, dict):
        lens = rng.integers(lens["lo"], lens["hi"], lens["n"])
    lens = np.asarray(lens, np.int64)
    offs = np.zeros(len(lens), np.int64)
    np.cumsum(lens[:-1], out=offs[1:])
    flat = rng.integers(0, 1 << 32, int(lens.sum()),
                        dtype=np.uint64).astype(np.uint32)
    k = min(len(flat), len(MINHASH_EDGE_HASHES))
    if k:
        flat[:k] = MINHASH_EDGE_HASHES[:k]
        flat[-k:] = MINHASH_EDGE_HASHES[:k]
    return flat, offs


def minhash_tensors(flat, offs, dev):
    import torch

    return (torch.from_numpy(flat.view(np.int32)).to(dev),
            torch.from_numpy(offs).to(dev))


def phase_minhash_vs_plain(dev):
    """Phase 2 for the MinHash kernel: signatures bit-equal to the plain
    version on the card and to the host `minhash_segments`, two runs
    bit-identical."""
    import torch

    from cozo_tpu_torch.ops import minhash as mh

    for i, (name, lens, n_perm) in enumerate(MINHASH_CASES):
        flat, offs = minhash_inputs(lens, i)
        h, o = minhash_tensors(flat, offs, dev)
        outs = []
        for _ in range(2):
            out = torch.empty((len(offs), n_perm), dtype=torch.int32,
                              device=dev)
            outs.append(mh.segment_min(h, o, n_perm, out))
        want = mh.segment_min_plain(h, o, n_perm)
        torch.cuda.synchronize()
        got = outs[0].cpu().numpy().view(np.uint32)
        host = mh.minhash_segments(flat, offs, n_perm)
        equal = bool(torch.equal(outs[0], want)) and bool((got == host).all())
        twice = bool(torch.equal(outs[0], outs[1]))
        empty = int((np.diff(np.append(offs, len(flat))) == 0).sum())
        say(f"phase 2 minhash vs plain ({name}): T={len(flat)} "
            f"D={len(offs)} n_perm={n_perm}, {empty} empty docs: "
            f"signatures equal to plain and host {equal}, two runs "
            f"identical {twice}")
        if not (equal and twice):
            raise SystemExit("phase 2 failed: minhash disagrees")


def recall(ids, gt):
    return float(np.mean([
        len(set(ids[b].tolist()) & set(gt[b].tolist())) / K
        for b in range(len(gt))
    ]))


def phase_main(index, qs, build_s, reps):
    """Serve the index that phase 5 built through the Db (the same data,
    `bulk_build(wave=8192)`, cosine, m = 16, ef_construction = 200, slots
    equal to ids) through the entry points; returns what phase 4 needs
    (launch counts)."""
    import torch

    from cozo_tpu_torch import sweep_search
    from cozo_tpu_torch.ops import fused_sweep as fs

    n = index.n
    # counts of the main path's run only
    fs.fused_sweep.launches = 0
    fs.fused_sweep.route_launches = dict.fromkeys(fs.ROUTES, 0)
    say(f"phase 3 serves the Db's index: {n} slots ({int(index.alive[:n].sum())}"
        f" alive), built by the DDL in phase 5 ({build_s:.1f}s)")

    t0 = time.time()
    gt, gt_d = sweep_search(index, qs, K, rt=1.0, compute_dtype="f32",
                            exact_rerank=False)
    say(f"phase 3 f32 ground truth in {time.time() - t0:.2f}s")
    if gt.shape != (NQ, K) or not np.isfinite(gt_d).all() or (gt < 0).any():
        raise SystemExit("phase 3 failed: f32 lane returned bad rows")

    lanes = {}
    # the int8 lane re-ranks 64 candidates, as the JAX package's bench
    # does: int8 rank noise needs the wider overfetch
    for tag, cd, rt, rerank, rk in (
            ("fused+rerank", "fused", 1.0, True, None),
            ("bf16+rerank", "bf16", 0.98, True, None),
            ("bf16-raw", "bf16", 0.99, False, None),
            ("i8+rerank", "i8", 0.98, True, 64)):
        torch.cuda.reset_peak_memory_stats()
        sweep_search(index, qs, K, rt=rt, compute_dtype=cd,
                     exact_rerank=rerank, rerank_k=rk)  # warm
        per_rep = []
        for _ in range(reps if cd == "fused" else OTHER_LANE_REPS):
            t0 = time.time()
            ids, dists = sweep_search(index, qs, K, rt=rt, compute_dtype=cd,
                                      exact_rerank=rerank, rerank_k=rk)
            per_rep.append(NQ / (time.time() - t0))
        r = recall(ids, gt)
        ok = (ids.shape == (NQ, K) and np.isfinite(dists[ids >= 0]).all()
              and r >= BARS[tag])
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        lanes[tag] = {"qps_median": float(np.median(per_rep)),
                      "qps_min": float(min(per_rep)), "per_rep_qps": per_rep,
                      "recall@10": r, "peak_device_gb": peak_gb}
        say(f"phase 3 lane {tag}: median {np.median(per_rep):.1f} QPS "
            f"min {min(per_rep):.1f} recall@10 {r:.5f} "
            f"(bar {BARS[tag]}) peak device memory {peak_gb:.2f} GB "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"phase 3 failed: lane {tag}")
    launches = dict(fs.fused_sweep.route_launches)
    say(f"phase 3 kernel launches on the main path: {launches}")
    main_route = fs.route(NQ, index._sweep_table.tbl_fused.shape[0],
                          index._sweep_table.d_pad)
    if launches[main_route] < 1 or \
            sum(launches.values()) != fs.fused_sweep.launches:
        raise SystemExit("phase 3 failed: fused_sweep never launched")
    lanes["quant"] = phase_quant_dispatch(index, qs, gt)
    beam = phase_beam_main(index, qs, gt)
    launches["beam_search"] = beam["launches"]
    say("phase 3 summary " + json.dumps(
        {"n": n, "nq": NQ, "build_s": build_s, "lanes": lanes,
         "beam_search": beam}))
    return launches


def phase_quant_dispatch(index, qs, gt):
    """The quant lane through `HnswIndex.search`, the f32 budget lowered
    for these calls only so that the table counts as past it."""
    from cozo_tpu_torch.ops.quant_knn import quant_search

    os.environ["COZO_TPU_F32_TABLE_MAX"] = "1"
    try:
        t0 = time.time()
        index.search(qs, K, 64)  # first use: quantises and loads the table
        load_s = time.time() - t0
        qps, scan_s, rerank_s = [], [], []
        for _ in range(OTHER_LANE_REPS):
            t0 = time.time()
            ids, dists = index.search(qs, K, 64)
            qps.append(NQ / (time.time() - t0))
            scan_s.append(quant_search.last_timing[0])
            rerank_s.append(quant_search.last_timing[1])
    finally:
        del os.environ["COZO_TPU_F32_TABLE_MAX"]
    r = recall(ids, gt)
    ok = (index._quant_sweep is not None and ids.shape == (NQ, K)
          and np.isfinite(dists[ids >= 0]).all() and r >= BARS["quant"])
    say(f"phase 3 lane quant (HnswIndex.search past the budget): median "
        f"{np.median(qps):.1f} QPS min {min(qps):.1f} (device scan + pull "
        f"{np.median(scan_s):.3f}s, host re-rank {np.median(rerank_s):.3f}s; "
        f"first call with the table load {load_s:.2f}s) recall@10 {r:.5f} "
        f"(bar {BARS['quant']}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("phase 3 failed: lane quant")
    return {"qps_median": float(np.median(qps)), "qps_min": float(min(qps)),
            "scan_s": float(np.median(scan_s)),
            "rerank_s": float(np.median(rerank_s)), "load_s": load_s,
            "recall@10": r}


def phase_beam_main(index, qs, gt):
    """Small batches through `HnswIndex.search`: the beam-search kernel on
    the full index, beside the host search; then the mirror's incremental
    update."""
    from cozo_tpu_torch.ops import vector_search as vs

    nb = 252  # four batches of 63: the bar is held on paired queries
    t0 = time.time()
    ids_h, _ = index.search(qs[:nb], K, 64, use_tpu=False)
    host_s = time.time() - t0
    r_host = recall(ids_h, gt[:nb])
    say(f"phase 3 host search (use_tpu=False, {nb} queries, ef=64): "
        f"recall@10 {r_host:.4f}, {host_s / nb * 1e3:.2f} ms per query")
    vs.beam_search.launches = 0  # counts of this path only
    out = {"host_recall@10": r_host, "per_batch": {}}
    t0 = time.time()
    index.search(qs[:16], K, 64)
    say(f"phase 3 beam search: first call (mirror upload) "
        f"{time.time() - t0:.2f}s")
    for B in (16, 1, 4, 63):
        before = vs.beam_search.launches
        lat = []
        for _ in range(20):
            t0 = time.perf_counter()
            # below B = 4 the default rule takes the host search
            ids, dists = index.search(qs[:B], K, 64,
                                      use_tpu=True if B < 4 else None)
            lat.append((time.perf_counter() - t0) * 1e3)
        counted = vs.beam_search.launches - before
        # the kernel alone on the same queries: a measurement beside the
        # path, so its launches are taken out of the path's count again
        args = beam_args(index, qs[:B], K, 64)
        kernel_ms = cuda_ms(lambda: vs.beam_search(*args), 20)
        vs.beam_search.launches = before + counted
        r, r_h = recall(ids, gt[:B]), recall(ids_h[:B], gt[:B])
        ok = (counted == 20 and ids.shape == (B, K)
              and np.isfinite(dists[ids >= 0]).all())
        out["per_batch"][B] = {"recall@10": r, "host_recall@10": r_h,
                               "ms_median": float(np.median(lat)),
                               "ms_min": float(min(lat)),
                               "kernel_ms": kernel_ms, "launches": counted}
        say(f"phase 3 beam search B={B}: search(k=10, ef=64) median "
            f"{np.median(lat):.3f} ms min {min(lat):.3f} ms per call, the "
            f"kernel alone {kernel_ms:.4f} ms, the call around it "
            f"{np.median(lat) - kernel_ms:.3f} ms; "
            f"recall@10 {r:.4f} (host search on the same queries {r_h:.4f}), "
            f"kernel launches {counted} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"phase 3 failed: beam search at B={B}")
    ids_d = np.concatenate([index.search(qs[b:b + 63], K, 64)[0]
                            for b in range(0, nb, 63)])
    r_dev = recall(ids_d, gt[:nb])
    out["recall@10"] = r_dev
    ok = r_dev >= r_host - 0.02
    say(f"phase 3 beam search on the host search's {nb} queries (4 calls of "
        f"B=63): recall@10 {r_dev:.4f} against the host search's "
        f"{r_host:.4f} (bar: at most 0.02 lower) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("phase 3 failed: beam search recall")
    # a few inserts and removals: the mirror takes the incremental route
    cache = index._dev_cache
    vectors_before = cache["vectors"]
    new = [index.insert(qs[100 + i]) for i in range(4)]
    gone = [int(s) for s in gt[:4, 0]]
    for s in gone:
        index.remove(s)
    ids_inc, d_inc = index.search(qs[:16], K, 64)
    in_place = (index._dev_cache is cache
                and cache["vectors"] is vectors_before
                and cache["version"] == index.version
                and not index.dev_pending)
    rows_match = (
        np.array_equal(cache["vectors"][new].cpu().numpy(), index.vectors[new])
        and np.array_equal(cache["nb0"][new].cpu().numpy(),
                           index.neighbors[0][new])
        and bool(cache["alive"][new].all())
        and not bool(cache["alive"][gone].any()))
    index._dev_cache = None  # a full re-push must answer alike
    ids_full, d_full = index.search(qs[:16], K, 64)
    same = (np.array_equal(ids_inc, ids_full)
            and np.array_equal(d_inc, d_full))
    ok = (in_place and rows_match and same
          and not np.isin(ids_inc, gone).any())
    say(f"phase 3 beam search after 4 inserts and 4 removals: mirror updated "
        f"in place {in_place}, its rows equal the host's {rows_match}, "
        f"removed rows absent {not np.isin(ids_inc, gone).any()}, same "
        f"answer as a full re-push {same} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("phase 3 failed: incremental mirror update")
    out["launches"] = vs.beam_search.launches
    if out["launches"] < 1:
        raise SystemExit("phase 3 failed: beam_search never launched")
    say(f"phase 3 beam_search launches on the main path: {out['launches']}")
    return out


DB_NQ, DB_SMALL, INGEST_BATCH = 4096, 16, 50_000  # bench_hybrid_1m.py
JOIN = ("?[qid, id, d] := *{rel}{{qid, qv}}, ~item:ix{{id | query: qv, k: 10, "
        "ef: 64, bind_distance: d}}")
TWO_HOP = ("first[id, v2] := ~item:ix{id, v: v2 | query: qv, k: 4, ef: 64}, "
           "qv = vec($q)\n"
           "?[id2] := first[id, v2], ~item:ix{id: id2 | query: v2, k: 4, "
           "ef: 64}, id2 != id")


def join_ids(rows, nq):
    """The pivot join's rows as [nq, K] ids by distance (-1 padded) and the
    distances beside them."""
    ids = np.full((nq, K), -1, dtype=np.int64)
    dists = np.full((nq, K), np.inf)
    per = {}
    for qid, i, d in rows:
        per.setdefault(qid, []).append((d, i))
    for qid, got in per.items():
        got.sort()
        ids[qid, :len(got)] = [i for _, i in got[:K]]
        dists[qid, :len(got)] = [d for d, _ in got[:K]]
    return ids, dists


def median_ms(fn, reps):
    lat = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        lat.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(lat)), out


def build_db(data):
    """`Db("mem")` holding `data` as `item {id: Int => v}`, ingested by
    `:put` batches of 50,000 ndarray rows, and `::hnsw create item:ix`
    (cosine, m = 16, ef_construction = 200) as the packed KV image, which
    every index past 2M rows takes by default (a row image of 1.18M rows
    is 20-30M KV rows encoded in Python).  Returns the Db and the seconds
    of the ingest, the DDL and the bulk build inside it."""
    import torch

    from cozo_tpu_torch import Db
    from cozo_tpu_torch.models.hnsw_index import HnswIndex

    n, d = data.shape
    out = {}
    db = Db("mem")
    db.run_script(f":create item {{id: Int => v: <F32; {d}>}}")
    t0 = time.time()
    for s in range(0, n, INGEST_BATCH):
        rows = [[s + i, data[s + i]] for i in range(min(INGEST_BATCH, n - s))]
        db.run_script("?[id, v] <- $rows :put item {id => v}", {"rows": rows})
    out["ingest_s"] = time.time() - t0
    out["ingest_rows_per_s"] = n / out["ingest_s"]
    build = HnswIndex.bulk_build
    spent = []

    def timed_build(self, *a, **kw):
        t = time.time()
        res = build(self, *a, **kw)
        torch.cuda.synchronize()
        spent.append(time.time() - t)
        return res

    os.environ["COZO_TPU_PACKED_KV_MIN"] = str(min(1_000_000, n))
    HnswIndex.bulk_build = timed_build
    try:
        t0 = time.time()
        db.run_script(f"::hnsw create item:ix {{dim: {d}, m: 16, dtype: F32, "
                      "fields: [v], distance: Cosine, ef_construction: 200}")
        out["ddl_s"] = time.time() - t0
    finally:
        HnswIndex.bulk_build = build
        del os.environ["COZO_TPU_PACKED_KV_MIN"]
    if len(spent) != 1:
        raise SystemExit("::hnsw create did not bulk-build the index once")
    out["bulk_build_s"] = spent[0]
    return db, out


def store_queries(db, rel, rows):
    """`rel {qid: Int => qv}` holding `rows` (numbered from 0)."""
    db.run_script(f":create {rel} {{qid: Int => qv: <F32; {rows.shape[1]}>}}")
    db.run_script(f"?[qid, qv] <- $rows :put {rel} {{qid => qv}}",
                  {"rows": [[i, rows[i]] for i in range(len(rows))]})


def phase_db(data, qs):
    """Phase 5: `cozo_tpu_torch.Db("mem")` on the card, the script of
    `benches/bench_hybrid_1m.py` phases 1-4: ingest, `::hnsw create`, the
    vector-pivot join of 4,096 stored queries (cold, warm, after a cache
    rebuild from KV), the small join (B = 16) and the 2-hop (the
    beam-search kernel), 8 threads of small joins, then writes.  Returns
    (the Db, its index, the bulk build's seconds, phase 5's launches)."""
    from concurrent.futures import ThreadPoolExecutor as Pool

    from cozo_tpu_torch import sweep_search
    from cozo_tpu_torch.ops import fused_sweep as fs
    from cozo_tpu_torch.ops import vector_search as vs

    n, d = data.shape
    vs.beam_search.launches = 0  # counts of this path only
    fs.fused_sweep.launches = 0
    db, out = build_db(data)
    out.update(n=n, d=d)
    say(f"phase 5 ingest: {n} rows in {out['ingest_s']:.1f}s "
        f"({out['ingest_rows_per_s']:.0f} rows/s, :put batches of "
        f"{INGEST_BATCH})")
    cache = db.algo_cache["hnsw::item::ix"]
    index = cache.index
    ok = (cache.packed and index.n == n and index.device == db.device
          and np.array_equal(cache.slot_ids, np.arange(n)))
    say(f"phase 5 ::hnsw create: {out['ddl_s']:.1f}s, of which bulk_build "
        f"{out['bulk_build_s']:.1f}s ({n / out['bulk_build_s']:.0f} "
        f"vectors/s); packed image {cache.packed}, slots equal ids "
        f"{ok} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("phase 5 failed: the DDL build")

    store_queries(db, "q", qs[:DB_NQ])
    # the small joins' query sets: q16 for the sequential runs, q16_t for
    # thread t (each its own queries)
    small = [qs[DB_NQ + DB_SMALL * t: DB_NQ + DB_SMALL * (t + 1)]
             for t in range(9)]
    for t, rel in enumerate(["q16"] + [f"q16_{t}" for t in range(8)]):
        store_queries(db, rel, small[t])

    join = JOIN.format(rel="q")
    t0 = time.time()
    res = db.run_script(join)
    out["join_cold_s"] = time.time() - t0
    reps = []
    for _ in range(3):
        t0 = time.time()
        res = db.run_script(join)
        reps.append(time.time() - t0)
    out["join_warm_s"] = float(np.median(reps))
    out["join_qps"] = DB_NQ / out["join_warm_s"]
    out["join_rows"] = len(res.rows)
    ids_j, d_j = join_ids(res.rows, DB_NQ)
    gt, _ = sweep_search(index, qs[:DB_NQ], K, rt=1.0, compute_dtype="f32",
                         exact_rerank=False)
    out["join_recall@10"] = recall(ids_j, gt)
    # the serving lane alone on the same queries: its share of the join
    lane_s = []
    for _ in range(3):
        t0 = time.time()
        index.search(qs[:DB_NQ], K, 64)
        lane_s.append(time.time() - t0)
    out["join_lane_s"] = float(np.median(lane_s))
    ok = (out["join_rows"] == DB_NQ * K and out["join_recall@10"] >= 0.999
          and np.isfinite(d_j).all())
    say(f"phase 5 pivot join (B={DB_NQ}, k=10, ef=64): cold "
        f"{out['join_cold_s']:.2f}s (the index's first search: its device "
        f"tables go up), warm median {out['join_warm_s']:.3f}s = "
        f"{out['join_qps']:.0f} QPS, {out['join_rows']} rows; the bf16 + "
        f"re-rank lane alone {out['join_lane_s']:.3f}s "
        f"({100 * out['join_lane_s'] / out['join_warm_s']:.1f}% of the join);"
        f" recall@10 against the exact f32 lane {out['join_recall@10']:.5f} "
        f"(bar 0.999) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("phase 5 failed: the pivot join")

    # a cache rebuilt from the packed KV image: a new HnswIndex whose
    # device tables go up again at its first search
    db.algo_cache.clear()
    t0 = time.time()
    res2 = db.run_script(join)
    out["join_after_rebuild_s"] = time.time() - t0
    index = db.algo_cache["hnsw::item::ix"].index
    same = (sorted(map(tuple, res2.rows)) == sorted(map(tuple, res.rows))
            and index.device == db.device)
    say(f"phase 5 pivot join after the index cache was dropped (rebuilt "
        f"from the packed image, tables uploaded again): "
        f"{out['join_after_rebuild_s']:.2f}s, the same rows {same} "
        f"{'ok' if same else 'FAIL'}")
    if not same:
        raise SystemExit("phase 5 failed: the rebuilt index answers otherwise")

    small_join = JOIN.format(rel="q16")
    before = vs.beam_search.launches
    db.run_script(small_join)  # the index's mirror goes up
    out["small_join_ms"], res = median_ms(lambda: db.run_script(small_join),
                                          20)
    counted = vs.beam_search.launches - before
    ids_s, d_s = join_ids(res.rows, DB_SMALL)
    ids_x, d_x = index.search(small[0], K, 64)
    args = beam_args(index, small[0], K, 64)
    kernel_ms = cuda_ms(lambda: vs.beam_search(*args), 20)
    vs.beam_search.launches = before + counted  # the timing is no path
    out["small_join_kernel_ms"] = kernel_ms
    ok = (counted == 21 and np.array_equal(ids_s, ids_x)
          and np.allclose(d_s, d_x, rtol=0, atol=1e-12))
    say(f"phase 5 small join (B={DB_SMALL}): median "
        f"{out['small_join_ms']:.3f} ms of 20, the kernel alone "
        f"{kernel_ms:.4f} ms; beam_search launches {counted} (21 expected), "
        f"ids equal to index.search on the same queries "
        f"{np.array_equal(ids_s, ids_x)} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("phase 5 failed: the small join")

    before = vs.beam_search.launches
    db.run_script(TWO_HOP, {"q": qs[0]})
    hop = iter(range(20))  # a new query each run, as the bench does
    out["two_hop_ms"], res = median_ms(
        lambda: db.run_script(TWO_HOP, {"q": qs[next(hop)]}), 20)
    out["two_hop_launches"] = vs.beam_search.launches - before
    ok = out["two_hop_launches"] == 21 and len(res.rows) >= 1
    say(f"phase 5 2-hop (first hop B=1 on the host, second B=4 through the "
        f"kernel): median {out['two_hop_ms']:.3f} ms of 20, "
        f"{len(res.rows)} rows in the last, beam_search launches "
        f"{out['two_hop_launches']} (21 expected) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("phase 5 failed: the 2-hop")

    scripts = [JOIN.format(rel=f"q16_{t}") for t in range(8)]
    want = [sorted(map(tuple, db.run_script(s).rows)) for s in scripts]

    def worker(t):
        return all(sorted(map(tuple, db.run_script(scripts[t]).rows))
                   == want[t] for _ in range(20))

    t0 = time.time()
    with Pool(8) as ex:
        agree = list(ex.map(worker, range(8)))
    out["threads_s"] = time.time() - t0
    ok = all(agree) and all(len(w) == DB_SMALL * K for w in want)
    say(f"phase 5 8 threads x 20 small joins (each its own 16 queries): "
        f"{out['threads_s']:.2f}s, every answer equal to the sequential one "
        f"{all(agree)} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("phase 5 failed: concurrent small joins")

    # 4 new rows, each twice the nearest row of one of the first 4 small
    # queries (the same direction: the same cosine distance), and 4
    # removals among the nearest rows of the others
    mirror = index._dev_cache
    near = [int(i) for i in ids_x[:4, 0]]
    new_ids = list(range(n, n + 4))
    gone = [int(i) for i in ids_x[4:, 0] if i not in near][:4]
    db.run_script("?[id, v] <- $rows :put item {id => v}",
                  {"rows": [[new_ids[i], 2 * data[near[i]]] for i in range(4)]})
    db.run_script("?[id] <- $rows :rm item {id}",
                  {"rows": [[i] for i in gone]})
    res = db.run_script(small_join)
    ids_w, d_w = join_ids(res.rows, DB_SMALL)
    in_place = (db.algo_cache["hnsw::item::ix"].index is index
                and index._dev_cache is mirror
                and mirror["version"] == index.version)
    found = all(
        new_ids[i] in ids_w[i]
        and abs(d_w[i][ids_w[i] == new_ids[i]][0] - d_x[i, 0]) < 1e-5
        for i in range(4))
    absent = len(gone) == 4 and not np.isin(ids_w, gone).any()
    ok = in_place and found and absent
    say(f"phase 5 writes (:put 4 new rows, :rm 4): the new rows found at "
        f"their twins' distance {found}, the removed ones absent {absent}, "
        f"the mirror updated in "
        f"place {in_place} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("phase 5 failed: writes through the Db")

    out["launches"] = {"beam_search": vs.beam_search.launches,
                       "fused_sweep": fs.fused_sweep.launches}
    if out["launches"]["beam_search"] < 1:
        raise SystemExit("phase 5 failed: beam_search never launched")
    say(f"phase 5 kernel launches on the Db path: {out['launches']}")
    out["card"] = smi_line()
    say("db " + json.dumps(out))
    return db, index, out["bulk_build_s"], out["launches"]["beam_search"]


# -------------------------------------------- the graph rules at full size

PROX = "*item:ix{layer: 0, fr_id: fr, to_id: to}"  # the level-0 graph
GRAPH_PR = f"?[n, s] <~ PageRank({PROX}, iterations: 10)"
GRAPH_LP = f"?[l, n] <~ LabelPropagation({PROX}, undirected: true)"
GRAPH_SP = (f"?[s, g, c, p] <~ ShortestPathDijkstra({PROX}, *sp_start[id], "
            "*sp_goal[id])")
SP_STARTS, SP_GOALS = 4, 64
# benches/graph_scale_bench.py (BASELINE config #3): the LiveJournal-scale
# graph, and the hub graph of its LabelPropagation
LJ_EDGES = 69_000_000
LJ_NODES = LJ_EDGES // 14
HUB_EDGES, HUB_DEG = 50_000_000, 10_000
HUB_NODES = HUB_EDGES // 14


def graph_counts():
    from cozo_tpu_torch.ops import graph_algos as ga

    return {"graph_pagerank": ga.pagerank_steps.launches,
            "graph_sssp": ga.sssp_ell.launches,
            "graph_sssp_solves": ga.sssp_ell.solves,
            "graph_labelprop": ga.lp_pick.launches}


def count_graph_launches(entry, by_path):
    """A graph kernel's `kernels` entry gains its launches on each path
    ({path: graph_counts()}) and their sum; graph_sssp its solves too."""
    for key, count in (("launches", entry["name"]),
                       ("solves", entry["name"] + "_solves")):
        if count in next(iter(by_path.values())):
            entry[key + "_by_path"] = {p: c[count] for p, c in by_path.items()}
            entry[key] = sum(entry[key + "_by_path"].values())


def zero_graph_counts():
    from cozo_tpu_torch.ops import graph_algos as ga

    ga.pagerank_steps.launches = ga.sssp_ell.launches = 0
    ga.sssp_ell.solves = ga.lp_pick.launches = 0


def plain_kernels():
    """A context in which the graph entry points run the kernels' plain
    versions on the card (the wrappers themselves take them only for CPU
    tensors): the reference the full-size phases are held to."""
    import contextlib

    from cozo_tpu_torch.ops import graph_algos as ga

    @contextlib.contextmanager
    def swap():
        saved = ga.pagerank_steps, ga.sssp_ell, ga.lp_pick
        ga.pagerank_steps, ga.sssp_ell, ga.lp_pick = (
            ga.pagerank_plain, ga.sssp_ell_plain, ga.lp_pick_plain)
        try:
            yield
        finally:
            ga.pagerank_steps, ga.sssp_ell, ga.lp_pick = saved

    return swap()


def canonical(labels):
    """Label ids renumbered by first occurrence: equal partitions give
    equal arrays."""
    _, first, inv = np.unique(labels, return_index=True, return_inverse=True)
    return np.argsort(np.argsort(first))[inv]


def bfs_hops(indptr, dst, s):
    """Unweighted distances from s over the CSR, level by level."""
    dist = np.full(len(indptr) - 1, np.inf)
    dist[s] = 0.0
    frontier, h = np.array([s]), 0
    while len(frontier):
        h += 1
        lens = indptr[frontier + 1] - indptr[frontier]
        at = np.repeat(indptr[frontier] - np.cumsum(lens) + lens, lens)
        nb = dst[at + np.arange(int(lens.sum()))]
        nb = np.unique(nb[np.isinf(dist[nb])])
        dist[nb] = h
        frontier = nb
    return dist


def cached_csr(db, undirected):
    """The CSR the Db staged for the last rule over the level-0 graph."""
    for key, val in db._csr_cache.items():
        if key[-1] == "csr" and key[-2] == undirected:
            return val
    raise SystemExit("phase 6 failed: the Db staged no CSR of the graph")


def timed_runs(db, script):
    """(cold s, warm s, the warm run's rows) of `script`."""
    t0 = time.time()
    db.run_script(script)
    cold = time.time() - t0
    t0 = time.time()
    res = db.run_script(script)
    return cold, time.time() - t0, res.rows


def lp_route(cache_key, dev):
    """Which LabelPropagation layout the device cache holds for the graph:
    ("dense", [(width, rows)]) or ("hybrid", lanes, host hubs)."""
    from cozo_tpu_torch.ops import graph_algos as ga

    for key, val in ga._GRAPH_DEV_CACHE.items():
        if (key[0] not in ("lpd", "lph2") or key[1] != str(dev)
                or key[2][0] != cache_key):
            continue
        if key[0] == "lpd":
            return {"route": "dense", "lanes": [list(val[0].shape[::-1])]}
        if key[0] == "lph2":
            return {"route": "hybrid",
                    "lanes": [[W, H] for H, W, _ in val[0]],
                    "host_hubs": int(len(val[2]))}
    raise SystemExit("label propagation staged nothing on the device")


def phase_graph_db(db, dev, reps=5):
    """Phase 6: PageRank, LabelPropagation and ShortestPathDijkstra
    through the Db over the level-0 proximity graph of the index phase 5
    built, read straight from the index relation; each cold and warm and
    held to the plain versions (SSSP to a host BFS) on the same CSR."""
    import torch

    from cozo_tpu_torch.ops import graph_algos as ga

    out = {}
    zero_graph_counts()
    out["pagerank_cold_s"], out["pagerank_warm_s"], rows = timed_runs(
        db, GRAPH_PR)
    indptr, dst, verts = cached_csr(db, False)
    n, e = len(verts), len(dst)
    out.update(nodes=n, edges=e, mean_out_degree=e / n)
    ck = ga.graph_content_key(indptr, dst)
    got = torch.zeros(ga._pad_pow2(n + 1), dtype=torch.float64)
    pos = {v: i for i, v in enumerate(verts)}
    for v, s in rows:
        got[pos[v]] = s
    with plain_kernels():
        want = ga.pagerank_jax(indptr, dst, iterations=10, cache_key=ck,
                               device=dev)
    l1, top = pagerank_agreement(got, torch.from_numpy(want), n)
    out.update(pagerank_l1=l1, pagerank_top100_same=top,
               pagerank_medges_per_s=10 * e / out["pagerank_warm_s"] / 1e6)
    ok = len(rows) == n and l1 <= PR_L1_TOL and top
    say(f"phase 6 PageRank (10 steps) over the level-0 graph: {n} nodes, "
        f"{e} edges (self-edges included); cold {out['pagerank_cold_s']:.2f}s"
        f" warm {out['pagerank_warm_s']:.2f}s ({out['pagerank_medges_per_s']:.0f}"
        f" M edges/s through the Db); against the plain version on the same "
        f"CSR: L1 {l1:.3e} (tol {PR_L1_TOL}), top-100 same {top} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("phase 6 failed: PageRank")

    out["labelprop_cold_s"], out["labelprop_warm_s"], rows = timed_runs(
        db, GRAPH_LP)
    u_ptr, u_dst, u_verts = cached_csr(db, True)
    uck = ga.graph_content_key(u_ptr, u_dst)
    route = lp_route(uck, dev)
    in_deg = np.bincount(u_dst, minlength=len(u_verts))
    by_node = {v: l for l, v in rows}
    got_l = canonical(np.array([by_node[v] for v in u_verts]))
    with plain_kernels():
        ended = ga.labelprop_jax(u_ptr, u_dst, None, 10, cache_key=uck,
                                 device=dev)
    want_l = canonical(ended)
    same = bool(np.array_equal(got_l, want_l))
    out.update(labelprop_edges=len(u_dst), labelprop_max_in_degree=
               int(in_deg.max()), labelprop_layout=route,
               labelprop_communities=int(got_l.max()) + 1,
               labelprop_partition_equal=same)
    ok = same and len(rows) == len(u_verts)
    say(f"phase 6 LabelPropagation (undirected, 10 steps): {len(u_dst)} "
        f"edges, max in-degree {int(in_deg.max())}: the {route['route']} "
        f"layout, lanes (width, rows) {route['lanes']}"
        f"{', host hubs %d' % route['host_hubs'] if 'host_hubs' in route else ''}"
        f"; cold {out['labelprop_cold_s']:.2f}s warm "
        f"{out['labelprop_warm_s']:.2f}s, {out['labelprop_communities']} "
        f"communities; partition equal to the plain version's {same} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("phase 6 failed: LabelPropagation")

    rng = np.random.default_rng(6)
    pick = rng.choice(n, SP_STARTS + SP_GOALS, replace=False)
    starts, goals = pick[:SP_STARTS], pick[SP_STARTS:]
    for rel, ids in (("sp_start", starts), ("sp_goal", goals)):
        db.run_script(f":create {rel} {{id: Int}}")
        db.run_script(f"?[id] <- $rows :put {rel} {{id}}",
                      {"rows": [[verts[i]] for i in ids]})
    out["sssp_cold_s"], out["sssp_warm_s"], rows = timed_runs(db, GRAPH_SP)
    hops = {verts[s]: bfs_hops(indptr, dst, s) for s in starts}
    costs = {(r[0], r[1]): r[2] for r in rows}
    want_c = {(verts[s], verts[g]): float(hops[verts[s]][g])
              for s in starts for g in goals}
    same = costs == want_c
    reached = sum(np.isfinite(c) for c in costs.values())
    out.update(sssp_rows=len(rows), sssp_reached=int(reached),
               sssp_costs_equal_bfs=same)
    say(f"phase 6 ShortestPathDijkstra ({SP_STARTS} stored starts, "
        f"{SP_GOALS} stored goals, unweighted: the uniform-weight scalar): "
        f"cold {out['sssp_cold_s']:.2f}s warm {out['sssp_warm_s']:.2f}s, "
        f"{len(rows)} rows, {reached} goals reached; the costs equal a host "
        f"BFS on the same CSR {same} {'ok' if same else 'FAIL'}")
    if not (same and len(rows) == SP_STARTS * SP_GOALS):
        raise SystemExit("phase 6 failed: ShortestPathDijkstra")

    out["launches"] = graph_counts()
    say(f"phase 6 graph kernel launches on the Db path: {out['launches']}")
    if min(out["launches"].values()) < 1:
        raise SystemExit("phase 6 failed: a graph kernel never launched")
    out["card"] = smi_line()
    say("graph " + json.dumps(out))
    # phase 4 at this graph's shapes, while its staged images are on the
    # card (phase 7's evict them)
    timings = {
        "pagerank": time_pagerank(ga._pagerank_stage(indptr, dst, ck, dev),
                                  n, e, reps, "db graph (phase 6)"),
        "lp_lanes": time_lp_lanes(uck, len(u_verts), ended, dev, reps,
                                  "db graph (phase 6)"),
        "sssp": time_sssp(ga._sssp_ell_stage(indptr, dst,
                                             np.ones(e, np.float32), ck,
                                             dev, False),
                          n, e, [int(s) for s in starts], "db graph (phase 6)"),
    }
    return out["launches"], timings


def make_graph(n_nodes, n_edges, seed=7):
    """benches/graph_scale_bench.py `make_graph` (a bincount in place of
    `np.add.at`: the same CSR, faster)."""
    rng = np.random.default_rng(seed)
    src = (rng.pareto(1.2, n_edges) * n_nodes / 20).astype(np.int64) % n_nodes
    dst = rng.integers(0, n_nodes, n_edges)
    order = np.argsort(src, kind="stable")
    src, dst = src[order], dst[order]
    indptr = np.zeros(n_nodes + 1, dtype=np.int64)
    indptr[1:] = np.cumsum(np.bincount(src, minlength=n_nodes))
    return indptr, dst


def make_hub_graph(n_nodes, n_edges, hub_deg, seed=11):
    """benches/graph_scale_bench.py `make_hub_graph` (bincount likewise)."""
    rng = np.random.default_rng(seed)
    base = n_edges - hub_deg
    src = rng.integers(0, n_nodes, n_edges).astype(np.int64)
    dst = np.empty(n_edges, dtype=np.int64)
    dst[:base] = rng.integers(0, n_nodes, base)
    dst[base:] = 0  # the hub
    order = np.argsort(src, kind="stable")
    src, dst = src[order], dst[order]
    indptr = np.zeros(n_nodes + 1, dtype=np.int64)
    indptr[1:] = np.cumsum(np.bincount(src, minlength=n_nodes))
    return indptr, dst


def cold_warm(fn):
    """(cold s, warm s, the warm result) of fn() ending on the device."""
    import torch

    t0 = time.time()
    fn()
    torch.cuda.synchronize()
    cold = time.time() - t0
    t0 = time.time()
    res = fn()
    torch.cuda.synchronize()
    return cold, time.time() - t0, res


def phase_graph_scale(dev, reps, db_timings):
    """Phase 7: the shapes of benches/graph_scale_bench.py through the
    entry points: PageRank and single-source SSSP (unit weights: the
    uniform scalar, the source array PageRank put on the card) on the
    LiveJournal-scale graph, LabelPropagation on the hub graph (the hub
    past COZO_TPU_LP_TIER_MAX takes the host lane every step); each cold
    and warm, then held to the plain versions.  Then phase 4 for the graph
    kernels at these shapes.  Returns their `kernels` entries and the
    launches of this path."""
    import torch

    from cozo_tpu_torch.ops import graph_algos as ga

    out = {"config": "benches/graph_scale_bench.py (BASELINE #3)",
           "reduced": []}
    n, e = LJ_NODES, LJ_EDGES
    t0 = time.time()
    ip, d = make_graph(n, e)
    ck = ga.graph_content_key(ip, d)
    w = np.ones(e, np.float32)
    hp, hd = make_hub_graph(HUB_NODES, HUB_EDGES, HUB_DEG)
    hck = ga.graph_content_key(hp, hd)
    out["datagen_s"] = time.time() - t0
    zero_graph_counts()
    out["pagerank_cold_s"], out["pagerank_warm_s"], pr = cold_warm(
        lambda: ga.pagerank_jax(ip, d, iterations=10, cache_key=ck))
    os.environ["COZO_TPU_SSSP_LOG"] = "1"
    try:
        out["sssp_cold_s"], out["sssp_warm_s"], sp = cold_warm(
            lambda: ga.sssp_device(ip, d, w, [0], cache_key=ck))
    finally:
        del os.environ["COZO_TPU_SSSP_LOG"]
    out["labelprop_cold_s"], out["labelprop_warm_s"], lab = cold_warm(
        lambda: ga.labelprop_jax(hp, hd, iterations=10, cache_key=hck))
    out["launches"] = graph_counts()
    say(f"phase 7 graph kernel launches: {out['launches']}")
    if min(out["launches"].values()) < 1:
        raise SystemExit("phase 7 failed: a graph kernel never launched")

    with plain_kernels():
        pr_p = ga.pagerank_jax(ip, d, iterations=10, cache_key=ck)
        sp_p = ga.sssp_device(ip, d, w, [0], cache_key=ck)
        lab_p = ga.labelprop_jax(hp, hd, iterations=10, cache_key=hck)
    l1, top = pagerank_agreement(torch.from_numpy(pr), torch.from_numpy(pr_p),
                                 n)
    out.update(nodes=n, edges=e, pagerank_l1=l1, pagerank_top100_same=top,
               pagerank_medges_per_s=10 * e / out["pagerank_warm_s"] / 1e6)
    ok = l1 <= PR_L1_TOL and top
    say(f"phase 7 PageRank (10 steps) on {n} nodes / {e} edges (datagen of "
        f"both graphs {out['datagen_s']:.1f}s): cold "
        f"{out['pagerank_cold_s']:.2f}s warm {out['pagerank_warm_s']:.3f}s "
        f"({out['pagerank_medges_per_s']:.0f} M edges/s); against the plain "
        f"version: L1 {l1:.3e}, top-100 same {top} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("phase 7 failed: PageRank")

    g = ga._sssp_ell_stage(ip, d, w, ck, dev, False)
    reached = int(np.isfinite(sp[0]).sum())
    same = (np.array_equal(sp[0], sp_p[0]) and np.array_equal(sp[1], sp_p[1])
            and reached == int(np.isfinite(sp_p[0]).sum()))
    steps = ga.sssp_ell_plain(g, [0], 512)[2]
    out.update(sssp_reached=reached, sssp_steps=steps, sssp_equal_plain=same,
               sssp_medges_per_s=steps * e / out["sssp_warm_s"] / 1e6)
    say(f"phase 7 SSSP from node 0 (unit weights): cold "
        f"{out['sssp_cold_s']:.2f}s warm {out['sssp_warm_s']:.3f}s, {steps} "
        f"steps, reached {reached} of {n}; distances and parents equal to "
        f"the plain version's {same} {'ok' if same else 'FAIL'}")
    if not same:
        raise SystemExit("phase 7 failed: SSSP")

    route = lp_route(hck, dev)
    same = bool(np.array_equal(lab, lab_p))
    out.update(hub_nodes=HUB_NODES, hub_edges=HUB_EDGES, hub_in_degree=HUB_DEG,
               labelprop_layout=route, labelprop_equal_plain=same,
               labelprop_communities=int(len(np.unique(lab))))
    ok = same and route.get("host_hubs", 0) >= 1
    say(f"phase 7 LabelPropagation (10 steps) on the hub graph, {HUB_NODES} "
        f"nodes / {HUB_EDGES} edges, hub in-degree {HUB_DEG}: the "
        f"{route['route']} layout, lanes (width, rows) {route['lanes']}, "
        f"host hubs {route.get('host_hubs', 0)}; cold "
        f"{out['labelprop_cold_s']:.2f}s warm {out['labelprop_warm_s']:.2f}s, "
        f"{out['labelprop_communities']} communities; labels equal to the "
        f"plain version's {same} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("phase 7 failed: LabelPropagation")
    lab_end = lab
    del sp, sp_p, pr, pr_p, lab, lab_p
    torch.cuda.empty_cache()
    lanes = db_timings["lp_lanes"] + time_lp_lanes(
        hck, HUB_NODES, lab_end, dev, reps, "hub graph (phase 7)")
    sssp = time_sssp(g, n, e, [0], "LiveJournal shape (phase 7)")
    sssp["db_graph"] = db_timings["sssp"]
    pagerank = time_pagerank(ga._pagerank_stage(ip, d, ck, dev), n, e, reps,
                             "LiveJournal shape (phase 7)")
    pagerank["db_graph"] = db_timings["pagerank"]
    kernels = [pagerank, sssp, time_lp_pick(hck, dev, reps, lanes)]
    out["card"] = smi_line()
    say("scale " + json.dumps(out))
    return kernels, out["launches"]


def pagerank_library_ms(staged, n, contrib, reps):
    """The yardstick, never called by the port: each step's incoming sums
    as one cuSPARSE product of the in-CSR of the real edges (int32
    indices, built outside the timed window) with the contributions, x
    10.  Returns the ms of the faster operand (1-D, a SpMV, or [n_pad,
    1]), its name and the ms of both."""
    import torch

    src_by_dst, in_ptr, out_deg = staged[:3]
    n_pad = out_deg.shape[0]
    e = int(in_ptr[n])
    crow = in_ptr.clone()
    crow[n + 1:] = e  # no padding edges: the dummy slot's row is empty
    with warnings.catch_warnings():  # CSR tensors are "beta" in torch
        warnings.simplefilter("ignore")
        a = torch.sparse_csr_tensor(
            crow, src_by_dst[:e].clone(),
            torch.ones(e, device=src_by_dst.device), size=(n_pad, n_pad),
            check_invariants=False)
        col = contrib[:, None].contiguous()
        times = {"1-D": cuda_ms(lambda: [a @ contrib for _ in range(10)],
                                reps),
                 "[n_pad, 1]": cuda_ms(lambda: [a @ col for _ in range(10)],
                                       reps)}
    best = min(times, key=times.get)
    return times[best], best, times


def pagerank_layout(staged, n, e, where):
    """The binned layout's size, bins and slices, and the time and
    transient memory of building it once more on the card."""
    import torch

    from cozo_tpu_torch.ops import graph_algos as ga

    dev = staged[0].device
    nbytes = sum(t.numel() * t.element_size() for t in staged[3:])
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.time()
    ga._pagerank_bins(staged[0], staged[1], n)
    torch.cuda.synchronize()
    build_ms = 1e3 * (time.time() - t0)
    peak = torch.cuda.max_memory_allocated(dev) - base
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    out = {"bin_nodes": ga.PR_BIN_NODES, "bins": len(staged[5]) - 1,
           "bytes": nbytes, "slices": sms, "edges_a_slice": e / sms,
           "build_ms": build_ms, "build_peak_bytes": peak}
    say(f"phase 4 graph_pagerank layout on the {where}: {out['bins']} bins "
        f"of {ga.PR_BIN_NODES} nodes, {nbytes} bytes ({nbytes / e:.2f} an "
        f"edge), the edge pass in {sms} slices (a block an SM) of "
        f"{e / sms:.0f} edges; built on the card in {build_ms:.1f} ms, "
        f"{peak / 1e9:.3f} GB at its peak above what was allocated")
    return out


def time_pagerank(staged, n, e, reps, where):
    """Phase 4 for graph_pagerank: 10 steps on a staged graph of n nodes
    and e edges, beside its bound, its plain version and the library's
    SpMV."""
    import torch

    from cozo_tpu_torch.ops import graph_algos as ga

    src_by_dst, in_ptr, out_deg = staged[:3]
    n_pad, e_pad = out_deg.shape[0], src_by_dst.shape[0]
    got = ga.pagerank_steps(*staged, n, 10, 0.85)
    again = ga.pagerank_steps(*staged, n, 10, 0.85)
    want = ga.pagerank_plain(*staged, n, 10, 0.85)
    err = float((got - want).abs().max())
    l1, top = pagerank_agreement(got, want, n)
    if not (l1 <= PR_L1_TOL and top and torch.equal(got, again)):
        raise SystemExit(f"phase 4 failed: graph_pagerank disagrees with "
                         f"plain on the {where}")
    layout = pagerank_layout(staged, n, e, where)
    ms = cuda_ms(lambda: ga.pagerank_steps(*staged, n, 10, 0.85), reps)
    plain_ms = cuda_ms(lambda: ga.pagerank_plain(*staged, n, 10, 0.85), 2)
    library_ms, operand, library_all = pagerank_library_ms(
        staged, n, want / torch.where(out_deg > 0, out_deg, 1.0), reps)
    # each step reads every real edge's source id and the in-CSR bounds,
    # reads the ranks and degrees and writes the ranks once
    nbytes = 10 * (4 * e + 4 * (n + 1) + 12 * n)
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, 10 * e / PEAK_F32 * 1e3
    bound = max(t_bytes, t_ops)
    # what the binned layout streams: a source id and a 2-byte offset an
    # edge, each step
    stream_ms = 10 * 6 * e / PEAK_BYTES * 1e3
    say(f"phase 4 graph_pagerank on the {where} (10 steps, n={n} e={e}): "
        f"{ms:.3f} ms ({10 * e / ms / 1e3:.0f} M edges/s, "
        f"{100 * bound / ms:.1f}% of the bound {bound:.3f} ms; the binned "
        f"edges' 6 B each at the memory rate {stream_ms:.3f} ms), plain "
        f"{plain_ms:.3f} ms, cuSPARSE SpMV x 10 {library_ms:.3f} ms "
        f"({operand} operand; {', '.join(f'{k} {v:.3f}' for k, v in library_all.items())}), "
        f"L1 {l1:.3e}, max_abs_err {err:.3e}, two runs identical")
    return {"name": "graph_pagerank", "route": "cuda",
            "source": "cozo_tpu_torch/csrc/graph_pagerank.cu",
            "replaces": "cozo_tpu/ops/graph_algos.py:70",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms, "library_operand": operand,
            "stream_ms": stream_ms, "layout": layout,
            "shape": {"where": where, "n": n, "e": e, "n_pad": n_pad,
                      "e_pad": e_pad, "steps": 10}}


def time_sssp(g, n, e, sources, where):
    """Phase 4 for graph_sssp: the whole solve (steps, flag reads,
    parents) from `sources` on a staged graph of n nodes and e edges,
    uniform weights, held to the plain version; then each step's route
    and frontier, and each step's time pushed and pulled."""
    import torch

    from cozo_tpu_torch.ops import _build
    from cozo_tpu_torch.ops import graph_algos as ga

    S = len(sources)
    got = ga.sssp_ell(g, sources, 512)
    want = ga.sssp_ell_plain(g, sources, 512)
    steps = want[2]
    fin = torch.isfinite(want[0])
    err = float((got[0][fin] - want[0][fin]).abs().max())
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
        raise SystemExit("phase 4 failed: graph_sssp disagrees with plain")
    ms = cuda_ms(lambda: ga.sssp_ell(g, sources, 512), 3)
    plain_ms = cuda_ms(lambda: ga.sssp_ell_plain(g, sources, 512), 1)
    # each step's route and frontier, then each step's device time under
    # the rule, pushed and pulled (the share's evidence), from the profiler
    lib = ga._bind_sssp(_build.load("graph_sssp"))
    stream = ga._stream(g.flat_src)
    fcount, fedges = (x.cpu().numpy() for x in ga._sssp_launch(
        lib, g, sources, 512, stream)[4])
    share = ga.SSSP_PUSH_SHARE
    routes = ["push" if fe.sum() <= share * e else "pull"
              for fe in fedges[:steps]]
    steps_ms, parent_ms, busy_ms = {}, {}, {}
    for route, forced in (("rule", share), *SSSP_FORCED_SHARES.items()):
        ks = kernel_times(lambda: ga._sssp_launch(lib, g, sources, 512,
                                                  stream, forced),
                          "seed_frontier")
        per_step = []
        for name, k_ms in ks:
            if "relax_first" in name:  # the first kernel of a step
                per_step.append(0.0)
            if any(k in name for k in ("relax_", "compact")):
                per_step[-1] += k_ms
        steps_ms[route] = np.round(per_step[:steps], 4).tolist()
        parent_ms[route] = sum(k for name, k in ks if "parent_" in name)
        busy_ms[route] = sum(k for _, k in ks)
    say(f"phase 4 graph_sssp steps on the {where}: frontier nodes "
        f"{fcount.sum(1).tolist()}, their out-edges {fedges.sum(1).tolist()},"
        f" routes at share {share} {routes}; device ms a step (the profiler)"
        f" under the rule {steps_ms['rule']}, pushed {steps_ms['push']}, "
        f"pulled {steps_ms['pull']}; the parent pass {parent_ms['rule']:.4f}"
        f" ms; all kernels of a solve {busy_ms['rule']:.4f} ms (pushed "
        f"{busy_ms['push']:.4f}, pulled {busy_ms['pull']:.4f})")
    # the full-pass bound: each step reads every real edge's source id
    # (uniform weights: no weight array), reads and writes each distance;
    # the parent pass reads the edges and the distances and writes the
    # parents
    nbytes = steps * (4 * e + 8 * n * S) + 4 * e + 8 * n * S
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = 2 * steps * e * S / PEAK_F32 * 1e3
    bound = max(t_bytes, t_ops)
    # the least any solve moves: each real edge once while relaxing and
    # each distance read and written once, then the parent pass's edges
    # and distances
    least = 2 * (4 * e + 8 * n * S) / PEAK_BYTES * 1e3
    say(f"phase 4 graph_sssp on the {where} (S={S}, {steps} steps, n={n} "
        f"e={e}, P={g.flat_src.shape[0]} slots): {ms:.3f} ms "
        f"({100 * bound / ms:.1f}% of the full-pass bound {bound:.3f} ms, "
        f"{100 * least / ms:.1f}% of the least bytes' {least:.3f} ms), "
        f"plain {plain_ms:.3f} ms, max_abs_err {err:.3e}")
    return {"name": "graph_sssp", "route": "cuda",
            "source": "cozo_tpu_torch/csrc/graph_sssp.cu",
            "replaces": "cozo_tpu/ops/graph_algos.py:633",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None,  # no single PyTorch call computes this
            "bound_least_ms": least,
            "shape": {"where": where, "n": n, "e": e, "S": S,
                      "steps": steps, "slots": int(g.flat_src.shape[0]),
                      "R_pad": g.R_pad},
            "steps": {"frontier": fcount.sum(1).tolist(),
                      "out_edges": fedges.sum(1).tolist(), "routes": routes,
                      "device_ms": steps_ms, "parent_ms": parent_ms,
                      "kernels_ms": busy_ms}}


def lp_lanes(cache_key, dev):
    """The pick inputs the device cache holds for a graph's label
    propagation: [(nb, w, idx, has_in)], one a lane (the dense layout:
    one, with idx None)."""
    from cozo_tpu_torch.ops import graph_algos as ga

    for key, val in ga._GRAPH_DEV_CACHE.items():
        if (key[0] not in ("lpd", "lph2") or key[1] != str(dev)
                or key[2][0] != cache_key):
            continue
        if key[0] == "lpd":
            return [(val[0], val[1], None, val[2])]
        return [(nb, w, idx, None) for nb, idx, w in val[1]]
    raise SystemExit("label propagation staged nothing on the device")


def lp_label_sets(n_real, ended, dev):
    """The labels a pick is timed at: random (seeded) and those a rule
    ended with (`ended` [n_real], converged communities), [n_pad] i32."""
    import torch

    from cozo_tpu_torch.ops import graph_algos as ga

    n_pad = ga._pad_pow2(n_real + 1)
    gen = torch.Generator(device=dev).manual_seed(8)
    rand = torch.randint(0, n_real, (n_pad,), dtype=torch.int32, device=dev,
                         generator=gen)
    conv = np.arange(n_pad, dtype=np.int32)
    conv[:n_real] = ended
    return {"random": rand, "converged": torch.from_numpy(conv).to(dev)}


def time_lp_lanes(cache_key, n_real, ended, dev, reps, where):
    """Phase 4 for graph_labelprop at every lane a rule met: one pick at
    random labels (seeded) and one at the labels the rule ended with
    (converged communities), each held to the plain version."""
    import torch

    from cozo_tpu_torch.ops import graph_algos as ga

    n_pad = ga._pad_pow2(n_real + 1)
    rows = []
    for nb, w, idx, has_in in lp_lanes(cache_key, dev):
        H, W = nb.shape
        valid = int((nb != n_pad - 1).sum() if w is None else (w > 0).sum())
        for kind, labels in lp_label_sets(n_real, ended, dev).items():
            got, want = labels.clone(), labels.clone()
            ga.lp_pick(labels, nb, w, idx, has_in, n_real, got)
            ga.lp_pick_plain(labels, nb, w, idx, has_in, n_real, want)
            if not torch.equal(got, want):
                raise SystemExit(f"phase 4 failed: graph_labelprop W={W} "
                                 f"{kind} disagrees with plain")
            ms = graph_ms(lambda: ga.lp_pick(labels, nb, w, idx, has_in,
                                             n_real, got), reps)
            # the rows' neighbour ids (and weights) and node ids, one label
            # gathered per valid slot, one label written per row
            nbytes = (4 * H * W * (1 if w is None else 2) + 8 * H
                      + 4 * valid)
            bound = nbytes / PEAK_BYTES * 1e3
            rows.append({"where": where, "W": W, "H": H, "valid": valid,
                         "labels": kind, "ms": ms, "bound_ms": bound})
            say(f"phase 4 graph_labelprop on the {where}: lane W={W} H={H} "
                f"({valid} valid slots), {kind} labels: {ms:.4f} ms "
                f"({100 * bound / ms:.1f}% of the bound {bound:.4f} ms), "
                f"equal to plain")
    return rows


def time_lp_pick(cache_key, dev, reps, lanes):
    """Phase 4 for graph_labelprop: one pick over the hub graph's lane of
    the most slots at random labels, with `lanes` (every lane of phases 6
    and 7 at random and converged labels) beside it."""
    import torch

    from cozo_tpu_torch.ops import graph_algos as ga

    nb, w, idx, _ = max(lp_lanes(cache_key, dev),
                        key=lambda lane: lane[0].numel())
    H, W = nb.shape
    n_pad = ga._pad_pow2(HUB_NODES + 1)
    gen = torch.Generator(device=dev).manual_seed(8)
    labels = torch.randint(0, HUB_NODES, (n_pad,), dtype=torch.int32,
                           device=dev, generator=gen)
    got, want = labels.clone(), labels.clone()
    ga.lp_pick(labels, nb, w, idx, None, HUB_NODES, got)
    ga.lp_pick_plain(labels, nb, w, idx, None, HUB_NODES, want)
    if not torch.equal(got, want):
        raise SystemExit("phase 4 failed: graph_labelprop disagrees with plain")
    ms = cuda_ms(lambda: ga.lp_pick(labels, nb, w, idx, None, HUB_NODES, got),
                 reps)
    plain_ms = cuda_ms(lambda: ga.lp_pick_plain(labels, nb, w, idx, None,
                                                HUB_NODES, want), 2)
    valid = int((nb != n_pad - 1).sum())
    # the rows' neighbour ids and node ids, one label gathered per valid
    # slot, one label written per row; a weighted mode needs no more than
    # one operation a slot
    nbytes = 4 * H * W + 4 * H + 4 * valid + 4 * H
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, valid / PEAK_F32 * 1e3
    bound = max(t_bytes, t_ops)
    say(f"phase 4 graph_labelprop (one pick, lane W={W} H={H}, {valid} "
        f"valid slots): {ms:.3f} ms ({100 * bound / ms:.1f}% of the bound "
        f"{bound:.4f} ms), plain {plain_ms:.3f} ms")
    return {"name": "graph_labelprop", "route": "cuda",
            "source": "cozo_tpu_torch/csrc/graph_labelprop.cu",
            "replaces": "cozo_tpu/ops/graph_algos.py:1174",
            "max_abs_err": float((got - want).abs().max()), "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None,  # no single PyTorch call computes this
            "shape": {"H": H, "W": W, "valid_slots": valid},
            "lanes": lanes}


# benches/bench_lsh_1m.py (BASELINE config #4): 1,000,000 short docs of
# 8-17 words over a 50,000-word vocabulary, 1,000 planted near-duplicates,
# `::lsh create` with 128 permutations at threshold 0.7
LSH_N, LSH_VOCAB, LSH_PLANTED = 1_000_000, 50_000, 1000
LSH_SINGLE, LSH_BATCHED = 200, 1000  # single queries; the batched join's
LSH_CHUNK = 32_768  # runtime/minhash_lsh.py's backfill chunk
LSH_N_PERM = 128
LSH_RECALL_BAR = 0.95  # the JAX package's runs on this data: 0.965 / 0.955
FTS_N, FTS_TERMS = 50_000, 10
# H100 SXM's integer issue rates, in lanes an SM a clock: the ALU pipe
# (xor, shift, min) and the FMA pipe (IMAD / IMUL) take 64 each (Hopper
# white paper: 16 INT32 lanes a sub-partition; Nsight Compute's pipe
# definitions put integer multiplies on the FMA pipe), and they run at the
# same time under the four schedulers' 128 lanes a clock in all
ALU_LANES_PER_SM, FMA_LANES_PER_SM, ISSUE_LANES_PER_SM = 64, 64, 128
SMS = 132
# fmix32(h ^ seed) and the min, a (token, permutation) pair: the seed xor,
# three shifts, three xors and the min on the ALU, two multiplies on FMA
MINHASH_ALU_OPS, MINHASH_FMA_OPS = 8, 2


def lsh_docs(n):
    """`benches/bench_lsh_1m.py`'s docs at n (a multiple of 16): 16
    streams spawned from default_rng(5), then docs[i] for i < 1,000 get a
    near-duplicate (the first word replaced) at n - 1,000 + i."""
    rng = np.random.default_rng(5)
    docs = []
    for br in rng.spawn(16):
        for _ in range(n // 16):
            n_words = 8 + int(br.integers(0, 10))
            docs.append(" ".join(f"w{int(w)}"
                                 for w in br.integers(0, LSH_VOCAB, n_words)))
    for i in range(LSH_PLANTED):
        words = docs[i].split()
        words[0] = "wDUP"
        docs[n - LSH_PLANTED + i] = " ".join(words)
    return docs


def lsh_host_chunks(docs, n_perm):
    """Per backfill chunk: (hashes, doc starts, host signatures), the
    signatures from the host `minhash_segments` over the chunk's
    `hash_tokens_dedup` hashes (the `Simple` tokenizer, n_gram 1), the
    chunks' numpy work spread over the host's cores."""
    from cozo_tpu_torch.fts.tokenizer import build_analyzer
    from cozo_tpu_torch.ops.minhash import hash_tokens_dedup, minhash_segments

    an = build_analyzer(("Simple", []), [])
    chunks = []
    for s in range(0, len(docs), LSH_CHUNK):
        toks = an.analyze_texts(docs[s:s + LSH_CHUNK])
        lens = np.fromiter((len(t) for t in toks), np.int64, len(toks))
        offs = np.zeros(len(toks), np.int64)
        np.cumsum(lens[:-1], out=offs[1:])
        chunks.append((hash_tokens_dedup([t for ts in toks for t in ts]),
                       offs))
    with ThreadPoolExecutor(os.cpu_count() or 1) as ex:
        sigs = ex.map(lambda c: minhash_segments(*c, n_perm), chunks)
        for (flat, offs), sig in zip(chunks, sigs):
            yield flat, offs, sig


def backfill_timer():
    """A context in which the LSH backfill's steps add their seconds to the
    dict it yields: `prepare` (a chunk's host half: extract, `tokenize`,
    `hash`, and `dispatch`: the upload and the launch queued) and `write`
    (the KV puts, `wait` for the signatures first)."""
    import contextlib

    from cozo_tpu_torch.fts.tokenizer import TextAnalyzer
    from cozo_tpu_torch.ops import minhash as mh
    from cozo_tpu_torch.runtime import minhash_lsh as ml

    targets = {"prepare": (ml, "_prepare_chunk"),
               "tokenize": (TextAnalyzer, "analyze_texts"),
               "hash": (mh, "hash_tokens_dedup"),
               "dispatch": (mh, "minhash_segments_dispatch"),
               "wait": (mh._SigFuture, "get"),
               "write": (ml, "_write_chunk")}
    spent = dict.fromkeys(targets, 0.0)

    def timed(key, fn):
        def run(*args, **kw):
            t = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                spent[key] += time.perf_counter() - t
        return run

    @contextlib.contextmanager
    def patched():
        saved = {k: getattr(obj, name) for k, (obj, name) in targets.items()}
        for k, (obj, name) in targets.items():
            setattr(obj, name, timed(k, saved[k]))
        try:
            yield spent
        finally:
            for k, (obj, name) in targets.items():
                setattr(obj, name, saved[k])

    return patched()


def stored_signatures(db, rel):
    """The `signature` bytes of every row of `rel` (an LSH index's
    inverse relation), by id, straight from the store."""
    from cozo_tpu_torch.data.functions import current_validity_ts

    tx = db._new_session(False, current_validity_ts())
    try:
        h = tx.get_relation(rel)
        return {row[0]: row[1] for row in h.scan_all(tx.store_tx_for(h))}
    finally:
        tx.abort()


def phase_lsh(n_docs=LSH_N):
    """Phase 8: `bench_lsh_1m.py` through `Db("mem")` (ingest, `::lsh
    create`, the serving image, single queries, the batched join), the
    stored signatures of every doc held to the host `minhash_segments`,
    then `::fts create` and single-term searches on FTS_N of the docs held
    to a scan.  Returns (the segment-min launches of the build, the first
    full chunk's hashes and doc starts, the `lsh` line's dict)."""
    from cozo_tpu_torch import Db
    from cozo_tpu_torch.ops import minhash as mh
    from cozo_tpu_torch.utils import fallback

    out = {"n_docs": n_docs, "n_perm": LSH_N_PERM, "target_threshold": 0.7}
    t0 = time.time()
    docs = lsh_docs(n_docs)
    out["docgen_s"] = time.time() - t0
    db = Db("mem")
    db.run_script(":create doc {id: Int => body: String}")
    t0 = time.time()
    for s in range(0, n_docs, INGEST_BATCH):
        rows = [[i, docs[i]] for i in range(s, min(s + INGEST_BATCH, n_docs))]
        db.run_script("?[id, body] <- $rows :put doc {id => body}",
                      {"rows": rows})
    out["ingest_s"] = time.time() - t0
    out["ingest_docs_per_s"] = n_docs / out["ingest_s"]
    mh.segment_min.launches = 0
    with backfill_timer() as spent:
        t0 = time.time()
        db.run_script("::lsh create doc:sim {extractor: body, "
                      f"tokenizer: Simple, n_perm: {LSH_N_PERM}, "
                      "target_threshold: 0.7}")
        out["build_s"] = time.time() - t0
    launches = mh.segment_min.launches
    out["build_steps_s"] = {
        "scan, commit, rest": out["build_s"] - spent["prepare"]
        - spent["write"],
        "extract": spent["prepare"] - spent["tokenize"] - spent["hash"]
        - spent["dispatch"],
        "tokenize": spent["tokenize"], "hash": spent["hash"],
        "dispatch": spent["dispatch"], "wait": spent["wait"],
        "kv puts": spent["write"] - spent["wait"]}
    out["build_docs_per_s"] = n_docs / out["build_s"]
    out["segment_min_launches"] = launches
    say(f"phase 8 lsh: {n_docs:,} docs generated in {out['docgen_s']:.1f}s, "
        f"ingest {out['ingest_s']:.1f}s ({out['ingest_docs_per_s']:,.0f} "
        f"docs/s), ::lsh create {out['build_s']:.1f}s "
        f"({out['build_docs_per_s']:,.0f} docs/s), {launches} minhash "
        f"launches; build steps (s): "
        + ", ".join(f"{k} {v:.2f}" for k, v in out["build_steps_s"].items()))
    chunks = -(-n_docs // LSH_CHUNK)
    if launches < chunks - 1:
        raise SystemExit(f"phase 8 failed: {launches} minhash launches for "
                         f"{chunks} backfill chunks")

    single = "?[id] := ~doc:sim{id | query: $q, k: 5}"
    fb0 = fallback.counts().get("lsh.serving_image", 0)
    t0 = time.time()
    db.run_script(single, {"q": docs[0]})
    out["serving_image_s"] = time.time() - t0
    t0 = time.time()
    hits = 0
    for i in range(LSH_SINGLE):
        res = db.run_script(single, {"q": docs[i]})
        hits += (n_docs - LSH_PLANTED + i) in {r[0] for r in res.rows}
    el = time.time() - t0
    out["query_qps"] = LSH_SINGLE / el
    out["planted_dup_recall"] = hits / LSH_SINGLE
    db.run_script(":create q {qid: Int => body: String}")
    db.run_script("?[qid, body] <- $rows :put q {qid => body}",
                  {"rows": [[i, docs[i]] for i in range(LSH_BATCHED)]})
    join = "?[qid, id] := *q{qid, body}, ~doc:sim{id | query: body, k: 5}"
    db.run_script(join)  # warm
    t0 = time.time()
    res = db.run_script(join)
    el_b = time.time() - t0
    pairs = {(r[0], r[1]) for r in res.rows}
    bhits = sum((i, n_docs - LSH_PLANTED + i) in pairs
                for i in range(LSH_BATCHED))
    out["batched_join_qps"] = LSH_BATCHED / el_b
    out["batched_join_recall"] = bhits / LSH_BATCHED
    out["fallbacks"] = fallback.counts()
    fired = out["fallbacks"].get("lsh.serving_image", 0) - fb0
    say(f"phase 8 lsh: serving image {out['serving_image_s']:.1f}s, "
        f"{LSH_SINGLE} single queries {out['query_qps']:.1f} QPS, recall "
        f"{out['planted_dup_recall']:.3f}; batched join of {LSH_BATCHED} "
        f"{out['batched_join_qps']:.1f} QPS ({len(res.rows)} rows), recall "
        f"{out['batched_join_recall']:.3f} (bar {LSH_RECALL_BAR}); "
        f"fallbacks {out['fallbacks']}")
    if min(out["planted_dup_recall"], out["batched_join_recall"]) \
            < LSH_RECALL_BAR:
        raise SystemExit("phase 8 failed: planted-duplicate recall below "
                         "its bar")
    if fired:
        raise SystemExit("phase 8 failed: the LSH serving image fell back")

    t0 = time.time()
    stored = stored_signatures(db, "doc:sim:inv")
    first = None
    d = bad = 0
    for flat, offs, sigs in lsh_host_chunks(docs, LSH_N_PERM):
        if first is None:
            first = (flat, offs)
        for row in sigs:
            bad += stored.get(d) != row.tobytes()
            d += 1
    out["signatures_checked"] = d
    out["signatures_equal"] = d - bad
    say(f"phase 8 lsh: stored signatures equal to the host minhash_segments "
        f"for {d - bad:,} of {d:,} docs ({len(stored):,} stored; "
        f"{time.time() - t0:.1f}s)")
    if bad or d != n_docs or len(stored) != n_docs:
        raise SystemExit("phase 8 failed: stored signatures differ from the "
                         "host minhash_segments")
    del db, stored

    fts = docs[:FTS_N]
    db = Db("mem")
    db.run_script(":create ftdoc {id: Int => body: String}")
    for s in range(0, FTS_N, INGEST_BATCH):
        rows = [[i, fts[i]] for i in range(s, min(s + INGEST_BATCH, FTS_N))]
        db.run_script("?[id, body] <- $rows :put ftdoc {id => body}",
                      {"rows": rows})
    t0 = time.time()
    db.run_script("::fts create ftdoc:ft {extractor: body, tokenizer: Simple}")
    out["fts_build_s"] = time.time() - t0
    words = [d.split() for d in fts]
    terms = [words[i * (FTS_N // FTS_TERMS)][1] for i in range(FTS_TERMS)]
    matched, t_search = [], 0.0
    for term in terms:
        want = {i for i, ws in enumerate(words) if term in ws}
        t0 = time.time()
        res = db.run_script(
            f"?[id] := ~ftdoc:ft{{id | query: '{term}', k: {len(want) + 10}}}")
        t_search += time.time() - t0
        got = {r[0] for r in res.rows}
        matched.append(len(want))
        if got != want:
            raise SystemExit(f"phase 8 failed: FTS '{term}' found "
                             f"{len(got)} ids, the scan {len(want)}")
    out["fts_terms"] = dict(zip(terms, matched))
    out["fts_search_ms"] = t_search / FTS_TERMS * 1e3
    say(f"phase 8 fts: {FTS_N:,} docs, ::fts create {out['fts_build_s']:.1f}s, "
        f"{FTS_TERMS} single-term searches ({out['fts_search_ms']:.2f} ms "
        f"each) equal to the scan, matches {matched}")
    out["card"] = smi_line()
    say("lsh " + json.dumps(out))
    return launches, first, out


def sm_clock_mhz():
    """The card's maximum SM clock as nvidia-smi reports it."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True)
    return float(smi.stdout.strip().splitlines()[0])


def time_minhash(first, launches, reps):
    """Phase 4 for minhash at the build's shape: the first full backfill
    chunk, with the upload and the copy back of a chunk beside it."""
    import torch

    from cozo_tpu_torch.ops import minhash as mh

    flat, offs = first
    T, D, n_perm = len(flat), len(offs), LSH_N_PERM
    dev = torch.device("cuda")
    h_pin = torch.from_numpy(flat.view(np.int32)).pin_memory()
    o_pin = torch.from_numpy(offs).pin_memory()
    h, o = h_pin.to(dev), o_pin.to(dev)
    out = torch.empty((D, n_perm), dtype=torch.int32, device=dev)
    host = torch.empty((D, n_perm), dtype=torch.int32, pin_memory=True)
    mh.segment_min(h, o, n_perm, out)
    want = mh.segment_min_plain(h, o, n_perm)
    err = float((mh._as_u32_i64(out) - mh._as_u32_i64(want)).abs().max())
    if err:
        raise SystemExit("phase 4 failed: minhash disagrees with plain")
    ms = cuda_ms(lambda: mh.segment_min(h, o, n_perm, out), reps * 4)
    plain_ms = cuda_ms(lambda: mh.segment_min_plain(h, o, n_perm), 2)
    upload_ms = cuda_ms(lambda: (h_pin.to(dev, non_blocking=True),
                                 o_pin.to(dev, non_blocking=True)), reps)
    back_ms = cuda_ms(lambda: host.copy_(out, non_blocking=True), reps)
    # operations: the busiest of the ALU pipe, the FMA pipe and the issue
    # of all 10 per pair; bytes: each hash and doc start read once, each
    # signature written once
    clock = sm_clock_mhz()
    pairs = T * n_perm
    sm_clocks = {
        "alu": MINHASH_ALU_OPS / ALU_LANES_PER_SM,
        "fma": MINHASH_FMA_OPS / FMA_LANES_PER_SM,
        "issue": (MINHASH_ALU_OPS + MINHASH_FMA_OPS) / ISSUE_LANES_PER_SM}
    pipe = max(sm_clocks, key=sm_clocks.get)
    t_ops = pairs * sm_clocks[pipe] / (SMS * clock * 1e6) * 1e3
    nbytes = 4 * T + 8 * D + 4 * D * n_perm
    t_bytes = nbytes / PEAK_BYTES * 1e3
    bound = max(t_bytes, t_ops)
    say(f"phase 4 minhash (the first backfill chunk: T={T} D={D} "
        f"n_perm={n_perm}): {ms:.4f} ms ({100 * bound / ms:.1f}% of the bound "
        f"{bound:.4f} ms: operations {t_ops:.4f} on the {pipe} pipe, "
        f"{pairs} pairs x {sm_clocks[pipe]:.4f} SM clocks / ({SMS} SMs x "
        f"{clock:.0f} MHz), bytes {t_bytes:.4f}), plain {plain_ms:.3f} ms, "
        f"upload {upload_ms:.4f} ms and copy back {back_ms:.4f} ms a chunk, "
        f"max_abs_err {err:.0f}")
    return {"name": "minhash", "route": "cuda",
            "source": "cozo_tpu_torch/csrc/minhash.cu",
            "replaces": "cozo_tpu/ops/minhash.py:209",
            "launches": launches,
            "launches_by_path": {"lsh build (phase 8)": launches},
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None,  # no single PyTorch call computes this
            "upload_ms": upload_ms, "copy_back_ms": back_ms,
            "shape": {"T": T, "D": D, "n_perm": n_perm,
                      "sm_clock_mhz": clock, "bound_pipe": pipe}}


def phase_quant_wide():
    """Phase 3b: the quant lane at its own width."""
    import torch

    from cozo_tpu_torch.ops.quant_knn import QuantSweepTable, quant_search
    from cozo_tpu_torch.ops.vector_search import brute_force_knn
    from cozo_tpu_torch.utils.datasets import glove_like

    say(f"quant cut: {QUANT_N:,} rows instead of 10,000,000")
    t0 = time.time()
    data = glove_like(QUANT_N + QUANT_NQ, QUANT_D, seed=43)
    qs, data = data[QUANT_N:], data[:QUANT_N]
    say(f"phase 3b datagen {QUANT_N} + {QUANT_NQ} x {QUANT_D} in "
        f"{time.time() - t0:.1f}s")
    t0 = time.time()
    table = QuantSweepTable().load(data, "Cosine")
    torch.cuda.synchronize()
    load_s = time.time() - t0
    quant_search(data, table, qs, K)  # warm
    qps = []
    for _ in range(OTHER_LANE_REPS):
        t0 = time.time()
        ids, dists = quant_search(data, table, qs, K)
        qps.append(QUANT_NQ / (time.time() - t0))
    scan_s, rerank_s = quant_search.last_timing
    norms = np.concatenate([
        np.einsum("nd,nd->n", blk, blk) for blk in np.array_split(data, 16)])
    gt = np.concatenate([
        brute_force_knn(data, norms, qs[b0:b0 + 512], K, "Cosine")[0]
        for b0 in range(0, QUANT_GT, 512)])
    torch.cuda.empty_cache()
    r = recall(ids[:QUANT_GT], gt)
    ok = (ids.shape == (QUANT_NQ, K) and np.isfinite(dists).all()
          and (np.diff(dists, axis=1) >= -1e-6).all() and r >= BARS["quant"])
    say(f"phase 3b quant lane {QUANT_N} x {QUANT_D} cosine (int8 table "
        f"{table.tbl.numel() / 1e9:.2f} GB on the device, load {load_s:.1f}s): "
        f"B={QUANT_NQ} median {np.median(qps):.1f} QPS min {min(qps):.1f} "
        f"(last rep: device scan + pull {scan_s:.3f}s, host re-rank "
        f"{rerank_s:.3f}s) recall@10 {r:.5f} on {QUANT_GT} queries against "
        f"brute_force_knn (bar {BARS['quant']}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("phase 3b failed: quant lane")


def phase_i8_build(data, qs):
    """Phase 3c: the int8 build against the f32 build of the same rows."""
    import torch

    from cozo_tpu_torch import HnswIndex
    from cozo_tpu_torch.ops.vector_search import brute_force_knn

    rows, q = data[:I8_BUILD_N], qs[:256]
    norms = np.einsum("nd,nd->n", rows, rows, dtype=np.float64)
    gt, _ = brute_force_knn(rows, norms, q, K, "Cosine")
    res = {}
    for mode, budget in (("i8", "1"), ("f32", None)):
        if budget:
            os.environ["COZO_TPU_F32_TABLE_MAX"] = budget
        try:
            t0 = time.time()
            index = HnswIndex(dim=D, m=16, ef_construction=200,
                              distance="Cosine")
            index.bulk_build(rows, wave=8192)
            torch.cuda.synchronize()
            build_s = time.time() - t0
            served = None
            if mode == "i8":  # the build's table serves, through the dispatcher
                qt = index._quant_sweep
                ids_s, _ = index.search(qs[:256], K, 64)
                gt_s, _ = brute_force_knn(rows, norms, qs[:256], K, "Cosine")
                served = (qt is not None and index._quant_sweep is qt
                          and index._quant_sweep_version == index.version
                          and index._sweep_table is None
                          and recall(ids_s, gt_s) > 0.95)
        finally:
            os.environ.pop("COZO_TPU_F32_TABLE_MAX", None)
        ids_h, _ = index.search(q, K, 64, use_tpu=False)
        res[mode] = (recall(ids_h, gt), build_s, served)
        say(f"phase 3c {mode} build of {I8_BUILD_N} x {D}: {build_s:.1f}s, host "
            f"search recall@10 {res[mode][0]:.4f} against exact"
            + (f", QuantSweepTable installed and serving {served}"
               if mode == "i8" else ""))
    ok = res["i8"][0] >= res["f32"][0] - 0.01 and res["i8"][2] is True
    say(f"phase 3c i8 graph at most 0.01 below the f32 graph: "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("phase 3c failed: int8 build")


def time_route(qb, tbl, bias, launches, reps, what):
    """Phase 4 for one route: agreement at the timed shape, then the
    kernel's, the plain version's and the yardstick's device time beside
    the bound.  Returns the route's entry of the `kernels` line."""
    import torch

    from cozo_tpu_torch.ops import fused_sweep as fs

    B, d_pad = qb.shape
    n_total = tbl.shape[0]
    out_w = 2 * (n_total // fs.SEG)
    route = fs.route(B, n_total, d_pad)

    out_k = fs.fused_sweep(qb, tbl, bias)
    out_again = fs.fused_sweep(qb, tbl, bias)
    out_p = fs.fused_sweep_plain(qb, tbl, bias)
    same_twice = bool(torch.equal(out_k, out_again))
    c = compare_fused(out_k, out_p, n_total, 0)
    del out_k, out_again, out_p
    say_agreement(f"phase 4 fused_sweep[{route}] vs plain at {what} B={B} "
                  f"n_total={n_total} d_pad={d_pad} two runs identical "
                  f"{same_twice}", c)
    if not (agreement_ok(c) and same_twice):
        raise SystemExit("phase 4 failed: kernel disagrees with plain")

    torch.cuda.empty_cache()
    ms = cuda_ms(lambda: fs.fused_sweep(qb, tbl, bias), reps)
    plain_ms = cuda_ms(lambda: fs.fused_sweep_plain(qb, tbl, bias), 2)
    torch.cuda.empty_cache()
    # yardstick only, never called by the port: the bf16 product alone
    library_ms = cuda_ms(lambda: torch.mm(qb, tbl.T), 2)
    torch.cuda.empty_cache()

    flops = 2.0 * B * n_total * d_pad
    nbytes = B * d_pad * 2 + n_total * d_pad * 2 + n_total * 4 + B * out_w * 4
    t_ops, t_bytes = flops / PEAK_BF16 * 1e3, nbytes / PEAK_BYTES * 1e3
    bound = max(t_ops, t_bytes)
    say(f"phase 4 fused_sweep[{route}]: {ms:.3f} ms "
        f"({flops / ms / 1e9:.1f} TFLOP/s, {100 * bound / ms:.1f}% of the "
        f"bound {bound:.3f} ms), plain {plain_ms:.3f} ms, "
        f"torch.mm bf16 {library_ms:.3f} ms")
    return {
        "name": f"fused_sweep[{route}]", "route": "cuda",
        "source": "cozo_tpu_torch/csrc/fused_sweep.cu",
        "replaces": "cozo_tpu/ops/pallas_sweep.py:126",
        "launches": launches[route],
        "max_abs_err": c["err"], "ids_agree": c["ids"],
        "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound,
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": library_ms,
        "shape": {"B": B, "n_total": n_total, "d_pad": d_pad},
    }


def main_path_inputs(index, qs):
    """The kernel's inputs as `SweepTable.search` makes them."""
    import torch

    st = index._sweep_table
    tbl, bias = st.tbl_fused, st.bias_fused
    q = qs / np.linalg.norm(qs, axis=1, keepdims=True)
    qb = torch.zeros((NQ, st.d_pad), dtype=torch.float32, device=tbl.device)
    qb[:, :D] = torch.from_numpy(q.astype(np.float16)).to(tbl.device).float()
    return qb.to(torch.bfloat16), tbl, bias


def synthetic_main_shape(dev):
    """Random unit rows at the main-path shape (for --kernels-only)."""
    import torch

    n_total = -(-N // 131_072) * 131_072
    qb, tbl, bias = random_case(NQ, n_total, 128, n_total - N, dev, seed=1)
    tbl = torch.nn.functional.normalize(tbl.float(), dim=1).to(torch.bfloat16)
    qb = torch.nn.functional.normalize(qb.float(), dim=1).to(torch.bfloat16)
    return qb, tbl, bias


def time_beam(index, qs, launches):
    """Phase 4 for `beam_search` on the full index at B = 16 and B = 63:
    agreement, the kernel's and the plain version's time, and the bound
    from the run's own counters.  Returns its entry of the `kernels` line
    (the B = 16 numbers; B = 63 beside them)."""
    import torch

    from cozo_tpu_torch.ops import vector_search as vs

    trip_ms = vs.memory_round_trip_ms()
    say(f"phase 4 one dependent device-memory load: {trip_ms * 1e6:.0f} ns")
    shapes = {}
    for B in (16, 63):
        args = beam_args(index, qs[:B], K, 64)
        vectors, nb0, up_nb = args[0], args[1], args[2]
        d, m0, m_up = vectors.shape[1], nb0.shape[1], up_nb.shape[2]
        out_k = vs.beam_search(*args)
        stats = vs.beam_search.last_stats.cpu().numpy().astype(np.int64)
        out_again = vs.beam_search(*args)
        out_p = vs.beam_search_plain(*args)
        same_twice = all(torch.equal(a, b) for a, b in zip(out_k, out_again))
        c = compare_beam(out_k, out_p, args[3])
        if not (beam_ok(c) and same_twice):
            raise SystemExit("phase 4 failed: beam_search disagrees with plain")
        ms = cuda_ms(lambda: vs.beam_search(*args), 20)
        plain_ms = cuda_ms(lambda: vs.beam_search_plain(*args), 2)
        steps, rounds, rows, lists = stats.sum(0).tolist()
        # bytes this run's data needs: the rows scored, the neighbour lists
        # read (upper-level lists are m_up wide), queries in, results out
        nbytes = (rows * d * 4 + (lists - steps) * m0 * 4 + steps * m_up * 4
                  + B * d * 4 + B * K * 8)
        t_bytes = nbytes / PEAK_BYTES * 1e3
        t_ops = 4.0 * rows * d / PEAK_F32 * 1e3
        bound = max(t_bytes, t_ops)
        # beside it: the longest query's chain of dependent rounds, each at
        # least one trip for its lists and one for its rows
        chain = int((stats[:, 0] + stats[:, 1]).max())
        chain_ms = 2 * chain * trip_ms
        longest = int((stats[:, 0] + stats[:, 1]).argmax())
        say(f"phase 4 beam_search B={B} (n_pad={vectors.shape[0]} d={d} "
            f"m0={m0} beam={args[7]} expand={args[11]}): {ms:.4f} ms, plain "
            f"{plain_ms:.2f} ms; ids {c['ids']:.6f} rows exact "
            f"{c['rows_exact']:.4f} max_abs_err {c['err']:.3e}; descent steps "
            f"{steps} rounds {rounds} rows {rows} lists {lists}; bound "
            f"{bound:.5f} ms (bytes {t_bytes:.5f}, operations {t_ops:.5f}); "
            f"chain of {chain} dependent rounds x 2 trips = {chain_ms:.4f} ms "
            f"({'the chain' if chain_ms > bound else 'the bound'} is larger); "
            f"the longest query: {int(stats[longest, 0])} descent steps + "
            f"{int(stats[longest, 1])} rounds, {ms * 1e3 / chain:.2f} us a "
            f"step if the launch were all its")
        shapes[B] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                     "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                     "chain_ms": chain_ms, "max_abs_err": c["err"],
                     "ids_agree": c["ids"], "rows": rows, "rounds": rounds,
                     "descent_steps": steps, "chain_steps": chain,
                     "us_per_step": ms * 1e3 / chain}
    main = shapes[16]
    return {
        "name": "beam_search", "route": "cuda",
        "source": "cozo_tpu_torch/csrc/beam_search.cu",
        "replaces": "cozo_tpu/ops/vector_search.py:81",
        "launches": launches["beam_search"] + launches["beam_search_db"],
        "launches_by_path": {"db (phase 5)": launches["beam_search_db"],
                             "index (phase 3)": launches["beam_search"]},
        "max_abs_err": main["max_abs_err"], "ids_agree": main["ids_agree"],
        "ms": main["ms"], "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
        "library_ms": None,  # no single PyTorch call computes this function
        "chain_ms": main["chain_ms"], "memory_round_trip_ms": trip_ms,
        "shape": {"B": 16, "n_pad": int(index._dev_cache["n_pad"]), "d": D,
                  "beam": 64, "expand": 8, "k": K},
        "B63": shapes[63],
    }


def phase_beam_quick(n):
    """For --kernels-only: `beam_search` timed on a built index of `n`
    rows (past the 50 MB L2: the rows alone are 105 MB), the kernel as in
    phase 4 and the call around it as in phase 3."""
    from cozo_tpu_torch import HnswIndex
    from cozo_tpu_torch.ops import vector_search as vs
    from cozo_tpu_torch.utils.datasets import glove_like

    data = glove_like(n + 64, D, seed=42)
    qs, data = data[n:], data[:n]
    t0 = time.time()
    index = HnswIndex(dim=D, m=16, ef_construction=200, distance="Cosine")
    index.bulk_build(data, wave=8192)
    say(f"beam_search index for the quick timing: {n} x {D} built in "
        f"{time.time() - t0:.1f}s")
    entry = time_beam(index, qs, {"beam_search": 0, "beam_search_db": 0})
    for B in (16, 1, 4, 63):
        index.search(qs[:B], K, 64, use_tpu=True)
        lat = []
        for _ in range(20):
            t0 = time.perf_counter()
            index.search(qs[:B], K, 64, use_tpu=True)
            lat.append((time.perf_counter() - t0) * 1e3)
        args = beam_args(index, qs[:B], K, 64)
        kernel_ms = cuda_ms(lambda: vs.beam_search(*args), 20)
        say(f"quick beam search B={B}: search(k=10, ef=64) median "
            f"{np.median(lat):.3f} ms min {min(lat):.3f} ms per call, the "
            f"kernel alone {kernel_ms:.4f} ms, the call around it "
            f"{np.median(lat) - kernel_ms:.3f} ms")
    return entry


def phase_kernel_timing(main_inputs, launches, reps, dev):
    kernels = [time_route(*main_inputs, launches, reps, "the main-path shape")]
    B, n_total, d_pad, dead = PHASE2_SHAPES[-1]
    kernels.append(time_route(*random_case(B, n_total, d_pad, dead, dev),
                              launches, reps, "a wide-row shape"))
    return kernels


def graph_only(args, dev):
    """--graph-only: the loop for work on the graph kernels."""
    from cozo_tpu_torch.utils.datasets import glove_like

    t0 = time.time()
    phase_graph_vs_plain(dev)
    data = glove_like(args.n + NQ, D, seed=42)
    qs, data = data[args.n:], data[:args.n]
    db = phase_db(data, qs)[0]
    launches, db_timings = phase_graph_db(db, dev, args.reps)
    del db
    kernels, scale = phase_graph_scale(dev, args.reps, db_timings)
    for entry in kernels:
        count_graph_launches(entry, {"db graph (phase 6)": launches,
                                     "scale (phase 7)": scale})
    say(f"total {time.time() - t0:.1f}s")
    say(json.dumps({"kernels": kernels}))
    say(smi_line())
    say("graph-only run: no verdict on the main path")
    return 0


def lsh_only(args):
    """--lsh-only: the loop for work on the MinHash kernel and the text
    indexes."""
    t0 = time.time()
    launches, first, _ = phase_lsh()
    kernels = [time_minhash(first, launches, args.reps)]
    say(f"total {time.time() - t0:.1f}s")
    say(json.dumps({"kernels": kernels}))
    say(smi_line())
    say("lsh-only run: no verdict on the main path")
    return 0


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=N,
                    help=f"table rows on the main path (>= {MIN_N})")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--kernels-only", action="store_true",
                    help="skip the main path (phase 3); time the kernels "
                         "on a random table of the main-path shape")
    ap.add_argument("--graph-only", action="store_true",
                    help="build the kernels, hold the graph kernels to "
                         "their plain versions, then phase 5 on a Db of "
                         "--n rows, phases 6 and 7 and the graph kernels' "
                         "timings; no verdict")
    ap.add_argument("--lsh-only", action="store_true",
                    help="build the kernels, hold the MinHash kernel to its "
                         "plain version, then phase 8 (the text indexes) "
                         "and the MinHash timing; no verdict")
    args = ap.parse_args()
    if args.n < MIN_N:
        ap.error(f"--n must be at least {MIN_N}")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from cozo_tpu_torch import default_device

    dev = default_device()
    say(f"device: {torch.cuda.get_device_name(0)} "
        f"(torch {torch.__version__}, CUDA {torch.version.cuda})")
    if args.n != N:
        say(f"main path cut: {args.n} rows instead of {N}")

    t_all = time.time()
    phase_build()
    if args.graph_only:
        return graph_only(args, dev)
    phase_minhash_vs_plain(dev)
    if args.lsh_only:
        return lsh_only(args)
    phase_kernel_vs_plain(dev)
    phase_beam_vs_plain()
    phase_graph_vs_plain(dev)
    lap = lambda what: say(f"[{time.time() - t_all:.1f}s] {what} done")  # noqa: E731
    lap("phases 1-2")
    if args.kernels_only:
        from cozo_tpu_torch.ops import fused_sweep as fs

        say("main path skipped (--kernels-only)")
        main_inputs = synthetic_main_shape(dev)
        launches = dict.fromkeys(fs.ROUTES, 0)
    else:
        from cozo_tpu_torch.utils.datasets import glove_like

        t0 = time.time()
        data = glove_like(args.n + NQ, D, seed=42)
        qs, data = data[args.n:], data[:args.n]
        say(f"datagen {args.n} + {NQ} x {D} in {time.time() - t0:.1f}s")
        db, index, build_s, db_launches = phase_db(data, qs)
        lap("phase 5")
        db_graph_launches, db_timings = phase_graph_db(db, dev, args.reps)
        graph_launches = {"db graph (phase 6)": db_graph_launches}
        del db
        lap("phase 6 and its timings")
        launches = phase_main(index, qs, build_s, args.reps)
        launches["beam_search_db"] = db_launches
        main_inputs = main_path_inputs(index, qs)
    kernels = phase_kernel_timing(main_inputs, launches, args.reps, dev)
    if args.kernels_only:
        kernels.append(phase_beam_quick(MIN_N))
    else:
        kernels.append(time_beam(index, qs, launches))
        del main_inputs, index
        torch.cuda.empty_cache()
        lap("phases 3 and 4 (main path)")
        phase_i8_build(data, qs)
        del data
        phase_quant_wide()
        lap("phases 3b and 3c")
        graph_kernels, graph_launches["scale (phase 7)"] = phase_graph_scale(
            dev, args.reps, db_timings)
        lap("phase 7 and its timings")
        for entry in graph_kernels:
            count_graph_launches(entry, graph_launches)
        kernels += graph_kernels
        lsh_launches, first_chunk, _ = phase_lsh()
        kernels.append(time_minhash(first_chunk, lsh_launches, args.reps))
    say(f"total {time.time() - t_all:.1f}s")
    say(json.dumps({"kernels": kernels}))
    say(smi_line())
    if args.kernels_only:
        say("kernels-only run: no verdict on the main path")
        return 0
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
