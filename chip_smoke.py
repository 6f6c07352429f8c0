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
     two runs bit-identical.  `slab_topk` (`topk_cases`): each variant
     (the prologue of the f32 / bf16 lanes, the int8 build, the i8 lane
     with its bf16 key, the quant lane, the fused lane's packed array, a
     bf16 merge) at widths 512, 4,097, 10,240, 16,384 and 131,072, kf 1,
     10, 26, 40, 97, 256, 1,000 and the width, B = 1 and 17 and a ragged
     block of launches (300 rows, kf = 131,072), with planted ties, +-0.0,
     a row all -inf, a row with fewer live entries than kf and a bf16 key
     slab from int8 products; ascending and descending keys and the best
     in the last columns at widths 512 and 131,072; the merges' widths 260
     and 970: values and ids bit-equal to the plain version, two runs
     bit-identical.  `sweep_topk` (`sweep_cases`): bf16 and int8 at every
     row state, piece width, d_pad 16-4,096 and variant; its f32 kind
     (`SWEEP_F32_CASES`: kc 1-256, d_pad 16-4,096, ragged B, dead columns,
     +-0.0) within 1e-5 of the plain version (cuBLAS's f32 product and the
     plain selection), the cases bit-equal to it counted;
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
  11. (a and d run after phase 6, on phase 5's Db; b, c, e and f after
     phase 8) the hosts: (a) the Db served in process, in turns through
     a server with the heap unfrozen over the index's list maps and
     through `hosts/server.serve`: PageRank over HTTP (a large answer)
     bit-equal to the direct call's, the heap by owner right after it,
     then 8 client threads x 20 small joins (B = 16, the beam kernel) as
     `/text-query` with no collection before them, each answer's rows
     equal to the Db's own, request ms p50 / p99 / max and the collector's
     passes, then one timed full pass (through `serve`, no pass while the
     answer is built, in the burst or after it may reach GC_PASS_BAR_MS);
     the served turn's requests' launches counted apart from the direct
     calls (the beam kernel once a small join, PageRank at least once);
     an SSE `/changes/{rel}` stream carrying a `:put`; a write over HTTP
     after serving started; (d)
     `utils/profiling.device_trace` around a small join writes a Chrome
     trace that names the beam kernel and holds the primer's kernels
     (`device_trace` refuses one without); (b) `python -m
     cozo_tpu_torch.hosts.server` with no `--device` answers `GET /` and
     a text query on the card, and `python -m cozo_tpu_torch.hosts.repl`
     prints for a script (create, put, an index, a `~` search, `%backup`)
     what it prints with `--device cpu`, banner aside; (c) the port's
     `libcozo_c.so` and the unchanged `native/example_c_host.c` against
     it print C_ABI_OK, and `c_bridge.open_db` with "" options opens a Db
     on the card; (e) each of `cozo_tpu_torch/examples/` prints on the
     card what it prints with `--device cpu`; (f) the graph-quality
     check: `glove_like(65,536 + 256, 100, seed 42)` (cut from phase 3c's
     262,144: the one-thread baseline) built through `::hnsw create` on
     the card and by `CpuHnswBaseline`, recall@10 at ef = 64 and 128 of
     each graph's host search against exact cosine, printed without a
     bar; prints a `hosts` line;
  3. drive the index's main path through the user entry points on the
     index phase 5 built (the same data, `bulk_build(wave=8192)`): then
     `sweep_search` with the f32 lane as ground truth (its first call,
     then 3 timed warm calls with the same ids; one launch of the f32
     chunk step and the merge, held to the lane's two-step route on the
     same queries: the rows that differ printed) and the fused,
     bf16+rerank, raw bf16 and i8+rerank lanes at B=16,384 (one warm call
     and `--reps` timed reps for the fused lane, 3 for the others),
     holding each lane's recall@10 to its bar; then `HnswIndex.search`
     alone: the quant lane (the f32 budget lowered for that call), small
     batches (B = 16, 1, 4, 63) through the beam-search kernel with
     recall beside the host search's, latency per call beside the
     kernel's own time, and the device mirror's incremental update after
     inserts and removals.  Each
     kernel's launch count is zeroed just before its path and read just
     after (`slab_topk` on each lane: f32, fused, bf16, raw bf16, i8,
     quant; in phase 5 on `::hnsw create` and on the rest of the script;
     in 3b, 3c, 9 and 10 on each path; each must launch);
  3b. the quant lane at its own width: a 768-wide cosine table of
     2,097,152 rows (cut from the JAX package's 10M-row configuration),
     `QuantSweepTable.load` + `quant_search`, recall against
     `brute_force_knn`; then that draw under the f32 budget through the
     bf16+rerank and i8+rerank lanes, on `sweep_topk`'s wide form (4
     launches each, no two-step call, recall bars), each chunk step timed
     on the kernel in turns with the two-step route, and phase 4's
     timings of the chunk step at those rows (bf16 kc 26 and 10, int8 kc
     64 and 128, the build's kc 97);
  3d. 1,536-wide rows: a draw of VectorDBBench's Performance1536D500K
     shape (OpenAI's text-embedding-ada-002 embeddings of C4: 500,000 x
     1,536 unit rows, cosine; `glove_like` of that shape, seed 44, made
     beside phase 2) under the f32 budget through the bf16+rerank,
     i8+rerank and f32 lanes at B = 4,096, k = 10, on `sweep_topk`'s wide
     form and its f32 kind's streamed rows (one launch a lane a batch, no
     two-step call; recall bars 0.999 / 0.998 against `brute_force_knn`
     on the first 1,024 queries; the f32 lane's ids equal to its two-step
     route's on the same queries but where the 10th and 11th scores lie
     within 1e-5), each lane's chunk step at its kc and at kc 116
     (VectorDBBench's top-100 + 16) timed in turns with the two-step
     route's products and selections, beside `torch.mm` + `torch.topk` a
     chunk, the SM clock under the kernel and under the route's product;
     then phase 4's timings at these rows (bf16 kc 26 / 10, int8 kc 64 /
     128, the build's kc 97, the f32 kind's kc 10); prints an `openai`
     line;
  9. (run after phase 4 times the main path's kernels) the device mesh
     (`cozo_tpu_torch/parallel/mesh.py`): a `ShardedSweep` over phase 3's
     index on [cuda:0] and on [cuda:0, cuda:0] at B = 16,384, k = 10
     (recall@10 within 0.002 of the raw bf16 lane's, the two meshes' ids
     equal but at exactly tied scores, QPS and the merge's share); a
     `Db("mem")` of 65,536 rows with the 2-shard mesh installed as the
     serving mesh: 64 single `~item:ix` queries answered by the index's
     `_mesh_sweep`, equal to `ShardedSweep.search`, recall@10 >= 0.95;
     at the end of phase 7, on its LiveJournal-shaped graph sharded over
     2 shards of the card: 10 PageRank steps from `sharded_pagerank_step`
     within L1 1e-5 of the loop unsharded in f64, two runs bit-identical,
     and `sharded_sssp_step` to its fixed point equal to phase 7's
     `sssp_device`; prints a `mesh` line after phase 7;
  10. (run after phase 9) the tkv, plog and remote engines (the last
     against a `python -m cozo_tpu_torch.hosts.kvserver --engine tkv`
     process): on each a Db on the card ingests 262,144 rows of phase 3's
     draw (phase 3c's size, cut from 1,183,514) and runs `::hnsw create`
     as phase 5 does, the pivot join of 1,024 stored queries (recall@10
     >= 0.999), the small join (B = 16, the beam kernel; ids equal to
     `HnswIndex.search`) and PageRank over the level-0 graph (held to the
     plain version); then the Db is closed and reopened (remote: a second
     client) and the row count, a search, the small join and PageRank
     are equal; prints an `engines` line;
  3c. the int8 build: 262,144 x 100 rows with the budget lowered, against
     the f32 build of the same rows;
  7. the shapes of `benches/graph_scale_bench.py` through the entry
     points: PageRank and SSSP at 4,928,571 nodes / 69M edges,
     LabelPropagation on the 50M-edge hub graph, each cold and warm and
     held to the plain versions; prints a `scale` line;
  8. the text indexes: `benches/bench_lsh_1m.py` through `Db("mem")`,
     at 262,144 of its 1,000,000 docs (LSH_N; 1,000 planted
     near-duplicates; ingest by
     `:put` batches of 50,000, `::lsh create` with 128 permutations at
     threshold 0.7, whose backfill runs the `minhash` kernel once a chunk
     of 32,768 docs, the serving image, 200 single queries and the
     1,000-query batched join, each planted-duplicate recall >= 0.95, no
     serving-image fallback); the stored signatures of every doc held to
     the host `minhash_segments` (a chunk a worker process); then `::fts
     create` on 50,000 of the docs and 10 single-term searches, each equal
     to a scan; prints an `lsh` line;
  4. time each kernel at its shape (the main-path shape for the routes the
     main path takes; `slab_topk` at each slab the main path hands it,
     from phase 3's index: the bf16 / f32 lanes' [16,384 x 131,072] f32
     with the bias at kf 26 and 10, the i8 lane's int32 products at kf
     64, the quant shape [4,096 x 131,072] at kf 40, the build's [8,192 x
     131,072] at kf 97 and the fused lane's packed array at kf 26, then
     the merges' buffers as the lanes fill them: [16,384 x 260] kf 26,
     [16,384 x 100] kf 10, [16,384 x 640] bf16 kf 64, the build's [8,192
     x 970] kf 97 and its pool [8,192 x 97] kf 96, beside the plain
     version (in row blocks) and `torch.topk` on the key slab (the f32
     lane's slab off the main path since its chunk step became a kernel,
     kept as a yardstick); `sweep_topk`
     at the main path's chunk steps (the f32 kind at kc 10 and 26, beside
     the two-step route's products and selections, in turns, with the SM
     clock under each), at phase 3b's (timed there, on its
     table) and, after phase 3b, at bf16 kc 26 and int8 kc 128 on a
     synthetic table of 3b's size 384 wide (`time_wide_384`), at phase
     3d's (timed there); the graph kernels at phase 7's, `minhash` at phase
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
  5. print the kernels' JSON line (each kernel's launches by path: the
     Db, the index, the graph rules, the scale graphs, the LSH build, the
     engines of phase 10), the card's name and power limit, and as the
     last line {"ok": true, "device": {...}}.

Beside phase 2, four threads of the host (`HostJob`) make phase 3b's and
3d's draws and phase 7's graphs and build phase 11 (f)'s baseline, each mostly
outside the GIL; the phase that takes a job's result prints its seconds
and those it still waited for.

`--kernels-only` skips phases 3-3d, times the fused main-path route on a
random table of the main-path shape and `beam_search` (kernel and call) on
a built index of 262,144 rows: a quick check of the kernels alone, which
prints no `{"ok": ...}` line.  `--graph-only` runs phases 1, 2 (the graph
kernels), 5 on a Db of `--n` rows, 6, 7 and the graph kernels' timings,
and prints no `{"ok": ...}` line either; `--lsh-only` runs phases 1, 2
(`minhash`), 8 and the `minhash` timing, and prints none either;
`--mesh-only` runs phases 1, 9 (on a Db's index of `--n` rows) and 10,
and prints none either; `--hosts-only` runs phases 1 and 11 but (a), with
(f) at `--n` rows (262,144 unless given; `--quality-main-draw`: phase 3c's
rows and queries) and (d) on (f)'s Db, and prints none either;
`--topk-only` runs phases 1 and 2 (`slab_topk`), builds an index of `--n`
rows (262,144 unless given), runs each sweep lane once (launches
counted) and times `slab_topk` as phase 4 does, and prints none either;
`--sweep-only` runs phases 1 and 2 (`sweep_topk`) and times `sweep_topk`
as phase 4 does on a synthetic table of `--n` rows and at phase 3b's
768-wide shapes on a synthetic table of its size (and two of them 384
wide), and at phase 3d's 1,536-wide shapes on a synthetic table of its
size, and prints none either; `--f32-only` runs phases 1 and 2's f32
cases of `sweep_topk` and times its f32 kind as phase 4 does on a
synthetic table of `--n` rows, and prints none either.
"""

import argparse
import contextlib
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
# each lane's earlier time a batch on one H100, as PERF.md section 5 records
# it, printed beside this run's
EARLIER_LANE_MS = {"f32": "163.1-165.9", "fused+rerank": "14.5-16.1",
                   "bf16+rerank": "67.6-76.7", "bf16-raw": "67.6-76.7",
                   "i8+rerank": "70.8-79.3",
                   "quant": "0.073-0.078 s scan + pull, 0.205-0.312 s host "
                            "re-rank"}
QUANT_N, QUANT_D, QUANT_NQ, QUANT_GT = 2_097_152, 768, 4096, 1024
# phase 3b's i8 lane re-ranks 128 candidates, not phase 3's 64: at d = 768
# the lane's bf16 keys (scores near 0.91, a bf16 step of 2^-8) tie in runs
# past 64 at a piece's 64th key, and the selection keeps a tie's lowest
# positions, so 64 cut true neighbours (the phase prints both)
WIDE_I8_RERANK = 128
I8_BUILD_N = 262_144
# phase 3d: VectorDBBench's Performance1536D500K shape (OpenAI's
# text-embedding-ada-002 on C4, 500,000 x 1,536, cosine): a draw of unit
# rows of that shape (glove_like, seed OPENAI_SEED), 4,096 queries, the
# ground truth on the first 1,024
OPENAI_N, OPENAI_D, OPENAI_NQ, OPENAI_GT = 500_000, 1536, 4096, 1024
OPENAI_SEED = 44
# VectorDBBench's top-100 plus the lanes' 16 over-fetched: the chunk step
# phase 3d times beside each lane's own
TOP100_KC = 116


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


class HostJob:
    """`fn(*args)` on a thread of its own, started at once: host work that
    needs no card and spends most of its time outside the GIL (numpy,
    a ctypes call), run beside phase 2 so that the phase that needs it
    does not wait for it.  A daemon thread: a failed run does not wait for
    it to end."""

    def __init__(self, fn, *args):
        import threading

        self._done = {}

        def run():
            t0 = time.time()
            try:
                self._done["value"] = fn(*args)
            except BaseException as exc:  # re-raised by result()
                self._done["error"] = exc
            self._done["seconds"] = time.time() - t0

        self._thread = threading.Thread(target=run, name=fn.__name__,
                                        daemon=True)
        self._thread.start()

    def result(self):
        """(fn's value, its seconds on its thread, the seconds waited for
        it here)."""
        t0 = time.time()
        self._thread.join()
        if "error" in self._done:
            raise self._done["error"]
        return self._done["value"], self._done["seconds"], time.time() - t0


def host_result(job, fn, *args):
    """`job.result()`, or without a job `fn(*args)` run here (all of its
    seconds then waited for)."""
    if job is not None:
        return job.result()
    t0 = time.time()
    value = fn(*args)
    return value, time.time() - t0, time.time() - t0


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
            elif "Potential Performance Loss" in line or "warning" in line:
                # e.g. asynchronous products serialised, or `setmaxnreg`
                # ignored: slow, not wrong
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


# ------------------------------------------------- slab_topk (the selection)

# The variants of `select_topk` phase 2 holds to the plain version: the
# prologue each caller passes, (slab type, column scale, row scale, bias,
# bf16 key).
TOPK_VARIANTS = {
    "packed": ("f32", False, False, False, False),    # fused lane, merges
    "bias": ("f32", False, False, True, False),       # f32 / bf16, build
    "scale_bias": ("f32", True, False, True, False),  # the int8 build
    "i8_bf16": ("i32", True, True, True, True),       # the i8 lane
    "quant": ("i32", True, True, True, False),        # the quant lane
    "bf16_in": ("bf16", False, False, False, False),  # the i8 lane's merge
}
# random: normal values (int8 products) with planted duplicates; ties:
# values from TOPK_TIES (+-0.0 among them; a 4-wide int8 product); dead: a
# row all -inf and a row with 3 live entries (int32 slabs: every column
# but 3 dead); i8_real: a bf16 key slab from int8 products of quantised
# normal rows (the i8 lane's ties); then the orders a running threshold
# finds hardest: ascending keys (every element beats the threshold),
# descending keys, and tail: the 300 best in the last columns
TOPK_KINDS = ("random", "ties", "dead", "i8_real", "ascending", "descending",
              "tail")
TOPK_ORDER_KINDS = TOPK_KINDS[4:]
TOPK_TIES = (0.0, -0.0, 1.0, -1.0, 2.5, -2.5, -np.inf)
TOPK_WIDTHS = (512, 4097, 10_240, 16_384, 131_072)
TOPK_KFS = (1, 10, 26, 40, 97, 256, 1000, None)  # None: the full width
TOPK_RAGGED = (300, 131_072)  # kf = W: 256 rows a launch, then 44
# the merges' widths (a bf16 lane's 10 x 26, the build's 10 x 97): one
# warp a row, several rows a block
TOPK_NARROW = (260, 970)


def topk_cases(widths=TOPK_WIDTHS, ragged=TOPK_RAGGED):
    """Phase 2's (B, W, kf, variant, kind): every width at every kf (B = 17,
    every fifth case B = 1), the variants and the first four kinds in
    turn; every variant with each of those kinds at the second width, kf =
    26 and 97; the ragged block of launches (kf = W past the scratch of
    one launch); then every variant with every order kind at the first
    and the last width, kf = 26 and 97; and the narrow widths at every kf,
    the variants and all kinds in turn."""
    names = list(TOPK_VARIANTS)
    first = TOPK_KINDS[:4]
    cases = []
    for W in widths:
        for kf in TOPK_KFS:
            kf = W if kf is None else kf
            if kf > W:
                continue
            i = len(cases)
            cases.append((1 if i % 5 == 4 else 17, W, kf,
                          names[i % len(names)],
                          first[(i // len(names)) % len(first)]))
    for variant in names:
        for kind in first:
            for kf in (26, 97):
                cases.append((17, widths[1], kf, variant, kind))
    if ragged:
        cases.append((ragged[0], ragged[1], ragged[1], "packed", "random"))
    for W in (widths[0], widths[-1]):
        for variant in names:
            for kind in TOPK_ORDER_KINDS:
                for kf in (26, 97):
                    cases.append((17, W, kf, variant, kind))
    for n, W in enumerate(TOPK_NARROW):
        for m, kf in enumerate(TOPK_KFS):
            kf = W if kf is None else kf
            if kf > W:
                continue
            cases.append((1 if m % 5 == 4 else 17, W, kf,
                          names[(n + m) % len(names)],
                          TOPK_KINDS[(3 * n + m) % len(TOPK_KINDS)]))
    return cases


def _int8_rows(rng, n, d):
    """int8 rows and their max-abs scales from normal rows."""
    v = rng.standard_normal((n, d)).astype(np.float32)
    sc = np.abs(v).max(axis=1) / 127.0
    return np.clip(np.rint(v / sc[:, None]), -127, 127).astype(np.int32), \
        sc.astype(np.float32)


def _ordered(rng, x, kind):
    """(slab, column scale, bias) of an order kind from a random slab: the
    scale constant and the bias in the slab's order, so that the keys
    keep it (ascending, descending), or the 300 best in the last columns
    (tail)."""
    B, W = x.shape
    c = np.full(W, 0.005, np.float32)
    b = np.sort(-rng.random(W)).astype(np.float32)
    if kind == "tail":
        t = min(W, 300)
        big = x.max() + 1 + rng.integers(0, 1000, (B, t)) \
            if x.dtype.kind == "i" else 50 + rng.random((B, t))
        x = x.copy()
        x[:, -t:] = big.astype(x.dtype)
        return x, c, b * np.float32(0.001)
    x = np.sort(x, axis=1)
    if kind == "descending":
        x, b = x[:, ::-1], b[::-1]
    return x, c, np.ascontiguousarray(b)


def topk_inputs(B, W, variant, kind, seed, dev):
    """(slab, keyword arguments of `select_topk`) of a phase-2 case."""
    import torch

    rng = np.random.default_rng(seed)
    dtype, has_c, has_r, has_b, bf16 = TOPK_VARIANTS[variant]
    kw = {"bf16": bf16} if bf16 else {}
    c = (rng.random(W) * 0.01 + 1e-3).astype(np.float32)
    r = (rng.random(B) * 0.01 + 1e-3).astype(np.float32)
    b = (-rng.random(W)).astype(np.float32)
    if kind == "ties":
        b = rng.choice(np.float32([0.0, -0.0]), W)
    if dtype == "i32":
        d = 4 if kind == "ties" else 100
        qa, qs = _int8_rows(rng, B, d)
        ta, ts = _int8_rows(rng, W, d)
        if kind == "i8_real":
            c, r = ts, qs
        x = qa @ ta.T
        if kind == "random":
            x[:, rng.integers(0, W, W // 4)] = x[:, :1]
        if kind == "dead":
            live = rng.choice(W, 3, replace=False)
            dead = np.ones(W, bool)
            dead[live] = False
            c[dead], b[dead] = 0.0, -np.inf
        x = x.astype(np.int32)
    else:
        x = rng.standard_normal((B, W)).astype(np.float32)
        if kind == "ties":
            x = rng.choice(np.float32(TOPK_TIES), (B, W))
        elif kind == "i8_real":
            qa, qs = _int8_rows(rng, B, 100)
            ta, ts = _int8_rows(rng, W, 100)
            x = ((qa @ ta.T).astype(np.float32) * ts[None, :]
                 * qs[:, None]).astype(np.float32)
            x = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
        else:
            x[:, rng.integers(0, W, W // 4)] = x[:, :1]
        if kind == "dead" and has_c:  # a product is finite: dead by bias
            dead = np.ones(W, bool)
            dead[rng.choice(W, 3, replace=False)] = False
            c[dead], b[dead] = 0.0, -np.inf
        elif kind == "dead":
            x[0] = -np.inf
            if B > 1:
                keep = x[1, :3].copy()
                x[1] = -np.inf
                x[1, rng.choice(W, 3, replace=False)] = keep
            b[::7] = -np.inf
    if kind in TOPK_ORDER_KINDS:
        x, c, b = _ordered(rng, x, kind)
    xt = torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    if dtype == "bf16":
        xt = xt.to(torch.bfloat16)
    for name, v, want in (("col_scale", c, has_c), ("row_scale", r, has_r),
                          ("bias", b, has_b)):
        if want:
            kw[name] = torch.from_numpy(np.ascontiguousarray(v)).to(dev)
    return xt, kw


def topk_same(a, b):
    """Bit-equality of two (values, ids) pairs."""
    import torch

    (va, ia), (vb, ib) = a, b
    view = torch.int16 if va.dtype == torch.bfloat16 else torch.int32
    return (va.dtype == vb.dtype and torch.equal(ia, ib)
            and torch.equal(va.contiguous().view(view),
                            vb.contiguous().view(view)))


def phase_topk_vs_plain(dev):
    """Phase 2 for `slab_topk`: every case of `topk_cases` bit-equal to
    `select_topk_plain` on the card in values and ids, two runs
    bit-identical.  Launches here are not counted on any path."""
    import torch

    from cozo_tpu_torch.ops import exact_knn as ek

    t0 = time.time()
    cases = topk_cases()
    by_width = {}
    for i, (B, W, kf, variant, kind) in enumerate(cases):
        x, kw = topk_inputs(B, W, variant, kind, i, dev)
        got = ek.select_topk(x, kf, **kw)
        again = ek.select_topk(x, kf, **kw)
        want = ek.select_topk_plain(x, kf, **kw)
        torch.cuda.synchronize()
        equal, twice = topk_same(got, want), topk_same(got, again)
        by_width.setdefault(W, []).append(equal and twice)
        if not (equal and twice):
            say(f"phase 2 slab_topk vs plain B={B} W={W} kf={kf} {variant} "
                f"{kind}: values and ids bit-equal {equal}, two runs "
                f"identical {twice} FAIL")
            raise SystemExit("phase 2 failed: slab_topk disagrees with plain")
        del x, kw, got, again, want
    torch.cuda.empty_cache()
    for W, oks in by_width.items():
        say(f"phase 2 slab_topk vs plain at W={W}: {len(oks)} cases (kf "
            f"1 ... W, B = 1 / 17{' / ' + str(TOPK_RAGGED[0]) if W == TOPK_RAGGED[1] else ''}, "
            f"the variants {sorted(TOPK_VARIANTS)}, kinds {list(TOPK_KINDS)}): "
            f"values and ids bit-equal, two runs identical")
    say(f"phase 2 slab_topk: {len(cases)} cases in {time.time() - t0:.1f}s")


TOPK_LAUNCHES = {}  # path -> slab_topk launches on it, each counted from 0
# path -> sweep_topk's launches of csrc/sweep_topk.cu (bf16, int8) and of
# csrc/sweep_topk_f32.cu (f32) on it, each counted from 0
SWEEP_LAUNCHES = {}
SWEEP_F32_LAUNCHES = {}
# what the calls made since `topk_zero` must launch, by kernel (sweep_topk
# all kinds, and its f32 kind apart), and the calls of sweep_topk that
# would take its two-step route (none may)
EXPECTED = {"slab_topk": 0, "sweep_topk": 0, "sweep_f32": 0, "two_step": 0}


def _merges(n_chunks, kc, kf):
    """`merge_chunks` launches `select_topk` unless the buffer is kf wide."""
    return 0 if n_chunks * kc == kf else 1


def _chunk_step(q, n_chunks, chunk, d_pad, kf, kind):
    """(sweep_topk, two-step calls, slab_topk) launches of one call of a
    lane's chunk step (`sweep_topk` of `kind`, as `sweep_piece` takes it,
    on the piece `sweep_piece` picks, then `merge_chunks`): one kernel, or
    one call of the two-step route and a selection a piece; and the
    merge."""
    from cozo_tpu_torch.ops import exact_knn as ek

    n_total = n_chunks * chunk
    piece = ek.sweep_piece(n_total, chunk, q.shape[0], d_pad, min(kf, chunk),
                           kind, q.device)
    kc = min(kf, piece)
    merge = _merges(n_total // piece, kc, kf)
    if ek.sweep_route(d_pad, kc, piece) == "kernel":
        return 1, 0, merge
    return 0, 1, n_total // piece + merge


def install_launch_ledger():
    """Wraps each function of the port that launches the selection kernels
    (the sweeps, the build steps, the fused lane's pick, the quant scan) so
    that every call on the card adds to EXPECTED what it must launch: the
    gates of `topk_read` then hold each kernel's count on a path to the
    exact number its calls imply.  The wrappers call the functions as they
    are; nothing else changes."""
    import inspect

    from cozo_tpu_torch.ops import bulk_build as bb
    from cozo_tpu_torch.ops import exact_knn as ek
    from cozo_tpu_torch.ops import fused_sweep as fs
    from cozo_tpu_torch.ops import quant_knn as qk

    def sweep(a):  # bf16, or f32 (its own kernel, counted apart too)
        n_chunks, chunk, d_pad = a["tbl"].shape
        kf = max(a["k"], a["rerank_k"])
        f32 = a["compute_dtype"] != "bf16"
        sw, ts, sl = _chunk_step(a["qs"], n_chunks, chunk, d_pad, kf,
                                 ek.SWEEP_F32 if f32 else 0)
        EXPECTED["sweep_f32"] += sw if f32 else 0
        return sw, ts, sl

    def sweep_i8(a):
        n_chunks, chunk, d_pad = a["tbl"].shape
        kf = max(a["k"], a["rerank_k"])
        return _chunk_step(a["qs"], n_chunks, chunk, d_pad, kf, True)

    def build_step(a):  # and the pool's selection
        n_chunks, chunk, d_pad = a["tbl"].shape
        sw, ts, sl = _chunk_step(a["new_rows"], n_chunks, chunk, d_pad,
                                 a["P"] + 1, False)
        return sw, ts, sl + 1

    def build_step_i8(a):
        n_chunks = a["tbl_i8"].shape[0]
        return 0, 0, n_chunks + _merges(n_chunks, a["P"] + 1, a["P"] + 1) + 1

    def qsweep(a):
        n_chunks, chunk, _ = a["tbl_i8"].shape
        kc = min(a["kf"], chunk)
        return 0, 0, n_chunks + _merges(n_chunks, kc, a["kf"])

    def wrap(mod, name, count, device_arg):
        fn = getattr(mod, name)
        if getattr(fn, "ledger", False):
            return
        sig = inspect.signature(fn)

        def wrapped(*args, **kw):
            a = sig.bind(*args, **kw)
            a.apply_defaults()
            if a.arguments[device_arg].device.type == "cuda":
                sw, ts, sl = count(a.arguments) if count else (0, 0, 1)
                EXPECTED["sweep_topk"] += sw
                EXPECTED["two_step"] += ts
                EXPECTED["slab_topk"] += sl
            return fn(*args, **kw)

        wrapped.ledger = True
        setattr(mod, name, wrapped)

    wrap(ek, "_sweep", sweep, "qs")
    wrap(ek, "_sweep_i8", sweep_i8, "qs")
    wrap(bb, "_build_step", build_step, "new_rows")
    wrap(bb, "_build_step_i8", build_step_i8, "new_rows")
    wrap(fs, "serve", None, "qs_in")  # one pick over the packed array
    wrap(qk, "_qsweep", qsweep, "qs_i8")


def topk_zero():
    from cozo_tpu_torch.ops import exact_knn as ek

    ek.select_topk.launches = 0
    ek.sweep_topk.launches = ek.sweep_topk.two_step = 0
    ek.sweep_topk.f32_launches = 0
    EXPECTED.update(slab_topk=0, sweep_topk=0, sweep_f32=0, two_step=0)


def topk_read(path, phase, sweep):
    """slab_topk's and sweep_topk's launches since `topk_zero`, kept as
    `path`'s (sweep_topk's f32 kind, `csrc/sweep_topk_f32.cu`, apart).
    The phase fails unless each equals what the path's calls imply
    (`install_launch_ledger`), sweep_topk launched where the path runs an
    f32, bf16 or i8 sweep or an f32-table build (`sweep` true) and never
    elsewhere, slab_topk launched on the other paths (their selections and
    merges), and sweep_topk's two-step route (rows past 4,096, kc past
    256) taken nowhere.  Returns slab_topk's count."""
    from cozo_tpu_torch.ops import exact_knn as ek

    n = TOPK_LAUNCHES[path] = ek.select_topk.launches
    m = ek.sweep_topk.launches
    f = SWEEP_F32_LAUNCHES[path] = ek.sweep_topk.f32_launches
    SWEEP_LAUNCHES[path] = m - f
    t = ek.sweep_topk.two_step
    want = (EXPECTED["slab_topk"], EXPECTED["sweep_topk"],
            EXPECTED["sweep_f32"], EXPECTED["two_step"])
    if (n, m, f, t) != want or (m >= 1) != sweep or not (sweep or n >= 1) \
            or t:
        raise SystemExit(
            f"{phase} failed on {path}: slab_topk launched {n} times, "
            f"sweep_topk {m} ({f} of them f32) and its two-step route {t}, "
            f"where the calls imply {want[0]}, {want[1]} ({want[2]}) and "
            f"{want[3]}")
    return n


# -- sweep_topk: the bf16 / i8 lanes' and the build's chunk step ------------

SWEEP_KINDS = ("bf16", "int8")
SWEEP_KCS = (1, 10, 26, 64, 97, 256)
SWEEP_WIDTHS = (256, 4096, 131_072)  # a piece's table rows
SWEEP_BS = (1, 17, 130)
SWEEP_DS = (16, 64, 128)
SWEEP_VARIANTS = ("random", "ties", "dead", "ascending")
SWEEP_EDGE_KCS = (32, 33, 64, 65, 96, 97, 256)  # each row state's edges
SWEEP_EDGE_BS = (1, 17, 129, 257)
# the wide rows (the kernel's wide form past d_pad 128): the narrowest,
# 144, 256, 384 (the small sentence encoders), phase 3b's 768, 1,024,
# phase 3d's 1,536 (OpenAI's) and the widest, 4,096 (the 7B-LLM
# embedders); every row state's kc (and the lanes' 10, 26, 64, 97, 128),
# both kinds, "random" (with rows whose int8 sums pass 2^22, and past
# d_pad 1,040 2^24), "ties" (+-0.0 among them) and "ascending" (rising
# keys); B = 257 (5 query tiles of 64 rows: a pair that ends with a block
# past the rows), 2 pieces of 8,192 rows; then pieces of 256 and 768 rows
# (1 and 3 groups of the lists of 8's 4 tiles: the second consumer of a
# block selects nothing, or one group fewer than the first); then 2,048
# and 3,072 (OpenAI's text-embedding-3-large) at the bf16 lane's kc 26 and
# at TOP100_KC
SWEEP_WIDE_DS = (144, 256, 384, 768, 1024, 1536, 4096)
SWEEP_WIDE_KCS = (10, 26, 64, 97, 128, 256)
SWEEP_WIDE_VARIANTS = ("random", "ties", "ascending")
SWEEP_WIDER = tuple((d_pad, kc) for d_pad in (2048, 3072)
                    for kc in (26, TOP100_KC))
SWEEP_WIDE_CASES = tuple((kind, 257, 8192, 2, d_pad, kc, variant)
                         for d_pad in SWEEP_WIDE_DS
                         for kc in SWEEP_WIDE_KCS
                         for kind in SWEEP_KINDS
                         for variant in SWEEP_WIDE_VARIANTS) + tuple(
    (kind, 257, piece, 3, d_pad, kc, ("random", "ties")[kc == 26])
    for piece in (256, 768) for d_pad in (384, 768) for kind in SWEEP_KINDS
    for kc in (10, 26)) + tuple(
    (kind, 257, 8192, 2, d_pad, kc, variant) for d_pad, kc in SWEEP_WIDER
    for kind in SWEEP_KINDS for variant in SWEEP_WIDE_VARIANTS)
# the f32 kind (`csrc/sweep_topk_f32.cu`): every kc of its row states and
# the lanes' (1, 10, 26, 64, 97, 128, 256) at d_pad 16, 128 (the lane's),
# 256, 768, 1,024, 1,536 and 4,096 (query rows streamed past 128), B 1,
# 17, 130 and 257 (ragged query tiles), pieces of 256 and 4,096 rows x
# 1-3, the variants in turn ("ties": +-0.0 and equal keys across piece
# edges; "dead": fewer live columns than kc)
SWEEP_F32_KCS = (1, 10, 26, 64, 97, 128, 256)
SWEEP_F32_DS = (16, 128, 256, 768, 1024, 1536, 4096)
SWEEP_F32_CASES = tuple(
    ("f32", (1, 17, 130, 257)[(i + j) % 4],
     4096 if kc > 256 or (i + j) % 2 else 256, 1 + (i + 2 * j) % 3, d_pad, kc,
     SWEEP_VARIANTS[(i + j) % 4])
    for i, d_pad in enumerate(SWEEP_F32_DS)
    for j, kc in enumerate(SWEEP_F32_KCS))
SWEEP_TOL = 1e-5  # bf16 route: |value - plain| <= SWEEP_TOL * max(1, |plain|)
SWEEP_ID_SHARE = 0.999  # bf16 route: ids equal on at least this share


def sweep_cases():
    """Phase 2's (kind, B, piece, n_pieces, d_pad, kc, variant): every
    piece width at every kc up to it, both kinds, B, the number of pieces
    (1-3), d_pad and the variant in turn; then every variant of each kind
    at [17 x 2 pieces of 4,096], d_pad 128, kc 26 and 97; then
    `sweep_edge_cases`; then SWEEP_WIDE_CASES (the kernel's wide form);
    then SWEEP_F32_CASES (the f32 kind)."""
    cases = []
    for W in SWEEP_WIDTHS:
        for kc in SWEEP_KCS:
            if kc > W:
                continue
            for kind in SWEEP_KINDS:
                i = len(cases)
                cases.append((kind, SWEEP_BS[i % 3], W, 1 + (i // 2) % 3,
                              SWEEP_DS[(i // 3) % 3], kc,
                              SWEEP_VARIANTS[i % 4]))
    for kind in SWEEP_KINDS:
        for variant in SWEEP_VARIANTS:
            for kc in (26, 97):
                cases.append((kind, 17, 4096, 2, 128, kc, variant))
    return (cases + sweep_edge_cases() + list(SWEEP_WIDE_CASES)
            + list(SWEEP_F32_CASES))


def sweep_edge_cases():
    """The kernel's edges: kc on both sides of each row state's limit (32 /
    33, 64 / 65, 96 / 97) and 256, both kinds, twice each, with B 1, 17,
    129 and 257 in turn, each kind meeting all four (query tiles of 128 or
    64 rows: 1, 2, 3 or 5 of them, so that a cluster of 2 blocks may end
    with a block past the rows), pieces of 256 and 4,096 rows, 1-3
    pieces, d_pad 16, 64 and 128 and the variants in turn."""
    cases = []
    for k, kc in enumerate(SWEEP_EDGE_KCS):
        for kind in SWEEP_KINDS:
            for _ in range(2):
                i = len(cases)
                cases.append((kind, SWEEP_EDGE_BS[(i + 2 * k) % 4], (
                    256, 4096)[(i // 4) % 2], 1 + i % 3, SWEEP_DS[i % 3], kc,
                    SWEEP_VARIANTS[(i // 3) % 4]))
    return cases


# rows wider than this are drawn on the card: a host draw of 16,384 x
# 4,096 normals takes a second, and phase 2 has some eighty such cases
SWEEP_HOST_DRAW_D = 1024


def sweep_inputs(kind, B, piece, n_pieces, d_pad, variant, seed, dev):
    """(q, tbl, keyword arguments of `sweep_topk`) of a phase-2 case: unit
    rows zero-padded past d_pad - 4 (as the lanes' 100 -> 128), a few dead
    rows (-inf bias; int8: column scale 0); "ties": each piece's last 8 rows
    repeated at the next piece's start, a quarter of the rows zero with a
    +-0.0 bias, the first query zero; "dead": 3 live rows a piece;
    "ascending": keys that rise along the piece (a bias step past the
    scores' range); "random" past d_pad 128 also 8 table rows and 4 queries
    near a constant vector (every other query negated), whose int8 codes
    are near +-127: sums past 2^22 at d_pad 768, past 2^24 beyond 1,040.
    The normal draws come from numpy's generator seeded with `seed`, past
    SWEEP_HOST_DRAW_D from the card's; everything else from numpy's.
    bf16, f32, or int8 with the lanes' max-abs scales."""
    import torch

    from cozo_tpu_torch.utils.device import quantize_i8

    rng = np.random.default_rng(seed)
    n = piece * n_pieces
    d = max(1, d_pad - 4)
    if d_pad > SWEEP_HOST_DRAW_D:
        g = torch.Generator(device=dev).manual_seed(seed)

        def normal(rows):
            return torch.randn((rows, d), generator=g, device=dev)
    else:
        def normal(rows):
            return torch.from_numpy(rng.standard_normal((rows, d)).astype(
                np.float32)).to(dev)
    q = torch.zeros((B, d_pad), device=dev)
    t = torch.zeros((n, d_pad), device=dev)
    q[:, :d] = normal(B)
    t[:, :d] = normal(n)
    if variant == "random" and d_pad > 128:
        for m, rows in ((t, 8), (q, min(4, B))):
            m[:rows, :d] = 1.0 + 0.03 * normal(rows)
        q[1:4:2] *= -1.0
    q /= q.norm(dim=1, keepdim=True)
    t /= t.norm(dim=1, keepdim=True)
    bias = np.zeros(n, np.float32)
    bias[rng.random(n) < 0.02] = -np.inf
    if variant == "ties":
        for p in range(1, n_pieces):
            t[p * piece:p * piece + 8] = t[p * piece - 8:p * piece]
            bias[p * piece:p * piece + 8] = bias[p * piece - 8:p * piece]
        zero = rng.choice(n, n // 4, replace=False)
        t[torch.from_numpy(zero).to(dev)] = 0.0
        bias[zero] = rng.choice(np.float32([0.0, -0.0]), len(zero))
        q[0] = 0.0
    elif variant == "dead":
        bias[:] = -np.inf
        for p in range(n_pieces):
            bias[p * piece + rng.choice(piece, 3, replace=False)] = 0.0
    elif variant == "ascending":
        t *= 1e-3
        bias = (np.arange(n) % piece).astype(np.float32) * 0.25
    bt = torch.from_numpy(bias).to(dev)
    if kind == "bf16":
        return q.to(torch.bfloat16), t.to(torch.bfloat16), {"bias": bt}
    if kind == "f32":
        return q, t, {"bias": bt}
    t_i8, cs = quantize_i8(t, reciprocal=True)
    cs = torch.where(torch.isfinite(bt), cs, torch.zeros_like(cs))
    q_i8, rs = quantize_i8(q, reciprocal=True)
    return q_i8, t_i8, {"bias": bt, "col_scale": cs.contiguous(),
                        "row_scale": rs.contiguous()}


def sweep_slab_keys(q, tbl, kw):
    """The plain version's keys of the whole [B, n_total] slab."""
    import torch

    from cozo_tpu_torch.ops import exact_knn as ek
    from cozo_tpu_torch.utils.device import int_mm, mm_bf16

    if q.dtype == torch.int8:
        return ek.slab_key(int_mm(q, tbl), kw["col_scale"], kw["row_scale"],
                           kw["bias"], bf16=True)
    if q.dtype == torch.float32:
        return ek.slab_key(torch.mm(q, tbl.T), bias=kw["bias"])
    return ek.slab_key(mm_bf16(q, tbl), bias=kw["bias"])


# past this d_pad cuBLAS's f32 product may sum in another order than the
# f32 kind's one chain a score (split K): its ids are then held by the
# near-tie test alone, the measure phase 3d holds its lane to
F32_CHAIN_ORDER_D = 1024


def sweep_agreement(got, want, keys, order_free=False):
    """The kernel's (values, ids) against the plain version's: for int8
    bit-equality; for bf16 and f32 the values within SWEEP_TOL x max(1,
    |value|)
    at every rank, ids equal on >= SWEEP_ID_SHARE of (row, rank) entries,
    and every other entry a near-tie: the plain key of the kernel's id
    within that tolerance of the plain value at its rank.  `order_free`
    (the f32 kind past F32_CHAIN_ORDER_D): the near-tie test without the
    share (a B = 1 case has 10-200 entries, and one swap of two keys
    within 2e-6 of each other, the two orders' sums near 1.0, is 1-4% of
    them).  Returns (ok, share of equal ids, max |value error| over
    finite values)."""
    import torch

    ok, share, err = sweep_values_agree(got, want, share_bar=(
        0.0 if order_free else SWEEP_ID_SHARE))
    if got[0].dtype == torch.bfloat16:
        return ok, share, err
    gv, gi = got
    wv, wi = want
    other = gi != wi
    if ok and bool(other.any()):
        tol = SWEEP_TOL * torch.clamp(wv.abs(), min=1.0)
        kv = torch.gather(keys, 1, gi.clamp(min=0))
        kdiff = torch.where(torch.isinf(kv) & (kv == wv),
                            torch.zeros_like(kv), (kv - wv).abs())
        ok = bool((kdiff[other] <= tol[other]).all())
    return ok, share, err


def sweep_values_agree(got, want, share_bar=SWEEP_ID_SHARE):
    """`sweep_agreement` without the near-tie test (which needs the whole
    slab): int8 bit-equal; bf16 and f32 values within the tolerance at
    every rank (-inf where the plain version's is) and ids equal on >=
    `share_bar` of entries.  (ok, share of equal ids, max |value error|
    over finite values)."""
    import torch

    share = float((got[1] == want[1]).float().mean())
    if got[0].dtype == torch.bfloat16:
        return topk_same(got, want), share, 0.0
    fin = torch.isfinite(want[0])
    diff = (got[0] - want[0]).abs()
    tol = SWEEP_TOL * torch.clamp(want[0].abs(), min=1.0)
    same_inf = bool(torch.equal(got[0][~fin], want[0][~fin]))
    err = float(diff[fin].max()) if bool(fin.any()) else 0.0
    return (bool((diff[fin] <= tol[fin]).all()) and same_inf
            and share >= share_bar), share, err


def phase_sweep_vs_plain(dev, cases=None):
    """Phase 2 for `sweep_topk`: every case of `sweep_cases` against
    `sweep_topk_plain` on the card (int8 bit-equal; bf16 and f32 by
    `sweep_agreement`; f32's bit-equal cases counted), two runs
    bit-identical, each call on the route `sweep_route` names (every case
    here: the kernel's; `cases`: a subset).  Launches here are not counted
    on any path."""
    import torch

    from cozo_tpu_torch.ops import exact_knn as ek

    t0 = time.time()
    cases = list(cases or sweep_cases())
    worst = {"bf16": (1.0, 0.0), "int8": (1.0, 0.0), "f32": (1.0, 0.0)}
    f32_exact, f32_inexact = 0, []
    for i, (kind, B, W, n_p, d_pad, kc, variant) in enumerate(cases):
        q, tbl, kw = sweep_inputs(kind, B, W, n_p, d_pad, variant, i, dev)
        before = (ek.sweep_topk.launches, ek.sweep_topk.two_step)
        # every other f32 case with its real width (the inputs' last 4
        # columns are zero): the chains stop there
        real = {"d_real": d_pad - 4} if kind == "f32" and i % 2 else {}
        got = ek.sweep_topk(q, tbl, W, kc, **kw, **real)
        again = ek.sweep_topk(q, tbl, W, kc, **kw, **real)
        want = ek.sweep_topk_plain(q, tbl, W, kc, **kw)
        torch.cuda.synchronize()
        two = ek.sweep_route(d_pad, kc, W) == "two_step"
        launched = (ek.sweep_topk.launches - before[0],
                    ek.sweep_topk.two_step - before[1]) == (
            (0, 2) if two else (2, 0))
        ok, share, err = sweep_agreement(got, want,
                                         sweep_slab_keys(q, tbl, kw),
                                         kind == "f32"
                                         and d_pad > F32_CHAIN_ORDER_D)
        twice = topk_same(got, again)
        w = worst[kind]
        worst[kind] = (min(w[0], share), max(w[1], err))
        if kind == "f32":
            if topk_same(got, want):
                f32_exact += 1
            else:
                f32_inexact.append(f"d_pad {d_pad} kc {kc} B {B} {variant}")
        if not (ok and twice and launched):
            say(f"phase 2 sweep_topk vs plain {kind} B={B} piece={W} x {n_p} "
                f"d_pad={d_pad} kc={kc} {variant}: agree {ok} (ids equal "
                f"{share:.5f}, max err {err:.3g}), two runs identical "
                f"{twice}, launched {launched} FAIL")
            raise SystemExit("phase 2 failed: sweep_topk disagrees with plain")
        del q, tbl, kw, got, again, want
    torch.cuda.empty_cache()
    say(f"phase 2 sweep_topk vs plain: {len(cases)} cases (B {SWEEP_BS}, "
        f"pieces of {SWEEP_WIDTHS} x 1-3, d_pad {SWEEP_DS}, kc {SWEEP_KCS}, "
        f"{list(SWEEP_VARIANTS)}; the edges: kc {SWEEP_EDGE_KCS}, B "
        f"{SWEEP_EDGE_BS}; {len(SWEEP_WIDE_CASES)} at the wide rows: d_pad "
        f"{SWEEP_WIDE_DS}, kc {SWEEP_WIDE_KCS}, B 257, 2 pieces of 8,192, "
        f"{list(SWEEP_WIDE_VARIANTS)}, 3 pieces of 256 and 768, and (d_pad, "
        f"kc) {list(SWEEP_WIDER)}; "
        f"{len(SWEEP_F32_CASES)} f32: d_pad {SWEEP_F32_DS}, kc "
        f"{SWEEP_F32_KCS}) in {time.time() - t0:.1f}s: int8 values "
        f"and ids bit-equal; bf16 values within {SWEEP_TOL} x max(1, |v|) "
        f"(max err {worst['bf16'][1]:.3g}), ids equal on >= "
        f"{worst['bf16'][0]:.5f} of entries (bar {SWEEP_ID_SHARE}), every "
        f"other a near-tie; f32 by the same measure, past d_pad "
        f"{F32_CHAIN_ORDER_D} by the near-tie test alone (max err "
        f"{worst['f32'][1]:.3g}, ids equal on >= {worst['f32'][0]:.5f}), "
        f"{f32_exact} of {len(SWEEP_F32_CASES)} cases bit-equal to cuBLAS's "
        f"product + the plain selection (not: {f32_inexact}); two runs "
        f"identical")


def recall(ids, gt):
    return float(np.mean([
        len(set(ids[b].tolist()) & set(gt[b].tolist())) / K
        for b in range(len(gt))
    ]))


def phase_main(index, qs, build_s, reps):
    """Serve the index that phase 5 built through the Db (the same data,
    `bulk_build(wave=8192)`, cosine, m = 16, ef_construction = 200, slots
    equal to ids) through the entry points; returns what phase 4 needs
    (launch counts) and what phase 9 needs (the f32 ground truth and the
    raw bf16 lane's recall)."""
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
    topk_zero()
    gt, gt_d = sweep_search(index, qs, K, rt=1.0, compute_dtype="f32",
                            exact_rerank=False)
    topk_read("index f32 (phase 3)", "phase 3", sweep=True)
    first_s = time.time() - t0
    if gt.shape != (NQ, K) or not np.isfinite(gt_d).all() or (gt < 0).any():
        raise SystemExit("phase 3 failed: f32 lane returned bad rows")
    warm = []
    for _ in range(OTHER_LANE_REPS):
        t0 = time.time()
        again, _ = sweep_search(index, qs, K, rt=1.0, compute_dtype="f32",
                                exact_rerank=False)
        warm.append(1e3 * (time.time() - t0))
        if not np.array_equal(again, gt):
            raise SystemExit("phase 3 failed: f32 lane not reproducible")
    say(f"phase 3 f32 ground truth in {first_s:.2f}s (first call), warm "
        f"median {np.median(warm):.1f} ms a batch ({warm}; earlier, PERF.md "
        f"section 5: {EARLIER_LANE_MS['f32']} ms a batch warm, the two-step "
        f"route)")
    f32_truth_vs_two_step(index, qs)

    lanes = {}
    # the int8 lane re-ranks 64 candidates, as the JAX package's bench
    # does: int8 rank noise needs the wider overfetch
    for tag, cd, rt, rerank, rk in (
            ("fused+rerank", "fused", 1.0, True, None),
            ("bf16+rerank", "bf16", 0.98, True, None),
            ("bf16-raw", "bf16", 0.99, False, None),
            ("i8+rerank", "i8", 0.98, True, 64)):
        torch.cuda.reset_peak_memory_stats()
        topk_zero()
        sweep_search(index, qs, K, rt=rt, compute_dtype=cd,
                     exact_rerank=rerank, rerank_k=rk)  # warm
        per_rep = []
        for _ in range(reps if cd == "fused" else OTHER_LANE_REPS):
            t0 = time.time()
            ids, dists = sweep_search(index, qs, K, rt=rt, compute_dtype=cd,
                                      exact_rerank=rerank, rerank_k=rk)
            per_rep.append(NQ / (time.time() - t0))
        topk_read(f"index {tag} (phase 3)", "phase 3",
                  sweep=cd in ("bf16", "i8"))
        r = recall(ids, gt)
        ok = (ids.shape == (NQ, K) and np.isfinite(dists[ids >= 0]).all()
              and r >= BARS[tag])
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        lanes[tag] = {"qps_median": float(np.median(per_rep)),
                      "qps_min": float(min(per_rep)), "per_rep_qps": per_rep,
                      "recall@10": r, "peak_device_gb": peak_gb}
        say(f"phase 3 lane {tag}: median {np.median(per_rep):.1f} QPS "
            f"min {min(per_rep):.1f} = {1e3 * NQ / np.median(per_rep):.1f} ms "
            f"a batch (earlier, PERF.md section 5: {EARLIER_LANE_MS[tag]} ms) "
            f"recall@10 {r:.5f} (bar {BARS[tag]}) peak device memory "
            f"{peak_gb:.2f} GB {'ok' if ok else 'FAIL'}")
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
    return launches, {"gt": gt, "raw_recall": lanes["bf16-raw"]["recall@10"]}


def f32_truth_vs_two_step(index, qs, phase="phase 3", tie_tol=None):
    """The f32 lane's answer on the card (`exact_knn._sweep`: the f32
    chunk step's one launch, then the merge) against the lane as it ran
    before its kernel on the same prepared queries: each chunk's product
    (`torch.mm` in f32) and `select_topk`, then the same merge (of the top
    K + 1, for the gap after the K-th).  Prints the rows whose ids or
    score bits differ.  `tie_tol` None (phase 3): fails on any such row,
    the two routes giving the same bits, rank for rank (each score one f32
    chain over k ascending, the chain stopped at the real width adding
    only +0.0; PERF.md section 6).  Else (phase 3d's 1,536-wide rows,
    where cuBLAS may sum in another order): fails on a row whose ids
    differ unless the route's K-th and (K + 1)-th scores lie within
    `tie_tol`.  Returns (rows differing in ids, in score bits, near-tie
    rows)."""
    import torch

    from cozo_tpu_torch.ops import exact_knn as ek
    from cozo_tpu_torch.utils.device import prepare_queries

    st = index._sweep_table
    n_chunks, chunk, d_pad = st.tbl.shape
    q = prepare_queries(torch.from_numpy(np.ascontiguousarray(qs, np.float32))
                        .to(st.tbl.device), index.distance, d_pad)
    got = ek._sweep(st.tbl, st.bias, q, K, "f32", d_in=index.dim)
    kc = min(K + 1, chunk)
    bufs = ek._chunk_buffers(q.shape[0], n_chunks, kc, torch.float32,
                             q.device)
    ek.sweep_two_step(q, st.tbl.reshape(-1, d_pad), chunk, kc,
                      st.bias.reshape(-1), None, None, 0, bufs)
    bs, bi = ek.merge_chunks(*bufs, K + 1)
    want = torch.cat([bi[:, :K].to(torch.int32),
                      bs[:, :K].view(torch.int32)], dim=1)
    ids_g, ids_w = got[:, :K], want[:, :K]
    row_ids = (ids_g != ids_w).any(1)
    rows_ids = int(row_ids.sum())
    rows_bits = int((got != want).any(1).sum())
    near = (bs[:, K - 1] - bs[:, K]).abs() <= (tie_tol or 0.0)
    rows_near = int(near.sum())
    sets = float(np.mean([set(a) == set(b) for a, b in
                          zip(ids_g.cpu().numpy(), ids_w.cpu().numpy())]))
    err = float((got[:, K:].view(torch.float32)
                 - want[:, K:].view(torch.float32)).abs().max())
    unexplained = rows_bits if tie_tol is None else int(
        (row_ids & ~near).sum())
    say(f"{phase} f32 lane against the two-step route (a chunk's torch.mm "
        f"+ slab_topk, then the merge) on the same queries: {rows_bits} of "
        f"{q.shape[0]} rows differ in ids or score bits ({rows_ids} in ids; "
        f"ids equal as sets on {sets:.5f}; max |score diff| {err:.3g})"
        + ("" if tie_tol is None else
           f"; {rows_near} rows whose {K}th and {K + 1}th scores lie within "
           f"{tie_tol:g}, {unexplained} rows differing in ids outside them"))
    if unexplained:
        raise SystemExit(f"{phase} failed: the f32 lane's kernel and its "
                         f"two-step route disagree")
    return rows_ids, rows_bits, rows_near


def phase_quant_dispatch(index, qs, gt):
    """The quant lane through `HnswIndex.search`, the f32 budget lowered
    for these calls only so that the table counts as past it."""
    from cozo_tpu_torch.ops.quant_knn import quant_search

    os.environ["COZO_TPU_F32_TABLE_MAX"] = "1"
    topk_zero()
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
    topk_read("index quant (phase 3)", "phase 3", sweep=False)
    r = recall(ids, gt)
    ok = (index._quant_sweep is not None and ids.shape == (NQ, K)
          and np.isfinite(dists[ids >= 0]).all() and r >= BARS["quant"])
    say(f"phase 3 lane quant (HnswIndex.search past the budget): median "
        f"{np.median(qps):.1f} QPS min {min(qps):.1f} (device scan + pull "
        f"{np.median(scan_s):.3f}s, host re-rank {np.median(rerank_s):.3f}s; "
        f"earlier, PERF.md section 5: {EARLIER_LANE_MS['quant']}; "
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


def build_db(data, engine="mem", path=""):
    """`Db(engine, path)` holding `data` as `item {id: Int => v}`, ingested
    by `:put` batches of 50,000 ndarray rows, and `::hnsw create item:ix`
    (cosine, m = 16, ef_construction = 200) as the packed KV image, which
    every index past 2M rows takes by default (a row image of 1.18M rows
    is 20-30M KV rows encoded in Python).  Returns the Db and the seconds
    of the ingest, the DDL and the bulk build inside it."""
    import torch

    from cozo_tpu_torch import Db
    from cozo_tpu_torch.models.hnsw_index import HnswIndex

    n, d = data.shape
    out = {}
    db = Db(engine, path)
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
    topk_zero()
    db, out = build_db(data)
    topk_read("db ::hnsw create (phase 5)", "phase 5", sweep=True)
    topk_zero()
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
                       "fused_sweep": fs.fused_sweep.launches,
                       "slab_topk": topk_read("db (phase 5)", "phase 5",
                                              sweep=True),
                       "sweep_topk": SWEEP_LAUNCHES["db (phase 5)"],
                       "sweep_topk_ddl": SWEEP_LAUNCHES[
                           "db ::hnsw create (phase 5)"],
                       "slab_topk_ddl": TOPK_LAUNCHES[
                           "db ::hnsw create (phase 5)"]}
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


def zero_all_counts():
    from cozo_tpu_torch.ops import fused_sweep as fs
    from cozo_tpu_torch.ops import minhash as mh
    from cozo_tpu_torch.ops import vector_search as vs

    topk_zero()
    vs.beam_search.launches = fs.fused_sweep.launches = 0
    fs.fused_sweep.route_launches = dict.fromkeys(fs.ROUTES, 0)
    mh.segment_min.launches = 0
    zero_graph_counts()


def all_counts():
    from cozo_tpu_torch.ops import exact_knn as ek
    from cozo_tpu_torch.ops import fused_sweep as fs
    from cozo_tpu_torch.ops import minhash as mh
    from cozo_tpu_torch.ops import vector_search as vs

    return {"beam_search": vs.beam_search.launches,
            "slab_topk": ek.select_topk.launches,
            "sweep_topk": ek.sweep_topk.launches,
            "minhash": mh.segment_min.launches, **graph_counts(),
            **{f"fused_sweep[{r}]": c
               for r, c in fs.fused_sweep.route_launches.items()}}


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


def db_pagerank(db, dev, out):
    """PageRank (10 steps) through the Db over the level-0 graph, cold and
    warm, held to the plain version on the CSR the Db staged; the numbers
    go into `out`, `out["pagerank_ok"]` the verdict.  Returns the rows."""
    import torch

    from cozo_tpu_torch.ops import graph_algos as ga

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
               pagerank_medges_per_s=10 * e / out["pagerank_warm_s"] / 1e6,
               pagerank_ok=len(rows) == n and l1 <= PR_L1_TOL and top)
    return rows


def phase_graph_db(db, dev, reps=5):
    """Phase 6: PageRank, LabelPropagation and ShortestPathDijkstra
    through the Db over the level-0 proximity graph of the index phase 5
    built, read straight from the index relation; each cold and warm and
    held to the plain versions (SSSP to a host BFS) on the same CSR."""
    from cozo_tpu_torch.ops import graph_algos as ga

    out = {}
    zero_graph_counts()
    db_pagerank(db, dev, out)
    indptr, dst, verts = cached_csr(db, False)
    n, e = out["nodes"], out["edges"]
    ck = ga.graph_content_key(indptr, dst)
    ok = out["pagerank_ok"]
    l1, top = out["pagerank_l1"], out["pagerank_top100_same"]
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


def scale_graphs():
    """Phase 7's two graphs at benches/graph_scale_bench.py's sizes, each
    with its content key, and the unit weights: (ip, d, ck, w, hp, hd,
    hck)."""
    from cozo_tpu_torch.ops import graph_algos as ga

    ip, d = make_graph(LJ_NODES, LJ_EDGES)
    hp, hd = make_hub_graph(HUB_NODES, HUB_EDGES, HUB_DEG)
    return (ip, d, ga.graph_content_key(ip, d), np.ones(LJ_EDGES, np.float32),
            hp, hd, ga.graph_content_key(hp, hd))


def phase_graph_scale(dev, reps, db_timings, graphs=None):
    """Phase 7: the shapes of benches/graph_scale_bench.py through the
    entry points: PageRank and single-source SSSP (unit weights: the
    uniform scalar, the source array PageRank put on the card) on the
    LiveJournal-scale graph, LabelPropagation on the hub graph (the hub
    past COZO_TPU_LP_TIER_MAX takes the host lane every step); each cold
    and warm, then held to the plain versions.  Then phase 4 for the graph
    kernels at these shapes.  `graphs`: the `HostJob` of `scale_graphs`
    (None: made here).  Returns their `kernels` entries and the launches
    of this path."""
    import torch

    from cozo_tpu_torch.ops import graph_algos as ga

    out = {"config": "benches/graph_scale_bench.py (BASELINE #3)",
           "reduced": []}
    n, e = LJ_NODES, LJ_EDGES
    ((ip, d, ck, w, hp, hd, hck), out["datagen_s"],
     out["datagen_waited_s"]) = host_result(graphs, scale_graphs)
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
        f"both graphs {out['datagen_s']:.1f}s, "
        f"{out['datagen_waited_s']:.1f}s of it waited for here): cold "
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
    mesh_graph = phase_mesh_graph(dev, ip, d, sp[0][0])

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
    return kernels, out["launches"], mesh_graph


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
# `::lsh create` with 128 permutations at threshold 0.7; phase 8 makes its
# docs at LSH_N (8 backfill chunks, not 31), so that the whole run ends
# well inside its 1,200 s (the phase's host work is ~180 s at 1M docs)
LSH_BENCH_N, LSH_N = 1_000_000, 262_144
LSH_VOCAB, LSH_PLANTED = 50_000, 1000
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


def lsh_host_chunk(texts, n_perm):
    """One backfill chunk's (hashes, doc starts, host signatures): the
    signatures from the host `minhash_segments` over the chunk's
    `hash_tokens_dedup` hashes (the `Simple` tokenizer, n_gram 1)."""
    from cozo_tpu_torch.fts.tokenizer import build_analyzer
    from cozo_tpu_torch.ops.minhash import hash_tokens_dedup, minhash_segments

    toks = build_analyzer(("Simple", []), []).analyze_texts(texts)
    lens = np.fromiter((len(t) for t in toks), np.int64, len(toks))
    offs = np.zeros(len(toks), np.int64)
    np.cumsum(lens[:-1], out=offs[1:])
    flat = hash_tokens_dedup([t for ts in toks for t in ts])
    return flat, offs, minhash_segments(flat, offs, n_perm)


def lsh_host_chunks(docs, n_perm):
    """`lsh_host_chunk` of every backfill chunk, in order, the chunks
    spread over worker processes (spawned, one a core the process may use
    but its own: the tokenizer is Python, so threads would share one core;
    all of them stopped on return)."""
    import multiprocessing as mp
    from concurrent.futures import ProcessPoolExecutor

    workers = max(1, min(len(os.sched_getaffinity(0)) - 1, 8))
    with ProcessPoolExecutor(workers, mp_context=mp.get_context("spawn")) as ex:
        yield from ex.map(lsh_host_chunk,
                          (docs[s:s + LSH_CHUNK]
                           for s in range(0, len(docs), LSH_CHUNK)),
                          itertools.repeat(n_perm))


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

    out = {"n_docs": n_docs, "n_perm": LSH_N_PERM, "target_threshold": 0.7,
           "reduced": [f"{n_docs:,} of {LSH_BENCH_N:,} docs"]
           if n_docs < LSH_BENCH_N else []}
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


# ------------------------------------------ the mesh and the engines

MESH_DB_N, MESH_DB_Q = 65_536, 64  # phase 9's Db through the mesh
MESH_RECALL_SLACK, MESH_DB_RECALL = 0.002, 0.95
MESH_QUERY = ("?[id, d] := ~item:ix{id | query: vec($q), k: 10, ef: 64, "
              "bind_distance: d}")
ENGINES = ("tkv", "plog", "remote")
ENGINE_N, ENGINE_NQ = 262_144, 1024  # phase 10: phase 3c's size
REMOTE_N = ENGINE_N


def phase_mesh_sweep(index, data, qs, truth, dev, reps):
    """Phase 9, the sweep: a `ShardedSweep` over phase 3's index on a mesh
    of [cuda:0] and of [cuda:0, cuda:0], B = 16,384, k = 10: recall@10
    against phase 3's f32 ground truth within MESH_RECALL_SLACK of the raw
    bf16 lane's, the two meshes' ids equal but at exact score ties, QPS
    and the merge's share of a batch; then a `Db("mem")` on the card
    holding the first MESH_DB_N rows, with the 2-shard mesh installed as
    the serving mesh: MESH_DB_Q single `~item:ix` queries answered by the
    index's `_mesh_sweep`, equal to `ShardedSweep.search` called directly,
    recall@10 >= MESH_DB_RECALL against the exact top-10.  Returns the
    numbers of the `mesh` line."""
    import torch

    from cozo_tpu_torch.parallel import mesh as pm

    out = {"n": int(index.n), "nq": NQ, "k": K,
           "raw_bf16_recall@10": truth["raw_recall"]}
    runs = {}
    topk_zero()
    for shards in (1, 2):
        mesh = pm.make_mesh(devices=[dev] * shards)
        t0 = time.time()
        ss = pm.ShardedSweep(mesh, index)
        torch.cuda.synchronize()
        build_s = time.time() - t0
        ss.search(qs, K)  # warm
        per = []
        for _ in range(reps):
            t0 = time.perf_counter()
            ids, dists = ss.search(qs, K)
            per.append(time.perf_counter() - t0)
        qp = ss.prepare_queries(qs)
        t0 = time.perf_counter()
        parts = ss.local_scan(qp, K)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        m_ids, m_sc = ss.merge(parts, K)
        torch.cuda.synchronize()
        merge_s = time.perf_counter() - t1
        rec = recall(ids, truth["gt"])
        runs[shards] = (ids, m_ids.cpu().numpy(), m_sc.cpu().numpy())
        res = {"build_s": build_s, "chunks": ss.n_chunks,
               "batch_s_median": float(np.median(per)),
               "qps": NQ / float(np.median(per)), "per_rep_s": per,
               "scan_s": t1 - t0, "merge_s": merge_s,
               "merge_share": merge_s / float(np.median(per)),
               "recall@10": rec}
        out[f"shards_{shards}"] = res
        ok = (ids.shape == (NQ, K) and np.isfinite(dists).all()
              and rec >= truth["raw_recall"] - MESH_RECALL_SLACK)
        say(f"phase 9 ShardedSweep on {mesh}: {ss.n_chunks} chunks of "
            f"{ss.chunk} built in {build_s:.2f}s; B={NQ}: median "
            f"{res['batch_s_median'] * 1e3:.1f} ms a batch = {res['qps']:.0f} "
            f"QPS (the shards' scans {res['scan_s'] * 1e3:.1f} ms, the merge "
            f"{merge_s * 1e3:.2f} ms = {100 * res['merge_share']:.2f}%); "
            f"recall@10 {rec:.5f} (the raw bf16 lane's {truth['raw_recall']:.5f}"
            f" less {MESH_RECALL_SLACK}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit("phase 9 failed: the sharded sweep")
        del ss, parts
        torch.cuda.empty_cache()
    topk_read("mesh (phase 9)", "phase 9", sweep=True)
    (ids1, mi1, ms1), (ids2, mi2, ms2) = runs[1], runs[2]
    differ = mi1 != mi2
    tied = bool((ms1[differ] == ms2[differ]).all())
    out["one_vs_two_shards_ids_differ"] = int(differ.sum())
    ok = bool(np.array_equal(ms1, ms2)) and tied and np.array_equal(
        ids1 != ids2, differ)
    say(f"phase 9 one shard against two: {int(differ.sum())} of {differ.size}"
        f" ids differ, each at an exactly tied score {tied}, the scores equal "
        f"{np.array_equal(ms1, ms2)} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("phase 9 failed: one shard and two disagree")

    db, built = build_db(data[:MESH_DB_N])
    mesh2 = pm.make_mesh(devices=[dev, dev])
    q = qs[:MESH_DB_Q]
    pm.set_serving_mesh(mesh2)
    try:
        t0 = time.time()
        first = db.run_script(MESH_QUERY, {"q": q[0]}).rows
        first_s = time.time() - t0
        lat, rows = [], []
        for i in range(MESH_DB_Q):
            t0 = time.perf_counter()
            rows.append(db.run_script(MESH_QUERY, {"q": q[i]}).rows)
            lat.append((time.perf_counter() - t0) * 1e3)
    finally:
        pm.set_serving_mesh(None)
    cache = db.algo_cache["hnsw::item::ix"]
    ss = cache.index._mesh_sweep
    sid = cache.slot_ids_array()
    want = []
    for b in range(MESH_DB_Q):  # one at a time, as the Db asked (a product
        d_ids, d_d = ss.search(q[b:b + 1], K)  # of another B may round
        want.append(sorted((int(sid[i]), float(x))  # otherwise)
                           for i, x in zip(d_ids[0], d_d[0]) if i >= 0))
    got = [sorted((int(i), float(x)) for i, x in r) for r in rows]
    same = got == want and sorted(first) == sorted(rows[0])
    x = data[:MESH_DB_N].astype(np.float64)
    xn = x / np.linalg.norm(x, axis=1, keepdims=True)
    qn = q / np.linalg.norm(q, axis=1, keepdims=True)
    gt = np.argsort(-(qn @ xn.T), axis=1)[:, :K]
    ids_db = np.array([[i for i, _ in sorted(r, key=lambda t: t[1])][:K]
                       for r in got])
    rec = recall(ids_db, gt)
    out["db"] = {"n": MESH_DB_N, "queries": MESH_DB_Q, "shards": ss.n_shards,
                 "ddl_s": built["ddl_s"], "first_query_s": first_s,
                 "query_ms_median": float(np.median(lat)), "recall@10": rec,
                 "rows_equal_direct": same}
    ok = same and ss.n_shards == 2 and rec >= MESH_DB_RECALL
    say(f"phase 9 Db through the mesh ({MESH_DB_N} rows, the 2-shard mesh "
        f"installed): the first query {first_s:.2f}s (the mesh table built), "
        f"then {MESH_DB_Q} single queries median {np.median(lat):.2f} ms; "
        f"answered by the index's _mesh_sweep ({ss.n_shards} shards), rows "
        f"equal to ShardedSweep.search called directly {same}, recall@10 "
        f"against the exact top-10 {rec:.4f} (bar {MESH_DB_RECALL}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("phase 9 failed: the Db query through the mesh")
    return out


def phase_mesh_graph(dev, ip, dst, sp_dist):
    """Phase 9, the graph steps on phase 7's LiveJournal-shaped graph, its
    edges sharded over 2 shards of the card: 10 PageRank steps built from
    `sharded_pagerank_step` (as `__graft_entry__.py` builds them: 0.15 / n
    + 0.85 x the incoming mass) within L1 PR_L1_TOL of the same loop
    unsharded in f64, two runs bit-identical; `sharded_sssp_step` iterated
    to its fixed point from node 0 (unit weights), the distances equal to
    phase 7's `sssp_device`.  Returns the numbers of the `mesh` line."""
    import torch

    from cozo_tpu_torch.parallel import mesh as pm

    n, e = len(ip) - 1, len(dst)
    src = np.repeat(np.arange(n, dtype=np.int64), np.diff(ip))
    deg = np.maximum(np.bincount(src, minlength=n), 1).astype(np.float32)
    mesh2 = pm.make_mesh(devices=[dev, dev])
    s_sh, d_sh = pm.shard_array(mesh2, src), pm.shard_array(mesh2, dst)
    step = pm.sharded_pagerank_step(mesh2, src, dst, deg, n)
    out = {"nodes": n, "edges": e, "shards": 2}

    def ten_steps():
        ranks = torch.full((n,), 1.0 / n, device=dev)
        for _ in range(10):
            ranks = 0.15 / n + 0.85 * step(s_sh, d_sh, ranks)
        return ranks

    t0 = time.time()
    step(s_sh, d_sh, torch.full((n,), 1.0 / n, device=dev))
    torch.cuda.synchronize()
    out["pagerank_layout_s"] = time.time() - t0  # the destination sorts
    t0 = time.time()
    r1 = ten_steps()
    torch.cuda.synchronize()
    out["pagerank_ms_per_step"] = (time.time() - t0) * 1e2
    r2 = ten_steps()
    bits = bool(torch.equal(r1, r2))
    src_t, dst_t = torch.from_numpy(src).to(dev), torch.from_numpy(dst).to(dev)
    deg64 = torch.from_numpy(deg).to(dev).double()
    ref = torch.full((n,), 1.0 / n, dtype=torch.float64, device=dev)
    for _ in range(10):
        inc = torch.zeros(n, dtype=torch.float64, device=dev).index_add_(
            0, dst_t, (ref / deg64)[src_t])
        ref = 0.15 / n + 0.85 * inc
    l1 = float((r1.double() - ref).abs().sum())
    del src_t, dst_t, deg64, ref, r2
    out.update(pagerank_l1_vs_f64=l1, pagerank_bit_identical=bits)
    ok = l1 <= PR_L1_TOL and bits
    say(f"phase 9 sharded PageRank, 10 steps on {n} nodes / {e} edges over 2 "
        f"shards of the card: layouts (a destination sort a shard) "
        f"{out['pagerank_layout_s']:.2f}s, then {out['pagerank_ms_per_step']:.2f}"
        f" ms a step; L1 against the unsharded f64 loop {l1:.3e} (tol "
        f"{PR_L1_TOL}), two runs bit-identical {bits} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("phase 9 failed: sharded PageRank")

    w_sh = pm.shard_array(mesh2, np.ones(e, np.float32))
    sstep = pm.sharded_sssp_step(mesh2, n)
    dist = torch.full((n,), float("inf"), device=dev)
    dist[0] = 0
    t0 = time.time()
    for steps in range(1, 10_000):
        new = sstep(s_sh, d_sh, w_sh, dist)
        if torch.equal(new, dist):  # a host sync a step
            break
        dist = new
    else:
        raise SystemExit("phase 9 failed: sharded SSSP did not settle")
    out["sssp_ms_per_step"] = (time.time() - t0) * 1e3 / steps
    got = dist.cpu().numpy()
    same = bool(np.array_equal(got, np.asarray(sp_dist, np.float32)))
    out.update(sssp_steps=steps, sssp_reached=int(np.isfinite(got).sum()),
               sssp_equal_phase7=same)
    say(f"phase 9 sharded SSSP from node 0 (unit weights) over 2 shards: "
        f"{steps} steps to the fixed point (the last one confirms it), "
        f"{out['sssp_ms_per_step']:.2f} ms a step, {out['sssp_reached']} "
        f"reached; distances equal to phase 7's sssp_device {same} "
        f"{'ok' if same else 'FAIL'}")
    if not same:
        raise SystemExit("phase 9 failed: sharded SSSP")
    del s_sh, d_sh, w_sh, dist, new
    torch.cuda.empty_cache()
    return out


def start_kvserver(path):
    """`python -m cozo_tpu_torch.hosts.kvserver --engine tkv` on a free
    local port, from this checkout; returns (the process, its address)."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    log = open(path + ".log", "w")
    proc = subprocess.Popen(
        [sys.executable, "-u", "-m", "cozo_tpu_torch.hosts.kvserver",
         "--engine", "tkv", "--path", path, "--port", str(port)],
        cwd=os.path.dirname(os.path.abspath(__file__)),
        stdout=subprocess.PIPE, stderr=log, text=True)
    line = proc.stdout.readline()
    if f"on 127.0.0.1:{port}" not in line:
        proc.kill()
        proc.wait()
        log.close()
        with open(path + ".log") as f:
            raise SystemExit(f"phase 10 failed: the kv server did not start: "
                             f"{line!r} {f.read()[-2000:]}")
    return proc, f"127.0.0.1:{port}"


def engine_run(engine, data, qs, dev, root):
    """Phase 10 on one engine (see `phase_engines`).  Returns its numbers."""
    from cozo_tpu_torch import Db, sweep_search

    n = len(data)
    path = os.path.join(root, "db")
    server = None
    if engine == "remote":
        server, path = start_kvserver(os.path.join(root, "kv"))
    try:
        db, out = build_db(data, engine, path)
        cache = db.algo_cache["hnsw::item::ix"]
        index = cache.index
        ok = cache.packed and np.array_equal(cache.slot_ids_array(),
                                             np.arange(n))
        if not ok:
            raise SystemExit(f"phase 10 failed: the DDL build on {engine}")
        store_queries(db, "q", qs[:ENGINE_NQ])
        small = qs[ENGINE_NQ:ENGINE_NQ + DB_SMALL]
        store_queries(db, "q16", small)
        join = JOIN.format(rel="q")
        t0 = time.time()
        db.run_script(join)
        out["join_cold_s"] = time.time() - t0
        reps = []
        for _ in range(3):
            t0 = time.time()
            res = db.run_script(join)
            reps.append(time.time() - t0)
        out["join_qps"] = ENGINE_NQ / float(np.median(reps))
        ids_j, d_j = join_ids(res.rows, ENGINE_NQ)
        gt = sweep_search(index, qs[:ENGINE_NQ], K, rt=1.0,
                          compute_dtype="f32", exact_rerank=False)[0]
        out["join_recall@10"] = recall(ids_j, gt)
        small_rows = sorted(db.run_script(JOIN.format(rel="q16")).rows)
        ids_s = join_ids(small_rows, DB_SMALL)[0]
        ids_x = index.search(small, K, 64)[0]
        out["small_join_equal"] = bool(np.array_equal(ids_s, ids_x))
        pr = {}
        pr_rows = sorted(db_pagerank(db, dev, pr))
        out.update({k: pr[k] for k in ("pagerank_cold_s", "pagerank_warm_s",
                                       "pagerank_l1", "pagerank_top100_same",
                                       "nodes", "edges")})
        probe = sorted(db.run_script(MESH_QUERY, {"q": qs[-1]}).rows)
        count = db.run_script("?[count(id)] := *item{id}").rows
        ok = (out["join_recall@10"] >= 0.999 and out["small_join_equal"]
              and pr["pagerank_ok"] and count == [[n]])
        say(f"phase 10 {engine}: ingest {n} rows in {out['ingest_s']:.1f}s "
            f"({out['ingest_rows_per_s']:.0f} rows/s), ::hnsw create "
            f"{out['ddl_s']:.1f}s (bulk_build {out['bulk_build_s']:.1f}s); "
            f"pivot join (B={ENGINE_NQ}) cold {out['join_cold_s']:.2f}s, "
            f"{out['join_qps']:.0f} QPS warm, recall@10 "
            f"{out['join_recall@10']:.5f} (bar 0.999); small join ids equal "
            f"to index.search {out['small_join_equal']}; PageRank over "
            f"{pr['nodes']} nodes / {pr['edges']} edges warm "
            f"{pr['pagerank_warm_s']:.2f}s, L1 against the plain version "
            f"{pr['pagerank_l1']:.3e}, top-100 same "
            f"{pr['pagerank_top100_same']} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"phase 10 failed: {engine}")

        if engine != "remote":
            db.close()
        del db, index, cache
        t0 = time.time()
        db = Db(engine, path)
        out["reopen_s"] = time.time() - t0
        t0 = time.time()
        probe2 = sorted(db.run_script(MESH_QUERY, {"q": qs[-1]}).rows)
        out["first_search_after_reopen_s"] = time.time() - t0
        same = {
            "rows": db.run_script("?[count(id)] := *item{id}").rows == count,
            "search": probe2 == probe,
            "small_join": sorted(db.run_script(
                JOIN.format(rel="q16")).rows) == small_rows,
            "pagerank": sorted(db.run_script(GRAPH_PR).rows) == pr_rows,
        }
        out["read_back_equal"] = same
        how = "a second client" if engine == "remote" else "reopened"
        ok = all(same.values())
        say(f"phase 10 {engine} {how}: open {out['reopen_s']:.2f}s, the first "
            f"search (the index cache rebuilt from KV) "
            f"{out['first_search_after_reopen_s']:.2f}s; equal afterwards: "
            f"{same} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"phase 10 failed: {engine} read back otherwise")
        if engine != "remote":
            db.close()
    finally:
        if server is not None:
            server.terminate()
            server.wait(timeout=60)
    return out


def phase_engines(data, qs, dev):
    """Phase 10: the tkv, plog and remote engines on the card.  On each, a
    Db (for remote, a client of `python -m cozo_tpu_torch.hosts.kvserver
    --engine tkv`) ingests ENGINE_N rows of phase 3's draw by `:put`
    batches of 50,000 and runs `::hnsw create` with phase 5's options;
    the pivot join of ENGINE_NQ stored queries (recall@10 >= 0.999
    against the exact f32 lane), the small join (B = 16, the beam kernel;
    ids equal to `HnswIndex.search`), PageRank over the level-0 graph
    (held to the plain version); then the Db is closed and reopened (for
    remote: a second client): the row count, one search, the small join
    and PageRank equal.  Prints the `engines` line; returns the kernels'
    launches on this path."""
    import shutil
    import tempfile

    zero_all_counts()  # counts of this path only
    out = {"config": "phase 5's script (benches/bench_hybrid_1m.py phases "
                     "1-4 and PageRank) on each engine",
           "reduced": [f"{ENGINE_N} of {N} rows (phase 3c's size)",
                       f"the pivot join {ENGINE_NQ} of {DB_NQ} queries"]}
    if REMOTE_N != ENGINE_N:
        out["reduced"].append(f"remote: {REMOTE_N} rows")
    for engine in ENGINES:
        root = tempfile.mkdtemp(prefix=f"cozo_phase10_{engine}_")
        try:
            t0 = time.time()
            rows = REMOTE_N if engine == "remote" else ENGINE_N
            out[engine] = engine_run(engine, data[:rows], qs, dev, root)
            out[engine]["phase_s"] = time.time() - t0
        finally:
            shutil.rmtree(root, ignore_errors=True)
    launches = all_counts()
    out["launches"] = launches
    say(f"phase 10 kernel launches on the engines path: {launches}")
    if launches["beam_search"] < len(ENGINES) or \
            launches["graph_pagerank"] < len(ENGINES) or \
            launches["sweep_topk"] < len(ENGINES):
        raise SystemExit("phase 10 failed: a kernel of the path never launched")
    topk_read("engines (phase 10)", "phase 10", sweep=True)
    out["card"] = smi_line()
    say("engines " + json.dumps(out))
    return launches


def add_path_launches(kernels, path, counts):
    """Each entry of the `kernels` line gains this path's launches."""
    for entry in kernels:
        c = counts.get(entry["name"], 0)
        entry.setdefault("launches_by_path", {})[path] = c
        entry["launches"] += c


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


def wide_index(data, norms, device=None):
    """What `SweepTable.refresh` and `SweepTable.search` read of an index
    (`n`, `dim`, `vectors`, `alive`, `norms`, `distance`, `version`,
    `sweep_pending`, `device`: None is the card) for cosine rows all
    alive: the sweep lanes read no graph, so phase 3b serves its draw
    through them unbuilt."""
    from types import SimpleNamespace

    return SimpleNamespace(n=len(data), dim=data.shape[1], vectors=data,
                           alive=np.ones(len(data), bool), norms=norms,
                           distance="Cosine", version=0, sweep_pending=set(),
                           device=device)


def piece_kw(kw, cols):
    """`sweep_topk`'s keyword arguments cut to the table rows `cols`."""
    return {k: v if k == "row_scale" else v[cols] for k, v in kw.items()}


def two_step_split(q, tbl, piece, kc, kw, reps):
    """(product ms, selection ms) of one call of `sweep_topk`'s two-step
    route, each the median over `reps` rounds after a warm one of its sum
    over the pieces: CUDA events around each piece's product (`mm_bf16`,
    `int_mm` or f32 `torch.mm`) and its `select_topk`, as
    `exact_knn.sweep_two_step` runs them; the last round's answer must
    agree with `sweep_topk`'s at the same piece (`sweep_values_agree`: int8
    bit-equal, bf16 and f32 within its tolerance)."""
    import torch

    from cozo_tpu_torch.ops import exact_knn as ek
    from cozo_tpu_torch.utils.device import int_mm

    int8 = q.dtype == torch.int8
    n_pieces = tbl.shape[0] // piece
    out = ek._chunk_buffers(q.shape[0], n_pieces, kc, torch.bfloat16 if int8
                            else torch.float32, q.device)
    rounds = []
    for _ in range(reps + 1):
        marks = []
        for p in range(n_pieces):
            cols = slice(p * piece, (p + 1) * piece)
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            ev[0].record()
            slab = (int_mm if int8 else ek._piece_product)(q, tbl[cols])
            ev[1].record()
            ek.select_topk(slab, kc, bf16=int8, offset=p * piece,
                           out=ek._cols(out, p, kc), **piece_kw(kw, cols))
            ev[2].record()
            marks.append(ev)
            del slab
        torch.cuda.synchronize()
        rounds.append((sum(a.elapsed_time(b) for a, b, _ in marks),
                       sum(b.elapsed_time(c) for _, b, c in marks)))
    if not sweep_values_agree(out, ek.sweep_topk(q, tbl, piece, kc, **kw))[0]:
        raise SystemExit("the split two-step route differs from "
                         "sweep_topk's")
    return (float(np.median([r[0] for r in rounds[1:]])),
            float(np.median([r[1] for r in rounds[1:]])))


def key_ties(q, tbl, piece, kc, kw):
    """(median, max) over rows and pieces of the keys equal to the piece's
    kc-th key, on the two-step route's slabs (the selection keeps a tie's
    lowest positions)."""
    import torch

    counts = []
    for p in range(tbl.shape[0] // piece):
        cols = slice(p * piece, (p + 1) * piece)
        key = sweep_slab_keys(q, tbl[cols], piece_kw(kw, cols)).float()
        kth = torch.topk(key, kc, dim=1).values[:, -1:]
        counts.append((key == kth).sum(1))
        del key
    c = torch.stack(counts).float()
    return float(c.median()), int(c.max())


# the lanes phases 3b and 3d serve: (compute dtype, re-ranked)
WIDE_LANES = {"bf16+rerank": ("bf16", None),
              "i8+rerank": ("i8", WIDE_I8_RERANK),
              "f32": ("f32", None)}


def lane_chunk_step(st, cd, qs, d):
    """(q, tbl, keyword arguments, d_real) of the chunk step a lane hands
    `sweep_topk` on sweep table `st` of rows d wide for queries `qs` (on
    the card): bf16 and int8 queries as `prepare_queries` rounds them, f32
    exact (its chains stop at d); the flat table of the lane's kind and its
    vectors."""
    import torch

    from cozo_tpu_torch.utils.device import prepare_queries

    d_pad = st.d_pad
    bias = {"bias": st.bias.reshape(-1)}
    if cd == "f32":
        return (prepare_queries(qs, "Cosine", d_pad).contiguous(),
                st.tbl.reshape(-1, d_pad), bias, d)
    if cd == "i8":
        _, q8, rs8 = prepare_queries(qs, "Cosine", d_pad, half=True,
                                     quantize=True, reciprocal=True)
        return (q8, st.tbl_i8.reshape(-1, d_pad),
                {**bias, "col_scale": st.scale_i8.reshape(-1),
                 "row_scale": rs8}, 0)
    q16 = prepare_queries(qs, "Cosine", d_pad, half=True,
                          reciprocal=True).to(torch.bfloat16)
    return q16, st.tbl_bf16, bias, 0


def step_in_turns(q, tbl, chunk, kc, kw, d_real, clocks):
    """One chunk step on the kernel (the piece `sweep_piece` picks), in
    SWEEP_TURNS turns with the two-step route a chunk at a time split into
    its products and selections (`two_step_split`), `torch.mm` (or
    `torch._int_mm`) + `torch.topk` a chunk (`sweep_library`), the bound
    (the products at their kind's peak) and, with `clocks`, the SM clock
    and power under the kernel and under one chunk's product of the route
    (`clock_under`).  Returns its numbers."""
    import torch

    from cozo_tpu_torch.ops import exact_knn as ek
    from cozo_tpu_torch.utils.device import int_mm

    B, d_pad = q.shape
    int8, f32 = q.dtype == torch.int8, q.dtype == torch.float32
    kind = ek.SWEEP_F32 if f32 else int(int8)
    n_total = tbl.shape[0]
    piece = ek.sweep_piece(n_total, chunk, B, d_pad, kc, kind, q.device)
    real = {"d_real": d_real} if f32 and d_real else {}
    buf = ek._chunk_buffers(B, n_total // piece, kc,
                            torch.bfloat16 if int8 else torch.float32,
                            q.device)
    kern, split = [], []
    for _ in range(SWEEP_TURNS):
        kern.append(cuda_ms(lambda: ek.sweep_topk(q, tbl, piece, kc, out=buf,
                                                  **kw, **real),
                            OTHER_LANE_REPS))
        split.append(two_step_split(q, tbl, chunk, kc, kw, 1))
    out = {"piece": piece, "pieces": n_total // piece, "kc": kc,
           "route": ek.sweep_route(d_pad, kc, piece),
           "kernel_ms": float(np.median(kern)), "kernel_turns": kern,
           "product_ms": float(np.median([x[0] for x in split])),
           "selection_ms": float(np.median([x[1] for x in split])),
           "two_step_turns": split,
           "library_ms": cuda_ms(lambda: sweep_library(q, tbl, chunk, kc, kw),
                                 1),
           "bound_ms": 2.0 * B * n_total * (d_real or d_pad) / (
               PEAK_INT8 if int8 else PEAK_F32 if f32 else PEAK_BF16) * 1e3}
    if clocks:
        out["clock_mhz_power_w"] = clock_under(
            lambda: ek.sweep_topk(q, tbl, piece, kc, out=buf, **kw, **real))
        mm = int_mm if int8 else ek._piece_product
        out["two_step_clock_mhz_power_w"] = clock_under(
            lambda: mm(q, tbl[:chunk]))
    del buf
    torch.cuda.empty_cache()
    return out


def step_line(s):
    """The printed form of `step_in_turns`'s numbers."""
    k = s["kernel_ms"]
    two = s["product_ms"] + s["selection_ms"]
    return (f"kc {s['kc']} on the kernel ({s['route']} route, "
            f"{s['pieces']} piece(s)) {k:.3f} ms ({100 * s['bound_ms'] / k:.1f}% "
            f"of the products' bound {s['bound_ms']:.3f} ms; turns "
            f"{[round(x, 3) for x in s['kernel_turns']]}), the two-step route "
            f"in turns with it product {s['product_ms']:.3f} ms + selection "
            f"{s['selection_ms']:.3f} ms ({two / k:.2f}x the kernel's), "
            f"torch mm + topk a chunk {s['library_ms']:.3f} ms"
            + (f", SM clock and power (MHz, W) under the kernel "
               f"{s['clock_mhz_power_w']}, under a chunk's product "
               f"{s['two_step_clock_mhz_power_w']}"
               if "clock_mhz_power_w" in s else ""))


def phase_wide_lanes(data, norms, qs, gt, phase, lanes, more_kcs=(),
                     clocks=False):
    """A wide draw (`phase`: 3b's 768, 3d's 1,536) under the f32 budget,
    through the code `HnswIndex.search` runs for a batch of B >= 64 there
    (`sweep_search` -> `SweepTable.search` -> `sweep_topk`, its wide form
    and its f32 kind's streamed rows): each of `lanes` (WIDE_LANES:
    bf16+rerank, i8+rerank at WIDE_I8_RERANK re-ranked, its recall at
    phase 3's 64 printed beside with the ties of bf16 keys that cut it;
    f32 exact), the first two held to their bars against
    `brute_force_knn` on the first len(gt) queries, f32 to its two-step
    route on the same queries (`f32_truth_vs_two_step`, ids equal but at
    near-ties), its launches gated at what the calls imply (sweep_topk,
    the f32 kind apart, no two-step call), a batch timed on the host
    clock, its chunk step and one at each of `more_kcs` timed on the
    kernel in turns with the two-step route (`step_in_turns`, the SM
    clock with `clocks`); then phase 4's timings of the chunk steps at
    these rows (`time_wide_sweep`, the f32 kind's kc 10 where the f32
    lane is served).  Returns each lane's numbers."""
    import torch

    from cozo_tpu_torch import sweep_search
    from cozo_tpu_torch.models.hnsw_index import f32_table_budget
    from cozo_tpu_torch.ops import exact_knn as ek
    from cozo_tpu_torch.utils.device import to_device

    index = wide_index(data, norms)
    n, d = data.shape
    nq = len(qs)
    d_pad = -(-d // 128) * 128
    if n * d_pad * 4 > f32_table_budget():
        raise SystemExit(f"{phase} failed: the draw is past the f32 budget, "
                         f"so HnswIndex.search would not take the sweep")
    t0 = time.time()
    sweep_search(index, qs[:64], K)  # the table's refresh, from the host
    torch.cuda.synchronize()
    st = index._sweep_table
    say(f"{phase} sweep table {n} x {d_pad} f32 on the device, "
        f"{st.n_chunks} chunks of {st.chunk} (refresh "
        f"{time.time() - t0:.1f}s)")
    qd = to_device(np.ascontiguousarray(qs), st.device)
    out = {}
    for tag in lanes:
        cd, rk = WIDE_LANES[tag]
        f32 = cd == "f32"
        lane = {"rt": 1.0, "compute_dtype": cd, "exact_rerank": not f32,
                "rerank_k": rk}
        topk_zero()
        sweep_search(index, qs, K, **lane)  # warm
        ms = []
        for _ in range(OTHER_LANE_REPS):
            t0 = time.time()
            ids, dists = sweep_search(index, qs, K, **lane)
            ms.append(1e3 * (time.time() - t0))
        path = f"wide {tag} ({phase})"
        slab = topk_read(path, phase, sweep=True)
        two_calls = ek.sweep_topk.two_step  # 0: the gate holds it there
        r = recall(ids[:len(gt)], gt)
        ok = (ids.shape == (nq, K) and np.isfinite(dists).all()
              and (f32 or r >= BARS[tag]))
        # the chunk step as the lane hands it to sweep_topk
        kf = K if f32 else max(rk or 0, K + 16)  # as `SweepTable.search`
        q, tbl, kw, d_real = lane_chunk_step(st, cd, qd, d)
        steps = [step_in_turns(q, tbl, st.chunk, min(kc, st.chunk), kw,
                               d_real, clocks and kc == kf)
                 for kc in (kf, *more_kcs)]
        res = {"ms_a_batch": float(np.median(ms)), "per_rep_ms": ms,
               "recall@10": r, "rerank_k": kf, **steps[0],
               "more_kcs": steps[1:],
               "sweep_topk": SWEEP_LAUNCHES[path] + SWEEP_F32_LAUNCHES[path],
               "slab_topk": slab, "two_step_calls": two_calls}
        if cd == "i8":  # the overfetch phase 3 gives the lane, 64
            ids64, _ = sweep_search(index, qs, K, compute_dtype=cd,
                                    rerank_k=64)
            r64 = recall(ids64[:len(gt)], gt)
            ties = key_ties(q, tbl, st.chunk, 64, kw)
            res.update(recall_at_64=r64, key_ties_at_64=ties)
            if r < BARS[tag]:  # the ties at the lane's own overfetch
                res["key_ties_at_rerank"] = key_ties(q, tbl, st.chunk, kf, kw)
            say(f"{phase} lane {tag} with phase 3's 64 re-ranked: recall@10 "
                f"{r64:.5f} (bar {BARS[tag]}); bf16 keys equal to a "
                f"{st.chunk}-row chunk's 64th key: median {ties[0]:.0f}, max "
                f"{ties[1]} (ROADMAP.md section 3: the lane re-ranks {rk} "
                f"here)" + (f"; at {kf}: {res['key_ties_at_rerank']}"
                            if "key_ties_at_rerank" in res else ""))
        if f32:
            res["vs_two_step"] = dict(zip(
                ("rows_ids", "rows_bits", "rows_near_tie"),
                f32_truth_vs_two_step(index, qs, phase, tie_tol=1e-5)))
        del q, tbl, kw
        out[tag] = res
        say(f"{phase} lane {tag} at d_pad {d_pad} ({kf} "
            f"{'selected' if f32 else 're-ranked'}): B={nq} median "
            f"{np.median(ms):.1f} ms a batch ({ms}); the chunk step "
            + "; ".join(step_line(x) for x in steps)
            + f"; sweep_topk {res['sweep_topk']} launches, slab_topk {slab} "
            f"(the merges), two-step calls {two_calls}; recall@10 {r:.5f} on "
            f"{len(gt)} queries against brute_force_knn "
            f"({'no bar: held to its two-step route' if f32 else f'bar {BARS[tag]}'}) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"{phase} failed: lane {tag} at d_pad {d_pad}")
    time_wide_sweep(*lane_inputs(st, qd, d, "f32" in lanes),
                    tag="" if d_pad == QUANT_D else f" at d_pad {d_pad}")
    del index, st, qd
    torch.cuda.empty_cache()
    return out


def lane_inputs(st, qd, d, f32):
    """`sweep_wide_shapes`'s inputs from a wide sweep table of rows d
    wide and its queries on the card (`lane_chunk_step`'s; with `f32`,
    where its f32 lane was served, the f32 table and queries too)."""
    q16, tbl16, kw, _ = lane_chunk_step(st, "bf16", qd, d)
    q8, tbl8, kw8, _ = lane_chunk_step(st, "i8", qd, d)
    q32, tbl32 = (lane_chunk_step(st, "f32", qd, d)[:2] if f32
                  else (None, None))
    return (tbl16, tbl8, kw8["col_scale"], kw["bias"], st.chunk, q16, q8,
            kw8["row_scale"], tbl32, q32)


def sweep_wide_shapes(tbl16, tbl8, scale8, bias, chunk, q16, q8, rs8,
                      tbl32=None, q32=None):
    """The chunk steps at wide rows (phase 3b's 768, 3d's 1,536), as
    `sweep_main_shapes` yields them: [4,096 x n_total] bf16 kc 26 (the
    bf16 lane + its re-rank) and 10 (raw), int8 kc 64 and WIDE_I8_RERANK
    (the i8 lane), the f32-table build's kc 97 for a wave of 8,192 of the
    table's rows, and where the f32 table is given the f32 lane's kc 10."""
    i8 = {"bias": bias, "col_scale": scale8, "row_scale": rs8}
    yield "wide bf16 lane", q16, tbl16, chunk, 26, {"bias": bias}
    yield "wide bf16 raw", q16, tbl16, chunk, 10, {"bias": bias}
    yield "wide i8 lane", q8, tbl8, chunk, 64, i8
    yield (f"wide i8 lane, {WIDE_I8_RERANK} re-ranked", q8, tbl8, chunk,
           WIDE_I8_RERANK, i8)
    yield ("wide build step", tbl16[:8192].contiguous(), tbl16, chunk, 97,
           {"bias": bias})
    if tbl32 is not None:
        yield "wide f32 lane", q32, tbl32, chunk, 10, {"bias": bias}


def synthetic_wide_table(dev, seed=43, d=QUANT_D, n=QUANT_N, f32=False):
    """`sweep_wide_shapes`'s inputs at a wide shape, made on the card
    without an index: n (QUANT_N, phase 3b's) random unit rows of d
    (QUANT_D, phase 3b's 768, or 384, or 3d's 1,536; bf16, and int8 with
    their column scales as `quantize_tbl` makes them; with `f32` the f32
    table too), all alive, in chunks of 131,072 (the last past n dead),
    and QUANT_NQ random unit queries as `prepare_queries` makes them
    (bf16; int8 with their row scales; f32)."""
    import torch

    from cozo_tpu_torch.ops.exact_knn import _chunking, quantize_tbl
    from cozo_tpu_torch.utils.device import prepare_queries

    chunk, n_chunks = _chunking(n)
    g = torch.Generator(device=dev).manual_seed(seed)
    tbl = torch.zeros((n_chunks * chunk, d), device=dev)
    tbl[:n] = torch.nn.functional.normalize(
        torch.randn((n, d), generator=g, device=dev), dim=1)
    bias = torch.zeros(n_chunks * chunk, device=dev)
    bias[n:] = -np.inf
    tbl8, scale8 = quantize_tbl(tbl.view(-1, chunk, d),
                                bias.view(-1, chunk))
    tbl16 = tbl.to(torch.bfloat16)
    q = torch.nn.functional.normalize(
        torch.randn((QUANT_NQ, d), generator=g, device=dev), dim=1)
    q16 = prepare_queries(q, "Cosine", d, half=True,
                          reciprocal=True).to(torch.bfloat16)
    _, q8, rs8 = prepare_queries(q, "Cosine", d, half=True,
                                 quantize=True, reciprocal=True)
    f32 = ((tbl, prepare_queries(q, "Cosine", d).contiguous()) if f32
           else (None, None))
    del tbl
    return (tbl16, tbl8.reshape(-1, d), scale8.reshape(-1), bias, chunk,
            q16, q8, rs8, *f32)


def time_wide_sweep(*inputs, lanes=None, tag=""):
    """Phase 4's timings (`time_sweep_shape`) of the chunk steps at wide
    rows (`sweep_wide_shapes` of `inputs`; `lanes`: only those), the plain
    version over the whole table in blocks of WIDE_PLAIN_ROWS query rows.
    Kept in WIDE_SWEEP_SHAPES under the lane's name + `tag`."""
    import torch

    for lane, q, tbl, chunk, kc, kw in sweep_wide_shapes(*inputs):
        if lanes is None or lane in lanes:
            WIDE_SWEEP_SHAPES[lane + tag] = time_sweep_shape(
                lane + tag, q, tbl, chunk, kc, kw, OTHER_LANE_REPS,
                WIDE_PLAIN_ROWS)
        del q, tbl, kw
        torch.cuda.empty_cache()


# phase 4's second wide table: 384 wide (the common small sentence
# encoders), the bf16 lane's and the i8 lane's chunk steps
WIDE_384_D = 384
WIDE_384_LANES = ("wide bf16 lane", f"wide i8 lane, {WIDE_I8_RERANK} re-ranked")


def time_wide_384(dev):
    """`time_wide_sweep` of WIDE_384_LANES on a synthetic [4,096 x
    2,097,152] x 384 table (`synthetic_wide_table`)."""
    import torch

    time_wide_sweep(*synthetic_wide_table(dev, d=WIDE_384_D),
                    lanes=WIDE_384_LANES, tag=f" at d_pad {WIDE_384_D}")
    torch.cuda.empty_cache()


def time_wide_1536(dev):
    """`time_wide_sweep` of every wide chunk step, the f32 kind's kc 10
    among them, on a synthetic table of phase 3d's shape: [4,096 x
    524,288] x 1,536 (OPENAI_N rows in chunks of 131,072)."""
    import torch

    time_wide_sweep(*synthetic_wide_table(dev, seed=OPENAI_SEED, d=OPENAI_D,
                                          n=OPENAI_N, f32=True),
                    tag=f" at d_pad {OPENAI_D}")
    torch.cuda.empty_cache()


def wide_draw(n, d, seed, unit=False):
    """A wide draw: glove_like(n, d, seed) (phase 3b's: QUANT_N +
    QUANT_NQ x QUANT_D, seed 43; 3d's: OPENAI_N + OPENAI_NQ x OPENAI_D,
    OPENAI_SEED, `unit`: each row scaled to norm 1, as OpenAI's
    embeddings are)."""
    from cozo_tpu_torch.utils.datasets import glove_like

    data = glove_like(n, d, seed=seed)
    if unit:
        for blk in np.array_split(data, 16):
            blk /= np.linalg.norm(blk, axis=1, keepdims=True)
    return data


def phase_quant_wide(draw=None):
    """Phase 3b: a 768-wide draw (`draw`: the `HostJob` of `wide_draw`;
    None: made here) through the quant lane (past the f32 budget, as
    `HnswIndex.search` serves it there), then under the budget through the
    bf16+rerank and i8+rerank lanes (`phase_wide_lanes`).  Returns the
    `wide` numbers."""
    import torch

    from cozo_tpu_torch.ops.quant_knn import QuantSweepTable, quant_search

    say(f"quant cut: {QUANT_N:,} rows instead of 10,000,000")
    data, gen_s, waited_s = host_result(draw, wide_draw, QUANT_N + QUANT_NQ,
                                        QUANT_D, 43)
    qs, data = data[QUANT_N:], data[:QUANT_N]
    say(f"phase 3b datagen {QUANT_N} + {QUANT_NQ} x {QUANT_D} in "
        f"{gen_s:.1f}s, {waited_s:.1f}s of it waited for here")
    t0 = time.time()
    table = QuantSweepTable().load(data, "Cosine")
    torch.cuda.synchronize()
    load_s = time.time() - t0
    table_gb = table.tbl.numel() / 1e9
    topk_zero()
    quant_search(data, table, qs, K)  # warm
    qps = []
    for _ in range(OTHER_LANE_REPS):
        t0 = time.time()
        ids, dists = quant_search(data, table, qs, K)
        qps.append(QUANT_NQ / (time.time() - t0))
    topk_read("quant (phase 3b)", "phase 3b", sweep=False)
    scan_s, rerank_s = quant_search.last_timing
    del table
    norms, gt = wide_truth(data, qs, QUANT_GT)
    torch.cuda.empty_cache()
    r = recall(ids[:QUANT_GT], gt)
    ok = (ids.shape == (QUANT_NQ, K) and np.isfinite(dists).all()
          and (np.diff(dists, axis=1) >= -1e-6).all() and r >= BARS["quant"])
    say(f"phase 3b quant lane {QUANT_N} x {QUANT_D} cosine (int8 table "
        f"{table_gb:.2f} GB on the device, load {load_s:.1f}s): "
        f"B={QUANT_NQ} median {np.median(qps):.1f} QPS min {min(qps):.1f} "
        f"(last rep: device scan + pull {scan_s:.3f}s, host re-rank "
        f"{rerank_s:.3f}s) recall@10 {r:.5f} on {QUANT_GT} queries against "
        f"brute_force_knn (bar {BARS['quant']}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("phase 3b failed: quant lane")
    return {"quant": {"qps_median": float(np.median(qps)), "recall@10": r,
                      "scan_s": scan_s, "rerank_s": rerank_s},
            **phase_wide_lanes(data, norms, qs, gt, "phase 3b",
                               ("bf16+rerank", "i8+rerank"))}


def phase_openai(draw=None):
    """Phase 3d: OPENAI_N x OPENAI_D unit rows, cosine (VectorDBBench's
    Performance1536D500K shape; `draw`: the `HostJob` of `wide_draw`;
    None: made here) under the f32 budget through the bf16+rerank,
    i8+rerank and f32 lanes on the chunk step's kernels at d_pad 1,536
    (`phase_wide_lanes`, each lane's chunk step also at TOP100_KC, the SM
    clock under each).  Returns the `openai` numbers."""
    data, gen_s, waited_s = host_result(draw, wide_draw, OPENAI_N + OPENAI_NQ,
                                        OPENAI_D, OPENAI_SEED, True)
    qs, data = data[OPENAI_N:], data[:OPENAI_N]
    say(f"phase 3d datagen {OPENAI_N} + {OPENAI_NQ} x {OPENAI_D} unit rows "
        f"in {gen_s:.1f}s, {waited_s:.1f}s of it waited for here")
    t0 = time.time()
    norms, gt = wide_truth(data, qs, OPENAI_GT)
    say(f"phase 3d ground truth of {OPENAI_GT} queries (brute_force_knn) in "
        f"{time.time() - t0:.1f}s")
    return phase_wide_lanes(data, norms, qs, gt, "phase 3d",
                            ("bf16+rerank", "i8+rerank", "f32"),
                            more_kcs=(TOP100_KC,), clocks=True)


def wide_truth(data, qs, n_gt):
    """(the rows' squared norms, `brute_force_knn`'s ids of the first
    n_gt queries) of a wide draw."""
    from cozo_tpu_torch.ops.vector_search import brute_force_knn

    norms = np.concatenate([
        np.einsum("nd,nd->n", blk, blk) for blk in np.array_split(data, 16)])
    gt = np.concatenate([
        brute_force_knn(data, norms, qs[b0:b0 + 512], K, "Cosine")[0]
        for b0 in range(0, n_gt, 512)])
    return norms, gt


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
            topk_zero()
            index.bulk_build(rows, wave=8192)
            torch.cuda.synchronize()
            build_s = time.time() - t0
            topk_read(f"{mode} build (phase 3c)", "phase 3c",
                      sweep=mode == "f32")
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
        "launches_by_path": {"index (phase 3)": launches[route]},
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


TOPK_PLAIN_ROWS = 1024  # the plain version runs the main shapes in row blocks
# and the wide shapes (a block's slab of a 2,097,152-row piece and its
# composite keys take some 11 GB)
WIDE_PLAIN_ROWS = 256


def topk_plain_blocks(x, kf, kw):
    """`select_topk_plain` over row blocks of x (its sort of a whole
    [16,384 x 131,072] slab would take some 45 GB)."""
    import torch

    from cozo_tpu_torch.ops import exact_knn as ek

    parts = []
    for r0 in range(0, x.shape[0], TOPK_PLAIN_ROWS):
        sl = slice(r0, r0 + TOPK_PLAIN_ROWS)
        kb = dict(kw)
        if "row_scale" in kb:
            kb["row_scale"] = kb["row_scale"][sl]
        parts.append(ek.select_topk_plain(x[sl], kf, **kb))
    return (torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts]))


def topk_main_shapes(index, qs):
    """The slabs `select_topk` takes on the main path, from phase 3's index
    (its first chunk): (lane, slab, kf, keyword arguments).  The f32 lane
    its true-f32 [16,384 x 131,072] product with the bias (kf 10); the
    quant lane 4,096 queries' int32 products (kf 40, phase 3b's batch and
    overfetch); the fused lane the kernel's packed [16,384 x 10,240] (kf
    26).  (The bf16 and i8 lanes and the f32-table build select inside
    `sweep_topk`: no slab.)"""
    import torch

    from cozo_tpu_torch.ops import fused_sweep as fs
    from cozo_tpu_torch.ops.exact_knn import quantize_tbl
    from cozo_tpu_torch.utils.device import int_mm, prepare_queries

    st = index._sweep_table
    dev = st.tbl.device
    q = torch.from_numpy(np.ascontiguousarray(qs, np.float32)).to(dev)
    q32 = prepare_queries(q, "Cosine", st.d_pad)
    qh = prepare_queries(q, "Cosine", st.d_pad, half=True)
    _, q_i8, q_scale = prepare_queries(q, "Cosine", st.d_pad, half=True,
                                       quantize=True, reciprocal=True)
    tbl_i8, scale = (st.tbl_i8, st.scale_i8) if st.tbl_i8 is not None \
        else quantize_tbl(st.tbl, st.bias)
    bias = st.bias[0]
    yield ("f32 lane", q32 @ st.tbl[0].T, 10, {"bias": bias})
    yield ("quant lane", int_mm(q_i8[:4096], tbl_i8[0]), 40,
           {"col_scale": scale[0], "row_scale": q_scale[:4096].contiguous(),
            "bias": bias})
    packed = fs.fused_sweep(qh.to(torch.bfloat16).contiguous(),
                            st.tbl_fused, st.bias_fused)
    yield ("fused lane", packed, 26, {})


def topk_merge_shapes(index, qs):
    """The merges' slabs from phase 3's index, as `merge_chunks` and
    `bulk_build._pool` take them: each lane's merge buffer with every
    chunk's selection written into its columns as `_sweep` / `_sweep_i8`
    / `_build_step` write it (the bf16 lane + re-rank: 26 a chunk; raw
    bf16: 10; the i8 lane: 64, bf16; a build wave of 8,192 rows, the
    first chunk's: 97), then the build's pool, P = 96 of the merged 97
    with the self-match masked.  (lane, slab, kf, keyword arguments)."""
    import torch

    from cozo_tpu_torch.ops import exact_knn as ek
    from cozo_tpu_torch.utils.device import (int_mm, mm_bf16,
                                             prepare_queries)

    st = index._sweep_table
    dev = st.tbl.device
    n_chunks, chunk = st.tbl.shape[:2]
    q = torch.from_numpy(np.ascontiguousarray(qs, np.float32)).to(dev)
    qh = prepare_queries(q, "Cosine", st.d_pad, half=True)
    _, q_i8, q_scale = prepare_queries(q, "Cosine", st.d_pad, half=True,
                                       quantize=True, reciprocal=True)
    tbl_i8, scale = (st.tbl_i8, st.scale_i8) if st.tbl_i8 is not None \
        else ek.quantize_tbl(st.tbl, st.bias)

    def merge_buffer(queries, kc, dtype, select):
        bufs = ek._chunk_buffers(queries.shape[0], n_chunks, kc, dtype, dev)
        for c in range(n_chunks):
            select(c, kc, ek._cols(bufs, c, kc))
        return bufs

    for lane, kc in (("bf16 lane merge", 26), ("bf16 raw merge", 10)):
        bufs = merge_buffer(qh, kc, torch.float32, lambda c, kc, out: (
            ek.select_topk(mm_bf16(qh, st.tbl[c]), kc, bias=st.bias[c],
                           offset=c * chunk, out=out)))
        yield (lane, bufs[0], kc, {})
    bufs = merge_buffer(qh, 64, torch.bfloat16, lambda c, kc, out: (
        ek.select_topk(int_mm(q_i8, tbl_i8[c]), kc, col_scale=scale[c],
                       row_scale=q_scale, bias=st.bias[c], bf16=True,
                       offset=c * chunk, out=out)))
    yield ("i8 lane merge", bufs[0], 64, {})
    wave = st.tbl[0][:8192]
    bufs = merge_buffer(wave, 97, torch.float32, lambda c, kc, out: (
        ek.select_topk(mm_bf16(wave, st.tbl[c]), kc, bias=st.bias[c],
                       offset=c * chunk, out=out)))
    yield ("build merge", bufs[0], 97, {})
    scores, ids = ek.merge_chunks(*bufs, 97)
    slots = torch.arange(8192, device=dev)
    scores = torch.where(ids == slots[:, None],
                         torch.full_like(scores, -np.inf), scores)
    yield ("build pool", scores.contiguous(), 96, {})


def time_topk(index, qs, reps):
    """Phase 4 for `slab_topk` at each slab the main path hands it (the
    lanes' chunks, then the merges'): values and ids bit-equal
    to the plain version, two runs identical, then the kernel's (its calls
    replayed from a CUDA graph: the device's time, not the host's), the
    plain version's (in row blocks) and `torch.topk`'s time on the same
    key slab,
    beside the bound (one read of the slab and of the prologue's vectors,
    one write of the output).  Returns its entry of the `kernels` line (the
    f32 lane's numbers; every shape under "shapes"), its launches by path
    filled in at the end of the run."""
    import torch

    from cozo_tpu_torch.ops import exact_knn as ek

    shapes = {}
    for lane, x, kf, kw in itertools.chain(topk_main_shapes(index, qs),
                                           topk_merge_shapes(index, qs)):
        B, W = x.shape
        got = ek.select_topk(x, kf, **kw)
        again = ek.select_topk(x, kf, **kw)
        want = topk_plain_blocks(x, kf, kw)
        torch.cuda.synchronize()
        equal, twice = topk_same(got, want), topk_same(got, again)
        err = float((got[0].float() - want[0].float()).abs().max())
        del got, again, want
        if not (equal and twice):
            raise SystemExit(f"phase 4 failed: slab_topk disagrees with plain "
                             f"({lane})")
        torch.cuda.empty_cache()
        ms = graph_ms(lambda: ek.select_topk(x, kf, **kw), reps)
        plain_ms = cuda_ms(lambda: topk_plain_blocks(x, kf, kw), 1)
        key = ek.slab_key(x, kw.get("col_scale"), kw.get("row_scale"),
                          kw.get("bias"), kw.get("bf16", False))
        # yardstick only, never called by the port: the library's top-k of
        # the key slab the kernel selects from (the prologue not timed)
        library_ms = cuda_ms(lambda: torch.topk(key, kf), reps)
        del key
        vec = sum(4 * W for n in ("col_scale", "bias") if n in kw)
        nbytes = (x.numel() * x.element_size() + vec
                  + (4 * B if "row_scale" in kw else 0)
                  + B * kf * ((2 if kw.get("bf16") or x.dtype == torch.bfloat16
                               else 4) + 8))
        bound = nbytes / PEAK_BYTES * 1e3
        shapes[lane] = {"B": B, "W": W, "kf": kf, "dtype": str(x.dtype),
                        "prologue": sorted(kw), "ms": ms, "plain_ms": plain_ms,
                        "library_ms": library_ms, "bound_ms": bound,
                        "max_abs_err": err}
        say(f"phase 4 slab_topk ({lane}: [{B} x {W}] {x.dtype}, kf {kf}, "
            f"prologue {sorted(kw) or 'none'}): {ms:.3f} ms "
            f"({100 * bound / ms:.1f}% of the bound {bound:.3f} ms, bytes "
            f"{nbytes / 1e9:.3f} GB), plain {plain_ms:.1f} ms (blocks of "
            f"{TOPK_PLAIN_ROWS} rows), torch.topk on the key slab "
            f"{library_ms:.3f} ms; values and ids bit-equal {equal}, two "
            f"runs identical {twice}")
        del x, kw
        torch.cuda.empty_cache()
    main = shapes["f32 lane"]
    return {
        "name": "slab_topk", "route": "cuda",
        "source": "cozo_tpu_torch/csrc/slab_topk.cu",
        "replaces": "cozo_tpu/ops/exact_knn.py:118",
        "replaces_all": ["cozo_tpu/ops/exact_knn.py:118",
                         "cozo_tpu/ops/quant_knn.py:88",
                         "cozo_tpu/ops/bulk_build.py:266",
                         "cozo_tpu/ops/pallas_sweep.py:201"],
        "launches": 0, "launches_by_path": {},
        "max_abs_err": max(v["max_abs_err"] for v in shapes.values()),
        "ms": main["ms"], "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"], "bound_by": "bytes",
        "library_ms": main["library_ms"],  # torch.topk on the key slab
        "shape": {"B": main["B"], "W": main["W"], "kf": main["kf"]},
        "shapes": shapes,
    }


PEAK_INT8 = 1979e12  # H100 SXM dense int8 OP/s
SWEEP_TURNS = 3  # rounds of (kernel, old two-step route) timed in turns


def sweep_main_shapes(st, qs):
    """The chunk steps the main path hands `sweep_topk`, from a sweep table
    `st` (phase 3's index, or a synthetic one of the main shape) and the
    queries: (lane, q, tbl, chunk, kc, keyword arguments), `chunk` the
    lane's chunk (the old route's piece).  The bf16 lane
    + re-rank (kc 26) and raw (kc 10) on the 16,384 queries as
    `prepare_queries` rounds them, the i8 lane's int8 queries (kc 64), a
    build wave of 8,192 rows (the table's first, as queries; kc P + 1 =
    97), the mesh's scan of one shard (raw bf16, kc 10, the table in
    `ShardedSweep`'s chunks of 16,384 rows), and the bf16 lane + re-rank
    with keys that rise along the table (the table scaled by 2^-10, a
    bias step of 0.25: the seed's case)."""
    import torch

    from cozo_tpu_torch.ops.exact_knn import quantize_tbl
    from cozo_tpu_torch.utils.device import prepare_queries

    dev = st.tbl.device
    n_chunks, chunk, d_pad = st.tbl.shape
    tbl16 = st.tbl.reshape(-1, d_pad).to(torch.bfloat16)
    bias = st.bias.reshape(-1)
    q = torch.from_numpy(np.ascontiguousarray(qs, np.float32)).to(dev)
    qh = prepare_queries(q, "Cosine", d_pad, half=True).to(torch.bfloat16)
    _, q_i8, q_scale = prepare_queries(q, "Cosine", d_pad, half=True,
                                       quantize=True, reciprocal=True)
    tbl_i8, scale = quantize_tbl(st.tbl, st.bias)
    yield "bf16 lane", qh, tbl16, chunk, 26, {"bias": bias}
    yield "bf16 raw", qh, tbl16, chunk, 10, {"bias": bias}
    yield ("i8 lane", q_i8, tbl_i8.reshape(-1, d_pad), chunk, 64,
           {"bias": bias, "col_scale": scale.reshape(-1),
            "row_scale": q_scale})
    yield "build step", tbl16[:8192].contiguous(), tbl16, chunk, 97, {
        "bias": bias}
    yield "mesh shard (raw, chunks of 16,384)", qh, tbl16, 16_384, 10, {
        "bias": bias}
    rising = torch.arange(bias.numel(), device=dev).float() * 0.25
    yield ("bf16 lane, rising keys", qh, tbl16 * 2.0 ** -10, chunk, 26,
           {"bias": torch.where(torch.isfinite(bias), rising, bias)})


def sweep_plain_blocks(q, tbl, piece, kc, kw, rows=None):
    """`sweep_topk_plain` over blocks of `rows` (TOPK_PLAIN_ROWS) query
    rows (its selection of a whole [16,384 x 131,072] slab would take some
    45 GB)."""
    import torch

    from cozo_tpu_torch.ops import exact_knn as ek

    rows = rows or TOPK_PLAIN_ROWS
    parts = []
    for r0 in range(0, q.shape[0], rows):
        sl = slice(r0, r0 + rows)
        kb = dict(kw)
        if "row_scale" in kb:
            kb["row_scale"] = kb["row_scale"][sl].contiguous()
        parts.append(ek.sweep_topk_plain(q[sl], tbl, piece, kc, **kb))
    return (torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts]))


def sweep_library(q, tbl, piece, kc, kw):
    """The yardstick, never called by the port: per piece one library
    product (`torch.mm` to f32, in f32 for f32 inputs, or
    `torch._int_mm`), the key in PyTorch, and `torch.topk`."""
    import torch

    for p in range(tbl.shape[0] // piece):
        cols = slice(p * piece, (p + 1) * piece)
        if q.dtype == torch.int8:
            s = torch._int_mm(q, tbl[cols].T).float()
            s = s * kw["col_scale"][cols] * kw["row_scale"][:, None]
        elif q.dtype == torch.float32:
            s = torch.mm(q, tbl[cols].T)
        else:
            s = torch.mm(q, tbl[cols].T, out_dtype=torch.float32)
        torch.topk(s + kw["bias"][cols], kc)
        del s


def time_sweep_shape(lane, q, tbl, chunk, kc, kw, reps, plain_rows=None,
                     d_real=0):
    """Phase 4 for `sweep_topk` at one chunk step, at the piece
    `sweep_piece` gives the lane: the kernel against the plain version
    (in blocks of `plain_rows` query rows) over the whole table first
    (int8 bit-equal, bf16 and f32 by `sweep_values_agree`), then its
    time (CUDA events, a launch covers all the pieces), the two-step
    route's a chunk at a time (the product writes each chunk's slab,
    `slab_topk` reads it) in turns with it, the plain version's (row
    blocks) and the library yardstick's, beside the bound: the products at
    the tensor cores' peak (989 TFLOP/s bf16, 1,979 TOP/s int8) or the
    card's f32 peak outside them (67 TFLOP/s), or the bytes (the queries,
    the table and the vectors read once, the outputs written once) at 3.35
    TB/s, the larger.  `d_real`: the rows' real width, given to the
    kernel (the f32 kind's chains stop there) and counted in the bound's
    operations.  Returns the shape's numbers."""
    import torch

    from cozo_tpu_torch.ops import exact_knn as ek

    B, d_pad = q.shape
    n_total = tbl.shape[0]
    int8 = q.dtype == torch.int8
    f32 = q.dtype == torch.float32
    kind = ek.SWEEP_F32 if f32 else int(int8)
    piece = ek.sweep_piece(n_total, chunk, B, d_pad, kc, kind, q.device)
    n_p = n_total // piece
    real = {"d_real": d_real} if d_real else {}
    got = ek.sweep_topk(q, tbl, piece, kc, **kw, **real)
    t0 = time.time()
    want = sweep_plain_blocks(q, tbl, piece, kc, kw, plain_rows)
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.time() - t0)
    again = ek.sweep_topk(q, tbl, piece, kc, **kw, **real)
    torch.cuda.synchronize()
    ok, share, err = sweep_values_agree(got, want)
    twice = topk_same(got, again)
    del got, want, again
    if not (ok and twice):
        raise SystemExit(f"phase 4 failed: sweep_topk disagrees with plain "
                         f"({lane}: ids equal {share}, max err {err})")
    out = ek._chunk_buffers(B, n_p, kc, torch.bfloat16 if int8
                            else torch.float32, q.device)
    out_old = ek._chunk_buffers(B, n_total // chunk, kc, out[0].dtype,
                                q.device)
    kern, old = [], []
    for _ in range(SWEEP_TURNS):
        kern.append(cuda_ms(lambda: ek.sweep_topk(q, tbl, piece, kc,
                                                  out=out, **kw, **real),
                            reps))
        old.append(cuda_ms(lambda: ek.sweep_two_step(
            q, tbl, chunk, kc, kw["bias"], kw.get("col_scale"),
            kw.get("row_scale"), 0, out_old), 1))
    del out_old, out
    torch.cuda.empty_cache()
    library_ms = cuda_ms(lambda: sweep_library(q, tbl, chunk, kc, kw), 1)
    torch.cuda.empty_cache()
    ops = 2.0 * B * n_total * (d_real or d_pad)
    peak = PEAK_INT8 if int8 else PEAK_F32 if f32 else PEAK_BF16
    nbytes = (q.numel() * q.element_size() + tbl.numel() * tbl.element_size()
              + 4 * n_total * (2 if "col_scale" in kw else 1)
              + (4 * B if "row_scale" in kw else 0)
              + B * n_p * kc * ((2 if int8 else 4) + 8))
    bound = max(ops / peak, nbytes / PEAK_BYTES) * 1e3
    ms = float(np.median(kern))
    # the table's bytes out of L2 a launch: once a cluster of blocks that
    # share its chunks
    kind = ek.SWEEP_F32 if f32 else int(int8)
    lib = ek._sweep_f32_lib() if f32 else ek._sweep_lib()
    rows = lib.cozo_sweep_topk_rows(kind, d_pad, kc)
    cluster = lib.cozo_sweep_topk_cluster(kind, d_pad, kc)
    l2_bytes = (tbl.numel() * tbl.element_size()
                * (-(-(-(-B // rows)) // cluster)))
    say(f"phase 4 sweep_topk ({lane}: [{B} x {n_total}] {q.dtype} in "
        f"{n_p} piece(s) of {piece}, d_pad {d_pad}"
        f"{f' (real width {d_real})' if d_real else ''}, kc {kc}): "
        f"{ms:.3f} ms "
        f"a launch ({100 * bound / ms:.1f}% of the bound {bound:.3f} ms, "
        f"{ops / 1e12:.2f} T{'OP' if int8 else 'FLOP'}"
        f"{' at the f32 rate' if f32 else ''}, "
        f"{nbytes / 1e9:.3f} GB; turns {[round(x, 3) for x in kern]}; "
        f"the table from L2 {l2_bytes / 1e9:.1f} GB), "
        f"the two-step route in chunks of {chunk} "
        f"{np.median(old):.3f} ms (turns "
        f"{[round(x, 3) for x in old]}), library mm + topk "
        f"{library_ms:.3f} ms, plain {plain_ms:.1f} ms (blocks of "
        f"{plain_rows or TOPK_PLAIN_ROWS} rows, host clock); ids "
        f"equal {share:.5f}, max err {err:.3g}, two runs identical {twice}")
    return {
        "B": B, "n_total": n_total, "piece": piece, "chunk": chunk,
        "kc": kc, "d_pad": d_pad, "d_real": d_real, "dtype": str(q.dtype),
        "ms": ms,
        "ms_turns": kern, "two_step_ms": float(np.median(old)),
        "two_step_turns": old, "plain_ms": plain_ms,
        "library_ms": library_ms,
        "bound_ms": bound,
        "bound_by": "operations" if ops / peak >= nbytes / PEAK_BYTES
        else "bytes", "l2_bytes": l2_bytes,
        "ids_equal": share, "max_abs_err": err}


def time_sweep(st, qs, reps):
    """Phase 4 for `sweep_topk` at each chunk step of the main path
    (`sweep_main_shapes`, `time_sweep_shape`).  Returns its entry of the
    `kernels` line (the bf16 lane's numbers; every shape under "shapes",
    phase 3b's wide rows added at the end of the run), its launches by
    path filled in at the end of the run."""
    import torch

    shapes = {}
    for lane, q, tbl, chunk, kc, kw in sweep_main_shapes(st, qs):
        shapes[lane] = time_sweep_shape(lane, q, tbl, chunk, kc, kw, reps)
        del q, tbl, kw
        torch.cuda.empty_cache()
    main = shapes["bf16 lane"]
    return {
        "name": "sweep_topk", "route": "cuda",
        "source": "cozo_tpu_torch/csrc/sweep_topk.cu",
        "replaces": "cozo_tpu/ops/exact_knn.py:100-123",
        "replaces_all": ["cozo_tpu/ops/exact_knn.py:100-123",
                         "cozo_tpu/ops/exact_knn.py:199-213",
                         "cozo_tpu/ops/bulk_build.py:137-147"],
        "launches": 0, "launches_by_path": {},
        "max_abs_err": max(v["max_abs_err"] for v in shapes.values()),
        "ms": main["ms"], "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
        "library_ms": main["library_ms"],  # torch.mm + torch.topk a piece
        "two_step_ms": main["two_step_ms"],
        "shape": {k: main[k] for k in ("B", "n_total", "piece", "chunk",
                                       "kc")},
        "shapes": shapes,
    }


def f32_main_inputs(st, qs):
    """The f32 lane's chunk step as `SweepTable.search` hands it to
    `sweep_topk`: the queries prepared on the card in f32 (cosine
    normalised, zero-padded: no f16 round), the flat f32 table (a view)
    and its bias."""
    import torch

    from cozo_tpu_torch.utils.device import prepare_queries

    dev = st.tbl.device
    q = torch.from_numpy(np.ascontiguousarray(qs, np.float32)).to(dev)
    d_pad = st.tbl.shape[2]
    return (prepare_queries(q, "Cosine", d_pad).contiguous(),
            st.tbl.reshape(-1, d_pad), st.bias.reshape(-1))


def clock_under(fn, seconds=2.0):
    """(median SM clock MHz, median power draw W) that `nvidia-smi` reads
    while fn() runs back to back for about `seconds` (a sample every
    call of nvidia-smi, ~0.1 s)."""
    import threading

    import torch

    samples, stop = [], threading.Event()

    def sample():
        while not stop.is_set():
            out = subprocess.run(
                ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                 "--format=csv,noheader,nounits"],
                capture_output=True, text=True, timeout=30)
            try:
                clk, pwr = out.stdout.strip().splitlines()[0].split(",")
                samples.append((float(clk), float(pwr)))
            except (ValueError, IndexError):
                pass

    fn()
    torch.cuda.synchronize()
    th = threading.Thread(target=sample)
    th.start()
    t0 = time.time()
    while time.time() - t0 < seconds:
        fn()
        torch.cuda.synchronize()
    stop.set()
    th.join()
    if not samples:
        return None, None
    return (float(np.median([c for c, _ in samples])),
            float(np.median([p for _, p in samples])))


def time_sweep_f32(st, qs, reps):
    """Phase 4 for the f32 chunk step (`csrc/sweep_topk_f32.cu`) at the f32
    lane's shape, [16,384 x 1,310,720] x 128 at kc 10 (the lane's) and 26:
    `time_sweep_shape` (the plain version, the kernel in turns with the
    two-step route a chunk at a time, `torch.mm` + `torch.topk` a chunk,
    the bound at 67 TFLOP/s of the chains stopped at the real width);
    then the two-step route split into its ten products and ten
    selections (`two_step_split`); at kc 10 the SM clock and power under
    the kernel and under cuBLAS's product (`clock_under`).  Returns the
    `kernels` line's entry of the f32 kind (kc 10's numbers; both shapes
    under "shapes")."""
    import torch

    from cozo_tpu_torch.ops import exact_knn as ek

    q, tbl, bias = f32_main_inputs(st, qs)
    chunk = st.tbl.shape[1]
    shapes = {}
    for kc in (10, 26):
        lane = f"f32 lane kc {kc}"
        shapes[lane] = sh = time_sweep_shape(lane, q, tbl, chunk, kc,
                                             {"bias": bias}, reps,
                                             d_real=D)
        torch.cuda.empty_cache()
        mm_ms, sel_ms = two_step_split(q, tbl, chunk, kc, {"bias": bias}, 3)
        sh.update(two_step_products_ms=mm_ms, two_step_selections_ms=sel_ms)
        torch.cuda.empty_cache()
        if kc == 10:  # the clock each holds: this kernel, cuBLAS's product
            out = ek._chunk_buffers(q.shape[0], tbl.shape[0] // sh["piece"],
                                    kc, torch.float32, q.device)
            sh["clock_mhz_power_w"] = clock_under(lambda: ek.sweep_topk(
                q, tbl, sh["piece"], kc, bias, out=out, d_real=D))
            del out
            sh["two_step_clock_mhz_power_w"] = clock_under(
                lambda: torch.mm(q, tbl[:chunk].T))
            torch.cuda.empty_cache()
            say(f"phase 4 sweep_topk[f32] SM clock and power (nvidia-smi, "
                f"median): the kernel {sh['clock_mhz_power_w']}, cuBLAS's "
                f"f32 product {sh['two_step_clock_mhz_power_w']} (MHz, W; "
                f"67 TFLOP/s is 1,980 MHz)")
        n_chunks = tbl.shape[0] // chunk
        say(f"phase 4 sweep_topk[f32] ({lane}): the two-step route's "
            f"{n_chunks} products {mm_ms:.3f} ms and selections "
            f"{sel_ms:.3f} ms (a chunk: {mm_ms / n_chunks:.3f} + "
            f"{sel_ms / n_chunks:.3f}); the kernel {sh['ms']:.3f} ms = "
            f"{sh['ms'] / (mm_ms + sel_ms):.3f}x their sum")
    main = shapes["f32 lane kc 10"]
    return {
        "name": "sweep_topk[f32]", "route": "cuda",
        "source": "cozo_tpu_torch/csrc/sweep_topk_f32.cu",
        "replaces": "cozo_tpu/ops/exact_knn.py:100-123",
        "launches": 0, "launches_by_path": {},
        "max_abs_err": max(v["max_abs_err"] for v in shapes.values()),
        "ms": main["ms"], "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
        "library_ms": main["library_ms"],  # torch.mm + torch.topk a chunk
        "two_step_ms": main["two_step_ms"],
        "shape": {k: main[k] for k in ("B", "n_total", "piece", "chunk",
                                       "kc", "d_pad")},
        "shapes": shapes,
    }


# phase 3b's chunk steps at 768-wide rows and 3d's at 1,536, timed as
# phase 4's (`time_wide_sweep`), added to sweep_topk's entry (the f32
# kind's to its own) at the end of the run
WIDE_SWEEP_SHAPES = {}


def finish_topk_entry(kernels):
    """slab_topk's and sweep_topk's entries (its f32 kind's apart) gain the
    launches counted on each path, sweep_topk's and its f32 kind's also
    the wide shapes of phases 3b and 3d."""
    for entry in kernels:
        by = {"slab_topk": TOPK_LAUNCHES, "sweep_topk": SWEEP_LAUNCHES,
              "sweep_topk[f32]": SWEEP_F32_LAUNCHES}.get(entry["name"])
        if by is not None:
            entry["launches_by_path"].update(by)
            entry["launches"] = sum(entry["launches_by_path"].values())
        if entry["name"] in ("sweep_topk", "sweep_topk[f32]"):
            f32 = entry["name"] == "sweep_topk[f32]"
            entry["shapes"].update(
                (k, v) for k, v in WIDE_SWEEP_SHAPES.items()
                if (v["dtype"] == "torch.float32") == f32)
            entry["max_abs_err"] = max(v["max_abs_err"]
                                       for v in entry["shapes"].values())


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


# ------------------------------------------------------ phase 11: the hosts

HOSTS_THREADS, HOSTS_REQS = 8, 20  # (a): 8 clients x 20 small joins
QUALITY_N, QUALITY_NQ = 65_536, 256  # (f): cut from phase 3c's 262,144
# the CLIs' device arguments (none: the card) and the device the hosts
# must report; a rehearsal on a CPU sets them to ["--device", "cpu"], "cpu"
CARD_ARGS, CARD = [], "cuda"
HOSTS_SSE_REL = "hosts_sse"
EXAMPLES = ("embed_basic", "graph_algos", "shared_store", "vector_search")


def http(url, path, body=None, method="POST", timeout=120):
    """(status, parsed JSON body) of one request to a server."""
    import urllib.error
    import urllib.request

    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url + path, data=data, method=method,
                                 headers={"content-type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def sse_first_event(url, db, rel):
    """Open `/changes/{rel}` and `:put` rows into `rel` (one every half
    second until the stream carries an event: the server registers its
    callback after the client connects); returns the first event and the
    keys put."""
    import threading
    import urllib.request

    events = []

    def listen():
        req = urllib.request.Request(url + f"/changes/{rel}")
        with urllib.request.urlopen(req, timeout=60) as resp:
            for raw in resp:
                line = raw.decode("utf-8").strip()
                if line.startswith("data: "):
                    events.append(json.loads(line[len("data: "):]))
                    return

    t = threading.Thread(target=listen, daemon=True)
    t.start()
    keys = []
    for k in range(40):
        if events:
            break
        time.sleep(0.5)
        keys.append(k)
        db.run_script(f"?[k] <- [[{k}]] :put {rel} {{k}}")
    t.join(timeout=30)
    return (events[0] if events else None), keys


def listen_counters():
    """(ListenOverflows, ListenDrops) of this network namespace's TCP
    stack, from /proc/net/netstat (read only): connection requests the
    kernel dropped because a listen queue was full, and all it dropped;
    None where the kernel does not expose them."""
    try:
        with open("/proc/net/netstat") as f:
            lines = f.read().splitlines()
    except OSError:
        return None
    for head, vals in zip(lines[::2], lines[1::2]):
        if head.startswith("TcpExt:"):
            kv = dict(zip(head.split()[1:], map(int, vals.split()[1:])))
            if "ListenOverflows" in kv and "ListenDrops" in kv:
                return kv["ListenOverflows"], kv["ListenDrops"]
    return None


SLOW_CONNECT_MS = 100  # a loopback handshake the kernel queues takes < 1 ms


def text_query(port, script):
    """One `/text-query` on a new connection, as urllib sends it: (status,
    parsed body, connect ms, request ms from the connect's start)."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        t0 = time.perf_counter()
        conn.connect()
        t1 = time.perf_counter()
        conn.request("POST", "/text-query", json.dumps({"script": script}),
                     {"content-type": "application/json"})
        resp = conn.getresponse()
        status, res = resp.status, json.loads(resp.read())
        t2 = time.perf_counter()
    finally:
        conn.close()
    return status, res, (t1 - t0) * 1e3, (t2 - t0) * 1e3


def server_burst(port, scripts, want):
    """HOSTS_THREADS client threads each send its small join HOSTS_REQS
    times as `/text-query`, a new connection a request: the request ms
    p50 / p99 / max, requests/s, whether every answer's rows equal the
    Db's own (`want`, a list of row tuples a join), the connects slower
    than SLOW_CONNECT_MS (a dropped handshake is retried after 1 s), the
    listen queue's overflows and drops during the burst (None where the
    kernel does not count them), and the garbage collector's passes during
    it, each of which stops every thread: their count, the full ones' and
    the longest.  Nothing collects before it: the burst meets the
    collector as a user's server does."""

    def client(t):
        lat, slow, same = [], 0, True
        for _ in range(HOSTS_REQS):
            status, res, connect_ms, ms = text_query(port, scripts[t])
            lat.append(ms)
            slow += connect_ms > SLOW_CONNECT_MS
            same = same and status == 200 and res.get("ok") is True \
                and sorted(map(tuple, res["rows"])) == want[t]
        return lat, slow, same

    before = listen_counters()
    t0 = time.time()
    with collector_passes() as passes:
        with ThreadPoolExecutor(HOSTS_THREADS) as ex:
            results = list(ex.map(client, range(HOSTS_THREADS)))
    wall = time.time() - t0
    after = listen_counters()
    lat = np.concatenate([r[0] for r in results])
    counted = before is not None and after is not None
    return {"requests": int(len(lat)),
            "request_ms_p50": float(np.percentile(lat, 50)),
            "request_ms_p99": float(np.percentile(lat, 99)),
            "request_ms_max": float(lat.max()),
            "requests_per_s": len(lat) / wall,
            "slow_connects": int(sum(r[1] for r in results)),
            **pass_numbers(passes, "gc"),
            "listen_overflows": after[0] - before[0] if counted else None,
            "listen_drops": after[1] - before[1] if counted else None,
            "small_join_rows_equal": all(r[2] for r in results) and all(
                len(w) == DB_SMALL * K for w in want)}


@contextlib.contextmanager
def collector_passes():
    """The collector's passes while the body runs, each holding the GIL and
    so stopping every thread: a list of (ms, generation)."""
    import gc

    passes, began = [], []

    def on_gc(phase, info):
        if phase == "start":
            began.append(time.perf_counter())
        else:
            passes.append(((time.perf_counter() - began.pop()) * 1e3,
                           info["generation"]))

    gc.callbacks.append(on_gc)
    try:
        yield passes
    finally:
        gc.callbacks.remove(on_gc)


def pass_numbers(passes, key):
    return {f"{key}_passes": len(passes),
            f"{key}_full_passes": sum(g == 2 for _, g in passes),
            f"{key}_longest_ms": max((ms for ms, _ in passes), default=0.0)}


def burst_line(what, b):
    counters = ("ListenOverflows / ListenDrops not counted by this kernel"
                if b["listen_overflows"] is None else
                f"ListenOverflows {b['listen_overflows']} ListenDrops "
                f"{b['listen_drops']}")
    return (f"{what}: request ms p50 {b['request_ms_p50']:.3f} p99 "
            f"{b['request_ms_p99']:.3f} max {b['request_ms_max']:.3f}, "
            f"{b['requests_per_s']:.1f} requests/s, connects over "
            f"{SLOW_CONNECT_MS} ms {b['slow_connects']}, {counters}, "
            f"{b['gc_passes']} garbage collections, {b['gc_full_passes']} "
            f"of them full, the longest {b['gc_longest_ms']:.1f} ms; rows "
            f"equal to the Db's own answers {b['small_join_rows_equal']}")


def backlog_turns(db, scripts, want):
    """(a)'s burst on the same Db through socketserver's backlog of 5 (a
    plain `ThreadingHTTPServer`, the port's server class before
    `CozoHTTPServer`) and through `serve`'s, in turns 5, 128, 128, 5: each
    turn's p50 / p99 / max ms and listen overflows and drops."""
    import threading
    from http.server import ThreadingHTTPServer

    from cozo_tpu_torch.hosts import server as hs

    turns = []
    for cls in (ThreadingHTTPServer, hs.CozoHTTPServer, hs.CozoHTTPServer,
                ThreadingHTTPServer):
        srv = cls(("127.0.0.1", 0), hs.make_handler(hs.ServerState(db)))
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        try:
            b = server_burst(srv.server_address[1], scripts, want)
        finally:
            srv.shutdown()
            srv.server_close()
        b["backlog"] = srv.request_queue_size
        say(burst_line(f"phase 11 (a) in turns, listen backlog "
                       f"{b['backlog']}", b))
        if not b["small_join_rows_equal"]:
            raise SystemExit("phase 11 failed: the server's small joins")
        turns.append(b)
    return turns


# (a)'s gate: through `serve`, no collector pass while PageRank's answer is
# built, nor inside the burst, nor the next full pass after it (brought
# forward by `gc.collect()`: it walks what the collector's own next full
# pass would), may take this long.  A small
# join over HTTP takes 30-60 ms at p50 and under 100 ms at p99 on a quiet
# heap (PERF.md §5); a pass past 100 ms at least doubles the requests it
# stops, where a full pass over the heap the server found took 0.5-0.9 s.
GC_PASS_BAR_MS = 100.0
# rows of the write over HTTP after serving starts: a quarter of a
# million, each with a string and a float
LATER_WRITE_ROWS = 262_144


def rank_arrays(text):
    """PageRank's JSON answer (rows [node, rank]) as two arrays, read
    without a Python object a row that the collector tracks (strings it
    does not track), so that neither holding nor reading the answer moves
    the server's collector: a client of a real server reads it elsewhere.
    The ranks are the JSON's shortest round-trip floats, parsed exactly;
    None where the answer is not ok."""
    head, _, rest = text.partition('"rows": [')
    if not rest or '"ok": true' not in rest:
        return None
    rows = rest[:rest.index("]]") + 1] if rest[0] == "[" else ""
    flat = np.array(rows.replace("[", "").replace("]", "").split(",")
                    if rows else [], np.float64)
    return flat[0::2].astype(np.int64), flat[1::2]


def pagerank_over_http(url):
    """(status, answer text, ms) of PageRank over `url`'s `/text-query`."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(
        url + "/text-query", data=json.dumps({"script": GRAPH_PR}).encode(),
        method="POST", headers={"content-type": "application/json"})
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=300) as resp:
            status, text = resp.status, resp.read().decode()
    except urllib.error.HTTPError as e:
        status, text = e.code, e.read().decode()
    return status, text, (time.perf_counter() - t0) * 1e3


def heap_census(db):
    """What CPython's cyclic collector tracks, by owner: the objects
    reachable from the Db; from the smoke's own frames and globals (its
    reference answers, what earlier phases left alive); the rest (the
    interpreter's, torch's and the other modules' heap).  The first owner
    to reach an object has it; modules, classes, functions, code and
    frames are not followed.  Also the objects a full pass would walk now
    (the collector's three generations), with their commonest types, and
    those frozen out of it."""
    import gc
    import types
    from collections import Counter

    stop = (types.ModuleType, type, types.FunctionType, types.CodeType,
            types.BuiltinFunctionType, types.FrameType)
    claimed = set()

    def reach(roots):
        kinds, todo = Counter(), [r for r in roots if gc.is_tracked(r)]
        while todo:
            o = todo.pop()
            if id(o) in claimed or isinstance(o, stop):
                continue
            claimed.add(id(o))
            kinds[type(o).__name__] += 1
            todo.extend(r for r in gc.get_referents(o)
                        if gc.is_tracked(r) and id(r) not in claimed)
        return kinds

    t0 = time.perf_counter()
    frames, f = [globals()], sys._getframe(1)
    while f is not None:
        frames.append(f.f_locals)
        f = f.f_back
    owners = {"db": reach([db]), "smoke": reach(frames)}
    walked = gc.get_objects()
    frozen = gc.get_freeze_count()
    kinds = Counter(type(o).__name__ for o in walked)
    out = {"tracked": len(walked) + frozen, "walked": len(walked),
           "frozen": frozen,
           **{o: sum(k.values()) for o, k in owners.items()},
           **{o + "_types": dict(k.most_common(3))
              for o, k in owners.items()},
           "walked_types": dict(kinds.most_common(4))}
    del walked, frames
    out["rest"] = out["tracked"] - out["db"] - out["smoke"]
    out["census_s"] = time.perf_counter() - t0
    return out


def full_pass_ms():
    """One full collection, timed (it stops every thread)."""
    import gc

    t0 = time.perf_counter()
    gc.collect()
    return (time.perf_counter() - t0) * 1e3


def list_maps(db):
    """The main index's slot -> item map with a list of key values a row in
    a pair, as `HnswCache` kept it before `put_item` (two tracked objects
    a row); returns the Db's own map, to be put back."""
    cache = db.algo_cache["hnsw::item::ix"]
    own = cache.slot_to_item
    with cache.lock:
        cache.slot_to_item = {s: (list(kv), f) for s, (kv, f) in own.items()}
    return own


def gc_turn(db, scripts, want, direct, repaired, census=False, extra=None):
    """One turn of (a) on `db`: a server made by `serve` (`repaired`: the
    heap frozen, the index maps' tuples untracked) or as the port made it
    before (a `CozoHTTPServer` alone, over list maps: `list_maps`); PageRank
    over HTTP, a large answer (its ranks bit-equal to `direct`), then
    (`census`) the heap by owner, the burst, one timed full pass, and
    `extra(url)` where given; through `serve`, a pass of GC_PASS_BAR_MS
    while the answer is built, in the burst or in that full pass fails the
    run.  Returns the turn's numbers."""
    import gc
    import threading

    from cozo_tpu_torch.hosts import server as hs

    cache = db.algo_cache["hnsw::item::ix"]
    own = None if repaired else list_maps(db)
    srv = (hs.serve(db, "127.0.0.1", 0) if repaired else hs.CozoHTTPServer(
        ("127.0.0.1", 0), hs.make_handler(hs.ServerState(db))))
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    what = ("serve (frozen heap, tuple maps)" if repaired
            else "the server unfrozen over list maps")
    out = {"server": what}
    try:
        with collector_passes() as passes:
            status, text, out["pagerank_request_ms"] = pagerank_over_http(
                url)
        out.update(pass_numbers(passes, "answer_gc"))
        got = rank_arrays(text) if status == 200 else None
        del text
        out["pagerank_bit_equal"] = bool(
            got is not None and len(direct[0]) > 0 and all(
                np.array_equal(g, d) for g, d in zip(got, direct)))
        del got
        if census:
            out["census"] = heap_census(db)
        out.update(server_burst(srv.server_address[1], scripts, want))
        out["walked_after_burst"] = len(gc.get_objects())
        out["full_pass_ms"] = full_pass_ms()
        turn_line(what, direct, out)
        if extra is not None:
            extra(url, out)
    finally:
        srv.shutdown()
        srv.server_close()
        if own is not None:
            with cache.lock:
                cache.slot_to_item = own
    if not (out["pagerank_bit_equal"] and out["small_join_rows_equal"]):
        raise SystemExit(f"phase 11 failed: {what}'s answers")
    longest = max(out["answer_gc_longest_ms"], out["gc_longest_ms"],
                  out["full_pass_ms"])
    if repaired and not longest < GC_PASS_BAR_MS:
        raise SystemExit(f"phase 11 failed: a collector pass of "
                         f"{longest:.1f} ms while the answer was built, in "
                         f"the burst or right after it through {what} (bar "
                         f"{GC_PASS_BAR_MS} ms)")
    return out


def turn_line(what, direct, out):
    c = out.get("census")
    say(burst_line(f"phase 11 (a) turn, {what}: PageRank over HTTP "
                   f"{len(direct[0])} rows in "
                   f"{out['pagerank_request_ms']:.1f} ms (ranks bit-equal "
                   f"{out['pagerank_bit_equal']}; {out['answer_gc_passes']} "
                   f"garbage collections while it was built, "
                   f"{out['answer_gc_full_passes']} of them full, the "
                   f"longest {out['answer_gc_longest_ms']:.1f} ms), then "
                   f"the burst", out)
        + f"; a full pass after it walked {out['walked_after_burst']} "
        f"objects in {out['full_pass_ms']:.1f} ms"
        + ("" if c is None else
           f"; the heap right after the answer: {c['tracked']} tracked "
           f"objects ({c['walked']} walked by a full pass, {c['frozen']} "
           f"frozen): the Db {c['db']} {c['db_types']}, the smoke "
           f"{c['smoke']} {c['smoke_types']}, the interpreter's, torch's "
           f"and the modules' {c['rest']}; walked {c['walked_types']} "
           f"(counted in {c['census_s']:.1f} s)"))


def sse_check(db, url, out):
    """(a)'s SSE `/changes/{HOSTS_SSE_REL}` stream carries a `:put`."""
    db.run_script(f":create {HOSTS_SSE_REL} {{k: Int}}")
    event, keys = sse_first_event(url, db, HOSTS_SSE_REL)
    ok = (event is not None and event["op"] == "Put"
          and event["relation"] == HOSTS_SSE_REL
          and len(event["new"]) == 1 and event["new"][0][0] in keys)
    out["sse_event"] = bool(ok)
    say(f"phase 11 (a) SSE /changes/{HOSTS_SSE_REL}: first event "
        f"{event} after {len(keys)} :put {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("phase 11 failed: the SSE change stream")


def later_write(url, out):
    """After serving starts: LATER_WRITE_ROWS rows imported over HTTP into
    a new relation, then the objects a full pass walks and its ms."""
    import gc

    rows = [[i, f"row {i}", i / 7] for i in range(LATER_WRITE_ROWS)]
    status, res = http(url, "/text-query", {
        "script": ":create hosts_later {k: Int => s: String, x: Float}"})
    ok = status == 200 and res.get("ok") is True
    status, res = http(url, "/import", {"hosts_later": {
        "headers": ["k", "s", "x"], "rows": rows}}, method="PUT")
    del rows
    ok = ok and status == 200 and res.get("ok") is True
    out["later_write_walked"] = len(gc.get_objects())
    out["later_write_full_pass_ms"] = full_pass_ms()
    say(f"phase 11 (a) a write after serving started: {LATER_WRITE_ROWS} "
        f"rows imported over HTTP {ok}; a full pass after it walked "
        f"{out['later_write_walked']} objects in "
        f"{out['later_write_full_pass_ms']:.1f} ms "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("phase 11 failed: the import over HTTP")


def phase_server(db):
    """Phase 11 (a): phase 5's Db served in process, in turns: first as
    the port served it before (no frozen heap, the index maps a list a
    row), then through `cozo_tpu_torch.hosts.server.serve` (the gated
    turn, its requests' launches counted), then both again (the collector
    unfrozen between).  Each turn: PageRank over the level-0 graph over
    HTTP (ranks bit-equal to the direct call's: the kernel is
    deterministic), a large answer; then 8 client threads each send the
    small join of its own 16 stored queries 20 times as `/text-query`
    (each answer's rows equal to the Db's own answer; no connection
    request dropped by a full listen queue where the kernel counts them),
    with no collection before it; then one timed full pass.  The first
    two turns count the heap by owner after the answer; the served turns
    fail where a collector pass while the answer is built, inside the
    burst, or that full pass, reaches GC_PASS_BAR_MS.
    The first served turn carries an SSE change stream, the second a
    large write over HTTP; the burst then runs in turns through
    socketserver's listen backlog of 5 and `serve`'s (`backlog_turns`).
    The reference answers are held as arrays and row tuples, so that the
    passes measured are the server's.  Returns the `hosts` numbers of (a)
    and the path's launches."""
    import gc

    from cozo_tpu_torch.hosts.server import LISTEN_BACKLOG

    scripts = [JOIN.format(rel=f"q16_{t}") for t in range(HOSTS_THREADS)]
    # the Db's own answers first, outside the counted window
    want = [sorted(map(tuple, json.loads(db.run_script_json(s))["rows"]))
            for s in scripts]
    direct = rank_arrays(db.run_script_json(GRAPH_PR))
    turns = [gc_turn(db, scripts, want, direct, False, census=True)]
    zero_all_counts()  # counts of the served turn's HTTP requests only
    out = gc_turn(db, scripts, want, direct, True, census=True,
                  extra=lambda url, o: sse_check(db, url, o))
    out["launches"] = all_counts()
    turns.append(dict(out))
    gc.unfreeze()
    turns.append(gc_turn(db, scripts, want, direct, False))
    turns.append(gc_turn(db, scripts, want, direct, True, extra=later_write))
    out["gc_turns"] = turns
    ok = out["listen_overflows"] in (0, None)
    say(f"phase 11 (a) served turn: listen backlog {LISTEN_BACKLOG}, "
        f"{HOSTS_THREADS} clients x {HOSTS_REQS} small joins (B={DB_SMALL}) "
        f"over HTTP, no listen overflow {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("phase 11 failed: the server's listen queue")
    from cozo_tpu_torch.ops import exact_knn as ek

    # small joins and PageRank: no sweep, no selection on this path
    if (out["launches"]["slab_topk"], out["launches"]["sweep_topk"],
            ek.sweep_topk.two_step) != (
            EXPECTED["slab_topk"], EXPECTED["sweep_topk"],
            EXPECTED["two_step"]):
        raise SystemExit(f"phase 11 failed: the selection kernels "
                         f"launched {out['launches']} (two-step "
                         f"{ek.sweep_topk.two_step}) where the calls "
                         f"imply {EXPECTED}")
    # one beam launch a small join (B = 16 < 64: the device beam search)
    n_req = HOSTS_THREADS * HOSTS_REQS
    ok = (out["launches"]["beam_search"] == n_req
          and out["launches"]["graph_pagerank"] >= 1)
    say(f"phase 11 (a) kernel launches of the served turn's HTTP requests: "
        f"{out['launches']}; beam_search {n_req} (one a small join), "
        f"graph_pagerank >= 1: {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("phase 11 failed: the server path's kernel launches")
    out["backlog_turns"] = backlog_turns(db, scripts, want)
    gc.unfreeze()  # serving ends: the rest of the run collects as before
    return out


def trace_small_join(db, extra=None):
    """The Chrome trace of `utils.profiling.device_trace` around two small
    joins (B = 16) after a warm one, and `extra()` where given: (events,
    kernel names).  The profiler can drop a run of a session's first
    device records: `device_trace`'s primer takes the drop, and
    `device_trace` raises on a trace that kept none of the primer's
    kernels."""
    import shutil
    import tempfile

    import torch

    from cozo_tpu_torch.utils.profiling import device_trace

    small = JOIN.format(rel="q16")
    db.run_script(small)
    tmp = tempfile.mkdtemp(prefix="cozo_phase11_trace_")
    try:
        with device_trace(tmp):
            db.run_script(small)
            db.run_script(small)
            if extra is not None:
                extra()
            torch.cuda.synchronize()
        files = os.listdir(tmp)
        if len(files) != 1:
            raise SystemExit(f"phase 11 failed: device_trace wrote {files}")
        with open(os.path.join(tmp, files[0])) as f:
            events = json.load(f)["traceEvents"]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return events, sorted({e["name"] for e in events
                           if e.get("cat") == "kernel"})


def phase_trace(db):
    """Phase 11 (d): `utils.profiling.device_trace` around a small join on
    the card: its Chrome trace names the beam kernel."""
    from cozo_tpu_torch.utils.profiling import primer_kernels

    events, kernels = trace_small_join(db)
    ok = any("beam_search_kernel" in k for k in kernels)
    kept = primer_kernels(events)
    say(f"phase 11 (d) device_trace around a small join: {len(events)} "
        f"events, {len(kernels)} kernels by name, the primer's kernels "
        f"kept {kept}, the beam kernel among them {ok} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("phase 11 failed: the trace names no beam kernel")
    return {"trace_events": len(events), "trace_kernels": len(kernels),
            "trace_primer_kept": kept, "trace_names_beam_kernel": ok}


def trace_after_server(db):
    """Phase 11 (d) once more, after (a)'s server and its client threads,
    with one ATen kernel (a sum on the card) in the same session: the
    trace must name both the beam kernel and the sum's `reduce_kernel`
    (a trace without the sum has seen nothing of the card; one without
    the beam kernel has missed the port's)."""
    import torch

    from cozo_tpu_torch.utils.profiling import primer_kernels

    events, kernels = trace_small_join(db, lambda: torch.ones(
        1 << 20, device="cuda").sum())
    beam = any("beam_search_kernel" in k for k in kernels)
    aten = any("reduce_kernel" in k for k in kernels)
    kept = primer_kernels(events)
    say(f"phase 11 (d) after the server: {len(events)} events, the "
        f"primer's kernels kept {kept}, kernels {kernels}; the beam kernel "
        f"among them {beam}, the ATen sum {aten} "
        f"{'ok' if beam and aten else 'FAIL'}")
    if not (beam and aten):
        raise SystemExit("phase 11 failed: the trace after the server names "
                         "no beam kernel or no ATen sum")
    return {"trace_after_server_primer_kept": kept,
            "trace_after_server_names_beam_kernel": beam,
            "trace_after_server_names_aten_sum": aten,
            "trace_after_server_kernels": len(kernels)}


def repl_script():
    """A REPL session: create, put, an index and a `~` search on a small
    relation, `%backup` into the working directory, `%exit`."""
    rng = np.random.default_rng(11)
    pts = np.round(rng.standard_normal((300, 8)), 4)
    rows = ", ".join(f"[{i}, vec({p.tolist()})]" for i, p in enumerate(pts))
    return "\n".join([
        ":create pts {id: Int => v: <F32; 8>}",
        f"?[id, v] <- [{rows}] :put pts {{id => v}}",
        "::hnsw create pts:ix {dim: 8, m: 8, ef_construction: 32, "
        "fields: [v], distance: L2}",
        "?[id, d] := ~pts:ix{id | query: vec("
        f"{pts[7].tolist()}), k: 3, ef: 32, bind_distance: d}} :order d",
        "?[count(id)] := *pts{id}",
        "%backup back.db",
        "%exit", ""])


def run_module(args, cwd, stdin=None, timeout=300):
    """`python args...` in `cwd`, with this checkout importable."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [root, *filter(None, [os.environ.get("PYTHONPATH")])]))
    return subprocess.run([sys.executable, *args], input=stdin,
                          capture_output=True, text=True, timeout=timeout,
                          cwd=cwd, env=env)


def phase_clis():
    """Phase 11 (b): `python -m cozo_tpu_torch.hosts.server` with no
    `--device` on a free port answers `GET /` and a text query on the
    card; `python -m cozo_tpu_torch.hosts.repl` with no `--device` prints,
    banner aside, what the same stdin prints with `--device cpu`."""
    import select
    import shutil
    import tempfile

    root = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.Popen(
        [sys.executable, "-m", "cozo_tpu_torch.hosts.server", "--port", "0",
         *CARD_ARGS], stdout=subprocess.PIPE, text=True, cwd=root)
    out = {}
    try:
        ready, _, _ = select.select([proc.stdout], [], [], 180)
        banner = proc.stdout.readline() if ready else ""
        if "listening" not in banner:
            raise SystemExit(f"phase 11 failed: the server CLI did not start "
                             f"({banner!r})")
        url = f"http://127.0.0.1:{banner.rsplit(':', 1)[1].strip()}"
        root_ok = http(url, "/", method="GET") == (
            200, {"ok": True, "service": "cozo_tpu", "status": "ready"})
        status, res = http(url, "/text-query", {"script": "?[a] <- [[1], [2]]"})
        query_ok = status == 200 and res.get("rows") == [[1], [2]]
    finally:
        proc.terminate()
        proc.wait(timeout=60)
    ok = root_ok and query_ok and CARD in banner
    out["server_cli"] = ok
    say(f"phase 11 (b) server CLI ({banner.strip()}): GET / {root_ok}, text "
        f"query {query_ok} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("phase 11 failed: the server CLI")

    script = repl_script()
    outs = []
    for args in (CARD_ARGS, ["--device", "cpu"]):
        wd = tempfile.mkdtemp(prefix="cozo_phase11_repl_")
        try:
            p = run_module(["-m", "cozo_tpu_torch.hosts.repl", *args],
                           wd, script)
            outs.append((p.returncode, *p.stdout.partition("\n")[::2],
                         os.path.exists(os.path.join(wd, "back.db"))))
            if p.returncode:
                say(p.stderr[-3000:])
        finally:
            shutil.rmtree(wd, ignore_errors=True)
    (rc_c, banner_c, text_c, back_c), (rc_h, _, text_h, back_h) = outs
    ok = (rc_c == rc_h == 0 and text_c == text_h and back_c and back_h
          and CARD in banner_c and "(3 rows)" in text_c
          and "backup done" in text_c)
    out["repl_cli"] = ok
    say(f"phase 11 (b) REPL CLI ({banner_c.strip()}): output equal to "
        f"--device cpu's, banner aside, {text_c == text_h}; %backup wrote "
        f"its file {back_c} {'ok' if ok else 'FAIL'}")
    if not ok:
        say(text_c[-2000:])
        raise SystemExit("phase 11 failed: the REPL CLI")
    return out


def phase_c_abi():
    """Phase 11 (c): the port's `libcozo_c.so` built from
    `cozo_tpu_torch/native/cozo_c.cpp`, the unchanged
    `native/example_c_host.c` compiled against it (its "" options: the
    card) and run: it prints C_ABI_OK; in process, `c_bridge.open_db`
    with "" options gives a Db on the card."""
    import shutil
    import tempfile

    from cozo_tpu_torch.hosts import c_bridge

    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.time()
    lib = c_bridge.build_library()
    wd = tempfile.mkdtemp(prefix="cozo_phase11_c_")
    try:
        exe = os.path.join(wd, "c_host")
        subprocess.run(["gcc", "-O2", os.path.join(root, "native",
                                                   "example_c_host.c"),
                        *c_bridge.link_flags(lib), "-o", exe], check=True,
                       capture_output=True)
        build_s = time.time() - t0
        t0 = time.time()
        p = subprocess.run([exe], env=c_bridge.host_env(lib),
                           capture_output=True, text=True, timeout=300,
                           cwd=wd)
        run_s = time.time() - t0
    finally:
        shutil.rmtree(wd, ignore_errors=True)
    host_ok = p.returncode == 0 and "C_ABI_OK" in p.stdout
    opened = json.loads(c_bridge.open_db("mem", "", ""))
    db_dev = str(c_bridge._DBS[opened["id"]].device) if opened.get("ok") \
        else opened.get("message")
    if opened.get("ok"):
        c_bridge.close_db(opened["id"])
    ok = host_ok and db_dev.startswith(CARD)
    say(f"phase 11 (c) C ABI: library and host built in {build_s:.1f}s, the "
        f"host ran in {run_s:.1f}s: {p.stdout.strip().splitlines()[-1:]}"
        f"; open_db('mem', '', '') -> {db_dev} {'ok' if ok else 'FAIL'}")
    if not ok:
        say(p.stdout[-2000:] + p.stderr[-3000:])
        raise SystemExit("phase 11 failed: the C ABI")
    return {"c_abi_host": host_ok, "c_abi_open_device": db_dev,
            "c_abi_host_s": run_s}


def phase_examples():
    """Phase 11 (e): each of the port's four examples on the card (no
    `--device`) prints what it prints with `--device cpu`; the eight runs
    at once."""
    root = os.path.dirname(os.path.abspath(__file__))
    runs = [(name, args) for name in EXAMPLES
            for args in (CARD_ARGS, ["--device", "cpu"])]
    with ThreadPoolExecutor(len(runs)) as ex:
        procs = list(ex.map(lambda r: run_module(
            [os.path.join("cozo_tpu_torch", "examples", f"{r[0]}.py"),
             *r[1]], root), runs))
    out = {}
    for i, name in enumerate(EXAMPLES):
        card, host = procs[2 * i], procs[2 * i + 1]
        ok = (card.returncode == host.returncode == 0
              and card.stdout == host.stdout and card.stdout.strip() != "")
        out[name] = ok
        say(f"phase 11 (e) example {name}: {len(card.stdout.splitlines())} "
            f"lines, equal to --device cpu's {card.stdout == host.stdout} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            say(card.stdout[-1500:] + card.stderr[-2000:] + host.stderr[-1000:])
    if not all(out.values()):
        raise SystemExit("phase 11 failed: an example")
    return out


def quality_draw(n, main_draw=False):
    """Phase 11 (f)'s rows and queries: `glove_like(n + 256, 100, seed
    42)` split, or with `main_draw` the first n rows of the main path's
    draw and the first 256 of its queries (phase 3c's)."""
    from cozo_tpu_torch.utils.datasets import glove_like

    if main_draw:
        x = glove_like(N + NQ, D, seed=42)
        return x[:n].copy(), x[N:N + QUALITY_NQ].copy()
    x = glove_like(n + QUALITY_NQ, D, seed=42)
    return x[:n], x[n:]


def baseline_graph(n, main_draw=False):
    """Phase 11 (f)'s baseline: `CpuHnswBaseline` (m = 16, ef_construction
    = 200, cosine; one thread, in C++ outside the GIL) built on
    `quality_draw(n, main_draw)`.  Returns its build seconds and its ids
    at ef = 64 and 128 for the draw's queries."""
    from cozo_tpu_torch.ops.cpu_baseline import CpuHnswBaseline

    data, qs = quality_draw(n, main_draw)
    t0 = time.time()
    base = CpuHnswBaseline(D, 16, 200, "Cosine")
    base.add(data)
    base_s = time.time() - t0
    return base_s, {ef: base.search(qs, K, ef)[0] for ef in (64, 128)}


def phase_graph_quality(n, main_draw=False, baseline=None):
    """Phase 11 (f): the graph-quality check.  `quality_draw(n,
    main_draw)` built through a `Db("mem")` on the card (`::hnsw create`:
    the device `bulk_build`, wave 8,192, m = 16, ef_construction = 200,
    cosine) and by `CpuHnswBaseline` (`native/hnsw_baseline.cpp`, the
    reference algorithm, one thread of the card's host; `baseline`: the
    `HostJob` of `baseline_graph`, None: built here); recall@10 of each
    graph's host search at ef = 64 and 128 on the 256 queries against
    exact cosine.  Prints, never fails on the numbers (the tier-1 test
    holds the port to JAX).  Returns the numbers and the Db (phase 11 (d)
    of `--hosts-only` runs on it)."""
    data, qs = quality_draw(n, main_draw)
    dn = data / np.linalg.norm(data, axis=1, keepdims=True)
    qn = qs / np.linalg.norm(qs, axis=1, keepdims=True)
    gt = np.argsort(-(qn @ dn.T), axis=1, kind="stable")[:, :K]
    db, built = build_db(data)
    index = db.algo_cache["hnsw::item::ix"].index
    (base_s, base_ids), _, _ = host_result(baseline, baseline_graph, n,
                                           main_draw)
    out = {"n": n, "draw": f"the first {n} rows of glove_like({N + NQ})"
           if main_draw else f"glove_like({n + QUALITY_NQ})",
           "queries": QUALITY_NQ, "port_bulk_build_s":
           built["bulk_build_s"], "baseline_build_s": base_s,
           "baseline_beside_phase_2": baseline is not None}
    for ef in (64, 128):
        out[f"port_recall@10_ef{ef}"] = recall(
            index.search(qs, K, ef, use_tpu=False)[0], gt)
        out[f"baseline_recall@10_ef{ef}"] = recall(base_ids[ef], gt)
        out[f"gap_ef{ef}"] = (out[f"port_recall@10_ef{ef}"]
                              - out[f"baseline_recall@10_ef{ef}"])
    say(f"phase 11 (f) graph quality at {n} x {D} ({out['draw']}, seed 42; "
        f"m 16, ef_construction 200): the port's bulk_build on the card "
        f"{built['bulk_build_s']:.1f}s, the baseline on one host thread "
        f"{base_s:.1f}s{' (beside phase 2)' if baseline else ''}; "
        f"recall@10 port / baseline / gap: ef 64 "
        f"{out['port_recall@10_ef64']:.5f} / "
        f"{out['baseline_recall@10_ef64']:.5f} / {out['gap_ef64']:+.5f}, "
        f"ef 128 {out['port_recall@10_ef128']:.5f} / "
        f"{out['baseline_recall@10_ef128']:.5f} / {out['gap_ef128']:+.5f} "
        f"(printed, no bar)")
    store_queries(db, "q16", qs[:DB_SMALL])
    return out, db


def phase_hosts(quality_n, main_draw=False, baseline=None):
    """Phase 11 (b), (c), (e) and (f) (`baseline`: as
    `phase_graph_quality` takes it); returns their `hosts` numbers and
    (f)'s Db."""
    out = {}
    out.update(phase_clis())
    out.update(phase_c_abi())
    out["examples"] = phase_examples()
    out["graph_quality"], db = phase_graph_quality(quality_n, main_draw,
                                                   baseline)
    return out, db


def hosts_only(args):
    """--hosts-only: phase 11 without (a): (b), (c), (e), (f) at --n rows
    and (d) on (f)'s Db; (f) on phase 3c's rows with --quality-main-draw."""
    t0 = time.time()
    out, db = phase_hosts(args.n, args.quality_main_draw)
    out.update(phase_trace(db))
    del db
    out["card"] = smi_line()
    say("hosts " + json.dumps(out))
    say(f"total {time.time() - t0:.1f}s")
    say(smi_line())
    say("hosts-only run: no verdict on the main path")
    return 0


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
    kernels, scale, mesh_graph = phase_graph_scale(dev, args.reps, db_timings)
    for entry in kernels:
        count_graph_launches(entry, {"db graph (phase 6)": launches,
                                     "scale (phase 7)": scale})
    say("mesh " + json.dumps({"graph": mesh_graph, "card": smi_line()}))
    say(f"total {time.time() - t0:.1f}s")
    say(json.dumps({"kernels": kernels}))
    say(smi_line())
    say("graph-only run: no verdict on the main path")
    return 0


def mesh_only(args, dev):
    """--mesh-only: the loop for work on the mesh and the engines: phase 9
    on an index of --n rows built through a Db (its ground truth and raw
    bf16 recall taken here), the graph steps on phase 7's graph, then
    phase 10."""
    from cozo_tpu_torch import sweep_search
    from cozo_tpu_torch.ops import graph_algos as ga
    from cozo_tpu_torch.utils.datasets import glove_like

    t0 = time.time()
    data = glove_like(args.n + NQ, D, seed=42)
    qs, data = data[args.n:], data[:args.n]
    db, _ = build_db(data)
    index = db.algo_cache["hnsw::item::ix"].index
    gt = sweep_search(index, qs, K, rt=1.0, compute_dtype="f32",
                      exact_rerank=False)[0]
    raw = sweep_search(index, qs, K, rt=0.99, compute_dtype="bf16",
                       exact_rerank=False)[0]
    mesh = phase_mesh_sweep(index, data, qs, {"gt": gt,
                                              "raw_recall": recall(raw, gt)},
                            dev, OTHER_LANE_REPS)
    del db, index
    phase_engines(data, qs, dev)
    ip, d = make_graph(LJ_NODES, LJ_EDGES)
    sp = ga.sssp_device(ip, d, np.ones(len(d), np.float32), [0],
                        cache_key=ga.graph_content_key(ip, d))
    mesh["graph"] = phase_mesh_graph(dev, ip, d, sp[0][0])
    mesh["card"] = smi_line()
    say("mesh " + json.dumps(mesh))
    say(f"total {time.time() - t0:.1f}s")
    say(smi_line())
    say("mesh-only run: no verdict on the main path")
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


def topk_only(args, dev):
    """--topk-only: the loop for work on the selection kernel: phase 2's
    slab_topk cases, then an index of --n rows of the main draw built on
    the card (its launches counted), each sweep lane once with its
    launches, and phase 4's slab_topk timings on that index."""
    from cozo_tpu_torch import HnswIndex, sweep_search
    from cozo_tpu_torch.utils.datasets import glove_like

    t0 = time.time()
    phase_topk_vs_plain(dev)
    data = glove_like(args.n + NQ, D, seed=42)
    qs, data = data[args.n:], data[:args.n]
    index = HnswIndex(dim=D, m=16, ef_construction=200, distance="Cosine")
    topk_zero()
    t1 = time.time()
    index.bulk_build(data, wave=8192)
    say(f"topk-only: bulk_build of {args.n} x {D} in {time.time() - t1:.1f}s")
    topk_read("build (--topk-only)", "build", sweep=True)
    for cd, rk in (("f32", None), ("bf16", None), ("i8", 64),
                   ("fused", None)):
        topk_zero()
        t1 = time.time()
        sweep_search(index, qs, K, compute_dtype=cd, rerank_k=rk,
                     exact_rerank=cd != "f32")
        topk_read(f"lane {cd} (--topk-only)", "lanes",
                  sweep=cd in ("f32", "bf16", "i8"))
        say(f"topk-only: lane {cd} B={NQ} first call {time.time() - t1:.2f}s")
    kernels = [time_topk(index, qs, args.reps)]
    finish_topk_entry(kernels)
    say(f"total {time.time() - t0:.1f}s")
    say(json.dumps({"kernels": kernels}))
    say(smi_line())
    say("topk-only run: no verdict on the main path")
    return 0


def synthetic_sweep_table(n, dev, seed=0):
    """A sweep table of the main path's shape without an index: n unit
    rows of D dims (normal, seeded, made on the card) in `_chunking`'s
    chunks, padded to d_pad 128, padding rows dead; and NQ unit queries."""
    import torch
    from types import SimpleNamespace

    from cozo_tpu_torch.ops.exact_knn import _chunking

    chunk, n_chunks = _chunking(n)
    g = torch.Generator(device=dev).manual_seed(seed)
    tbl = torch.zeros((n_chunks * chunk, 128), device=dev)
    tbl[:n, :D] = torch.nn.functional.normalize(
        torch.randn((n, D), generator=g, device=dev), dim=1)
    bias = torch.zeros(n_chunks * chunk, device=dev)
    bias[n:] = -np.inf
    qs = torch.nn.functional.normalize(
        torch.randn((NQ, D), generator=g, device=dev), dim=1)
    return (SimpleNamespace(tbl=tbl.view(n_chunks, chunk, 128),
                            bias=bias.view(n_chunks, chunk)),
            qs.cpu().numpy())


def sweep_only(args, dev):
    """--sweep-only: the loop for work on the chunk-step kernel: phase 2's
    sweep_topk cases, then phase 4's sweep_topk timings on a synthetic
    table of --n rows (the main path's shape, no index), at phase 3b's
    768-wide shapes on a synthetic table of its size, at two of them 384
    wide (`time_wide_384`) and at phase 3d's shape (`time_wide_1536`)."""
    import torch

    t0 = time.time()
    phase_sweep_vs_plain(dev)
    say(f"[{time.time() - t0:.1f}s] phase 2 (sweep_topk) done")
    st, qs = synthetic_sweep_table(args.n, dev)
    kernels = [time_sweep(st, qs, args.reps),
               time_sweep_f32(st, qs, args.reps)]
    del st, qs
    torch.cuda.empty_cache()
    time_wide_sweep(*synthetic_wide_table(dev))
    time_wide_384(dev)
    time_wide_1536(dev)
    finish_topk_entry(kernels)
    say(f"total {time.time() - t0:.1f}s")
    say(json.dumps({"kernels": kernels}))
    say(smi_line())
    say("sweep-only run: no verdict on the main path")
    return 0


def f32_only(args, dev):
    """--f32-only: the loop for work on the f32 chunk step: phase 2's f32
    cases, then phase 4's f32 timings on a synthetic table of --n rows
    (the main path's shape, no index)."""
    t0 = time.time()
    phase_sweep_vs_plain(dev, SWEEP_F32_CASES)
    say(f"[{time.time() - t0:.1f}s] phase 2 (sweep_topk f32) done")
    st, qs = synthetic_sweep_table(args.n, dev)
    kernels = [time_sweep_f32(st, qs, args.reps)]
    say(f"total {time.time() - t0:.1f}s")
    say(json.dumps({"kernels": kernels}))
    say(smi_line())
    say("f32-only run: no verdict on the main path")
    return 0


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=None,
                    help=f"table rows on the main path (>= {MIN_N}; "
                         f"default {N}, with --hosts-only {MIN_N})")
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
    ap.add_argument("--mesh-only", action="store_true",
                    help="build the kernels, then phase 9 (the mesh) on a "
                         "Db's index of --n rows and on phase 7's graph, "
                         "and phase 10 (the engines); no verdict")
    ap.add_argument("--hosts-only", action="store_true",
                    help="build the kernels, then phase 11 (the hosts) "
                         "without the server at full size: the CLIs, the C "
                         "ABI, the examples, the graph-quality check at "
                         "--n rows and a trace on its Db; no verdict")
    ap.add_argument("--topk-only", action="store_true",
                    help="build the kernels, hold slab_topk to its plain "
                         "version, build an index of --n rows, run each "
                         "sweep lane once and time slab_topk on it; no "
                         "verdict")
    ap.add_argument("--sweep-only", action="store_true",
                    help="build the kernels, hold sweep_topk to its plain "
                         "version and time it on a synthetic table of --n "
                         "rows and at phase 3b's 768-wide shapes; no "
                         "verdict")
    ap.add_argument("--f32-only", action="store_true",
                    help="build the kernels, hold sweep_topk's f32 kind to "
                         "its plain version (phase 2's f32 cases) and time "
                         "it as phase 4 does on a synthetic table of --n "
                         "rows; no verdict")
    ap.add_argument("--quality-main-draw", action="store_true",
                    help="with --hosts-only: the graph-quality check on "
                         "the first --n rows of the main path's draw and "
                         "its first 256 queries (phase 3c's), not on "
                         "glove_like(--n + 256)")
    args = ap.parse_args()
    if args.quality_main_draw and not args.hosts_only:
        ap.error("--quality-main-draw goes with --hosts-only")
    if args.n is None:
        args.n = MIN_N if args.hosts_only or args.topk_only else N
    if args.n < MIN_N:
        ap.error(f"--n must be at least {MIN_N}")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from cozo_tpu_torch import default_device

    dev = default_device()
    install_launch_ledger()
    say(f"device: {torch.cuda.get_device_name(0)} "
        f"(torch {torch.__version__}, CUDA {torch.version.cuda})")
    if args.n != N and not args.hosts_only:
        say(f"main path cut: {args.n} rows instead of {N}")

    t_all = time.time()
    phase_build()
    if args.graph_only:
        return graph_only(args, dev)
    if args.mesh_only:
        return mesh_only(args, dev)
    if args.hosts_only:
        return hosts_only(args)
    if args.topk_only:
        return topk_only(args, dev)
    if args.sweep_only:
        return sweep_only(args, dev)
    if args.f32_only:
        return f32_only(args, dev)
    phase_minhash_vs_plain(dev)
    if args.lsh_only:
        return lsh_only(args)
    jobs = {}
    if not args.kernels_only:  # the host's work of later phases, beside 2
        jobs = {"wide": HostJob(wide_draw, QUANT_N + QUANT_NQ, QUANT_D, 43),
                "openai": HostJob(wide_draw, OPENAI_N + OPENAI_NQ, OPENAI_D,
                                  OPENAI_SEED, True),
                "graphs": HostJob(scale_graphs),
                "baseline": HostJob(baseline_graph, QUALITY_N)}
    phase_kernel_vs_plain(dev)
    phase_topk_vs_plain(dev)
    phase_sweep_vs_plain(dev)
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
        lap("phase 6 and its timings")
        # (d) before the server and after it, each gated
        hosts = phase_trace(db)
        hosts.update(phase_server(db))
        hosts.update(trace_after_server(db))
        del db
        lap("phase 11 (d), (a), (d): traces around the server on phase 5's "
            "Db")
        launches, truth = phase_main(index, qs, build_s, args.reps)
        launches["beam_search_db"] = db_launches
        main_inputs = main_path_inputs(index, qs)
    kernels = phase_kernel_timing(main_inputs, launches, args.reps, dev)
    if args.kernels_only:
        kernels.append(phase_beam_quick(MIN_N))
    else:
        kernels.append(time_beam(index, qs, launches))
        kernels.append(time_topk(index, qs, args.reps))
        kernels.append(time_sweep(index._sweep_table, qs, args.reps))
        kernels.append(time_sweep_f32(index._sweep_table, qs, args.reps))
        del main_inputs
        torch.cuda.empty_cache()
        lap("phases 3 and 4 (main path)")
        mesh = phase_mesh_sweep(index, data, qs, truth, dev, OTHER_LANE_REPS)
        del index, truth
        torch.cuda.empty_cache()
        lap("phase 9 (the sweep and the Db through the mesh)")
        engine_launches = phase_engines(data, qs, dev)
        lap("phase 10 (the engines)")
        phase_i8_build(data, qs)
        del data
        wide = phase_quant_wide(jobs["wide"])
        wide["card"] = smi_line()
        say("wide " + json.dumps(wide))
        lap("phases 3b and 3c")
        time_wide_384(dev)
        lap("phase 4's sweep_topk at d_pad 384")
        openai = phase_openai(jobs["openai"])
        openai["card"] = smi_line()
        say("openai " + json.dumps(openai))
        lap("phase 3d (1,536-wide rows) and its phase 4 timings")
        (graph_kernels, graph_launches["scale (phase 7)"],
         mesh["graph"]) = phase_graph_scale(dev, args.reps, db_timings,
                                            jobs["graphs"])
        mesh["card"] = smi_line()
        say("mesh " + json.dumps(mesh))
        lap("phase 7 and its timings, phase 9's graph steps")
        for entry in graph_kernels:
            count_graph_launches(entry, graph_launches)
        kernels += graph_kernels
        lsh_launches, first_chunk, _ = phase_lsh()
        kernels.append(time_minhash(first_chunk, lsh_launches, args.reps))
        add_path_launches(kernels, "engines (phase 10)", engine_launches)
        lap("phase 8 and its timing")
        more, db = phase_hosts(QUALITY_N, baseline=jobs["baseline"])
        del db
        hosts.update(more)
        hosts["card"] = smi_line()
        say("hosts " + json.dumps(hosts))
        lap("phase 11 (b), (c), (e), (f)")
        add_path_launches(kernels, "server (phase 11)", hosts["launches"])
        finish_topk_entry(kernels)
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
