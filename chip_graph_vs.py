#!/usr/bin/env python3
"""A kernel of this checkout beside another checkout's, on one card.

    git archive <commit> | tar -x -C .archive/other   # a git-ignored dir
    python3 chip_graph_vs.py --other .archive/other
    python3 chip_graph_vs.py --kernel pagerank --other .archive/other
    python3 chip_graph_vs.py --kernel slab_topk --other .archive/other
    python3 chip_graph_vs.py --kernel sweep_topk --other .archive/other \
        [--diag .archive/copy ...] [--counters] \
        [--wide [--d 768 --d 384] [--all-modes]]
    python3 chip_graph_vs.py --kernel sweep_topk --f32 --other .archive/other \
        [--diag .archive/f32-products --diag .archive/f32-ring]
    python3 chip_graph_vs.py --make-wide-copies .archive/pr18
    python3 chip_graph_vs.py --make-f32-copies .

Builds the kernel's source (`cozo_tpu_torch/csrc/graph_labelprop.cu`,
`graph_pagerank.cu`, `slab_topk.cu` or `sweep_topk.cu`) of both checkouts with this
checkout's nvcc flags, runs each build in turns (other, this, this,
other) and prints a line a shape.

`--kernel labelprop` (the default; the C entry point `cozo_lp_pick` has
kept its arguments since it was written) stages the label-propagation
lanes of `chip_smoke.py` phase 6 (the Db's undirected level-0 graph of
1,183,514 `glove_like` rows, the same draw) and phase 7 (the 50M-edge hub
graph) and times one pick of every lane at random and at converged
labels, each replayed from a CUDA graph (`chip_smoke.graph_ms`); every
pick is held to the plain version.

`--kernel pagerank` times 10 steps, replayed from a CUDA graph, at the
LiveJournal shape of phase 7 (4,928,571 nodes, 69M Pareto-sourced edges)
and at a uniform stand-in of the Db's level-0 graph (1,183,514 nodes,
26,489,371 edges, sources and destinations uniform).  Either build may
have the first version's C interface (`cozo_pagerank` over the
destination-sorted sources) or the binned one; each result is held to the
plain version (L1, the same top 100) and two runs must be bit-identical,
unless `--unchecked-other` says that the other build computes something
else (a stream floor with the gather replaced).

`--kernel slab_topk` times the per-chunk selection (`slab_topk.cu`, whose
C entry point `cozo_slab_topk` has kept its arguments since it was
written) at the slabs `chip_smoke.py` phase 4 times: the f32, quant
and fused lanes' chunks and the five merges, from the table of phase 3's index (the same
`glove_like` rows, seed 42, made into the sweep table without the graph),
and at a worst case, ascending keys at the bf16 lane's shape.  Each call
is replayed from a CUDA graph (`chip_smoke.graph_ms`: the device's time);
each result is held to the plain version, bit for bit, and two runs must
be identical.

`--kernel sweep_topk` times the chunk step (`sweep_topk.cu`, whose C
entry point `cozo_sweep_topk` has kept its arguments since it was
written) at the six shapes `chip_smoke.py` phase 4 times (the bf16 lane
+ re-rank and raw, the i8 lane, the build step, the mesh's shard, rising
keys) on its synthetic table of the main path's shape, each build at the
piece `exact_knn.sweep_piece` picks for it (an older build has no
clusters and no occupancy query: the SMs are its slots); with `--wide`,
at phase 3b's five 768-wide chunk steps (`chip_smoke.sweep_wide_shapes`)
on a synthetic table of its size (`chip_smoke.synthetic_wide_table`).  A
design choice is weighed as a copy of the source with one change under
`.archive/NAME`, timed as one more other; a copy that does not build is
reported (nvcc's errors) and left out.  Every result of this build and
of each `--other` is held to the plain version by phase 4's measure
(`sweep_values_agree`); `--diag DIR` times a build as `--other` does but
never holds it to plain (a copy that computes something else, such as the
ring and the products alone).  ptxas's registers, shared memory, spills
and warnings are printed for every build.  `--counters` also runs a
build with `-DCOZO_SWEEP_COUNTERS` once a shape and prints its counts
(warp-tiles with pass 2, keyings, rejected keyings).  Each shape's line
also gives the table's bytes from L2 a launch (the table once a cluster
of blocks: table x query tiles / cluster).  `--d 384` runs the wide
shapes on a table of that width (phase 4's second wide table); `--d 768
--d 384` both, one after the other; `--all-modes` adds the row states the
lanes do not reach there (bf16 kc 64, int8 kc 26, kc 256 of both kinds).

`--kernel sweep_topk --f32` times the f32 kind instead
(`sweep_topk_f32.cu`, whose C entry point `cozo_sweep_topk_f32` has kept
its arguments since it was written) at its four timed shapes
(`f32_shapes`: the f32 lane's [16,384 x 1,310,720] x 128, real width
100, kc 10 and 26, and phase 3d's [4,096 x 524,288] x 1,536 kc 10 and
116), every build, this checkout's too, built with this checkout's
flags; each build's answer (the top kc over its pieces, ids and score
bits) is held equal to this build's, and this build's to the two-step
route's (cuBLAS's f32 product + `slab_topk` a chunk) at the lane's shape;
each line gives both builds' ms in turns, their share of the bound (the
chains stopped at the real width at 67 TFLOP/s) and the two-step route's
ms.  `--make-f32-copies BASE` writes the f32 kind's diagnostic copies of
BASE (`F32_COPIES`: `products` the ring and the products with no
hand-off and no selection, `ring` the ring alone, `noload` all but the
loads) under `.archive/f32-NAME/`, to be timed with `--diag`.

`--make-wide-copies BASE` needs no card: it writes the diagnostic copies
of BASE's wide form (`WIDE_COPIES`, for the source at commit 6100156: the
form as it stood before its redesign) under `.archive/wide-NAME/`, each BASE's
`sweep_topk.cu` and `sweep_select.cuh` with a few lines replaced, which
split the wide form's time: `ring` the ring alone (the producer streams,
the consumers wait and release), `products` the ring and the products
with no selection, `l2hit` that with every block streaming the same 16
tiles (always in L2), `noload` the products with no table loads at all,
and `c4` clusters of 4 blocks sharing each chunk (a design, held to
plain).  Time them with `--diag` (`--other` for `c4`).

`--sector-model` runs no kernel and needs no card: it counts, on the
host, the distinct 32-byte sectors each window of 32 consecutive gathers
reads in the first version's destination-major order and in the binned
order at two bin sizes, at those two shapes (the model `PERF.md`
quotes).

Prints the card's name and power limit last.
"""

import argparse
import ctypes
import os
import subprocess
import sys
import tempfile

import chip_smoke as cs

# the edges of the Db's level-0 graph in chip_smoke.py phase 6 (1,183,514
# `glove_like` rows, m = 16)
DB_GRAPH_EDGES = 26_489_371

# The diagnostic copies of the wide form, as (file, old, new) replacements
# of the source at commit 6100156 (`--make-wide-copies`); each `old`
# occurs once there.
_WIDE_IDLE = ("sweep_topk.cu",
              "  const bool idle = qt >= a.n_qt;\n  const int n_tiles = a.piece / TN;\n"
              "  const int kcn = w.kcn;\n",
              "  const bool idle = true;  // diagnostic: the ring alone\n"
              "  const int n_tiles = a.piece / TN;\n  const int kcn = w.kcn;\n")
_WIDE_NO_SELECT = ("sweep_topk.cu",
                   "    for (int t = 0; t < G; ++t) select_tile(d[t], e + t);\n",
                   "    for (int t = 0; t < G; ++t) {  // diagnostic: no selection\n"
                   "      vec_of(e + t);\n      free_vec(e + t);\n    }\n")
_WIDE_L2_HIT = ("sweep_topk.cu",
                "          col[t] = col_base + (long long)tile * TN;\n",
                "          col[t] = (long long)(tile & 15) * TN;  // diagnostic: 16 tiles\n")
_WIDE_NO_LOAD = ("sweep_topk.cu",
                 "            mbar_expect_tx(bar, T_BOX + (with_a ? Q_WBOX : 0u));\n"
                 "            tma_load_2d_mc(base + w.ring + stage * T_BOX + rank * (SHARE * ROW), &map_t, bar,\n"
                 "                           c * ELEMS, (int)(col[t] + rank * SHARE),\n"
                 "                           (uint16_t)((1u << C::CLUSTER) - 1));\n",
                 "            mbar_expect_tx(bar, with_a ? Q_WBOX : 0u);  // diagnostic: no table\n")
WIDE_COPIES = {
    "ring": (_WIDE_IDLE,),
    "products": (_WIDE_NO_SELECT,),
    "l2hit": (_WIDE_NO_SELECT, _WIDE_L2_HIT),
    "noload": (_WIDE_NO_SELECT, _WIDE_NO_LOAD),
    "c4": (("sweep_select.cuh", "using WideCfg = Cfg<1, MODE, 2>;",
            "using WideCfg = Cfg<1, MODE, 4>;"),
           ("sweep_topk.cu", "C::NCONS == 1 && C::CLUSTER == 2",
            "C::NCONS == 1 && C::CLUSTER == 4")),
}

# The diagnostic copies of the f32 kind (`--make-f32-copies`), replacements
# in this checkout's `sweep_f32.cuh` (and its includers' files, copied
# as they are): `products` the ring and the products (each tile's sums
# kept alive, no hand-off, no selection: the selecting warpgroup only
# feeds the ring), `ring` the ring alone (the consumers wait for each
# stage and free it), `noload` everything but the loads (each stage's
# barrier completed with no bytes: the loop's own rate on stale data).
_F32_NO_HANDOFF = ("sweep_f32.cuh",
                   "      const int sl = g % slots;\n",
                   "      const int sl = g % slots;\n"
                   "      if (g >= 0) {  // diagnostic: the sums kept, no hand-off\n"
                   "        float z = 0.f;\n"
                   "        for (int r = 0; r < 8; ++r)\n"
                   "          for (int c = 0; c < MC; ++c) z += acc[r][c];\n"
                   "        if (z == 1.2345e-30f) staging[tid] = z;\n"
                   "        continue;\n"
                   "      }\n")
_F32_NO_SELECT = ("sweep_f32.cuh",
                  "    for (int e = 0; e < n_tiles; ++e) {\n",
                  "    if (producer)  // diagnostic: no selection, the ring fed to its end\n"
                  "      while (p_step < n_steps) {\n"
                  "        feed();\n"
                  "        Dev::idle();\n"
                  "      }\n"
                  "    for (int e = 0; e < 0; ++e) {\n")
_F32_NO_PRODUCTS = ("sweep_f32.cuh",
                    "    int kk = 0;\n",
                    "    int kk = kl;  // diagnostic: no products\n")
_F32_NO_LOADS = (("sweep_f32.cuh",
                  "        Dev::expect(full(p_st), L.stage_bytes);\n"
                  "        Dev::load(dst, mt, full(p_st), p_s * KS, "
                  "(int)(col_base + (long long)p_tile * F::TC));\n"
                  "        if (!L.resident) Dev::load(dst + L.t_box, mq, full(p_st), "
                  "p_s * KS, qt * RB);\n",
                  "        (void)dst;  // diagnostic: no loads\n"
                  "        Dev::arrive(full(p_st));\n"),
                 ("sweep_f32.cuh",
                  "        Dev::expect(q_full, (unsigned)L.n_ks * L.q_box);\n"
                  "        for (int s = 0; s < L.n_ks; ++s)\n"
                  "          Dev::load(smem + L.q + s * L.q_box, mq, q_full, s * KS, qt * RB);\n",
                  "        Dev::arrive(q_full);  // diagnostic: no loads\n"))
F32_COPIES = {
    "products": (_F32_NO_HANDOFF, _F32_NO_SELECT),
    "ring": (_F32_NO_PRODUCTS, _F32_NO_HANDOFF, _F32_NO_SELECT),
    "noload": _F32_NO_LOADS,
}
F32_FILES = ("sweep_topk_f32.cu", "sweep_f32.cuh", "sweep_select.cuh",
             "hopper.cuh")


def make_copies(base, copies, prefix, out_root=".archive",
                files=("sweep_topk.cu", "sweep_select.cuh")):
    """Writes each of `copies` under `out_root/PREFIX-NAME/`: BASE's
    `files` (of `cozo_tpu_torch/csrc/`) with the copy's lines replaced.
    Returns the copies' roots."""
    src = os.path.join(base, "cozo_tpu_torch", "csrc")
    roots = []
    for name, edits in copies.items():
        text = {}
        for f in files:
            with open(os.path.join(src, f)) as fh:
                text[f] = fh.read()
        for f, old, new in edits:
            if text[f].count(old) != 1:
                raise SystemExit(f"copy {name}: {f} of {base} has "
                                 f"{text[f].count(old)} places for {old!r}")
            text[f] = text[f].replace(old, new)
        root = os.path.join(out_root, f"{prefix}-{name}")
        dst = os.path.join(root, "cozo_tpu_torch", "csrc")
        os.makedirs(dst, exist_ok=True)
        for f, t in text.items():
            with open(os.path.join(dst, f), "w") as fh:
                fh.write(t)
        roots.append(root)
    return roots


def build_other(root, out_dir, name):
    """ctypes handle of the other checkout's `csrc/<name>.cu`, built with
    this checkout's flags."""
    from cozo_tpu_torch.ops import _build

    # a file of its own per checkout: dlopen hands back the library
    # already loaded from a path
    out = os.path.join(out_dir, f"{name}_{abs(hash(root))}.so")
    proc = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", out,
                           os.path.join(root, "cozo_tpu_torch", "csrc",
                                        f"{name}.cu")],
                          check=True, capture_output=True, text=True)
    say_ptxas(f"{name} of {root}", proc.stderr)
    lib = ctypes.CDLL(out)
    lib.cozo_cuda_error_string.argtypes = [ctypes.c_int]
    lib.cozo_cuda_error_string.restype = ctypes.c_char_p
    return lib


def say_ptxas(what, log):
    """ptxas's registers, shared memory, spills and warnings of each
    kernel."""
    for line in log.splitlines():
        if ("Used" in line or "spill" in line or "warning" in line
                or "Performance Loss" in line):
            cs.say(f"  ptxas {what}: {line.strip()[:240]}")


def ek_sweep_lib():
    from cozo_tpu_torch.ops import exact_knn as ek

    return ek._sweep_lib()


def build_others(roots, out_dir, name):
    """`build_other` of each root, the builds run together; a root whose
    source does not build is reported and left out."""
    from concurrent.futures import ThreadPoolExecutor

    def one(root):
        try:
            return build_other(root, out_dir, name)
        except subprocess.CalledProcessError as e:
            cs.say(f"{name} of {root} does not build:\n{e.stderr[-4000:]}")
            return None

    with ThreadPoolExecutor(len(roots)) as ex:
        libs = list(ex.map(one, roots))
    return {r: lib for r, lib in zip(roots, libs) if lib is not None}


# the kernels of either PageRank build, for the profiler's breakdown
PR_KERNELS = ("pr_init", "pr_reduce", "pr_step", "pr_bins", "pr_finish")

# the first version's C interface of `cozo_pagerank`: the
# destination-sorted sources, the in-CSR bounds and the degrees, then the
# scratch
_DST_MAJOR_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
                       + [ctypes.c_float] * 3 + [ctypes.c_void_p] * 6)


def pagerank_runner(lib, staged, n_real, iterations, theta):
    """A function that enqueues `iterations` steps of `lib`'s PageRank on
    the current stream and returns the ranks: the binned interface
    through the module's launcher, the first version's through its own
    arguments."""
    import numpy as np
    import torch

    from cozo_tpu_torch.ops import _build
    from cozo_tpu_torch.ops import graph_algos as ga

    if hasattr(lib, "cozo_pagerank_bin_nodes"):
        ga._bind_pagerank(lib)
        bins = lib.cozo_pagerank_bin_nodes()
        layout = staged[3:] if bins == ga.PR_BIN_NODES else ga._pagerank_bins(
            staged[0], staged[1], n_real, bins)
        return lambda: ga._pagerank_launch(lib, *staged[:3], *layout, n_real,
                                           iterations, theta,
                                           ga._stream(staged[0]))
    lib.cozo_pagerank.argtypes = _DST_MAJOR_ARGTYPES
    lib.cozo_pagerank.restype = ctypes.c_int
    lib.cozo_pagerank_max_blocks.restype = ctypes.c_int
    src_by_dst, in_ptr, out_deg = staged[:3]
    n_pad = out_deg.shape[0]
    inv_n = np.float32(1.0) / np.float32(n_real)
    c0 = np.float32(1 - theta) * inv_n

    def run():
        dev = out_deg.device
        ranks = torch.empty(n_pad, dtype=torch.float32, device=dev)
        ca, cb = torch.empty_like(ranks), torch.empty_like(ranks)
        parts = torch.empty(lib.cozo_pagerank_max_blocks(),
                            dtype=torch.float32, device=dev)
        dang = torch.empty(1, dtype=torch.float32, device=dev)
        err = lib.cozo_pagerank(
            src_by_dst.data_ptr(), in_ptr.data_ptr(), out_deg.data_ptr(),
            n_real, n_pad, iterations, float(inv_n), float(c0),
            float(np.float32(theta)), ranks.data_ptr(), ca.data_ptr(),
            cb.data_ptr(), parts.data_ptr(), dang.data_ptr(),
            ga._stream(out_deg))
        _build.check(lib, err, "graph_pagerank (destination-major interface) launch")
        return ranks

    return run


def uniform_graph(n_nodes, n_edges, seed=5):
    """Sources and destinations uniform: the stand-in for the Db's
    level-0 graph."""
    import numpy as np

    rng = np.random.default_rng(seed)
    src = np.sort(rng.integers(0, n_nodes, n_edges))
    dst = rng.integers(0, n_nodes, n_edges)
    indptr = np.zeros(n_nodes + 1, dtype=np.int64)
    indptr[1:] = np.cumsum(np.bincount(src, minlength=n_nodes))
    return indptr, dst


def sectors_per_edge(src):
    """Distinct 32-byte sectors of f32 contributions that each window of 32
    consecutive gathers (a warp's lanes on consecutive edges) reads, per
    edge: the model of the gather's L2 traffic, with no reuse across
    windows."""
    import numpy as np

    window = np.arange(len(src), dtype=np.int64) // 32
    return len(np.unique((window << 32) | (src >> 3))) / len(src)


def sector_model(bin_sizes):
    """The model on the host, for the destination-major order and the
    binned order at each bin size, at the LiveJournal shape and on the
    uniform stand-in of the Db graph."""
    import numpy as np

    for where, (indptr, dst) in (
            ("LiveJournal shape (phase 7)", cs.make_graph(cs.LJ_NODES,
                                                          cs.LJ_EDGES)),
            ("uniform stand-in of the Db graph (phase 6)",
             uniform_graph(cs.N, DB_GRAPH_EDGES))):
        src = np.repeat(np.arange(len(indptr) - 1, dtype=np.int64),
                        np.diff(indptr))
        model = {"destination-major": sectors_per_edge(
            src[np.argsort(dst, kind="stable")])}
        for r in bin_sizes:
            key = np.sort(((dst // r) << 32) | src)
            model[f"bins of {r}, by source"] = sectors_per_edge(
                key & 0xFFFFFFFF)
        cs.say(f"{where}: sectors an edge, windows of 32 gathers: "
               + ", ".join(f"{k} {v:.3f}" for k, v in model.items()))


def compare_pagerank(libs, indptr, dst, dev, reps, where, check_other):
    """Each other build against this one, in turns, on one graph."""
    import torch

    from cozo_tpu_torch.ops import graph_algos as ga

    n, e = len(indptr) - 1, len(dst)
    staged = ga._pagerank_stage(indptr, dst, None, dev)
    cs.pagerank_layout(staged, n, e, where)
    want = ga.pagerank_plain(*staged, n, 10, 0.85)
    runs = {name: pagerank_runner(lib, staged, n, 10, 0.85)
            for name, lib in libs.items()}
    for name, run in runs.items():
        got, again = run(), run()
        torch.cuda.synchronize()
        l1, top = cs.pagerank_agreement(got, want, n)
        ok = l1 <= cs.PR_L1_TOL and top and torch.equal(got, again)
        cs.say(f"{where}: {name} L1 {l1:.3e}, top-100 same {top}, two runs "
               f"identical {bool(torch.equal(got, again))}")
        if not ok and (name == "this" or check_other):
            raise SystemExit(f"{name} disagrees with plain: {where}")
    for name, run in runs.items():
        parts = {}
        for kernel, k_ms in cs.kernel_times(run, "pr_init"):
            short = next((k for k in PR_KERNELS if k in kernel), kernel)
            parts[short] = parts.get(short, 0.0) + k_ms
        cs.say(f"{where}: {name} device ms by kernel (the profiler, one "
               f"call): " + ", ".join(f"{k} {v:.4f}" for k, v in parts.items()))
    for name in libs:
        if name == "this":
            continue
        ms = {name: [], "this": []}
        for turn in (name, "this", "this", name):
            ms[turn].append(cs.graph_ms(runs[turn], reps))
        other, this = (sum(v) / len(v) for v in (ms[name], ms["this"]))
        cs.say(f"{where} graph_pagerank 10 steps, n={n} e={e}: {name} "
               f"{other:.4f} ms ({ms[name]}), this {this:.4f} ms "
               f"({ms['this']}), {other / this:.2f}x")


def sweep_index(data):
    """What the sweep reads of phase 3's index (its rows, slots equal to
    ids, every row alive), without the graph, its tables made by one
    call of each lane."""
    from types import SimpleNamespace

    import numpy as np

    from cozo_tpu_torch import sweep_search

    index = SimpleNamespace(
        vectors=data, norms=np.einsum("ij,ij->i", data, data, dtype=np.float64),
        alive=np.ones(len(data), bool), n=len(data), dim=data.shape[1],
        distance="Cosine", version=1, sweep_pending=set(), device=None,
        _sweep_table=None)
    q = data[:64]
    for cd, rk in (("f32", None), ("i8", 64), ("fused", None)):
        sweep_search(index, q, cs.K, compute_dtype=cd, rerank_k=rk,
                     exact_rerank=cd != "f32")
    return index


def ascending_slab(dev):
    """The worst case of a running threshold at the bf16 lane's shape:
    every row's keys ascend, so every element beats the threshold."""
    import torch

    return ("ascending keys", torch.arange(
        131_072, dtype=torch.float32, device=dev).expand(cs.NQ, -1)
        .contiguous(), 26, {})


def compare_topk(libs, shapes, reps):
    """Each build on every slab, in turns (other, this, this, other)."""
    import torch

    from cozo_tpu_torch.ops import exact_knn as ek

    for lane, x, kf, kw in shapes:
        B, W = x.shape
        want = cs.topk_plain_blocks(x, kf, kw)
        runs = {name: (lambda lib=lib: ek._topk_run(
            lib, x, kf, kw.get("col_scale"), kw.get("row_scale"),
            kw.get("bias"), kw.get("bf16", False), 0, None,
            torch.cuda.current_stream().cuda_stream)[0])
            for name, lib in libs.items()}
        for name, run in runs.items():
            got, again = run(), run()
            torch.cuda.synchronize()
            if not (cs.topk_same(got, want) and cs.topk_same(got, again)):
                raise SystemExit(f"{name} disagrees with plain: {lane}")
        del want
        for name in libs:
            if name == "this":
                continue
            ms = {name: [], "this": []}
            for turn in (name, "this", "this", name):
                ms[turn].append(cs.graph_ms(runs[turn], reps))
            other, this = (sum(v) / len(v) for v in (ms[name], ms["this"]))
            cs.say(f"slab_topk {lane} [{B} x {W}] {x.dtype} kf {kf} "
                   f"prologue {sorted(kw) or 'none'}: {name} {other:.4f} ms "
                   f"({ms[name]}), this {this:.4f} ms ({ms['this']}), "
                   f"{other / this:.2f}x; both bit-equal to plain")
        del x, kw, runs
        torch.cuda.empty_cache()


class FirstSweep:
    """A build of the first design (no clusters, no occupancy query) as
    `exact_knn.sweep_piece` reads a library: clusters of 1, the SMs as
    slots."""

    def __init__(self, lib, sms):
        self.lib, self.sms = lib, sms

    def __getattr__(self, name):  # the build's own C entries
        return getattr(self.lib, name)

    def cozo_sweep_topk_cluster(self, kind, kc):
        return 1

    def cozo_sweep_topk_slots(self, kind, d_pad, kc):
        return self.sms


def bind_sweep_any(lib):
    """`lib`'s C entries bound; a build of the first design behind
    `FirstSweep`."""
    import torch

    from cozo_tpu_torch.ops import exact_knn as ek

    if hasattr(lib, "cozo_sweep_topk_slots"):
        return ek._bind_sweep(lib)
    lib.cozo_sweep_topk.argtypes = ek._SWEEP_ARGTYPES
    lib.cozo_sweep_topk.restype = ctypes.c_int
    lib.cozo_sweep_topk_rows.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.cozo_sweep_topk_rows.restype = ctypes.c_int
    return FirstSweep(lib, torch.cuda.get_device_properties(
        torch.cuda.current_device()).multi_processor_count)


def sweep_launch(lib, q, tbl, piece, kc, kw, out):
    """One launch of `lib`'s chunk step on the current stream."""
    import torch

    from cozo_tpu_torch.ops import _build

    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    B, d_pad = q.shape
    err = lib.cozo_sweep_topk(
        q.data_ptr(), tbl.data_ptr(), int(q.dtype == torch.int8), B,
        tbl.shape[0], d_pad, piece, kc, kw["bias"].data_ptr(),
        ptr(kw.get("col_scale")), ptr(kw.get("row_scale")), out[0].data_ptr(),
        out[1].data_ptr(), out[0].stride(0), 0,
        torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "sweep_topk launch")
    return out


def wide_modes(shapes):
    """`shapes` (phase 3b's wide chunk steps), then the row states that
    they do not reach on the same table: bf16 kc 64 (lists of 16), int8
    kc 26 (lists of 8), both kinds at kc 256 (head 256)."""
    import torch

    by_kc = {}
    for lane, q, tbl, chunk, kc, kw in shapes:
        by_kc.setdefault(q.dtype, (q, tbl, chunk, kw))
        yield lane, q, tbl, chunk, kc, kw
    for dtype, kc in ((torch.bfloat16, 64), (torch.int8, 26),
                      (torch.bfloat16, 256), (torch.int8, 256)):
        q, tbl, chunk, kw = by_kc[dtype]
        yield f"wide {dtype} kc {kc}", q, tbl, chunk, kc, kw


def compare_sweep(libs, counting, reps, dev, unchecked=(), wide=False, d=None,
                  all_modes=False):
    """Each build at every phase-4 shape (`wide`: phase 3b's wide ones, on
    a table d wide; `all_modes`: and `wide_modes`'s), in turns (other,
    this, this, other), each held to the plain version first (not the
    builds named in `unchecked`)."""
    import numpy as np
    import torch

    from cozo_tpu_torch.ops import exact_knn as ek

    if wide:
        shapes = cs.sweep_wide_shapes(*cs.synthetic_wide_table(
            dev, d=d or cs.QUANT_D))
        if all_modes:
            shapes = wide_modes(shapes)
        plain_rows = cs.WIDE_PLAIN_ROWS
    else:
        shapes = cs.sweep_main_shapes(*cs.synthetic_sweep_table(cs.N, dev))
        plain_rows = None
    for lane, q, tbl, chunk, kc, kw in shapes:
        B, d_pad = q.shape
        int8 = q.dtype == torch.int8
        runs, pieces, l2 = {}, {}, {}
        for name, lib in libs.items():
            piece = ek.sweep_piece(tbl.shape[0], chunk, B, d_pad, kc, int8,
                                   dev, lib=lib)
            out = ek._chunk_buffers(B, tbl.shape[0] // piece, kc,
                                    torch.bfloat16 if int8 else torch.float32,
                                    dev)
            runs[name] = (lambda lib=lib, piece=piece, out=out: sweep_launch(
                lib, q, tbl, piece, kc, kw, out))
            pieces[name] = piece
            rows = lib.cozo_sweep_topk_rows(int(int8), d_pad, kc)
            cluster = lib.cozo_sweep_topk_cluster(int(int8), d_pad, kc)
            n_qt = -(-(-(-B // rows)) // cluster) * cluster
            # the table once a cluster of blocks that share its chunks
            l2[name] = tbl.numel() * tbl.element_size() * n_qt / cluster
        for name, run in list(runs.items()):
            if name in unchecked:
                continue
            got = run()
            want = cs.sweep_plain_blocks(q, tbl, pieces[name], kc, kw,
                                         plain_rows)
            torch.cuda.synchronize()
            ok, share, err = cs.sweep_values_agree(got, want)
            del want
            if not ok and name == "this":
                raise SystemExit(f"{name} disagrees with plain: {lane} (ids "
                                 f"equal {share}, max err {err})")
            if not ok:  # an other build that is wrong is not timed
                cs.say(f"sweep_topk {lane}: {name} disagrees with plain (ids "
                       f"equal {share}, max err {err}); not timed")
                del runs[name]
        if counting is not None:
            piece = ek.sweep_piece(tbl.shape[0], chunk, B, d_pad, kc, int8,
                                   dev, lib=counting)
            out = ek._chunk_buffers(B, tbl.shape[0] // piece, kc,
                                    torch.bfloat16 if int8 else torch.float32,
                                    dev)
            counts = np.zeros(3, np.int64)
            counting.cozo_sweep_topk_counts(counts.ctypes.data)
            sweep_launch(counting, q, tbl, piece, kc, kw, out)
            torch.cuda.synchronize()
            _build_check = counting.cozo_sweep_topk_counts(counts.ctypes.data)
            rows_tiles = B * (tbl.shape[0] // 64) / 16
            cs.say(f"sweep_topk {lane} counters (piece {piece}, rc "
                   f"{_build_check}): warp-tiles with pass 2 {counts[0]} "
                   f"({counts[0] / rows_tiles:.4%} of {rows_tiles:.0f}), "
                   f"keyings {counts[1]} ({counts[1] / B:.1f} a row), "
                   f"rejected {counts[2]} ({counts[2] / max(counts[1], 1):.2%})")
            del out
        for name in runs:
            if name == "this":
                continue
            ms = {name: [], "this": []}
            for turn in (name, "this", "this", name):
                ms[turn].append(cs.cuda_ms(runs[turn], reps))
            other, this = (sum(v) / len(v) for v in (ms[name], ms["this"]))
            held = ("not held to plain" if name in unchecked
                    else "both agree with plain")
            cs.say(f"sweep_topk {lane} [{B} x {tbl.shape[0]}] x {d_pad} "
                   f"{q.dtype} kc {kc}: {name} {other:.3f} ms at piece "
                   f"{pieces[name]} ({[round(x, 3) for x in ms[name]]}; table "
                   f"from L2 {l2[name] / 1e9:.1f} GB a launch = "
                   f"{l2[name] / other / 1e9:.2f} TB/s), this {this:.3f} ms "
                   f"at piece {pieces['this']} "
                   f"({[round(x, 3) for x in ms['this']]}; "
                   f"{l2['this'] / 1e9:.1f} GB = "
                   f"{l2['this'] / this / 1e9:.2f} TB/s), "
                   f"{other / this:.3f}x; {held}")
        del runs, q, tbl, kw
        torch.cuda.empty_cache()


def f32_shapes(dev, widths=None):
    """The f32 kind's four timed chunk steps, as (name, q, tbl, bias,
    chunk, kc, d_real): [16,384 x 1,310,720] x 128, real width 100, kc 10
    (the f32 lane's) and 26 on phase 4's synthetic table
    (`chip_smoke.f32_main_inputs`), then [4,096 x 524,288] x 1,536 kc 10
    and 116 (VectorDBBench's top-100 + 16) on phase 3d's
    (`chip_smoke.synthetic_wide_table` at OpenAI's shape); `widths`: only
    the tables of these widths (128, 1,536)."""
    import torch

    if not widths or 128 in widths:
        st, qs = cs.synthetic_sweep_table(cs.N, dev)
        q, tbl, bias = cs.f32_main_inputs(st, qs)
        for kc in (10, 26):
            yield f"f32 lane kc {kc}", q, tbl, bias, st.tbl.shape[1], kc, cs.D
        del st, q, tbl, bias
        torch.cuda.empty_cache()
    if not widths or cs.OPENAI_D in widths:
        wide = cs.synthetic_wide_table(dev, seed=cs.OPENAI_SEED,
                                       d=cs.OPENAI_D, n=cs.OPENAI_N, f32=True)
        bias, chunk, tbl, q = wide[3], wide[4], wide[8], wide[9]
        del wide
        torch.cuda.empty_cache()
        for kc in (10, 116):
            yield f"wide f32 kc {kc}", q, tbl, bias, chunk, kc, 0


def f32_launch(lib, q, tbl, piece, kc, bias, d_real, out):
    """One launch of `lib`'s f32 chunk step on the current stream."""
    import torch

    from cozo_tpu_torch.ops import _build

    B, d_pad = q.shape
    err = lib.cozo_sweep_topk_f32(
        q.data_ptr(), tbl.data_ptr(), B, tbl.shape[0], d_pad, d_real, piece,
        kc, bias.data_ptr(), out[0].data_ptr(), out[1].data_ptr(),
        out[0].stride(0), 0, torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "sweep_topk_f32 launch")
    return out


def f32_top(out, kc):
    """The top kc of a launch's per-piece columns (`merge_chunks`), as
    one int32 tensor [B, 2 kc]: ids, then the score bits."""
    import torch

    from cozo_tpu_torch.ops import exact_knn as ek

    v, i = ek.merge_chunks(*out, kc)
    return torch.cat([i.to(torch.int32), v.view(torch.int32)], dim=1)


def compare_sweep_f32(libs, reps, dev, unchecked=(), widths=None):
    """The f32 kind of each build at `f32_shapes`, each at the piece
    `exact_knn.sweep_piece` gives it from its own launch configuration,
    in turns (other, this, this, other), beside the two-step route (a
    chunk's cuBLAS product in f32 + `slab_topk`, `sweep_two_step`) and the
    bound (the chains stopped at the real width at 67 TFLOP/s).  Each
    build's answer (the top kc over the pieces: ids and score bits) is
    held equal to this build's (not the builds named in `unchecked`),
    and this build's to the two-step route's at the f32 lane's shape (kc
    10 at 128); elsewhere the rows that differ from the route are
    printed."""
    import numpy as np
    import torch

    from cozo_tpu_torch.ops import exact_knn as ek

    for lane, q, tbl, bias, chunk, kc, d_real in f32_shapes(dev, widths):
        B, d_pad = q.shape
        n_total = tbl.shape[0]
        runs, pieces, tops = {}, {}, {}
        for name, lib in libs.items():
            piece = ek.sweep_piece(n_total, chunk, B, d_pad, kc, ek.SWEEP_F32,
                                   dev, lib=lib)
            out = ek._chunk_buffers(B, n_total // piece, kc, torch.float32,
                                    dev)
            runs[name] = (lambda lib=lib, piece=piece, out=out: f32_launch(
                lib, q, tbl, piece, kc, bias, d_real, out))
            pieces[name] = piece
            if name not in unchecked:
                tops[name] = f32_top(runs[name](), kc)
        route = ek._chunk_buffers(B, n_total // chunk, kc, torch.float32, dev)
        ek.sweep_two_step(q, tbl, chunk, kc, bias, None, None, 0, route)
        want = f32_top(route, kc)
        torch.cuda.synchronize()
        mine = tops["this"]
        differ = int((mine != want).any(1).sum())
        cs.say(f"sweep_topk[f32] {lane}: this build's answer against the "
               f"two-step route: {differ} of {B} rows differ in ids or score "
               f"bits")
        if differ and lane == "f32 lane kc 10":
            raise SystemExit(f"this build disagrees with the two-step route "
                             f"at the f32 lane's shape ({differ} rows)")
        for name, top in tops.items():
            if not torch.equal(top, mine):
                raise SystemExit(f"{name} disagrees with this build: {lane} "
                                 f"({int((top != mine).any(1).sum())} rows)")
        del tops, want, mine
        route_ms = cs.cuda_ms(lambda: ek.sweep_two_step(
            q, tbl, chunk, kc, bias, None, None, 0, route), 1)
        del route
        torch.cuda.empty_cache()
        bound = 2.0 * B * n_total * (d_real or d_pad) / cs.PEAK_F32 * 1e3
        for name in runs:
            if name == "this":
                continue
            ms = {name: [], "this": []}
            for turn in (name, "this", "this", name):
                ms[turn].append(cs.cuda_ms(runs[turn], reps))
            other, this = (float(np.mean(v)) for v in (ms[name], ms["this"]))
            held = ("not held" if name in unchecked
                    else "both bit-equal to this build's answer")
            cs.say(f"sweep_topk[f32] {lane} [{B} x {n_total}] x {d_pad}"
                   f"{f' (real width {d_real})' if d_real else ''} kc {kc}: "
                   f"{name} {other:.3f} ms at piece {pieces[name]} "
                   f"({[round(x, 3) for x in ms[name]]}; "
                   f"{100 * bound / other:.1f}% of the bound), this "
                   f"{this:.3f} ms at piece {pieces['this']} "
                   f"({[round(x, 3) for x in ms['this']]}; "
                   f"{100 * bound / this:.1f}%), {other / this:.3f}x; the "
                   f"bound {bound:.3f} ms, the two-step route {route_ms:.3f} "
                   f"ms ({route_ms / this:.3f}x this); {held}")
        del runs
        torch.cuda.empty_cache()


def compare_lanes(libs, cache_key, n_real, ended, dev, reps, where):
    import torch

    from cozo_tpu_torch.ops import graph_algos as ga

    for nb, w, idx, has_in in cs.lp_lanes(cache_key, dev):
        H, W = nb.shape
        for kind, labels in cs.lp_label_sets(n_real, ended, dev).items():
            want = labels.clone()
            ga.lp_pick_plain(labels, nb, w, idx, has_in, n_real, want)
            ms = {"other": [], "this": []}
            for name in ("other", "this", "this", "other"):
                out = labels.clone()

                def pick():
                    ga._lp_launch(libs[name], labels, nb, w, idx, has_in,
                                  n_real, out, ga._stream(nb))

                pick()
                torch.cuda.synchronize()
                if not torch.equal(out, want):
                    raise SystemExit(f"{name} disagrees with plain: {where} "
                                     f"W={W} {kind}")
                ms[name].append(cs.graph_ms(pick, reps))
            other, this = (sum(v) / len(v) for v in (ms["other"], ms["this"]))
            cs.say(f"{where} lane W={W} H={H} {kind} labels: other "
                   f"{other:.4f} ms, this {this:.4f} ms ({other / this:.2f}x)"
                   f", both equal to plain")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", action="append",
                    help="root of the other checkout (PageRank: repeat to "
                         "time several, each beside this one)")
    ap.add_argument("--sector-model", action="store_true",
                    help="PageRank's gather model on the host instead (no "
                         "card): sectors an edge of each layout")
    ap.add_argument("--kernel", choices=("labelprop", "pagerank",
                                         "slab_topk", "sweep_topk"),
                    default="labelprop")
    ap.add_argument("--counters", action="store_true",
                    help="sweep_topk: print a counting build's counts a "
                         "shape")
    ap.add_argument("--wide", action="store_true",
                    help="sweep_topk: phase 3b's 768-wide shapes instead "
                         "of the main path's")
    ap.add_argument("--d", type=int, action="append", default=None,
                    help="sweep_topk --wide: the table's width (default "
                         "768); repeat for several, in one process; "
                         "--f32: only the shapes of this width (128, 1536)")
    ap.add_argument("--all-modes", action="store_true",
                    help="sweep_topk --wide: also bf16 kc 64, int8 kc 26 and "
                         "kc 256 of both kinds (every row state)")
    ap.add_argument("--diag", action="append", default=[],
                    help="sweep_topk: another build timed like --other but "
                         "not held to plain (a diagnostic copy); repeat")
    ap.add_argument("--f32", action="store_true",
                    help="sweep_topk: its f32 kind (`sweep_topk_f32.cu`) "
                         "at its four timed shapes instead")
    ap.add_argument("--make-f32-copies", metavar="BASE",
                    help="write the f32 kind's diagnostic copies of BASE "
                         "under .archive/f32-NAME and exit (no card)")
    ap.add_argument("--make-wide-copies", metavar="BASE",
                    help="write the wide form's diagnostic copies of BASE "
                         "under .archive/wide-NAME and exit (no card)")
    ap.add_argument("--unchecked-other", action="store_true",
                    help="pagerank: the other build computes another "
                         "function (a stream floor): time it, do not hold it "
                         "to plain (sweep_topk: --diag)")
    ap.add_argument("--reps", type=int, default=None,
                    help="replays timed (default: 100 picks, 20 PageRank "
                         "calls, 5 selections)")
    args = ap.parse_args()
    if args.make_wide_copies:
        for root in make_copies(args.make_wide_copies, WIDE_COPIES, "wide"):
            print(root)
        return 0
    if args.make_f32_copies:
        for root in make_copies(args.make_f32_copies, F32_COPIES, "f32",
                                files=F32_FILES):
            print(root)
        return 0
    if args.sector_model:
        from cozo_tpu_torch.ops import graph_algos as ga

        sector_model((ga.PR_BIN_NODES, 28_672))
        return 0
    if not (args.other or args.diag):
        ap.error("--other is required")
    if args.unchecked_other and args.kernel != "pagerank":
        ap.error("--unchecked-other is PageRank's; a sweep_topk build not "
                 "held to plain is named by --diag")
    args.other = args.other or []

    import torch

    if not torch.cuda.is_available():
        print("chip_graph_vs: CUDA is not available", file=sys.stderr)
        return 1
    from cozo_tpu_torch import default_device
    from cozo_tpu_torch.ops import _build
    from cozo_tpu_torch.ops import graph_algos as ga
    from cozo_tpu_torch.utils.datasets import glove_like

    dev = default_device()
    if args.kernel == "sweep_topk" and args.f32:
        from cozo_tpu_torch.ops import exact_knn as ek

        with tempfile.TemporaryDirectory() as tmp:
            # every build at once: this checkout's and the others
            libs = {root: ek._bind_sweep_f32(lib) for root, lib in
                    build_others(args.other + args.diag + ["."], tmp,
                                 "sweep_topk_f32").items()}
            if "." not in libs:
                raise SystemExit("this checkout's sweep_topk_f32.cu does not "
                                 "build")
            libs["this"] = libs.pop(".")
            compare_sweep_f32(libs, args.reps or 5, dev, set(args.diag),
                              args.d)
        cs.say(cs.smi_line())
        return 0
    if args.kernel == "sweep_topk":
        from concurrent.futures import ThreadPoolExecutor

        defines = [()] + ([("-DCOZO_SWEEP_COUNTERS",)] if args.counters
                          else [])
        with tempfile.TemporaryDirectory() as tmp, ThreadPoolExecutor(
                len(defines) + 1) as ex:
            # every build at once: this checkout's and the others
            mine = [ex.submit(_build.build, "sweep_topk", d) for d in defines]
            libs = {root: bind_sweep_any(lib) for root, lib in build_others(
                args.other + args.diag, tmp, "sweep_topk").items()} \
                if args.other or args.diag else {}
            for f in mine:
                f.result()
            libs["this"] = ek_sweep_lib()
            counting = (bind_sweep_any(_build.load(
                "sweep_topk", ("-DCOZO_SWEEP_COUNTERS",)))
                if args.counters else None)
            for what, (_, log) in sorted(_build.BUILD_INFO.items()):
                say_ptxas(f"{what} of this checkout", log)
            for d in args.d or [None]:
                compare_sweep(libs, counting, args.reps or 5, dev,
                              set(args.diag), args.wide, d, args.all_modes)
        cs.say(cs.smi_line())
        return 0
    if args.kernel == "slab_topk":
        import itertools

        from cozo_tpu_torch.ops import exact_knn as ek

        with tempfile.TemporaryDirectory() as tmp:
            libs = {root: ek._bind_topk(lib) for root, lib in build_others(
                args.other, tmp, "slab_topk").items()}
            libs["this"] = ek._topk_lib()
            for what, (_, log) in _build.BUILD_INFO.items():
                say_ptxas(f"{what} of this checkout", log)
            data = glove_like(cs.N + cs.NQ, cs.D, seed=42)
            qs, data = data[cs.N:], data[:cs.N]
            index = sweep_index(data)
            compare_topk(libs, itertools.chain(
                cs.topk_main_shapes(index, qs),
                cs.topk_merge_shapes(index, qs), [ascending_slab(dev)]),
                args.reps or 5)
        cs.say(cs.smi_line())
        return 0
    if args.kernel == "pagerank":
        with tempfile.TemporaryDirectory() as tmp:
            libs = build_others(args.other, tmp, "graph_pagerank")
            libs["this"] = _build.load("graph_pagerank")
            reps = args.reps or 20
            ip, d = cs.make_graph(cs.LJ_NODES, cs.LJ_EDGES)
            compare_pagerank(libs, ip, d, dev, reps,
                             "LiveJournal shape (phase 7)",
                             not args.unchecked_other)
            del ip, d
            ip, d = uniform_graph(cs.N, DB_GRAPH_EDGES)
            compare_pagerank(libs, ip, d, dev, reps,
                             "uniform stand-in of the Db graph (phase 6)",
                             not args.unchecked_other)
        cs.say(cs.smi_line())
        return 0
    args.reps = args.reps or 100
    with tempfile.TemporaryDirectory() as tmp:
        libs = {"other": ga._bind_lp(build_other(args.other[0], tmp,
                                                 "graph_labelprop")),
                "this": ga._bind_lp(_build.load("graph_labelprop"))}
        data = glove_like(cs.N + cs.NQ, cs.D, seed=42)[:cs.N]
        db = cs.build_db(data)[0]
        del data
        db.run_script(cs.GRAPH_LP)
        u_ptr, u_dst, u_verts = cs.cached_csr(db, True)
        uck = ga.graph_content_key(u_ptr, u_dst)
        ended = ga.labelprop_jax(u_ptr, u_dst, None, 10, cache_key=uck,
                                 device=dev)
        compare_lanes(libs, uck, len(u_verts), ended, dev, args.reps,
                      "db graph (phase 6)")
        del db
        ga._GRAPH_DEV_CACHE.clear()
        hp, hd = cs.make_hub_graph(cs.HUB_NODES, cs.HUB_EDGES, cs.HUB_DEG)
        hck = ga.graph_content_key(hp, hd)
        ended = ga.labelprop_jax(hp, hd, iterations=10, cache_key=hck,
                                 device=dev)
        compare_lanes(libs, hck, cs.HUB_NODES, ended, dev, args.reps,
                      "hub graph (phase 7)")
    cs.say(cs.smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
