#!/usr/bin/env python3
"""A graph kernel of this checkout beside another checkout's, on one card.

    git archive <commit> | tar -x -C .archive/other   # a git-ignored dir
    python3 chip_graph_vs.py --other .archive/other
    python3 chip_graph_vs.py --kernel pagerank --other .archive/other

Builds the kernel's source (`cozo_tpu_torch/csrc/graph_labelprop.cu` or
`graph_pagerank.cu`) of both checkouts with this checkout's nvcc flags,
runs each build in turns (other, this, this, other) and prints a line a
shape.

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


def build_other(root, out_dir, name):
    """ctypes handle of the other checkout's `csrc/<name>.cu`, built with
    this checkout's flags."""
    from cozo_tpu_torch.ops import _build

    # a file of its own per checkout: dlopen hands back the library
    # already loaded from a path
    out = os.path.join(out_dir, f"{name}_{len(os.listdir(out_dir))}.so")
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", out,
                    os.path.join(root, "cozo_tpu_torch", "csrc",
                                 f"{name}.cu")],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(out)
    lib.cozo_cuda_error_string.argtypes = [ctypes.c_int]
    lib.cozo_cuda_error_string.restype = ctypes.c_char_p
    return lib


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
    ap.add_argument("--kernel", choices=("labelprop", "pagerank"),
                    default="labelprop")
    ap.add_argument("--unchecked-other", action="store_true",
                    help="the other build computes another function (a "
                         "stream floor): time it, do not hold it to plain")
    ap.add_argument("--reps", type=int, default=None,
                    help="replays timed (default: 100 picks, 20 PageRank "
                         "calls)")
    args = ap.parse_args()
    if args.sector_model:
        from cozo_tpu_torch.ops import graph_algos as ga

        sector_model((ga.PR_BIN_NODES, 28_672))
        return 0
    if not args.other:
        ap.error("--other is required")

    import torch

    if not torch.cuda.is_available():
        print("chip_graph_vs: CUDA is not available", file=sys.stderr)
        return 1
    from cozo_tpu_torch import default_device
    from cozo_tpu_torch.ops import _build
    from cozo_tpu_torch.ops import graph_algos as ga
    from cozo_tpu_torch.utils.datasets import glove_like

    dev = default_device()
    if args.kernel == "pagerank":
        with tempfile.TemporaryDirectory() as tmp:
            libs = {root: build_other(root, tmp, "graph_pagerank")
                    for root in args.other}
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
