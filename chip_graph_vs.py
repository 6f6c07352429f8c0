#!/usr/bin/env python3
"""The label pick of this checkout beside another checkout's, on one card.

    git archive <commit> | tar -x -C .archive/other   # a git-ignored dir
    python3 chip_graph_vs.py --other .archive/other

Builds `cozo_tpu_torch/csrc/graph_labelprop.cu` of both checkouts with
this checkout's nvcc flags (the C entry point `cozo_lp_pick` has kept its
arguments since it was written), stages the label-propagation lanes of
`chip_smoke.py` phase 6 (the Db's undirected level-0 graph of 1,183,514
`glove_like` rows, the same draw) and phase 7 (the 50M-edge hub graph),
and times one pick of every lane with each build at random and at
converged labels, in turns (other, this, this, other), each replayed from
a CUDA graph (`chip_smoke.graph_ms`); every pick is held to the plain
version.  Prints a line a lane and the card's name and power limit last.
"""

import argparse
import ctypes
import os
import subprocess
import sys
import tempfile

import chip_smoke as cs


def build_other(root, out_dir):
    """ctypes handle of the other checkout's pick, built with this
    checkout's flags."""
    from cozo_tpu_torch.ops import _build
    from cozo_tpu_torch.ops import graph_algos as ga

    out = os.path.join(out_dir, "graph_labelprop_other.so")
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", out,
                    os.path.join(root, "cozo_tpu_torch", "csrc",
                                 "graph_labelprop.cu")],
                   check=True, capture_output=True, text=True)
    return ga._bind_lp(ctypes.CDLL(out))


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
    ap.add_argument("--other", required=True,
                    help="root of the other checkout")
    ap.add_argument("--reps", type=int, default=100)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_graph_vs: CUDA is not available", file=sys.stderr)
        return 1
    from cozo_tpu_torch import default_device
    from cozo_tpu_torch.ops import _build
    from cozo_tpu_torch.ops import graph_algos as ga
    from cozo_tpu_torch.utils.datasets import glove_like

    dev = default_device()
    with tempfile.TemporaryDirectory() as tmp:
        libs = {"other": build_other(args.other, tmp),
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
