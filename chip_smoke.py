#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`cozo_tpu_torch`) on one card.

    python3 chip_smoke.py            # full size: 1,183,514 x 100 cosine

Phases, each reported on its own line; any failure exits non-zero:
  1. build every kernel under cozo_tpu_torch/csrc/ (one nvcc per source,
     all started together) and print the build seconds;
  2. hold each kernel against its plain PyTorch version on the card at
     small shapes;
  3. drive the main path through the user entry points: `glove_like`
     data (seed 42), `HnswIndex.bulk_build` (device build), then
     `sweep_search` with the f32 lane as ground truth and the fused,
     bf16+rerank and raw bf16 lanes at B=16,384 (one warm call, 5 timed
     reps each), holding each lane's recall@10 to its bar; the kernel
     launch counts are zeroed just before and read just after;
  4. time each kernel at the main-path shape with CUDA events, beside its
     bound, its plain version and a one-call PyTorch yardstick;
  5. print the kernels' JSON line, the card's name and power limit, and
     as the last line {"ok": true, "device": {...}}.
"""

import argparse
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

N, D, NQ, K = 1_183_514, 100, 16_384, 10
MIN_N = 262_144  # more than one 131,072-row chunk
PEAK_BF16 = 989e12  # H100 SXM dense bf16 FLOP/s
PEAK_BYTES = 3.35e12  # H100 SXM HBM3 bytes/s
BARS = {"fused+rerank": 0.999, "bf16+rerank": 0.999, "bf16-raw": 0.962}


def say(msg):
    print(msg, flush=True)


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


def phase_build():
    from cozo_tpu_torch.ops import _build

    names = sorted(f[:-3] for f in os.listdir(_build.CSRC) if f.endswith(".cu"))
    t0 = time.time()
    with ThreadPoolExecutor(len(names)) as ex:
        list(ex.map(_build.build, names))
    say(f"phase 1 build: {len(names)} kernel(s) {names} in "
        f"{time.time() - t0:.1f}s")
    for name, (secs, log) in sorted(_build.BUILD_INFO.items()):
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                say(f"  ptxas {name}: {line.strip()}")


def compare_fused(out_k, out_p, n_total, dead):
    """Agreement of the kernel's packed output with the plain version's."""
    import torch

    from cozo_tpu_torch.ops import fused_sweep as fs

    close = torch.isclose(out_k, out_p, rtol=1e-6, atol=1e-6).float().mean()
    seg_base = (torch.arange(out_k.shape[1], device=out_k.device) >> 1) * fs.SEG

    def ids(o):
        return seg_base[None, :] + (o.view(torch.int32) & (fs.SEG - 1))

    ik = ids(out_k)
    same_ids = (ik == ids(out_p)).float().mean()
    live = out_k > fs.NEG_FILL * 0.5
    dead_hits = int(((ik >= n_total - dead) & live).sum()) if dead else 0
    err = float((out_k - out_p).abs().max())
    return float(close), float(same_ids), dead_hits, err


def phase_kernel_vs_plain(dev):
    import torch

    from cozo_tpu_torch.ops import fused_sweep as fs

    g = torch.Generator(device=dev).manual_seed(0)
    for B, n_total, d_pad, dead in ((512, 16_384, 128, 100),
                                    (700, 131_072, 768, 0)):
        tbl = torch.randn(n_total, d_pad, generator=g, device=dev)
        tbl = tbl.to(torch.bfloat16)
        qs = torch.randn(B, d_pad, generator=g, device=dev).to(torch.bfloat16)
        bias = torch.zeros(n_total, device=dev)
        bias[n_total - dead:] = fs.NEG_FILL
        out_k = fs.fused_sweep(qs, tbl, bias)
        out_p = fs.fused_sweep_plain(qs, tbl, bias)
        torch.cuda.synchronize()
        close, same, dead_hits, err = compare_fused(out_k, out_p, n_total, dead)
        say(f"phase 2 fused_sweep vs plain B={B} n_total={n_total} "
            f"d_pad={d_pad} dead={dead}: isclose(1e-6) {close:.6f} "
            f"ids {same:.6f} dead_hits {dead_hits} max_abs_err {err:.3e}")
        if not (close >= 0.99 and same >= 0.999 and dead_hits == 0):
            raise SystemExit("phase 2 failed: kernel disagrees with plain")


def recall(ids, gt):
    return float(np.mean([
        len(set(ids[b].tolist()) & set(gt[b].tolist())) / K
        for b in range(len(gt))
    ]))


def phase_main(n, reps):
    """Build and serve through the entry points; returns what phase 4
    needs (index, queries, launch counts)."""
    import torch

    from cozo_tpu_torch import HnswIndex, sweep_search
    from cozo_tpu_torch.ops import fused_sweep as fs
    from cozo_tpu_torch.utils.datasets import glove_like

    t0 = time.time()
    data = glove_like(n + NQ, D, seed=42)
    qs, data = data[n:], data[:n]
    say(f"phase 3 datagen {n} + {NQ} x {D} in {time.time() - t0:.1f}s")

    fs.fused_sweep.launches = 0  # counts of the main path's run only
    t0 = time.time()
    index = HnswIndex(dim=D, m=16, ef_construction=200, distance="Cosine")
    index.bulk_build(data, wave=8192)
    torch.cuda.synchronize()
    build_s = time.time() - t0
    say(f"phase 3 build: {n} vectors in {build_s:.1f}s "
        f"({n / build_s:.0f} vectors/s)")

    t0 = time.time()
    gt, gt_d = sweep_search(index, qs, K, rt=1.0, compute_dtype="f32",
                            exact_rerank=False)
    say(f"phase 3 f32 ground truth in {time.time() - t0:.2f}s")
    if gt.shape != (NQ, K) or not np.isfinite(gt_d).all() or (gt < 0).any():
        raise SystemExit("phase 3 failed: f32 lane returned bad rows")

    lanes = {}
    for tag, cd, rt, rerank in (("fused+rerank", "fused", 1.0, True),
                                ("bf16+rerank", "bf16", 0.98, True),
                                ("bf16-raw", "bf16", 0.99, False)):
        sweep_search(index, qs, K, rt=rt, compute_dtype=cd,
                     exact_rerank=rerank)  # warm
        per_rep = []
        for _ in range(reps):
            t0 = time.time()
            ids, dists = sweep_search(index, qs, K, rt=rt, compute_dtype=cd,
                                      exact_rerank=rerank)
            per_rep.append(NQ / (time.time() - t0))
        r = recall(ids, gt)
        ok = (ids.shape == (NQ, K) and np.isfinite(dists[ids >= 0]).all()
              and r >= BARS[tag])
        lanes[tag] = {"qps_median": float(np.median(per_rep)),
                      "qps_min": float(min(per_rep)), "per_rep_qps": per_rep,
                      "recall@10": r}
        say(f"phase 3 lane {tag}: median {np.median(per_rep):.1f} QPS "
            f"min {min(per_rep):.1f} recall@10 {r:.4f} "
            f"(bar {BARS[tag]}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"phase 3 failed: lane {tag}")
    launches = {"fused_sweep": fs.fused_sweep.launches}
    say(f"phase 3 kernel launches on the main path: {launches}")
    if launches["fused_sweep"] < 1:
        raise SystemExit("phase 3 failed: fused_sweep never launched")
    say("phase 3 summary " + json.dumps(
        {"n": n, "nq": NQ, "build_s": build_s, "lanes": lanes}))
    return index, qs, launches


def phase_kernel_timing(index, qs, launches, reps):
    import torch

    from cozo_tpu_torch.ops import fused_sweep as fs

    st = index._sweep_table
    tbl, bias = st.tbl_fused, st.bias_fused
    q = qs / np.linalg.norm(qs, axis=1, keepdims=True)
    qb = torch.zeros((NQ, st.d_pad), dtype=torch.float32, device=tbl.device)
    qb[:, :D] = torch.from_numpy(q.astype(np.float16)).to(tbl.device).float()
    qb = qb.to(torch.bfloat16)
    B, d_pad = qb.shape
    n_total = tbl.shape[0]
    out_w = 2 * (n_total // fs.SEG)

    out_k = fs.fused_sweep(qb, tbl, bias)
    out_p = fs.fused_sweep_plain(qb, tbl, bias)
    close, same, _, err = compare_fused(out_k, out_p, n_total, 0)
    del out_k, out_p
    say(f"phase 4 fused_sweep vs plain at the main-path shape B={B} "
        f"n_total={n_total} d_pad={d_pad}: isclose(1e-6) {close:.6f} "
        f"ids {same:.6f} max_abs_err {err:.3e}")
    if not (close >= 0.99 and same >= 0.999):
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
    say(f"phase 4 fused_sweep: {ms:.3f} ms ({flops / ms / 1e9:.1f} TFLOP/s), "
        f"bound {max(t_ops, t_bytes):.3f} ms, plain {plain_ms:.3f} ms, "
        f"torch.mm bf16 {library_ms:.3f} ms")
    return [{
        "name": "fused_sweep", "route": "cuda",
        "source": "cozo_tpu_torch/csrc/fused_sweep.cu",
        "replaces": "cozo_tpu/ops/pallas_sweep.py:126",
        "launches": launches["fused_sweep"],
        "max_abs_err": err, "max_err": err,
        "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": library_ms,
    }]


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=N,
                    help=f"table rows on the main path (>= {MIN_N})")
    ap.add_argument("--reps", type=int, default=5)
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
    phase_kernel_vs_plain(dev)
    index, qs, launches = phase_main(args.n, args.reps)
    kernels = phase_kernel_timing(index, qs, launches, args.reps)
    say(f"total {time.time() - t_all:.1f}s")
    say(json.dumps({"kernels": kernels}))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    say(smi.stdout.strip().splitlines()[0])
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
