#!/usr/bin/env python3
"""Where the time goes on the port's main path, on one card.

    python3 chip_profile.py            # full size: 1,183,514 x 100 cosine

Builds the index as `chip_smoke.py` does, with the build's per-wave phase
log on (`COZO_TPU_BUILD_LOG=1`: dispatch, wait for the device result,
host links, host upper levels), then serves one 16,384-query batch per
lane under `torch.profiler` and prints, per lane, the wall time, the
summed device time of its kernels and copies, and the top kernels by
device time.  Last it names the fused lane's host time: the steps of
`SweepTable.search` re-enacted one by one on the same batch, with the
device drained after each, and each step's share of their sum.
Needs CUDA; it measures, it checks nothing (chip_smoke.py checks).
"""

import argparse
import os
import subprocess
import sys
import time

import numpy as np

N, D, NQ, K = 1_183_514, 100, 16_384, 10


def fused_lane_steps(index, qs, reps=5):
    """The steps of `SweepTable.search(compute_dtype="fused")` on one
    batch, each ended by a `torch.cuda.synchronize()` so that its time is
    its own: median milliseconds over `reps` rounds after a warm one.
    Nothing of `search` is changed; this follows it line by line."""
    import torch

    from cozo_tpu_torch.ops import fused_sweep as fs
    from cozo_tpu_torch.utils.device import to_device

    st = index._sweep_table
    d, n = index.dim, index.n
    names = ("query normalise + f16 cast (numpy)",
             "pinned upload (pin_memory + copy)",
             "device: kernel, top-k, decode, re-rank",
             "download (.cpu().numpy())", "unpack ids / distances (numpy)")
    rounds = []
    for _ in range(reps + 1):
        t = [time.perf_counter()]

        def lap():
            torch.cuda.synchronize()
            t.append(time.perf_counter())

        q = np.asarray(qs, dtype=np.float32)
        qp = np.empty((q.shape[0], d), dtype=np.float16)
        nrm = np.linalg.norm(q, axis=1, keepdims=True)
        qp[:] = q / np.where(nrm > 0, nrm, 1.0)
        lap()
        q_dev = to_device(qp, st.device)
        lap()
        packed_d = fs.serve(st.tbl_fused, st.bias_fused, st.tbl, q_dev, K,
                            K + 16, index.distance, d, st.d_pad)
        lap()
        packed = packed_d.cpu().numpy()
        lap()
        kk = packed.shape[1] // 2
        ids = packed[:, :kk].astype(np.int64)
        scores = np.ascontiguousarray(packed[:, kk:]).view(
            np.float32).astype(np.float64)
        bad = ~np.isfinite(scores) | (ids < 0) | (ids >= n)
        ids = np.where(bad, -1, ids)
        dists = np.where(bad, np.inf, 1.0 - scores)
        lap()
        rounds.append(np.diff(t) * 1e3)
    med = np.median(np.array(rounds[1:]), axis=0)
    print(f"fused lane, steps of one {len(qs)}-query batch (median of "
          f"{reps}, device drained after each): sum {med.sum():.2f} ms",
          flush=True)
    for name, ms in zip(names, med):
        print(f"  {ms:8.2f} ms {100 * ms / med.sum():5.1f}%  {name}",
              flush=True)
    return ids, dists


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=N)
    args = ap.parse_args()

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("chip_profile: CUDA is not available", file=sys.stderr)
        return 1
    os.environ["COZO_TPU_BUILD_LOG"] = "1"
    from cozo_tpu_torch import HnswIndex, sweep_search
    from cozo_tpu_torch.utils.datasets import glove_like

    print(f"device: {torch.cuda.get_device_name(0)}", flush=True)
    data = glove_like(args.n + NQ, D, seed=42)
    qs, data = data[args.n:], data[:args.n]
    t0 = time.time()
    index = HnswIndex(dim=D, m=16, ef_construction=200, distance="Cosine")
    index.bulk_build(data, wave=8192)
    torch.cuda.synchronize()
    print(f"build {args.n} rows: {time.time() - t0:.1f}s", flush=True)

    for tag, cd, rerank in (("fused+rerank", "fused", True),
                            ("bf16+rerank", "bf16", True),
                            ("bf16-raw", "bf16", False),
                            ("f32", "f32", False)):
        sweep_search(index, qs, K, compute_dtype=cd, exact_rerank=rerank)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.time()
            sweep_search(index, qs, K, compute_dtype=cd, exact_rerank=rerank)
            wall_ms = (time.time() - t0) * 1e3
        # device-side events only (kernels, copies): the host ops that
        # launched them report the same device time again
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA]
        dev_ms = sum(e.self_device_time_total for e in events) / 1e3
        print(f"lane {tag}: wall {wall_ms:.1f} ms, device busy "
              f"{dev_ms:.1f} ms ({100 * dev_ms / wall_ms:.0f}%)", flush=True)
        top = sorted(events, key=lambda e: -e.self_device_time_total)[:8]
        for e in top:
            print(f"  {e.self_device_time_total / 1e3:9.2f} ms "
                  f"x{e.count:<4d} {e.key[:90]}", flush=True)

    fused_lane_steps(index, qs)
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        sweep_search(index, qs, K, compute_dtype="fused")
        walls.append((time.perf_counter() - t0) * 1e3)
    print(f"fused lane, `sweep_search` itself on that batch: median "
          f"{np.median(walls):.2f} ms, min {min(walls):.2f} ms", flush=True)
    subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                    "--format=csv,noheader"], check=False)
    return 0


if __name__ == "__main__":
    sys.exit(main())
