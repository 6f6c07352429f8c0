#!/usr/bin/env python3
"""Where the time goes on the port's main path, on one card.

    python3 chip_profile.py            # full size: 1,183,514 x 100 cosine

Builds the index as `chip_smoke.py` does, with the build's per-wave phase
log on (`COZO_TPU_BUILD_LOG=1`: dispatch, wait for the device result,
host links, host upper levels), then serves one 16,384-query batch per
lane under `torch.profiler` and prints, per lane, the wall time, the
summed device time of its kernels and copies, and the top kernels by
device time.
Needs CUDA; it measures, it checks nothing (chip_smoke.py checks).
"""

import argparse
import os
import sys
import time

import numpy as np

N, D, NQ, K = 1_183_514, 100, 16_384, 10


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
    return 0


if __name__ == "__main__":
    sys.exit(main())
