#!/usr/bin/env python3
"""Where the time goes on the port's main path, on one card.

    python3 chip_profile.py            # full size: 1,183,514 x 100 cosine

Builds the index as `chip_smoke.py` does, with the build's per-wave phase
log on (`COZO_TPU_BUILD_LOG=1`: dispatch, wait for the device result,
host links, host upper levels), then serves one 16,384-query batch per
lane under `torch.profiler` and prints, per lane, the wall time, the
summed device time of its kernels and copies, and the top kernels by
device time.  Then it names the fused lane's host time: the steps of
`SweepTable.search` re-enacted one by one on the same batch, with the
device drained after each, and each step's share of their sum (the query
preparation runs on the device; the numpy form it replaced is timed
beside it).  Last, the small-batch path: one `HnswIndex.search` through
the beam-search kernel under the profiler, then the steps of
`hnsw_search_device` re-enacted one by one in the same way (staging copy,
launch, wait, unpack) at B = 1, 4, 16, 63.

`--db` profiles the Db instead (`chip_smoke.py` phase 5's scripts):
`Db("mem")` on the card, ingest and `::hnsw create` of `--n` rows, then
the 4,096-query pivot join, the small join (B = 16) and the 2-hop, each
warm, under `cProfile`: the host functions that take the time, beside
the serving call's own time.  The evaluator's share does not depend on
the table's size (4,096 queries, 40,960 rows), so `--n 262144` will do.
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
    from cozo_tpu_torch.utils.device import prepare_queries, to_device

    st = index._sweep_table
    d, n = index.dim, index.n
    names = ("pinned f32 upload (pin_memory + copy)",
             "device: query preparation (normalise, f16 round, pad)",
             "device: kernel, top-k, decode, re-rank",
             "download (.cpu().numpy())", "unpack ids / distances (numpy)",
             "[replaced, not in the lane] numpy normalise + f16 cast")
    rounds = []
    for _ in range(reps + 1):
        t = [time.perf_counter()]

        def lap():
            torch.cuda.synchronize()
            t.append(time.perf_counter())

        q = np.asarray(qs, dtype=np.float32)
        q_dev = to_device(np.ascontiguousarray(q), st.device)
        lap()
        prepared = prepare_queries(q_dev, index.distance, st.d_pad, half=True)
        lap()
        packed_d = fs.serve(st.tbl_fused, st.bias_fused, st.tbl, prepared, K,
                            K + 16, index.distance, 0, st.d_pad)
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
        qp = np.empty((q.shape[0], d), dtype=np.float16)
        nrm = np.linalg.norm(q, axis=1, keepdims=True)
        qp[:] = q / np.where(nrm > 0, nrm, 1.0)
        lap()
        rounds.append(np.diff(t) * 1e3)
    med = np.median(np.array(rounds[1:]), axis=0)
    total = med[:-1].sum()  # the last entry is not a step of the lane
    print(f"fused lane, steps of one {len(qs)}-query batch (median of "
          f"{reps}, device drained after each): sum {total:.2f} ms",
          flush=True)
    for name, ms in zip(names, med):
        print(f"  {ms:8.2f} ms {100 * ms / total:5.1f}%  {name}",
              flush=True)
    return ids, dists


def beam_call_steps(index, qs, B, reps=20):
    """The steps of `hnsw_search_device` on one batch of B queries, each
    timed by itself (the launch up to the return of the enqueue, the
    kernel as the wait for the stream after it; the device is idle before
    each): median milliseconds over `reps` rounds after a warm one, beside
    the whole `HnswIndex.search` call.  Nothing of the call is changed;
    this follows it line by line."""
    import torch

    from cozo_tpu_torch.ops import vector_search as vs

    q = np.asarray(qs[:B], dtype=index.dtype)
    index.search(q, K, 64, use_tpu=True)  # the mirror and the staging buffers
    names = ("mirror, parameters and their checks, staging lookup, stream "
             "(host)",
             "staging copy (numpy -> pinned)",
             "launch: enqueue (host only, not drained)",
             "the kernel, reading and writing the pinned buffers (stream "
             "synchronize)",
             "unpack ids / distances (numpy)")
    rounds, calls = [], []
    for _ in range(reps + 1):
        torch.cuda.synchronize()
        t = [time.perf_counter()]

        def lap(drain=True):
            if drain:
                torch.cuda.synchronize()
            t.append(time.perf_counter())

        dev = vs._device_arrays(index)
        beam, max_iters, expand = vs.beam_params(K, 64, None)
        device = dev["vectors"].device
        vs._check_params(K, beam, dev["n_levels"], expand)
        vs._check_layout(index.dim, dev["nb0"].shape[1], dev["m_up"], beam,
                         expand)
        st = vs._staging(dev, B, index.dim, K)
        stream = torch.cuda.current_stream(device)
        lap()
        np.copyto(st["q_np"], q, casting="same_kind")
        lap()
        vs._launch(dev["vectors"], dev["nb0"], dev["up_nb"], dev["alive"],
                   dev["entry"], st["q_host"], st["out_host"], K, beam,
                   dev["n_levels"], vs.DIST_KINDS[index.distance], max_iters,
                   expand, stream.cuda_stream)
        lap(drain=False)
        stream.synchronize()
        lap(drain=False)
        packed = st["out_np"]
        ids = packed[:, :K].astype(np.int64)
        dists = packed[:, K:].view(np.float32).astype(np.float64)
        lap()
        rounds.append(np.diff(t) * 1e3)
        t0 = time.perf_counter()
        index.search(q, K, 64, use_tpu=True)
        calls.append((time.perf_counter() - t0) * 1e3)
    med = np.median(np.array(rounds[1:]), axis=0)
    call = float(np.median(calls[1:]))
    print(f"beam search B={B}, steps of one call (median of {reps}): sum "
          f"{med.sum():.4f} ms; HnswIndex.search "
          f"itself {call:.4f} ms median, {min(calls[1:]):.4f} ms min",
          flush=True)
    for name, ms in zip(names, med):
        print(f"  {ms:8.4f} ms {100 * ms / med.sum():5.1f}%  {name}", flush=True)
    return ids, dists


def beam_recall_curve(index, qs, nq=252):
    """recall@10 of the graph search against the exact f32 lane on `nq`
    queries, the host search (`use_tpu=False`) beside the beam-search
    kernel (batches of 63 through `HnswIndex.search`), over ef; and the
    kernel again with the iteration cap lifted, which shows what the cap
    of ceil(beam / expand) + 8 rounds costs."""
    import torch

    from cozo_tpu_torch import sweep_search
    from cozo_tpu_torch.ops import vector_search as vs

    def rec(ids, gt):
        return float(np.mean([len(set(ids[b].tolist()) & set(gt[b].tolist()))
                              / K for b in range(len(gt))]))

    q = qs[:nq]
    gt, _ = sweep_search(index, q, K, rt=1.0, compute_dtype="f32",
                         exact_rerank=False)
    dev = vs._device_arrays(index)
    for ef in (64, 128, 256, 512):
        t0 = time.perf_counter()
        ids_h, _ = index.search(q, K, ef, use_tpu=False)
        host_ms = (time.perf_counter() - t0) * 1e3 / nq
        t0 = time.perf_counter()
        ids_d = np.concatenate([index.search(q[b:b + 63], K, ef)[0]
                                for b in range(0, nq, 63)])
        dev_ms = (time.perf_counter() - t0) * 1e3 / -(-nq // 63)
        rounds = vs.beam_search.last_stats[:, 1].float().mean().item()
        beam = vs.beam_params(K, ef)[0]
        q_dev = torch.from_numpy(np.ascontiguousarray(q, dtype=np.float32)).to(
            dev["vectors"].device)
        ids_u = np.concatenate([
            vs.beam_search(dev["vectors"], dev["nb0"], dev["up_nb"],
                           dev["alive"], dev["entry"], q_dev[b:b + 63], K,
                           beam, dev["n_levels"],
                           vs.DIST_KINDS[index.distance], 100_000, 8)[0]
            .cpu().numpy() for b in range(0, nq, 63)])
        rounds_u = vs.beam_search.last_stats[:, 1].float().mean().item()
        print(f"graph search ef={ef}, {nq} queries: host recall@10 "
              f"{rec(ids_h, gt):.4f} ({host_ms:.2f} ms per query); kernel "
              f"{rec(ids_d, gt):.4f} ({dev_ms:.3f} ms per 63-query call, "
              f"{rounds:.1f} rounds per query in the last batch); kernel "
              f"without the iteration cap {rec(ids_u, gt):.4f} "
              f"({rounds_u:.1f} rounds)", flush=True)


def db_profile(data, qs):
    """`--db`: the phase 5 scripts under cProfile."""
    import cProfile
    import pstats

    import torch

    from chip_smoke import (DB_NQ, DB_SMALL, JOIN, TWO_HOP, build_db,
                            store_queries)

    db, took = build_db(data)
    print(f"db ingest {len(data)} rows: {took['ingest_s']:.1f}s, ::hnsw "
          f"create {took['ddl_s']:.1f}s (bulk_build {took['bulk_build_s']:.1f}"
          f"s)", flush=True)
    store_queries(db, "q", qs[:DB_NQ])
    store_queries(db, "q16", qs[DB_NQ:DB_NQ + DB_SMALL])
    index = db.algo_cache["hnsw::item::ix"].index
    cases = (("pivot join B=4096", JOIN.format(rel="q"), None, 3,
              lambda: index.search(qs[:DB_NQ], K, 64)),
             ("small join B=16", JOIN.format(rel="q16"), None, 20,
              lambda: index.search(qs[DB_NQ:DB_NQ + DB_SMALL], K, 64)),
             ("2-hop", TWO_HOP, {"q": qs[0]}, 20, None))
    for tag, script, params, reps, search in cases:
        db.run_script(script, params)  # warm: tables and mirror go up
        torch.cuda.synchronize()
        walls = []
        for _ in range(reps):
            t0 = time.perf_counter()
            db.run_script(script, params)
            walls.append((time.perf_counter() - t0) * 1e3)
        line = f"db {tag}: median {np.median(walls):.3f} ms of {reps}"
        if search is not None:
            lane = []
            for _ in range(reps):
                t0 = time.perf_counter()
                search()
                lane.append((time.perf_counter() - t0) * 1e3)
            line += (f"; HnswIndex.search on its queries alone "
                     f"{np.median(lane):.3f} ms "
                     f"({100 * np.median(lane) / np.median(walls):.1f}%)")
        print(line, flush=True)
        prof = cProfile.Profile()
        prof.enable()
        for _ in range(reps):
            db.run_script(script, params)
        prof.disable()
        st = pstats.Stats(prof)
        total = st.total_tt / reps * 1e3
        print(f"  under cProfile: {total:.3f} ms a run; the functions by "
              f"their own time (ms a run, calls a run):", flush=True)
        rows = sorted(st.stats.items(), key=lambda kv: -kv[1][2])[:12]
        for (fname, line_no, func), (_, nc, tt, ct, _) in rows:
            where = f"{os.path.relpath(fname)}:{line_no}" \
                if fname.startswith("/") else fname
            print(f"  {tt / reps * 1e3:9.3f} own {ct / reps * 1e3:9.3f} cum "
                  f"x{nc // reps:<7d} {func} ({where})", flush=True)
    subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                    "--format=csv,noheader"], check=False)
    return 0


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=N)
    ap.add_argument("--beam-only", action="store_true",
                    help="after the build, only the small-batch path: the "
                         "steps of a call and the graph-search recall curve "
                         "(host search beside the kernel)")
    ap.add_argument("--db", action="store_true",
                    help="profile the Db's scripts (chip_smoke.py phase 5) "
                         "on an index of --n rows built through the Db")
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
    if args.db:
        return db_profile(data, qs)
    t0 = time.time()
    index = HnswIndex(dim=D, m=16, ef_construction=200, distance="Cosine")
    index.bulk_build(data, wave=8192)
    torch.cuda.synchronize()
    print(f"build {args.n} rows: {time.time() - t0:.1f}s", flush=True)

    if args.beam_only:
        for B in (1, 4, 16, 63):
            beam_call_steps(index, qs, B)
        beam_recall_curve(index, qs)
        return 0

    for tag, cd, rerank, rk in (("fused+rerank", "fused", True, None),
                                ("bf16+rerank", "bf16", True, None),
                                ("bf16-raw", "bf16", False, None),
                                ("i8+rerank", "i8", True, 64),
                                ("f32", "f32", False, None)):
        sweep_search(index, qs, K, compute_dtype=cd, exact_rerank=rerank,
                     rerank_k=rk)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.time()
            sweep_search(index, qs, K, compute_dtype=cd, exact_rerank=rerank,
                         rerank_k=rk)
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
    # one small batch through the dispatcher: the beam-search kernel
    index.search(qs[:16], K, 64)  # uploads the mirror
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        index.search(qs[:16], K, 64)
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    dev_ms = sum(e.self_device_time_total for e in events) / 1e3
    print(f"HnswIndex.search B=16 (beam search): wall {wall_ms:.3f} ms under "
          f"the profiler, device busy {dev_ms:.3f} ms", flush=True)
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:5]:
        print(f"  {e.self_device_time_total / 1e3:9.4f} ms x{e.count:<4d} "
              f"{e.key[:90]}", flush=True)
    walls = []
    for _ in range(20):
        t0 = time.perf_counter()
        index.search(qs[:16], K, 64)
        walls.append((time.perf_counter() - t0) * 1e3)
    print(f"HnswIndex.search B=16 without the profiler: median "
          f"{np.median(walls):.3f} ms, min {min(walls):.3f} ms", flush=True)
    for B in (1, 4, 16, 63):
        beam_call_steps(index, qs, B)
    beam_recall_curve(index, qs)
    subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                    "--format=csv,noheader"], check=False)
    return 0


if __name__ == "__main__":
    sys.exit(main())
