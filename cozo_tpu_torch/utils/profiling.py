"""Profiling hooks (counterpart of `cozo_tpu/utils/profiling.py`; SURVEY
§5.1: the reference exposes only ::explain and `took`; the rebuild adds
device traces).  The JAX package's `device_trace` is a JAX profiler trace;
this one is a `torch.profiler` session that writes a Chrome trace."""

from __future__ import annotations

import contextlib
import json
import os
import time

# Kernels a session launches before the code inside.  The profiler
# (kineto over CUPTI) drops the first device records of a session as out
# of its window, more of them the older the process: none in its first
# half minute, then about one more every 15 s (11 at 209 s), whether the
# card idles or works between sessions and however long the session
# waits before its first launch (`chip_trace_witness.py --drift`).  These
# take that drop in the place of the code's, for processes up to about
# an hour old at that rate.
PRIMER_LAUNCHES = 256


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Record what the code inside runs, on the host and, where a card is
    present, on the card, and write it on exit as a Chrome trace
    (`chrome://tracing`, Perfetto) `trace-<pid>-<ns>.json` in `log_dir`.
    It chooses no device: it records wherever the code inside runs.
    Where the process has used the card, the session first launches
    PRIMER_LAUNCHES one-element adds on it, under the span `device_trace
    primer`, and waits for them; a trace that then holds no kernel at all
    has seen nothing of the card (the profiler lost the session's device
    records) and is written, but `device_trace` raises RuntimeError
    naming it where the code inside raised nothing."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"trace-{os.getpid()}-{time.time_ns()}.json")
    primed = torch.cuda.is_initialized()
    prof = profile(activities=activities)
    prof.start()
    try:
        if primed:
            with record_function("device_trace primer"):
                one = torch.zeros(1, device="cuda")
                for _ in range(PRIMER_LAUNCHES):
                    one.add_(1)
                torch.cuda.synchronize()
        yield
    finally:
        prof.stop()
        prof.export_chrome_trace(path)
    if primed:
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        if not any(e.get("cat") == "kernel" for e in events):
            raise RuntimeError(f"device_trace: the profiler recorded no "
                               f"kernel of the card, not even the primer's: "
                               f"{path} has the host's side only")


@contextlib.contextmanager
def timed(label: str, sink=print):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        sink(f"{label}: {(time.perf_counter() - t0) * 1000:.2f}ms")
