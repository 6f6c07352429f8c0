"""Profiling hooks (counterpart of `cozo_tpu/utils/profiling.py`; SURVEY
§5.1: the reference exposes only ::explain and `took`; the rebuild adds
device traces).  The JAX package's `device_trace` is a JAX profiler trace;
this one is a `torch.profiler` session that writes a Chrome trace."""

from __future__ import annotations

import contextlib
import os
import time


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Record what the code inside runs, on the host and, where a card is
    present, on the card, and write it on exit as a Chrome trace
    (`chrome://tracing`, Perfetto) `trace-<pid>-<ns>.json` in `log_dir`.
    It chooses no device: it records wherever the code inside runs."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(
            log_dir, f"trace-{os.getpid()}-{time.time_ns()}.json"))


@contextlib.contextmanager
def timed(label: str, sink=print):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        sink(f"{label}: {(time.perf_counter() - t0) * 1000:.2f}ms")
