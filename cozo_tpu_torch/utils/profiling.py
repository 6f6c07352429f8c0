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
# (kineto over CUPTI) drops device records whose timestamps fall before a
# session's window, from its start, in order.  CUPTI stays up between
# sessions (torch's default) and its device timestamps drift from the
# window's clock: the drop grows by about one kernel every 13 s after the
# process's first session, whatever the process did meanwhile
# (`chip_trace_witness.py --drift`: 17-21 at 280-310 s).  Tearing CUPTI
# down after each session (TEARDOWN_CUPTI=1) stops the drift, but a
# session started right after a torn-down one records no kernel at all
# (`--graph`), and set for its own session only, it left the first
# session of a process holding a CUDA graph with none: the port leaves
# CUPTI up.  Apart from the drift, a session now and then
# loses a run of its first records at once: at most 213 of the primer's
# 257 kernels in the witness's sessions (others 42, 73, 97, 155 and 185),
# or every record.  256 adds take the drift of the first 55 minutes of
# profiling (256 x 13 s) or such a run in the place of the code's; past
# them `device_trace` refuses the trace.
PRIMER_LAUNCHES = 256
PRIMER_SPAN = "device_trace primer"
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def primer_kernels(events) -> int:
    """How many of the primer's kernels a Chrome trace of `device_trace`
    holds: kernels whose launch (a CUDA runtime or driver event, matched by
    its correlation id) lies inside the primer's span on its thread."""
    spans = [(e["pid"], e["tid"], e["ts"], e["ts"] + e.get("dur", 0))
             for e in events if e.get("name") == PRIMER_SPAN
             and e.get("cat") == "user_annotation"]
    launched = {e["args"]["correlation"] for e in events
                if e.get("cat") in LAUNCH_CATS
                and "correlation" in e.get("args", {})
                and any(e["pid"] == p and e["tid"] == t and t0 <= e["ts"] <= t1
                        for p, t, t0, t1 in spans)}
    return sum(e.get("cat") == "kernel"
               and e.get("args", {}).get("correlation") in launched
               for e in events)


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Record what the code inside runs, on the host and, where a card is
    present, on the card, and write it on exit as a Chrome trace
    (`chrome://tracing`, Perfetto) `trace-<pid>-<ns>.json` in `log_dir`.
    It chooses no device: it records wherever the code inside runs.
    Where the process has used the card, the session first launches
    PRIMER_LAUNCHES one-element adds on it, under the span PRIMER_SPAN,
    and waits for them.  The profiler drops a session's first device
    records in order, so a trace that still holds one of the primer's
    kernels holds every kernel of the code inside; one that holds none may
    have lost the code's first kernels (or, holding no kernel at all, saw
    nothing of the card).  Such a trace is written, and `device_trace`
    then raises RuntimeError naming it and the primer's kernels it kept,
    where the code inside raised nothing."""
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
            with record_function(PRIMER_SPAN):
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
        kernels = sum(e.get("cat") == "kernel" for e in events)
        if not kernels:
            raise RuntimeError(f"device_trace: the profiler recorded no "
                               f"kernel of the card, not even the primer's: "
                               f"{path} has the host's side only")
        if not primer_kernels(events):
            raise RuntimeError(
                f"device_trace: {path} holds 0 of the primer's "
                f"{PRIMER_LAUNCHES + 1} kernels ({kernels} kernels in all): "
                f"the profiler dropped the session's first device records "
                f"past the primer, so the code's first kernels may be "
                f"missing from it")


@contextlib.contextmanager
def timed(label: str, sink=print):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        sink(f"{label}: {(time.perf_counter() - t0) * 1000:.2f}ms")
