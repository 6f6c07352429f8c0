#!/usr/bin/env python3
"""What `torch.profiler` records of the card, two witnesses, one card.

    python3 chip_trace_witness.py [--load N] [--rounds R] [--case NAME]
    python3 chip_trace_witness.py --drift 200 [--idle] [--prime session]
                                  [--raw] [--launches N] [--late S]
                                  [--late-cuda] [--open schedule]
    python3 chip_trace_witness.py --spike 16 --sessions 20
    python3 chip_trace_witness.py --graph --sessions 3 [--no-graph]
    python3 chip_trace_witness.py --device cpu ...  # a rehearsal: no kernels

The first: does the profiler still see the card after an HTTP server's
client threads?  Each case runs in a process of its own (the profiler's
and CUPTI's state belong to a process), made of the factors it names, in
this order:

  earlier     a CUDA-only `torch.profiler` session around a few launches,
              then one session as `raw_trace` runs it (as `chip_smoke.py`
              phase 6 and phase 11 (d) run before the server);
  server      a bare `ThreadingHTTPServer` (socketserver's backlog of 5)
              whose POST handler launches a small CUDA op; 8 client
              threads x 20 requests, a new connection each (urllib);
  port        instead of `server`: `cozo_tpu_torch.hosts.server.serve` on
              a `Db("mem")` on the card, the requests a PageRank over
              60,000 stored edges (the `graph_pagerank` kernel);
  sse         an SSE stream opened, one event carried, the client gone:
              the server's handler left waiting in `queue.get(timeout=30)`
              with its callback registered (the bare server's handler is
              the port's `_sse_changes` loop, shortened);
  unfinished  8 requests whose handlers still run CUDA ops for ~3 s when
              `shutdown()` and `server_close()` return;
  load        --load processes of the witness's own that spin on the CPU
              for the whole case (default: twice the CPU count);

then, after the server is shut down, three `raw_trace` sessions in a row
around `torch.ones(2**20).sum()` on the card.  Each case prints one line:
the events of each trace by category, its kernels, the threads alive at
the first trace, the requests' p50 / p99 ms and the listen queue's
overflows and drops (`/proc/net/netstat`, read only, where the kernel
counts them), and the profiler's own warnings from the case's standard
error.  A case whose traces name no kernel is "blind".

The second, `--drift SECONDS`: what a session records as the process
ages.  One process keeps the card busy with small ATen ops between
sessions (`--idle`: sleeps) and runs a session every DRIFT_EVERY seconds
(`--every`)
around a fill and a sum (`--launches N`: N more fills and sums first),
alternately at once and after DRIFT_PAD seconds of sleep inside the
session, each after an empty session where `--prime session`, through
`device_trace` or (`--raw`) `raw_trace` (TEARDOWN_CUPTI=1 in the
environment has kineto tear CUPTI down after each), or
(`--open schedule`) a session
opened by a `torch.profiler.schedule` whose warm-up step starts CUPTI
before the active step opens the window and the primer runs; with
`--late S` the process sleeps S seconds after its first launch before its
first session (`--late-cuda`: before its first launch too, CUDA not yet
initialised).  One line a session: the process's age, the kernels
recorded (by name; of the body's fills and sums, those recorded and those
launched; the others: `device_trace`'s primer), the primer's kernels
found by their launches' correlation ids (`profiling.primer_kernels`) and
whether `device_trace` refused the trace, how many of the primer's
launches lost their kernel and whether those were its first, where the
window opens and the first kept kernel's launch and start fall from it,
its CUDA runtime events, the sum kernel's start less its `aten::sum`
op's start, how far CLOCK_REALTIME has moved from CLOCK_MONOTONIC and
CLOCK_MONOTONIC_RAW since the process started, and the host us of a
launch after the session (a first line: before any session, and kineto's
TEARDOWN_CUPTI setting from the environment).

The third, `--spike N --sessions S [--late S]`: S sessions of
`device_trace`, each right after N spinning processes of the witness's own
ran for SPIKE_S seconds and stopped; one line a session: its kernels, the
primer's kept, and whether `device_trace` refused it.

The fourth, `--graph --sessions S [--no-graph]`: S rounds of a
`device_trace` session and a raw one, each replaying a CUDA graph the
process captured first (`--no-graph`: none); one line a session: its
kernels, the primer's kept, whether `device_trace` refused it, and
kineto's TEARDOWN_CUPTI setting from the environment.

It measures; it gates nothing: exit 0 once every case ran, 1 without
CUDA.
"""

import argparse
import contextlib
import json
import os
import queue
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from chip_smoke import listen_counters

CASES = {
    "control": ("earlier",),
    "server": ("earlier", "server"),
    "server+sse": ("earlier", "server", "sse"),
    "server+unfinished": ("earlier", "server", "unfinished"),
    "server, no earlier session": ("server",),
    "load": ("earlier", "load"),
    "server+load": ("earlier", "server", "load"),
    "server+sse+unfinished+load": ("earlier", "server", "sse", "unfinished",
                                   "load"),
    "port+sse+load": ("earlier", "port", "sse", "load"),
}
DRIFT_EVERY, DRIFT_PAD = 10.0, 0.5
SPIKE_S = 3.0
CLIENTS, REQUESTS = 8, 20
PR_NODES, PR_EDGES = 5_000, 60_000  # edges past the device threshold, 50,000
DEVICE = "cuda"  # --device cpu rehearses the flow here (no kernels to see)


@contextlib.contextmanager
def raw_trace(log_dir):
    """A `torch.profiler` session alone, as `device_trace` ran one before
    its primer: start, the code inside, stop, the Chrome trace."""
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, "raw.json"))


@contextlib.contextmanager
def schedule_trace(log_dir):
    """`device_trace`'s session opened by a schedule instead: a warm-up
    step (CUPTI started, nothing kept), then the active step, whose window
    the primer and the code inside fall in; the same primer, the same
    Chrome trace."""
    import torch
    from torch.profiler import (ProfilerActivity, profile, record_function,
                                schedule)

    from cozo_tpu_torch.utils.profiling import PRIMER_LAUNCHES, PRIMER_SPAN

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                   schedule=schedule(wait=0, warmup=1, active=1),
                   on_trace_ready=lambda p: p.export_chrome_trace(
                       os.path.join(log_dir, "schedule.json")))
    prof.start()
    try:
        torch.cuda.synchronize()
        prof.step()  # the warm-up step ends: the window opens
        with record_function(PRIMER_SPAN):
            one = torch.zeros(1, device="cuda")
            for _ in range(PRIMER_LAUNCHES):
                one.add_(1)
            torch.cuda.synchronize()
        yield
    finally:
        prof.step()  # the active step ends: the trace is ready
        prof.stop()


def trace(body, keep=False, raw=False, opened="start"):
    """One `device_trace` session (`raw`: `raw_trace`; `opened` "schedule":
    `schedule_trace`) around `body()`: events by category and the kernels'
    names (and the events themselves with `keep`); `refused`, the
    RuntimeError `device_trace` raised on the trace it wrote, if any."""
    import torch

    from cozo_tpu_torch.utils.profiling import device_trace

    tmp = tempfile.mkdtemp(prefix="cozo_witness_")
    refused = None
    try:
        session = (raw_trace if raw else schedule_trace
                   if opened == "schedule" else device_trace)
        try:
            with session(tmp):
                body()
                if DEVICE == "cuda":
                    torch.cuda.synchronize()
        except RuntimeError as e:
            refused = str(e)[:200]
        (name,) = os.listdir(tmp)
        with open(os.path.join(tmp, name)) as f:
            events = json.load(f)["traceEvents"]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    cats = {}
    for e in events:
        cats[e.get("cat", "?")] = cats.get(e.get("cat", "?"), 0) + 1
    return {"events": len(events), "by_cat": cats,
            "kernels": sorted({e["name"][:60] for e in events
                               if e.get("cat") == "kernel"}),
            "refused": refused,
            **({"trace_events": events} if keep else {})}


def primer_loss(events):
    """Of the primer's kernel launches (`profiling.primer_kernels`' rule,
    the runtime's launch calls alone): how many lost their kernel, whether
    those were its first (and the first few lost, by launch), and, from the
    window's opening (the profiler's own span), where the first launch and
    the first kept kernel's launch and start fall (us)."""
    from cozo_tpu_torch.utils.profiling import LAUNCH_CATS, PRIMER_SPAN

    span = [e for e in events if e.get("name") == PRIMER_SPAN
            and e.get("cat") == "user_annotation"]
    window = [e["ts"] for e in events if e.get("cat") == "Trace"]
    if not span or not window:
        return {}
    t0, t1 = span[0]["ts"], span[0]["ts"] + span[0].get("dur", 0)
    launches = sorted((e["ts"], e["args"]["correlation"]) for e in events
                      if e.get("cat") in LAUNCH_CATS
                      and "Launch" in e.get("name", "")
                      and "correlation" in e.get("args", {})
                      and e["tid"] == span[0]["tid"] and t0 <= e["ts"] <= t1)
    kernels = {e["args"]["correlation"]: e["ts"] for e in events
               if e.get("cat") == "kernel" and "correlation" in e.get("args",
                                                                     {})}
    kept = [c in kernels for _, c in launches]
    lost = kept.count(False)
    first = kept.index(True) if True in kept else None
    w = min(window)
    return {"primer_launches": len(launches), "primer_lost": lost,
            "lost_first": lost == (first if first is not None else lost),
            "lost_at": [i for i, k in enumerate(kept) if not k][:4],
            "first_launch_us": launches[0][0] - w if launches else None,
            "kept_launch_us": None if first is None
            else launches[first][0] - w,
            "kept_kernel_us": None if first is None
            else kernels[launches[first][1]] - w}


def launch_us(n=2000):
    """Host us a one-element add takes to launch, outside any session: what
    the profiler's hooks, where they stay attached, add to every launch."""
    import torch

    if DEVICE != "cuda":
        return None
    one = torch.zeros(1, device=DEVICE)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        one.add_(1)
    torch.cuda.synchronize()
    return round((time.perf_counter() - t0) / n * 1e6, 3)


def clock_skew_us(origin):
    """How far CLOCK_REALTIME has moved from CLOCK_MONOTONIC and from
    CLOCK_MONOTONIC_RAW since `origin` (`clocks()` then), in us."""
    now = clocks()
    return [round((now[0] - now[i] - origin[0] + origin[i]) / 1e3, 3)
            for i in (1, 2)]


def clocks():
    return (time.clock_gettime_ns(time.CLOCK_REALTIME),
            time.clock_gettime_ns(time.CLOCK_MONOTONIC),
            time.clock_gettime_ns(time.CLOCK_MONOTONIC_RAW))


def cuda_op(n=1 << 16):
    import torch

    return float(torch.ones(n, device=DEVICE).sum())


def bare_handler(callbacks):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):
            pass

        def _send(self, body):
            self.send_response(200)
            self.send_header("content-length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_POST(self):
            self.rfile.read(int(self.headers.get("content-length") or 0))
            if self.path == "/slow":  # runs on past the server's shutdown
                time.sleep(1.0)
                t_end = time.time() + 3.0
                while time.time() < t_end:
                    cuda_op(1 << 22)
            return self._send(json.dumps({"sum": cuda_op()}).encode())

        def do_GET(self):  # the port's SSE loop, shortened
            q = queue.Queue()
            callbacks.append(q.put)
            try:
                self.send_response(200)
                self.send_header("content-type", "text/event-stream")
                self.end_headers()
                while True:
                    try:
                        ev = q.get(timeout=30)
                        self.wfile.write(f"data: {json.dumps(ev)}\n\n".encode())
                    except queue.Empty:
                        self.wfile.write(b": keepalive\n\n")
                    self.wfile.flush()
            except (BrokenPipeError, ConnectionResetError):
                pass
            finally:
                callbacks.remove(q.put)

    return Handler


def post(url, path, body, timeout=120):
    req = urllib.request.Request(url + path, data=json.dumps(body).encode(),
                                 method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.read()


def sse_once(url, path, put):
    """Open an SSE stream, `put()` until it carries an event, then leave."""
    got = []

    def listen():
        with urllib.request.urlopen(url + path, timeout=60) as resp:
            for raw in resp:
                if raw.startswith(b"data: "):
                    got.append(raw)
                    return

    t = threading.Thread(target=listen, daemon=True)
    t.start()
    for k in range(40):
        if got:
            break
        time.sleep(0.25)
        put(k)
    t.join(timeout=30)
    return bool(got)


def run_case(name, n_load):
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    factors = CASES[name]
    out = {"case": name}
    burners = []
    if "load" in factors:
        burners = [subprocess.Popen([sys.executable, "-c", "while True: pass"])
                   for _ in range(n_load)]
        out["load_processes"] = n_load
    try:
        cuda_op()
        if "earlier" in factors and DEVICE == "cuda":
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                cuda_op()
                cuda_op()
                torch.cuda.synchronize()
            out["earlier_cuda_events"] = sum(
                e.device_type == torch.autograd.DeviceType.CUDA
                for e in prof.events())
        if "earlier" in factors:
            out["earlier_trace"] = trace(cuda_op, raw=True)
        if "server" in factors or "port" in factors:
            out.update(serve_and_shut(factors, np))
        out["threads_at_trace"] = sorted(t.name for t in threading.enumerate())
        out["traces_after"] = [trace(lambda: cuda_op(1 << 20), raw=True)
                               for _ in range(3)]
    finally:
        for p in burners:
            p.kill()
        for p in burners:
            p.wait()
    out["blind"] = not any(t["kernels"] for t in out["traces_after"])
    return out


def serve_and_shut(factors, np):
    callbacks = []
    if "port" in factors:
        from cozo_tpu_torch import Db
        from cozo_tpu_torch.hosts.server import serve

        db = Db("mem", device=DEVICE)
        rng = np.random.default_rng(5)
        edges = rng.integers(0, PR_NODES, (PR_EDGES, 2)).tolist()
        db.run_script(":create e {a: Int, b: Int}")
        db.run_script("?[a, b] <- $rows :put e {a, b}", {"rows": edges})
        db.run_script(":create sse_rel {k: Int}")
        srv = serve(db, "127.0.0.1", 0)
        path, body = "/text-query", {
            "script": "?[n, s] <~ PageRank(*e[a, b], iterations: 10)"}

        def put(k):
            db.run_script(f"?[k] <- [[{k}]] :put sse_rel {{k}}")
        sse_path = "/changes/sse_rel"
    else:
        srv = ThreadingHTTPServer(("127.0.0.1", 0), bare_handler(callbacks))
        path, body = "/op", {}

        def put(k):
            for cb in list(callbacks):
                cb({"k": k})
        sse_path = "/changes"
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    post(url, path, body)  # warm

    def client(_):
        lat = []
        for _ in range(REQUESTS):
            t0 = time.perf_counter()
            post(url, path, body)
            lat.append((time.perf_counter() - t0) * 1e3)
        return lat

    before = listen_counters()
    with ThreadPoolExecutor(CLIENTS) as ex:
        lat = sorted(sum(ex.map(client, range(CLIENTS)), []))
    after = listen_counters()
    out = {"p50_ms": statistics.median(lat),
           "p99_ms": lat[int(0.99 * (len(lat) - 1))],
           "listen_overflows_drops": None if before is None or after is None
           else (after[0] - before[0], after[1] - before[1])}
    if "sse" in factors:
        out["sse_event"] = sse_once(url, sse_path, put)
    if "unfinished" in factors:
        def leave(_):
            try:
                post(url, "/slow", {}, timeout=0.2)
            except OSError:
                pass
        with ThreadPoolExecutor(CLIENTS) as ex:
            list(ex.map(leave, range(CLIENTS)))
    srv.shutdown()
    srv.server_close()
    return out


def run_drift(seconds, idle, prime, raw, launches=0, late=0.0,
              late_cuda=False, opened="start", every=DRIFT_EVERY):
    """`--drift`: one line a session (the module's docstring)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    t_start, origin = time.time(), clocks()
    if late_cuda:
        time.sleep(late)
    cuda_op()
    if not late_cuda:
        time.sleep(late)
    print("drift-start " + json.dumps({
        "launch_us": launch_us(), "TEARDOWN_CUPTI": os.environ.get(
            "TEARDOWN_CUPTI")}), flush=True)
    n = 0
    while time.time() - t_start < seconds:
        t_next = time.time() + every
        while time.time() < t_next:  # the card kept busy between sessions
            if idle:
                time.sleep(t_next - time.time())
            else:
                cuda_op(1 << 18)
        if prime == "session":
            empty = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
            empty.start()
            empty.stop()
        padded = n % 2 == 1
        t = trace(lambda: (time.sleep(DRIFT_PAD) if padded else None,
                           [cuda_op(1 << 10) for _ in range(launches)],
                           cuda_op(1 << 20)), keep=True, raw=raw,
                  opened=opened)
        ev = t.pop("trace_events")
        op = [e["ts"] for e in ev if e.get("name") == "aten::sum"]
        kern = [e["ts"] for e in ev if e.get("cat") == "kernel"
                and "reduce_kernel" in e["name"]]
        body = sum(e.get("cat") == "kernel" and ("reduce_kernel" in e["name"]
                   or "FillFunctor" in e["name"]) for e in ev)
        from cozo_tpu_torch.utils.profiling import primer_kernels

        print("drift " + json.dumps({
            "age_s": round(time.time() - t_start, 1), "idle": idle,
            "prime": prime, "raw": raw, "opened": opened, "late": late,
            "late_cuda": late_cuda, "every": every, "padded": padded,
            "kernels": len(t["kernels"]),
            "body_kernels": body, "launched": 2 * (launches + 1),
            "primer_kernels": t["by_cat"].get("kernel", 0) - body,
            "primer_kept": primer_kernels(ev), "refused": t["refused"],
            **primer_loss(ev),
            "cuda_runtime": t["by_cat"].get("cuda_runtime", 0),
            "sum_kernel_less_op_us": kern[0] - op[0] if op and kern
            else None, "clock_skew_us": clock_skew_us(origin),
            "launch_us_after": launch_us()}), flush=True)
        n += 1


def run_spike(n_load, sessions, late=0.0):
    """`--spike`: `device_trace` sessions, each right after `n_load`
    spinning processes ran SPIKE_S seconds and stopped (the first after
    `late` seconds of sleep)."""
    from cozo_tpu_torch.utils.profiling import primer_kernels

    t_start = time.time()
    cuda_op()
    time.sleep(late)
    for i in range(sessions):
        burners = [subprocess.Popen([sys.executable, "-c",
                                     "while True: pass"])
                   for _ in range(n_load)]
        time.sleep(SPIKE_S)
        for p in burners:
            p.kill()
        for p in burners:
            p.wait()
        t = trace(lambda: cuda_op(1 << 20), keep=True)
        ev = t.pop("trace_events")
        print("spike " + json.dumps({
            "session": i, "age_s": round(time.time() - t_start, 1),
            "load_processes": n_load, "kernels": t["by_cat"].get("kernel", 0),
            "primer_kept": primer_kernels(ev), "refused": t["refused"],
            "cuda_runtime": t["by_cat"].get("cuda_runtime", 0),
            "events": t["events"]}), flush=True)


def run_graph(sessions, graph=True):
    """`--graph`: `device_trace` and raw sessions in a process that holds a
    captured CUDA graph (with `--no-graph`: none), each replaying it."""
    import torch

    x = torch.ones(1 << 16, device=DEVICE)
    g = None
    if graph:
        side = torch.cuda.Stream()
        with torch.cuda.stream(side):
            (x * 2).sum()
        torch.cuda.synchronize()
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            (x * 2).sum()

    def body():
        if g is not None:
            g.replay()
        (x + 1).sum()

    for i in range(sessions):
        for raw in (False, True):
            t = trace(body, keep=True, raw=raw)
            ev = t.pop("trace_events")
            from cozo_tpu_torch.utils.profiling import primer_kernels

            print("graph " + json.dumps({
                "session": i, "graph": graph, "raw": raw,
                "TEARDOWN_CUPTI": os.environ.get("TEARDOWN_CUPTI"),
                "kernels": t["by_cat"].get("kernel", 0),
                "primer_kept": primer_kernels(ev),
                "refused": (t["refused"] or "")[:80] or None}), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--case", choices=sorted(CASES), default=None,
                    help="run this case here (default: every case, each "
                         "in a process of its own)")
    ap.add_argument("--load", type=int, default=2 * (os.cpu_count() or 4))
    ap.add_argument("--rounds", type=int, default=1,
                    help="times each case runs")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--drift", type=float, default=None, metavar="SECONDS",
                    help="the second witness: the kernels a session records "
                         "in a process this old")
    ap.add_argument("--idle", action="store_true",
                    help="with --drift: sleep between sessions")
    ap.add_argument("--prime", choices=("none", "session"),
                    default="none", help="with --drift: before each session")
    ap.add_argument("--launches", type=int, default=0,
                    help="with --drift: fills and sums launched in each "
                         "session before the last")
    ap.add_argument("--raw", action="store_true",
                    help="with --drift: sessions of torch.profiler alone, "
                         "not device_trace")
    ap.add_argument("--open", choices=("start", "schedule"), default="start",
                    help="with --drift: device_trace's session, or one "
                         "opened by a schedule's warm-up step")
    ap.add_argument("--late", type=float, default=0.0, metavar="SECONDS",
                    help="with --drift or --spike: sleep this long before "
                         "the first session, after the first launch")
    ap.add_argument("--every", type=float, default=DRIFT_EVERY,
                    metavar="SECONDS", help="with --drift: seconds between "
                    "sessions")
    ap.add_argument("--late-cuda", action="store_true",
                    help="with --late: sleep before the first launch")
    ap.add_argument("--spike", type=int, default=None, metavar="N",
                    help="the third witness: sessions right after N "
                         "spinning processes stop")
    ap.add_argument("--sessions", type=int, default=20,
                    help="with --spike or --graph: how many")
    ap.add_argument("--graph", action="store_true",
                    help="the fourth witness: sessions in a process that "
                         "holds a CUDA graph")
    ap.add_argument("--no-graph", action="store_true",
                    help="with --graph: the same sessions, no graph")
    args = ap.parse_args()
    import torch

    global DEVICE
    DEVICE = args.device
    if DEVICE == "cuda" and not torch.cuda.is_available():
        print("chip_trace_witness: CUDA is not available", file=sys.stderr)
        return 1
    if args.case:
        print("WITNESS " + json.dumps(run_case(args.case, args.load)),
              flush=True)
        return 0
    if args.drift is not None:
        run_drift(args.drift, args.idle, args.prime, args.raw,
                  args.launches, args.late, args.late_cuda, args.open,
                  args.every)
        return 0
    if args.spike is not None:
        run_spike(args.spike, args.sessions, args.late)
        return 0
    if args.graph:
        run_graph(args.sessions, not args.no_graph)
        return 0
    name = torch.cuda.get_device_name(0) if DEVICE == "cuda" else "cpu"
    print(f"device: {name} (torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}), "
          f"{os.cpu_count()} CPUs", flush=True)
    results = []
    for r in range(args.rounds):
        for name in CASES:
            t0 = time.time()
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--case", name,
                 "--load", str(args.load), "--device", DEVICE],
                capture_output=True, text=True,
                timeout=600)
            lines = [ln for ln in proc.stdout.splitlines()
                     if ln.startswith("WITNESS ")]
            res = json.loads(lines[-1][8:]) if lines else {
                "case": name, "failed": proc.returncode,
                "stderr_tail": proc.stderr[-2000:]}
            res["round"], res["seconds"] = r, round(time.time() - t0, 1)
            res["profiler_warnings"] = [
                ln[:300] for ln in proc.stderr.splitlines()
                if any(w in ln.lower() for w in ("kineto", "cupti",
                                                 "profil"))][:12]
            results.append(res)
            print("case " + json.dumps(res), flush=True)
    if DEVICE == "cuda":
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip())
    print("summary " + json.dumps({r["case"] + f" #{r['round']}":
                                   r.get("blind", "failed")
                                   for r in results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
