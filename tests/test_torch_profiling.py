"""The port's profiling hooks (`cozo_tpu_torch/utils/profiling.py`)
against the JAX package's: `timed` prints the same line, and
`device_trace` writes a Chrome trace of what runs inside it."""

import glob
import json
import os
import re
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from cozo_tpu.utils import profiling as jax_profiling
from cozo_tpu_torch import Db
from cozo_tpu_torch.hosts.server import serve
from cozo_tpu_torch.utils import profiling


def test_timed_prints_the_same_line():
    lines = {}
    for name, mod in (("jax", jax_profiling), ("port", profiling)):
        got = []
        with mod.timed("step", sink=got.append):
            sum(range(1000))
        lines[name] = got
    pat = re.compile(r"^step: \d+\.\d{2}ms$")
    assert all(len(v) == 1 and pat.match(v[0]) for v in lines.values()), lines


def test_timed_reports_when_the_body_raises():
    got = []
    try:
        with profiling.timed("fails", sink=got.append):
            raise KeyError("x")
    except KeyError:
        pass
    assert len(got) == 1 and got[0].startswith("fails: ")


def test_device_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    db = Db("mem", device="cpu")
    a = torch.from_numpy(np.ones((64, 64), np.float32))
    with profiling.device_trace(str(tmp_path / "trace")):
        (a @ a).sum().item()
        db.run_script("?[x] <- [[1]]")
    files = glob.glob(str(tmp_path / "trace" / "trace-*.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any("mm" in n for n in names), sorted(names)[:50]


def test_device_trace_writes_its_trace_when_the_body_raises(tmp_path):
    try:
        with profiling.device_trace(str(tmp_path)):
            torch.ones(3).sum()
            raise ValueError("inside")
    except ValueError:
        pass
    assert len(os.listdir(tmp_path)) == 1


def _post(url, script):
    req = urllib.request.Request(url + "/text-query",
                                 data=json.dumps({"script": script}).encode(),
                                 method="POST")
    with urllib.request.urlopen(req, timeout=60) as resp:
        return json.loads(resp.read())


def _sse_once(url, db, rel):
    """Open /changes/{rel}, put rows until it carries an event, leave."""
    got = []

    def listen():
        with urllib.request.urlopen(url + f"/changes/{rel}",
                                    timeout=30) as resp:
            for raw in resp:
                if raw.startswith(b"data: "):
                    got.append(raw)
                    return

    t = threading.Thread(target=listen, daemon=True)
    t.start()
    for k in range(40):
        if got:
            break
        time.sleep(0.1)
        db.run_script(f"?[k] <- [[{k}]] :put {rel} {{k}}")
    t.join(timeout=15)
    return got


def test_device_trace_after_a_server_holds_the_ops_inside(tmp_path):
    """The order of `chip_smoke.py` phase 11: a port server on the Db
    serves 8 client threads and an SSE stream, is shut down, and only then
    does `device_trace` run: its trace holds the ops run inside it."""
    db = Db("mem", device="cpu")
    db.run_script(":create sse_rel {k: Int}")
    srv = serve(db, "127.0.0.1", 0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        with ThreadPoolExecutor(8) as ex:
            rows = list(ex.map(lambda t: _post(url, f"?[x] <- [[{t}]]"),
                               range(8)))
        assert [r["rows"] for r in rows] == [[[t]] for t in range(8)]
        assert _sse_once(url, db, "sse_rel")
    finally:
        srv.shutdown()
        srv.server_close()
    a = torch.from_numpy(np.ones((64, 64), np.float32))
    with profiling.device_trace(str(tmp_path)):
        (a @ a).sum().item()
        db.run_script("?[x] <- [[1]]")
    (name,) = os.listdir(tmp_path)
    with open(tmp_path / name) as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
    assert "aten::mm" in names and "aten::sum" in names, sorted(names)[:50]


def test_device_trace_primes_the_card_first(tmp_path, monkeypatch):
    """Where the process has used the card, the session launches its
    primer (PRIMER_LAUNCHES adds under `device_trace primer`, then a wait)
    before the code inside: the profiler drops a session's first device
    records.  A trace that then holds no kernel, as here, where the card's
    tensors are the host's, is written and `device_trace` raises."""
    zeros = torch.zeros
    waits = []
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: waits.append(1))
    monkeypatch.setattr(torch, "zeros", lambda *a, device=None, **k: zeros(
        *a, **k))
    a = torch.from_numpy(np.ones((8, 8), np.float32))
    try:
        with profiling.device_trace(str(tmp_path)):
            (a @ a).sum()
    except RuntimeError as e:
        assert "no kernel" in str(e)
    else:
        raise AssertionError("a trace without a kernel passed as the card's")
    (name,) = os.listdir(tmp_path)
    with open(tmp_path / name) as f:
        ops = sorted((e["ts"], e["name"]) for e in json.load(f)["traceEvents"]
                     if e.get("cat") in ("cpu_op", "user_annotation"))
    names = [n for _, n in ops]
    assert names.count("aten::add_") == profiling.PRIMER_LAUNCHES, names[:20]
    assert "device_trace primer" in names and waits
    last_add = max(t for t, n in ops if n == "aten::add_")
    assert all(t > last_add for t, n in ops if n == "aten::mm")


def test_device_trace_leaves_the_codes_error_alone(tmp_path, monkeypatch):
    """The code inside raised: its error goes out, not the blind trace's."""
    zeros = torch.zeros
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch, "zeros", lambda *a, device=None, **k: zeros(
        *a, **k))
    try:
        with profiling.device_trace(str(tmp_path)):
            raise KeyError("inside")
    except KeyError:
        pass
    assert len(os.listdir(tmp_path)) == 1


# The ops that launch a kernel each on the card, in the trace of a session
# around `(a @ a).sum()` with the primer first.
LAUNCHING = ("aten::zero_", "aten::fill_", "aten::add_", "aten::mm",
             "aten::sum")


def _as_the_cards(events, drop):
    """The CPU trace `events` made to look like a card's: each launching op
    gets a `cudaLaunchKernel` event inside it and a kernel on the device
    stream, tied by a correlation id; then the first `drop` kernels, in
    launch order, are taken out, as the profiler drops a session's first
    device records."""
    ops = [e for e in events if e.get("cat") == "cpu_op"
           and e["name"] in LAUNCHING]
    ops = sorted((e for e in ops if not any(  # the innermost launch
        o is not e and o["tid"] == e["tid"]
        and e["ts"] <= o["ts"] <= e["ts"] + e["dur"] for o in ops)),
        key=lambda e: e["ts"])
    kernels = []
    for c, op in enumerate(ops, 1):
        events.append({"ph": "X", "cat": "cuda_runtime",
                       "name": "cudaLaunchKernel", "pid": op["pid"],
                       "tid": op["tid"], "ts": op["ts"], "dur": 0,
                       "args": {"correlation": c}})
        kernels.append({"ph": "X", "cat": "kernel", "name": f"k {op['name']}",
                        "pid": 0, "tid": 7, "ts": op["ts"] + 5, "dur": 1,
                        "args": {"correlation": c}})
    events.extend(kernels[drop:])
    return len(ops)


@pytest.mark.parametrize("drop", [0, 1, 200, profiling.PRIMER_LAUNCHES])
def test_device_trace_keeps_a_trace_with_some_of_the_primer(
        tmp_path, monkeypatch, drop):
    """Kernels dropped from the front of the session, the primer's last one
    kept: every kernel of the code inside is in the trace, which passes."""
    launched = _card_stand_in(tmp_path, monkeypatch, drop)
    with profiling.device_trace(str(tmp_path)):
        (torch.ones(8, 8) @ torch.ones(8, 8)).sum()
    (name,) = os.listdir(tmp_path)
    with open(tmp_path / name) as f:
        events = json.load(f)["traceEvents"]
    assert launched[0] > profiling.PRIMER_LAUNCHES + 1  # the body's too
    assert profiling.primer_kernels(events) == profiling.PRIMER_LAUNCHES + 1 \
        - drop
    assert sum(e.get("cat") == "kernel" for e in events) == launched[0] - drop


@pytest.mark.parametrize("past", [0, 1])
def test_device_trace_refuses_a_trace_without_the_primer(
        tmp_path, monkeypatch, past):
    """Every kernel of the primer dropped (and, past it, the code's first):
    the trace is written, and `device_trace` raises naming it and the
    primer's kernels it kept."""
    _card_stand_in(tmp_path, monkeypatch, profiling.PRIMER_LAUNCHES + 1 + past)
    with pytest.raises(RuntimeError) as err:
        with profiling.device_trace(str(tmp_path)):
            (torch.ones(8, 8) @ torch.ones(8, 8)).sum()
    (name,) = os.listdir(tmp_path)
    assert str(tmp_path / name) in str(err.value)
    assert "holds 0 of the primer's" in str(err.value)


def _card_stand_in(tmp_path, monkeypatch, drop):
    """A card for `device_trace` on the CPU, as in
    `test_device_trace_primes_the_card_first`, whose exported trace is made
    a card's and thinned by `drop` kernels before `device_trace` reads it;
    returns a list that receives the count of launches."""
    from torch.profiler import profile

    zeros, export, launched = torch.zeros, profile.export_chrome_trace, []

    def thinned(self, path):
        export(self, path)
        with open(path) as f:
            trace = json.load(f)
        launched.append(_as_the_cards(trace["traceEvents"], drop))
        with open(path, "w") as f:
            json.dump(trace, f)

    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch, "zeros", lambda *a, device=None, **k: zeros(
        *a, **k))
    monkeypatch.setattr(profile, "export_chrome_trace", thinned)
    return launched

