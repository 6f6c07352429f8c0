"""The port's HTTP server (`cozo_tpu_torch/hosts/server.py`) against the
JAX package's (`cozo_tpu/hosts/server.py`): the cases of
`tests/test_server.py`, each sent with the same requests to a JAX server
on `Db("mem")` and a port server on `Db("mem", device="cpu")`; the JSON
bodies and the SSE events must be equal (the `took` seconds of a query
aside)."""

import json
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import pytest

from cozo_tpu import Db as JaxDb
from cozo_tpu.hosts.server import serve as jax_serve
from cozo_tpu_torch import Db
from cozo_tpu_torch.hosts.server import serve

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _start(srv):
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    return f"http://127.0.0.1:{srv.server_address[1]}"


@pytest.fixture()
def urls():
    """(JAX server url, port server url), each on a fresh mem Db."""
    servers = [jax_serve(JaxDb("mem"), "127.0.0.1", 0),
               serve(Db("mem", device="cpu"), "127.0.0.1", 0)]
    yield [_start(s) for s in servers]
    for s in servers:
        s.shutdown()
        s.server_close()


def _request(url, path, body=None, method="POST", headers=None):
    """(status, raw body) of one request; HTTP errors are answers too."""
    data = None if body is None else (
        body if isinstance(body, bytes) else json.dumps(body).encode())
    req = urllib.request.Request(url + path, data=data, method=method,
                                 headers={"content-type": "application/json",
                                          **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _strip(raw):
    out = json.loads(raw)
    if isinstance(out, dict):
        out.pop("took", None)
    return out


def both(urls, path, body=None, method="POST", headers=None):
    """Send the same request to both servers; their statuses and bodies
    must be equal.  Returns the port's body, parsed."""
    (sj, bj), (st, bt) = (_request(u, path, body, method, headers)
                          for u in urls)
    assert sj == st, (path, bj, bt)
    assert _strip(bj) == _strip(bt), (path, bj, bt)
    return _strip(bt)


def test_root_bodies_equal_byte_for_byte(urls):
    raw = [_request(u, "/", method="GET")[1] for u in urls]
    assert raw[0] == raw[1]
    assert json.loads(raw[1])["service"] == "cozo_tpu"


def test_text_query(urls):
    out = both(urls, "/text-query", {"script": "?[a] <- [[1], [2]]"})
    assert out["ok"] is True and out["rows"] == [[1], [2]]


def test_text_query_error(urls):
    out = both(urls, "/text-query", {"script": "?[a] := nonexistent[a]"})
    assert out["ok"] is False and "nonexistent" in out["message"]
    both(urls, "/nowhere", {})


def test_export_import(urls):
    both(urls, "/text-query", {"script": ":create exp {a}"})
    both(urls, "/text-query", {"script": "?[a] <- [[5]] :put exp {a}"})
    out = both(urls, "/export/exp", method="GET")
    assert out["data"]["exp"]["rows"] == [[5]]
    out = both(urls, "/import", {"exp": {"headers": ["a"], "rows": [[6]]}},
               method="PUT")
    assert out["ok"]
    out = both(urls, "/text-query", {"script": "?[a] := *exp[a]"})
    assert out["rows"] == [[5], [6]]


def test_transact(urls):
    txid = both(urls, "/transact", {})["id"]
    both(urls, f"/transact/{txid}", {"script": ":create t {a}"})
    both(urls, f"/transact/{txid}", {"script": "?[a] <- [[1]] :put t {a}"})
    both(urls, f"/transact/{txid}", {"commit": True})
    both(urls, "/transact/99", {"commit": True})  # not found, both
    out = both(urls, "/text-query", {"script": "?[a] := *t[a]"})
    assert out["rows"] == [[1]]


def test_auth():
    servers = [jax_serve(JaxDb("mem"), "127.0.0.1", 0, auth_token="secret"),
               serve(Db("mem", device="cpu"), "127.0.0.1", 0,
                     auth_token="secret")]
    urls = [_start(s) for s in servers]
    try:
        script = b'{"script": "?[a] <- [[1]]"}'
        both(urls, "/text-query", script)  # 401 with the same body
        assert _request(urls[1], "/text-query", script)[0] == 401
        out = both(urls, "/text-query", script,
                   headers={"x-cozo-auth": "secret"})
        assert out["ok"]
    finally:
        for s in servers:
            s.shutdown()
            s.server_close()


def _remote_rule(url):
    """test_server.py's remote custom rule on one server: register, query
    (blocks), deliver the rows; returns the query's and the delivery's
    answers."""
    got = {"register": _request(url, "/rules/RemoteDouble",
                                {"arity": 1, "timeout": 30})}

    def run_query():
        got["query"] = _request(url, "/text-query",
                                {"script": "?[x] <~ RemoteDouble()"})

    t = threading.Thread(target=run_query)
    t.start()
    for _ in range(200):
        time.sleep(0.05)
        status, raw = _request(url, "/rules/RemoteDouble/result",
                               {"rows": [[2], [4]]})
        if status == 200:
            got["deliver"] = (status, raw)
            break
    t.join(timeout=30)
    assert not t.is_alive()
    return {k: (s, _strip(b)) for k, (s, b) in got.items()}


def test_remote_custom_rule(urls):
    j, t = (_remote_rule(u) for u in urls)
    assert j == t
    assert t["query"][1]["ok"] is True
    assert t["query"][1]["rows"] == [[2], [4]]


def _first_event(url, rel):
    """Listen on /changes/{rel}, put a row, return the first event."""
    events = []

    def listen():
        req = urllib.request.Request(url + f"/changes/{rel}")
        with urllib.request.urlopen(req, timeout=20) as resp:
            for raw in resp:
                line = raw.decode("utf-8").strip()
                if line.startswith("data: "):
                    events.append(json.loads(line[len("data: "):]))
                    return

    t = threading.Thread(target=listen, daemon=True)
    t.start()
    time.sleep(0.5)  # let the callback register
    _request(url, "/text-query", {"script": f"?[k] <- [[42]] :put {rel} {{k}}"})
    t.join(timeout=15)
    assert not t.is_alive()
    return events


def test_sse_change_stream(urls):
    both(urls, "/text-query", {"script": ":create sse_rel {k}"})
    j, t = (_first_event(u, "sse_rel") for u in urls)
    assert j == t
    assert t and t[0]["op"] == "Put" and t[0]["new"] == [[42]]


def test_cli_without_a_device_refuses_without_a_card():
    """`python -m cozo_tpu_torch.hosts.server` with no `--device` opens its
    Db on the card: with none visible it exits non-zero with the CUDA
    error, and serves nothing on the CPU."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=_ROOT)
    proc = subprocess.run(
        [sys.executable, "-m", "cozo_tpu_torch.hosts.server", "--port", "0"],
        capture_output=True, text=True, timeout=120, env=env, cwd=_ROOT)
    assert proc.returncode != 0
    assert "RuntimeError" in proc.stderr and "CUDA" in proc.stderr
    assert "listening" not in proc.stdout


def test_cli_serves_on_the_cpu_when_asked():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=_ROOT)
    proc = subprocess.Popen(
        [sys.executable, "-m", "cozo_tpu_torch.hosts.server", "--port", "0",
         "--device", "cpu"],
        stdout=subprocess.PIPE, text=True, env=env, cwd=_ROOT)
    watchdog = threading.Timer(120, proc.kill)  # the test's own time limit
    watchdog.start()
    try:
        line = proc.stdout.readline()
        assert "listening" in line and "cpu" in line, line
        url = f"http://127.0.0.1:{line.rsplit(':', 1)[1].strip()}"
        status, raw = _request(url, "/text-query", {"script": "?[a] <- [[7]]"})
        assert status == 200 and json.loads(raw)["rows"] == [[7]]
    finally:
        watchdog.cancel()
        proc.terminate()
        proc.wait(timeout=30)
