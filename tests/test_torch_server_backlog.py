"""The port's HTTP server under a burst of connection requests
(`cozo_tpu_torch/hosts/server.py`, `LISTEN_BACKLOG`): the kernel queues
every connect of a burst while the server accepts none, where
socketserver's backlog of 5 completes 6 and drops the rest's handshakes
(each client then waits a retransmit, 1 s); and a burst of 8 client
threads, a connection a request, gets the Db's own answers."""

import json
import socket
import threading
import urllib.request
from concurrent.futures import ThreadPoolExecutor

from cozo_tpu_torch import Db
from cozo_tpu_torch.hosts.server import LISTEN_BACKLOG, serve

CONNECTS = 32
CONNECT_S = 0.3  # a handshake the kernel queues takes microseconds


def test_a_burst_of_connects_completes_while_none_is_accepted():
    srv = serve(Db("mem", device="cpu"), "127.0.0.1", 0)  # never accepts
    socks, done = [], 0
    try:
        for _ in range(CONNECTS):
            s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            socks.append(s)
            s.settimeout(CONNECT_S)
            try:
                s.connect(srv.server_address)
            except OSError:  # a dropped handshake: the timeout
                break
            done += 1
    finally:
        for s in socks:
            s.close()
        srv.server_close()
    assert LISTEN_BACKLOG >= CONNECTS
    assert done == CONNECTS, f"{done} of {CONNECTS} connects completed"


def _text_query(url, script):
    req = urllib.request.Request(
        url + "/text-query", data=json.dumps({"script": script}).encode(),
        method="POST", headers={"content-type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as resp:
        return resp.status, resp.read()


def _strip(raw):
    out = json.loads(raw)
    out.pop("took", None)
    return out


def test_a_burst_of_8_client_threads_gets_the_dbs_answers():
    db = Db("mem", device="cpu")
    db.run_script(":create r {a: Int => b: Int}")
    db.run_script("?[a, b] <- $rows :put r {a => b}",
                  {"rows": [[a, a * a % 97] for a in range(800)]})
    scripts = [f"?[a, b] := *r[a, b], a >= {100 * t}, a < {100 * t + 100}, "
               f"b % 2 == {t % 2}" for t in range(8)]
    want = [_strip(db.run_script_json(s)) for s in scripts]
    srv = serve(db, "127.0.0.1", 0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"

    def client(t):
        return [_text_query(url, scripts[t]) for _ in range(10)]

    try:
        with ThreadPoolExecutor(8) as ex:
            got = list(ex.map(client, range(8)))
    finally:
        srv.shutdown()
        srv.server_close()
    for t, answers in enumerate(got):
        assert len(answers) == 10
        for status, raw in answers:
            assert status == 200 and _strip(raw) == want[t], (t, raw[:200])
    assert all(w["rows"] for w in want)
