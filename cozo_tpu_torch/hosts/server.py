"""HTTP server host (reference `cozo-bin/src/server.rs`; counterpart of
`cozo_tpu/hosts/server.py`, whose response bodies it repeats byte for
byte: the protocol is the same service, `"service": "cozo_tpu"` on
`GET /` included).

Routes (parity with `server.rs:244-256`):
  POST /text-query                 {script, params} → result json
  GET  /export/{relations}         comma-separated names
  PUT  /import                     {rel: {headers, rows}}
  POST /backup                     {path}
  POST /import-from-backup         {path, relations}
  GET  /changes/{relation}         SSE change stream (register_callback)
  POST /rules/{name}               register a remote custom fixed rule
  POST /rules/{name}/result        deliver a remote rule's result
  POST /transact                   open a multi-transaction → {id}
  POST /transact/{id}              {script, params} | {commit|abort: true}

Auth: `x-cozo-auth` header checked against the token passed at startup
(reference `server.rs:103`).

    python -m cozo_tpu_torch.hosts.server --port 9070   # the Db on the card
    python -m cozo_tpu_torch.hosts.server --device cpu  # on the host

Reads run concurrently (a `ThreadingHTTPServer`), under the locks the Db
and its indexes keep; there is no lock around the Db.  The listen backlog
is `LISTEN_BACKLOG` (`CozoHTTPServer`), not socketserver's 5.  `serve`
leaves the heap it finds out of the cyclic collector's walk
(`gc.freeze()`)."""

from __future__ import annotations

import gc
import json
import queue
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional

from ..runtime.db import Db, MultiTransaction
from ..fixed_rule import SimpleFixedRule
from ..utils.errors import CozoError


# Connection requests the kernel queues while the accept loop is busy.
# socketserver's default, 5, overflows under a burst of more clients than
# that, each opening a connection a request (urllib, curl): the kernel
# drops the handshake and the client retries it after 1 s, a tail of whole
# seconds around requests of milliseconds (`chip_smoke.py` phase 11 (a)
# runs both in turns).  128 holds a burst of that many clients; Linux caps
# it at net.core.somaxconn.
LISTEN_BACKLOG = 128


class CozoHTTPServer(ThreadingHTTPServer):
    """The server `serve` returns: a `ThreadingHTTPServer` that listens
    with a backlog of `LISTEN_BACKLOG`."""

    request_queue_size = LISTEN_BACKLOG


class ServerState:
    def __init__(self, db: Db, auth_token: Optional[str] = None) -> None:
        self.db = db
        self.auth_token = auth_token
        self.tx_lock = threading.Lock()
        self.tx_counter = 0
        self.transactions: Dict[int, MultiTransaction] = {}
        self.rule_lock = threading.Lock()
        self.pending_rules: Dict[str, queue.Queue] = {}


def make_handler(state: ServerState):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # quiet
            pass

        # ------------------------------------------------------------ helpers

        def _check_auth(self) -> bool:
            if state.auth_token is None:
                return True
            return self.headers.get("x-cozo-auth") == state.auth_token

        def _body(self) -> dict:
            length = int(self.headers.get("content-length") or 0)
            if not length:
                return {}
            raw = self.rfile.read(length)
            return json.loads(raw.decode("utf-8")) if raw else {}

        def _send(self, obj, code=200, content_type="application/json"):
            payload = (
                obj if isinstance(obj, bytes) else json.dumps(obj).encode("utf-8")
            )
            self.send_response(code)
            self.send_header("content-type", content_type)
            self.send_header("content-length", str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)

        def _err(self, e: Exception, code=400):
            if isinstance(e, CozoError):
                self._send(
                    {"ok": False, "message": e.message, "code": e.code}, code
                )
            else:
                self._send({"ok": False, "message": str(e)}, 500)

        # -------------------------------------------------------------- routes

        def do_POST(self):
            if not self._check_auth():
                return self._send({"ok": False, "message": "unauthorized"}, 401)
            path = urllib.parse.urlparse(self.path).path
            try:
                if path == "/text-query":
                    body = self._body()
                    out = state.db.run_script_json(
                        body.get("script", ""), json.dumps(body.get("params", {}))
                    )
                    return self._send(out.encode("utf-8"))
                if path == "/backup":
                    body = self._body()
                    state.db.backup_db(body["path"])
                    return self._send({"ok": True})
                if path == "/import-from-backup":
                    body = self._body()
                    state.db.import_from_backup(body["path"], body["relations"])
                    return self._send({"ok": True})
                if path == "/transact":
                    with state.tx_lock:
                        state.tx_counter += 1
                        txid = state.tx_counter
                        state.transactions[txid] = state.db.multi_transaction(
                            write=True
                        )
                    return self._send({"ok": True, "id": txid})
                if path.startswith("/transact/"):
                    txid = int(path.rsplit("/", 1)[1])
                    tx = state.transactions.get(txid)
                    if tx is None:
                        return self._send(
                            {"ok": False, "message": "transaction not found"}, 404
                        )
                    body = self._body()
                    if body.get("commit"):
                        tx.commit()
                        state.transactions.pop(txid, None)
                        return self._send({"ok": True})
                    if body.get("abort"):
                        tx.abort()
                        state.transactions.pop(txid, None)
                        return self._send({"ok": True})
                    res = tx.run_script(
                        body.get("script", ""), body.get("params", {})
                    )
                    d = res.to_dict()
                    d["ok"] = True
                    return self._send(d)
                if path.startswith("/rules/") and path.endswith("/result"):
                    name = path[len("/rules/") : -len("/result")]
                    with state.rule_lock:
                        q = state.pending_rules.get(name)
                    if q is None:
                        return self._send(
                            {"ok": False, "message": "rule not waiting"}, 404
                        )
                    q.put(self._body())
                    return self._send({"ok": True})
                if path.startswith("/rules/"):
                    # register a remote custom rule: the rule blocks queries
                    # until a client POSTs to /rules/{name}/result
                    # (reference server.rs:521-568)
                    name = path[len("/rules/") :]
                    body = self._body()
                    arity = int(body.get("arity", 1))

                    def remote_fn(inputs, options, _name=name):
                        q: queue.Queue = queue.Queue()
                        with state.rule_lock:
                            state.pending_rules[_name] = q
                        try:
                            payload = q.get(timeout=float(body.get("timeout", 300)))
                        finally:
                            with state.rule_lock:
                                state.pending_rules.pop(_name, None)
                        return payload.get("rows", [])

                    state.db.register_fixed_rule(
                        name, SimpleFixedRule(name, arity, remote_fn)
                    )
                    return self._send({"ok": True})
                return self._send({"ok": False, "message": "not found"}, 404)
            except Exception as e:  # noqa: BLE001
                return self._err(e)

        def do_PUT(self):
            if not self._check_auth():
                return self._send({"ok": False, "message": "unauthorized"}, 401)
            path = urllib.parse.urlparse(self.path).path
            try:
                if path == "/import":
                    state.db.import_relations(self._body())
                    return self._send({"ok": True})
                return self._send({"ok": False, "message": "not found"}, 404)
            except Exception as e:  # noqa: BLE001
                return self._err(e)

        def do_GET(self):
            if not self._check_auth():
                return self._send({"ok": False, "message": "unauthorized"}, 401)
            parsed = urllib.parse.urlparse(self.path)
            path = parsed.path
            try:
                if path.startswith("/export/"):
                    rels = urllib.parse.unquote(path[len("/export/") :]).split(",")
                    data = state.db.export_relations([r for r in rels if r])
                    return self._send({"ok": True, "data": data})
                if path.startswith("/changes/"):
                    relation = urllib.parse.unquote(path[len("/changes/") :])
                    return self._sse_changes(relation)
                if path == "/":
                    return self._send(
                        {"ok": True, "service": "cozo_tpu", "status": "ready"}
                    )
                return self._send({"ok": False, "message": "not found"}, 404)
            except Exception as e:  # noqa: BLE001
                return self._err(e)

        def _sse_changes(self, relation: str):
            """SSE change stream backed by register_callback
            (reference server.rs:629)."""
            q: queue.Queue = queue.Queue()

            def cb(op, rel, new_rows, old_rows):
                q.put({"op": op, "relation": rel, "new": new_rows, "old": old_rows})

            cb_id = state.db.register_callback(relation, cb)
            try:
                self.send_response(200)
                self.send_header("content-type", "text/event-stream")
                self.send_header("cache-control", "no-cache")
                self.end_headers()
                while True:
                    try:
                        event = q.get(timeout=30)
                        from ..data.value import to_json

                        def clean(rows):
                            return [[to_json(v) for v in r] for r in rows]

                        event["new"] = clean(event["new"])
                        event["old"] = clean(event["old"])
                        data = json.dumps(event)
                        self.wfile.write(f"data: {data}\n\n".encode("utf-8"))
                        self.wfile.flush()
                    except queue.Empty:
                        self.wfile.write(b": keepalive\n\n")
                        self.wfile.flush()
            except (BrokenPipeError, ConnectionResetError):
                pass
            finally:
                state.db.unregister_callback(cb_id)

    return Handler


def serve(
    db: Db, host: str = "127.0.0.1", port: int = 9070, auth_token: Optional[str] = None
) -> CozoHTTPServer:
    """The server on `db`, bound and listening, after one collection that
    moves every object the collector tracks into its permanent generation
    (`gc.freeze()`), which no later pass walks.  CPython runs a full pass,
    holding the GIL and so stopping every request thread, once the objects
    that survived into its oldest generation since the last one pass a
    quarter of those it kept then; a large answer (the rows of a
    whole-graph rule) passes it, and unfrozen the pass walks the whole
    heap: the interpreter's and torch's modules and whatever the Db holds.
    Frozen, that heap is out of every later pass, which walks what was made
    after it.  Objects are still freed when their last reference goes; a
    reference cycle among frozen objects stays until the process ends
    (`gc.unfreeze()` returns them to the collector)."""
    state = ServerState(db, auth_token)
    server = CozoHTTPServer((host, port), make_handler(state))
    gc.collect()
    gc.freeze()
    return server


def server_main(argv=None) -> None:
    import argparse

    ap = argparse.ArgumentParser(description="cozo_tpu_torch server")
    ap.add_argument("--engine", default="mem")
    ap.add_argument("--path", default="")
    ap.add_argument("--bind", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=9070)
    ap.add_argument("--auth", default=None)
    ap.add_argument("--device", default=None,
                    help="the Db's device: the card unless 'cpu' is given")
    args = ap.parse_args(argv)
    db = Db(args.engine, args.path, device=args.device)
    server = serve(db, args.bind, args.port, args.auth)
    print(f"cozo_tpu_torch server ({db.device}) listening on "
          f"{args.bind}:{server.server_address[1]}", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    server_main()
