"""Db — the embedding API and query orchestrator
(reference `cozo-core/src/runtime/db.rs` + `src/lib.rs`).

Owns storage + per-script temp storage, the fixed-rule registry, the
event-callback registry, the running-query registry (::running/::kill),
and per-relation write locks.  `run_script` is the single entry point:
parse → (query | sys | imperative) → NamedRows.

Counterpart of `cozo_tpu/runtime/db.py`.  A Db resolves its device once,
at construction (`device=None` means the card, and raises without one;
`device="cpu"` runs the plain PyTorch paths on the host), and every
vector index it builds or rebuilds lives there, as does the MinHash-LSH
backfill's segment-min.  Storage engines: `mem`, `sqlite`, `tkv`
(alias `rocksdb`), `plog` (alias `sled`) and `remote` (alias `tikv`, a
client of `hosts/kvserver.py`), each with the JAX package's on-disk or
wire format."""

from __future__ import annotations

import functools
import itertools
import json as _json
import threading
import time as _time
from typing import Any, Callable, Dict, List, Optional, Set, Tuple

from ..data.functions import current_validity_ts
from ..data.program import InputProgram, QueryOutOptions
from ..data.value import cmp_key, to_json
from ..parse import ast as A
from ..parse.parser import parse_script
from ..query.eval import EvalContext, evaluate_strata
from ..query.normalize import normalize_program
from ..query.stored import create_relation, destroy_relation, execute_mutation
from ..query.stratify import stratify_program
from ..storage.base import Storage
from ..storage.mem import MemStorage
from ..utils.errors import (
    CozoError,
    QueryError,
    QueryKilled,
    QueryTimeout,
    StoredRelationError,
)
from ..utils.device import DeviceLike, default_device
from .relation import ACCESS_LEVELS, Catalog, RelationHandle, rel_prefix, rel_upper
from .transact import SessionTx


class _GcEvalTimer:
    """Attributes a query's wall time to GC pauses (COZO_TPU_EVAL_TIMING=1).

    CPython's cyclic collector walks every tracked container; with a
    10M-row mem relation resident the young-gen passes triggered by the
    ~1M transient env/row objects of a large set-at-a-time query add up
    to whole seconds per query (measured on BASELINE config #5).  The
    timer hooks gc.callbacks for the duration of one query and prints
    one line: eval wall, sort wall, GC pause total / pass count / gen2
    count — enough to separate engine work from collector stalls."""

    def __init__(self) -> None:
        import gc

        self._gc = gc
        self._t0 = 0.0
        self.pause = 0.0
        self.passes = 0
        self.gen2 = 0
        gc.callbacks.append(self._cb)

    def _cb(self, phase, info) -> None:
        if phase == "start":
            self._t0 = _time.time()
        else:
            self.pause += _time.time() - self._t0
            self.passes += 1
            if info.get("generation") == 2:
                self.gen2 += 1

    def report(self, t_eval: float, t_sort) -> None:
        try:
            self._gc.callbacks.remove(self._cb)
        except ValueError:
            pass
        import sys

        print(
            f"# eval_timing eval {t_eval:.3f}s sort "
            f"{(t_sort if t_sort is not None else 0.0):.3f}s gc_pause "
            f"{self.pause:.3f}s passes {self.passes} gen2 {self.gen2} "
            f"frozen {self._gc.get_freeze_count()}",
            file=sys.stderr,
            flush=True,
        )


def _gc_timer_if_enabled():
    import os

    if os.environ.get("COZO_TPU_EVAL_TIMING") != "1":
        return None
    return _GcEvalTimer()


def _sort_value_order(rows: list) -> list:
    """Sort result rows by value order (cmp_key).  Fast path: when every
    column is uniformly plain int or finite float (no -0.0), numeric
    numpy lexsort gives the identical order at ~20x the speed — this is
    the common shape for analytical outputs (ids + scores), where the
    per-value cmp_key lambda dominated the vector-pivot join's epilogue."""
    if len(rows) > 2048:
        import numpy as np

        cols = []
        ok = True
        for c in range(len(rows[0])):
            col = [r[c] for r in rows]
            t0 = type(col[0])
            if t0 is int and all(type(v) is int for v in col):
                try:  # out-of-i64 ints (e.g. $param = 2**70) can't ride
                    cols.append(np.asarray(col, np.int64))
                except OverflowError:
                    ok = False
                    break
            elif t0 is float and all(type(v) is float for v in col):
                a = np.asarray(col, np.float64)
                # NaN/-0.0 order differs from IEEE total order: fall back
                if not np.isfinite(a).all() or bool(
                    np.any((a == 0) & np.signbit(a))
                ):
                    ok = False
                    break
                cols.append(a)
            else:
                ok = False
                break
        if ok and cols:
            order = np.lexsort(tuple(reversed(cols)))
            return [rows[i] for i in order]
    rows.sort(key=lambda r: tuple(cmp_key(v) for v in r))
    return rows


class NamedRows:
    def __init__(self, headers: List[str], rows: List[list], next_rows=None):
        self.headers = headers
        self.rows = rows
        self.next = next_rows

    def to_dict(self, row=list) -> dict:
        """The answer as JSON values, each row a `row` (list or tuple: the
        same JSON text; the collector stops tracking a tuple of atoms at
        its first pass, so a large answer's rows then add nothing to the
        full passes that run while it is built)."""
        d = {
            "headers": self.headers,
            "rows": [row(map(to_json, r)) for r in self.rows],
        }
        d["next"] = self.next.to_dict(row) if self.next is not None else None
        return d

    def __repr__(self):
        return f"NamedRows({self.headers}, {len(self.rows)} rows)"

    @staticmethod
    def ok():
        return NamedRows(["status"], [["OK"]])


class Poison:
    """Cancellation + timeout flag checked inside evaluation loops
    (reference `runtime/db.rs:1926-1956`)."""

    def __init__(self) -> None:
        self.killed = False
        self.deadline: Optional[float] = None

    def check(self) -> None:
        if self.killed:
            raise QueryKilled("query is killed before completion")
        if self.deadline is not None and _time.monotonic() > self.deadline:
            raise QueryTimeout("query timed out")

    def set_timeout(self, secs: float) -> None:
        self.deadline = _time.monotonic() + secs


class Db:
    def __init__(self, engine: str = "mem", path: str = "",
                 device: DeviceLike = None) -> None:
        self.device = default_device(device)
        if isinstance(engine, Storage):
            self.storage: Storage = engine
        elif engine == "mem":
            self.storage = MemStorage()
        elif engine == "sqlite":
            from ..storage.sqlite import SqliteStorage

            self.storage = SqliteStorage(path)
        elif engine in ("rocksdb", "tkv"):
            from ..storage.tkv import TkvStorage

            self.storage = TkvStorage(path)
        elif engine in ("remote", "tikv"):
            from ..storage.remote import RemoteStorage

            self.storage = RemoteStorage(path)
        elif engine in ("plog", "sled"):
            from ..storage.plog import PlogStorage

            self.storage = PlogStorage(path)
        else:
            raise CozoError(f"unknown storage engine '{engine}'")
        tx = self.storage.transact(write=True)
        Catalog.init_storage(tx)
        tx.commit()
        # Relation ids come from a process-level counter (reference keeps an
        # AtomicU64 seeded from storage at open, runtime/db.rs:100,607): a
        # per-tx KV read-modify-write would let two concurrent :create calls
        # both read the same NEXT_ID_KEY and share a key range. Seeded from
        # max(NEXT_ID_KEY, catalog ids) so a stale persisted counter (commits
        # can land out of order) can never re-issue a live id.
        self._rel_id_lock = threading.Lock()
        rtx = self.storage.transact(write=False)
        try:
            self._next_rel_id = Catalog.max_allocated_id(rtx) + 1
        finally:
            rtx.abort()

        from ..fixed_rule import DEFAULT_FIXED_RULES

        self.fixed_rules: Dict[str, Any] = dict(DEFAULT_FIXED_RULES)
        self._cb_lock = threading.Lock()
        self._cb_next_id = 0
        self._callbacks: Dict[int, Tuple[str, Callable]] = {}
        self._cb_targets: Set[str] = set()
        self._running_lock = threading.Lock()
        self._running_next_id = 0
        self._running: Dict[int, dict] = {}
        self._rel_locks: Dict[str, threading.RLock] = {}
        self._rel_locks_guard = threading.Lock()
        self.algo_cache: Dict[str, Any] = {}
        self._handle_cache: Dict[str, Any] = {}
        # script-text → parsed template (params deferred) | None (uncacheable)
        self._plan_cache: Dict[str, Any] = {}
        self._plan_cache_max = 256
        # script-text → PointPlan for single-atom retrievals (query/fastpath)
        self._fast_plans: Dict[str, Any] = {}
        # relation name → mutation counter (invalidates staged-graph caches)
        self._rel_versions: Dict[str, int] = {}
        # (name, version, undirected) → staged CSR for whole-graph rules
        self._csr_cache: Dict[tuple, tuple] = {}

    # ------------------------------------------------------------------ public

    def run_script(
        self,
        payload: str,
        params: Optional[Dict[str, Any]] = None,
        immutable: bool = False,
    ) -> NamedRows:
        return self._run_script(payload, params, immutable, list)

    def _run_script(self, payload: str, params: Optional[Dict[str, Any]],
                    immutable: bool, row) -> NamedRows:
        """`run_script` with a query's answer rows made by `row` (list, or
        tuple for an answer that is only serialised)."""
        cur_vld = current_validity_ts()
        fast = self._fast_plans.get(payload)
        if fast is None and payload not in self._plan_cache:
            # first sighting: template-parse (also installs the fast plan)
            prog0 = self._parse_cached(payload, params or {})
            fast = self._fast_plans.get(payload)
            if fast is None and prog0 is not None:
                return self._execute_single(prog0, cur_vld, immutable, row)
        if fast is not None:
            from ..query import fastpath

            res = fastpath.execute(fast, self, params or {}, cur_vld, immutable)
            if res is not fastpath.MISS:
                return res
        prog = self._parse_cached(payload, params or {})
        if prog is not None:
            return self._execute_single(prog, cur_vld, immutable, row)
        script = parse_script(payload, params or {})
        if isinstance(script, A.SysScript):
            return self.run_sys_op(script.op, immutable)
        if isinstance(script, A.ImperativeScript):
            return self._execute_imperative(script, cur_vld, immutable)
        return self._execute_single(script.prog, cur_vld, immutable, row)

    def _parse_cached(self, payload: str, params: Dict[str, Any]):
        """Template cache: parse query scripts once with deferred params,
        clone + substitute per execution (see query/template.py)."""
        from ..query.template import NotTemplatable, instantiate

        entry = self._plan_cache.get(payload)
        if entry is None and payload not in self._plan_cache:
            entry = None
            try:
                t = parse_script(payload, defer_params=True)
                if isinstance(t, A.QueryScript):
                    instantiate(t.prog, None) if "$" not in payload else None
                    entry = t.prog
            except (CozoError, NotTemplatable):
                entry = None
            if len(self._plan_cache) >= self._plan_cache_max:
                old = next(iter(self._plan_cache))
                self._plan_cache.pop(old)
                self._fast_plans.pop(old, None)
            self._plan_cache[payload] = entry
            if entry is not None:
                from ..query import fastpath

                plan = fastpath.analyze(entry)
                if plan is not None:
                    self._fast_plans[payload] = plan
        if entry is None:
            return None
        try:
            return instantiate(entry, params)
        except NotTemplatable:
            self._plan_cache[payload] = None
            return None

    def run_script_json(self, payload: str, params_json: str = "{}") -> str:
        """String-in/string-out convenience (reference `lib.rs:244` adds
        ok/took folding)."""
        start = _time.time()
        try:
            params = _json.loads(params_json) if params_json else {}
            res = self._run_script(payload, params, False, tuple)
            d = res.to_dict(tuple)
            d["ok"] = True
            d["took"] = _time.time() - start
            return _json.dumps(d)
        except CozoError as e:
            return _json.dumps(
                {"ok": False, "message": e.message, "code": e.code, "display": str(e)}
            )
        except Exception as e:  # noqa: BLE001
            return _json.dumps({"ok": False, "message": str(e), "code": "unexpected"})

    def close(self) -> None:
        self.storage.close()

    # --------------------------------------------------------------- callbacks

    def register_callback(self, relation: str, callback: Callable) -> int:
        with self._cb_lock:
            self._cb_next_id += 1
            self._callbacks[self._cb_next_id] = (relation, callback)
            self._cb_targets = {rel for rel, _ in self._callbacks.values()}
            return self._cb_next_id

    def unregister_callback(self, cb_id: int) -> bool:
        with self._cb_lock:
            removed = self._callbacks.pop(cb_id, None) is not None
            self._cb_targets = {rel for rel, _ in self._callbacks.values()}
            return removed

    def _callback_targets(self) -> Set[str]:
        return self._cb_targets

    def _send_callbacks(self, collector: Dict[str, list]) -> None:
        if not collector:
            return
        with self._cb_lock:
            cbs = list(self._callbacks.values())
        for rel, events in collector.items():
            for op, new_rows, old_rows in events:
                for target_rel, fn in cbs:
                    if target_rel == rel:
                        try:
                            fn(op, rel, new_rows, old_rows)
                        except Exception:  # noqa: BLE001
                            pass

    # ------------------------------------------------------------- fixed rules

    def register_fixed_rule(self, name: str, rule) -> None:
        if name in self.fixed_rules:
            raise QueryError(f"fixed rule '{name}' already registered")
        self.fixed_rules[name] = rule

    def unregister_fixed_rule(self, name: str) -> bool:
        from ..fixed_rule import DEFAULT_FIXED_RULES

        if name in DEFAULT_FIXED_RULES:
            raise QueryError(f"cannot unregister builtin fixed rule '{name}'")
        return self.fixed_rules.pop(name, None) is not None

    # ------------------------------------------------------------------- locks

    def _lock_for(self, name: str) -> threading.RLock:
        with self._rel_locks_guard:
            lk = self._rel_locks.get(name)
            if lk is None:
                lk = threading.RLock()
                self._rel_locks[name] = lk
            return lk

    # -------------------------------------------------------------- query path

    def _alloc_rel_id(self) -> int:
        with self._rel_id_lock:
            rid = self._next_rel_id
            self._next_rel_id += 1
            return rid

    def _new_session(self, write: bool, cur_vld: int) -> SessionTx:
        return SessionTx(
            self.storage.transact(write=write),
            MemStorage,  # lazily constructed on first `_rel` access
            cur_vld,
            handle_cache=self._handle_cache,
            rel_id_alloc=self._alloc_rel_id,
            db=self,
        )

    def _register_running(self, poison: Poison, payload: str) -> int:
        with self._running_lock:
            self._running_next_id += 1
            self._running[self._running_next_id] = {
                "poison": poison,
                "started_at": _time.time(),
                "payload": payload,
            }
            return self._running_next_id

    def _unregister_running(self, qid: int) -> None:
        with self._running_lock:
            self._running.pop(qid, None)

    def _execute_single(
        self, prog: InputProgram, cur_vld: int, immutable: bool, row=list
    ) -> NamedRows:
        write = prog.out_opts.store_relation is not None
        if write and immutable:
            raise QueryError("attempting to write in read-only mode")
        locks: List[threading.RLock] = []
        if write:
            locks.append(self._lock_for(prog.out_opts.store_relation.name))
        for lk in locks:
            lk.acquire()
        poison = Poison()
        qid = self._register_running(poison, "<query>")
        tx = self._new_session(write, cur_vld)
        cb_targets = self._callback_targets()
        collector: Dict[str, list] = {}
        try:
            res = self._run_query_program(
                tx, prog, cur_vld, cb_targets, collector, True, poison, row
            )
            tx.commit()
            self._send_callbacks(collector)
            return res
        except BaseException:
            tx.abort()
            # index caches may have been mutated inside the aborted tx
            self.algo_cache.clear()
            self._csr_cache.clear()
            raise
        finally:
            self._unregister_running(qid)
            for lk in locks:
                lk.release()

    def _run_query_program(
        self,
        tx: SessionTx,
        prog: InputProgram,
        cur_vld: int,
        callback_targets: Set[str],
        callback_collector: Dict[str, list],
        propagate_triggers: bool,
        poison: Optional[Poison] = None,
        row=list,
    ) -> NamedRows:
        """`row` makes each answer row (list, or tuple where the answer is
        only serialised); rows a mutation writes are lists."""
        opts = prog.out_opts
        if opts.store_relation is not None:
            row = list
        if poison is None:
            poison = Poison()
        if opts.timeout is not None:
            poison.set_timeout(opts.timeout)

        limited = False
        if not prog.rules:
            if opts.store_relation is None:
                raise QueryError("no entry to query: the query is empty")
            headers = (
                [c.name for c in opts.store_relation.schema.keys]
                + [c.name for c in opts.store_relation.schema.values]
                if opts.store_relation.schema
                else []
            )
            rows: List[list] = []
        else:
            if "?" not in prog.rules:
                raise QueryError("entry rule '?' not found", code="eval::no_entry")
            const_rows = self._try_const_entry(prog)
            if const_rows is not None:
                # single const entry rule: materialize directly (the general
                # pipeline costs ~150µs of normalize/stratify/eval per write)
                rows = const_rows
                headers = self._entry_headers(prog)
                return self._query_epilogue(
                    tx, prog, rows, headers, cur_vld, callback_targets,
                    callback_collector, propagate_triggers,
                )
            nf = normalize_program(prog)
            if not opts.disable_magic_rewrite:
                from ..query.magic import magic_rewrite

                nf = magic_rewrite(nf)
            strata = stratify_program(nf)
            ctx = EvalContext(
                tx,
                self.fixed_rules,
                poison=poison,
                search_compiler=self._compile_search,
                db=self,
            )
            limit_hint = None
            if (
                opts.limit is not None
                and not opts.sorters
                and opts.store_relation is None
            ):
                limit_hint = opts.limit + (opts.offset or 0)
            gct = _gc_timer_if_enabled()
            t_eval = _time.time()
            evaluate_strata(strata, ctx, limit_hint)
            t_eval = _time.time() - t_eval
            store = ctx.stores["?"]
            t_sort = None
            if limit_hint is not None and not store.presorted:
                # reference QueryLimiter semantics (query/eval.rs:33-62):
                # without :order, evaluation stops after limit+offset
                # DISTINCT tuples in generation order; :offset drops the
                # first tuples in generation order; output is then sorted
                gen = list(store.total.values())[:limit_hint]
                gen = gen[prog.out_opts.offset or 0:]
                rows = _sort_value_order([row(r) for r in gen])
                rows = rows[: prog.out_opts.limit]
                limited = True
            elif store.presorted:
                # the stored rows themselves where they are `row`s already
                # (a bulk fixed rule's tuples, for the serialised answer)
                rows = list(store.total.values())
                if any(type(r) is not row for r in rows):
                    rows = [row(r) for r in rows]
            else:
                t_sort = _time.time()
                rows = _sort_value_order(
                    [row(r) for r in store.total.values()]
                )
                t_sort = _time.time() - t_sort
            headers = self._entry_headers(prog)
            if gct is not None:
                gct.report(t_eval, t_sort)

        return self._query_epilogue(
            tx, prog, rows, headers, cur_vld, callback_targets,
            callback_collector, propagate_triggers,
            skip_limit_offset=limited,
        )

    def _query_epilogue(
        self, tx, prog, rows, headers, cur_vld, callback_targets,
        callback_collector, propagate_triggers, skip_limit_offset=False,
    ) -> NamedRows:
        """Shared tail: sorters/limit/asserts/sleep + the mutation step."""
        opts = prog.out_opts
        if opts.sorters:
            rows = self._apply_sorters(rows, headers, opts.sorters)
        if not skip_limit_offset:
            if opts.offset:
                rows = rows[opts.offset :]
            if opts.limit is not None:
                rows = rows[: opts.limit]

        if opts.assert_none and rows:
            raise QueryError(
                "assertion failure: query returned some rows",
                code="eval::assert_none_failure",
            )
        if opts.assert_some and not rows:
            raise QueryError(
                "assertion failure: query returned no rows",
                code="eval::assert_some_failure",
            )

        if opts.sleep:
            _time.sleep(opts.sleep)

        if opts.store_relation is not None:
            lock = None
            if not opts.store_relation.name.startswith("_"):
                lock = self._lock_for(opts.store_relation.name)
                lock.acquire()
            try:
                returning = execute_mutation(
                    self,
                    tx,
                    rows,
                    headers,
                    opts.store_relation,
                    cur_vld,
                    callback_targets,
                    callback_collector,
                    propagate_triggers,
                )
            finally:
                if lock is not None:
                    lock.release()
            if opts.returning:
                handle = tx.get_relation(opts.store_relation.name)
                return NamedRows(["_kind"] + handle.col_names(), returning)
            return NamedRows.ok()
        return NamedRows(headers, rows)

    def _try_const_entry(self, prog: InputProgram):
        """Rows for a single constant `?` rule, bypassing normalize/
        stratify/eval — the OLTP write shape (`?[..] <- $rows :put ..`).
        Returns None when not applicable (falls back to the pipeline)."""
        from ..data.expr import Const
        from ..data.program import ConstRule

        if len(prog.rules) != 1:
            return None
        rules = prog.rules.get("?")
        if not rules or len(rules) != 1 or not isinstance(rules[0], ConstRule):
            return None
        r = rules[0]
        data = r.data if isinstance(r.data, Const) else r.data.fold_const()
        if not isinstance(data, Const) or not isinstance(data.val, list):
            return None
        arity = len(r.head)
        rows = []
        for row in data.val:
            if not isinstance(row, (list, tuple)) or len(row) != arity:
                return None  # canonical error from the general path
            rows.append(list(row))
        if len(rows) > 1:
            # set semantics + memo output order
            dedup = {}
            for row in rows:
                dedup[tuple(cmp_key(v) for v in row)] = row
            rows = [row for _, row in sorted(dedup.items())]
        return rows

    @staticmethod
    def _entry_headers(prog: InputProgram) -> List[str]:
        from ..data.program import ConstRule, FixedRuleApply, InputRule

        entry = prog.rules["?"][-1]
        if isinstance(entry, InputRule):
            out = []
            for v, a in zip(entry.head, entry.aggrs):
                out.append(f"{a.name}({v})" if a is not None else v)
            return out
        if isinstance(entry, (ConstRule, FixedRuleApply)):
            if entry.head:
                return list(entry.head)
        return []

    @staticmethod
    def _apply_sorters(rows, headers, sorters):
        idx = []
        for var, desc in sorters:
            if var not in headers:
                raise QueryError(f"Sort key '{var}' not found")
            idx.append((headers.index(var), desc))

        def cmp(a, b):
            for i, desc in idx:
                ka, kb = cmp_key(a[i]), cmp_key(b[i])
                if ka < kb:
                    return 1 if desc else -1
                if ka > kb:
                    return -1 if desc else 1
            return 0

        return sorted(rows, key=functools.cmp_to_key(cmp))

    # ----------------------------------------------------------- index search

    def _compile_search(self, atom, binding_map, ctx):
        handle = ctx.tx.get_relation(atom.rel)
        meta = handle.indices.get(atom.idx)
        if meta is None:
            raise QueryError(
                f"index '{atom.idx}' not found on relation '{atom.rel}'"
            )
        kind = meta["kind"]
        if kind == "hnsw":
            from .hnsw import compile_hnsw_search

            return compile_hnsw_search(self, atom, binding_map, ctx, handle, meta)
        if kind == "fts":
            from ..fts.indexing import compile_fts_search

            return compile_fts_search(self, atom, binding_map, ctx, handle, meta)
        if kind == "lsh":
            from .minhash_lsh import compile_lsh_search

            return compile_lsh_search(self, atom, binding_map, ctx, handle, meta)
        raise QueryError(f"index '{atom.idx}' of kind {kind} cannot be searched")

    # ------------------------------------------------------------- imperative

    def _execute_imperative(
        self, script: A.ImperativeScript, cur_vld: int, immutable: bool
    ) -> NamedRows:
        from .imperative import execute_imperative

        return execute_imperative(self, script, cur_vld, immutable)

    # ----------------------------------------------------------------- sys ops

    def run_sys_op(self, op: A.SysOp, immutable: bool = False) -> NamedRows:
        from . import sysops

        return sysops.run_sys_op(self, op, immutable)

    # --------------------------------------------------------- export / import

    def export_relations(self, relations: List[str]) -> Dict[str, dict]:
        cur_vld = current_validity_ts()
        tx = self._new_session(False, cur_vld)
        try:
            out = {}
            for name in relations:
                handle = tx.get_relation(name)
                handle.ensure_can_read()
                rows = [
                    [to_json(v) for v in r]
                    for r in handle.scan_all(tx.store_tx_for(handle))
                ]
                out[name] = {"headers": handle.col_names(), "rows": rows}
            return out
        finally:
            tx.abort()

    def import_relations(self, data: Dict[str, dict]) -> None:
        from ..data.value import from_json

        cur_vld = current_validity_ts()
        tx = self._new_session(True, cur_vld)
        try:
            for name, content in data.items():
                self._rel_versions[name] = self._rel_versions.get(name, 0) + 1
                self._csr_cache.clear()
                handle = tx.get_relation(name, for_update=True)
                if ACCESS_LEVELS[handle.access_level] < ACCESS_LEVELS["protected"]:
                    raise StoredRelationError(
                        f"cannot import into relation '{name}' with access level "
                        f"{handle.access_level}"
                    )
                headers = content.get("headers") or handle.col_names()
                store_tx = tx.store_tx_for(handle)
                cols = handle.col_names()
                pos = []
                for c in cols:
                    if c not in headers:
                        raise QueryError(
                            f"required column '{c}' not found in import data"
                        )
                    pos.append(headers.index(c))
                from ..runtime.indexing import update_indexes_on_put

                for row_json in content["rows"]:
                    row = [from_json(row_json[p]) for p in pos]
                    row = handle.coerce_row(row)
                    if handle.indices:
                        old = handle.get_row(
                            store_tx, row[: len(handle.keys)]
                        )
                        update_indexes_on_put(self, tx, handle, row, old)
                    store_tx.put(
                        handle.encode_row_key(row), handle.encode_row_val(row)
                    )
            tx.commit()
        except BaseException:
            tx.abort()
            raise

    # ---------------------------------------------------------- backup/restore

    def backup_db(self, path: str) -> None:
        """Stream the full KV range into a fresh SQLite file
        (reference `runtime/db.rs:644-658`)."""
        from ..storage.sqlite import SqliteStorage

        out = SqliteStorage(path)
        try:
            # the backup target is a fresh file: journaling/fsync buy
            # nothing (a crash mid-backup leaves an unusable file either
            # way), and dropping them ~doubles throughput
            out.conn.execute("PRAGMA journal_mode=OFF")
            out.conn.execute("PRAGMA synchronous=OFF")
            tx = self.storage.transact(write=False)
            # fresh file: plain INSERT (no upsert conflict clause) — the
            # source scan yields keys in order, the best case for the
            # WITHOUT ROWID clustered b-tree.  Multi-row VALUES lists cut
            # per-row statement overhead ~3x (ref throughput ~1M rows/s,
            # README.md:144)
            ROWS_PER_STMT = 500
            stmt = "INSERT INTO cozo(k, v) VALUES " + ",".join(
                ["(?,?)"] * ROWS_PER_STMT
            )
            with out.conn:
                buf: list = []
                for k, v in tx.total_scan():
                    buf.append(k)
                    buf.append(v)
                    if len(buf) == 2 * ROWS_PER_STMT:
                        out.conn.execute(stmt, buf)
                        buf.clear()
                if buf:
                    tail = "INSERT INTO cozo(k, v) VALUES " + ",".join(
                        ["(?,?)"] * (len(buf) // 2)
                    )
                    out.conn.execute(tail, buf)
            tx.abort()
        finally:
            out.close()

    def restore_backup(self, path: str) -> None:
        tx = self.storage.transact(write=False)
        has_data = False
        for _ in tx.range_scan(rel_prefix(1), rel_upper(1)):
            has_data = True
            break
        tx.abort()
        if has_data:
            raise CozoError("cannot restore into a non-empty database")
        from ..storage.sqlite import SqliteStorage

        src = SqliteStorage(path)
        try:
            stx = src.transact(write=False)
            self.storage.batch_put(stx.total_scan())
            stx.abort()
        finally:
            src.close()

    def import_from_backup(self, path: str, relations: List[str]) -> None:
        """Copy selected relations from a backup, rewriting key prefixes
        (reference `db.rs:695-758`; refuses relations with indexes)."""
        from ..storage.sqlite import SqliteStorage

        src = SqliteStorage(path)
        cur_vld = current_validity_ts()
        tx = self._new_session(True, cur_vld)
        try:
            stx = src.transact(write=False)
            for name in relations:
                src_handle = Catalog.get(stx, name)
                if src_handle is None:
                    raise QueryError(f"relation '{name}' not found in backup")
                dst_handle = tx.get_relation(name, for_update=True)
                if dst_handle.indices:
                    raise QueryError(
                        f"cannot import into relation '{name}' with indices"
                    )
                store_tx = tx.store_tx_for(dst_handle)
                src_pre, dst_pre = rel_prefix(src_handle.id), rel_prefix(dst_handle.id)
                for k, v in stx.range_scan(src_pre, rel_upper(src_handle.id)):
                    store_tx.put(dst_pre + k[8:], v)
            tx.commit()
        except BaseException:
            tx.abort()
            raise
        finally:
            src.close()

    # ------------------------------------------------------------------- multi

    def multi_transaction(self, write: bool = True) -> "MultiTransaction":
        return MultiTransaction(self, write)


class MultiTransaction:
    """Explicit multi-statement transaction (reference `lib.rs:587`)."""

    def __init__(self, db: Db, write: bool) -> None:
        self.db = db
        self.cur_vld = current_validity_ts()
        self.tx = db._new_session(write, self.cur_vld)
        self.write = write
        self._collector: Dict[str, list] = {}

    def run_script(self, payload: str, params: Optional[dict] = None) -> NamedRows:
        script = parse_script(payload, params or {})
        if isinstance(script, A.SysScript):
            raise QueryError("system scripts are not allowed in multi-transactions")
        if isinstance(script, A.ImperativeScript):
            raise QueryError("imperative scripts are not allowed in multi-transactions")
        return self.db._run_query_program(
            self.tx,
            script.prog,
            self.cur_vld,
            self.db._callback_targets(),
            self._collector,
            True,
        )

    def commit(self) -> None:
        self.tx.commit()
        self.db._send_callbacks(self._collector)

    def abort(self) -> None:
        self.tx.abort()
        self.db.algo_cache.clear()
        self.db._csr_cache.clear()
