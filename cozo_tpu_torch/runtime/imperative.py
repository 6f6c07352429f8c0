"""Imperative script runtime (reference `runtime/imperative.rs`):
%if/%loop/%break/%continue/%return/%swap/%debug over one transaction."""

from __future__ import annotations

from typing import Any, List, Optional, Tuple

from ..parse import ast as A
from ..utils.errors import CozoError, QueryError
from .relation import ColumnDef, RelationHandle


class _Break(Exception):
    def __init__(self, label):
        self.label = label


class _Continue(Exception):
    def __init__(self, label):
        self.label = label


class _Return(Exception):
    def __init__(self, result):
        self.result = result


def execute_imperative(db, script: A.ImperativeScript, cur_vld: int, immutable: bool):
    from .db import NamedRows, Poison

    poison = Poison()
    tx = db._new_session(not immutable, cur_vld)
    cb_targets = db._callback_targets()
    collector: dict = {}
    try:
        try:
            ret = _exec_block(
                db, tx, script.stmts, cur_vld, cb_targets, collector, poison
            )
        except _Return as r:
            ret = r.result
        except (_Break, _Continue):
            raise QueryError("break/continue outside loop")
        tx.commit()
        db._send_callbacks(collector)
        return ret if ret is not None else NamedRows.ok()
    except BaseException:
        tx.abort()
        raise


def _rel_as_named_rows(db, tx, name: str):
    from .db import NamedRows

    handle = tx.get_relation(name)
    rows = [list(r) for r in handle.scan_all(tx.store_tx_for(handle))]
    return NamedRows(handle.col_names(), rows)


def _store_as(db, tx, name: str, res, cur_vld: int) -> None:
    """Store a NamedRows result as a temp relation (replace semantics)."""
    from ..query.stored import create_relation

    if tx.relation_exists(name):
        from ..query.stored import destroy_relation

        destroy_relation(tx, name)
    headers = res.headers or [f"_{i}" for i in range(len(res.rows[0]) if res.rows else 0)]
    handle = create_relation(tx, name, None, headers)
    store_tx = tx.store_tx_for(handle)
    for row in res.rows:
        store_tx.put(handle.encode_row_key(row), handle.encode_row_val(row))


def _exec_clause(db, tx, clause, cur_vld, cb_targets, collector, poison):
    if isinstance(clause, A.ImperativeSysOp):
        res = db.run_sys_op(clause.op)
        if clause.store_as:
            _store_as(db, tx, clause.store_as, res, cur_vld)
        return res
    res = db._run_query_program(
        tx, clause.prog, cur_vld, cb_targets, collector, True, poison
    )
    if clause.store_as:
        _store_as(db, tx, clause.store_as, res, cur_vld)
    return res


def _exec_block(db, tx, stmts, cur_vld, cb_targets, collector, poison):
    from .db import NamedRows

    ret = None
    for stmt in stmts:
        poison.check()
        if isinstance(stmt, (A.ImperativeQuery, A.ImperativeSysOp)):
            ret = _exec_clause(db, tx, stmt, cur_vld, cb_targets, collector, poison)
        elif isinstance(stmt, A.ImperativeIgnoreError):
            try:
                ret = _exec_clause(
                    db, tx, stmt.clause, cur_vld, cb_targets, collector, poison
                )
            except CozoError:
                ret = NamedRows(["status"], [["FAILED"]])
        elif isinstance(stmt, A.ImperativeIf):
            cond = stmt.condition
            if isinstance(cond, str):
                res = _rel_as_named_rows(db, tx, cond)
            else:
                res = _exec_clause(
                    db, tx, cond, cur_vld, cb_targets, collector, poison
                )
            truth = bool(res.rows)
            if stmt.negated:
                truth = not truth
            branch = stmt.then_branch if truth else stmt.else_branch
            if branch:
                ret = _exec_block(
                    db, tx, branch, cur_vld, cb_targets, collector, poison
                )
        elif isinstance(stmt, A.ImperativeLoop):
            while True:
                poison.check()
                try:
                    ret = _exec_block(
                        db, tx, stmt.body, cur_vld, cb_targets, collector, poison
                    )
                except _Break as b:
                    if b.label is None or b.label == stmt.label:
                        break
                    raise
                except _Continue as c:
                    if c.label is None or c.label == stmt.label:
                        continue
                    raise
        elif isinstance(stmt, A.ImperativeBreak):
            raise _Break(stmt.label)
        elif isinstance(stmt, A.ImperativeContinue):
            raise _Continue(stmt.label)
        elif isinstance(stmt, A.ImperativeReturn):
            if not stmt.values:
                raise _Return(NamedRows([], []))
            results = []
            for v in stmt.values:
                if isinstance(v, str):
                    results.append(_rel_as_named_rows(db, tx, v))
                else:
                    results.append(
                        _exec_clause(
                            db, tx, v, cur_vld, cb_targets, collector, poison
                        )
                    )
            for i in range(len(results) - 1, 0, -1):
                results[i - 1].next = results[i]
            raise _Return(results[0])
        elif isinstance(stmt, A.ImperativeSwap):
            h1 = tx.get_relation(stmt.left, for_update=True)
            h2 = tx.get_relation(stmt.right, for_update=True)
            h1.name, h2.name = h2.name, h1.name
            tx.delete_relation_meta(stmt.left)
            tx.delete_relation_meta(stmt.right)
            tx.put_relation_meta(h1)
            tx.put_relation_meta(h2)
            tx.invalidate_cache()
            ret = NamedRows.ok()
        elif isinstance(stmt, A.ImperativeDebug):
            res = _rel_as_named_rows(db, tx, stmt.name)
            print(f"{stmt.name}: {res.headers} {res.rows!r}")
            ret = NamedRows([], [])
        else:
            raise QueryError(f"unknown imperative statement {stmt!r}")
    return ret
