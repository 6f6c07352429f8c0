"""Mutation executor: :create/:replace/:put/:insert/:update/:rm/:delete/
:ensure/:ensure_not, with index maintenance, triggers and callback
collection (reference `cozo-core/src/query/stored.rs`).

Binding semantics mirror the reference's extractor mechanism
(`stored.rs:1138-1195`): for each stored column, find the input-schema
column of the same name, then its binding among the result headers;
fall back to the column default; else error.  When the schema spec is
omitted, the entry head vars act as the input schema."""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

from ..data.program import ColSpec, StoreRelation, TableSchema
from ..data.relation_types import ColType, coerce_value
from ..data.value import cmp_key
from ..runtime.relation import ColumnDef, RelationHandle, rel_prefix, rel_upper
from ..runtime.transact import SessionTx
from ..utils.errors import QueryError, StoredRelationError, TransactError


class _Extractor:
    __slots__ = ("idx", "default_expr", "typing")

    def __init__(self, idx, default_expr, typing):
        self.idx = idx
        self.default_expr = default_expr
        self.typing = typing

    def extract(self, row):
        if self.idx is not None:
            v = row[self.idx]
        else:
            v = self.default_expr.eval_env({})
        return coerce_value(v, self.typing)


def _make_extractor(
    stored_col: ColumnDef,
    input_cols: List[Tuple[str, str]],  # (col_name, binding_name)
    headers: List[str],
) -> _Extractor:
    for col_name, binding in input_cols:
        if col_name == stored_col.name:
            if binding in headers:
                return _Extractor(
                    headers.index(binding), None, stored_col.typing
                )
    de = stored_col.default_expr()
    if de is not None:
        return _Extractor(None, de, stored_col.typing)
    raise QueryError(
        f"cannot make extractor for column {stored_col.name}",
        code="eval::unable_to_make_extractor",
    )


def _input_cols(schema: Optional[TableSchema], headers: List[str]):
    """Returns (key_input_cols, val_input_cols) as (name, binding) pairs."""
    if schema is None:
        return [(h, h) for h in headers], []
    def conv(cols: List[ColSpec]):
        out = []
        for c in cols:
            binding = c.gen_binding if c.gen_binding else c.name
            out.append((c.name, binding))
        return out
    return conv(schema.keys), conv(schema.values)


def _schema_to_handle_cols(schema: TableSchema):
    def conv(cols: List[ColSpec]):
        out = []
        for c in cols:
            src = c.default[1] if c.default else None
            out.append(ColumnDef(c.name, c.typing, src))
        return out

    keys = conv(schema.keys)
    vals = conv(schema.values)
    return keys, vals


def create_relation(
    tx: SessionTx, name: str, schema: TableSchema, headers: List[str]
) -> RelationHandle:
    if tx.relation_exists(name):
        raise StoredRelationError(
            f"stored relation '{name}' conflicts with an existing one",
            code="eval::stored_relation_conflict",
        )
    if schema is None:
        keys = [ColumnDef(h, None, None) for h in headers]
        vals: List[ColumnDef] = []
    else:
        keys, vals = _schema_to_handle_cols(schema)
    if not keys:
        raise StoredRelationError(
            f"stored relation '{name}' has no keys", code="parser::relation_has_no_keys"
        )
    rel_id = tx.alloc_rel_id(temp=name.startswith("_"))
    handle = RelationHandle(
        id=rel_id, name=name, keys=keys, values=vals, is_temp=name.startswith("_")
    )
    tx.put_relation_meta(handle)
    return handle


def destroy_relation(tx: SessionTx, name: str) -> None:
    handle = tx.get_relation(name)
    if handle.access_level != "normal":
        raise StoredRelationError(
            f"cannot remove relation '{name}' with access level {handle.access_level}"
        )
    store_tx = tx.store_tx_for(handle)
    ids = [handle.id]
    for idx_name, meta in handle.indices.items():
        ids.extend(meta.get("rel_ids", []))
        if meta.get("kind") == "hnsw":
            from ..runtime.hnsw_packed import drop_packed_image

            drop_packed_image(store_tx, name, idx_name)
        tx.delete_relation_meta(f"{name}:{idx_name}")
    for rid in ids:
        for k, _ in list(store_tx.range_scan(rel_prefix(rid), rel_upper(rid))):
            store_tx.delete(k)
    tx.delete_relation_meta(name)


def execute_mutation(
    db,
    tx: SessionTx,
    rows: List[list],
    headers: List[str],
    store_rel: StoreRelation,
    cur_vld: int,
    callback_targets,
    callback_collector: Dict[str, list],
    propagate_triggers: bool,
) -> List[list]:
    """Returns the 'returning' rows: [status, *row] tuples."""
    op = store_rel.op
    name = store_rel.name

    replaced_old_triggers = None
    if op == "replace":
        if not propagate_triggers:
            raise QueryError(
                f"replace op in trigger is not allowed: {name}",
                code="eval::replace_in_trigger",
            )
        if tx.relation_exists(name):
            old_handle = tx.get_relation(name)
            if old_handle.access_level != "normal":
                raise StoredRelationError(
                    f"cannot replace relation '{name}' with access level "
                    f"{old_handle.access_level}"
                )
            if old_handle.put_triggers or old_handle.rm_triggers:
                replaced_old_triggers = (
                    old_handle.put_triggers,
                    old_handle.rm_triggers,
                )
            for trigger in old_handle.replace_triggers:
                _run_trigger(db, tx, trigger, [], [], old_handle, cur_vld,
                             callback_targets, callback_collector)
            destroy_relation(tx, name)

    if op in ("create", "replace"):
        handle = create_relation(tx, name, store_rel.schema, headers)
        if replaced_old_triggers:
            handle.put_triggers, handle.rm_triggers = replaced_old_triggers
            tx.put_relation_meta(handle)
    else:
        # the shared raw-validated handle cache is exactly as fresh as a
        # re-deserialization (it compares the stored catalog bytes); row
        # mutations never modify relation meta, so no for_update needed
        handle = tx.get_relation(name)

    # staged-graph caches key on this counter (fixed_payload CSR cache)
    if db is not None and not name.startswith("_"):
        db._rel_versions[name] = db._rel_versions.get(name, 0) + 1
        for k in [k for k in getattr(db, "_csr_cache", {}) if k[0] == name]:
            db._csr_cache.pop(k, None)

    key_inputs, val_inputs = _input_cols(store_rel.schema, headers)

    returning: List[list] = []
    if op in ("rm", "delete"):
        _remove_rows(db, tx, rows, headers, handle, key_inputs, cur_vld,
                     callback_targets, callback_collector, propagate_triggers,
                     strict=(op == "delete"), returning=returning)
    elif op == "ensure":
        _ensure_rows(tx, rows, headers, handle, key_inputs, val_inputs, True)
    elif op == "ensure_not":
        _ensure_rows(tx, rows, headers, handle, key_inputs, val_inputs, False)
    elif op == "update":
        _update_rows(db, tx, rows, headers, handle, key_inputs, val_inputs, cur_vld,
                     callback_targets, callback_collector, propagate_triggers,
                     returning)
    else:  # create/replace/put/insert
        _put_rows(db, tx, rows, headers, handle, key_inputs, val_inputs, cur_vld,
                  callback_targets, callback_collector, propagate_triggers,
                  is_insert=(op == "insert"), returning=returning)
    return returning


def _collect_target(handle, callback_targets) -> bool:
    return handle.name in callback_targets


def _put_rows(db, tx, rows, headers, handle: RelationHandle, key_inputs, val_inputs,
              cur_vld, callback_targets, callback_collector, propagate_triggers,
              is_insert, returning):
    handle.ensure_can_write()
    input_cols = key_inputs + val_inputs if val_inputs else key_inputs
    key_ex = [_make_extractor(c, input_cols if not val_inputs else key_inputs, headers)
              for c in handle.keys]
    val_ex = [_make_extractor(c, input_cols if not val_inputs else val_inputs, headers)
              for c in handle.values]
    store_tx = tx.store_tx_for(handle)
    is_cb = _collect_target(handle, callback_targets)
    need_collect = not handle.is_temp and (
        is_cb or (propagate_triggers and handle.put_triggers)
    )
    has_indices = bool(handle.indices)
    new_tuples, old_tuples = [], []
    from ..data.memcmp import decode_tuple
    from ..runtime.indexing import update_indexes_on_put

    for row in rows:
        extracted = [ex.extract(row) for ex in key_ex] + [ex.extract(row) for ex in val_ex]
        key = handle.encode_row_key(extracted)
        if is_insert and store_tx.exists(key, for_update=True):
            raise TransactError(
                f"assertion failure for insert into '{handle.name}': key exists "
                f"{extracted[:len(handle.keys)]!r}",
                code="eval::assert_insert_failure",
            )
        old_row = None
        if need_collect or has_indices:
            existing = store_tx.get(key)
            if existing is not None:
                old_row = extracted[: len(handle.keys)] + (
                    decode_tuple(existing) if existing else []
                )
                if need_collect:
                    old_tuples.append(old_row)
        if has_indices:
            update_indexes_on_put(db, tx, handle, extracted, old_row)
        if need_collect:
            new_tuples.append(extracted)
        store_tx.put(key, handle.encode_row_val(extracted))
        returning.append(["inserted"] + extracted)
    if new_tuples or old_tuples:
        _collect_mutations(db, tx, handle, new_tuples, old_tuples, "put", cur_vld,
                           callback_targets, callback_collector, propagate_triggers,
                           is_cb)


def _update_rows(db, tx, rows, headers, handle, key_inputs, val_inputs, cur_vld,
                 callback_targets, callback_collector, propagate_triggers, returning):
    handle.ensure_can_write()
    input_cols = key_inputs + val_inputs
    input_names = {c for c, _ in input_cols}
    key_ex = [_make_extractor(c, input_cols, headers) for c in handle.keys]
    val_ex = []
    for c in handle.values:
        if c.name in input_names:
            val_ex.append((True, _make_extractor(c, input_cols, headers)))
        else:
            val_ex.append((False, None))
    store_tx = tx.store_tx_for(handle)
    is_cb = _collect_target(handle, callback_targets)
    need_collect = not handle.is_temp and (
        is_cb or (propagate_triggers and handle.put_triggers)
    )
    has_indices = bool(handle.indices)
    new_tuples, old_tuples = [], []
    from ..data.memcmp import decode_tuple
    from ..runtime.indexing import update_indexes_on_put

    for row in rows:
        key_vals = [ex.extract(row) for ex in key_ex]
        key = handle.encode_row_key(key_vals)
        existing = store_tx.get(key, for_update=True)
        if existing is None:
            raise TransactError(
                f"assertion failure for update of '{handle.name}': "
                f"key does not exist {key_vals!r}",
                code="eval::assert_update_failure",
            )
        old_vals = decode_tuple(existing) if existing else []
        old_row = key_vals + old_vals
        new_row = list(key_vals)
        for (has, ex), old_v in zip(val_ex, old_vals + [None] * len(val_ex)):
            new_row.append(ex.extract(row) if has else old_v)
        if has_indices:
            update_indexes_on_put(db, tx, handle, new_row, old_row)
        if need_collect:
            old_tuples.append(old_row)
            new_tuples.append(new_row)
        store_tx.put(key, handle.encode_row_val(new_row))
        returning.append(["updated"] + new_row)
    if new_tuples:
        _collect_mutations(db, tx, handle, new_tuples, old_tuples, "put", cur_vld,
                           callback_targets, callback_collector, propagate_triggers,
                           is_cb)


def _remove_rows(db, tx, rows, headers, handle, key_inputs, cur_vld,
                 callback_targets, callback_collector, propagate_triggers,
                 strict, returning):
    handle.ensure_can_write()
    key_ex = [_make_extractor(c, key_inputs, headers) for c in handle.keys]
    store_tx = tx.store_tx_for(handle)
    is_cb = _collect_target(handle, callback_targets)
    need_collect = not handle.is_temp and (
        is_cb or (propagate_triggers and handle.rm_triggers)
    )
    has_indices = bool(handle.indices)
    old_tuples, found_keys = [], []
    from ..data.memcmp import decode_tuple
    from ..runtime.indexing import update_indexes_on_remove

    for row in rows:
        key_vals = [ex.extract(row) for ex in key_ex]
        key = handle.encode_row_key(key_vals)
        existing = store_tx.get(key, for_update=True)
        if existing is None:
            if strict:
                raise TransactError(
                    f"assertion failure for delete from '{handle.name}': "
                    f"key does not exist {key_vals!r}",
                    code="eval::assert_delete_failure",
                )
            # rm still records the tombstone row for triggers
            old_row = None
        else:
            old_row = key_vals + (decode_tuple(existing) if existing else [])
        if old_row is not None:
            if has_indices:
                update_indexes_on_remove(db, tx, handle, old_row)
            if need_collect:
                old_tuples.append(old_row)
            store_tx.delete(key)
            returning.append(["deleted"] + old_row)
        found_keys.append(key_vals)
    if old_tuples:
        _collect_mutations(db, tx, handle, [], old_tuples, "rm", cur_vld,
                           callback_targets, callback_collector, propagate_triggers,
                           is_cb)


def _ensure_rows(tx, rows, headers, handle, key_inputs, val_inputs, want_present):
    input_cols = key_inputs + val_inputs if val_inputs else key_inputs
    key_ex = [_make_extractor(c, input_cols if not val_inputs else key_inputs, headers)
              for c in handle.keys]
    store_tx = tx.store_tx_for(handle)
    from ..data.memcmp import decode_tuple

    if want_present:
        val_ex = [
            _make_extractor(c, input_cols if not val_inputs else val_inputs, headers)
            for c in handle.values
        ]
        for row in rows:
            key_vals = [ex.extract(row) for ex in key_ex]
            existing = store_tx.get(handle.encode_row_key(key_vals), for_update=True)
            if existing is None:
                raise TransactError(
                    f"ensure failed for '{handle.name}': row does not exist "
                    f"{key_vals!r}",
                    code="eval::ensure_failure",
                )
            want_vals = [ex.extract(row) for ex in val_ex]
            got_vals = decode_tuple(existing) if existing else []
            if [cmp_key(v) for v in want_vals] != [cmp_key(v) for v in got_vals]:
                raise TransactError(
                    f"ensure failed for '{handle.name}': values differ for "
                    f"{key_vals!r}: {want_vals!r} vs {got_vals!r}",
                    code="eval::ensure_failure",
                )
    else:
        for row in rows:
            key_vals = [ex.extract(row) for ex in key_ex]
            if store_tx.exists(handle.encode_row_key(key_vals), for_update=True):
                raise TransactError(
                    f"ensure_not failed for '{handle.name}': row exists "
                    f"{key_vals!r}",
                    code="eval::ensure_failure",
                )


def _run_trigger(db, tx, trigger_src, new_tuples, old_tuples, handle, cur_vld,
                 callback_targets, callback_collector):
    from ..parse.parser import parse_script
    from ..parse.ast import QueryScript
    from ..data.program import ConstRule
    from ..data.expr import Const

    script = parse_script(trigger_src)
    if not isinstance(script, QueryScript):
        raise QueryError("trigger must be a single query")
    prog = script.prog
    cols = handle.col_names()
    prog.rules["_new"] = [ConstRule(list(cols), Const([list(r) for r in new_tuples]))]
    prog.rules["_old"] = [ConstRule(list(cols), Const([list(r) for r in old_tuples]))]
    db._run_query_program(
        tx,
        prog,
        cur_vld,
        callback_targets,
        callback_collector,
        propagate_triggers=False,
    )


def _collect_mutations(db, tx, handle, new_tuples, old_tuples, kind, cur_vld,
                       callback_targets, callback_collector, propagate_triggers,
                       is_cb):
    if propagate_triggers:
        triggers = handle.put_triggers if kind == "put" else handle.rm_triggers
        for trigger in triggers:
            _run_trigger(db, tx, trigger, new_tuples, old_tuples, handle, cur_vld,
                         callback_targets, callback_collector)
    if is_cb:
        callback_collector.setdefault(handle.name, []).append(
            (
                "Put" if kind == "put" else "Rm",
                [list(r) for r in (new_tuples if kind == "put" else old_tuples)],
                [list(r) for r in (old_tuples if kind == "put" else [])],
            )
        )
