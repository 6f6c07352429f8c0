"""Straight-line fast path for point/prefix lookups.

The general pipeline (normalize → stratify → magic → RA compile →
semi-naive eval, reference `runtime/db.rs:1455-1685`) costs ~300µs of
host work per execution even for `?[v] := *kv{k: $k, v}`.  OLTP point
ops are the reference's headline (>250K read QPS, README.md:141-143),
so single-atom retrievals compile once into a PointPlan: encode key
prefix → KV get/prefix-scan → project, with results identical to the
general path (set semantics, memcmp output order).

A script is fast-pathable when it is a single `?` rule whose body is one
stored-relation atom with a constant/parameter key prefix, every other
column free or constant, no aggregations, and no out-options beyond
limit/offset.  Anything else falls back to the general pipeline; any
runtime surprise (validity relation, unknown column, repeated binding)
returns MISS and re-runs the query through the general path so error
messages and semantics stay canonical."""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from ..data.expr import Apply, Binding, Const, ParamRef
from ..data.memcmp import decode_tuple, encode_tuple
from ..data.program import ConstRule, InputProgram, InputRule, RelationApplyAtom
from ..data.relation_types import coerce_value
from ..data.value import cmp_key, deep_freeze, value_eq
from ..utils.errors import CozoError, QueryError, TransactError

MISS = object()

_NAMED_ROWS = None


def _named_rows():
    # lazy NamedRows class handle: runtime.db imports this module lazily,
    # so a top-level import here would be circular on first touch
    global _NAMED_ROWS
    if _NAMED_ROWS is None:
        from ..runtime.db import NamedRows

        _NAMED_ROWS = NamedRows
    return _NAMED_ROWS


class PointPlan:
    __slots__ = ("rel", "pairs", "head", "limit", "offset", "_compiled")

    def __init__(self, rel: str, pairs, head, limit, offset) -> None:
        self.rel = rel
        self.pairs = pairs  # [(col_name, expr)]
        self.head = head  # [var, ...]
        self.limit = limit
        self.offset = offset
        # (handle, runner) for the full-key point-get shape — see
        # _compile_point: skips all per-call plan re-derivation
        self._compiled = None


class CountPlan:
    __slots__ = ("rel", "pairs", "header")

    def __init__(self, rel: str, pairs, header: str) -> None:
        self.rel = rel
        self.pairs = pairs
        self.header = header


class AggrPlan:
    """Columnar whole-scan aggregation: `?[sum(v), max(v), ...] := *rel{..}`
    over fixed-width (Int/Float/Bool) columns.  Raw key/value bytes are
    collected from the KV scan and decoded column-wise with numpy (memcmp
    encodings of non-nullable Int/Float/Bool are fixed-stride), so a 1.6M-
    row sum costs one array pass instead of 1.6M tuple decodes — the OLAP
    full-scan shape (reference README.md:147, ~1s per 1.6M-row scan)."""

    __slots__ = ("rel", "pairs", "aggrs", "headers")

    def __init__(self, rel, pairs, aggrs, headers) -> None:
        self.rel = rel
        self.pairs = pairs  # [(col_name, expr)] from the atom
        self.aggrs = aggrs  # [(aggr_name, var)]
        self.headers = headers


_AGGR_FAST = {"count", "sum", "mean", "min", "max", "variance", "std_dev",
              "product"}
_FIXED_WIDTH = {"Int": 18, "Float": 10, "Bool": 1}


class MutatePlan:
    """Straight-line executor for the OLTP write shape: a single constant
    `?` rule mutating a plain stored relation (no indexes, triggers,
    callbacks or validity — any of those falls back to the general
    mutation executor in query/stored.py, whose semantics this mirrors
    row for row; reference hot path `runtime/db.rs:1590-1669`)."""

    __slots__ = ("op", "rel", "schema", "head", "rows_tmpl", "rows_param",
                 "_compiled")

    def __init__(self, op, rel, schema, head, rows_tmpl, rows_param) -> None:
        self.op = op
        self.rel = rel
        self.schema = schema
        self.head = head
        self.rows_tmpl = rows_tmpl  # [[Const|ParamRef, ...], ...] or None
        self.rows_param = rows_param  # param name holding rows, or None
        self._compiled = None  # (handle, key_ex, val_ex) cache


def _leaf_row(rowe, arity):
    """Row of leaf exprs from one element of a const-rule list, or None."""
    if isinstance(rowe, Const):
        v = rowe.val
        if not isinstance(v, (list, tuple)) or len(v) != arity:
            return None
        return [Const(x) for x in v]
    if (
        isinstance(rowe, Apply)
        and getattr(rowe.op, "name", None) == "list"
        and len(rowe.args) == arity
        and all(isinstance(a, (Const, ParamRef)) for a in rowe.args)
    ):
        return list(rowe.args)
    return None


def _analyze_mutation(prog: InputProgram):
    oo = prog.out_opts
    sr = oo.store_relation
    if sr.op not in ("put", "insert", "rm", "delete", "update"):
        return None
    if sr.name.startswith("_"):
        return None
    if (
        oo.sorters
        or oo.limit is not None
        or oo.offset is not None
        or oo.timeout is not None
        or oo.sleep is not None
        or oo.assert_none
        or oo.assert_some
        or oo.returning
    ):
        return None
    if set(prog.rules.keys()) != {"?"}:
        return None
    rules = prog.rules["?"]
    if len(rules) != 1 or not isinstance(rules[0], ConstRule):
        return None
    r = rules[0]
    if not r.head:
        return None
    d = r.data
    rows_tmpl = rows_param = None
    if isinstance(d, ParamRef):
        rows_param = d.name
    elif isinstance(d, Const) and isinstance(d.val, (list, tuple)):
        rows_tmpl = [_leaf_row(Const(row), len(r.head)) for row in d.val]
    elif isinstance(d, Apply) and getattr(d.op, "name", None) == "list":
        rows_tmpl = [_leaf_row(rowe, len(r.head)) for rowe in d.args]
    else:
        return None
    if rows_tmpl is not None and any(row is None for row in rows_tmpl):
        return None
    return MutatePlan(sr.op, sr.name, sr.schema, list(r.head), rows_tmpl,
                      rows_param)


def analyze(prog: InputProgram):
    oo = prog.out_opts
    if oo.store_relation is not None:
        return _analyze_mutation(prog)
    if (
        oo.sorters
        or oo.timeout is not None
        or oo.sleep is not None
        or oo.assert_none
        or oo.assert_some
        or oo.returning
    ):
        return None
    if set(prog.rules.keys()) != {"?"}:
        return None
    rules = prog.rules["?"]
    if len(rules) != 1:
        return None
    r = rules[0]
    if not isinstance(r, InputRule):
        return None
    if len(r.body) != 1 or not isinstance(r.body[0], RelationApplyAtom):
        return None
    atom = r.body[0]
    if atom.validity is not None or atom.pairs is None or atom.name.startswith("_"):
        return None
    for _, e in atom.pairs:
        if not isinstance(e, (Const, ParamRef, Binding)):
            return None
    aggrs = [a for a in r.aggrs if a is not None]
    if not aggrs:
        return PointPlan(
            atom.name, list(atom.pairs), list(r.head), oo.limit, oo.offset
        )
    # `?[count(v)] := *rel{...}`: answerable as a key-range count when the
    # bound columns cover every key column (then distinct bodies == rows)
    if (
        len(r.head) == 1
        and len(aggrs) == 1
        and aggrs[0].name == "count"
        and oo.limit is None
        and oo.offset is None
    ):
        return CountPlan(atom.name, list(atom.pairs), f"count({r.head[0]})")
    if (
        len(aggrs) == len(r.head)  # fully aggregated (no group-by keys)
        and all(a.name in _AGGR_FAST and not a.extra_args for a in aggrs)
        and oo.limit is None
        and oo.offset is None
    ):
        return AggrPlan(
            atom.name,
            list(atom.pairs),
            [(a.name, v) for a, v in zip(aggrs, r.head)],
            [f"{a.name}({v})" for a, v in zip(aggrs, r.head)],
        )
    return None


def _resolve(e, params: Dict[str, Any]):
    if isinstance(e, Const):
        return e.val
    if e.name not in params:
        raise QueryError(
            f"Required parameter {e.name} not found",
            code="parser::param_not_found",
        )
    return deep_freeze(params[e.name])


def _execute_count(plan: CountPlan, db, params: Dict[str, Any], tx):
    """Key-range count for `?[count(v)] := *rel{..}` shapes, or MISS."""
    NamedRows = _named_rows()
    from ..runtime.relation import encode_key

    handle = db_get_handle(db, tx, plan.rel)
    if handle is None or handle.has_validity() or handle.is_temp:
        return MISS
    if handle.packed_src is not None:
        return MISS  # virtual rows: raw key-range count undercounts
    if handle.access_level not in ("normal", "protected", "read_only"):
        return MISS
    cols = handle.keys + handle.values
    col_idx = {c.name: i for i, c in enumerate(cols)}
    nk = len(handle.keys)
    bound_cols = set()
    seen_vars = set()
    exprs: Dict[int, object] = {}
    for name, e in plan.pairs:
        i = col_idx.get(name)
        if i is None:
            return MISS
        if isinstance(e, Binding):
            if name in bound_cols or e.var in seen_vars:
                return MISS  # repeated var = intra-row equality constraint
            bound_cols.add(name)
            seen_vars.add(e.var)
        else:
            exprs[i] = e
    prefix_vals = []
    for i in range(nk):
        e = exprs.get(i)
        if e is None:
            break
        val = _resolve(e, params)
        typing = cols[i].typing
        if typing is not None:
            try:
                val = coerce_value(val, typing)
            except CozoError:
                return NamedRows([plan.header], [[0]])
        prefix_vals.append(val)
    # const filters beyond the prefix, or key columns not individually
    # bound (distinct bodies could collapse): general path
    if any(i >= len(prefix_vals) for i in exprs):
        return MISS
    for i in range(len(prefix_vals), nk):
        if cols[i].name not in bound_cols:
            return MISS
    lower = encode_key(handle.id, prefix_vals)
    upper = lower + b"\xff" * 8
    n = tx.range_count(lower, upper)
    return NamedRows([plan.header], [[n]])


def _compile_point(plan: PointPlan, handle, key_exprs, head_cols, nk):
    """Specialized runner for `?[v, ...] := *rel{k1: $a, ..., v, ...}`
    (every key column const/param, head projects value columns)."""
    import struct

    NamedRows = _named_rows()
    from ..data.memcmp import encode_value

    prefix = struct.pack(">Q", handle.id)
    head = list(plan.head)
    vpos = [i - nk for i in head_cols]
    limit, offset = plan.limit, plan.offset
    resolvers = []
    for e, c in zip(key_exprs, handle.keys):
        if isinstance(e, Const):
            resolvers.append((None, e.val, c.typing))
        else:  # ParamRef
            resolvers.append((e.name, None, c.typing))

    def run(params, tx):
        buf = bytearray(prefix)
        for pname, cval, typing in resolvers:
            if pname is None:
                val = cval
            else:
                if pname not in params:
                    raise QueryError(
                        f"Required parameter {pname} not found",
                        code="parser::param_not_found",
                    )
                val = deep_freeze(params[pname])
            if typing is not None:
                try:
                    val = coerce_value(val, typing)
                except CozoError:
                    return NamedRows(head, [])  # unmatchable key
            encode_value(buf, val)
        v = tx.get(bytes(buf))
        if v is None:
            return NamedRows(head, [])
        vals = decode_tuple(v) if v else []
        rows = [[vals[p] for p in vpos]]
        if offset:
            rows = rows[offset:]
        if limit is not None:
            rows = rows[:limit]
        return NamedRows(head, rows)

    return run


def _compile_extractors(plan: MutatePlan, handle):
    """(key_ex, val_ex) for this handle, mirroring query/stored.py's
    extractor construction; cached on the plan keyed by handle identity
    (the shared handle cache replaces the object whenever catalog bytes
    change, so identity doubles as a schema-version check)."""
    from .stored import _input_cols, _make_extractor

    comp = plan._compiled
    if comp is not None and comp[0] is handle:
        return comp[1], comp[2]
    key_inputs, val_inputs = _input_cols(plan.schema, plan.head)
    input_cols = key_inputs + val_inputs if val_inputs else key_inputs
    k_src = input_cols if not val_inputs else key_inputs
    v_src = input_cols if not val_inputs else val_inputs
    if plan.op in ("rm", "delete"):
        key_ex = [_make_extractor(c, key_inputs, plan.head) for c in handle.keys]
        val_ex = None
    elif plan.op == "update":
        all_inputs = key_inputs + val_inputs
        input_names = {c for c, _ in all_inputs}
        key_ex = [_make_extractor(c, all_inputs, plan.head) for c in handle.keys]
        val_ex = [
            (True, _make_extractor(c, all_inputs, plan.head))
            if c.name in input_names
            else (False, None)
            for c in handle.values
        ]
    else:
        key_ex = [_make_extractor(c, k_src, plan.head) for c in handle.keys]
        val_ex = [_make_extractor(c, v_src, plan.head) for c in handle.values]
    plan._compiled = (handle, key_ex, val_ex)
    return key_ex, val_ex


def _try_bulk_vector_put(handle, key_ex, val_ex, raw_rows, arity, tx):
    """Vectorized `:put` for the embedding-table shape — single Int key,
    single fixed-dim F32/F64 vector value.  Key and value memcmp
    encodings are one numpy pass over the whole batch instead of ~10
    python/numpy calls per row (measured 2-4x at 768-d), and the
    set-semantics dedup runs on the encoded bytes, whose lexicographic
    order IS the value order (the codec's invariant), picking the same
    winner as the generic cmp_key dedup.  Returns True when the batch
    was written; None -> caller falls back to the generic loop."""
    import numpy as np

    from ..data.memcmp import NUM_TAG, VEC_TAG
    from ..data.value import Vector
    from ..runtime.relation import rel_prefix

    if len(handle.keys) != 1 or len(handle.values) != 1 or arity != 2:
        return None
    kt, vt = handle.keys[0].typing, handle.values[0].typing
    if kt is None or kt.kind != "Int":
        return None
    if (
        vt is None
        or vt.kind != "Vec"
        or vt.vec_eltype not in ("F32", "F64")
        or vt.length is None
        or vt.nullable
    ):
        return None
    if key_ex[0].idx is None or val_ex[0].idx is None:
        return None
    ki, vi = key_ex[0].idx, val_ex[0].idx
    n = len(raw_rows)
    if n == 0:
        return True
    d = vt.length
    f32 = vt.vec_eltype == "F32"
    dt = np.float32 if f32 else np.float64
    try:
        vec_list = []
        for row in raw_rows:
            if not isinstance(row, (list, tuple)) or len(row) != arity:
                return None
            v = row[vi]
            vec_list.append(v.a if type(v) is Vector else v)
        vecs0 = np.stack(vec_list)  # one C loop; raises on ragged input
        if (
            vecs0.ndim != 2
            or vecs0.shape[1] != d
            or not np.issubdtype(vecs0.dtype, np.floating)
        ):
            return None
        vecs = np.ascontiguousarray(vecs0, dtype=dt)
        ids = np.empty(n, dtype=np.int64)
        for i, row in enumerate(raw_rows):
            k = row[ki]
            if type(k) is not int:  # bools/floats: generic coercion path
                return None
            ids[i] = k
    except (OverflowError, TypeError, ValueError):
        return None

    # keys: prefix(8) | NUM_TAG | order-bits(float(id)) | 0x00 | id+2^63
    fb = ids.astype(np.float64).view(np.uint64)
    ob = np.where(fb >> np.uint64(63), ~fb, fb | np.uint64(1 << 63))
    second = ids.view(np.uint64) + np.uint64(1 << 63)  # wrapping add
    keyb = np.empty((n, 26), dtype=np.uint8)
    keyb[:, :8] = np.frombuffer(rel_prefix(handle.id), dtype=np.uint8)
    keyb[:, 8] = NUM_TAG
    keyb[:, 9:17] = ob.astype(">u8").view(np.uint8).reshape(n, 8)
    keyb[:, 17] = 0
    keyb[:, 18:26] = second.astype(">u8").view(np.uint8).reshape(n, 8)

    # values: VEC_TAG | dtype | u32 len | order-bit element bytes
    esz = 4 if f32 else 8
    vw = 6 + d * esz
    valb = np.empty((n, vw), dtype=np.uint8)
    valb[:, 0] = VEC_TAG
    valb[:, 1] = 1 if f32 else 2
    valb[:, 2:6] = np.frombuffer(
        d.to_bytes(4, "big"), dtype=np.uint8
    )
    # order-bit transform (sign set -> ~u, clear -> u|MSB) with one
    # temporary and in-place or/xor/byteswap: flip = asr(u, w-1) | MSB,
    # out = u ^ flip.  The np.where form (5 temporaries over a [n, d]
    # slab) was 60% of bulk-ingest CPU at 768-d.
    if f32:
        u = vecs.view(np.uint32)
        f = (u.view(np.int32) >> np.int32(31)).view(np.uint32)
        np.bitwise_or(f, np.uint32(1 << 31), out=f)
    else:
        u = vecs.view(np.uint64)
        f = (u.view(np.int64) >> np.int64(63)).view(np.uint64)
        np.bitwise_or(f, np.uint64(1 << 63), out=f)
    np.bitwise_xor(u, f, out=f)
    f.byteswap(inplace=True)  # big-endian byte order, lexicographic = value
    valb[:, 6:] = f.view(np.uint8).reshape(n, d * esz)

    # set-semantics dedup: duplicate KEYS are rare in bulk loads, so
    # dedup on the 26-byte keys first; only actual duplicates pay a
    # full-row comparison (winner = lexicographically largest encoded
    # row — identical to the generic cmp_key dedup's last-sorted win)
    order = None
    if n > 1:
        uniq_ids, first, counts = np.unique(
            ids, return_index=True, return_counts=True
        )
        if len(uniq_ids) != n:
            keep = np.ones(n, dtype=bool)
            for j in np.nonzero(counts > 1)[0].tolist():
                cand = np.nonzero(ids == uniq_ids[j])[0]
                rowsb = [
                    keyb[i].tobytes() + valb[i].tobytes() for i in cand
                ]
                win = cand[max(range(len(cand)), key=rowsb.__getitem__)]
                keep[cand] = False
                keep[win] = True
            order = np.nonzero(keep)[0]

    kb, vb = keyb.tobytes(), valb.tobytes()
    idx_iter = range(n) if order is None else order.tolist()
    for i in idx_iter:
        tx.put(kb[i * 26 : (i + 1) * 26], vb[i * vw : (i + 1) * vw])
    return True


def _execute_mutate(plan: MutatePlan, db, params: Dict[str, Any], cur_vld: int,
                    immutable: bool):
    NamedRows = _named_rows()
    if immutable:
        raise QueryError("attempting to write in read-only mode")
    # resolve rows before taking any lock/tx.  Param batches stay RAW
    # here: the bulk vector path encodes them in one numpy pass, and the
    # deep_freeze + cmp_key dedup below (~45% of 768-d ingest time) only
    # runs when the generic per-row loop is actually taken.
    arity = len(plan.head)
    raw_rows = None
    if plan.rows_param is not None:
        data = params.get(plan.rows_param, MISS)
        if data is MISS:
            raise QueryError(
                f"Required parameter {plan.rows_param} not found",
                code="parser::param_not_found",
            )
        if not isinstance(data, (list, tuple)):
            return MISS  # canonical arity/type error from the general path
        raw_rows = data
        rows = None
    else:
        rows = [[_resolve(e, params) for e in rt] for rt in plan.rows_tmpl]

    def _norm_rows():
        out = []
        for row in raw_rows:
            if not isinstance(row, (list, tuple)) or len(row) != arity:
                return None
            out.append([deep_freeze(v) for v in row])
        return out

    def _dedup(rows):
        if len(rows) <= 1:  # set semantics + memo order (_try_const_entry)
            return rows
        dedup = {}
        for row in rows:
            dedup[tuple(cmp_key(v) for v in row)] = row
        return [row for _, row in sorted(dedup.items())]

    if rows is not None:
        rows = _dedup(rows)

    with db._lock_for(plan.rel):
        tx = db.storage.transact(write=True)
        committed = False
        try:
            handle = db_get_handle(db, tx, plan.rel)
            if handle is None or handle.has_validity():
                return MISS
            if handle.indices:
                return MISS
            if plan.op in ("rm", "delete"):
                if handle.rm_triggers:
                    return MISS
            elif handle.put_triggers:
                return MISS
            if plan.rel in db._callback_targets():
                return MISS
            handle.ensure_can_write()
            try:
                key_ex, val_ex = _compile_extractors(plan, handle)
            except QueryError:
                return MISS  # canonical extractor error from the general path
            nk = len(handle.keys)

            if plan.op == "put" and raw_rows is not None:
                done = _try_bulk_vector_put(
                    handle, key_ex, val_ex, raw_rows, arity, tx
                )
                if done:
                    db._rel_versions[plan.rel] = (
                        db._rel_versions.get(plan.rel, 0) + 1
                    )
                    for k in [k for k in db._csr_cache if k[0] == plan.rel]:
                        db._csr_cache.pop(k, None)
                    tx.commit()
                    committed = True
                    return NamedRows.ok()

            if rows is None:
                rows = _norm_rows()
                if rows is None:
                    return MISS  # arity mismatch: canonical general error
                rows = _dedup(rows)

            if plan.op in ("put", "insert"):
                is_insert = plan.op == "insert"
                for row in rows:
                    extracted = [ex.extract(row) for ex in key_ex] + [
                        ex.extract(row) for ex in val_ex
                    ]
                    key = handle.encode_row_key(extracted)
                    if is_insert and tx.exists(key, for_update=True):
                        raise TransactError(
                            f"assertion failure for insert into "
                            f"'{handle.name}': key exists "
                            f"{extracted[:nk]!r}",
                            code="eval::assert_insert_failure",
                        )
                    tx.put(key, handle.encode_row_val(extracted))
            elif plan.op == "update":
                for row in rows:
                    key_vals = [ex.extract(row) for ex in key_ex]
                    key = handle.encode_row_key(key_vals)
                    existing = tx.get(key, for_update=True)
                    if existing is None:
                        raise TransactError(
                            f"assertion failure for update of "
                            f"'{handle.name}': key does not exist "
                            f"{key_vals!r}",
                            code="eval::assert_update_failure",
                        )
                    old_vals = decode_tuple(existing) if existing else []
                    new_row = list(key_vals)
                    for (has, ex), old_v in zip(
                        val_ex, old_vals + [None] * len(val_ex)
                    ):
                        new_row.append(ex.extract(row) if has else old_v)
                    tx.put(key, handle.encode_row_val(new_row))
            else:  # rm / delete
                strict = plan.op == "delete"
                for row in rows:
                    key_vals = [ex.extract(row) for ex in key_ex]
                    key = handle.encode_row_key(key_vals)
                    existing = tx.get(key, for_update=True)
                    if existing is None:
                        if strict:
                            raise TransactError(
                                f"assertion failure for delete from "
                                f"'{handle.name}': key does not exist "
                                f"{key_vals!r}",
                                code="eval::assert_delete_failure",
                            )
                    else:
                        tx.delete(key)

            db._rel_versions[plan.rel] = db._rel_versions.get(plan.rel, 0) + 1
            for k in [k for k in db._csr_cache if k[0] == plan.rel]:
                db._csr_cache.pop(k, None)
            tx.commit()
            committed = True
            return NamedRows.ok()
        finally:
            if not committed:
                tx.abort()


def _execute_aggr(plan: AggrPlan, db, params: Dict[str, Any], tx):
    """Columnar aggregation over one stored-relation scan, or MISS."""
    import numpy as np

    NamedRows = _named_rows()
    from ..data.aggr import AGGR_REGISTRY
    from ..runtime.relation import encode_key

    handle = db_get_handle(db, tx, plan.rel)
    if handle is None or handle.has_validity() or handle.is_temp:
        return MISS
    if handle.packed_src is not None:
        return MISS  # virtual rows: raw KV scan misses the packed base
    if handle.access_level not in ("normal", "protected", "read_only"):
        return MISS
    nk = len(handle.keys)
    cols = handle.keys + handle.values
    col_idx = {c.name: i for i, c in enumerate(cols)}
    bound: Dict[str, int] = {}  # var → column index
    exprs: Dict[int, object] = {}
    bound_cols = set()
    for name, e in plan.pairs:
        i = col_idx.get(name)
        if i is None:
            return MISS
        if isinstance(e, Binding):
            if name in bound_cols or e.var in bound:
                return MISS
            bound_cols.add(name)
            bound[e.var] = i
        else:
            exprs[i] = e
    # aggregated vars must be bound columns (unbound vars are unsafe —
    # the general path raises the canonical error)
    need_cols = []
    for aname, var in plan.aggrs:
        if var not in bound:
            return MISS
        need_cols.append(bound[var])
    # constant/param key prefix (consts beyond it: general path)
    prefix_vals = []
    for i in range(nk):
        e = exprs.get(i)
        if e is None:
            break
        val = _resolve(e, params)
        typing = cols[i].typing
        if typing is not None:
            try:
                val = coerce_value(val, typing)
            except CozoError:
                prefix_vals = None  # unmatchable: aggregate over zero rows
                break
        prefix_vals.append(val)
    if prefix_vals is not None and any(
        i >= len(prefix_vals) for i in exprs
    ):
        return MISS
    # (no distinct-ness guard needed: aggregation inputs are the bag of
    # body matches — one per physical row — in both this path and the
    # general evaluator, matching the reference's semantics)

    def fixed_width(c):
        t = c.typing
        if t is None or t.nullable:
            return None
        return _FIXED_WIDTH.get(t.kind)

    # column layout: a side (key / value) only needs fixed widths when we
    # decode a column from it
    need_key = any(i is not None and i < nk for i in need_cols)
    need_val = any(i is not None and i >= nk for i in need_cols)
    key_w = [fixed_width(c) for c in handle.keys]
    val_w = [fixed_width(c) for c in handle.values]
    if need_key and any(w is None for w in key_w):
        return MISS
    if need_val and any(w is None for w in val_w):
        return MISS
    key_off = [8 + sum(key_w[:i]) for i in range(nk)] if need_key else None
    kstride = 8 + sum(key_w) if need_key else None
    val_off = [sum(val_w[:j]) for j in range(len(val_w))] if need_val else None
    vstride = sum(val_w) if need_val else None

    # numeric column requirement for everything but count
    for (aname, var), ci in zip(plan.aggrs, need_cols):
        if aname == "count":
            continue
        kind = cols[ci].typing.kind
        if kind not in ("Int", "Float"):
            return MISS

    # ---- scan: collect raw bytes
    n = 0
    kchunks = [] if need_key else None
    vchunks = [] if need_val else None
    if prefix_vals is None:
        pass  # unmatchable prefix: zero rows
    else:
        lower = encode_key(handle.id, prefix_vals)
        upper = lower + b"\xff" * 8
        for k, v in tx.range_scan(lower, upper):
            n += 1
            if need_key:
                kchunks.append(k)
            if need_val:
                vchunks.append(v)
    if n == 0:
        out = []
        for aname, var in plan.aggrs:
            out.append(AGGR_REGISTRY[aname].make([]).get())
        return NamedRows(list(plan.headers), [out])
    kbuf = vbuf = None
    if need_key:
        kb = b"".join(kchunks)
        if len(kb) != n * kstride:
            return MISS  # row with unexpected layout: general path
        kbuf = np.frombuffer(kb, dtype=np.uint8).reshape(n, kstride)
    if need_val:
        vb = b"".join(vchunks)
        if len(vb) != n * vstride:
            return MISS
        vbuf = np.frombuffer(vb, dtype=np.uint8).reshape(n, vstride)

    def col_f64(ci):
        """Decode column ci to (float64 array, original-dtype array)."""
        if ci < nk:
            buf, off, kind = kbuf, key_off[ci], handle.keys[ci].typing.kind
        else:
            j = ci - nk
            buf, off, kind = vbuf, val_off[j], handle.values[j].typing.kind
        if kind == "Int":
            raw = buf[:, off + 10 : off + 18].copy().view(">u8")[:, 0]
            iv = (raw.astype(np.uint64) ^ np.uint64(1 << 63)).view(np.int64)
            return iv.astype(np.float64), iv
        # Float: 8 order-bit bytes after the tag
        raw = buf[:, off + 1 : off + 9].copy().view(">u8")[:, 0].astype(np.uint64)
        neg = (raw >> np.uint64(63)) == 0
        bits = np.where(
            neg, ~raw, raw & np.uint64(0x7FFF_FFFF_FFFF_FFFF)
        ).astype(np.uint64)
        fv = bits.view(np.float64)
        return fv, fv

    decoded: Dict[int, tuple] = {}
    out = []
    for (aname, var), ci in zip(plan.aggrs, need_cols):
        if aname == "count":
            out.append(n)
            continue
        if ci not in decoded:
            decoded[ci] = col_f64(ci)
        f64, orig = decoded[ci]
        if np.isnan(f64).any():
            return MISS  # NaN ordering differs per-acc; keep canonical path
        if aname == "sum":
            out.append(float(np.sum(f64)))
        elif aname == "mean":
            out.append(float(np.sum(f64)) / float(n))
        elif aname == "product":
            out.append(float(np.prod(f64)))
        elif aname in ("min", "max"):
            idx = int(np.argmin(f64) if aname == "min" else np.argmax(f64))
            v = orig[idx]
            out.append(int(v) if orig.dtype == np.int64 else float(v))
        else:  # variance / std_dev
            if n <= 1:
                out.append(float("nan"))
            else:
                s = float(np.sum(f64))
                sq = float(np.sum(f64 * f64))
                var = (sq - s * s / n) / (n - 1.0)
                if aname == "variance":
                    out.append(var)
                else:
                    out.append(
                        float(np.sqrt(var)) if var == var and var >= 0
                        else float("nan")
                    )
    return NamedRows(list(plan.headers), [out])


def execute(plan, db, params: Dict[str, Any], cur_vld: int,
            immutable: bool = False):
    """Returns a NamedRows or MISS (caller falls back to the general path)."""
    NamedRows = _named_rows()
    if isinstance(plan, MutatePlan):
        return _execute_mutate(plan, db, params, cur_vld, immutable)
    tx = db.storage.transact(write=False)
    try:
        if isinstance(plan, CountPlan):
            return _execute_count(plan, db, params, tx)
        if isinstance(plan, AggrPlan):
            return _execute_aggr(plan, db, params, tx)
        try:
            handle = db_get_handle(db, tx, plan.rel)
        except CozoError:
            return MISS  # canonical error comes from the general path
        if handle is None or handle.has_validity() or handle.is_temp:
            return MISS
        if handle.access_level not in ("normal", "protected", "read_only"):
            return MISS
        comp = plan._compiled
        if comp is not None and comp[0] is handle:
            return comp[1](params, tx)
        cols = handle.keys + handle.values
        col_idx = {c.name: i for i, c in enumerate(cols)}
        nk = len(handle.keys)
        bind_col: Dict[str, int] = {}
        exprs: List[Optional[object]] = [None] * len(cols)
        for name, e in plan.pairs:
            i = col_idx.get(name)
            if i is None:
                return MISS
            if isinstance(e, Binding):
                if e.var in bind_col:
                    return MISS  # intra-row equality: general path
                bind_col[e.var] = i
            else:
                exprs[i] = e
        for v in plan.head:
            if v not in bind_col:
                return MISS
        head_cols = [bind_col[v] for v in plan.head]

        # full-key point get with value-column projection: compile a
        # runner specialized to this (plan, handle) pair — skips all of
        # the per-call shape re-derivation below
        if (
            handle.packed_src is None  # raw-bytes runner can't see virt rows
            and all(exprs[i] is not None for i in range(nk))
            and all(e is None for e in exprs[nk:])
            and all(i >= nk for i in head_cols)
        ):
            runner = _compile_point(plan, handle, exprs[:nk], head_cols, nk)
            plan._compiled = (handle, runner)
            return runner(params, tx)

        # constant/param key prefix
        prefix_vals = []
        for i in range(nk):
            e = exprs[i]
            if e is None:
                break
            val = _resolve(e, params)
            typing = cols[i].typing
            if typing is not None:
                try:
                    val = coerce_value(val, typing)
                except CozoError:
                    return NamedRows(list(plan.head), [])  # unmatchable key
            prefix_vals.append(val)
        # equality post-filters (consts outside the prefix)
        filters = []
        for i, e in enumerate(exprs):
            if e is not None and i >= len(prefix_vals):
                filters.append((i, _resolve(e, params)))

        if len(prefix_vals) == nk and not filters:
            row = handle.get_row(tx, prefix_vals)
            rows = [] if row is None else [[row[i] for i in head_cols]]
        else:
            rows = []
            limit = plan.limit
            fetch_cap = None
            # without post-filters/dedup-risk, stop the scan at limit+offset
            key_bound = {i for i in range(len(prefix_vals), nk)}
            dedup_free = key_bound <= set(head_cols)
            if limit is not None and not filters and dedup_free:
                fetch_cap = limit + (plan.offset or 0)
            for row in handle.scan_prefix(tx, prefix_vals):
                ok = True
                for i, want in filters:
                    if not value_eq(row[i], want):
                        ok = False
                        break
                if ok:
                    rows.append([row[i] for i in head_cols])
                    if fetch_cap is not None and len(rows) >= fetch_cap:
                        break
            if len(rows) > 1:
                # set semantics + memcmp output order, as the general
                # path's memo store produces
                seen = set()
                uniq = []
                for r_ in rows:
                    kb = encode_tuple(r_)
                    if kb not in seen:
                        seen.add(kb)
                        uniq.append((kb, r_))
                uniq.sort(key=lambda t: t[0])
                rows = [r_ for _, r_ in uniq]
        if plan.offset:
            rows = rows[plan.offset :]
        if plan.limit is not None:
            rows = rows[: plan.limit]
        return NamedRows(list(plan.head), rows)
    finally:
        tx.abort()


def db_get_handle(db, tx, name: str):
    """Handle lookup through the shared raw-validated cache."""
    from ..runtime.relation import Catalog, RelationHandle

    raw = tx.get(Catalog.meta_key(name))
    if raw is None:
        return None
    shared = db._handle_cache
    ent = shared.get(name)
    if ent is not None and ent[0] == raw:
        return ent[1]
    h = RelationHandle.from_json(raw.decode("utf-8"))
    h.is_temp = False
    if h.packed_src is not None:
        from ..runtime.hnsw_packed import PackedHnswBinder

        ps = h.packed_src
        h.virt_binder = PackedHnswBinder(db, ps["base"], ps["idx"])
    shared[name] = (raw, h)
    return h
