"""FTS inverted index: DDL, maintenance, search
(reference `cozo-core/src/fts/indexing.rs`).

Layout: index relation keyed `(token, ...base_keys) => (positions, doc_len)`
— one posting row per (token, document).  Scoring: TF or TF-IDF
(`indexing.rs:231-247`), with per-literal boosters."""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

from ..data.expr import Binding, Const
from ..data.value import cmp_key
from ..parse import ast as A
from ..utils.errors import IndexError_, QueryError
from ..runtime.relation import ColumnDef, RelationHandle, parse_col_type_str
from .ast import (
    FtsAnd,
    FtsLiteral,
    FtsNear,
    FtsNot,
    FtsOr,
    parse_fts_query,
    tokenize_ast,
)
from .tokenizer import TextAnalyzer, build_analyzer

_ANALYZER_CACHE: Dict[str, TextAnalyzer] = {}


def get_analyzer(manifest: dict) -> TextAnalyzer:
    key = repr((manifest["tokenizer"], manifest["filters"]))
    a = _ANALYZER_CACHE.get(key)
    if a is None:
        a = build_analyzer(
            tuple(manifest["tokenizer"]),
            [tuple(f) for f in manifest["filters"]],
        )
        _ANALYZER_CACHE[key] = a
    return a


def _compile_extractor(manifest: dict, handle: RelationHandle):
    src = manifest["extractor"]
    from ..parse.parser import parse_expressions

    expr = parse_expressions(src)
    bmap = {name: i for i, name in enumerate(handle.col_names())}
    expr.fill_binding_indices(bmap)
    return expr


# ------------------------------------------------------------------------ DDL


def create_fts_index(db, cfg: A.FtsIndexConfig):
    from ..runtime.db import NamedRows
    from ..data.functions import current_validity_ts

    tx = db._new_session(True, current_validity_ts())
    try:
        handle = tx.get_relation(cfg.base_relation, for_update=True)
        if cfg.index_name in handle.indices:
            raise IndexError_(
                f"index '{cfg.index_name}' already exists on '{cfg.base_relation}'"
            )
        if not cfg.extractor:
            raise IndexError_("fts index requires 'extractor'")
        idx_id = tx.alloc_rel_id(temp=handle.is_temp)
        idx_keys = [ColumnDef("token", parse_col_type_str("String"), None)]
        for kc in handle.keys:
            idx_keys.append(ColumnDef(f"src_{kc.name}", kc.typing, None))
        idx_handle = RelationHandle(
            id=idx_id,
            name=f"{cfg.base_relation}:{cfg.index_name}",
            keys=idx_keys,
            values=[
                ColumnDef("positions", parse_col_type_str("[Int]"), None),
                ColumnDef("doc_len", parse_col_type_str("Int"), None),
            ],
            is_temp=handle.is_temp,
        )
        tx.put_relation_meta(idx_handle)
        manifest = {
            "extractor": cfg.extractor,
            "tokenizer": list(cfg.tokenizer),
            "filters": [list(f) for f in cfg.filters],
        }
        meta = {"kind": "fts", "rel_ids": [idx_id], "config": manifest}
        handle.indices[cfg.index_name] = meta
        tx.put_relation_meta(handle)
        # back-fill
        extractor = _compile_extractor(manifest, handle)
        analyzer = get_analyzer(manifest)
        store_tx = tx.store_tx_for(handle)
        nk = len(handle.keys)
        for row in handle.scan_all(store_tx):
            _index_doc(tx, idx_handle, analyzer, extractor, row, nk)
        tx.commit()
        return NamedRows.ok()
    except BaseException:
        tx.abort()
        raise


def _extract_text(extractor, row) -> Optional[str]:
    v = extractor.eval(row)
    if v is None:
        return None
    if not isinstance(v, str):
        raise QueryError("FTS extractor must evaluate to a string or null")
    return v


def _index_doc(tx, idx_handle, analyzer, extractor, row, nk) -> None:
    text = _extract_text(extractor, row)
    if not text:
        return
    toks = analyzer.analyze(text)
    postings: Dict[str, List[int]] = {}
    for t in toks:
        postings.setdefault(t.text, []).append(t.position)
    store_tx = tx.store_tx_for(idx_handle)
    doc_len = len(toks)
    for token, positions in postings.items():
        out_row = [token] + row[:nk] + [positions, doc_len]
        store_tx.put(
            idx_handle.encode_row_key(out_row), idx_handle.encode_row_val(out_row)
        )


def _deindex_doc(tx, idx_handle, analyzer, extractor, row, nk) -> None:
    text = _extract_text(extractor, row)
    if not text:
        return
    toks = analyzer.analyze(text)
    store_tx = tx.store_tx_for(idx_handle)
    for token in {t.text for t in toks}:
        key_row = [token] + row[:nk]
        store_tx.delete(idx_handle.encode_row_key(key_row))


# -------------------------------------------------------------- maintenance


def fts_put(db, tx, handle, idx_name, meta, new_row, old_row) -> None:
    manifest = meta["config"]
    idx_handle = tx.get_relation(f"{handle.name}:{idx_name}")
    extractor = _compile_extractor(manifest, handle)
    analyzer = get_analyzer(manifest)
    nk = len(handle.keys)
    if old_row is not None:
        _deindex_doc(tx, idx_handle, analyzer, extractor, old_row, nk)
    _index_doc(tx, idx_handle, analyzer, extractor, new_row, nk)


def fts_remove(db, tx, handle, idx_name, meta, old_row) -> None:
    manifest = meta["config"]
    idx_handle = tx.get_relation(f"{handle.name}:{idx_name}")
    extractor = _compile_extractor(manifest, handle)
    analyzer = get_analyzer(manifest)
    _deindex_doc(tx, idx_handle, analyzer, extractor, old_row, len(handle.keys))


# ------------------------------------------------------------------- search


def _postings_for_token(tx, idx_handle, token: str, nk: int):
    """token → {doc_key_cmp: (key_vals, tf)}"""
    store_tx = tx.store_tx_for(idx_handle)
    out = {}
    for row in idx_handle.scan_prefix(store_tx, [token]):
        key_vals = row[1 : 1 + nk]
        positions = row[1 + nk]
        out[tuple(cmp_key(v) for v in key_vals)] = (key_vals, positions)
    return out


def _postings_for_prefix(tx, idx_handle, prefix: str, nk: int):
    store_tx = tx.store_tx_for(idx_handle)
    from ..data.memcmp import encode_value

    buf = bytearray()
    encode_value(buf, prefix)
    lower = (
        __import__("struct").pack(">Q", idx_handle.id) + bytes(buf)[:-2]
    )  # strip terminator to match any continuation
    upper = lower + b"\xff" * 9
    out: Dict[tuple, Tuple[list, list]] = {}
    for k, v in store_tx.range_scan(lower, upper):
        row = idx_handle.decode_row(k, v)
        if not isinstance(row[0], str) or not row[0].startswith(prefix):
            continue
        key_vals = row[1 : 1 + nk]
        positions = row[1 + nk]
        dk = tuple(cmp_key(x) for x in key_vals)
        if dk in out:
            out[dk][1].extend(positions)
        else:
            out[dk] = (key_vals, list(positions))
    return out


def _eval_fts(node, tx, idx_handle, nk, n_total, score_kind) -> Dict[tuple, Tuple[list, float]]:
    """Evaluate AST → {doc: (key_vals, score)}."""

    def score(tf: float, n_found: int, booster: float) -> float:
        if score_kind == "tf":
            return tf * booster
        idf = math.log(1.0 + (n_total - n_found + 0.5) / (n_found + 0.5))
        return tf * idf * booster

    if isinstance(node, FtsLiteral):
        if not node.value or node.booster == 0.0:
            return {}
        if node.is_prefix:
            postings = _postings_for_prefix(tx, idx_handle, node.value, nk)
        else:
            postings = _postings_for_token(tx, idx_handle, node.value, nk)
        n_found = len(postings)
        return {
            dk: (kv, score(len(pos), n_found, node.booster))
            for dk, (kv, pos) in postings.items()
        }
    if isinstance(node, FtsNear):
        if not node.literals:
            return {}
        maps = [
            _postings_for_token(tx, idx_handle, lit.value, nk)
            for lit in node.literals
        ]
        common = set(maps[0])
        for m in maps[1:]:
            common &= set(m)
        out = {}
        for dk in common:
            pos_lists = [m[dk][1] for m in maps]
            lo = max(min(pl) for pl in pos_lists)
            hi = min(max(pl) for pl in pos_lists)
            # all words within `distance` of each other
            best_span = None
            mins = [min(pl) for pl in pos_lists]
            span = max(mins) - min(mins)
            ok = False
            # simple sliding check: exists a choice of positions within dist
            import itertools as _it

            if all(len(pl) <= 8 for pl in pos_lists):
                for combo in _it.product(*pos_lists):
                    if max(combo) - min(combo) <= node.distance:
                        ok = True
                        break
            else:
                ok = span <= node.distance
            if ok:
                tf = sum(len(pl) for pl in pos_lists) / len(pos_lists)
                booster = sum(l.booster for l in node.literals) / len(node.literals)
                out[dk] = (maps[0][dk][0], score(tf, len(common), booster))
        return out
    if isinstance(node, FtsAnd):
        maps = [
            _eval_fts(x, tx, idx_handle, nk, n_total, score_kind)
            for x in node.items
        ]
        if not maps:
            return {}
        common = set(maps[0])
        for m in maps[1:]:
            common &= set(m)
        return {
            dk: (maps[0][dk][0], sum(m[dk][1] for m in maps)) for dk in common
        }
    if isinstance(node, FtsOr):
        out: Dict[tuple, Tuple[list, float]] = {}
        for x in node.items:
            for dk, (kv, s) in _eval_fts(
                x, tx, idx_handle, nk, n_total, score_kind
            ).items():
                if dk in out:
                    out[dk] = (out[dk][0], out[dk][1] + s)
                else:
                    out[dk] = (kv, s)
        return out
    if isinstance(node, FtsNot):
        lhs = _eval_fts(node.lhs, tx, idx_handle, nk, n_total, score_kind)
        rhs = _eval_fts(node.rhs, tx, idx_handle, nk, n_total, score_kind)
        return {dk: v for dk, v in lhs.items() if dk not in rhs}
    raise QueryError(f"bad FTS node {node!r}")


def fts_search(
    db, tx, handle, idx_name, meta, query: str, k: int, score_kind: str
) -> List[Tuple[list, float]]:
    """Returns [(base_key_vals, score)] sorted by descending score."""
    manifest = meta["config"]
    idx_handle = tx.get_relation(f"{handle.name}:{idx_name}")
    analyzer = get_analyzer(manifest)
    ast = tokenize_ast(parse_fts_query(query), analyzer)
    store_tx = tx.store_tx_for(handle)
    from ..runtime.relation import rel_prefix, rel_upper

    n_total = store_tx.range_count(rel_prefix(handle.id), rel_upper(handle.id))
    results = _eval_fts(ast, tx, idx_handle, len(handle.keys), n_total, score_kind)
    ranked = sorted(results.values(), key=lambda x: -x[1])
    return ranked[:k]


def compile_fts_search(db, atom, binding_map, ctx, handle, meta):
    from ..query.eval import CONST, BOUND, FRESH, Step, _classify_args
    from ..data.value import value_eq

    opts = dict(atom.opts)
    query_expr = opts.pop("query", None)
    if query_expr is None:
        raise QueryError("Field `query` is required for FTS search")
    k_e = opts.pop("k", None)
    if k_e is None:
        raise QueryError("Field `k` is required for FTS search")
    k_e = k_e.fold_const()
    if not isinstance(k_e, Const):
        raise QueryError("option 'k' must be a constant")
    k = int(k_e.val)
    sk = opts.pop("score_kind", None)
    score_kind = "tf_idf"
    if sk is not None:
        sk = sk.fold_const()
        if isinstance(sk, Const) and sk.val in ("tf", "tf_idf"):
            score_kind = sk.val
        elif isinstance(sk, Binding) and sk.var in ("tf", "tf_idf"):
            score_kind = sk.var
        else:
            raise QueryError("score_kind must be 'tf' or 'tf_idf'")
    filter_expr = opts.pop("filter", None)
    bind_score = None
    bs = opts.pop("bind_score", None)
    if bs is not None:
        if not isinstance(bs, Binding):
            raise QueryError("bind_score must be a variable")
        bind_score = bs.var
    if opts:
        raise QueryError(f"Unknown parameters for FTS: {sorted(opts)}")

    query_expr = query_expr.clone()
    query_expr.fill_binding_indices(binding_map)
    cols = handle.col_names()
    by_col = dict(atom.pairs)
    unknown = set(by_col) - set(cols)
    if unknown:
        raise QueryError(f"columns {sorted(unknown)} not found in '{handle.name}'")
    spec = _classify_args([by_col.get(c) for c in cols], binding_map)
    score_pos = None
    if bind_score is not None:
        if bind_score in binding_map:
            raise QueryError(f"binding '{bind_score}' already bound")
        binding_map[bind_score] = len(binding_map)
        score_pos = binding_map[bind_score]
    if filter_expr is not None:
        filter_expr = filter_expr.clone()
        fmap = {c: i for i, c in enumerate(cols)}
        filter_expr.fill_binding_indices(fmap)

    idx_name = atom.idx

    class FtsSearchStep(Step):
        def run(self, envs, ctx2, delta):
            out = []
            post = [(i, kv) for i, kv in enumerate(spec) if kv[0] in (CONST, BOUND)]
            fresh = [(i, p) for i, (kk, p) in enumerate(spec) if kk == FRESH]
            store_tx = ctx2.tx.store_tx_for(handle)
            for env in envs:
                q = query_expr.eval(env)
                if not isinstance(q, str):
                    raise QueryError("FTS query must be a string")
                ranked = fts_search(
                    db, ctx2.tx, handle, idx_name, meta, q, k, score_kind
                )
                for key_vals, s in ranked:
                    row = handle.get_row(store_tx, key_vals)
                    if row is None:
                        continue
                    if filter_expr is not None and filter_expr.eval(row) is not True:
                        continue
                    ok = True
                    for i, (kk, v) in post:
                        want = v if kk == CONST else env[v]
                        if not value_eq(row[i], want):
                            ok = False
                            break
                    if not ok:
                        continue
                    new_env = env + tuple(row[i] for i, _ in fresh)
                    if score_pos is not None:
                        new_env = new_env + (s,)
                    out.append(new_env)
            return out

    return FtsSearchStep()
