"""System-op execution (reference `runtime/db.rs:1192-1443`; counterpart
of `cozo_tpu/runtime/sysops.py`)."""

from __future__ import annotations

import time as _time
from typing import Any, Dict, List

from ..data.functions import current_validity_ts
from ..parse import ast as A
from ..query.stored import create_relation, destroy_relation
from ..utils.errors import CozoError, QueryError, StoredRelationError
from .relation import ACCESS_LEVELS, Catalog, RelationHandle, rel_prefix, rel_upper


def run_sys_op(db, op: A.SysOp, immutable: bool = False):
    from .db import NamedRows

    kind = op.kind
    p = op.payload
    cur_vld = current_validity_ts()
    if kind in ("remove_relations", "rename_relations", "restore"):
        db._csr_cache.clear()
        db._rel_versions.clear()

    if kind == "compact":
        db.storage.range_compact(b"", b"\xff" * 9)
        return NamedRows.ok()

    if kind == "list_fixed_rules":
        return NamedRows("rule", [[name] for name in sorted(db.fixed_rules)])

    if kind == "running":
        with db._running_lock:
            rows = [
                [qid, _time.time() - info["started_at"]]
                for qid, info in db._running.items()
            ]
        return NamedRows(["id", "started_at"], rows)

    if kind == "fallbacks":
        from ..utils import fallback

        firsts = fallback.first_errors()
        rows = [
            [site, n, firsts.get(site, "")]
            for site, n in sorted(fallback.counts().items())
        ]
        return NamedRows(["site", "count", "first_error"], rows)

    if kind == "kill":
        qid = p["id"]
        with db._running_lock:
            info = db._running.get(qid)
            if info is not None:
                info["poison"].killed = True
        return NamedRows.ok()

    if kind == "explain":
        from ..query.normalize import normalize_program
        from ..query.stratify import stratify_program

        nf = normalize_program(p["prog"])
        if not p["prog"].out_opts.disable_magic_rewrite:
            from ..query.magic import magic_rewrite

            nf = magic_rewrite(nf)
        strata = stratify_program(nf)
        rows = []
        for i, stratum in enumerate(strata):
            for name, rs in stratum.items():
                from ..query.normalize import ConstantRuleSet, FixedRuleSet

                if isinstance(rs, ConstantRuleSet):
                    rows.append([i, name, 0, "constant", f"{len(rs.rows)} rows"])
                elif isinstance(rs, FixedRuleSet):
                    rows.append([i, name, 0, "fixed", rs.apply.fixed_name])
                else:
                    for j, rule in enumerate(rs.rules):
                        atoms = ", ".join(type(a).__name__ for a in rule.body)
                        rows.append([i, name, j, "rule", atoms])
        return NamedRows(
            ["stratum", "rule", "clause", "kind", "detail"], rows
        )

    if kind == "list_relations":
        tx = db._new_session(False, cur_vld)
        try:
            rows = []
            for h in Catalog.list_all(tx.store_tx):
                if ":" in h.name:
                    continue
                rows.append(
                    [
                        h.name,
                        h.arity,
                        h.access_level,
                        len(h.keys),
                        len(h.values),
                        len(h.put_triggers),
                        len(h.rm_triggers),
                        len(h.replace_triggers),
                        h.description,
                    ]
                )
            rows.sort(key=lambda r: r[0])
            return NamedRows(
                [
                    "name",
                    "arity",
                    "access_level",
                    "n_keys",
                    "n_non_keys",
                    "n_put_triggers",
                    "n_rm_triggers",
                    "n_replace_triggers",
                    "description",
                ],
                rows,
            )
        finally:
            tx.abort()

    if kind == "list_columns":
        tx = db._new_session(False, cur_vld)
        try:
            h = tx.get_relation(p["rel"])
            rows = []
            for i, c in enumerate(h.keys):
                rows.append(
                    [
                        c.name,
                        True,
                        i,
                        c.typing.display() if c.typing else "Any?",
                        c.default_src is not None,
                    ]
                )
            for i, c in enumerate(h.values):
                rows.append(
                    [
                        c.name,
                        False,
                        i,
                        c.typing.display() if c.typing else "Any?",
                        c.default_src is not None,
                    ]
                )
            return NamedRows(
                ["column", "is_key", "index", "type", "has_default"], rows
            )
        finally:
            tx.abort()

    if kind == "list_indices":
        tx = db._new_session(False, cur_vld)
        try:
            h = tx.get_relation(p["rel"])
            rows = []
            for name, meta in sorted(h.indices.items()):
                rows.append([name, meta["kind"], str(meta.get("config", meta))])
            return NamedRows(["name", "type", "config"], rows)
        finally:
            tx.abort()

    if kind == "describe":
        tx = db._new_session(True, cur_vld)
        try:
            h = tx.get_relation(p["rel"], for_update=True)
            h.description = p["text"]
            tx.put_relation_meta(h)
            tx.commit()
            return NamedRows.ok()
        except BaseException:
            tx.abort()
            raise

    if kind == "remove_relations":
        tx = db._new_session(True, cur_vld)
        try:
            for rel in p["rels"]:
                destroy_relation(tx, rel)
            tx.commit()
            return NamedRows.ok()
        except BaseException:
            tx.abort()
            raise

    if kind == "rename_relations":
        tx = db._new_session(True, cur_vld)
        try:
            for old, new in p["pairs"]:
                h = tx.get_relation(old, for_update=True)
                if tx.relation_exists(new):
                    raise StoredRelationError(
                        f"stored relation '{new}' conflicts with an existing one"
                    )
                tx.delete_relation_meta(old)
                h.name = new
                tx.put_relation_meta(h)
            tx.commit()
            return NamedRows.ok()
        except BaseException:
            tx.abort()
            raise

    if kind == "access_level":
        tx = db._new_session(True, cur_vld)
        try:
            level = p["level"]
            for rel in p["rels"]:
                h = tx.get_relation(rel, for_update=True)
                h.access_level = level
                tx.put_relation_meta(h)
            tx.commit()
            return NamedRows.ok()
        except BaseException:
            tx.abort()
            raise

    if kind == "show_triggers":
        tx = db._new_session(False, cur_vld)
        try:
            h = tx.get_relation(p["rel"])
            rows = []
            for i, t in enumerate(h.put_triggers):
                rows.append(["put", i, t])
            for i, t in enumerate(h.rm_triggers):
                rows.append(["rm", i, t])
            for i, t in enumerate(h.replace_triggers):
                rows.append(["replace", i, t])
            return NamedRows(["type", "idx", "trigger"], rows)
        finally:
            tx.abort()

    if kind == "set_triggers":
        tx = db._new_session(True, cur_vld)
        try:
            h = tx.get_relation(p["rel"], for_update=True)
            h.put_triggers = p["puts"]
            h.rm_triggers = p["rms"]
            h.replace_triggers = p["replaces"]
            tx.put_relation_meta(h)
            tx.commit()
            return NamedRows.ok()
        except BaseException:
            tx.abort()
            raise

    # index DDL serializes against writers of the base relation (same
    # per-relation lock the mutation executor takes): a `:put` committed
    # mid-backfill would otherwise miss the index (its cached handle
    # predates the index manifest) — the reference gets this from its
    # relation ShardedLocks (runtime/db.rs:831-856)
    if kind == "create_index":
        from .index_ddl import create_normal_index

        with db._lock_for(p["rel"]):
            return create_normal_index(db, p["rel"], p["idx"], p["cols"])

    if kind == "create_hnsw_index":
        from .hnsw import create_hnsw_index

        with db._lock_for(p["config"].base_relation):
            return create_hnsw_index(db, p["config"])

    if kind == "create_fts_index":
        from ..fts.indexing import create_fts_index

        with db._lock_for(p["config"].base_relation):
            return create_fts_index(db, p["config"])

    if kind == "create_lsh_index":
        from .minhash_lsh import create_lsh_index

        with db._lock_for(p["config"].base_relation):
            return create_lsh_index(db, p["config"])

    if kind == "drop_index":
        from .index_ddl import drop_index

        with db._lock_for(p["rel"]):
            return drop_index(db, p["rel"], p["idx"])

    raise QueryError(f"unknown sys op '{kind}'")
