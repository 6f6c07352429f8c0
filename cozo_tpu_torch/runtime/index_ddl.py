"""Normal (lateral covering) index DDL: create with back-fill, drop
(reference `runtime/relation.rs:1232` create_index, index removal)."""

from __future__ import annotations

from typing import List

from ..data.functions import current_validity_ts
from ..utils.errors import QueryError, StoredRelationError
from .relation import ColumnDef, RelationHandle, rel_prefix, rel_upper


def create_normal_index(db, rel: str, idx: str, cols: List[str]):
    from .db import NamedRows

    cur_vld = current_validity_ts()
    tx = db._new_session(True, cur_vld)
    try:
        handle = tx.get_relation(rel, for_update=True)
        if idx in handle.indices:
            raise StoredRelationError(
                f"index '{idx}' already exists on relation '{rel}'"
            )
        positions = [handle.col_index(c) for c in cols]
        all_cols = handle.keys + handle.values
        # index relation: keys = chosen cols + base key cols (covering)
        idx_keys = [
            ColumnDef(all_cols[p].name, all_cols[p].typing, None) for p in positions
        ]
        for kc in handle.keys:
            idx_keys.append(ColumnDef(kc.name, kc.typing, None))
        # de-duplicate names for the handle (positions still authoritative)
        seen = {}
        for c in idx_keys:
            if c.name in seen:
                seen[c.name] += 1
                c.name = f"{c.name}__{seen[c.name]}"
            else:
                seen[c.name] = 0
        idx_id = tx.alloc_rel_id(temp=handle.is_temp)
        idx_handle = RelationHandle(
            id=idx_id,
            name=f"{rel}:{idx}",
            keys=idx_keys,
            values=[],
            is_temp=handle.is_temp,
        )
        tx.put_relation_meta(idx_handle)
        handle.indices[idx] = {
            "kind": "normal",
            "rel_ids": [idx_id],
            "cols": cols,
            "positions": positions,
        }
        tx.put_relation_meta(handle)
        # back-fill
        store_tx = tx.store_tx_for(handle)
        nk = len(handle.keys)
        for row in handle.scan_all(store_tx):
            tup = [row[p] for p in positions] + row[:nk]
            store_tx.put(idx_handle.encode_row_key(tup), b"")
        tx.commit()
        return NamedRows.ok()
    except BaseException:
        tx.abort()
        raise


def drop_index(db, rel: str, idx: str):
    from .db import NamedRows

    cur_vld = current_validity_ts()
    tx = db._new_session(True, cur_vld)
    try:
        handle = tx.get_relation(rel, for_update=True)
        meta = handle.indices.pop(idx, None)
        if meta is None:
            raise QueryError(f"index '{idx}' not found on relation '{rel}'")
        store_tx = tx.store_tx_for(handle)
        for rid in meta.get("rel_ids", []):
            for k, _ in list(store_tx.range_scan(rel_prefix(rid), rel_upper(rid))):
                store_tx.delete(k)
        if meta.get("kind") == "hnsw":
            from .hnsw_packed import drop_packed_image

            drop_packed_image(store_tx, rel, idx)
            db.algo_cache.pop(f"hnsw::{rel}::{idx}", None)
        tx.delete_relation_meta(f"{rel}:{idx}")
        tx.put_relation_meta(handle)
        tx.commit()
        return NamedRows.ok()
    except BaseException:
        tx.abort()
        raise
