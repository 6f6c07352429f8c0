"""Index maintenance dispatch: every write to a base relation updates all
of its indexes (reference `query/stored.rs:371-431,774`).

Normal (lateral) indexes are key-only relations whose keys are the chosen
columns followed by the base key columns.  HNSW / FTS / LSH maintenance
dispatches into their subsystem modules."""

from __future__ import annotations

from typing import List, Optional

from ..runtime.relation import RelationHandle
from ..runtime.transact import SessionTx


def index_row(base: RelationHandle, meta: dict, row: list) -> list:
    positions = meta["positions"]
    nk = len(base.keys)
    return [row[p] for p in positions] + row[:nk]


def update_indexes_on_put(
    db, tx: SessionTx, handle: RelationHandle, new_row: list, old_row: Optional[list]
) -> None:
    for idx_name, meta in handle.indices.items():
        kind = meta["kind"]
        if kind == "normal":
            idx_handle = tx.get_relation(f"{handle.name}:{idx_name}")
            store_tx = tx.store_tx_for(idx_handle)
            # compare memcmp-encoded keys: str() forms collide across types
            # (Int 1 vs Str "1"), leaving a stale index row undeleted
            new_key = idx_handle.encode_row_key(index_row(handle, meta, new_row))
            if old_row is not None:
                old_key = idx_handle.encode_row_key(index_row(handle, meta, old_row))
                if old_key != new_key:
                    store_tx.delete(old_key)
            store_tx.put(new_key, b"")
        elif kind == "hnsw":
            from .hnsw import hnsw_put

            hnsw_put(db, tx, handle, idx_name, meta, new_row, old_row)
        elif kind == "fts":
            from ..fts.indexing import fts_put

            fts_put(db, tx, handle, idx_name, meta, new_row, old_row)
        elif kind == "lsh":
            from .minhash_lsh import lsh_put

            lsh_put(db, tx, handle, idx_name, meta, new_row, old_row)


def update_indexes_on_remove(
    db, tx: SessionTx, handle: RelationHandle, old_row: list
) -> None:
    for idx_name, meta in handle.indices.items():
        kind = meta["kind"]
        if kind == "normal":
            idx_handle = tx.get_relation(f"{handle.name}:{idx_name}")
            store_tx = tx.store_tx_for(idx_handle)
            store_tx.delete(
                idx_handle.encode_row_key(index_row(handle, meta, old_row))
            )
        elif kind == "hnsw":
            from .hnsw import hnsw_remove

            hnsw_remove(db, tx, handle, idx_name, meta, old_row)
        elif kind == "fts":
            from ..fts.indexing import fts_remove

            fts_remove(db, tx, handle, idx_name, meta, old_row)
        elif kind == "lsh":
            from .minhash_lsh import lsh_remove

            lsh_remove(db, tx, handle, idx_name, meta, old_row)
