"""Relation catalog: stored-relation handles, key encoding, scans.

Mirrors reference `cozo-core/src/runtime/relation.rs`: every stored
relation (and every index) is a key range in the single ordered-KV space,
prefixed by its 8-byte big-endian relation id (`data/tuple.rs:29-38`).
The catalog itself lives in the SYSTEM id range.
"""

from __future__ import annotations

import json as _json
import struct
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional, Tuple

from ..data.memcmp import decode_tuple, encode_tuple, encode_value
from ..data.relation_types import ColType, coerce_value
from ..data.value import Validity, cmp_key
from ..storage.base import StoreTx
from ..utils.errors import QueryError, StoredRelationError

_U64 = struct.Struct(">Q")

# id 0 = internal bookkeeping, id 1 = catalog, user relations from 16 up
INTERNAL_ID = 0
SYSTEM_ID = 1
FIRST_USER_ID = 16

ACCESS_LEVELS = {"hidden": 0, "read_only": 1, "protected": 2, "normal": 3}


def rel_prefix(rel_id: int) -> bytes:
    return _U64.pack(rel_id)


def rel_upper(rel_id: int) -> bytes:
    return _U64.pack(rel_id + 1)


def encode_key(rel_id: int, key_tuple) -> bytes:
    return rel_prefix(rel_id) + encode_tuple(key_tuple)


@dataclass
class ColumnDef:
    name: str
    typing: Optional[ColType] = None
    default_src: Optional[str] = None

    def to_json(self):
        return {
            "name": self.name,
            "type": self.typing.display() if self.typing else "Any?",
            "default": self.default_src,
        }

    @staticmethod
    def from_json(d):
        return ColumnDef(d["name"], parse_col_type_str(d["type"]), d.get("default"))

    def default_expr(self):
        if self.default_src is None:
            return None
        from ..parse.parser import parse_expressions

        return parse_expressions(self.default_src)


_COL_TYPE_CACHE: Dict[str, Optional[ColType]] = {}


def parse_col_type_str(s: str) -> Optional[ColType]:
    """Memoized: handles deserialize on every uncached catalog read and the
    distinct type-string population is tiny; ColType instances are treated
    as immutable everywhere."""
    if s is None:
        return None
    got = _COL_TYPE_CACHE.get(s)
    if got is None and s not in _COL_TYPE_CACHE:
        from ..parse.parser import Parser

        got = Parser(s).parse_col_type()
        _COL_TYPE_CACHE[s] = got
    return got


@dataclass
class RelationHandle:
    id: int
    name: str
    keys: List[ColumnDef]
    values: List[ColumnDef]
    access_level: str = "normal"
    is_temp: bool = False
    # index name → metadata dict (kind: normal|hnsw|fts|lsh, plus config)
    indices: Dict[str, dict] = field(default_factory=dict)
    put_triggers: List[str] = field(default_factory=list)
    rm_triggers: List[str] = field(default_factory=list)
    replace_triggers: List[str] = field(default_factory=list)
    description: str = ""
    # virtual relation backed by a packed index image (hnsw_packed.py):
    # {"kind": "hnsw", "base": rel, "idx": idx}.  Scans decode rows on
    # demand from the in-memory index instead of the KV range; the KV
    # range holds only post-build mutation overlay rows.
    packed_src: Optional[dict] = None
    # runtime-attached PackedHnswBinder (not serialized)
    virt_binder: Any = None

    # --- serialization -------------------------------------------------------

    def to_json(self) -> str:
        return _json.dumps(
            {
                "id": self.id,
                "name": self.name,
                "keys": [c.to_json() for c in self.keys],
                "values": [c.to_json() for c in self.values],
                "access_level": self.access_level,
                "indices": self.indices,
                "put_triggers": self.put_triggers,
                "rm_triggers": self.rm_triggers,
                "replace_triggers": self.replace_triggers,
                "description": self.description,
                **(
                    {"packed_src": self.packed_src}
                    if self.packed_src is not None
                    else {}
                ),
            }
        )

    @staticmethod
    def from_json(s: str) -> "RelationHandle":
        d = _json.loads(s)
        return RelationHandle(
            id=d["id"],
            name=d["name"],
            keys=[ColumnDef.from_json(c) for c in d["keys"]],
            values=[ColumnDef.from_json(c) for c in d["values"]],
            access_level=d.get("access_level", "normal"),
            indices=d.get("indices", {}),
            put_triggers=d.get("put_triggers", []),
            rm_triggers=d.get("rm_triggers", []),
            replace_triggers=d.get("replace_triggers", []),
            description=d.get("description", ""),
            packed_src=d.get("packed_src"),
        )

    # --- basics ----------------------------------------------------------------

    @property
    def arity(self) -> int:
        return len(self.keys) + len(self.values)

    @property
    def key_arity(self) -> int:
        return len(self.keys)

    def col_names(self) -> List[str]:
        return [c.name for c in self.keys] + [c.name for c in self.values]

    def col_index(self, name: str) -> int:
        for i, c in enumerate(self.keys):
            if c.name == name:
                return i
        for i, c in enumerate(self.values):
            if c.name == name:
                return len(self.keys) + i
        raise QueryError(
            f"column '{name}' not found in relation '{self.name}'",
            code="eval::col_not_found",
        )

    def has_validity(self) -> bool:
        return bool(self.keys) and (
            self.keys[-1].typing is not None and self.keys[-1].typing.kind == "Validity"
        )

    def ensure_can_write(self) -> None:
        if ACCESS_LEVELS[self.access_level] < ACCESS_LEVELS["protected"]:
            raise StoredRelationError(
                f"relation '{self.name}' does not allow writes "
                f"(access level {self.access_level})",
                code="tx::access_denied",
            )

    def ensure_can_read(self) -> None:
        if ACCESS_LEVELS[self.access_level] < ACCESS_LEVELS["read_only"]:
            raise StoredRelationError(
                f"relation '{self.name}' does not allow reads "
                f"(access level {self.access_level})",
                code="tx::access_denied",
            )

    # --- row codec ---------------------------------------------------------------

    def coerce_row(self, row: List[Any]) -> List[Any]:
        cols = self.keys + self.values
        if len(row) != len(cols):
            raise StoredRelationError(
                f"arity mismatch for relation '{self.name}': "
                f"expected {len(cols)}, got {len(row)}"
            )
        return [coerce_value(v, c.typing) for v, c in zip(row, cols)]

    def encode_row_key(self, row) -> bytes:
        return encode_key(self.id, row[: len(self.keys)])

    def encode_row_val(self, row) -> bytes:
        return encode_tuple(row[len(self.keys) :])

    def decode_row(self, k: bytes, v: bytes) -> List[Any]:
        row = decode_tuple(k, 8)
        if v:
            row.extend(decode_tuple(v))
        return row

    # --- scans ---------------------------------------------------------------------

    def _virt_view(self, tx):
        if self.virt_binder is None:
            return None
        return self.virt_binder._view(self, tx)

    def scan_all(self, tx: StoreTx, raw_image: bool = False) -> Iterator[List[Any]]:
        if not raw_image:
            view = self._virt_view(tx)
            if view is not None:
                yield from view.scan_all()
                return
        for k, v in tx.range_scan(rel_prefix(self.id), rel_upper(self.id)):
            yield self.decode_row(k, v)

    def scan_prefix(
        self, tx: StoreTx, prefix_vals, raw_image: bool = False
    ) -> Iterator[List[Any]]:
        if not raw_image:
            view = self._virt_view(tx)
            if view is not None:
                yield from view.scan_prefix(prefix_vals)
                return
        lower = encode_key(self.id, prefix_vals)
        upper = lower + b"\xff\xff\xff\xff\xff\xff\xff\xff"
        for k, v in tx.range_scan(lower, upper):
            yield self.decode_row(k, v)

    def scan_bounded(
        self, tx: StoreTx, prefix_vals, lo_val, lo_incl, hi_val, hi_incl
    ) -> Iterator[List[Any]]:
        """Prefix scan with a range bound on the column right after the prefix."""
        view = self._virt_view(tx)
        if view is not None:
            yield from view.scan_bounded(
                prefix_vals, lo_val, lo_incl, hi_val, hi_incl
            )
            return
        base = encode_key(self.id, prefix_vals)
        if lo_val is not None:
            buf = bytearray()
            encode_value(buf, lo_val)
            lower = base + bytes(buf)
            if not lo_incl:
                lower += b"\xff" * 8
        else:
            lower = base
        if hi_val is not None:
            buf = bytearray()
            encode_value(buf, hi_val)
            upper = base + bytes(buf)
            if hi_incl:
                upper += b"\xff" * 9
        else:
            upper = base + b"\xff" * 9
        for k, v in tx.range_scan(lower, upper):
            yield self.decode_row(k, v)

    def get_row(
        self, tx: StoreTx, key_vals, raw_image: bool = False
    ) -> Optional[List[Any]]:
        if not raw_image:
            view = self._virt_view(tx)
            if view is not None:
                return view.get_row(key_vals)
        k = encode_key(self.id, key_vals)
        v = tx.get(k)
        if v is None:
            return None
        row = list(key_vals)
        if v:
            row.extend(decode_tuple(v))
        return row

    def get_rows(self, tx: StoreTx, key_vals_list) -> List[Optional[List[Any]]]:
        """Batched point lookups: one `multi_get` (a single round trip on
        the remote engine) instead of N gets."""
        view = self._virt_view(tx)
        if view is not None:
            return [view.get_row(kv) for kv in key_vals_list]
        keys = [encode_key(self.id, kv) for kv in key_vals_list]
        out: List[Optional[List[Any]]] = []
        for kv, v in zip(key_vals_list, tx.multi_get(keys)):
            if v is None:
                out.append(None)
                continue
            row = list(kv)
            if v:
                row.extend(decode_tuple(v))
            out.append(row)
        return out

    def exists(self, tx: StoreTx, key_vals) -> bool:
        view = self._virt_view(tx)
        if view is not None:
            return view.exists(key_vals)
        return tx.exists(encode_key(self.id, key_vals))

    def scan_at_validity(
        self, tx: StoreTx, prefix_vals, vld_ts: int
    ) -> Iterator[List[Any]]:
        """Time-travel SKIP-scan: for each distinct non-validity key group,
        seek directly to the newest fact at or before `vld_ts`, then seek
        past the rest of the group's history (reference
        `data/tuple.rs:60` check_key_for_validity next-seek keys +
        `storage/mod.rs` range_skip_scan_tuple).  Deep histories cost
        O(log n) per group instead of O(history)."""
        from ..data.memcmp import encode_value

        nk = len(self.keys) - 1  # positions before the validity column
        lower = encode_key(self.id, prefix_vals)
        upper = lower + b"\xff" * 8
        while True:
            first = tx.seek_first(lower, upper)
            if first is None:
                return
            k, v = first
            row = self.decode_row(k, v)
            group_prefix = encode_key(self.id, row[:nk])
            vld = row[nk]
            if isinstance(vld, Validity) and vld.ts <= vld_ts:
                # newest fact of this group at/before vld_ts
                if vld.is_assert:
                    yield row
            elif isinstance(vld, Validity):
                # newer than vld_ts: seek within the group to ts <= vld_ts
                buf = bytearray()
                encode_value(buf, Validity(vld_ts, True))
                hit = tx.seek_first(group_prefix + bytes(buf), upper)
                if hit is not None and hit[0].startswith(group_prefix):
                    row2 = self.decode_row(*hit)
                    vld2 = row2[nk]
                    if isinstance(vld2, Validity) and vld2.is_assert:
                        yield row2
            # skip the remainder of this group's history
            lower = group_prefix + b"\xff" * 9


# --- catalog over the SYSTEM range ---------------------------------------------


class Catalog:
    """Relation metadata in the SYSTEM key range + id allocation."""

    NEXT_ID_KEY = rel_prefix(INTERNAL_ID) + b"next_rel_id"
    VERSION_KEY = rel_prefix(INTERNAL_ID) + b"storage_version"
    STORAGE_VERSION = 1

    @staticmethod
    def init_storage(tx: StoreTx) -> None:
        if tx.get(Catalog.VERSION_KEY) is None:
            tx.put(Catalog.VERSION_KEY, str(Catalog.STORAGE_VERSION).encode())
            tx.put(Catalog.NEXT_ID_KEY, str(FIRST_USER_ID).encode())

    @staticmethod
    def alloc_rel_id(tx: StoreTx) -> int:
        raw = tx.get(Catalog.NEXT_ID_KEY, for_update=True)
        nxt = int(raw) if raw else FIRST_USER_ID
        tx.put(Catalog.NEXT_ID_KEY, str(nxt + 1).encode())
        return nxt

    @staticmethod
    def max_allocated_id(tx: StoreTx) -> int:
        """Highest relation id in use: max of the persisted counter and every
        catalog entry's id (index sub-relations included — they have their
        own catalog rows). Robust to a stale NEXT_ID_KEY from out-of-order
        commits; used to seed the process-level allocator at Db open."""
        raw = tx.get(Catalog.NEXT_ID_KEY)
        hi = (int(raw) if raw else FIRST_USER_ID) - 1
        for h in Catalog.list_all(tx):
            hi = max(hi, h.id)
        return max(hi, FIRST_USER_ID - 1)

    @staticmethod
    def meta_key(name: str) -> bytes:
        return encode_key(SYSTEM_ID, [name])

    @staticmethod
    def get(tx: StoreTx, name: str) -> Optional[RelationHandle]:
        v = tx.get(Catalog.meta_key(name))
        if v is None:
            return None
        return RelationHandle.from_json(v.decode("utf-8"))

    @staticmethod
    def put(tx: StoreTx, handle: RelationHandle) -> None:
        tx.put(Catalog.meta_key(handle.name), handle.to_json().encode("utf-8"))

    @staticmethod
    def delete(tx: StoreTx, name: str) -> None:
        tx.delete(Catalog.meta_key(name))

    @staticmethod
    def list_all(tx: StoreTx) -> List[RelationHandle]:
        out = []
        for _, v in tx.range_scan(rel_prefix(SYSTEM_ID), rel_upper(SYSTEM_ID)):
            out.append(RelationHandle.from_json(v.decode("utf-8")))
        return out
