"""Pluggable ordered-KV storage protocol.

Mirrors the reference's `trait Storage` / `trait StoreTx`
(`cozo-core/src/storage/mod.rs:31,56`): every engine exposes ordered byte
keys with snapshot transactions.  Engines: ``mem`` (sorted container),
``sqlite`` (stdlib, doubles as the backup format), ``tkv`` (C++ native
engine, see `native/tkv.cpp`).
"""

from __future__ import annotations

from typing import Iterator, Optional, Tuple


class StorageError(Exception):
    pass


class ConflictError(StorageError):
    """Optimistic-transaction write-write conflict."""


class StoreTx:
    """One transaction over an ordered KV space."""

    writable: bool = False

    def get(self, key: bytes, for_update: bool = False) -> Optional[bytes]:
        raise NotImplementedError

    def multi_get(self, keys) -> list:
        return [self.get(k) for k in keys]

    def exists(self, key: bytes, for_update: bool = False) -> bool:
        return self.get(key, for_update) is not None

    def put(self, key: bytes, value: bytes) -> None:
        raise NotImplementedError

    def delete(self, key: bytes) -> None:
        raise NotImplementedError

    def range_scan(
        self, lower: bytes, upper: bytes
    ) -> Iterator[Tuple[bytes, bytes]]:
        """All pairs with lower <= key < upper, ascending."""
        raise NotImplementedError

    def range_scan_rev(
        self, lower: bytes, upper: bytes
    ) -> Iterator[Tuple[bytes, bytes]]:
        """All pairs with lower <= key < upper, descending."""
        raise NotImplementedError

    def range_count(self, lower: bytes, upper: bytes) -> int:
        n = 0
        for _ in self.range_scan(lower, upper):
            n += 1
        return n

    def seek_first(self, lower: bytes, upper: bytes):
        for kv in self.range_scan(lower, upper):
            return kv

    def collect_keys(self, lower: bytes, upper: bytes) -> list:
        """All keys in [lower, upper) as a list — bulk staging hook
        (engines override with O(k) slicing / native export)."""
        return [k for k, _ in self.range_scan(lower, upper)]

    def total_scan(self) -> Iterator[Tuple[bytes, bytes]]:
        return self.range_scan(b"", b"\xff" * 9)

    def commit(self) -> None:
        raise NotImplementedError

    def abort(self) -> None:
        pass


class Storage:
    """One storage engine instance."""

    name = "base"

    def transact(self, write: bool = False) -> StoreTx:
        raise NotImplementedError

    def del_range(self, lower: bytes, upper: bytes) -> None:
        tx = self.transact(write=True)
        for k, _ in list(tx.range_scan(lower, upper)):
            tx.delete(k)
        tx.commit()

    def range_compact(self, lower: bytes, upper: bytes) -> None:
        pass

    def batch_put(self, items) -> None:
        """Bulk load (used by restore); items = iterable of (key, value)."""
        tx = self.transact(write=True)
        for k, v in items:
            tx.put(k, v)
        tx.commit()

    def close(self) -> None:
        pass
