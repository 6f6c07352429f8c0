"""SQLite storage engine — persistence + the backup file format.

Analog of the reference `sqlite` engine (`cozo-core/src/storage/sqlite.rs`):
a single ``cozo`` table of (k BLOB PRIMARY KEY, v BLOB).  Used both as a
persistent engine and as the portable backup format for every engine.
"""

from __future__ import annotations

import sqlite3

from sortedcontainers import SortedDict
import threading
from typing import Iterator, Optional, Tuple

from .base import Storage, StoreTx


class SqliteTx(StoreTx):
    def __init__(self, store: "SqliteStorage", write: bool) -> None:
        self.store = store
        self.writable = write
        self._done = False
        if write:
            self.store.wlock.acquire()
            self.overlay = SortedDict()
        else:
            self.overlay = None

    def get(self, key: bytes, for_update: bool = False) -> Optional[bytes]:
        if self.overlay is not None and key in self.overlay:
            return self.overlay[key]
        cur = self.store.conn.execute("SELECT v FROM cozo WHERE k = ?", (key,))
        row = cur.fetchone()
        return row[0] if row else None

    def range_scan(self, lower: bytes, upper: bytes) -> Iterator[Tuple[bytes, bytes]]:
        rows = self.store.conn.execute(
            "SELECT k, v FROM cozo WHERE k >= ? AND k < ? ORDER BY k", (lower, upper)
        ).fetchall()
        if not self.overlay:
            yield from rows
            return
        overlay = {
            k: self.overlay[k]
            for k in self.overlay.irange(lower, upper, inclusive=(True, False))
        }
        merged = {k: v for k, v in rows}
        merged.update(overlay)
        for k in sorted(merged):
            v = merged[k]
            if v is not None:
                yield k, v

    def range_scan_rev(self, lower: bytes, upper: bytes) -> Iterator[Tuple[bytes, bytes]]:
        items = list(self.range_scan(lower, upper))
        yield from reversed(items)

    def seek_first(self, lower: bytes, upper: bytes):
        lo = lower
        while True:
            row = self.store.conn.execute(
                "SELECT k, v FROM cozo WHERE k >= ? AND k < ? ORDER BY k LIMIT 1",
                (lo, upper),
            ).fetchone()
            bk = row[0] if row else None
            ok = None
            if self.overlay:
                ok = next(
                    self.overlay.irange(lo, upper, inclusive=(True, False)), None
                )
            if ok is not None and (bk is None or ok <= bk):
                ov = self.overlay[ok]
                if ov is None:
                    if bk is not None and bk < ok:
                        return (bytes(bk), bytes(row[1]))
                    lo = ok + b"\x00"
                    continue
                return (ok, ov)
            if bk is None:
                return None
            return (bytes(bk), bytes(row[1]))

    def range_count(self, lower: bytes, upper: bytes) -> int:
        if not self.overlay:
            cur = self.store.conn.execute(
                "SELECT COUNT(*) FROM cozo WHERE k >= ? AND k < ?", (lower, upper)
            )
            return cur.fetchone()[0]
        return sum(1 for _ in self.range_scan(lower, upper))

    def put(self, key: bytes, value: bytes) -> None:
        self.overlay[key] = value

    def delete(self, key: bytes) -> None:
        self.overlay[key] = None

    def commit(self) -> None:
        if self._done:
            return
        self._done = True
        if self.overlay is None:
            return
        try:
            conn = self.store.conn
            with conn:
                for k, v in self.overlay.items():
                    if v is None:
                        conn.execute("DELETE FROM cozo WHERE k = ?", (k,))
                    else:
                        conn.execute(
                            "INSERT INTO cozo(k, v) VALUES(?, ?) "
                            "ON CONFLICT(k) DO UPDATE SET v = excluded.v",
                            (k, v),
                        )
        finally:
            self.store.wlock.release()

    def abort(self) -> None:
        if self._done:
            return
        self._done = True
        if self.overlay is not None:
            self.overlay = {}
            self.store.wlock.release()


class SqliteStorage(Storage):
    name = "sqlite"

    def __init__(self, path: str) -> None:
        self.path = path
        self.conn = sqlite3.connect(path, check_same_thread=False)
        self.conn.execute(
            "CREATE TABLE IF NOT EXISTS cozo (k BLOB PRIMARY KEY, v BLOB) WITHOUT ROWID"
        )
        self.conn.commit()
        self.wlock = threading.RLock()

    def transact(self, write: bool = False) -> SqliteTx:
        return SqliteTx(self, write)

    def batch_put(self, items) -> None:
        with self.wlock, self.conn:
            self.conn.executemany(
                "INSERT INTO cozo(k, v) VALUES(?, ?) "
                "ON CONFLICT(k) DO UPDATE SET v = excluded.v",
                list(items),
            )

    def del_range(self, lower: bytes, upper: bytes) -> None:
        with self.wlock, self.conn:
            self.conn.execute(
                "DELETE FROM cozo WHERE k >= ? AND k < ?", (lower, upper)
            )

    def close(self) -> None:
        self.conn.close()
