"""The port's storage engines (`cozo_tpu_torch/storage/tkv.py`, `plog.py`,
`remote.py`, `hosts/kvserver.py`) against the JAX package's, on the CPU.

- `tests/test_storage.py`'s cases, parametrised over engine x package;
- the cases of `test_tkv_lsm.py`, `test_tkv_hardening.py`, `test_plog.py`
  and `test_remote_storage.py`, on the port's copies, under their
  original names;
- across packages: a tkv and a plog directory written by either package
  open in the other with equal rows; a port client against a JAX
  `KvServer`, and the reverse;
- twin Dbs (`run_both`) on each engine, one with an HNSW index;
- the two packages' tkv libraries built at different paths;
- the kv server's command line, run as a module, serving a Db."""

import glob
import importlib
import os
import shutil
import signal
import socket
import struct
import subprocess
import sys
import textwrap
import threading

import numpy as np
import pytest

from cozo_tpu_torch.runtime.db import Db as _PortDb
from cozo_tpu_torch.storage.base import ConflictError
from cozo_tpu_torch.storage.mem import MemStorage
from cozo_tpu_torch.storage.plog import PlogStorage
from cozo_tpu_torch.storage.remote import KvServer, RemoteStorage, SCAN_BATCH
from cozo_tpu_torch.storage.tkv import TkvStorage
from tests.test_torch_db_scripts import norm, rows_sorted, run_both, same
from tests.test_torch_db_storage import STATE_SCRIPTS, write_state

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = ("cozo_tpu", "cozo_tpu_torch")


def Db(engine, path=""):
    """The port's Db on the CPU."""
    return _PortDb(engine, path, device="cpu")


def _addr(srv):
    return f"{srv.addr[0]}:{srv.addr[1]}"


# ------------------------------------ tests/test_storage.py, both packages


@pytest.fixture(params=[(p, e) for p in PACKAGES for e in
                        ("mem", "sqlite", "tkv", "tkv_mem", "plog", "remote")],
                ids=lambda pe: f"{pe[0]}-{pe[1]}")
def store(request, tmp_path):
    pkg, engine = request.param

    def mod(name):
        return importlib.import_module(f"{pkg}.storage.{name}")

    if engine == "mem":
        yield mod("mem").MemStorage()
        return
    if engine == "remote":
        srv = mod("remote").KvServer(mod("mem").MemStorage())
        srv.start_background()
        s = mod("remote").RemoteStorage(_addr(srv))
        yield s
        s.close()
        srv.shutdown()
        return
    s = {"sqlite": lambda: mod("sqlite").SqliteStorage(str(tmp_path / "t.db")),
         "tkv": lambda: mod("tkv").TkvStorage(str(tmp_path / "t.tkv")),
         "tkv_mem": lambda: mod("tkv").TkvStorage(""),
         "plog": lambda: mod("plog").PlogStorage(str(tmp_path / "t.plog")),
         }[engine]()
    yield s
    s.close()


def test_basic_kv(store):
    tx = store.transact(write=True)
    tx.put(b"a", b"1")
    tx.put(b"b", b"2")
    tx.put(b"c", b"3")
    tx.delete(b"b")
    assert tx.get(b"a") == b"1"
    assert tx.get(b"b") is None
    tx.commit()

    rd = store.transact()
    assert rd.get(b"a") == b"1"
    assert rd.get(b"b") is None
    assert list(rd.range_scan(b"a", b"d")) == [(b"a", b"1"), (b"c", b"3")]
    assert list(rd.range_scan_rev(b"a", b"d")) == [(b"c", b"3"), (b"a", b"1")]
    assert rd.range_count(b"a", b"d") == 2


def test_overlay_scan_merge(store):
    store.batch_put([(b"k1", b"v1"), (b"k3", b"v3"), (b"k5", b"v5")])
    tx = store.transact(write=True)
    tx.put(b"k2", b"v2")
    tx.put(b"k3", b"v3x")
    tx.delete(b"k5")
    got = list(tx.range_scan(b"k0", b"k9"))
    assert got == [(b"k1", b"v1"), (b"k2", b"v2"), (b"k3", b"v3x")]
    got_rev = list(tx.range_scan_rev(b"k0", b"k9"))
    assert got_rev == list(reversed(got))
    tx.abort()
    rd = store.transact()
    assert list(rd.range_scan(b"k0", b"k9")) == [
        (b"k1", b"v1"),
        (b"k3", b"v3"),
        (b"k5", b"v5"),
    ]


def test_del_range(store):
    store.batch_put([(bytes([i]), b"x") for i in range(10)])
    store.del_range(bytes([2]), bytes([5]))
    rd = store.transact()
    keys = [k for k, _ in rd.range_scan(bytes([0]), bytes([10]))]
    assert keys == [bytes([i]) for i in [0, 1, 5, 6, 7, 8, 9]]


# ----------------------------------------- tests/test_tkv_lsm.py, the port


def _store(tmp_path, name="t.db", flush=None):
    s = TkvStorage(str(tmp_path / name))
    if flush is not None:
        s.set_flush_bytes(flush)
    return s


def _put_many(store, items):
    tx = store.transact(write=True)
    for k, v in items:
        tx.put(k, v)
    tx.commit()


def _scan(store, lo=b"", hi=b"\xff" * 9):
    tx = store.transact(write=False)
    try:
        return list(tx.range_scan(lo, hi))
    finally:
        tx.abort()


def test_flush_creates_sst_and_reads_span_levels(tmp_path):
    s = _store(tmp_path, flush=1)  # flush after every commit
    _put_many(s, [(b"a%03d" % i, b"v%d" % i) for i in range(100)])
    _put_many(s, [(b"b%03d" % i, b"w%d" % i) for i in range(100)])
    assert glob.glob(str(tmp_path / "t.db.sst.*")), "no SST files written"
    tx = s.transact(write=False)
    assert tx.get(b"a050") == b"v50"
    assert tx.get(b"b099") == b"w99"
    assert tx.get(b"zzz") is None
    tx.abort()
    rows = _scan(s)
    assert len(rows) == 200
    assert rows[0] == (b"a000", b"v0") and rows[-1] == (b"b099", b"w99")
    s.close()


def test_shadowing_update_and_delete_across_flush(tmp_path):
    s = _store(tmp_path, flush=1)
    _put_many(s, [(b"k1", b"old"), (b"k2", b"keep"), (b"k3", b"gone")])
    tx = s.transact(write=True)
    tx.put(b"k1", b"new")
    tx.delete(b"k3")
    tx.commit()
    tx = s.transact(write=False)
    assert tx.get(b"k1") == b"new"
    assert tx.get(b"k3") is None
    tx.abort()
    assert _scan(s) == [(b"k1", b"new"), (b"k2", b"keep")]
    tx = s.transact(write=False)
    rows = list(tx.range_scan_rev(b"", b"\xff" * 9))
    tx.abort()
    assert rows == [(b"k2", b"keep"), (b"k1", b"new")]
    s.close()


def test_tiered_compaction_keeps_data(tmp_path):
    s = _store(tmp_path, flush=1)
    for wave in range(10):  # > 6 flushes trigger a compaction of the tier
        _put_many(s, [(b"w%02d-%03d" % (wave, i), b"x" * 20) for i in range(50)])
    ssts = glob.glob(str(tmp_path / "t.db.sst.*"))
    assert len(ssts) <= 7, f"compaction did not bound SST count: {ssts}"
    assert len(_scan(s)) == 500
    s.close()


def test_restart_recovers_ssts_and_wal(tmp_path):
    s = _store(tmp_path, flush=1)
    _put_many(s, [(b"flushed", b"1")])
    s.set_flush_bytes(1 << 30)
    _put_many(s, [(b"walonly", b"2")])
    s.close()
    s2 = _store(tmp_path)
    assert _scan(s2) == [(b"flushed", b"1"), (b"walonly", b"2")]
    _put_many(s2, [(b"flushed", b"3")])
    tx = s2.transact(write=False)
    assert tx.get(b"flushed") == b"3"
    tx.abort()
    s2.close()


def test_conflict_detection_spans_levels(tmp_path):
    s = _store(tmp_path, flush=1)
    _put_many(s, [(b"acct", b"100")])
    txa = s.transact(write=True)
    assert txa.get(b"acct", for_update=True) == b"100"
    txb = s.transact(write=True)
    txb.put(b"acct", b"50")
    txb.commit()
    txa.put(b"acct", b"90")
    with pytest.raises(ConflictError):
        txa.commit()
    s.close()


def test_delete_conflict_survives_flush(tmp_path):
    s = _store(tmp_path, flush=1)
    _put_many(s, [(b"row", b"v")])
    txa = s.transact(write=True)
    assert txa.get(b"row", for_update=True) == b"v"
    txb = s.transact(write=True)
    txb.delete(b"row")
    txb.commit()
    txa.put(b"row", b"resurrect")
    with pytest.raises(ConflictError):
        txa.commit()
    s.close()


def test_explicit_compact_drops_tombstones_keeps_live(tmp_path):
    s = _store(tmp_path, flush=1)
    _put_many(s, [(b"k%03d" % i, b"v") for i in range(100)])
    tx = s.transact(write=True)
    for i in range(0, 100, 2):
        tx.delete(b"k%03d" % i)
    tx.commit()
    s.range_compact(b"", b"\xff")
    assert len(_scan(s)) == 50
    ssts = glob.glob(str(tmp_path / "t.db.sst.*"))
    assert len(ssts) == 1, ssts
    assert os.path.getsize(tmp_path / "t.db") == 0
    s.close()
    s2 = _store(tmp_path)
    assert len(_scan(s2)) == 50
    s2.close()


def test_db_level_queries_across_flushes(tmp_path):
    d = Db("tkv", str(tmp_path / "q.db"))
    d.storage.set_flush_bytes(4096)
    d.run_script(":create kv {k: Int => v: String}")
    payload = "x" * 100
    for s in range(0, 5000, 500):
        d.run_script(
            "?[k,v] <- $rows :put kv {k => v}",
            params={"rows": [[i, payload + str(i)] for i in range(s, s + 500)]},
        )
    assert glob.glob(str(tmp_path / "q.db.sst.*"))
    assert d.run_script("?[count(k)] := *kv{k}").rows == [[5000]]
    r = d.run_script("?[v] := *kv{k: 4321, v}")
    assert r.rows == [[payload + "4321"]]
    r = d.run_script("?[k] := *kv{k}, k < 10 :order -k :limit 3")
    assert r.rows == [[9], [8], [7]]
    d.close()
    d2 = Db("tkv", str(tmp_path / "q.db"))
    assert d2.run_script("?[count(k)] := *kv{k}").rows == [[5000]]
    d2.close()


def _kill_after(script, n_acked):
    """Run `script` (prints each acknowledged commit's number), SIGKILL it
    once it has printed `n_acked`; returns the last number printed."""
    proc = subprocess.Popen([sys.executable, "-c", script],
                            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
                            text=True, cwd=_ROOT)
    seen = -1
    watchdog = threading.Timer(300, proc.kill)  # the test's own time limit
    watchdog.start()
    for line in proc.stdout:
        seen = int(line.strip())
        if seen >= n_acked:
            break
    watchdog.cancel()
    os.kill(proc.pid, signal.SIGKILL)
    proc.wait(timeout=60)
    return seen


def test_kill9_recovery_with_ssts(tmp_path):
    """SIGKILL mid-stream: WAL + SSTs recover to a consistent prefix."""
    script = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {_ROOT!r})
        from cozo_tpu_torch.storage.tkv import TkvStorage
        s = TkvStorage({str(tmp_path / "crash.db")!r}, sync_mode=1)
        s.set_flush_bytes(2048)
        for wave in range(1000):
            tx = s.transact(write=True)
            for i in range(20):
                tx.put(b"w%04d-%02d" % (wave, i), b"y" * 40)
            tx.commit()
            print(wave, flush=True)
    """)
    waves_seen = _kill_after(script, 40)
    assert waves_seen >= 40
    s = TkvStorage(str(tmp_path / "crash.db"))
    by_wave = {}
    for k, _ in _scan(s):
        by_wave.setdefault(k[:5], []).append(k)
    for w in range(waves_seen):
        assert len(by_wave.get(b"w%04d" % w, [])) == 20, f"wave {w} incomplete"
    s.close()


# ------------------------------------ tests/test_tkv_hardening.py, the port


def test_delete_conflict_detected():
    s = TkvStorage("")
    init = s.transact(write=True)
    init.put(b"k", b"v0")
    init.commit()
    reader = s.transact(write=True)
    assert reader.get(b"k", for_update=True) == b"v0"
    deleter = s.transact(write=True)
    deleter.delete(b"k")
    deleter.commit()
    reader.put(b"other", b"x")
    with pytest.raises(ConflictError):
        reader.commit()
    s.close()


def test_iterator_sees_consistent_data_across_commits():
    s = TkvStorage("")
    tx = s.transact(write=True)
    for i in range(1000):
        tx.put(b"k%04d" % i, b"v%d" % i)
    tx.commit()
    rd = s.transact()
    it = rd.range_scan(b"k", b"l")
    got = [next(it) for _ in range(10)]
    w = s.transact(write=True)
    for i in range(500, 600):
        w.delete(b"k%04d" % i)
    w.put(b"k9999", b"new")
    w.commit()
    rest = list(it)
    keys = [k for k, _ in got] + [k for k, _ in rest]
    assert keys == sorted(set(keys)), "iterator went backwards or duplicated"
    assert b"k0550" not in keys
    assert keys[-1] == b"k9999"
    s.close()


def test_tombstone_gc_keeps_scans_correct():
    s = TkvStorage("")
    tx = s.transact(write=True)
    for i in range(10000):
        tx.put(b"g%05d" % i, b"v")
    tx.commit()
    d = s.transact(write=True)
    for i in range(9000):
        d.delete(b"g%05d" % i)
    d.commit()
    rows = list(s.transact().range_scan(b"g", b"h"))
    assert len(rows) == 1000
    assert rows[0][0] == b"g09000"
    s.close()


_ONE_BY_ONE = """
import sys
sys.path.insert(0, {root!r})
from cozo_tpu_torch.storage.{mod} import {cls}
s = {cls}({path!r}, sync_mode=1)
i = 0
while True:
    tx = s.transact(write=True)
    tx.put(b"row%08d" % i, b"v%d" % i)
    tx.commit()
    print(i, flush=True)
    i += 1
"""


def test_crash_recovery_sigkill(tmp_path):
    """Every commit the child acknowledged is there after a SIGKILL."""
    path = str(tmp_path / "crash.tkv")
    acked = _kill_after(_ONE_BY_ONE.format(root=_ROOT, mod="tkv",
                                           cls="TkvStorage", path=path), 500)
    s = TkvStorage(path)
    rd = s.transact()
    for i in range(acked + 1):
        assert rd.get(b"row%08d" % i) == b"v%d" % i, f"lost committed row {i}"
    s.close()


# --------------------------------------------- tests/test_plog.py, the port


def _put_rows(s, lo, hi):
    tx = s.transact(write=True)
    for i in range(lo, hi):
        tx.put(b"k%06d" % i, b"v%d" % i)
    tx.commit()


def test_reopen_replays_journal(tmp_path):
    p = str(tmp_path / "d")
    s = PlogStorage(p, sync_mode=0)
    _put_rows(s, 0, 100)
    tx = s.transact(write=True)
    tx.delete(b"k000050")
    tx.commit()
    s._wal.flush()  # no close (no snapshot): the reopen replays the journal
    s2 = PlogStorage(p, sync_mode=0)
    rd = s2.transact()
    assert rd.get(b"k000010") == b"v10"
    assert rd.get(b"k000050") is None
    assert rd.range_count(b"k", b"l") == 99
    s2.close()


def test_close_compacts_and_reopens(tmp_path):
    p = str(tmp_path / "d")
    s = PlogStorage(p)
    _put_rows(s, 0, 500)
    s.close()
    assert os.path.getsize(os.path.join(p, "journal.plog")) == 0
    assert os.path.getsize(os.path.join(p, "snapshot.plog")) > 0
    s2 = PlogStorage(p)
    assert s2.transact().range_count(b"k", b"l") == 500
    s2.close()


def test_torn_tail_frame_dropped(tmp_path):
    p = str(tmp_path / "d")
    s = PlogStorage(p, sync_mode=0)
    _put_rows(s, 0, 50)
    s._wal.flush()
    with open(os.path.join(p, "journal.plog"), "ab") as f:
        f.write(struct.pack("<I", 3) + struct.pack("<Ii", 10, 100) + b"short")
    s2 = PlogStorage(p, sync_mode=0)
    assert s2.transact().range_count(b"k", b"l") == 50
    _put_rows(s2, 50, 60)
    s3 = PlogStorage(p, sync_mode=0)
    assert s3.transact().range_count(b"k", b"l") == 60
    s3.close()
    s2.close()


def test_del_range_durable(tmp_path):
    p = str(tmp_path / "d")
    s = PlogStorage(p, sync_mode=0)
    _put_rows(s, 0, 100)
    s.del_range(b"k000020", b"k000030")
    s._wal.flush()
    s2 = PlogStorage(p, sync_mode=0)
    assert s2.transact().range_count(b"k", b"l") == 90
    s2.close()


def test_compaction_triggered_by_journal_growth(tmp_path):
    p = str(tmp_path / "d")
    s = PlogStorage(p, sync_mode=0)
    big = b"x" * 65536
    for i in range(80):  # ~5 MB of journal > the 4 MB threshold
        tx = s.transact(write=True)
        tx.put(b"big%04d" % i, big)
        tx.commit()
    assert os.path.getsize(os.path.join(p, "snapshot.plog")) > 0
    s2 = PlogStorage(p, sync_mode=0)
    assert s2.transact().range_count(b"big", b"bih") == 80
    s2.close()


def test_sigkill_durability(tmp_path):
    """Every acknowledged fsync'd commit survives a SIGKILL."""
    p = str(tmp_path / "crash")
    acked = _kill_after(_ONE_BY_ONE.format(root=_ROOT, mod="plog",
                                           cls="PlogStorage", path=p), 300)
    s = PlogStorage(p)
    rd = s.transact()
    for i in range(acked + 1):
        assert rd.get(b"row%08d" % i) == b"v%d" % i, f"lost committed row {i}"
    s.close()


def test_db_end_to_end_over_plog(tmp_path):
    p = str(tmp_path / "db")
    db = Db("plog", p)
    db.run_script(":create kv {k: Int => v: String}")
    db.run_script("?[k, v] <- [[1, 'a'], [2, 'b']] :put kv {k => v}")
    db.storage.close()
    db2 = Db("plog", p)
    assert db2.run_script("?[k, v] := *kv{k, v}").rows == [[1, "a"], [2, "b"]]
    db2.storage.close()


# ----------------------------------- tests/test_remote_storage.py, the port


@pytest.fixture()
def server():
    srv = KvServer(MemStorage())
    srv.start_background()
    yield srv
    srv.shutdown()


def test_kv_roundtrip_and_scans(server):
    st = RemoteStorage(_addr(server))
    tx = st.transact(write=True)
    n = SCAN_BATCH * 2 + 17  # multi-batch cursor scans
    for i in range(n):
        tx.put(b"k%06d" % i, b"v%d" % i)
    tx.commit()
    tx = st.transact()
    assert tx.get(b"k000005") == b"v5"
    assert tx.get(b"missing") is None
    rows = list(tx.range_scan(b"k", b"l"))
    assert len(rows) == n and rows == sorted(rows)
    assert list(tx.range_scan_rev(b"k", b"l")) == rows[::-1]
    assert tx.range_count(b"k", b"l") == n
    assert tx.seek_first(b"k000100", b"l") == (b"k000100", b"v100")
    tx.abort()
    tx = st.transact(write=True)
    tx.put(b"k000000x", b"mid")
    tx.delete(b"k000001")
    got = [k for k, _ in tx.range_scan(b"k000000", b"k000003")]
    assert got == [b"k000000", b"k000000x", b"k000002"]
    tx.abort()
    st.del_range(b"k000000", b"k000010")
    tx = st.transact()
    assert tx.get(b"k000005") is None
    assert tx.get(b"k000010") == b"v10"
    tx.abort()
    st.close()


def test_batch_put_streams(server):
    st = RemoteStorage(_addr(server))
    big = b"x" * 4096
    st.batch_put([(b"b%05d" % i, big) for i in range(3000)])  # > 4 MB: chunks
    tx = st.transact()
    assert tx.range_count(b"b", b"c") == 3000
    tx.abort()
    st.close()


def test_occ_lost_update_conflict(server):
    st1 = RemoteStorage(_addr(server))
    st2 = RemoteStorage(_addr(server))
    tx = st1.transact(write=True)
    tx.put(b"counter", b"0")
    tx.commit()
    t1 = st1.transact(write=True)
    t2 = st2.transact(write=True)
    assert t1.get(b"counter", for_update=True) == b"0"
    assert t2.get(b"counter", for_update=True) == b"0"
    t1.put(b"counter", b"1")
    t2.put(b"counter", b"1")
    t1.commit()
    with pytest.raises(ConflictError):
        t2.commit()
    st1.close()
    st2.close()


def test_occ_delete_after_snapshot(server):
    st1 = RemoteStorage(_addr(server))
    st2 = RemoteStorage(_addr(server))
    tx = st1.transact(write=True)
    tx.put(b"doomed", b"1")
    tx.commit()
    t2 = st2.transact(write=True)
    assert t2.get(b"doomed", for_update=True) == b"1"
    t1 = st1.transact(write=True)
    t1.delete(b"doomed")
    t1.commit()
    t2.put(b"doomed", b"2")
    with pytest.raises(ConflictError):
        t2.commit()
    st1.close()
    st2.close()


def test_db_end_to_end_over_remote(server):
    db = Db("remote", _addr(server))
    db.run_script(":create person {id: Int => name: String, age: Int}")
    db.run_script(
        "?[id, name, age] <- [[1, 'ann', 30], [2, 'bob', 41], [3, 'cy', 25]] "
        ":put person {id => name, age}"
    )
    out = db.run_script("?[name] := *person{age, name}, age > 28")
    assert sorted(r[0] for r in out.rows) == ["ann", "bob"]
    db.run_script("::index create person:by_age {age}")
    assert [r[0] for r in db.run_script("?[id] := *person{id, age: 41}").rows] == [2]
    db2 = Db("remote", _addr(server))
    assert db2.run_script("?[count(id)] := *person{id}").rows[0][0] == 3
    db2.run_script("?[id, name, age] <- [[4, 'dee', 55]] :put person {id => name, age}")
    assert db.run_script("?[name] := *person{id: 4, name}").rows[0][0] == "dee"
    db.run_script(":create edge {f: Int, t: Int}")
    db.run_script("?[f, t] <- [[1,2],[2,3],[3,4]] :put edge {f, t}")
    out = db.run_script(
        "reach[x, y] := *edge{f: x, t: y}\n"
        "reach[x, y] := reach[x, z], *edge{f: z, t: y}\n"
        "?[y] := reach[1, y]"
    )
    assert sorted(r[0] for r in out.rows) == [2, 3, 4]


def test_concurrent_db_writers_conflict_detected(server):
    """Two Dbs sharing the remote store race a read-modify-write of one
    cell: the server's optimistic check rejects the second commit."""
    db1 = Db("remote", _addr(server))
    db1.run_script(":create cell {k: Int => v: Int}")
    db1.run_script("?[k, v] <- [[0, 0]] :put cell {k => v}")
    db2 = Db("remote", _addr(server))
    bump = ("?[k, v] := *cell{k: 0, v: old}, k = 0, v = old + 1 "
            ":update cell {k => v}")
    t1 = db1.multi_transaction()
    t2 = db2.multi_transaction()
    t1.run_script(bump)
    t2.run_script(bump)
    t1.commit()
    with pytest.raises(Exception, match="[Cc]onflict"):
        t2.commit()
    assert db1.run_script("?[v] := *cell{k: 0, v}").rows[0][0] == 1


def test_hnsw_cross_client_visibility(server):
    """Two Dbs share an HNSW index through the remote store: the canary
    version invalidates the second client's cache when the first writes."""
    db1 = Db("remote", _addr(server))
    db1.run_script(":create doc {id: Int => v: <F32; 4>}")
    db1.run_script("?[id, v] <- [[0, [1.0,0.0,0.0,0.0]], [1, [0.0,1.0,0.0,0.0]]] "
                   ":put doc {id => v}")
    db1.run_script("::hnsw create doc:ix {dim: 4, m: 4, dtype: F32, fields: [v], "
                   "distance: L2, ef_construction: 16}")
    db2 = Db("remote", _addr(server))
    q = "?[id] := ~doc:ix{id | query: vec($q), k: $k, ef: 8}"
    assert [r[0] for r in db2.run_script(
        q, {"q": [1.0, 0.0, 0.0, 0.0], "k": 1}).rows] == [0]
    db1.run_script("?[id, v] <- [[9, [0.9,0.1,0.0,0.0]]] :put doc {id => v}")
    assert [r[0] for r in db2.run_script(
        q, {"q": [0.9, 0.1, 0.0, 0.0], "k": 1}).rows] == [9]
    db1.run_script("?[id] <- [[0]] :rm doc {id}")
    out = db2.run_script(q, {"q": [1.0, 0.0, 0.0, 0.0], "k": 2})
    assert 0 not in {r[0] for r in out.rows}


def test_hnsw_concurrent_writers_conflict(server):
    db1 = Db("remote", _addr(server))
    db1.run_script(":create emb {id: Int => v: <F32; 4>}")
    db1.run_script("?[id, v] <- [[0, [1.0,0.0,0.0,0.0]]] :put emb {id => v}")
    db1.run_script("::hnsw create emb:ix {dim: 4, m: 4, dtype: F32, fields: [v], "
                   "distance: L2, ef_construction: 16}")
    db2 = Db("remote", _addr(server))
    q = "?[id] := ~emb:ix{id | query: vec($q), k: 1, ef: 8}"
    for d in (db1, db2):
        d.run_script(q, {"q": [1.0, 0.0, 0.0, 0.0]})
    t1 = db1.multi_transaction()
    t2 = db2.multi_transaction()
    t1.run_script("?[id, v] <- [[10, [0.5,0.5,0.0,0.0]]] :put emb {id => v}")
    t2.run_script("?[id, v] <- [[11, [0.5,0.0,0.5,0.0]]] :put emb {id => v}")
    t1.commit()
    with pytest.raises(Exception, match="[Cc]onflict"):
        t2.commit()
    db2.run_script("?[id, v] <- [[11, [0.5,0.0,0.5,0.0]]] :put emb {id => v}")
    assert [r[0] for r in db1.run_script(
        q, {"q": [0.5, 0.0, 0.5, 0.0]}).rows] == [11]


def test_multi_get_batches_one_round_trip(server):
    st = RemoteStorage(_addr(server))
    tx = st.transact(write=True)
    for i in range(20):
        tx.put(b"m%02d" % i, b"v%d" % i)
    tx.commit()
    tx = st.transact(write=True)
    tx.put(b"m05", b"overlaid")
    tx.delete(b"m06")
    got = tx.multi_get([b"m01", b"m05", b"m06", b"nope", b"m19"])
    assert got == [b"v1", b"overlaid", None, None, b"v19"]
    tx.abort()
    st.close()


# ---------------------------------------------------------- across packages


def _copy_store(engine, src, dst):
    """A copy of a closed tkv (a file and its SSTs) or plog (a directory)
    store, so that each package opens its own."""
    if engine == "plog":
        shutil.copytree(src, dst)
        return
    for f in glob.glob(src + "*"):
        shutil.copy(f, dst + f[len(src):])


@pytest.mark.parametrize("engine", ["tkv", "plog"])
@pytest.mark.parametrize("writer", PACKAGES)
def test_store_opens_in_the_other_package(engine, writer, tmp_path,
                                          monkeypatch):
    """A tkv or plog store written by one package (a relation, a lateral
    index, an HNSW index in the row image and one in the packed image,
    each mutated after its build; with the tkv memtable flushed to SSTs
    along the way) opens in both packages, which answer the same scripts
    with the same rows as the writer did."""
    import cozo_tpu
    import cozo_tpu_torch

    path = str(tmp_path / "w.db")
    monkeypatch.setenv("COZO_TPU_PACKED_KV_MIN", "50")
    if writer == "cozo_tpu":
        w = cozo_tpu.Db(engine, path)
    else:
        w = cozo_tpu_torch.Db(engine, path, device="cpu")
    if engine == "tkv":
        w.storage.set_flush_bytes(8192)
    vecs = write_state(w)
    monkeypatch.delenv("COZO_TPU_PACKED_KV_MIN")
    before = {s: rows_sorted(w.run_script(s, {"q": vecs[7]}))
              for s in STATE_SCRIPTS}
    w.close()
    if engine == "tkv":
        assert glob.glob(path + ".sst.*")
    _copy_store(engine, path, str(tmp_path / "r.db"))
    dbs = (cozo_tpu.Db(engine, path),
           cozo_tpu_torch.Db(engine, str(tmp_path / "r.db"), device="cpu"))
    for s in STATE_SCRIPTS:
        res = run_both(dbs, s, {"q": vecs[7]})
        assert same(norm(rows_sorted(res)), norm(before[s]), tol=1e-12), s
    for db in dbs:
        db.close()


@pytest.mark.parametrize("server_pkg", PACKAGES)
def test_remote_client_of_the_other_package(server_pkg):
    """A client of either package against a `KvServer` of the other (the
    wire format is byte-equal): a Db of each package shares the one
    server; the JAX Db writes a relation, the port's Db (opened after that
    DDL: see `ROADMAP.md` §3 on relation ids across clients) builds an
    HNSW index over it and removes a row, and both answer the same."""
    import cozo_tpu
    import cozo_tpu_torch

    srv_mod = importlib.import_module(f"{server_pkg}.storage.remote")
    mem_mod = importlib.import_module(f"{server_pkg}.storage.mem")
    srv = srv_mod.KvServer(mem_mod.MemStorage())
    srv.start_background()
    try:
        jdb = cozo_tpu.Db("remote", _addr(srv))
        vecs = np.random.default_rng(4).normal(size=(60, 4)).astype(np.float32)
        jdb.run_script(":create pts {id: Int => v: <F32; 4>}")
        jdb.run_script("?[id, v] <- $rows :put pts {id => v}",
                       {"rows": [[i, vecs[i]] for i in range(60)]})
        tdb = cozo_tpu_torch.Db("remote", _addr(srv), device="cpu")
        tdb.run_script("::hnsw create pts:ix {dim: 4, m: 8, "
                       "ef_construction: 32, fields: [v], distance: L2}")
        tdb.run_script("?[id] <- [[5]] :rm pts {id}")
        for s in ("?[id, v] := *pts{id, v}",
                  "?[id, d] := ~pts:ix{id | query: vec($q), k: 6, ef: 32, "
                  "bind_distance: d}",
                  "?[layer, fr_id, to_id, dist] := *pts:ix{layer, fr_id, "
                  "to_id, dist}"):
            run_both((jdb, tdb), s, {"q": vecs[7]})
        assert jdb.run_script("?[count(id)] := *pts{id}").rows == [[59]]
        # a raw key written by one client, read by the other's storage
        tx = tdb.storage.transact(write=True)
        tx.put(b"\xffraw", b"from the port")
        tx.commit()
        assert jdb.storage.transact().get(b"\xffraw") == b"from the port"
    finally:
        srv.shutdown()


# -------------------------------------------------------------- twin Dbs


TWIN_SCRIPTS = [
    ":create person {id: Int => name: String, age: Int}",
    ("?[id, name, age] <- $rows :put person {id => name, age}",
     {"rows": [[i, f"p{i}", 20 + (i % 40)] for i in range(300)]}),
    "::index create person:by_age {age, name}",
    "?[name] := *person{name, age: 25}",
    "?[age, count(id)] := *person{id, age}",
    "?[id, name, age] <- [[7, 'renamed', 99]] :put person {id => name, age}",
    "?[id] <- [[8], [9]] :rm person {id}",
    "?[id, name] := *person{id, name}, id < 12",
    ":create e {f: Int, t: Int}",
    "?[f, t] <- [[1,2],[2,3],[3,4],[4,1]] :put e {f, t}",
    "r[a, b] := *e[a, b]\nr[a, c] := r[a, b], *e[b, c]\n?[b] := r[1, b]",
]
HNSW_SCRIPTS = [
    ":create pts {id: Int => v: <F32; 8>}",
    ("?[id, v] <- $rows :put pts {id => v}",
     {"rows": [[i, v] for i, v in enumerate(
         np.random.default_rng(9).normal(size=(200, 8)).astype(np.float32))]}),
    "::hnsw create pts:ix {dim: 8, m: 8, ef_construction: 32, fields: [v], "
    "distance: Cosine}",
    ("?[id, d] := ~pts:ix{id | query: vec($q), k: 5, ef: 32, "
     "bind_distance: d}", {"q": [0.5] * 8}),
    ("?[id, v] <- [[500, $q]] :put pts {id => v}", {"q": [0.5] * 8}),
    "?[id] <- [[3], [4]] :rm pts {id}",
    ("?[id, d] := ~pts:ix{id | query: vec($q), k: 5, ef: 32, "
     "bind_distance: d}", {"q": [0.5] * 8}),
    "?[layer, fr_id, to_id] := *pts:ix{layer, fr_id, to_id}",
]


@pytest.mark.parametrize("scripts", ["relational", "hnsw"])
@pytest.mark.parametrize("engine", ["tkv", "rocksdb", "plog", "sled",
                                    "remote", "tikv"])
def test_twin_dbs_on_each_engine(engine, scripts, tmp_path):
    """The same scripts through a JAX Db and a port Db, each on its own
    store of the engine (a tkv file, a plog directory, or a kv server of
    its own package): equal headers and rows at every step, and equal
    rows again after each store is closed and opened (or, for remote,
    read by a second client)."""
    import cozo_tpu
    import cozo_tpu_torch

    servers = []
    if engine in ("remote", "tikv"):
        for pkg in PACKAGES:
            srv = importlib.import_module(f"{pkg}.storage.remote").KvServer(
                importlib.import_module(f"{pkg}.storage.mem").MemStorage())
            srv.start_background()
            servers.append(srv)
        paths = [_addr(s) for s in servers]
    else:
        paths = [str(tmp_path / f"{pkg}.db") for pkg in PACKAGES]
    opens = (lambda: cozo_tpu.Db(engine, paths[0]),
             lambda: cozo_tpu_torch.Db(engine, paths[1], device="cpu"))
    try:
        dbs = tuple(o() for o in opens)
        steps = TWIN_SCRIPTS if scripts == "relational" else HNSW_SCRIPTS
        for step in steps:
            run_both(dbs, *(step if isinstance(step, tuple) else (step,)))
        if not servers:
            for db in dbs:
                db.close()
        dbs = tuple(o() for o in opens)
        for step in steps:
            step = step if isinstance(step, tuple) else (step,)
            if not any(w in step[0] for w in (":put", ":rm", ":create", "::")):
                run_both(dbs, *step)
        if not servers:
            for db in dbs:
                db.close()
    finally:
        for srv in servers:
            srv.shutdown()


# ----------------------------------------------------- libraries, the CLI


def test_tkv_libraries_are_built_at_different_paths(tmp_path):
    """The port builds `native/tkv.cpp` into its own directory, under a
    name that carries the source's hash; the JAX package's library stays
    `native/libtkv.so`.  Both load in one process and each opens its own
    store."""
    import cozo_tpu.storage.tkv as jtkv
    import cozo_tpu_torch.storage.tkv as ttkv

    jpath = jtkv._find_or_build_lib()
    tpath = ttkv._find_or_build_lib()
    assert os.path.realpath(jpath) == os.path.join(_ROOT, "native", "libtkv.so")
    assert os.path.dirname(tpath) == os.path.join(
        _ROOT, "build", "cozo_tpu_torch_kernels")
    assert tpath == ttkv.lib_path() and os.path.exists(tpath)
    assert os.path.basename(tpath).startswith("libtkv-")
    assert jtkv._lib()._name != ttkv._lib()._name
    a, b = jtkv.TkvStorage(str(tmp_path / "a")), ttkv.TkvStorage(str(tmp_path / "b"))
    for s, v in ((a, b"jax"), (b, b"port")):
        tx = s.transact(write=True)
        tx.put(b"k", v)
        tx.commit()
    assert a.transact().get(b"k") == b"jax" and b.transact().get(b"k") == b"port"
    a.close()
    b.close()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_kvserver_module_serves_a_db(tmp_path):
    """`python -m cozo_tpu_torch.hosts.kvserver --engine tkv` serves a
    store that a Db of either package uses; a write acknowledged by the
    server is read back after the server restarts on the same path."""
    import cozo_tpu

    port = _free_port()
    cmd = [sys.executable, "-u", "-m", "cozo_tpu_torch.hosts.kvserver", "--engine",
           "tkv", "--path", str(tmp_path / "kv"), "--port", str(port)]

    def start():
        proc = subprocess.Popen(cmd, cwd=_ROOT, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        watchdog = threading.Timer(120, proc.kill)  # the test's own time limit
        watchdog.start()
        line = proc.stdout.readline()
        watchdog.cancel()
        assert f"cozo_tpu_torch kv server (tkv) on 127.0.0.1:{port}" in line, \
            (line, proc.stderr.read() if proc.poll() is not None else "")
        return proc

    proc = start()
    try:
        db = Db("remote", f"127.0.0.1:{port}")
        db.run_script(":create kv {k: Int => v: String}")
        db.run_script("?[k, v] <- [[1, 'a'], [2, 'b']] :put kv {k => v}")
        jdb = cozo_tpu.Db("remote", f"127.0.0.1:{port}")
        assert jdb.run_script("?[k, v] := *kv{k, v}").rows == [[1, "a"], [2, "b"]]
    finally:
        proc.terminate()
        proc.wait(timeout=30)
    proc = start()
    try:
        db = Db("remote", f"127.0.0.1:{port}")
        assert db.run_script("?[k, v] := *kv{k, v}").rows == [[1, "a"], [2, "b"]]
    finally:
        proc.terminate()
        proc.wait(timeout=30)
