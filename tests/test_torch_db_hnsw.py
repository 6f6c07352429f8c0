"""HNSW through `cozo_tpu_torch.Db` against `cozo_tpu.Db` (on the CPU):
the index DDL, `~rel:idx{...}` searches, maintenance on `:put` / `:rm`,
the KV image as a relation (row image and packed image), cache rebuilds
from KV, and the device dispatch of a pivot join on a table past the
20,000-row threshold.  Below that threshold both packages run the same
host search, so distances are compared exactly; the device lanes are held
to the tolerance of `test_torch_vector_search.py` (1e-5).

The 4 <= B < 64 dispatch to the beam search needs a table past 131,072
rows; a build of one through the Db takes minutes here, so the port's Db
holds a navigable index made without a build (`tests/_torch_state.
line_state`) and its joins at B = 4 and 63 are held against
`HnswIndex.search` called directly.  Concurrent B >= 64 joins with a
writer hold the sweep table's and the index cache's locks.
"""

import sys
import threading
import time

import numpy as np
import pytest
import torch

from tests.test_torch_db_scripts import new_dbs, rows_sorted, run_both

DIM = 8
HNSW = ("::hnsw create vecs:idx {dim: 8, m: 8, ef_construction: 50, "
        "fields: [v]}")


def seeded(n=100, dim=DIM, seed=0):
    dbs = new_dbs()
    data = np.random.default_rng(seed).standard_normal((n, dim)).astype(
        np.float32)
    run_both(dbs, f":create vecs {{k: Int => v: <F32; {dim}>}}")
    run_both(dbs, "?[k, v] <- $rows :put vecs {k => v}",
             {"rows": [[i, data[i].tolist()] for i in range(n)]})
    return dbs, data


def test_ddl_and_search():
    dbs, data = seeded(100)
    run_both(dbs, HNSW)
    res = run_both(
        dbs, "?[k, d] := ~vecs:idx{k | query: q, k: 5, ef: 30, "
        "bind_distance: d}, q = vec($q)", {"q": data[7].tolist()})
    top = min(res.rows, key=lambda r: r[1])
    assert top[0] == 7 and abs(top[1]) < 1e-5
    run_both(dbs, "::indices vecs")


def test_incremental_put_and_rm():
    dbs, data = seeded(50)
    run_both(dbs, HNSW)
    run_both(dbs, "?[k, v] <- [[999, $v]] :put vecs {k => v}",
             {"v": (data[3] + 0.0001).tolist()})
    res = run_both(dbs, "?[k] := ~vecs:idx{k | query: vec($q), k: 2, ef: 30}",
                   {"q": data[3].tolist()})
    assert {r[0] for r in res.rows} == {3, 999}
    run_both(dbs, "?[k] <- [[7]] :rm vecs {k}")
    res = run_both(dbs, "?[k, d] := ~vecs:idx{k | query: vec($q), k: 3, "
                   "ef: 30, bind_distance: d}", {"q": data[7].tolist()})
    assert 7 not in [r[0] for r in res.rows]


def test_kv_image_queryable_and_rebuilt_from_kv():
    dbs, data = seeded(60)
    run_both(dbs, HNSW)
    run_both(dbs, "?[fr, to, d] := *vecs:idx{layer: 0, fr_k: fr, to_k: to, "
             "dist: d}, fr != to")
    run_both(dbs, "?[layer, count(fr)] := *vecs:idx{layer, fr_k: fr}")
    for db in dbs:
        db.algo_cache.clear()  # the next search rebuilds from the KV image
    res = run_both(dbs, "?[k, d] := ~vecs:idx{k | query: vec($q), k: 3, "
                   "ef: 30, bind_distance: d}", {"q": data[11].tolist()})
    assert min(res.rows, key=lambda r: r[1])[0] == 11
    cache = dbs[1].algo_cache["hnsw::vecs::idx"]
    assert type(cache.index).__module__ == "cozo_tpu_torch.models.hnsw_index"
    assert cache.index.device.type == "cpu"


def test_filter_radius_and_drop():
    dbs, data = seeded(60)
    run_both(dbs, HNSW)
    res = run_both(dbs, "?[k] := ~vecs:idx{k | query: vec($q), k: 10, "
                   "ef: 40, filter: k % 2 == 0}", {"q": data[10].tolist()})
    assert res.rows and all(r[0] % 2 == 0 for r in res.rows)
    res = run_both(dbs, "?[k, d] := ~vecs:idx{k | query: vec($q), k: 10, "
                   "ef: 40, radius: 0.001, bind_distance: d}",
                   {"q": data[10].tolist()})
    assert [r[0] for r in res.rows] == [10]
    run_both(dbs, "::hnsw drop vecs:idx")
    assert run_both(dbs, "::indices vecs").rows == []


def test_join_with_rule_and_two_hop():
    dbs, _ = seeded(80)
    run_both(dbs, "::hnsw create vecs:idx {dim: 8, m: 8, ef_construction: 40, "
             "fields: [v]}")
    res = run_both(dbs, """
        starters[q] := *vecs[3, q]
        starters[q] := *vecs[5, q]
        ?[k] := starters[q], ~vecs:idx{k | query: q, k: 1, ef: 20}
        """)
    assert sorted(r[0] for r in res.rows) == [3, 5]
    res = run_both(dbs, """
        first[k, v2] := ~vecs:idx{k, v: v2 | query: q, k: 1, ef: 20},
                        q = vec($q)
        ?[k2] := first[k, v2], ~vecs:idx{k: k2 | query: v2, k: 2, ef: 20},
                 k2 != k
        """, {"q": [float(i) for i in range(8)]})
    assert len(res.rows) >= 1
    res = run_both(dbs, """
        edges[fr, to] := *vecs:idx{layer: 0, fr_k: fr, to_k: to}, fr != to
        ?[label, node] <~ CommunityDetectionLouvain(edges[fr, to])
        """)
    assert len(res.rows) == 80


def test_f64_index():
    dbs = new_dbs()
    rng = np.random.default_rng(1)
    rows = [[i, rng.standard_normal(4).tolist()] for i in range(10)]
    run_both(dbs, ":create dv {id: Int => v: <F64; 4>}")
    run_both(dbs, "?[id, v] <- $rows :put dv {id => v}", {"rows": rows})
    run_both(dbs, "::hnsw create dv:idx {dim: 4, m: 8, ef_construction: 16, "
             "dtype: F64, fields: [v], distance: Cosine}")
    res = run_both(dbs, "?[id] := ~dv:idx{id | query: vec($q, 'F64'), k: 1, "
                   "ef: 8}", {"q": rows[3][1]})
    assert res.rows == [[3]]


# ----------------------------------------------------- the packed KV image

PN, PD = 60, 4
PVECS = np.random.default_rng(7).normal(size=(PN + 8, PD)).astype(np.float32)
PROWS = [[i, list(map(float, PVECS[i]))] for i in range(PN)]
PSEARCH = ("?[id, d] := ~pts:idx{id | query: vec($q), k: 8, ef: 48, "
           "bind_distance: d}")
PSCAN = "?[layer, fr_id, to_id, dist] := *pts:idx{layer, fr_id, to_id, dist}"


def packed_dbs(monkeypatch, packed_min, engine="mem", paths=("", "")):
    monkeypatch.setenv("COZO_TPU_PACKED_KV_MIN", str(packed_min))
    dbs = new_dbs(engine, *paths)
    run_both(dbs, ":create pts {id: Int => v: <F32; 4>}")
    run_both(dbs, "?[id, v] <- $rows :put pts {id => v}", {"rows": PROWS})
    run_both(dbs, "::hnsw create pts:idx {dim: 4, m: 8, ef_construction: 32, "
             "fields: [v], distance: L2}")
    monkeypatch.delenv("COZO_TPU_PACKED_KV_MIN")
    return dbs


def is_packed(db, pkg):
    import importlib

    hp = importlib.import_module(f"{pkg}.runtime.hnsw_packed")
    tx = db._new_session(False, 0)
    try:
        h = tx.get_relation("pts:idx")
        return h.packed_src is not None and hp.read_packed_meta(
            tx.store_tx_for(h), "pts", "idx") is not None
    finally:
        tx.abort()


def mutate(dbs):
    run_both(dbs, "?[id, v] <- [[100, $v]] :put pts {id => v}",
             {"v": list(map(float, PVECS[PN]))})
    run_both(dbs, "?[id, v] <- [[3, $v]] :put pts {id => v}",
             {"v": list(map(float, PVECS[PN + 1]))})
    run_both(dbs, "?[id] <- [[5]] :rm pts {id}")


@pytest.mark.parametrize("packed_min", [10, 10**9])
def test_packed_and_row_image_reads(monkeypatch, packed_min):
    dbs = packed_dbs(monkeypatch, packed_min)
    want = packed_min == 10
    assert is_packed(dbs[0], "cozo_tpu") == want
    assert is_packed(dbs[1], "cozo_tpu_torch") == want
    run_both(dbs, PSCAN)
    run_both(dbs, "?[count(fr_id)] := *pts:idx{layer, fr_id, to_id}")
    run_both(dbs, "?[to_id, dist] := *pts:idx{layer: 0, fr_id: 3, to_id, "
             "dist}")
    res = run_both(dbs, "?[dist] := *pts:idx{layer: 0, fr_id: 3, fr_field: 0, "
                   "to_id: 3, to_field: 0, dist}")
    assert res.rows == [[0.0]]
    mutate(dbs)
    run_both(dbs, PSEARCH, {"q": list(map(float, PVECS[7]))})
    scan = run_both(dbs, PSCAN).rows
    assert not any(r[1] == 5 or r[2] == 5 for r in scan)
    assert any(r[1] == 100 for r in scan)
    for db in dbs:
        db.algo_cache.clear()
    run_both(dbs, PSEARCH, {"q": list(map(float, PVECS[9]))})
    run_both(dbs, "nodes[fr_id, to_id] := *pts:idx{layer: 0, fr_id, to_id}\n"
             "?[id, pr] <~ PageRank(nodes[])\n:order id")
    run_both(dbs, "?[id, pr] <~ PageRank(*pts:idx{layer: 0, fr_id, to_id})\n"
             ":order id")


def test_packed_rebuild_after_reopen(monkeypatch, tmp_path):
    from tests.test_torch_db_scripts import new_dbs as reopen

    paths = (str(tmp_path / "j.db"), str(tmp_path / "t.db"))
    dbs = packed_dbs(monkeypatch, 10, "sqlite", paths)
    mutate(dbs)
    scan = run_both(dbs, PSCAN).rows
    found = run_both(dbs, PSEARCH, {"q": list(map(float, PVECS[7]))}).rows
    for db in dbs:
        db.close()
    dbs = reopen("sqlite", *paths)
    assert run_both(dbs, PSCAN).rows == scan
    assert run_both(dbs, PSEARCH, {"q": list(map(float, PVECS[7]))}).rows \
        == found


def test_packed_backup_restore_and_drop(monkeypatch, tmp_path):
    dbs = packed_dbs(monkeypatch, 10)
    mutate(dbs)
    scan = run_both(dbs, PSCAN).rows
    restored = new_dbs()
    for i, (db, db2) in enumerate(zip(dbs, restored)):
        bk = str(tmp_path / f"b{i}.db")
        db.backup_db(bk)
        db2.restore_backup(bk)
    assert run_both(restored, PSCAN).rows == scan
    run_both(restored, PSEARCH, {"q": list(map(float, PVECS[7]))})
    run_both(dbs, "::index drop pts:idx")
    run_both(dbs, "::indices pts")
    from cozo_tpu_torch.runtime import hnsw_packed as hp

    tx = dbs[1]._new_session(False, 0)
    try:
        p = hp._pfx("pts", "idx")
        assert list(tx.store_tx.range_scan(p, p + b"\xff" * 8)) == []
    finally:
        tx.abort()


# ------------------------------------------- the device lanes, 20,480 rows

NBIG, DBIG, NQ = 20_480, 16, 64
JOIN = ("?[qid, id, d] := *q{qid, qv}, ~item:ix{id | query: qv, k: 10, "
        "ef: 64, bind_distance: d}")


@pytest.fixture(scope="module")
def big_dbs():
    """Both Dbs holding the same 20,480 x 16 cosine index (built by the
    DDL: the device bulk build) and 64 stored queries."""
    from cozo_tpu_torch.utils.datasets import glove_like

    data = glove_like(NBIG + NQ, DBIG, seed=3)
    dbs = new_dbs()
    run_both(dbs, f":create item {{id: Int => v: <F32; {DBIG}>}}")
    run_both(dbs, "?[id, v] <- $rows :put item {id => v}",
             {"rows": [[i, data[i]] for i in range(NBIG)]})
    run_both(dbs, f"::hnsw create item:ix {{dim: {DBIG}, m: 8, dtype: F32, "
             "fields: [v], distance: Cosine, ef_construction: 32}")
    run_both(dbs, f":create q {{qid: Int => qv: <F32; {DBIG}>}}")
    run_both(dbs, "?[qid, qv] <- $rows :put q {qid => qv}",
             {"rows": [[i, data[NBIG + i]] for i in range(NQ)]})
    return dbs, data


def test_pivot_join_takes_the_sweep_lane(big_dbs, monkeypatch):
    """B = 64 queries on 20,480 rows: `HnswIndex.search` dispatches to the
    chunked sweep (bf16 + exact re-rank) in both packages; ids equal,
    distances within 1e-5."""
    from cozo_tpu_torch.ops import exact_knn

    dbs, _ = big_dbs
    calls = []
    real = exact_knn.sweep_search
    monkeypatch.setattr(exact_knn, "sweep_search",
                        lambda index, qs, k, **kw: calls.append(qs.shape)
                        or real(index, qs, k, **kw))
    res = run_both(dbs, JOIN, tol=1e-5)
    assert calls == [(NQ, DBIG)]
    assert len(res.rows) == NQ * 10
    assert dbs[1].algo_cache["hnsw::item::ix"].index._sweep_table is not None


def test_concurrent_joins_equal_sequential(big_dbs):
    """8 threads run small joins (each its own stored query set, B = 16) on
    one port Db at once: each answer equals the sequential one.  Then 8
    threads call `hnsw_search_device` on the Db's index (the small-batch
    path, on the CPU here; its mirror lock is held on the card by
    `test_torch_cuda.py`)."""
    from cozo_tpu_torch.ops import vector_search as vs

    dbs, data = big_dbs
    db = dbs[1]
    for t in range(8):
        db.run_script(f":create qs{t} {{qid: Int => qv: <F32; {DBIG}>}}")
        db.run_script(f"?[qid, qv] <- $rows :put qs{t} {{qid => qv}}",
                      {"rows": [[i, data[NBIG - 1000 * t - i]]
                                for i in range(16)]})
    scripts = [JOIN.replace("*q{", f"*qs{t}{{") for t in range(8)]
    want = [rows_sorted(db.run_script(s)) for s in scripts]
    index = db.algo_cache["hnsw::item::ix"].index
    qsets = [data[NBIG - 1000 * t - 16: NBIG - 1000 * t] for t in range(8)]
    want_dev = [vs.hnsw_search_device(index, q, 10, 64) for q in qsets]
    errors = []

    def worker(t):
        try:
            for _ in range(3):
                assert rows_sorted(db.run_script(scripts[t])) == want[t]
                ids, d = vs.hnsw_search_device(index, qsets[t], 10, 64)
                assert np.array_equal(ids, want_dev[t][0])
                assert np.array_equal(d, want_dev[t][1])
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)  # switch threads often: races show
    try:
        threads = [threading.Thread(target=worker, args=(t,))
                   for t in range(8)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=300)
    finally:
        sys.setswitchinterval(switch)
    assert not any(th.is_alive() for th in threads)
    assert not errors, errors
    assert all(len(w) == 160 for w in want)


def test_concurrent_sweep_joins_with_a_writer(big_dbs):
    """4 threads run the B = 64 pivot join (the sweep lane, whose table a
    refresh scatters in place) while a writer removes rows one by one:
    every answer equals the sequential answer at one of the writer's
    versions (the sweep table's lock; the Db cache's lock keeps a search
    and its slot -> id mapping on one version), and after the writer
    stops one refresh leaves the table equal to a full rebuild.  The rows
    are put back at the end."""
    from cozo_tpu_torch.ops.exact_knn import SweepTable

    dbs, data = big_dbs
    db = dbs[1]
    # the rows to remove: the first 6 queries' nearest, each changes an answer
    first = rows_sorted(db.run_script(JOIN))
    gone = []
    for qid in range(6):
        near = min((r for r in first if r[0] == qid), key=lambda r: r[2])[1]
        if near not in gone:
            gone.append(near)
    rm = "?[id] <- [[$id]] :rm item {id}"
    put = "?[id, v] <- [[$id, $v]] :put item {id => v}"
    answers = [first]
    for i in gone:
        db.run_script(rm, {"id": i})
        answers.append(rows_sorted(db.run_script(JOIN)))
    for i in gone:
        db.run_script(put, {"id": i, "v": data[i]})
    assert rows_sorted(db.run_script(JOIN)) == first
    assert len({tuple(a) for a in answers}) == len(answers)
    errors, seen, done = [], set(), threading.Event()

    def reader():
        try:
            while not done.is_set():
                got = rows_sorted(db.run_script(JOIN))
                assert got in answers, "an answer of no version"
                seen.add(answers.index(got))
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    def writer():
        try:
            for i in gone:
                db.run_script(rm, {"id": i})
                time.sleep(0.05)
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)
        finally:
            done.set()

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=reader) for _ in range(4)]
        threads.append(threading.Thread(target=writer))
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=300)
    finally:
        sys.setswitchinterval(switch)
    assert not any(th.is_alive() for th in threads)
    assert not errors, errors
    assert rows_sorted(db.run_script(JOIN)) == answers[-1]
    index = db.algo_cache["hnsw::item::ix"].index
    st = index._sweep_table
    with st.lock:
        st.refresh(index)
        full = SweepTable(st.device)
        full.refresh(index)
        assert torch.equal(st.tbl, full.tbl) and torch.equal(st.bias, full.bias)
    for i in gone:
        db.run_script(put, {"id": i, "v": data[i]})
    assert rows_sorted(db.run_script(JOIN)) == first


def test_sweep_refresh_excludes_readers_and_keeps_concurrent_writes(
        monkeypatch):
    """What arrives while a refresh is scattering (a hook inside the
    refresh runs it there): a writer's slot, added after the refresh took
    its pending set, is applied by the next refresh, which leaves the
    table equal to a full rebuild; a reader waits for the refresh, so it
    never reads the table half written."""
    from cozo_tpu_torch import HnswIndex
    from cozo_tpu_torch.ops.exact_knn import SweepTable, sweep_search

    rng = np.random.default_rng(8)
    data = rng.standard_normal((3000, 16)).astype(np.float32)
    index = HnswIndex(dim=16, m=8, ef_construction=32, device="cpu")
    index.bulk_build(data, wave=1024)
    qs = data[:64]
    sweep_search(index, qs, 10)
    st = index._sweep_table
    real = SweepTable._prep_rows

    def during_refresh(action):
        fired = []

        def hook(idx, slots):
            if not fired:
                fired.append(1)
                action(idx)
            return real(idx, slots)

        monkeypatch.setattr(SweepTable, "_prep_rows", staticmethod(hook))

    index.remove(5)
    during_refresh(lambda idx: idx.remove(7))  # a writer mid-refresh
    ids, _ = sweep_search(index, qs, 10)
    assert 5 not in ids
    monkeypatch.setattr(SweepTable, "_prep_rows", staticmethod(real))
    with st.lock:
        st.refresh(index)
        full = SweepTable(st.device)
        full.refresh(index)
        assert torch.equal(st.tbl, full.tbl) and torch.equal(st.bias, full.bias)
    assert float(st.bias.view(-1)[7]) == float("-inf")

    readers = []

    def reader(idx):
        th = threading.Thread(target=sweep_search, args=(idx, qs, 10))
        th.start()
        th.join(timeout=0.5)
        readers.append((th, th.is_alive()))

    index.remove(9)
    during_refresh(reader)
    ids, _ = sweep_search(index, qs, 10)
    th, waited = readers[0]
    th.join(timeout=60)
    assert waited and not th.is_alive()
    assert not np.isin(ids, [5, 7, 9]).any()


def test_db_small_batches_take_the_beam_search(monkeypatch):
    """B = 4 and 63 stored queries joined against an index past 131,072
    rows (a navigable line, made without a build) reach
    `hnsw_search_device` through the port's Db, and the rows equal
    `HnswIndex.search` called directly on the same index; B = 64 takes
    the sweep."""
    from cozo_tpu_torch import Db, HnswIndex
    from cozo_tpu_torch.ops import vector_search as vs
    from tests._torch_state import line_state

    n = 140_000
    state = line_state(n)
    monkeypatch.setenv("COZO_TPU_F32_TABLE_MAX", str(8 << 30))
    monkeypatch.setenv("COZO_TPU_PACKED_KV_MIN", "100000")

    def from_line(self, data, wave=8192):
        assert np.array_equal(data, state["vectors"])
        self.__dict__.update(HnswIndex.from_state(state, device="cpu")
                             .__dict__)
        return list(range(n))

    monkeypatch.setattr(HnswIndex, "bulk_build", from_line)
    db = Db("mem", device="cpu")
    db.run_script(":create item {id: Int => v: <F32; 2>}")
    db.run_script("?[id, v] <- $rows :put item {id => v}",
                  {"rows": [[i, state["vectors"][i]] for i in range(n)]})
    db.run_script("::hnsw create item:ix {dim: 2, m: 8, dtype: F32, "
                  "fields: [v], distance: L2, ef_construction: 16}")
    index = db.algo_cache["hnsw::item::ix"].index
    assert index.n == n and np.array_equal(index.neighbors[0],
                                           state["neighbors"][0])
    rng = np.random.default_rng(5)
    calls = []
    real = vs.hnsw_search_device
    monkeypatch.setattr(vs, "hnsw_search_device",
                        lambda *a, **kw: calls.append(a[1].shape[0])
                        or real(*a, **kw))
    for B in (4, 63, 64):
        qs = np.stack([rng.random(B), rng.random(B) * 1e-3], 1).astype(
            np.float32)
        rel = f"q{B}"
        db.run_script(f":create {rel} {{qid: Int => qv: <F32; 2>}}")
        db.run_script(f"?[qid, qv] <- $rows :put {rel} {{qid => qv}}",
                      {"rows": [[i, qs[i]] for i in range(B)]})
        del calls[:]
        res = db.run_script(JOIN.replace("*q{", f"*{rel}{{"))
        assert calls == ([B] if B < 64 else [])
        ids, d = index.search(qs, 10, 64)
        want = sorted((q, int(ids[q, j]), float(d[q, j]))
                      for q in range(B) for j in range(10) if ids[q, j] >= 0)
        assert rows_sorted(res) == want

