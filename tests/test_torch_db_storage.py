"""Stored state through `cozo_tpu_torch.Db` against `cozo_tpu.Db` (on the
CPU): the bulk vector `:put` lane and the key encoding (the two packages'
KV images compared byte for byte), lateral indexes, a `sqlite` file
written by one package and opened by the other (both ways, with an HNSW
index in the row image and in the packed image), the graph fixed rules
below the device threshold, FTS and LSH indexes in a `sqlite` file
written by one package and served and maintained by the other (both
ways), and the branches that are not ported yet."""

import shutil

import numpy as np
import pytest

from tests.test_torch_db_scripts import new_dbs, norm, rows_sorted, run_both, same

D = 8
EDGE_F32 = np.array([0.0, -0.0, 1.5, -1.5, np.inf, -np.inf,
                     np.float32(1e-40), np.finfo(np.float32).max],
                    dtype=np.float32)


def kv_image(db):
    tx = db.storage.transact(write=False)
    try:
        return list(tx.total_scan())
    finally:
        tx.abort()


def test_bulk_vector_put_kv_bytes_equal():
    """ndarray rows take the bulk lane, plain lists the generic one; edge
    floats, NaN, duplicate keys in one batch and the F64 lane: both
    packages store the same bytes."""
    dbs = new_dbs()
    run_both(dbs, f":create item {{id: Int => v: <F32; {D}>}}")
    run_both(dbs, f":create item64 {{id: Int => v: <F64; {D}>}}")
    rng = np.random.default_rng(3)
    vecs = rng.normal(size=(32, D)).astype(np.float32)
    vecs[0], vecs[1] = EDGE_F32, -EDGE_F32
    vecs[2] = np.nan
    put = "?[id, v] <- $rows :put item {id => v}"
    run_both(dbs, put, {"rows": [[int(i), vecs[i]] for i in range(32)]})
    run_both(dbs, put, {"rows": [[40, vecs[3]], [40, vecs[4]], [40, vecs[3]]]})
    run_both(dbs, put, {"rows": [[41, vecs[5].tolist()],
                                 [41, vecs[6].tolist()]]})
    run_both(dbs, "?[id, v] <- $rows :put item64 {id => v}",
             {"rows": [[0, EDGE_F32.astype(np.float64)],
                       [1, -EDGE_F32.astype(np.float64)]]})
    assert kv_image(dbs[0]) == kv_image(dbs[1])
    res = run_both(dbs, "?[id, v] := *item{id, v}, id < 2")
    for i, v in res.rows:
        assert np.array_equal(v.a.view(np.uint32),
                              vecs[i].view(np.uint32))


INDEX_SEED = [
    ":create person {id: Int => name: String, age: Int}",
    ("?[id, name, age] <- $rows :put person {id => name, age}",
     {"rows": [[i, f"p{i}", 20 + (i % 50)] for i in range(200)]}),
    "::index create person:by_name {name}",
    "::index create person:by_age {age, name}",
]


def test_lateral_indexes():
    dbs = new_dbs()
    for step in INDEX_SEED:
        run_both(dbs, *(step if isinstance(step, tuple) else (step,)))
    for script in (
            "?[id] := *person{id, name: 'p42'}",
            "?[name] := *person{name, age: 25}",
            "?[id, name] := *person{id, name, age: 30}",
            "?[id, name, age] <- [[999, 'zz', 99]] :put person "
            "{id => name, age}",
            "?[id] := *person{id, name: 'zz'}",
            "?[id] <- [[999]] :rm person {id}",
            "?[id] := *person{id, name: 'zz'}",
            "?[name, id] := *person:by_name[name, id] :limit 3",
            "?[id] := *person[id, name, age], id >= 5, id < 8",
            "?[id] := *person[id, name, age], id == 17",
            "::indices person",
            "::index drop person:by_name",
            "?[id] := *person{id, name: 'p42'}"):
        run_both(dbs, script)
    assert kv_image(dbs[0]) == kv_image(dbs[1])


STATE_SCRIPTS = [
    "?[id, name] := *person{id, name}, id < 20",
    "?[age, count(id)] := *person{id, age}",
    "?[id, d] := ~pts:rows{id | query: vec($q), k: 6, ef: 32, "
    "bind_distance: d}",
    "?[id, d] := ~pts:packed{id | query: vec($q), k: 6, ef: 32, "
    "bind_distance: d}",
    "?[layer, fr_id, to_id, dist] := *pts:rows{layer, fr_id, to_id, dist}",
    "?[layer, fr_id, to_id, dist] := *pts:packed{layer, fr_id, to_id, dist}",
    "::relations",
    "::indices pts",
]


def write_state(db):
    vecs = np.random.default_rng(5).normal(size=(80, 4)).astype(np.float32)
    for step in INDEX_SEED:
        db.run_script(*(step if isinstance(step, tuple) else (step,)))
    db.run_script(":create pts {id: Int => v: <F32; 4>}")
    db.run_script("?[id, v] <- $rows :put pts {id => v}",
                  {"rows": [[i, vecs[i]] for i in range(80)]})
    db.run_script("::hnsw create pts:rows {dim: 4, m: 8, ef_construction: 32, "
                  "fields: [v], distance: L2}")
    db.run_script("::hnsw create pts:packed {dim: 4, m: 8, "
                  "ef_construction: 32, fields: [v], distance: Cosine}")
    # a write after the build: the packed image gets its row overlay
    db.run_script("?[id, v] <- [[3, $v]] :put pts {id => v}",
                  {"v": vecs[79] + 0.5})
    db.run_script("?[id] <- [[5]] :rm pts {id}")
    return vecs


@pytest.mark.parametrize("writer", ["cozo_tpu", "cozo_tpu_torch"])
def test_sqlite_file_opens_in_the_other_package(writer, tmp_path,
                                                monkeypatch):
    """A sqlite file written by one package (a relation, a lateral index,
    an HNSW index in the row image and one in the packed image, each
    mutated after its build) opens in both packages, which answer the
    same scripts with the same rows; the port rebuilds its index caches
    from that KV state."""
    import cozo_tpu
    import cozo_tpu_torch

    path = str(tmp_path / "w.db")
    monkeypatch.setenv("COZO_TPU_PACKED_KV_MIN", "50")
    if writer == "cozo_tpu":
        w = cozo_tpu.Db("sqlite", path)
    else:
        w = cozo_tpu_torch.Db("sqlite", path, device="cpu")
    vecs = write_state(w)
    monkeypatch.delenv("COZO_TPU_PACKED_KV_MIN")
    before = {s: rows_sorted(w.run_script(s, {"q": vecs[7]}))
              for s in STATE_SCRIPTS}
    w.close()
    shutil.copy(path, tmp_path / "r.db")
    dbs = new_dbs("sqlite", path, str(tmp_path / "r.db"))
    for s in STATE_SCRIPTS:
        res = run_both(dbs, s, {"q": vecs[7]})
        # distances of the packed view follow the norms, which a cache
        # rebuilt from KV sums in another order than the writer's inserts
        assert same(norm(rows_sorted(res)), norm(before[s]), tol=1e-12), s
    packed = dbs[1].algo_cache["hnsw::pts::packed"]
    assert packed.packed and packed.index.device.type == "cpu"
    assert type(packed.index) is cozo_tpu_torch.HnswIndex


# ------------------------------------------------ fixed rules on the host


def graph_rows(n_edges, n_nodes, seed):
    rng = np.random.default_rng(seed)
    fr = rng.integers(0, n_nodes, n_edges)
    to = rng.integers(0, n_nodes, n_edges)
    w = rng.uniform(0.5, 2.0, n_edges).round(3)
    return [[int(a), int(b), float(c)] for a, b, c in zip(fr, to, w)]


@pytest.mark.parametrize("script", [
    "?[n, s] <~ PageRank(*g[fr, to])",
    "?[n, s] <~ PageRank(*g[fr, to], undirected: true, iterations: 30)",
    "st[n] <- [[0], [7]]; "
    "?[s, g, c, p] <~ ShortestPathDijkstra(*g[fr, to, w], st[])",
    "?[l, n] <~ LabelPropagation(*g[fr, to])",
    "?[l, n] <~ LabelPropagation(*g[fr, to, w], max_iter: 20)",
    "?[c, n] <~ ConnectedComponents(*g[fr, to])",
])
def test_graph_rules_below_the_device_threshold(script):
    """PageRank, SSSP (Dijkstra) and LabelPropagation on a 2,000-edge graph
    (under the 50,000-edge device threshold): the same rows."""
    dbs = new_dbs()
    run_both(dbs, "?[fr, to, w] <- $rows :create g {fr, to => w}",
             {"rows": graph_rows(2000, 300, 11)})
    res = run_both(dbs, script)
    assert res.rows


# ------------------------------------------- text indexes in a sqlite file


FTS_SCRIPTS = [
    "?[id, s] := ~doc:ft{id | query: 'hello', k: 5, bind_score: s}",
    "?[id] := ~doc:ft{id | query: 'hel* OR world', k: 5}",
    "?[tok, id, pos, n] := *doc:ft{token: tok, src_id: id, positions: pos, "
    "doc_len: n}",
    "?[id, s] := ~doc:sim{id | query: 'hello big world', k: 5, "
    "bind_similarity: s}",
    "?[id, sig] := *doc:sim:inv{id, signature: sig}",
]
FTS_WRITES = [
    "?[id, text] <- [[2, 'hello there'], [3, 'a big world']] "
    ":put doc {id => text}",
    "?[id] <- [[1]] :rm doc {id}",
    "?[id, text] <- [[3, 'hello again']] :put doc {id => text}",
]


@pytest.mark.parametrize("writer", ["cozo_tpu", "cozo_tpu_torch"])
def test_text_indexes_in_sqlite_are_served_by_the_other_package(writer,
                                                                 tmp_path):
    """An FTS and an LSH index written by one package into a sqlite file
    are searched, and kept up to date on `:put` and `:rm`, by the other
    with the same rows (searches and the index relations' own rows)."""
    import cozo_tpu
    import cozo_tpu_torch

    path = str(tmp_path / "w.db")
    if writer == "cozo_tpu":
        w = cozo_tpu.Db("sqlite", path)
    else:
        w = cozo_tpu_torch.Db("sqlite", path, device="cpu")
    w.run_script(":create doc {id: Int => text: String}")
    w.run_script("?[id, text] <- [[1, 'hello world'], [4, 'big world']] "
                 ":put doc {id => text}")
    w.run_script("::fts create doc:ft {extractor: text, tokenizer: Simple}")
    w.run_script("::lsh create doc:sim {extractor: text, tokenizer: Simple, "
                 "n_perm: 32, target_threshold: 0.5}")
    w.close()
    shutil.copy(path, tmp_path / "r.db")
    dbs = new_dbs("sqlite", path, str(tmp_path / "r.db"))
    for s in FTS_SCRIPTS:
        run_both(dbs, s)
    for write in FTS_WRITES:
        run_both(dbs, write)
        for s in FTS_SCRIPTS:
            run_both(dbs, s)
    res = run_both(dbs, FTS_SCRIPTS[0])
    assert sorted(r[0] for r in res.rows) == [2, 3]


# ----------------------------------------------------- not ported yet


def test_unported_branches_raise_naming_their_item(tmp_path):
    """Each branch that is not ported raises `NotImplementedError` naming
    its ROADMAP item, and nothing answers in its place: the storage
    engines other than `mem` and `sqlite`."""
    import cozo_tpu_torch

    for engine in ("tkv", "plog", "remote"):
        with pytest.raises(NotImplementedError, match="item 4"):
            cozo_tpu_torch.Db(engine, str(tmp_path / engine), device="cpu")
