"""The port's server and CPython's cyclic collector
(`cozo_tpu_torch/hosts/server.py`, `serve`, and the
index maps of `cozo_tpu_torch/runtime/hnsw.py`, `HnswCache.put_item`).

A full collection holds the GIL and so stops every request thread; after
a large answer the next one walks every object the collector tracks.
`serve` freezes the heap it finds, so that pass walks only what serving
made; and an index's slot maps keep no tracked object a row, so a Db that
builds them after serving starts does not bring the walk back.  The maps'
Db still answers as the JAX package's Db does.  While a whole-graph rule's
answer is built for `run_script_json`, its rows are tuples the collector
stops tracking, and the JSON text is the one a list a row gives."""

import gc
import json
import threading
import urllib.request

import numpy as np
import pytest

from cozo_tpu_torch import Db
from cozo_tpu_torch.hosts.server import serve
from tests.test_torch_db_scripts import new_dbs, run_both

ROWS = 30_000  # the large answer's rows: one list a row while it is built
INDEXED = 2_000
# Objects a full pass may walk after the answer: what the request, the
# server's thread and this test made since `serve`.  The heap `serve`
# found (the interpreter's, torch's, numpy's and the JAX package's
# modules, the Db) is over 150,000 objects on its own.
WALKED_BAR = 20_000


@pytest.fixture()
def thawed():
    """`serve` freezes the whole process's heap: give it back after."""
    yield
    gc.unfreeze()


def _db_with_rows():
    db = Db("mem", device="cpu")
    db.run_script(":create big {a: Int => b: Int}")
    db.run_script("?[a, b] <- $rows :put big {a => b}",
                  {"rows": [[a, a * 7 % 1009] for a in range(ROWS)]})
    vecs = np.random.default_rng(3).standard_normal((INDEXED, 8)).astype(
        np.float32)
    db.run_script(":create vecs {k: Int => v: <F32; 8>}")
    db.run_script("?[k, v] <- $rows :put vecs {k => v}",
                  {"rows": [[i, vecs[i].tolist()] for i in range(INDEXED)]})
    db.run_script("::hnsw create vecs:idx {dim: 8, m: 8, ef_construction: 32, "
                  "fields: [v]}")
    return db


def test_a_full_pass_after_a_large_answer_walks_what_serving_made(thawed):
    db = _db_with_rows()
    srv = serve(db, "127.0.0.1", 0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.server_address[1]}/text-query",
            data=json.dumps({"script": "?[a, b] := *big[a, b]"}).encode(),
            method="POST", headers={"content-type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as resp:
            raw = resp.read()
        got = json.loads(raw)["rows"]
        assert len(got) == ROWS and got[7] == [7, 49]
        del got, raw
        walked = len(gc.get_objects())  # generations 0-2: a full pass's walk
        frozen = gc.get_freeze_count()
    finally:
        srv.shutdown()
        srv.server_close()
    assert walked < WALKED_BAR, (
        f"the next full pass walks {walked} objects ({frozen} frozen)")
    assert frozen > WALKED_BAR


def _tracked_entries(cache):
    """Entries of the maps the collector still tracks after two full passes
    (the first untracks the key tuples, the second the pairs holding
    them)."""
    gc.collect()
    gc.collect()
    return (sum(map(gc.is_tracked, cache.slot_to_item.values()))
            + sum(map(gc.is_tracked, cache.key_to_slot)))


KEYED = ("::hnsw create docs:idx {dim: 4, m: 8, ef_construction: 32, "
         "fields: [v], distance: L2}")
KSEARCH = ("?[name, part, d] := ~docs:idx{name, part | query: vec($q), k: 6, "
           "ef: 40, bind_distance: d}")
KSCAN = ("?[layer, fr_name, fr_part, to_name, to_part, dist] := "
         "*docs:idx{layer, fr_name, fr_part, to_name, to_part, dist}")


def test_index_maps_keep_no_tracked_object_a_row_and_answer_as_jax():
    """A two-column key (a string and an int) through every path that
    fills the maps: the DDL build, `:put` / `:rm`, a rebuild from the row
    image; each step's answers equal to the JAX Db's."""
    rng = np.random.default_rng(8)
    vecs = rng.standard_normal((300, 4)).astype(np.float32)
    dbs = new_dbs()
    run_both(dbs, ":create docs {name: String, part: Int => v: <F32; 4>}")
    run_both(dbs, "?[name, part, v] <- $rows :put docs {name, part => v}",
             {"rows": [[f"d{i % 97}", i, vecs[i].tolist()]
                       for i in range(300)]})
    run_both(dbs, KEYED)
    port = dbs[1]
    run_both(dbs, KSEARCH, {"q": vecs[5].tolist()})
    run_both(dbs, "?[name, part, v] <- [['new', 1, $v]] :put docs "
             "{name, part => v}", {"v": (vecs[9] * 1.01).tolist()})
    run_both(dbs, "?[name, part] <- [['d9', 9]] :rm docs {name, part}")
    before = run_both(dbs, KSEARCH, {"q": vecs[9].tolist()}).rows
    run_both(dbs, KSCAN)
    cache = port.algo_cache["hnsw::docs::idx"]
    assert len(cache.slot_to_item) == 300 and _tracked_entries(cache) == 0
    for db in dbs:
        db.algo_cache.clear()  # rebuilt from the row image
    assert run_both(dbs, KSEARCH, {"q": vecs[9].tolist()}).rows == before
    run_both(dbs, KSCAN)
    assert _tracked_entries(port.algo_cache["hnsw::docs::idx"]) == 0


def test_packed_index_maps_after_a_write_keep_no_tracked_object(monkeypatch):
    """A packed index (one Int key, slot ids in an array) fills its maps at
    its first write (`ensure_maps`): they too hold no tracked object."""
    monkeypatch.setenv("COZO_TPU_PACKED_KV_MIN", "10")
    rng = np.random.default_rng(9)
    vecs = rng.standard_normal((400, 4)).astype(np.float32)
    dbs = new_dbs()
    run_both(dbs, ":create pts {id: Int => v: <F32; 4>}")
    run_both(dbs, "?[id, v] <- $rows :put pts {id => v}",
             {"rows": [[i, vecs[i].tolist()] for i in range(400)]})
    run_both(dbs, "::hnsw create pts:idx {dim: 4, m: 8, ef_construction: 32, "
             "fields: [v], distance: L2}")
    cache = dbs[1].algo_cache["hnsw::pts::idx"]
    assert cache.slot_ids is not None
    run_both(dbs, "?[id, v] <- [[1000, $v]] :put pts {id => v}",
             {"v": vecs[3].tolist()})
    run_both(dbs, "?[id, d] := ~pts:idx{id | query: vec($q), k: 5, ef: 32, "
             "bind_distance: d}", {"q": vecs[3].tolist()})
    run_both(dbs, "?[layer, fr_id, to_id, dist] := "
             "*pts:idx{layer, fr_id, to_id, dist}")
    assert cache.slot_ids is None and len(cache.slot_to_item) == 401
    assert _tracked_entries(cache) == 0


# -- a large answer's rows while it is built ----------------------------------

RULE_NODES = 20_000  # a whole-graph rule's answer: a row a node
RULES = ("?[n, s] <~ PageRank(*e[], iterations: 10)",
         "?[l, n] <~ LabelPropagation(*e[])")
# Objects in the collector's two older generations at the start of any pass
# while a rule's answer is built and written: rows that a young pass left
# tracked move there, and every full pass walks them (at 20,000 rows a list
# a row put some 39,000 there, at 80,000 some 158,000).
OLD_BAR = 1_000


def _graph_db(n):
    db = Db("mem", device="cpu")
    edges = np.random.default_rng(n).integers(0, n, (3 * n, 2))
    db.run_script(":create e {a: Int, b: Int}")
    db.run_script("?[a, b] <- $rows :put e {a, b}", {"rows": edges.tolist()})
    return db


@pytest.mark.parametrize("script", RULES + ("?[a, b] := *e[a, b]",))
def test_a_large_answer_s_json_is_the_text_of_its_rows(script):
    """`run_script_json` writes the text `json.dumps` writes of the answer
    as `run_script` returns it (a list a row), byte for byte."""
    db = _graph_db(RULE_NODES)
    text = db.run_script_json(script)
    want = db.run_script(script).to_dict()
    assert isinstance(want["rows"][0], list) and len(want["rows"]) > 1000
    want["ok"] = True
    want["took"] = json.loads(text)["took"]
    assert text == json.dumps(want)


@pytest.mark.parametrize("script", RULES)
def test_building_a_rule_s_answer_leaves_no_tracked_row(thawed, script):
    """While `run_script_json` builds a whole-graph rule's answer, its rows
    are tuples of atoms, which a young pass stops tracking: the older
    generations hold under OLD_BAR objects at every pass, at 20,000 rows
    and at 80,000 alike."""
    peaks = []
    for n in (RULE_NODES, 4 * RULE_NODES):
        db = _graph_db(n)
        db.run_script_json(script)  # the graph's staging, cached
        gc.collect()
        gc.freeze()
        peak = [0]

        def on_gc(phase, info):
            if phase == "start":
                peak[0] = max(peak[0], len(gc.get_objects(generation=1))
                              + len(gc.get_objects(generation=2)))

        gc.callbacks.append(on_gc)
        try:
            text = db.run_script_json(script)
        finally:
            gc.callbacks.remove(on_gc)
            gc.unfreeze()
        assert len(json.loads(text)["rows"]) > n // 2
        peaks.append(peak[0])
    assert max(peaks) < OLD_BAR, peaks
