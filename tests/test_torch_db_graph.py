"""The graph fixed rules at and above the device threshold (50,000 edges)
through `cozo_tpu_torch.Db` against `cozo_tpu.Db` (both on the CPU): the
port runs the plain versions of its graph kernels, the JAX package its
jitted device functions.

Rows are compared as `run_both` does: equal, except PageRank's scores,
held to 1e-6 (`tol`): the JAX device path sums each node's in-edges as
the difference of an f32 prefix sum, about 1e-8 off a node here
(`tests/test_torch_graph_algos.py` measures it), and the port sums
directly.  LabelPropagation's weights are k/8, so its sums are exact in
either package's order.  Also: the proximity-graph form that
`chip_smoke.py` phase 6 uses reaches the index-array staging
(`fixed_payload._hnsw_layer0_fast`)."""

import numpy as np
import pytest

from tests.test_torch_db_scripts import new_dbs, rows_sorted, run_both
from tests.test_torch_db_storage import graph_rows

N_EDGES, N_NODES = 60_000, 5_000


def dyadic_rows(n_edges, n_nodes, seed, hub=0):
    """Edges with k/8 weights; `hub` more edges into node 1."""
    rng = np.random.default_rng(seed)
    fr = rng.integers(0, n_nodes, n_edges + hub)
    to = np.concatenate([rng.integers(0, n_nodes, n_edges),
                         np.ones(hub, np.int64)])
    w = rng.integers(1, 17, n_edges + hub) / 8
    return [[int(a), int(b), float(c)] for a, b, c in zip(fr, to, w)]


@pytest.fixture(scope="module")
def dbs():
    out = new_dbs()
    run_both(out, "?[fr, to, w] <- $rows :create big {fr, to => w}",
             {"rows": graph_rows(N_EDGES, N_NODES, 12)})
    run_both(out, "?[fr, to, w] <- $rows :create hub {fr, to => w}",
             {"rows": dyadic_rows(N_EDGES, N_NODES, 13, hub=400)})
    return out


@pytest.mark.parametrize("script", [
    "?[n, s] <~ PageRank(*big[fr, to])",
    "?[n, s] <~ PageRank(*big[fr, to], undirected: true, iterations: 20)",
    "?[n, s] <~ PageRank(*hub[fr, to], theta: 0.7)",
], ids=["directed", "undirected", "hub"])
def test_pagerank_through_both_dbs(dbs, script):
    res = run_both(dbs, script, tol=1e-6)
    assert len(res.rows) >= N_NODES - 5
    assert abs(sum(r[1] for r in res.rows) - 1.0) < 1e-4


@pytest.mark.parametrize("script", [
    "st[n] <- [[0], [7]]; "
    "?[s, g, c, p] <~ ShortestPathDijkstra(*big[fr, to, w], st[])",
    "st[n] <- [[3]]; gl[n] <- [[1], [2], [4000]]; "
    "?[s, g, c, p] <~ ShortestPathDijkstra(*hub[fr, to, w], st[], gl[])",
    "st[n] <- [[5]]; "
    "?[s, g, c, p] <~ ShortestPathDijkstra(*big[fr, to], st[], "
    "undirected: true)",
], ids=["weighted", "hub-goals", "unweighted-undirected"])
def test_sssp_through_both_dbs(dbs, script):
    """Costs and paths equal (the ELL route; a hub past 1,024 in-edges in
    the second graph's undirected form is not needed: 400 + ~12)."""
    res = run_both(dbs, script)
    assert res.rows


@pytest.mark.parametrize("script", [
    "?[l, n] <~ LabelPropagation(*big[fr, to])",
    "?[l, n] <~ LabelPropagation(*hub[fr, to, w], max_iter: 6)",
    "?[l, n] <~ LabelPropagation(*hub[fr, to])",
    "?[l, n] <~ LabelPropagation(*hub[fr, to], degree_cap: 64)",
], ids=["dense", "hybrid-weighted", "hybrid", "capped"])
def test_labelprop_through_both_dbs(dbs, script):
    """The dense layout (in-degrees <= 128), the hybrid lanes (a hub of
    400 in-edges), the capped layout: the same communities, numbered
    alike."""
    res = run_both(dbs, script)
    assert len(res.rows) >= N_NODES - 5


def test_port_db_runs_the_graph_rules_on_its_device(dbs, monkeypatch):
    """A CPU Db hands `device="cpu"` to the entry points (so they run the
    plain versions), and the kernels' wrappers are reached."""
    from cozo_tpu_torch.ops import graph_algos as ga

    seen = []
    for name in ("pagerank_jax", "sssp_device", "labelprop_jax"):
        real = getattr(ga, name)
        monkeypatch.setattr(ga, name, lambda *a, _real=real, _name=name, **k:
                            seen.append((_name, str(k.get("device"))))
                            or _real(*a, **k))
    db = dbs[1]
    db.run_script("?[n, s] <~ PageRank(*big[fr, to])")
    db.run_script("st[n] <- [[0]]; "
                  "?[s, g, c, p] <~ ShortestPathDijkstra(*big[fr, to, w], st[])")
    db.run_script("?[l, n] <~ LabelPropagation(*big[fr, to])")
    assert seen == [("pagerank_jax", "cpu"), ("sssp_device", "cpu"),
                    ("labelprop_jax", "cpu")]


def test_proximity_graph_form_reaches_the_index_staging(monkeypatch):
    """`*item:ix{layer: 0, fr_id: fr, to_id: to}` as a fixed rule's input
    stages the level-0 graph from the index arrays
    (`_hnsw_layer0_fast`), and PageRank, LabelPropagation and SSSP over it
    equal the same rules over the graph materialised as a relation."""
    from cozo_tpu_torch import Db
    from cozo_tpu_torch.query import fixed_payload

    calls = []
    real = fixed_payload.FixedInput._hnsw_layer0_fast

    def spy(self):
        out = real(self)
        calls.append(out is not None)
        return out

    monkeypatch.setattr(fixed_payload.FixedInput, "_hnsw_layer0_fast", spy)
    n, d = 5000, 8
    data = np.random.default_rng(9).standard_normal((n, d)).astype(np.float32)
    db = Db("mem", device="cpu")
    db.run_script(f":create item {{id: Int => v: <F32; {d}>}}")
    db.run_script("?[id, v] <- $rows :put item {id => v}",
                  {"rows": [[i, data[i]] for i in range(n)]})
    db.run_script(f"::hnsw create item:ix {{dim: {d}, m: 16, dtype: F32, "
                  "fields: [v], distance: L2, ef_construction: 32}")
    prox = "*item:ix{layer: 0, fr_id: fr, to_id: to}"
    db.run_script(":create prox {fr: Int, to: Int}")
    db.run_script(f"?[fr, to] := {prox} :put prox {{fr, to}}")
    n_edges = db.run_script("?[count(fr)] := *prox{fr}").rows[0][0]
    assert n_edges >= 50_000  # the device path
    db.run_script(":create st {id: Int}")
    db.run_script("?[id] <- [[0], [11]] :put st {id}")
    for rule in ("PageRank({g})", "LabelPropagation({g}, undirected: true)",
                 "ShortestPathDijkstra({g}, *st[id])"):
        head = "?[s, g, c, p]" if "Shortest" in rule else "?[a, b]"
        del calls[:]
        via_index = db.run_script(f"{head} <~ " + rule.format(g=prox))
        assert calls and all(calls)
        via_rel = db.run_script(f"{head} <~ " + rule.format(g="*prox[fr, to]"))
        assert rows_sorted(via_index) == rows_sorted(via_rel)
