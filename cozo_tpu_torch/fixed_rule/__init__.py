"""Fixed rules (whole-graph algorithms + utilities).

Mirrors the reference registry `DEFAULT_FIXED_RULES`
(`cozo-core/src/fixed_rule/mod.rs:706-836`).  Interface:

    class FixedRule:
        def arity(self, options, head) -> Optional[int]
        def run(self, payload, out_put, poison) -> None

Graph algorithms stage inputs as numpy CSR (payload.as_directed_graph)
and dispatch the heavy iterations to the TPU kernels in
`cozo_tpu.ops.graph_algos` when the graph is large enough to amortize a
device launch; small graphs run the numpy path."""

from __future__ import annotations

from typing import Any, Dict, Optional

from ..utils.errors import QueryError


class FixedRule:
    name = "FixedRule"

    def arity(self, options, head) -> Optional[int]:
        raise NotImplementedError

    def run(self, payload, out_put, poison) -> None:
        raise NotImplementedError


class SimpleFixedRule(FixedRule):
    """Wraps a Python callable: fn(inputs, options) -> rows
    (reference `fixed_rule/mod.rs:571` — the embedding-API extension seam)."""

    def __init__(self, name: str, arity: int, fn) -> None:
        self.name = name
        self._arity = arity
        self.fn = fn

    def arity(self, options, head):
        return self._arity

    def run(self, payload, out_put, poison):
        inputs = [payload.get_input(i).rows() for i in range(payload.n_inputs())]
        rows = self.fn(inputs, payload.options)
        for row in rows:
            if len(row) != self._arity:
                raise QueryError(
                    f"custom rule '{self.name}' returned a row of wrong arity: {row!r}"
                )
            out_put(list(row))


def _build_registry() -> Dict[str, FixedRule]:
    from . import algos, utilities

    reg: Dict[str, FixedRule] = {}
    for rule in [
        algos.PageRank(),
        algos.ShortestPathDijkstra(),
        algos.ShortestPathBFS(),
        algos.ShortestPathAStar(),
        algos.KShortestPathYen(),
        algos.Bfs(),
        algos.Dfs(),
        algos.ConnectedComponents(),
        algos.StronglyConnectedComponents(),
        algos.DegreeCentrality(),
        algos.ClosenessCentrality(),
        algos.BetweennessCentrality(),
        algos.CommunityDetectionLouvain(),
        algos.LabelPropagation(),
        algos.MinimumSpanningTreePrim(),
        algos.MinimumSpanningForestKruskal(),
        algos.TopSort(),
        algos.ClusteringCoefficients(),
        algos.RandomWalk(),
        utilities.ReorderSort(),
        utilities.Constant(),
        utilities.CsvReader(),
        utilities.JsonReader(),
    ]:
        reg[rule.name] = rule
    # alias names registered by the reference (fixed_rule/mod.rs:706-836)
    reg["BreadthFirstSearch"] = reg["BFS"]
    reg["DepthFirstSearch"] = reg["DFS"]
    reg["SCC"] = reg["StronglyConnectedComponents"]
    return reg


DEFAULT_FIXED_RULES: Dict[str, FixedRule] = _build_registry()
