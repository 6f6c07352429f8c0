"""Graph fixed rules — host implementations over numpy CSR (counterpart
of `cozo_tpu/fixed_rule/algos.py`).

Output shapes and option names match the reference
(`cozo-core/src/fixed_rule/algos/*.rs`).  At or above
`TPU_EDGE_THRESHOLD` edges PageRank, SSSP and LabelPropagation take
their device iterations in `ops/graph_algos.py`, on the Db's device
(`payload.device`: a CPU Db runs the kernels' plain versions); no branch
here catches a device failure and answers on the host instead.  Below
the threshold the host code runs as in the JAX package."""

from __future__ import annotations

import heapq
import math
import random
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..data.value import cmp_key
from ..utils.errors import QueryError
from . import FixedRule

# above this edge count the spMV-style rules run on device
TPU_EDGE_THRESHOLD = 50_000


def _check(poison):
    if poison is not None:
        poison.check()


def _row_tuples(a, b, step: int = 4096) -> list:
    """The rows zip(a, b) as tuples, made `step` at a time.  A tuple of
    atoms is one object the collector stops tracking at its first young
    pass, where a list a row stays tracked and every full pass walks it;
    in steps, each young pass runs between two and walks at most one
    step's fresh tuples (a million made at once took one of ~0.1 s)."""
    rows: list = []
    for i in range(0, len(a), step):
        rows.extend(zip(a[i:i + step], b[i:i + step]))
    return rows


class PageRank(FixedRule):
    """[node, score]; options theta/epsilon/iterations/undirected
    (reference `algos/pagerank.rs`)."""

    name = "PageRank"

    def arity(self, options, head):
        return 2

    def run(self, payload, out_put, poison):
        edges = payload.get_input(0)
        undirected = payload.bool_option("undirected", False)
        theta = payload.float_option("theta", 0.85)
        epsilon = payload.float_option("epsilon", 0.0001)
        iterations = payload.int_option("iterations", 10)
        indptr, dst, verts = edges.as_directed_graph(undirected)
        n = len(verts)
        if n == 0:
            return
        from ..ops.graph_algos import pagerank

        scores = pagerank(
            indptr,
            dst,
            theta=theta,
            epsilon=epsilon,
            iterations=iterations,
            use_tpu=len(dst) >= TPU_EDGE_THRESHOLD,
            device=payload.device,
        )
        for i, v in enumerate(verts):
            _check(poison)
            out_put([v, float(scores[i])])

    def run_bulk(self, payload, poison):
        """Bulk output lane: PageRank emits one distinct row per vertex;
        when the staging path interned vertices via np.unique (sorted Int
        ids) the rows are already in cmp_key order, so the entry store
        can skip per-row dedup AND the final million-row sort."""
        edges = payload.get_input(0)
        undirected = payload.bool_option("undirected", False)
        theta = payload.float_option("theta", 0.85)
        epsilon = payload.float_option("epsilon", 0.0001)
        iterations = payload.int_option("iterations", 10)
        indptr, dst, verts = edges.as_directed_graph(undirected)
        n = len(verts)
        if n == 0:
            return [], True, True
        from ..ops.graph_algos import pagerank

        scores = pagerank(
            indptr, dst, theta=theta, epsilon=epsilon, iterations=iterations,
            use_tpu=len(dst) >= TPU_EDGE_THRESHOLD,
            device=payload.device,
        )
        _check(poison)
        rows = _row_tuples(verts, scores.tolist())
        presorted = all(isinstance(v, int) for v in verts[:64]) and (
            n < 2 or all(verts[i] < verts[i + 1] for i in range(min(n - 1, 64)))
        )
        if presorted and n > 64:
            import numpy as _np

            va = _np.asarray(verts[: n])
            presorted = bool((va[1:] > va[:-1]).all()) if va.dtype.kind == "i" else False
        return rows, True, presorted


def _build_adj_w(payload, undirected: bool, input_idx: int = 0,
                 unit_as_none: bool = False):
    """CSR + weights for a graph input.  `unit_as_none=True`: a 2-column
    (unweighted) input returns w=None instead of a ones array — at the
    10M-node proximity graph the ones array is 5.3GB allocated, copied
    and hashed per call, and the device LP kernel has a dedicated
    unit-weight lane that never materializes weights at all."""
    edges = payload.get_input(input_idx)
    if unit_as_none:
        try:
            ar = edges.arity()
        except Exception:
            ar = None
        if ar == 2:
            indptr, dst, verts = edges.as_directed_graph(undirected)
            return indptr, dst, None, verts
    indptr, dst, w, verts = edges.as_directed_weighted_graph(undirected)
    return indptr, dst, w, verts


def _vert_index(verts) -> Dict[tuple, int]:
    return {cmp_key(v): i for i, v in enumerate(verts)}


def _dijkstra(indptr, dst, w, start: int, goals: Optional[set], limit: int = 1):
    """Single-source Dijkstra; returns dist, parents arrays."""
    n = len(indptr) - 1
    dist = np.full(n, np.inf)
    parent = np.full(n, -1, dtype=np.int64)
    dist[start] = 0.0
    pq = [(0.0, start)]
    seen_goals = 0
    while pq:
        d, u = heapq.heappop(pq)
        if d > dist[u]:
            continue
        if goals is not None and u in goals:
            seen_goals += 1
            if seen_goals >= len(goals):
                break
        for ei in range(indptr[u], indptr[u + 1]):
            v = dst[ei]
            nd = d + w[ei]
            if nd < dist[v]:
                dist[v] = nd
                parent[v] = u
                heapq.heappush(pq, (nd, v))
    return dist, parent


def _path_from_parents(parent, start, goal) -> Optional[list]:
    if start == goal:
        return [start]
    if parent[goal] < 0:
        return None
    path = [goal]
    cur = goal
    while cur != start:
        cur = int(parent[cur])
        if cur < 0:
            return None
        path.append(cur)
    path.reverse()
    return path


class ShortestPathDijkstra(FixedRule):
    """[start, goal, cost, path] (reference `algos/shortest_path_dijkstra.rs`)."""

    name = "ShortestPathDijkstra"

    def arity(self, options, head):
        return 4

    def run(self, payload, out_put, poison):
        undirected = payload.bool_option("undirected", False)
        keep_ties = payload.bool_option("keep_ties", False)
        indptr, dst, w, verts = _build_adj_w(payload, undirected)
        vidx = _vert_index(verts)
        starting = payload.get_input(1).rows()
        goals_rows = None
        if payload.n_inputs() > 2:
            goals_rows = payload.get_input(2).rows()

        sources = []
        src_rows = []
        for srow in starting:
            skey = cmp_key(srow[0])
            if skey in vidx:
                sources.append(vidx[skey])
                src_rows.append(srow)

        goal_ids = None
        if goals_rows is not None:
            goal_ids = {
                vidx[cmp_key(g[0])] for g in goals_rows if cmp_key(g[0]) in vidx
            }

        use_device = len(dst) >= TPU_EDGE_THRESHOLD and len(sources) > 0

        def emit(srow, s, dist, parent):
            targets = goal_ids if goal_ids is not None else range(len(verts))
            for g in targets:
                if not math.isfinite(dist[g]):
                    if goal_ids is not None:
                        out_put([srow[0], verts[g], float("inf"), []])
                    continue
                path = _path_from_parents(parent, s, g)
                if path is None:
                    continue
                out_put(
                    [srow[0], verts[g], float(dist[g]), [verts[p] for p in path]]
                )

        if use_device:
            from ..ops.graph_algos import graph_content_key, sssp_device

            ck = graph_content_key(indptr, dst)
            # chunk sources so [S, E] relaxation buffers fit in HBM
            chunk = max(1, (1 << 27) // max(len(dst), 1))
            for i in range(0, len(sources), chunk):
                _check(poison)
                srcs = sources[i : i + chunk]
                dists, parents = sssp_device(
                    indptr, dst, w, srcs, cache_key=ck,
                    device=payload.device,
                )
                for j, s in enumerate(srcs):
                    emit(src_rows[i + j], s, dists[j], parents[j])
            _ = keep_ties
            return
        for srow, s in zip(src_rows, sources):
            _check(poison)
            dist, parent = _dijkstra(indptr, dst, w, s, goal_ids)
            emit(srow, s, dist, parent)
        _ = keep_ties  # tie enumeration is a follow-up refinement


class ShortestPathBFS(FixedRule):
    """[start, goal, path-or-null] — unweighted (reference
    `algos/shortest_path_bfs.rs`)."""

    name = "ShortestPathBFS"

    def arity(self, options, head):
        return 3

    def run(self, payload, out_put, poison):
        edges = payload.get_input(0)
        indptr, dst, verts = edges.as_directed_graph(False)
        vidx = _vert_index(verts)
        starting = payload.get_input(1).rows()
        ending = payload.get_input(2).rows()
        from collections import deque

        for srow in starting:
            _check(poison)
            skey = cmp_key(srow[0])
            if skey not in vidx:
                for erow in ending:
                    out_put([srow[0], erow[0], None])
                continue
            s = vidx[skey]
            parent = {s: -1}
            q = deque([s])
            while q:
                u = q.popleft()
                for ei in range(indptr[u], indptr[u + 1]):
                    v = int(dst[ei])
                    if v not in parent:
                        parent[v] = u
                        q.append(v)
            for erow in ending:
                ekey = cmp_key(erow[0])
                g = vidx.get(ekey)
                if g is None or g not in parent:
                    out_put([srow[0], erow[0], None])
                    continue
                path = [g]
                cur = g
                while cur != s:
                    cur = parent[cur]
                    path.append(cur)
                path.reverse()
                out_put([srow[0], erow[0], [verts[p] for p in path]])


class ShortestPathAStar(FixedRule):
    """[start, goal, cost, path]; heuristic expr evaluated per node row
    (reference `algos/astar.rs`)."""

    name = "ShortestPathAStar"

    def arity(self, options, head):
        return 4

    def run(self, payload, out_put, poison):
        from ..data.expr import Expr

        edges = payload.get_input(0)
        nodes = payload.get_input(1)
        starting = payload.get_input(2).rows()
        goals_in = payload.get_input(3)
        goals = goals_in.rows()
        goals_bmap = goals_in.binding_map()
        heuristic = payload.expr_option("heuristic", None)
        if heuristic is None:
            raise QueryError("'heuristic' option required for ShortestPathAStar")
        indptr, dst, w, verts = edges.as_directed_weighted_graph(False)
        vidx = _vert_index(verts)
        node_rows = {cmp_key(r[0]): r for r in nodes.rows()}
        bmap = nodes.binding_map()

        for grow in goals:
            goal_row = node_rows.get(cmp_key(grow[0]))
            if goal_row is None:
                raise QueryError(f"A* goal {grow[0]!r} not found among nodes")

            def h(node_key):
                row = node_rows.get(node_key)
                if row is None:
                    return 0.0
                # env = node-row bindings (input 1, e.g. `nodes[n, lat1,
                # lon1]`) + goal-row bindings (input 3, e.g. `goal[g,
                # lat2, lon2]`) — reference algos/astar.rs evaluates the
                # heuristic with both tuples in scope
                env = {name: row[i] for name, i in bmap.items()}
                for name, i in goals_bmap.items():
                    if i < len(grow):
                        env[name] = grow[i]
                v = heuristic.eval_env(env)
                if isinstance(v, bool) or not isinstance(v, (int, float)):
                    raise QueryError("heuristic must evaluate to a number")
                return float(v)

            g = vidx.get(cmp_key(grow[0]))
            for srow in starting:
                _check(poison)
                s = vidx.get(cmp_key(srow[0]))
                if s is None or g is None:
                    continue
                dist = {s: 0.0}
                parent = {s: -1}
                pq = [(h(cmp_key(verts[s])), s)]
                found = False
                while pq:
                    f, u = heapq.heappop(pq)
                    if u == g:
                        found = True
                        break
                    du = dist[u]
                    for ei in range(indptr[u], indptr[u + 1]):
                        v = int(dst[ei])
                        nd = du + w[ei]
                        if nd < dist.get(v, math.inf):
                            dist[v] = nd
                            parent[v] = u
                            heapq.heappush(pq, (nd + h(cmp_key(verts[v])), v))
                if found:
                    path = [g]
                    cur = g
                    while cur != s:
                        cur = parent[cur]
                        path.append(cur)
                    path.reverse()
                    out_put(
                        [srow[0], grow[0], float(dist[g]), [verts[p] for p in path]]
                    )


class KShortestPathYen(FixedRule):
    """[start, goal, cost, path] — k loopless shortest paths
    (reference `algos/yen.rs`)."""

    name = "KShortestPathYen"

    def arity(self, options, head):
        return 4

    def run(self, payload, out_put, poison):
        k = payload.int_option("k", None)
        if k is None:
            raise QueryError("option 'k' required for KShortestPathYen")
        undirected = payload.bool_option("undirected", False)
        indptr, dst, w, verts = _build_adj_w(payload, undirected)
        vidx = _vert_index(verts)
        starting = payload.get_input(1).rows()
        ending = payload.get_input(2).rows()

        adj = [
            [(int(dst[ei]), float(w[ei])) for ei in range(indptr[u], indptr[u + 1])]
            for u in range(len(verts))
        ]

        def dijkstra_masked(s, g, banned_nodes, banned_edges):
            dist = {s: 0.0}
            parent = {s: -1}
            pq = [(0.0, s)]
            while pq:
                d, u = heapq.heappop(pq)
                if u == g:
                    break
                if d > dist.get(u, math.inf):
                    continue
                for (v, wt) in adj[u]:
                    if v in banned_nodes or (u, v) in banned_edges:
                        continue
                    nd = d + wt
                    if nd < dist.get(v, math.inf):
                        dist[v] = nd
                        parent[v] = u
                        heapq.heappush(pq, (nd, v))
            if g not in dist:
                return None
            path = [g]
            cur = g
            while cur != s:
                cur = parent[cur]
                path.append(cur)
            path.reverse()
            return dist[g], path

        for srow in starting:
            for erow in ending:
                _check(poison)
                s, g = vidx.get(cmp_key(srow[0])), vidx.get(cmp_key(erow[0]))
                if s is None or g is None:
                    continue
                first = dijkstra_masked(s, g, set(), set())
                if first is None:
                    continue
                paths = [first]
                candidates: List[Tuple[float, list]] = []
                while len(paths) < k:
                    prev_cost, prev_path = paths[-1]
                    for i in range(len(prev_path) - 1):
                        spur = prev_path[i]
                        root = prev_path[: i + 1]
                        banned_edges = set()
                        for (c, p) in paths:
                            if p[: i + 1] == root and len(p) > i + 1:
                                banned_edges.add((p[i], p[i + 1]))
                        banned_nodes = set(root[:-1])
                        res = dijkstra_masked(spur, g, banned_nodes, banned_edges)
                        if res is None:
                            continue
                        spur_cost, spur_path = res
                        root_cost = 0.0
                        for j in range(i):
                            u, v = prev_path[j], prev_path[j + 1]
                            root_cost += min(
                                wt for (vv, wt) in adj[u] if vv == v
                            )
                        total = root_cost + spur_cost
                        cand = root[:-1] + spur_path
                        entry = (total, cand)
                        if entry not in candidates and all(
                            cand != p for _, p in paths
                        ):
                            candidates.append(entry)
                    if not candidates:
                        break
                    candidates.sort(key=lambda x: x[0])
                    paths.append(candidates.pop(0))
                for cost, path in paths:
                    out_put(
                        [srow[0], erow[0], float(cost), [verts[p] for p in path]]
                    )


class _GoalSearch(FixedRule):
    """Shared BFS/DFS goal-predicate search: [start, found, path]
    (reference `algos/{bfs,dfs}.rs`)."""

    depth_first = False

    def arity(self, options, head):
        return 3

    def run(self, payload, out_put, poison):
        edges = payload.get_input(0)
        nodes = payload.get_input(1)
        starting = (
            payload.get_input(2) if payload.n_inputs() > 2 else nodes
        ).rows()
        limit = payload.int_option("limit", 1)
        condition = payload.expr_option("condition", None)
        if condition is None:
            raise QueryError(f"option 'condition' required for '{self.name}'")
        indptr, dst, verts = edges.as_directed_graph(False)
        vidx = _vert_index(verts)
        node_rows = {cmp_key(r[0]): r for r in nodes.rows()}
        bmap = nodes.binding_map()

        def goal(nid) -> bool:
            row = node_rows.get(cmp_key(verts[nid]))
            if row is None:
                return False
            env = {name: row[i] for name, i in bmap.items() if i < len(row)}
            v = condition.eval_env(env)
            if not isinstance(v, bool):
                raise QueryError("condition must evaluate to a boolean")
            return v

        for srow in starting:
            _check(poison)
            s = vidx.get(cmp_key(srow[0]))
            if s is None:
                continue
            found = 0
            parent = {s: -1}
            frontier = [s]
            if goal(s):
                out_put([srow[0], verts[s], [verts[s]]])
                found += 1
                if found >= limit:
                    continue
            while frontier and found < limit:
                if self.depth_first:
                    u = frontier.pop()
                else:
                    u = frontier.pop(0)
                for ei in range(indptr[u], indptr[u + 1]):
                    v = int(dst[ei])
                    if v in parent:
                        continue
                    parent[v] = u
                    if goal(v):
                        path = [v]
                        cur = v
                        while cur != s:
                            cur = parent[cur]
                            path.append(cur)
                        path.reverse()
                        out_put([srow[0], verts[v], [verts[p] for p in path]])
                        found += 1
                        if found >= limit:
                            break
                    frontier.append(v)


class Bfs(_GoalSearch):
    name = "BFS"
    depth_first = False


class Dfs(_GoalSearch):
    name = "DFS"
    depth_first = True


class ConnectedComponents(FixedRule):
    """[node, component_id] (reference
    `algos/strongly_connected_components.rs` weak variant)."""

    name = "ConnectedComponents"

    def arity(self, options, head):
        return 2

    def run(self, payload, out_put, poison):
        edges = payload.get_input(0)
        indptr, dst, verts = edges.as_directed_graph(True)
        n = len(verts)
        comp = np.full(n, -1, dtype=np.int64)
        cur = 0
        for i in range(n):
            if comp[i] >= 0:
                continue
            stack = [i]
            comp[i] = cur
            while stack:
                u = stack.pop()
                for ei in range(indptr[u], indptr[u + 1]):
                    v = int(dst[ei])
                    if comp[v] < 0:
                        comp[v] = cur
                        stack.append(v)
            cur += 1
        for i, v in enumerate(verts):
            out_put([v, int(comp[i])])
        counter = cur
        if payload.n_inputs() > 1:
            seen = {cmp_key(v) for v in verts}
            for row in payload.get_input(1).rows():
                if cmp_key(row[0]) not in seen:
                    seen.add(cmp_key(row[0]))
                    out_put([row[0], counter])
                    counter += 1


class StronglyConnectedComponents(FixedRule):
    """[node, group_id] — iterative Tarjan (reference
    `algos/strongly_connected_components.rs`)."""

    name = "StronglyConnectedComponents"

    def arity(self, options, head):
        return 2

    def run(self, payload, out_put, poison):
        edges = payload.get_input(0)
        indptr, dst, verts = edges.as_directed_graph(False)
        n = len(verts)
        index = np.full(n, -1, dtype=np.int64)
        low = np.zeros(n, dtype=np.int64)
        on_stack = np.zeros(n, dtype=bool)
        comp = np.full(n, -1, dtype=np.int64)
        stack: List[int] = []
        counter = [0]
        ncomp = [0]
        for root in range(n):
            if index[root] >= 0:
                continue
            work = [(root, 0)]
            while work:
                u, pi = work[-1]
                if pi == 0:
                    index[u] = low[u] = counter[0]
                    counter[0] += 1
                    stack.append(u)
                    on_stack[u] = True
                recurse = False
                deg = indptr[u + 1] - indptr[u]
                for i in range(pi, deg):
                    v = int(dst[indptr[u] + i])
                    if index[v] < 0:
                        work[-1] = (u, i + 1)
                        work.append((v, 0))
                        recurse = True
                        break
                    elif on_stack[v]:
                        low[u] = min(low[u], index[v])
                if recurse:
                    continue
                if low[u] == index[u]:
                    while True:
                        v = stack.pop()
                        on_stack[v] = False
                        comp[v] = ncomp[0]
                        if v == u:
                            break
                    ncomp[0] += 1
                work.pop()
                if work:
                    p = work[-1][0]
                    low[p] = min(low[p], low[u])
        for i, v in enumerate(verts):
            out_put([v, int(comp[i])])
        cnt = ncomp[0]
        if payload.n_inputs() > 1:
            seen = {cmp_key(v) for v in verts}
            for row in payload.get_input(1).rows():
                if cmp_key(row[0]) not in seen:
                    seen.add(cmp_key(row[0]))
                    out_put([row[0], cnt])
                    cnt += 1


class DegreeCentrality(FixedRule):
    """[node, total_degree, out_degree, in_degree]
    (reference `algos/degree_centrality.rs`)."""

    name = "DegreeCentrality"

    def arity(self, options, head):
        return 4

    def run(self, payload, out_put, poison):
        edges = payload.get_input(0)
        indptr, dst, verts = edges.as_directed_graph(False)
        n = len(verts)
        out_deg = np.diff(indptr)
        in_deg = np.zeros(n, dtype=np.int64)
        np.add.at(in_deg, dst, 1)
        for i, v in enumerate(verts):
            o, ind = int(out_deg[i]), int(in_deg[i])
            out_put([v, o + ind, o, ind])


class ClosenessCentrality(FixedRule):
    """[node, centrality] via sampled BFS/Dijkstra
    (reference `algos/all_pairs_shortest_path.rs`)."""

    name = "ClosenessCentrality"

    def arity(self, options, head):
        return 2

    def run(self, payload, out_put, poison):
        undirected = payload.bool_option("undirected", False)
        indptr, dst, w, verts = _build_adj_w(payload, undirected)
        n = len(verts)
        for i in range(n):
            _check(poison)
            dist, _ = _dijkstra(indptr, dst, w, i, None)
            finite = dist[np.isfinite(dist)]
            s = float(finite.sum())
            c = (len(finite) - 1) / s if s > 0 else 0.0
            out_put([verts[i], c])


class BetweennessCentrality(FixedRule):
    """[node, centrality] — Brandes over all sources (O(V·E), the reference
    warns likewise)."""

    name = "BetweennessCentrality"

    def arity(self, options, head):
        return 2

    def run(self, payload, out_put, poison):
        undirected = payload.bool_option("undirected", False)
        indptr, dst, w, verts = _build_adj_w(payload, undirected)
        n = len(verts)
        centrality = np.zeros(n)
        from collections import deque

        for s in range(n):
            _check(poison)
            sigma = np.zeros(n)
            sigma[s] = 1.0
            dist = np.full(n, -1.0)
            dist[s] = 0.0
            preds: List[List[int]] = [[] for _ in range(n)]
            order = []
            q = deque([s])
            while q:
                u = q.popleft()
                order.append(u)
                for ei in range(indptr[u], indptr[u + 1]):
                    v = int(dst[ei])
                    if dist[v] < 0:
                        dist[v] = dist[u] + 1
                        q.append(v)
                    if dist[v] == dist[u] + 1:
                        sigma[v] += sigma[u]
                        preds[v].append(u)
            delta = np.zeros(n)
            for v in reversed(order):
                for u in preds[v]:
                    delta[u] += sigma[u] / sigma[v] * (1 + delta[v])
                if v != s:
                    centrality[v] += delta[v]
        for i, v in enumerate(verts):
            out_put([v, float(centrality[i])])


def _louvain_vectorized(indptr, dst, w, max_iter, delta, poison):
    """Parallel-sweep Louvain over numpy edge arrays (sort + reduceat
    segment sums), the scale path for million-node proximity graphs
    where the dict-of-dicts sweep's per-edge Python cost is hours.

    Each round computes every node's best neighbor community against the
    round-start assignment and applies all improving moves at once
    (Grappolo-style synchronous moving; same modularity objective as the
    sequential sweep, different move order).  Returns the same
    levels structure as the sequential path."""
    n = len(indptr) - 1
    base_u = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    u, v = base_u, np.asarray(dst, dtype=np.int64)
    ww = np.asarray(w, dtype=np.float64)
    levels: List[np.ndarray] = []
    while True:
        _check(poison)
        nn = int(max(u.max(initial=-1), v.max(initial=-1)) + 1) if len(u) else 0
        if nn == 0 or ww.sum() == 0:
            break
        m2 = ww.sum()
        k = np.bincount(u, weights=ww, minlength=nn)
        comm = np.arange(nn, dtype=np.int64)
        tot = k.copy()
        improved_any = False
        quiet = 0
        for rnd in range(2 * max_iter):
            _check(poison)
            # segment sums of edge weight by (u, comm[v]), self-edges out
            mask = u != v
            key = u[mask] * nn + comm[v[mask]]
            order = np.argsort(key, kind="stable")
            ks, ws = key[order], ww[mask][order]
            if len(ks) == 0:
                break
            starts = np.nonzero(
                np.concatenate([[True], ks[1:] != ks[:-1]])
            )[0]
            sums = np.add.reduceat(ws, starts)
            gu = ks[starts] // nn
            gc = ks[starts] % nn
            # gain of moving gu into gc, with k[gu] taken out of its own
            # community's total (mirrors the sequential sweep's
            # tot[cu] -= k[u] bookkeeping)
            tot_adj = tot[gc] - np.where(gc == comm[gu], k[gu], 0.0)
            gain = sums - tot_adj * k[gu] / m2
            # per-node argmax: sort by (node, -gain) is avoidable — use
            # reduceat over the node-grouped candidate list
            nstarts = np.nonzero(
                np.concatenate([[True], gu[1:] != gu[:-1]])
            )[0]
            best_gain = np.maximum.reduceat(gain, nstarts)
            # pick the (first) community achieving the max per node
            grp_of = np.repeat(
                np.arange(len(nstarts)), np.diff(np.append(nstarts, len(gu)))
            )
            is_best = gain == best_gain[grp_of]
            # earliest best index per group -> smallest community id wins
            idx = np.where(is_best, np.arange(len(gu)), np.iinfo(np.int64).max)
            best_pos = np.minimum.reduceat(idx, nstarts)
            node_of = gu[nstarts]
            new_comm = comm.copy()
            movers = best_gain > delta
            # alternate move parity across rounds: synchronous moving
            # lets symmetric pairs swap communities forever; letting only
            # even/odd nodes move per round breaks the cycles (standard
            # parallel-Louvain device trick)
            movers &= (node_of % 2) == (rnd % 2)
            new_comm[node_of[movers]] = gc[best_pos[movers]]
            if (new_comm == comm).all():
                quiet += 1
                if quiet >= 2:  # both parities settled
                    break
                continue
            quiet = 0
            improved_any = True
            comm = new_comm
            tot = np.bincount(comm, weights=k, minlength=nn)
        if not improved_any:
            break
        # renumber communities densely (first-seen order like the
        # sequential path's remap)
        _, idx_first, inv = np.unique(comm, return_index=True, return_inverse=True)
        comm = np.argsort(np.argsort(idx_first))[inv]
        levels.append(comm)
        nc = int(comm.max() + 1)
        if nc == nn:
            break
        # aggregate: edges between communities, weights summed
        cu, cv = comm[u], comm[v]
        key = cu * nc + cv
        order = np.argsort(key, kind="stable")
        ks, ws = key[order], ww[order]
        starts = np.nonzero(np.concatenate([[True], ks[1:] != ks[:-1]]))[0]
        ww = np.add.reduceat(ws, starts)
        u = ks[starts] // nc
        v = ks[starts] % nc
    return levels


class CommunityDetectionLouvain(FixedRule):
    """[List(labels per level), node] — multi-level modularity optimization
    (reference `algos/louvain.rs`).  Inputs above 200K edges use the
    vectorized parallel-sweep variant (`_louvain_vectorized`)."""

    name = "CommunityDetectionLouvain"

    def arity(self, options, head):
        return 2

    def run(self, payload, out_put, poison):
        undirected = payload.bool_option("undirected", False)
        max_iter = payload.int_option("max_iter", 10)
        delta = payload.float_option("delta", 0.0001)
        keep_depth = payload.int_option("keep_depth", None)
        indptr, dst, w, verts = _build_adj_w(payload, True)
        n = len(verts)
        if len(dst) >= 200_000:
            levels_np = _louvain_vectorized(
                indptr, dst, w, max_iter, delta, poison
            )
            for i, vtx in enumerate(verts):
                labels = []
                cur = i
                for lvl in levels_np:
                    cur = int(lvl[cur])
                    labels.append(cur)
                if keep_depth is not None:
                    labels = labels[-keep_depth:]
                out_put([labels, vtx])
            return
        # adjacency as dict-of-dicts for merging
        adj: List[Dict[int, float]] = [dict() for _ in range(n)]
        for u in range(n):
            for ei in range(indptr[u], indptr[u + 1]):
                v = int(dst[ei])
                adj[u][v] = adj[u].get(v, 0.0) + float(w[ei])
        levels: List[List[int]] = []
        node_map = list(range(n))  # current node → original set handled via levels

        cur_adj = adj
        while True:
            _check(poison)
            m2 = sum(sum(d.values()) for d in cur_adj)
            if m2 == 0:
                break
            nn = len(cur_adj)
            comm = list(range(nn))
            k = [sum(d.values()) for d in cur_adj]
            tot = list(k)
            improved_any = False
            for _ in range(max_iter):
                improved = False
                for u in range(nn):
                    cu = comm[u]
                    # weights to neighboring communities
                    wc: Dict[int, float] = {}
                    for v, wt in cur_adj[u].items():
                        if v != u:
                            wc[comm[v]] = wc.get(comm[v], 0.0) + wt
                    tot[cu] -= k[u]
                    best, best_gain = cu, 0.0
                    for c, wt in wc.items():
                        gain = wt - tot[c] * k[u] / m2
                        if gain > best_gain + delta:
                            best_gain = gain
                            best = c
                    tot[best] += k[u]
                    if best != cu:
                        comm[u] = best
                        improved = True
                        improved_any = True
                if not improved:
                    break
            if not improved_any:
                break
            # renumber communities
            remap: Dict[int, int] = {}
            for u in range(nn):
                if comm[u] not in remap:
                    remap[comm[u]] = len(remap)
                comm[u] = remap[comm[u]]
            levels.append(comm)
            # aggregate graph
            nc = len(remap)
            if nc == nn:
                break
            new_adj: List[Dict[int, float]] = [dict() for _ in range(nc)]
            for u in range(nn):
                cu = comm[u]
                for v, wt in cur_adj[u].items():
                    cv = comm[v]
                    new_adj[cu][cv] = new_adj[cu].get(cv, 0.0) + wt
            cur_adj = new_adj

        for i, v in enumerate(verts):
            labels = []
            cur = i
            for lvl in levels:
                cur = lvl[cur]
                labels.append(cur)
            if keep_depth is not None:
                labels = labels[-keep_depth:]
            out_put([labels, v])


class LabelPropagation(FixedRule):
    """[label, node] — synchronous label propagation with random tie-break
    (reference `algos/label_propagation.rs`)."""

    name = "LabelPropagation"

    def arity(self, options, head):
        return 2

    def run(self, payload, out_put, poison):
        undirected = payload.bool_option("undirected", False)
        max_iter = payload.int_option("max_iter", 10)
        # extension over the reference's options (label_propagation.rs):
        # cap hub in-neighborhoods at `degree_cap` (highest-weight edges)
        # so huge power-law graphs stay on the dense device kernel
        degree_cap = payload.int_option("degree_cap", 0)
        indptr, dst, w, verts = _build_adj_w(payload, True, unit_as_none=True)
        n = len(verts)
        if len(dst) >= TPU_EDGE_THRESHOLD:
            # scale path: sort/scan-based synchronous LPA on device
            # (ops/graph_algos.labelprop_jax); the host sweep below is the
            # reference-semantics path (async, seeded-RNG tie-break)
            from ..ops.graph_algos import graph_content_key, labelprop_jax

            labels = labelprop_jax(
                indptr,
                dst,
                w=w,
                iterations=max_iter,
                cache_key=graph_content_key(indptr, dst),
                degree_cap=degree_cap,
                device=payload.device,
            )
            _check(poison)
            remap: Dict[int, int] = {}
            for i, v in enumerate(verts):
                l = int(labels[i])
                if l not in remap:
                    remap[l] = len(remap)
                out_put([remap[l], v])
            return
        labels = np.arange(n, dtype=np.int64)
        rng = random.Random(0xC0203)
        for _ in range(max_iter):
            _check(poison)
            changed = False
            order = list(range(n))
            rng.shuffle(order)
            for u in order:
                if indptr[u + 1] == indptr[u]:
                    continue
                wc: Dict[int, float] = {}
                for ei in range(indptr[u], indptr[u + 1]):
                    l = int(labels[dst[ei]])
                    wc[l] = wc.get(l, 0.0) + (
                        1.0 if w is None else float(w[ei])
                    )
                best_w = max(wc.values())
                best = [l for l, wt in wc.items() if wt == best_w]
                new = rng.choice(best)
                if new != labels[u]:
                    labels[u] = new
                    changed = True
            if not changed:
                break
        remap: Dict[int, int] = {}
        for i, v in enumerate(verts):
            l = int(labels[i])
            if l not in remap:
                remap[l] = len(remap)
            out_put([remap[l], v])

    def run_bulk(self, payload, poison):
        """Bulk output lane for the device path: one distinct row per
        vertex (see PageRank.run_bulk for the presorted contract)."""
        undirected = payload.bool_option("undirected", False)
        max_iter = payload.int_option("max_iter", 10)
        degree_cap = payload.int_option("degree_cap", 0)
        indptr, dst, w, verts = _build_adj_w(payload, True, unit_as_none=True)
        n = len(verts)
        if n == 0:
            return [], True, True
        if len(dst) < TPU_EDGE_THRESHOLD:
            return None  # host sweep via run()
        from ..ops.graph_algos import graph_content_key, labelprop_jax

        labels = labelprop_jax(
            indptr, dst, w=w, iterations=max_iter,
            cache_key=graph_content_key(indptr, dst),
            degree_cap=degree_cap, device=payload.device,
        )
        _check(poison)
        # canonicalize label ids in first-seen order (vectorized: rank of
        # each unique label's first occurrence)
        _, idx_first, inv = np.unique(
            labels, return_index=True, return_inverse=True
        )
        canon = np.argsort(np.argsort(idx_first))[inv]
        rows = _row_tuples(canon.tolist(), verts)
        return rows, True, False


class MinimumSpanningTreePrim(FixedRule):
    """[src, dst, cost] (reference `algos/prim.rs`)."""

    name = "MinimumSpanningTreePrim"

    def arity(self, options, head):
        return 3

    def run(self, payload, out_put, poison):
        indptr, dst, w, verts = _build_adj_w(payload, True)
        n = len(verts)
        if n == 0:
            return
        start = 0
        if payload.n_inputs() > 1:
            srows = payload.get_input(1).rows()
            if srows:
                vidx = _vert_index(verts)
                s = vidx.get(cmp_key(srows[0][0]))
                if s is not None:
                    start = s
        in_tree = np.zeros(n, dtype=bool)
        in_tree[start] = True
        pq = [
            (float(w[ei]), start, int(dst[ei]))
            for ei in range(indptr[start], indptr[start + 1])
        ]
        heapq.heapify(pq)
        while pq:
            _check(poison)
            wt, u, v = heapq.heappop(pq)
            if in_tree[v]:
                continue
            in_tree[v] = True
            out_put([verts[u], verts[v], wt])
            for ei in range(indptr[v], indptr[v + 1]):
                t = int(dst[ei])
                if not in_tree[t]:
                    heapq.heappush(pq, (float(w[ei]), v, t))


class MinimumSpanningForestKruskal(FixedRule):
    """[src, dst, cost] (reference `algos/kruskal.rs`)."""

    name = "MinimumSpanningForestKruskal"

    def arity(self, options, head):
        return 3

    def run(self, payload, out_put, poison):
        indptr, dst, w, verts = _build_adj_w(payload, True)
        n = len(verts)
        edges = []
        for u in range(n):
            for ei in range(indptr[u], indptr[u + 1]):
                v = int(dst[ei])
                if u < v:
                    edges.append((float(w[ei]), u, v))
        edges.sort()
        parent = list(range(n))

        def find(x):
            while parent[x] != x:
                parent[x] = parent[parent[x]]
                x = parent[x]
            return x

        for wt, u, v in edges:
            ru, rv = find(u), find(v)
            if ru != rv:
                parent[ru] = rv
                out_put([verts[u], verts[v], wt])


class TopSort(FixedRule):
    """[sort_position, node] — Kahn (reference `algos/top_sort.rs`)."""

    name = "TopSort"

    def arity(self, options, head):
        return 2

    def run(self, payload, out_put, poison):
        edges = payload.get_input(0)
        indptr, dst, verts = edges.as_directed_graph(False)
        n = len(verts)
        in_deg = np.zeros(n, dtype=np.int64)
        np.add.at(in_deg, dst, 1)
        from collections import deque

        q = deque(i for i in range(n) if in_deg[i] == 0)
        pos = 0
        while q:
            u = q.popleft()
            out_put([pos, verts[u]])
            pos += 1
            for ei in range(indptr[u], indptr[u + 1]):
                v = int(dst[ei])
                in_deg[v] -= 1
                if in_deg[v] == 0:
                    q.append(v)
        if pos != n:
            raise QueryError("topological sort requires an acyclic graph")


class ClusteringCoefficients(FixedRule):
    """[node, coefficient, n_triangles, degree]
    (reference `algos/triangles.rs`)."""

    name = "ClusteringCoefficients"

    def arity(self, options, head):
        return 4

    def run(self, payload, out_put, poison):
        indptr, dst, verts = payload.get_input(0).as_directed_graph(True)
        n = len(verts)
        neigh = [set() for _ in range(n)]
        for u in range(n):
            for ei in range(indptr[u], indptr[u + 1]):
                v = int(dst[ei])
                if v != u:
                    neigh[u].add(v)
        for u in range(n):
            _check(poison)
            d = len(neigh[u])
            tri = 0
            for v in neigh[u]:
                tri += len(neigh[u] & neigh[v])
            tri //= 2
            cc = 2.0 * tri / (d * (d - 1)) if d > 1 else 0.0
            out_put([verts[u], cc, tri, d])


class RandomWalk(FixedRule):
    """[counter, start, path] — weighted random walks
    (reference `algos/random_walk.rs`)."""

    name = "RandomWalk"

    def arity(self, options, head):
        return 3

    def run(self, payload, out_put, poison):
        edges = payload.get_input(0)
        nodes = payload.get_input(1)
        starting = payload.get_input(2).rows()
        iterations = payload.int_option("iterations", 1)
        steps = payload.int_option("steps", None)
        if steps is None:
            raise QueryError("option 'steps' required for RandomWalk")
        weight = payload.expr_option("weight", None)
        indptr, dst, verts = edges.as_directed_graph(False)
        vidx = _vert_index(verts)
        node_rows = {cmp_key(r[0]): r for r in nodes.rows()}
        bmap = nodes.binding_map()
        counter = 0
        for srow in starting:
            s = vidx.get(cmp_key(srow[0]))
            if s is None:
                continue
            for _ in range(iterations):
                _check(poison)
                path = [verts[s]]
                cur = s
                for _ in range(steps):
                    lo, hi = int(indptr[cur]), int(indptr[cur + 1])
                    if lo == hi:
                        break
                    cands = [int(dst[ei]) for ei in range(lo, hi)]
                    if weight is not None:
                        wts = []
                        for c in cands:
                            row = node_rows.get(cmp_key(verts[c]))
                            env = (
                                {name: row[i] for name, i in bmap.items()}
                                if row
                                else {}
                            )
                            wv = weight.eval_env(env)
                            if isinstance(wv, bool) or not isinstance(
                                wv, (int, float)
                            ):
                                raise QueryError("weight must evaluate to a number")
                            wts.append(max(float(wv), 0.0))
                        total = sum(wts)
                        if total <= 0:
                            cur = random.choice(cands)
                        else:
                            r = random.random() * total
                            acc = 0.0
                            cur = cands[-1]
                            for c, wt in zip(cands, wts):
                                acc += wt
                                if r <= acc:
                                    cur = c
                                    break
                    else:
                        cur = random.choice(cands)
                    path.append(verts[cur])
                counter += 1
                out_put([counter, srow[0], path])
