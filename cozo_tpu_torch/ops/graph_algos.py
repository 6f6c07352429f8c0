"""Graph fixed-rule iterations over numpy CSR (counterpart of
`cozo_tpu/ops/graph_algos.py`, host half).

The host stages graphs as numpy CSR (`fixed_payload.as_directed_graph`).
What is here runs on the host, as in the JAX package below the device
threshold (`fixed_rule/algos.TPU_EDGE_THRESHOLD`): `pagerank_numpy` and
the content key of a graph.  The device iterations (the dst-sorted
PageRank spMV, the sliced-ELL Bellman-Ford SSSP, the label pick of label
propagation) are not ported yet: their entry points raise
`NotImplementedError` naming ROADMAP §1 item 2, and nothing falls back
to the host in their place.
"""

from __future__ import annotations

import hashlib

import numpy as np


def pagerank_numpy(indptr, dst, theta=0.85, epsilon=1e-4, iterations=10):
    n = len(indptr) - 1
    out_deg = np.diff(indptr).astype(np.float64)
    src = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    ranks = np.full(n, 1.0 / n)
    safe_deg = np.where(out_deg > 0, out_deg, 1.0)
    for _ in range(iterations):
        contrib = ranks / safe_deg
        incoming = np.zeros(n)
        np.add.at(incoming, dst, contrib[src])
        dangling = ranks[out_deg == 0].sum()
        new_ranks = (1 - theta) / n + theta * (incoming + dangling / n)
        if np.abs(new_ranks - ranks).sum() < epsilon:
            ranks = new_ranks
            break
        ranks = new_ranks
    return ranks


def graph_content_key(indptr, dst) -> str:
    h = hashlib.blake2b(digest_size=16)
    h.update(np.ascontiguousarray(indptr))
    h.update(np.ascontiguousarray(dst))
    return h.hexdigest()


def pagerank(indptr, dst, theta=0.85, epsilon=1e-4, iterations=10,
             use_tpu=False):
    if use_tpu:
        raise NotImplementedError(
            "PageRank on the device is not ported yet (ROADMAP §1 item 2: "
            "graph fixed rules on the device)")
    return pagerank_numpy(
        indptr, dst, theta=theta, epsilon=epsilon, iterations=iterations
    )


def sssp_device(indptr, dst, w, sources, max_iters: int = 512,
                cache_key=None):
    raise NotImplementedError(
        "batched SSSP on the device is not ported yet (ROADMAP §1 item 2: "
        "graph fixed rules on the device)")


def labelprop_jax(indptr, dst, w=None, iterations=10, cache_key=None,
                  degree_cap=None):
    raise NotImplementedError(
        "label propagation on the device is not ported yet (ROADMAP §1 "
        "item 2: graph fixed rules on the device)")
