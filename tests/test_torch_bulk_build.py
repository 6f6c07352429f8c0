"""Parity of the port's device bulk build (`cozo_tpu_torch/ops/
bulk_build.py`) with the JAX package's (`cozo_tpu/ops/bulk_build.py`):
the batched selection heuristic gives the identical mask on the same
pool, and a build of the same data reaches the same graph recall."""

import numpy as np
import pytest
import torch

from cozo_tpu.models.hnsw_index import HnswIndex as JaxIndex
from cozo_tpu.ops.bulk_build import _select_fn
from cozo_tpu_torch import HnswIndex, sweep_search
from cozo_tpu_torch.ops.bulk_build import _select
from tests._torch_state import recall


def _table_and_pools(metric, n=1024, d=48, W=64, P=24, seed=31):
    """A sweep-form table and, per wave row, its P nearest rows in
    ascending distance (exact f32 distances: no ties by construction)."""
    rng = np.random.default_rng(seed)
    v = rng.standard_normal((n, d)).astype(np.float32)
    tbl = np.zeros((1, n, 128), np.float32)
    if metric == "L2":
        tbl[0, :, :d] = 2.0 * v
        bias = -(v.astype(np.float64) ** 2).sum(1).astype(np.float32)[None]
    else:
        v = v / np.linalg.norm(v, axis=1, keepdims=True)
        tbl[0, :, :d] = v
        bias = np.zeros((1, n), np.float32)
    q = v[:W] + 0.05 * rng.standard_normal((W, d)).astype(np.float32)
    if metric == "L2":
        dist = ((q[:, None, :] - v[None]) ** 2).sum(2)
    else:
        dist = 1.0 - q @ v.T
    order = np.argsort(dist, axis=1)[:, :P]
    pool_d = np.take_along_axis(dist, order, axis=1).astype(np.float32)
    pool_ids = order.astype(np.int32)
    pool_ids[::7, -3:] = -1  # some invalid tails
    pool_d[::7, -3:] = np.inf
    return tbl, bias, pool_ids, pool_d


@pytest.mark.parametrize("metric", ["L2", "Cosine"])
def test_select_matches_jax(metric):
    import jax.numpy as jnp

    tbl, bias, pool_ids, pool_d = _table_and_pools(metric)
    W, P = pool_ids.shape
    mmax = 8
    sel_j = np.asarray(_select_fn(1, tbl.shape[1], 128, P, mmax, metric)(
        jnp.asarray(tbl), jnp.asarray(bias), jnp.asarray(pool_ids),
        jnp.asarray(pool_d)))
    sel_t = _select(torch.from_numpy(tbl), torch.from_numpy(bias),
                    torch.from_numpy(pool_ids), torch.from_numpy(pool_d),
                    mmax, metric).numpy()
    assert sel_t.any() and (sel_t.sum(1) <= mmax).all()
    assert np.array_equal(sel_t, sel_j)


N, D, K = 20_000, 64, 10


@pytest.fixture(scope="module", params=["Cosine", "L2"])
def built(request):
    """The same data built by both packages' device builds."""
    metric = request.param
    rng = np.random.default_rng(41)
    data = rng.standard_normal((N, D)).astype(np.float32)
    jidx = JaxIndex(dim=D, m=8, ef_construction=50, distance=metric)
    jidx.bulk_build(data, wave=4096)
    tidx = HnswIndex(dim=D, m=8, ef_construction=50, distance=metric,
                     device="cpu")
    tidx.bulk_build(data, wave=4096)
    qs = data[:200] + 0.01 * rng.standard_normal((200, D)).astype(np.float32)
    return metric, data, qs, jidx, tidx


def test_device_build_graph_recall_matches_jax(built):
    metric, data, qs, jidx, tidx = built
    # the level sampling draws from the same seeded rng in both packages
    assert np.array_equal(tidx.levels[:N], jidx.levels[:N])
    assert tidx.n == jidx.n == N
    gt, _ = tidx._bf_candidates_np(qs, K)
    ids_t, _ = tidx.search(qs, k=K, ef=64, use_tpu=False)
    ids_j, _ = jidx.search(qs, k=K, ef=64, use_tpu=False)
    r_t, r_j = recall(ids_t, gt), recall(ids_j, gt)
    assert abs(r_t - r_j) <= 0.02, (r_t, r_j)


def test_fused_lane_on_built_index(built):
    """compute_dtype="fused" through sweep_search on the built index:
    the self row is the top hit, and the lane agrees with the f32 lane."""
    metric, data, _, _, tidx = built
    rng = np.random.default_rng(1)
    qs = data[:256] + 0.01 * rng.standard_normal((256, D)).astype(np.float32)
    ids_f, d_f = sweep_search(tidx, qs, K, compute_dtype="fused")
    ids_b, _ = sweep_search(tidx, qs, K, compute_dtype="f32", rt=1.0)
    assert float(np.mean(ids_f[:, 0] == np.arange(256))) > 0.99
    overlap = np.mean([
        len(set(ids_f[i].tolist()) & set(ids_b[i].tolist())) / K
        for i in range(256)
    ])
    assert overlap > 0.98, overlap
    assert np.all(np.isfinite(d_f[ids_f >= 0]))
