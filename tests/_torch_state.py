"""Carry a `cozo_tpu` HnswIndex into `cozo_tpu_torch` for parity tests:
the JAX index is read attribute by attribute into the plain state dict
that `cozo_tpu_torch.HnswIndex.from_state` takes."""

_FIELDS = (
    "vectors", "norms", "levels", "alive", "dim", "n", "entry", "version",
    "m", "m_max", "m_max0", "ef_construction", "distance", "level_mult",
    "extend_candidates", "keep_pruned_connections",
)


def jax_state(idx) -> dict:
    state = {k: getattr(idx, k) for k in _FIELDS}
    state["neighbors"] = list(idx.neighbors)
    state["_free"] = list(idx._free)
    state["dtype"] = idx.dtype.str
    state["rng"] = idx.rng.getstate()
    return state


def carry(jax_index, device="cpu"):
    from cozo_tpu_torch import HnswIndex

    return HnswIndex.from_state(jax_state(jax_index), device=device)


def recall(ids, gt):
    k = gt.shape[1]
    return sum(
        len(set(ids[b].tolist()) & set(gt[b].tolist())) for b in range(len(gt))
    ) / (len(gt) * k)


def device_mirrors(jax_index, torch_index=None):
    """Both packages' device mirrors (`_device_arrays`) of the same host
    index: (JAX cache dict, port cache dict, the port's index)."""
    from cozo_tpu.ops.vector_search import _device_arrays as jax_arrays
    from cozo_tpu_torch.ops.vector_search import _device_arrays as torch_arrays

    tidx = torch_index if torch_index is not None else carry(jax_index)
    return jax_arrays(jax_index), torch_arrays(tidx), tidx


def quant_tables(rows, distance, alive=None):
    """Both packages' `QuantSweepTable`s loaded from the same numpy rows."""
    from cozo_tpu.ops.quant_knn import QuantSweepTable as JaxTable
    from cozo_tpu_torch.ops.quant_knn import QuantSweepTable as TorchTable

    return (JaxTable().load(rows, distance, alive=alive),
            TorchTable("cpu").load(rows, distance, alive=alive))


def line_state(n, m=8, seed=0):
    """State of a navigable index of n points on a line, made without a
    build: level-0 links to the neighbours at rank distance 1, 2, 4, ...
    on both sides (in sorted order), one upper level over every 64th
    point.  Cheap enough for tables past one sweep chunk (131,072 rows),
    where only the dispatch and the search are under test."""
    import numpy as np

    from cozo_tpu_torch import HnswIndex

    rng = np.random.default_rng(seed)
    x = np.sort(rng.random(n).astype(np.float32))
    vectors = np.stack([x, np.zeros(n, np.float32)], axis=1)
    m0 = 2 * m
    ranks = np.arange(n)[:, None]
    steps = 1 << np.arange(m)
    nb0 = np.concatenate([ranks - steps[None, :], ranks + steps[None, :]], 1)
    nb0 = np.where((nb0 >= 0) & (nb0 < n), nb0, -1).astype(np.int32)
    levels = np.zeros(n, np.int32)
    levels[::64] = 1
    up = np.full((n, m), -1, np.int32)
    hi = np.arange(0, n, 64)
    j = np.arange(len(hi))[:, None]
    steps_up = 1 << np.arange(m // 2)
    nb_up = np.concatenate([j - steps_up[None, :], j + steps_up[None, :]], 1)
    up[hi] = np.where((nb_up >= 0) & (nb_up < len(hi)), nb_up * 64, -1)
    state = HnswIndex(dim=2, m=m, ef_construction=16, device="cpu").to_state()
    state.update(vectors=vectors, norms=(x.astype(np.float64) ** 2),
                 levels=levels, alive=np.ones(n, bool), n=n, entry=0,
                 neighbors=[nb0, up], version=1)
    return state


def jax_from_state(state):
    """A `cozo_tpu` HnswIndex holding the arrays of `state`."""
    import numpy as np

    from cozo_tpu.models.hnsw_index import HnswIndex

    idx = HnswIndex(dim=int(state["dim"]), m=int(state["m"]),
                    ef_construction=int(state["ef_construction"]),
                    distance=state["distance"])
    for k in _FIELDS:
        v = state[k]
        setattr(idx, k, np.array(v) if isinstance(v, np.ndarray) else v)
    idx.neighbors = [np.array(nb) for nb in state["neighbors"]]
    idx._free = list(state["_free"])
    idx.rng.setstate(state["rng"])
    return idx
