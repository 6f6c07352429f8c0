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
