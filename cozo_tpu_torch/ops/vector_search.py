"""Brute-force k-NN (counterpart of the brute-force part of
`cozo_tpu/ops/vector_search.py`).

The batched device beam search of the JAX module (`_compiled_search`,
`hnsw_search_device`) is not ported yet; `HnswIndex.search` raises where
it would be reached.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..utils.device import default_device, to_device


def _pad_pow2(n: int) -> int:
    if n <= 1:
        return 1
    return 1 << (n - 1).bit_length()


def brute_force_knn(
    vectors: np.ndarray,
    norms_sq: np.ndarray,
    queries: np.ndarray,
    k: int,
    distance: str,
    device=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Exact k-NN via one matmul + top-k on `device` (the card unless
    given).  Used for small indexes, re-ranking, and recall validation."""
    dev = default_device(device)
    v = to_device(np.ascontiguousarray(vectors, dtype=np.float32), dev)
    q = to_device(np.ascontiguousarray(queries, dtype=np.float32), dev)
    nsq = to_device(np.ascontiguousarray(norms_sq, dtype=np.float32), dev)
    dots = q @ v.T  # [B, N]
    if distance == "L2":
        qn = torch.sum(q * q, dim=1, keepdim=True)
        d = qn + nsq[None, :] - 2.0 * dots
    elif distance == "IP":
        d = 1.0 - dots
    else:  # Cosine
        qn = torch.sqrt(torch.sum(q * q, dim=1, keepdim=True))
        vn = torch.sqrt(nsq)[None, :]
        denom = torch.where(qn * vn > 0, qn * vn, torch.ones_like(dots))
        d = 1.0 - dots / denom
    neg_d, idx = torch.topk(-d, k)
    return (idx.cpu().numpy().astype(np.int64),
            (-neg_d).cpu().numpy().astype(np.float64))
