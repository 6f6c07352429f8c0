"""cozo_tpu_torch — the PyTorch/CUDA port of `cozo_tpu`'s device core.

This package imports PyTorch and numpy, never JAX and nothing of
`cozo_tpu`.  It mirrors the JAX package's layout and names.  So far it
carries the vector-serving path: `HnswIndex` (host graph code, device
bulk build) and `sweep_search` (the chunked sweep with its f32, bf16 and
fused lanes; the fused lane is the hand-written CUDA kernel
`csrc/fused_sweep.cu`).  Device entry points run on the card unless the
caller passes device="cpu".

The `Db` chain (parser, planner, evaluation, storage) is a later slice.
"""

from .models.hnsw_index import HnswIndex
from .ops.exact_knn import sweep_search
from .utils.device import default_device

__all__ = ["HnswIndex", "sweep_search", "default_device"]
