"""cozo_tpu_torch — the PyTorch/CUDA port of `cozo_tpu`'s device core.

This package imports PyTorch and numpy, never JAX and nothing of
`cozo_tpu`.  It mirrors the JAX package's layout and names.  So far it
carries the vector index: `HnswIndex` (host graph code, device bulk build
on an f32 or int8 table, and every dispatch of `search` but the
`COZO_TPU_MESH` mesh sweep: the chunked sweep, the int8 quant lane past
the f32 budget, the device beam search for small batches) and
`sweep_search` (the chunked sweep with its f32, bf16, i8 and fused
lanes).  Two hand-written CUDA kernels: `csrc/fused_sweep.cu` (the fused
lane) and `csrc/beam_search.cu` (the batched HNSW search).  Device entry
points run on the card unless the caller passes device="cpu".

The `Db` chain (parser, planner, evaluation, storage) is a later slice.
"""

from .models.hnsw_index import HnswIndex
from .ops.exact_knn import sweep_search
from .utils.device import default_device

__all__ = ["HnswIndex", "sweep_search", "default_device"]
