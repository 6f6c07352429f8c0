"""cozo_tpu_torch — the PyTorch/CUDA port of `cozo_tpu`.

This package imports PyTorch and numpy, never JAX and nothing of
`cozo_tpu`.  It mirrors the JAX package's layout and names, and carries:

- the database: `Db` (CozoScript parser, planner, evaluation, stored
  relations, normal, HNSW, full-text (FTS) and MinHash-LSH index DDL and
  maintenance, the graph fixed rules, `mem`, `sqlite`, `tkv`, `plog` and
  `remote` storage, the last served by `hosts/kvserver.py`), whose
  `~rel:idx{...}` searches run on the port's vector index on the Db's
  device, on the host's FTS index, or on the LSH serving image, and whose
  graph rules and LSH backfill run their kernels on that device;
- the vector index: `HnswIndex` (host graph code, device bulk build on an
  f32 or int8 table, and every dispatch of `search`: the `COZO_TPU_MESH`
  mesh sweep, the chunked sweep, the int8 quant lane past the f32
  budget, the device beam search for small batches) and `sweep_search`
  (the chunked sweep with its f32, bf16, i8 and fused lanes);
- the device mesh (`parallel/mesh.py`): one process driving a list of
  devices, with the row-sharded sweep and k-NN and the edge-sharded
  PageRank and SSSP steps.

Seven hand-written CUDA kernels: `csrc/fused_sweep.cu` (the fused lane),
`csrc/slab_topk.cu` (every selection of the sweep lanes, where the JAX
package calls `lax.approx_max_k`), `csrc/beam_search.cu` (the batched
HNSW search), `csrc/graph_pagerank.cu`, `graph_sssp.cu` and
`graph_labelprop.cu` (the graph rules) and `csrc/minhash.cu` (the LSH
backfill's segment-min).  Entry points run on
the card unless the caller passes device="cpu":

    from cozo_tpu_torch import Db
    db = Db("mem")                 # Db("mem", device="cpu") on the host
    db.run_script("?[a] <- [[1], [2]]")

"""

from .fixed_rule import SimpleFixedRule
from .models.hnsw_index import HnswIndex
from .ops.exact_knn import sweep_search
from .runtime.db import Db, MultiTransaction, NamedRows
from .utils.device import DeviceLike, default_device
from .utils.errors import CozoError

__all__ = [
    "Db",
    "DbInstance",
    "MultiTransaction",
    "NamedRows",
    "SimpleFixedRule",
    "CozoError",
    "open_db",
    "HnswIndex",
    "sweep_search",
    "default_device",
]

# alias matching the reference naming
DbInstance = Db


def open_db(engine: str = "mem", path: str = "",
            device: DeviceLike = None) -> Db:
    return Db(engine, path, device=device)
