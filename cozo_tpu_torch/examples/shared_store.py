"""Shared remote storage + proximity-graph analytics.

Several embedding processes share one KV server (the reference's `tikv`
deployment story, storage/tikv.rs): start a server, point N `Db`s at it,
build an HNSW index from one client, query and analyze from another.

    # terminal 1
    python -m cozo_tpu_torch.hosts.kvserver --engine tkv --path /tmp/shared.kv
    # terminal 2
    python cozo_tpu_torch/examples/shared_store.py
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import numpy as np

from cozo_tpu_torch import Db
from cozo_tpu_torch.storage.mem import MemStorage
from cozo_tpu_torch.storage.remote import KvServer

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--device", default=None,
                help="the Db's device: the card unless 'cpu' is given")
device = ap.parse_args().device

# in-process server so the example is self-contained
srv = KvServer(MemStorage())
srv.start_background()
addr = f"{srv.addr[0]}:{srv.addr[1]}"

writer = Db("remote", addr, device=device)
writer.run_script(":create doc {id: Int => emb: <F32; 16>}")
rng = np.random.default_rng(0)
data = rng.standard_normal((500, 16)).astype(np.float32)
writer.run_script(
    "?[id, emb] <- $rows :put doc {id => emb}",
    {"rows": [[int(i), data[i]] for i in range(len(data))]},  # ndarray params
)
writer.run_script(
    "::hnsw create doc:ix {dim: 16, m: 8, dtype: F32, fields: [emb], "
    "distance: L2, ef_construction: 50}"
)

# a second, independent client sees the index (HNSW canary versioning)
reader = Db("remote", addr, device=device)
hits = reader.run_script(
    "?[id, d] := ~doc:ix{id | query: vec($q), k: 5, ef: 32, bind_distance: d}",
    {"q": data[42]},
)
print("k-NN from second client:", hits.rows)

# proximity graph -> community detection through the fixed-rule registry
reader.run_script(":create prox {fr: Int, to: Int}")
reader.run_script(
    "?[fr, to] := *doc:ix{layer: 0, fr_id: fr, to_id: to}, fr != to "
    ":put prox {fr, to}"
)
comms = reader.run_script(
    "?[l, n] <~ LabelPropagation(*prox[fr, to], undirected: true)"
)
n_comms = len({r[0] for r in comms.rows})
print(f"label propagation: {n_comms} communities over {len(comms.rows)} nodes")
srv.shutdown()
