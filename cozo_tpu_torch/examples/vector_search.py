"""HNSW vector search example: build an index, hybrid Datalog + kNN."""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import numpy as np

from cozo_tpu_torch import Db

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--device", default=None,
                help="the Db's device: the card unless 'cpu' is given")
device = ap.parse_args().device

rng = np.random.default_rng(0)
db = Db("mem", device=device)
db.run_script(":create doc {id: Int => topic: String, emb: <F32; 32>}")
rows = [
    [i, f"topic{i % 3}", rng.standard_normal(32).tolist()] for i in range(500)
]
db.run_script("?[id, topic, emb] <- $rows :put doc {id => topic, emb}", {"rows": rows})
db.run_script(
    "::hnsw create doc:semantic {dim: 32, m: 16, ef_construction: 100, fields: [emb]}"
)
res = db.run_script(
    """
    ?[id, topic, dist] := ~doc:semantic{id, topic | query: vec($q), k: 5,
                                        ef: 50, bind_distance: dist}
    :order dist
    """,
    {"q": rows[42][2]},
)
for row in res.rows:
    print(row)
