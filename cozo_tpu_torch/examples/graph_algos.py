"""Graph algorithms example: PageRank + shortest paths over a relation."""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from cozo_tpu_torch import Db

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--device", default=None,
                help="the Db's device: the card unless 'cpu' is given")
device = ap.parse_args().device

db = Db("mem", device=device)
db.run_script(":create follows {fr: String, to: String}")
edges = [
    ["a", "b"], ["b", "c"], ["c", "a"], ["a", "c"], ["d", "a"], ["c", "d"],
]
db.run_script("?[fr, to] <- $e :put follows {fr, to}", {"e": edges})
print(db.run_script("?[n, score] <~ PageRank(*follows[]) :order -score").rows)
print(
    db.run_script(
        "st[x] <- [['a']]; en[x] <- [['d']]; "
        "?[s, g, cost, path] <~ ShortestPathDijkstra(*follows[], st[], en[])"
    ).rows
)
