"""Minimal embedding example (reference cozo-core-examples/src/bin/run.rs)."""

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
db.run_script(":create person {name: String => age: Int}")
db.run_script(
    "?[name, age] <- [['alice', 30], ['bob', 25], ['carol', 35]] "
    ":put person {name => age}"
)
res = db.run_script("?[name] := *person{name, age}, age > 26 :order name")
print(res.headers, res.rows)
