"""The port's profiling hooks (`cozo_tpu_torch/utils/profiling.py`)
against the JAX package's: `timed` prints the same line, and
`device_trace` writes a Chrome trace of what runs inside it."""

import glob
import json
import os
import re

import numpy as np
import torch

from cozo_tpu.utils import profiling as jax_profiling
from cozo_tpu_torch import Db
from cozo_tpu_torch.utils import profiling


def test_timed_prints_the_same_line():
    lines = {}
    for name, mod in (("jax", jax_profiling), ("port", profiling)):
        got = []
        with mod.timed("step", sink=got.append):
            sum(range(1000))
        lines[name] = got
    pat = re.compile(r"^step: \d+\.\d{2}ms$")
    assert all(len(v) == 1 and pat.match(v[0]) for v in lines.values()), lines


def test_timed_reports_when_the_body_raises():
    got = []
    try:
        with profiling.timed("fails", sink=got.append):
            raise KeyError("x")
    except KeyError:
        pass
    assert len(got) == 1 and got[0].startswith("fails: ")


def test_device_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    db = Db("mem", device="cpu")
    a = torch.from_numpy(np.ones((64, 64), np.float32))
    with profiling.device_trace(str(tmp_path / "trace")):
        (a @ a).sum().item()
        db.run_script("?[x] <- [[1]]")
    files = glob.glob(str(tmp_path / "trace" / "trace-*.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any("mm" in n for n in names), sorted(names)[:50]


def test_device_trace_writes_its_trace_when_the_body_raises(tmp_path):
    try:
        with profiling.device_trace(str(tmp_path)):
            torch.ones(3).sum()
            raise ValueError("inside")
    except ValueError:
        pass
    assert len(os.listdir(tmp_path)) == 1
