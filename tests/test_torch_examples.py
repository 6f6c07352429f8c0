"""The port's examples (`cozo_tpu_torch/examples/`) against the JAX
package's (`examples/`): each run in a subprocess, the JAX one as it is,
the port's with `--device cpu`; their stdout must be equal.  A line that
prints floats (a PageRank score, a distance) is compared number by number
within 1e-6 and its text around the numbers exactly; every other line
exactly."""

import os
import re
import subprocess
import sys

import pytest

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = ["embed_basic", "graph_algos", "shared_store", "vector_search"]
_NUM = re.compile(r"-?\d+\.\d+(?:[eE][-+]?\d+)?")


def _run(args, extra_env=None):
    env = dict(os.environ, **(extra_env or {}))
    env.pop("PYTHONPATH", None)  # each example finds its checkout itself
    return subprocess.run([sys.executable, *args], capture_output=True,
                          text=True, timeout=300, cwd=_ROOT, env=env)


def _same_lines(a, b):
    la, lb = a.splitlines(), b.splitlines()
    assert len(la) == len(lb), (a, b)
    for x, y in zip(la, lb):
        fx, fy = _NUM.findall(x), _NUM.findall(y)
        if not fx:
            assert x == y
            continue
        assert _NUM.sub("#", x) == _NUM.sub("#", y), (x, y)
        assert len(fx) == len(fy)
        for u, v in zip(fx, fy):
            assert abs(float(u) - float(v)) <= 1e-6, (x, y)


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_prints_what_the_jax_one_prints(name):
    j = _run([os.path.join("examples", f"{name}.py")])
    t = _run([os.path.join("cozo_tpu_torch", "examples", f"{name}.py"),
              "--device", "cpu"])
    assert j.returncode == 0, j.stderr[-2000:]
    assert t.returncode == 0, t.stderr[-2000:]
    assert t.stdout.strip()
    _same_lines(j.stdout, t.stdout)


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_without_a_device_refuses_without_a_card(name):
    t = _run([os.path.join("cozo_tpu_torch", "examples", f"{name}.py")],
             {"CUDA_VISIBLE_DEVICES": ""})
    assert t.returncode != 0
    assert "CUDA" in t.stderr
