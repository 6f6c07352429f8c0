"""The port's CPU HNSW baseline (`cozo_tpu_torch/ops/cpu_baseline.py`)
against the JAX package's wrapper of the same source
(`native/hnsw_baseline.cpp`), and the graph-quality check: the port's
device bulk build against the JAX package's and against the baseline."""

import os

import numpy as np
import pytest

from cozo_tpu.models.hnsw_index import HnswIndex as JaxIndex
from cozo_tpu.ops import cpu_baseline as jax_baseline
from cozo_tpu_torch import HnswIndex
from cozo_tpu_torch.ops import _build, cpu_baseline
from cozo_tpu_torch.utils.datasets import glove_like
from tests._torch_state import recall

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_SO = os.path.join(_ROOT, "native", "libhnswb.so")


@pytest.mark.parametrize("metric", ["L2", "Cosine"])
def test_wrappers_answer_alike(metric):
    rng = np.random.default_rng(5)
    data = rng.standard_normal((2000, 24)).astype(np.float32)
    qs = rng.standard_normal((64, 24)).astype(np.float32)
    got = []
    for mod in (jax_baseline, cpu_baseline):
        b = mod.CpuHnswBaseline(24, m=8, ef_construction=64, metric=metric)
        b.add(data)
        got.append(b.search(qs, 10, 48))
    assert np.array_equal(got[0][0], got[1][0])
    assert np.array_equal(got[0][1], got[1][1])
    # the graph is a sane one: most of the exact neighbours are found
    if metric == "L2":
        dist = ((qs[:, None] - data[None]) ** 2).sum(2)
    else:
        dn = data / np.linalg.norm(data, axis=1, keepdims=True)
        dist = -(qs / np.linalg.norm(qs, axis=1, keepdims=True)) @ dn.T
    assert recall(got[1][0], np.argsort(dist, axis=1)[:, :10]) > 0.9


def test_libraries_sit_apart(tmp_path, monkeypatch):
    """A build from scratch (the build directory pointed at tmp_path)
    writes its library there, under a name with the source's hash; the
    JAX package's `native/libhnswb.so` keeps its time stamp."""
    before = os.path.getmtime(JAX_SO) if os.path.exists(JAX_SO) else None
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "kernels"))
    monkeypatch.setattr(cpu_baseline, "_LIB", None)
    cpu_baseline.CpuHnswBaseline(8)
    built = os.listdir(tmp_path / "kernels")
    assert len(built) == 1 and built[0].startswith("libhnswb-")
    assert cpu_baseline._LIB._name == str(tmp_path / "kernels" / built[0])
    assert (os.path.getmtime(JAX_SO) if os.path.exists(JAX_SO) else None) \
        == before
    # the library of this checkout's build directory, in every other use
    monkeypatch.undo()
    assert os.path.dirname(cpu_baseline._lib()._name) == os.path.join(
        _ROOT, "build", "cozo_tpu_torch_kernels")
    assert cpu_baseline._lib()._name != os.path.realpath(JAX_SO)


# The graph-quality check: glove_like's draw (the shape of the main path's
# data) at 20,000 rows, built at the main path's m = 16,
# ef_construction = 200, wave 8,192 three ways; recall@10 at ef = 64 of
# the host search on the next 256 rows of the draw against exact cosine.
N, NQ, K = 20_000, 256, 10


def three_builds(data, qs, efs=(64,)):
    """Recall@10 of the host search at each ef for the JAX build, the
    port's build on the CPU and the baseline, and each build's seconds."""
    import time

    dn = data / np.linalg.norm(data, axis=1, keepdims=True)
    qn = qs / np.linalg.norm(qs, axis=1, keepdims=True)
    gt = np.argsort(-(qn @ dn.T), axis=1, kind="stable")[:, :K]
    out = {}
    t0 = time.time()
    jidx = JaxIndex(dim=100, m=16, ef_construction=200, distance="Cosine")
    jidx.bulk_build(data, wave=8192)
    out["jax_build_s"] = time.time() - t0
    t0 = time.time()
    tidx = HnswIndex(dim=100, m=16, ef_construction=200, distance="Cosine",
                     device="cpu")
    tidx.bulk_build(data, wave=8192)
    out["port_build_s"] = time.time() - t0
    t0 = time.time()
    base = cpu_baseline.CpuHnswBaseline(100, 16, 200, "Cosine")
    base.add(data)
    out["baseline_build_s"] = time.time() - t0
    for ef in efs:
        out[f"jax_ef{ef}"] = recall(
            jidx.search(qs, k=K, ef=ef, use_tpu=False)[0], gt)
        out[f"port_ef{ef}"] = recall(
            tidx.search(qs, k=K, ef=ef, use_tpu=False)[0], gt)
        out[f"baseline_ef{ef}"] = recall(base.search(qs, K, ef)[0], gt)
    return out


def test_graph_quality_three_builds():
    x = glove_like(N + NQ, 100, seed=42)
    r = three_builds(x[:N], x[N:])
    r_j, r_t, r_b = r["jax_ef64"], r["port_ef64"], r["baseline_ef64"]
    print(f"recall@10 at ef = 64: JAX {r_j:.5f}, port {r_t:.5f}, baseline "
          f"{r_b:.5f}; port - baseline {r_t - r_b:+.5f}")
    assert abs(r_t - r_j) <= 0.02, (r_t, r_j)
    assert r_b >= 0.95, r_b


if __name__ == "__main__":
    # The same three builds at another size, on a CPU:
    #   python -m tests.test_torch_cpu_baseline --n 262144 [--main-draw]
    # --main-draw takes chip_smoke.py phase 3c's rows and queries: the first
    # n rows of glove_like(1,183,514 + 16,384, 100, seed 42) and the first
    # 256 rows of its last 16,384; otherwise glove_like(n + 256) as above.
    import argparse
    import json

    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=N)
    ap.add_argument("--main-draw", action="store_true")
    args = ap.parse_args()
    if args.main_draw:
        x = glove_like(1_183_514 + 16_384, 100, seed=42)
        data, qs = x[:args.n].copy(), x[1_183_514:1_183_514 + NQ].copy()
        del x
    else:
        x = glove_like(args.n + NQ, 100, seed=42)
        data, qs = x[:args.n], x[args.n:]
    print(json.dumps({"n": args.n, "main_draw": args.main_draw,
                      **three_builds(data, qs, efs=(64, 128))}))
