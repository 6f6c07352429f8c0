"""The port (`cozo_tpu_torch`, `chip_smoke.py`) imports nothing of JAX or
of `cozo_tpu`, and never carries on on the CPU unless asked to."""

import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SCRIPT = r"""
import sys, importlib.abc

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "cozo_tpu"):
            raise ImportError(f"blocked import of {name}")

sys.meta_path.insert(0, Block())
sys.path.insert(0, "@@SITE@@")  # -S dropped site-packages; restore w/o sitecustomize
sys.path.insert(0, "@@ROOT@@")
assert "jax" not in sys.modules  # sitecustomize must not have run

import numpy as np
import cozo_tpu_torch
from cozo_tpu_torch import HnswIndex, sweep_search

rng = np.random.default_rng(0)
data = rng.standard_normal((5000, 24)).astype(np.float32)
idx = HnswIndex(dim=24, m=8, ef_construction=32, distance="Cosine",
                device="cpu")
idx.bulk_build(data, wave=2048)  # device build, on the CPU
for cd in ("f32", "bf16", "fused"):
    ids, _ = sweep_search(idx, data[:64], 5, compute_dtype=cd)
    assert (ids[:, 0] == np.arange(64)).all(), cd
ids, _ = idx.search(data[:8], k=5, ef=32, use_tpu=False)
assert (ids[:, 0] == np.arange(8)).all()

# the i8 lane, the beam search, the quant lane and the i8 build
import os
from cozo_tpu_torch.ops import quant_knn, vector_search
from cozo_tpu_torch.ops.bulk_build import bulk_build_device
ids, _ = sweep_search(idx, data[:64], 5, compute_dtype="i8")
assert (ids[:, 0] == np.arange(64)).all()
ids, _ = vector_search.hnsw_search_device(idx, data[:8], 5, 32)
assert (ids[:, 0] == np.arange(8)).all()
qt = quant_knn.QuantSweepTable("cpu").load(data, "Cosine")
ids, _ = quant_knn.quant_search(data, qt, data[:16], 5)
assert (ids[:, 0] == np.arange(16)).all()
os.environ["COZO_TPU_F32_TABLE_MAX"] = "1"
idx8 = HnswIndex(dim=24, m=8, ef_construction=32, distance="Cosine",
                 device="cpu")
bulk_build_device(idx8, data, wave=2048)
assert idx8._quant_sweep is not None
ids, _ = idx8.search(data[:64], k=5, ef=32, use_tpu=True)
assert (ids[:, 0] == np.arange(64)).mean() > 0.95

assert not any(m.split(".")[0] in ("jax", "jaxlib", "cozo_tpu")
               for m in sys.modules)
print("NO_JAX_OK")
"""


def test_port_runs_with_jax_and_cozo_tpu_blocked():
    import sysconfig

    code = _SCRIPT.replace("@@ROOT@@", _ROOT).replace(
        "@@SITE@@", sysconfig.get_paths()["purelib"]
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-S", "-c", code],  # -S: no sitecustomize preload
        capture_output=True, text=True, timeout=300, env=env,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "NO_JAX_OK" in proc.stdout


def _port_sources():
    pkg = os.path.join(_ROOT, "cozo_tpu_torch")
    for dirpath, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    for script in ("chip_smoke.py", "chip_profile.py", "chip_ubench.py"):
        yield os.path.join(_ROOT, script)


def test_no_source_imports_jax_or_cozo_tpu():
    pat = re.compile(r"^\s*(import|from)\s+(jax|cozo_tpu)\b", re.M)
    srcs = list(_port_sources())
    assert len(srcs) > 5
    for path in srcs:
        with open(path) as f:
            hit = pat.search(f.read())
        assert hit is None, f"{path}: {hit.group(0)!r}"


def test_new_modules_are_among_the_scanned_sources():
    names = {os.path.relpath(p, _ROOT) for p in _port_sources()}
    for mod in ("ops/quant_knn.py", "ops/vector_search.py",
                "ops/exact_knn.py", "ops/bulk_build.py", "utils/device.py"):
        assert os.path.join("cozo_tpu_torch", mod) in names


def test_only_the_mesh_branch_is_unported():
    """`NotImplementedError` appears once in the package: the
    `COZO_TPU_MESH` raise of `HnswIndex.search`."""
    hits = []
    for path in _port_sources():
        with open(path) as f:
            for i, line in enumerate(f, 1):
                if "NotImplementedError" in line:
                    hits.append((os.path.relpath(path, _ROOT), i))
    assert len(hits) == 1 and hits[0][0] == os.path.join(
        "cozo_tpu_torch", "models", "hnsw_index.py"), hits


def test_entry_points_raise_without_cuda(monkeypatch):
    from cozo_tpu_torch import HnswIndex, default_device, sweep_search
    from cozo_tpu_torch.ops.vector_search import brute_force_knn

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        default_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        default_device("cuda")
    assert default_device("cpu") == torch.device("cpu")

    rng = np.random.default_rng(2)
    data = rng.standard_normal((4096, 8)).astype(np.float32)
    idx = HnswIndex(dim=8, m=4, ef_construction=16)
    for v in data[:50]:
        idx.insert(v)  # host graph code needs no device
    with pytest.raises(RuntimeError, match="CUDA"):
        sweep_search(idx, data[:4], 3)
    with pytest.raises(RuntimeError, match="CUDA"):
        HnswIndex(dim=8, m=4, ef_construction=16).bulk_build(data)
    with pytest.raises(RuntimeError, match="CUDA"):
        brute_force_knn(data, np.ones(len(data)), data[:2], 3, "L2")
    # the int8 lanes' and the beam search's entry points
    from cozo_tpu_torch.ops.quant_knn import QuantSweepTable
    from cozo_tpu_torch.ops.vector_search import hnsw_search_device

    with pytest.raises(RuntimeError, match="CUDA"):
        sweep_search(idx, data[:4], 3, compute_dtype="i8")
    with pytest.raises(RuntimeError, match="CUDA"):
        hnsw_search_device(idx, data[:4], 3, 16)
    with pytest.raises(RuntimeError, match="CUDA"):
        QuantSweepTable().load(data, "L2")


def test_chip_smoke_fails_without_the_card_or_the_repo(tmp_path):
    """chip_smoke.py exits non-zero and prints no result here (no CUDA),
    and likewise alone in a directory without the package."""
    lone = tmp_path / "chip_smoke.py"
    shutil.copy(os.path.join(_ROOT, "chip_smoke.py"), lone)
    for cwd, script in ((_ROOT, "chip_smoke.py"), (tmp_path, str(lone))):
        proc = subprocess.run([sys.executable, script], cwd=cwd,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode != 0
        assert '"ok": true' not in proc.stdout
