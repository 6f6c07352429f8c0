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

# the Db chain: relations, rules, an HNSW index by the DDL and a search
from cozo_tpu_torch import Db
db = Db("mem", device="cpu")
db.run_script(":create item {id: Int => v: <F32; 24>}")
db.run_script("?[id, v] <- $rows :put item {id => v}",
              {"rows": [[i, data[i]] for i in range(300)]})
db.run_script("::hnsw create item:ix {dim: 24, m: 8, ef_construction: 32, "
              "fields: [v], distance: Cosine}")
res = db.run_script("?[id, d] := ~item:ix{id | query: vec($q), k: 3, ef: 32, "
                    "bind_distance: d}", {"q": data[5].tolist()})
assert min(res.rows, key=lambda r: r[1])[0] == 5
res = db.run_script("r[a, b] := *item{id: a}, b = a % 3, a < 9\n"
                    "?[b, count(a)] := r[a, b]")
assert res.rows == [[0, 3], [1, 3], [2, 3]]

# the graph rules' device entry points (the plain versions on the CPU)
from cozo_tpu_torch.ops import graph_algos as ga
ip, dst = np.array([0, 2, 3, 3]), np.array([1, 2, 2])
assert abs(ga.pagerank_jax(ip, dst, device="cpu").sum() - 1.0) < 1e-5
d, p = ga.sssp_device(ip, dst, np.ones(3, np.float32), [0], device="cpu")
assert d[0].tolist() == [0.0, 1.0, 1.0] and p[0].tolist() == [-1, 0, 0]
assert ga.labelprop_jax(ip, dst, iterations=2, device="cpu").shape == (3,)

# the text indexes: FTS, and an LSH backfill past DEVICE_MIN_TOKENS (the
# segment-min's device route, its plain version on a CPU Db)
from cozo_tpu_torch.ops import minhash
db.run_script(":create doc {id: Int => body: String}")
docs = [" ".join(f"w{w}" for w in rng.integers(0, 300, 10)) for _ in range(2000)]
db.run_script("?[id, body] <- $rows :put doc {id => body}",
              {"rows": [[i, d] for i, d in enumerate(docs)]})
db.run_script("::fts create doc:ft {extractor: body, tokenizer: Simple}")
w = docs[5].split()[0]
res = db.run_script(f"?[id] := ~doc:ft{{id | query: '{w}', k: 2000}}")
assert {r[0] for r in res.rows} == {i for i, d in enumerate(docs) if w in d.split()}
routes = []
minhash._dispatch = (lambda real: lambda *a: routes.append(len(a[0])) or real(*a))(
    minhash._dispatch)
db.run_script("::lsh create doc:sim {extractor: body, tokenizer: Simple, "
              "n_perm: 64, target_threshold: 0.7}")
assert routes and routes[0] >= minhash.DEVICE_MIN_TOKENS
res = db.run_script("?[id, s] := ~doc:sim{id | query: $q, k: 3, bind_similarity: s}",
                    {"q": docs[9]})
assert [9, 1.0] in res.rows
db.run_script("?[id] <- [[9]] :rm doc {id}")
res = db.run_script("?[id] := ~doc:sim{id | query: $q, k: 3}", {"q": docs[9]})
assert 9 not in [r[0] for r in res.rows]

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
    for script in ("chip_smoke.py", "chip_profile.py", "chip_ubench.py",
                   "chip_graph_vs.py"):
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
                "ops/exact_knn.py", "ops/bulk_build.py", "utils/device.py",
                "runtime/db.py", "runtime/hnsw.py", "runtime/hnsw_packed.py",
                "runtime/sysops.py", "runtime/indexing.py", "query/eval.py",
                "query/fastpath.py", "parse/parser.py", "data/memcmp.py",
                "storage/sqlite.py", "fixed_rule/algos.py",
                "ops/graph_algos.py", "utils/graph_stage.py",
                "ops/minhash.py", "runtime/minhash_lsh.py",
                "fts/indexing.py", "fts/tokenizer.py", "fts/ast.py"):
        assert os.path.join("cozo_tpu_torch", mod) in names


# Every `raise NotImplementedError(...)` of the package, by file, with the
# ROADMAP §1 item its message names.  Bare `raise NotImplementedError`
# marks an abstract method and is allowed only in the base classes below.
UNPORTED_SITES = {
    "models/hnsw_index.py": [3],       # COZO_TPU_MESH mesh serving
    "runtime/db.py": [4],              # the tkv, plog and remote engines
}
ABSTRACT_BASES = {"storage/base.py", "data/aggr.py", "data/expr.py",
                  "query/eval.py", "fixed_rule/__init__.py"}


def test_unported_branches_are_the_listed_sites():
    """`raise NotImplementedError` appears only at the listed sites, and
    each names its ROADMAP item in its message."""
    pkg = os.path.join(_ROOT, "cozo_tpu_torch")
    found, bare = {}, set()
    for path in _port_sources():
        rel = os.path.relpath(path, pkg)
        with open(path) as f:
            lines = f.read().splitlines()
        for i, line in enumerate(lines):
            if "raise NotImplementedError" not in line:
                continue
            if line.rstrip().endswith("raise NotImplementedError"):
                bare.add(rel)
                continue
            # the message's string literals, joined
            msg = re.sub(r'"\s*f?"', "", " ".join(lines[i:i + 4]))
            item = re.search(r"ROADMAP §1 item (\d)", msg)
            assert item, f"{rel}:{i + 1} names no ROADMAP item"
            found.setdefault(rel, []).append(int(item.group(1)))
    assert found == UNPORTED_SITES
    assert bare <= ABSTRACT_BASES, bare - ABSTRACT_BASES


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
    # the Db resolves its device once, at construction
    from cozo_tpu_torch import Db, open_db

    with pytest.raises(RuntimeError, match="CUDA"):
        Db("mem")
    with pytest.raises(RuntimeError, match="CUDA"):
        open_db("mem")
    assert Db("mem", device="cpu").device == torch.device("cpu")


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
