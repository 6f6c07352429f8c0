"""The port's C ABI (`cozo_tpu_torch/native/cozo_c.cpp` over
`cozo_tpu_torch/hosts/c_bridge.py`): its library built into
`build/cozo_tpu_torch_kernels/`, a C host linked against it end to end,
the two bridges' string functions against each other, and the device the
options choose."""

import json
import os
import subprocess

import pytest
import torch

from cozo_tpu.hosts import c_bridge as jax_bridge
from cozo_tpu_torch.hosts import c_bridge
from cozo_tpu_torch.ops import _build

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# `native/example_c_host.c`'s calls, with options that open the Db on the
# host and the backup path from argv
C_HOST = r"""
#include <stdio.h>
#include <string.h>
#include "cozo_c.h"

int main(int argc, char** argv) {
    int32_t id = -1;
    char* err = cozo_open_db("mem", "", "{\"device\": \"cpu\"}", &id);
    if (err) { printf("open error: %s\n", err); return 1; }
    printf("opened db %d\n", id);
    char* r = cozo_run_query(id, ":create kv {k: Int => v: Int}", "{}", false);
    printf("create: %.60s\n", r); cozo_free_str(r);
    r = cozo_run_query(id, "?[k, v] <- [[1, 10], [2, 20]] :put kv {k => v}", "{}", false);
    printf("put: %.60s\n", r); cozo_free_str(r);
    r = cozo_run_query(id, "?[v] := *kv{k: $k, v}", "{\"k\": 2}", false);
    printf("query: %s\n", r);
    int ok = strstr(r, "[[20]]") != NULL;
    cozo_free_str(r);
    r = cozo_export_relations(id, "{\"relations\": [\"kv\"]}");
    printf("export: %.80s\n", r); cozo_free_str(r);
    r = cozo_backup(id, argv[1]);
    printf("backup: %s\n", r);
    ok = ok && strstr(r, "true") != NULL;
    cozo_free_str(r);
    r = cozo_run_query(id, "?[x] := nonsense(", "{}", false);
    printf("bad script ok=false: %d\n", strstr(r, "\"ok\": false") != NULL || strstr(r, "\"ok\":false") != NULL);
    cozo_free_str(r);
    if (!cozo_close_db(id)) { printf("close failed\n"); return 1; }
    printf(ok ? "C_ABI_OK\n" : "C_ABI_BAD\n");
    return ok ? 0 : 1;
}
"""


def test_c_host_end_to_end(tmp_path):
    lib = c_bridge.build_library()
    assert os.path.dirname(os.path.dirname(lib)) == os.path.join(
        _ROOT, "build", "cozo_tpu_torch_kernels")
    assert os.path.basename(lib) == "libcozo_c.so"
    src = tmp_path / "host.c"
    src.write_text(C_HOST)
    exe = str(tmp_path / "host")
    subprocess.run(["gcc", "-O2", str(src), *c_bridge.link_flags(lib), "-o",
                    exe], check=True, capture_output=True, timeout=300)
    backup = tmp_path / "cback.db"
    out = subprocess.run([exe, str(backup)], env=c_bridge.host_env(lib),
                         capture_output=True, text=True, timeout=300,
                         cwd=tmp_path)
    assert "C_ABI_OK" in out.stdout, (out.stdout, out.stderr[-1500:])
    assert backup.exists()


def test_build_writes_nothing_under_native(tmp_path, monkeypatch):
    """A build from scratch (the build directory pointed at tmp_path) runs
    g++ with its output under that directory alone; `native/libcozo_c.so`,
    the JAX package's, keeps its time stamp (unless the JAX test rebuilds
    it meanwhile, which it does only when it is missing or older than its
    source)."""
    jax_so = os.path.join(_ROOT, "native", "libcozo_c.so")
    jax_src = os.path.join(_ROOT, "native", "cozo_c.cpp")
    stable = (os.path.exists(jax_so)
              and os.path.getmtime(jax_so) >= os.path.getmtime(jax_src))
    before = os.path.getmtime(jax_so) if stable else None
    outputs = []
    real_run = _build.subprocess.run

    def run(cmd, **kw):
        outputs.append(cmd[cmd.index("-o") + 1])
        return real_run(cmd, **kw)

    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "kernels"))
    monkeypatch.setattr(_build.subprocess, "run", run)
    lib = c_bridge.build_library()
    assert len(outputs) == 1
    assert outputs[0].startswith(str(tmp_path / "kernels") + os.sep)
    assert lib.startswith(str(tmp_path / "kernels") + os.sep)
    assert os.path.exists(lib)
    if stable:
        assert os.path.getmtime(jax_so) == before


def _calls(bridge, backup_path):
    """The same calls through one bridge's string functions; each answer
    parsed, the `took` seconds aside."""
    out = []
    opened = json.loads(bridge.open_db("mem", "", '{"device": "cpu"}')
                        if bridge is c_bridge else bridge.open_db("mem", ""))
    i = opened["id"]
    for r in (
        bridge.run_query(i, ":create kv {k: Int => v: Int}", "{}", False),
        bridge.run_query(i, "?[k, v] <- [[1, 10], [2, 20]] :put kv {k => v}",
                         "", False),
        bridge.run_query(i, "?[v] := *kv{k: $k, v}", '{"k": 2}', False),
        bridge.run_query(i, "?[v] := *kv{k: $k, v}", '{"k": 1}', True),
        bridge.run_query(i, "?[x] := nonsense(", "{}", False),
        bridge.run_query(i, "?[x] := nonsense(", "{}", True),
        bridge.run_query(i, "?[k] <- [[3]] :put kv {k}", "{}", True),
        bridge.export_relations(i, '{"relations": ["kv"]}'),
        bridge.import_relations(i, '{"kv": {"headers": ["k", "v"], '
                                   '"rows": [[5, 50]]}}'),
        bridge.run_query(i, "?[k, v] := *kv{k, v}", "{}", False),
        bridge.import_relations(i, "not json"),
        bridge.backup(i, backup_path),
        bridge.restore(i, backup_path),
        bridge.import_from_backup(i, json.dumps({"path": backup_path,
                                                 "relations": ["kv"]})),
        bridge.run_query(12345, "?[a] <- [[1]]", "{}", False),
        bridge.export_relations(12345, "{}"),
    ):
        d = json.loads(r)
        d.pop("took", None)
        out.append(d)
    out.append(bridge.close_db(i))
    out.append(bridge.close_db(i))
    return out


def test_bridges_answer_alike(tmp_path):
    j = _calls(jax_bridge, str(tmp_path / "j.db"))
    t = _calls(c_bridge, str(tmp_path / "t.db"))
    assert j == t
    assert t[2]["rows"] == [[20]] and t[9]["rows"] == [[1, 10], [2, 20], [5, 50]]
    assert t[-2:] == [True, False]


@pytest.mark.parametrize("options", ["", "{}"])
def test_open_without_a_device_asks_for_the_card(options, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = json.loads(c_bridge.open_db("mem", "", options))
    assert out["ok"] is False and "CUDA" in out["message"]


@pytest.mark.parametrize("options", ["{not json", "[1]", '{"device": "tpu"}'])
def test_open_refuses_bad_options(options):
    out = json.loads(c_bridge.open_db("mem", "", options))
    assert out["ok"] is False and out["message"]


def test_open_on_the_cpu_when_asked():
    out = json.loads(c_bridge.open_db("mem", "", '{"device": "cpu"}'))
    assert out["ok"] is True
    assert c_bridge._DBS[out["id"]].device == torch.device("cpu")
    assert c_bridge.close_db(out["id"])
