"""The port's REPL (`cozo_tpu_torch/hosts/repl.py`) against the JAX
package's (`cozo_tpu/hosts/repl.py`): the same stdin through both, each
in a directory of its own (the `%` commands take relative paths, so the
outputs name the same files); the outputs must be equal, the banner line
aside."""

import json
import os
import subprocess
import sys

import pytest

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# every `%` command, a backslash continuation, a CozoScript error and an
# unknown command; then a second session restores the backup
SESSION = """\
%help
%save nothing.json
:create kv {k: Int => v: String}
?[k, v] <- [[1, 'a'], [2, 'b']] \\
:put kv {k => v}
?[k, v] := *kv{k, v}
%save last.json
%backup back.db
%import rows.json
?[k, v] := *kv{k, v}
%run script.cozo
?[x] := nonsense(
?[x] := *missing[x]
%restore back.db
%import nowhere.json
%frobnicate

%exit
?[never] <- [[1]]
"""
RESTORE = """\
%restore back.db
?[k, v] := *kv{k, v}
"""


def _repl(cmd, cwd, stdin):
    env = dict(os.environ, PYTHONPATH=_ROOT, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-m", *cmd], input=stdin,
                          capture_output=True, text=True, timeout=120,
                          cwd=cwd, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    banner, _, rest = proc.stdout.partition("\n")
    return banner, rest


def _workdir(path):
    path.mkdir()
    (path / "rows.json").write_text(json.dumps(
        {"kv": {"headers": ["k", "v"], "rows": [[3, "c"]]}}))
    (path / "script.cozo").write_text("?[n] := *kv{k: n}, n > 1")
    return path


@pytest.fixture(scope="module")
def sessions(tmp_path_factory):
    """{package: [(banner, output), ...]} of both sessions, and the JAX
    and port work directories."""
    out, dirs = {}, {}
    for name, cmd in (("jax", ["cozo_tpu.hosts.repl"]),
                      ("port", ["cozo_tpu_torch.hosts.repl", "--device",
                                "cpu"])):
        d = _workdir(tmp_path_factory.mktemp(name) / "w")
        out[name] = [_repl(cmd, d, SESSION), _repl(cmd, d, RESTORE)]
        dirs[name] = d
    return out, dirs


def test_outputs_equal_banner_aside(sessions):
    out, _ = sessions
    for (bj, j), (bt, t) in zip(out["jax"], out["port"]):
        assert j == t
        assert bj.startswith("cozo_tpu REPL")
        assert bt.startswith("cozo_tpu_torch REPL") and "cpu" in bt


def test_session_exercises_every_command(sessions):
    out, dirs = sessions
    text = out["port"][0][1]
    for want in ("Meta commands", "no result to save", "saved to last.json",
                 "backup done", "import done", "(3 rows)", "error[",
                 "io error", "unknown meta command %frobnicate"):
        assert want in text, want
    assert "never" not in text  # nothing after %exit
    assert "restore done" in out["port"][1][1]
    assert "(2 rows)" in out["port"][1][1]
    saved = [json.loads((dirs[p] / "last.json").read_text())
             for p in ("jax", "port")]
    assert saved[0] == saved[1] and saved[1]["rows"] == [[1, "a"], [2, "b"]]


def test_cli_without_a_device_refuses_without_a_card(tmp_path):
    env = dict(os.environ, PYTHONPATH=_ROOT, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, "-m", "cozo_tpu_torch.hosts.repl"],
        input="?[a] <- [[1]]\n", capture_output=True, text=True,
        timeout=120, cwd=tmp_path, env=env)
    assert proc.returncode != 0
    assert "RuntimeError" in proc.stderr and "CUDA" in proc.stderr
    assert "REPL" not in proc.stdout
