"""String-in/string-out shim consumed by the C ABI host
(`cozo_tpu_torch/native/cozo_c.cpp`, the analog of
`cozo-lib-c/src/lib.rs:44-323`; counterpart of
`cozo_tpu/hosts/c_bridge.py`).

Every function takes/returns UTF-8 JSON strings so the C side stays a
thin CPython-embedding layer with no object marshalling.  `open_db`'s
options are JSON: `""` or `{}` opens the Db on the card,
`{"device": "cpu"}` on the host.

`build_library()` builds `libcozo_c.so` (the C ABI of `native/cozo_c.h`)
and `host_env()` gives the environment a C host runs in: a C program
that embeds libpython starts an interpreter that sees neither the
checkout nor the site-packages of the interpreter that built it, and
the port's Db imports torch and numpy.

    gcc host.c -Inative -L<lib dir> -lcozo_c -L<LIBDIR> -lpython3.X -o host
    env PYTHONPATH=<checkout>:<purelib> LD_LIBRARY_PATH=<lib dir>:<LIBDIR> ./host
"""

from __future__ import annotations

import json
import os
import sys
import sysconfig
from typing import Dict

from ..runtime.db import Db
from ..utils.errors import CozoError

_DBS: Dict[int, Db] = {}
_NEXT_ID = 0


def open_db(engine: str, path: str, options: str = "") -> str:
    """Returns {"ok": true, "id": N} or {"ok": false, "message": ...}.
    `options`: JSON, `{"device": ...}` (absent: the card)."""
    global _NEXT_ID
    try:
        opts = json.loads(options) if options else {}
        if not isinstance(opts, dict):
            raise ValueError(f"options must be a JSON object: {options!r}")
        db = Db(engine, path, device=opts.get("device"))
    except Exception as e:  # noqa: BLE001
        return json.dumps({"ok": False, "message": str(e)})
    _NEXT_ID += 1
    _DBS[_NEXT_ID] = db
    return json.dumps({"ok": True, "id": _NEXT_ID})


def close_db(db_id: int) -> bool:
    db = _DBS.pop(db_id, None)
    if db is None:
        return False
    try:
        db.close()
    except Exception:  # noqa: BLE001
        pass
    return True


def _get(db_id: int) -> Db:
    db = _DBS.get(db_id)
    if db is None:
        raise CozoError(f"database {db_id} is not open")
    return db


def run_query(db_id: int, script: str, params_json: str, immutable: bool) -> str:
    try:
        db = _get(db_id)
    except CozoError as e:
        return json.dumps({"ok": False, "message": str(e)})
    if immutable:
        try:
            params = json.loads(params_json) if params_json else {}
            res = db.run_script(script, params, immutable=True)
            d = res.to_dict()
            d["ok"] = True
            return json.dumps(d)
        except CozoError as e:
            return json.dumps(
                {"ok": False, "message": e.message, "code": e.code}
            )
        except Exception as e:  # noqa: BLE001
            return json.dumps({"ok": False, "message": str(e)})
    return db.run_script_json(script, params_json or "{}")


def export_relations(db_id: int, payload_json: str) -> str:
    try:
        db = _get(db_id)
        rels = json.loads(payload_json).get("relations", [])
        data = db.export_relations(rels)
        return json.dumps({"ok": True, "data": data})
    except Exception as e:  # noqa: BLE001
        return json.dumps({"ok": False, "message": str(e)})


def import_relations(db_id: int, payload_json: str) -> str:
    try:
        db = _get(db_id)
        db.import_relations(json.loads(payload_json))
        return json.dumps({"ok": True})
    except Exception as e:  # noqa: BLE001
        return json.dumps({"ok": False, "message": str(e)})


def backup(db_id: int, out_path: str) -> str:
    try:
        _get(db_id).backup_db(out_path)
        return json.dumps({"ok": True})
    except Exception as e:  # noqa: BLE001
        return json.dumps({"ok": False, "message": str(e)})


def restore(db_id: int, in_path: str) -> str:
    try:
        _get(db_id).restore_backup(in_path)
        return json.dumps({"ok": True})
    except Exception as e:  # noqa: BLE001
        return json.dumps({"ok": False, "message": str(e)})


def import_from_backup(db_id: int, payload_json: str) -> str:
    try:
        p = json.loads(payload_json)
        _get(db_id).import_from_backup(p["path"], p.get("relations", []))
        return json.dumps({"ok": True})
    except Exception as e:  # noqa: BLE001
        return json.dumps({"ok": False, "message": str(e)})


_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
C_SRC = os.path.join(_ROOT, "cozo_tpu_torch", "native", "cozo_c.cpp")
C_HEADER_DIR = os.path.join(_ROOT, "native")  # cozo_c.h, shared with JAX's


def _python_link():
    """(include dir, LIBDIR, library name) of the running interpreter."""
    pyver = f"python{sys.version_info.major}.{sys.version_info.minor}"
    return (sysconfig.get_paths()["include"],
            sysconfig.get_config_var("LIBDIR"), pyver)


def build_library() -> str:
    """`libcozo_c.so` built from the port's `native/cozo_c.cpp` against
    the running interpreter's libpython, in a directory of its own under
    `build/cozo_tpu_torch_kernels/` named by a hash (never
    `native/libcozo_c.so`, the JAX package's); returns its path."""
    from ..ops._build import build_host

    inc, libdir, pyver = _python_link()
    return build_host(C_SRC, ["-O2", "-std=c++17", "-shared", "-fPIC",
                              f"-I{inc}"], "cozo_c-{hash}/libcozo_c.so",
                      libs=[f"-L{libdir}", f"-l{pyver}"])


def link_flags(lib: str):
    """gcc flags that link a C host against `lib` (`build_library()`)."""
    _, libdir, pyver = _python_link()
    return [f"-I{C_HEADER_DIR}", f"-L{os.path.dirname(lib)}", "-lcozo_c",
            f"-L{libdir}", f"-l{pyver}"]


def host_env(lib: str) -> dict:
    """This process's environment for a C host linked against `lib`: the
    loader finds the library and libpython, and the embedded interpreter
    imports the checkout and the packages this interpreter sees (its
    purelib and platlib, and where torch and numpy lie)."""
    import numpy
    import torch

    env = dict(os.environ)
    paths = sysconfig.get_paths()
    sites = [_ROOT]
    for p in (paths["purelib"], paths["platlib"],
              os.path.dirname(os.path.dirname(torch.__file__)),
              os.path.dirname(os.path.dirname(numpy.__file__))):
        if p not in sites:
            sites.append(p)
    env["PYTHONPATH"] = os.pathsep.join(sites)
    env["LD_LIBRARY_PATH"] = os.pathsep.join(
        [os.path.dirname(lib), _python_link()[1]]
        + [p for p in env.get("LD_LIBRARY_PATH", "").split(os.pathsep) if p])
    return env
