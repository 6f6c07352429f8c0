"""Loader for the C scalar codec (native/codec.c): builds the CPython
extension on demand with the system compiler and imports it from the
native/ directory.  Import failure (no compiler, exotic platform) is
non-fatal — memcmp.py falls back to the pure-Python codec."""

from __future__ import annotations

import importlib.util
import os
import subprocess
import sysconfig


def load():
    here = os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    )
    native = os.path.join(here, "native")
    suffix = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
    so = os.path.join(native, "codec" + suffix)
    src = os.path.join(native, "codec.c")
    if not os.path.exists(so) or (
        os.path.exists(src) and os.path.getmtime(src) > os.path.getmtime(so)
    ):
        include = sysconfig.get_paths()["include"]
        subprocess.run(
            ["gcc", "-O2", "-shared", "-fPIC", f"-I{include}", "-o", so, src],
            check=True,
            capture_output=True,
        )
    spec = importlib.util.spec_from_file_location("codec", so)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
