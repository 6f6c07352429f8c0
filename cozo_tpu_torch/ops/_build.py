"""Build and load the port's CUDA kernels (`cozo_tpu_torch/csrc/*.cu`).

Each source is compiled at first use by `nvcc` into a shared library with
a plain C interface under `build/cozo_tpu_torch_kernels/` at the root of
the checkout (git-ignored), and loaded with `ctypes`.  The file name
carries a hash of the source and the flags, so an edited source is
rebuilt and a stale library is never loaded.  Nothing is fetched: the
only inputs are the sources in the checkout and the CUDA toolkit.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Tuple

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "cozo_tpu_torch_kernels")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_LIBS: Dict[Tuple[str, Tuple[str, ...]], ctypes.CDLL] = {}
_LOCK = threading.Lock()
# seconds and ptxas report of each build done by this process
BUILD_INFO: Dict[str, Tuple[float, str]] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("cozo_tpu_torch: nvcc not found (set CUDA_HOME)")


def lib_path(name: str, defines: Tuple[str, ...] = ()) -> str:
    src = os.path.join(CSRC, name + ".cu")
    with open(src, "rb") as f:
        h = hashlib.sha1(f.read() + " ".join((*NVCC_FLAGS, *defines)).encode()
                         ).hexdigest()
    return os.path.join(BUILD_DIR, f"{name}-{h[:12]}.so")


def build(name: str, defines: Tuple[str, ...] = ()) -> str:
    """Compile `csrc/<name>.cu` (with extra `-D` flags `defines`, for a
    variant of a kernel) unless its library is already built; returns the
    library's path."""
    out = lib_path(name, defines)
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [nvcc_path(), *NVCC_FLAGS, *defines, "-o", tmp,
           os.path.join(CSRC, name + ".cu")]
    t0 = time.time()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"cozo_tpu_torch: nvcc failed for {name}.cu:\n{proc.stderr}"
        )
    os.replace(tmp, out)
    BUILD_INFO[" ".join((name, *defines))] = (time.time() - t0, proc.stderr)
    return out


def load(name: str, defines: Tuple[str, ...] = ()) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built if needed."""
    with _LOCK:
        lib = _LIBS.get((name, defines))
        if lib is None:
            lib = ctypes.CDLL(build(name, defines))
            lib.cozo_cuda_error_string.argtypes = [ctypes.c_int]
            lib.cozo_cuda_error_string.restype = ctypes.c_char_p
            _LIBS[(name, defines)] = lib
        return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        msg = lib.cozo_cuda_error_string(err).decode()
        raise RuntimeError(f"cozo_tpu_torch: {what} failed: {msg} ({err})")
