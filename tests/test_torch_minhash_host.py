"""The CUDA source of the MinHash segment-min (`cozo_tpu_torch/csrc/
minhash.cu`), run on the CPU and held against its plain PyTorch version.

As `tests/test_torch_graph_host.py` does for the graph kernels: the source
is compiled with g++ against `tests/test_torch_beam_host.py`'s stand-in
`cuda_runtime.h` (a fiber per CUDA thread, blocks one after
another, barriers for `__syncthreads`), at 64 threads a block (so n_perm
128 and 256 take the kernel's loop over permutation groups, and 100 a
ragged last group) and with tiles of 256 hashes (so docs of 300 tokens and
the 100,000-token doc cross tiles), and its C entry point is called with
CPU tensors through the module's own launch helper, at the shapes of
`chip_smoke.py` phase 2.

Tolerance: none.  The signatures must be EQUAL to `segment_min_plain`'s
and to the host `minhash_segments` (integer minima).  What this cannot
show: that nvcc takes the source, any time.  Skips where there is no g++.
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from chip_smoke import MINHASH_CASES, minhash_inputs, minhash_tensors
from cozo_tpu_torch.ops import _build
from cozo_tpu_torch.ops import minhash as mh
from tests.test_torch_beam_host import SHIM
from tests.test_torch_fused_routes import _extern_c_functions
from tests.test_torch_graph_host import to_host_cpp

FLAGS = ["-DCOZO_MINHASH_THREADS=64", "-DCOZO_MINHASH_TILE=256"]


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the kernel source for the host")
    work = tmp_path_factory.mktemp("minhash_host")
    (work / "cuda_runtime.h").write_text(SHIM)
    with open(f"{_build.CSRC}/minhash.cu") as f:
        (work / "minhash.cpp").write_text(to_host_cpp(f.read()))
    proc = subprocess.run(
        [gxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread", *FLAGS,
         f"-I{work}", "-o", str(work / "minhash.so"),
         str(work / "minhash.cpp")],
        capture_output=True, text=True, timeout=600)
    if proc.returncode != 0 and "barrier" in proc.stderr \
            and "No such file" in proc.stderr:
        pytest.skip("needs a g++ with C++20 <barrier>")
    assert proc.returncode == 0, proc.stderr[-3000:]
    return mh._bind(ctypes.CDLL(str(work / "minhash.so")))


def run_source(lib, h, o, n_perm):
    out = torch.full((o.shape[0], n_perm), 7, dtype=torch.int32)
    mh._segment_min_launch(lib, h, o, mh._seeds_on(n_perm, h.device),
                           n_perm, out, None)
    return out


@pytest.mark.parametrize("i", range(len(MINHASH_CASES)),
                         ids=[c[0] for c in MINHASH_CASES])
def test_minhash_source_on_the_host(lib, i):
    """Every phase-2 case: equal to the plain version and to the host
    `minhash_segments`, empty docs all ones."""
    _, lens, n_perm = MINHASH_CASES[i]
    flat, offs = minhash_inputs(lens, i)
    h, o = minhash_tensors(flat, offs, torch.device("cpu"))
    got = run_source(lib, h, o, n_perm)
    assert torch.equal(got, mh.segment_min_plain(h, o, n_perm))
    assert (got.numpy().view(np.uint32)
            == mh.minhash_segments(flat, offs, n_perm)).all()
    empty = np.diff(np.append(offs, len(flat))) == 0
    assert (got.numpy()[empty] == -1).all()


def test_minhash_source_takes_tokens_before_the_first_start_as_no_doc(lib):
    """Doc starts that do not begin at 0 (a chunk's slice of a larger
    buffer): the tokens before the first start belong to no doc, as in
    the host reduceat."""
    flat, _ = minhash_inputs((40,), 3)
    offs = np.array([10, 10, 25], np.int64)
    h, o = minhash_tensors(flat, offs, torch.device("cpu"))
    got = run_source(lib, h, o, 33)
    assert torch.equal(got, mh.segment_min_plain(h, o, 33))
    assert (got.numpy().view(np.uint32)
            == mh.minhash_segments(flat[10:], offs - 10, 33)).all()


def test_minhash_launcher_refuses_bad_arguments(lib):
    h = torch.zeros(4, dtype=torch.int32)
    o = torch.zeros(2, dtype=torch.int64)
    out = torch.zeros((2, 1), dtype=torch.int32)
    for T, D, n_perm in ((4, 2, 0), (-1, 2, 1), (4, -1, 1)):
        err = lib.cozo_minhash_segments(h.data_ptr(), o.data_ptr(), T, D,
                                        h.data_ptr(), n_perm, out.data_ptr(),
                                        None)
        assert err != 0, (T, D, n_perm)
    assert lib.cozo_minhash_segments(None, None, 0, 0, None, 1, None,
                                      None) == 0


def test_c_interface_matches_the_wrapper():
    """The argtypes list follows the C signature in the source."""
    assert _extern_c_functions()["cozo_minhash_segments"] == mh._ARGTYPES
