"""The CUDA source of the per-chunk selection (`cozo_tpu_torch/csrc/
slab_topk.cu`), run on the CPU in its build with one warp a block and
256-entry buffers, and held against `select_topk_plain`: how, and what
the cases are, in `tests/_torch_slab_topk_host.py`, which the three
builds' files share.

Beside the cases: a ragged block of launches, and what the C entry
refuses.
"""

import pytest
import torch

from chip_smoke import topk_inputs, topk_same
from cozo_tpu_torch.ops import exact_knn as ek
from tests import _torch_slab_topk_host as host

BUILD = "32 threads, 256-entry buffers"


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    return {BUILD: host.build_lib(tmp_path_factory, BUILD)}


@pytest.mark.parametrize("build", [BUILD])
@pytest.mark.parametrize("i", range(len(host.CASES)), ids=host.CASE_IDS)
def test_slab_topk_source_on_the_host(libs, build, i):
    """Every phase-2 case at widths 512 and 4,097, the order kinds at both
    and the narrow widths: values and ids bit-equal to the plain version,
    two runs identical."""
    host.check_case(libs[build], i)


def test_ragged_block_of_launches_and_offsets(libs, monkeypatch):
    """kf past the shared sort buffer with scratch for 5 rows a launch: 17
    rows go in launches of 5, 5, 5 and 2, written into a chunk's columns
    of a wider buffer with the chunk's id offset."""
    lib = libs[BUILD]
    monkeypatch.setattr(ek, "TOPK_SCRATCH_BYTES", 8 * 512 * 5)
    x, kw = topk_inputs(17, 500, "bias", "random", 7, host.CPU)
    bufs = ek._chunk_buffers(17, 3, 500, torch.float32, host.CPU)
    for t in bufs:
        t.fill_(3)
    out, launches = ek._topk_run(lib, x, 500, None, None, kw["bias"], False,
                                 131_072, ek._cols(bufs, 1, 500), None)
    assert launches == 4
    want = ek.select_topk_plain(x, 500, bias=kw["bias"], offset=131_072)
    assert topk_same((bufs[0][:, 500:1000], bufs[1][:, 500:1000]), want)
    assert (bufs[1][:, :500] == 3).all() and (bufs[1][:, 1000:] == 3).all()


def test_the_c_entry_refuses_what_it_cannot_take(libs):
    """kf past W, a row stride below W, and a kf past the shared sort
    buffer without scratch are refused before any launch."""
    lib = libs[BUILD]
    x = torch.zeros((4, 300))
    v = torch.empty((4, 300))
    i = torch.empty((4, 300), dtype=torch.int64)
    args = lambda ldx, kf, scratch: (  # noqa: E731
        x.data_ptr(), 0, ldx, 4, 300, kf, None, None, None, v.data_ptr(), 0,
        i.data_ptr(), 300, 0, scratch, 512, 0, None)
    assert lib.cozo_slab_topk(*args(300, 301, None)) != 0
    assert lib.cozo_slab_topk(*args(299, 10, None)) != 0
    assert lib.cozo_slab_topk(*args(300, 300, None)) != 0
    assert lib.cozo_slab_topk_sort_cap() == 256
