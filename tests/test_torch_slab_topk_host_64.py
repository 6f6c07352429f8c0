"""The CUDA source of the per-chunk selection (`cozo_tpu_torch/csrc/
slab_topk.cu`), run on the CPU in its build with two warps a block and
the card's buffers, and held against `select_topk_plain`: how, and what
the cases are, in `tests/_torch_slab_topk_host.py`, which the three
builds' files share.
"""

import pytest

from tests import _torch_slab_topk_host as host

BUILD = "64 threads, 2,048-entry buffers"


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
