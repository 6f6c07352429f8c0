"""The f32 chunk step's block loop (`cozo_tpu_torch/csrc/sweep_f32.cuh`)
on the CPU for the heads' row states: "head 128" (kc 65, 97, 128) and
"head 256" (kc 256), 64 query rows a block, four or two consumer
warpgroups beside the selecting one.  How,
the cases and the tolerance (none: bit-equal to
`exact_knn.sweep_topk_plain`): `tests/test_torch_sweep_select_host_f32.py`
and `tests/_torch_sweep_select_host.py`.
"""

import pytest

from tests import _torch_sweep_select_host as host

HEAD128 = host.MODES["head 128"]
HEAD256 = host.MODES["head 256"]


@pytest.fixture(scope="module")
def lib128(tmp_path_factory):
    return host.build_f32(tmp_path_factory, HEAD128)


@pytest.fixture(scope="module")
def lib256(tmp_path_factory):
    return host.build_f32(tmp_path_factory, HEAD256)


def test_the_heads_blocks_fit(lib128, lib256):
    """64 rows, 8 x 4 micro-tiles on slices of 16, the query rows
    streamed; head 128 four consumer warpgroups (16 warps, four a
    scheduler, on tiles of 256 columns) beside its one selecting
    warpgroup, head 256 two (128 columns); at every width, the kernel's
    widest (4,096) too, a ring of three stages and one staged selection
    tile beside the heads and tails."""
    for d in (128, 1024, 4096):
        assert host.f32_shape(lib128, d) == (640, 64, 256, 4, 16, 3, 0, 1)
        assert host.f32_shape(lib256, d) == (384, 64, 128, 4, 16, 3, 0, 1)


@pytest.mark.parametrize("i", range(len(host.f32_cases(HEAD128))),
                         ids=host.f32_case_ids(HEAD128))
def test_f32_step_head_128(lib128, i):
    host.check_f32_case(lib128, HEAD128, i)


@pytest.mark.parametrize("i", range(len(host.f32_cases(HEAD256))),
                         ids=host.f32_case_ids(HEAD256))
def test_f32_step_head_256(lib256, i):
    host.check_f32_case(lib256, HEAD256, i)
