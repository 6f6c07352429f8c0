"""The f32 chunk step's block loop (`cozo_tpu_torch/csrc/sweep_f32.cuh`:
the FFMA product on register fragments fed from shared memory, the
K-slices of the table and, past d_pad 128, of the query rows, the ring's
steps, and the selection of `sweep_select.cuh` on each finished tile) on
the CPU, compiled with g++ against the stand-in CUDA runtime of
`tests/_torch_sweep_select_host.py` (the threads of a block as fibers;
plain copies where the card has `cp.async`).  Row states "lists of 8" (kc
1, 10, 26, 32; two fragments a thread) and "lists of 16" (kc 33, 64; one);
the heads are `test_torch_sweep_select_host_f32_heads.py`.

Inputs of small integers, so every f32 sum is exact in any order, at
d_pad 16, 48, 128 (query rows resident), 144, 256, 1,536 and 4,096
(streamed), B 70 and 130, two pieces of 512 rows, every variant (ties, +-0.0, dead columns,
rising keys), the chains over d_pad or stopped at the real width.  Tolerance: none; values and ids bit-equal to
`exact_knn.sweep_topk_plain`.  What this cannot show: `cp.async`'s timing,
races only real warps hit, the card's rounding of chains whose sums are
not exact (`tests/test_torch_cuda.py`, `chip_smoke.py` phase 2), any time.
"""

import pytest

from tests import _torch_sweep_select_host as host

LISTS8 = host.MODES["lists of 8"]
LISTS16 = host.MODES["lists of 16"]


@pytest.fixture(scope="module")
def lib8(tmp_path_factory):
    return host.build_f32(tmp_path_factory, LISTS8)


@pytest.fixture(scope="module")
def lib16(tmp_path_factory):
    return host.build_f32(tmp_path_factory, LISTS16)


def test_the_blocks_are_the_ones_the_source_describes(lib8, lib16):
    """(threads, rows, fragments a thread, stages, resident): 128 rows a
    block for the lists, two fragments a thread for the lists of 8 and one
    for the lists of 16; the query rows resident to d_pad 128, streamed
    past it to the widest, 4,096, with the same ring."""
    assert host.f32_shape(lib8, 128) == (128, 128, 2, 4, 1)
    assert host.f32_shape(lib8, 144)[2:] == (2, 4, 0)
    assert host.f32_shape(lib8, 4096)[2:] == (2, 4, 0)
    assert host.f32_shape(lib16, 1024)[:3] == (256, 128, 1)
    assert host.f32_shape(lib16, 4096)[2:] == (1, 4, 0)
    # both widths of the last K-slice, chains stopped short, and 1,536 and
    # 4,096 over d_pad and stopped short, are cases
    cases = host.f32_cases(LISTS8)
    assert {d % 32 for _, _, d, _, _ in cases} == {0, 16}
    assert {r > 0 for *_, r in cases} == {False, True}
    assert {(d, r > 0) for _, _, d, _, r in cases if d > 1024} == {
        (1536, False), (1536, True), (4096, False), (4096, True)}


@pytest.mark.parametrize("i", range(len(host.f32_cases(LISTS8))),
                         ids=host.f32_case_ids(LISTS8))
def test_f32_step_lists_of_8(lib8, i):
    host.check_f32_case(lib8, LISTS8, i)


@pytest.mark.parametrize("i", range(len(host.f32_cases(LISTS16))),
                         ids=host.f32_case_ids(LISTS16))
def test_f32_step_lists_of_16(lib16, i):
    host.check_f32_case(lib16, LISTS16, i)
