"""The f32 chunk step's block loop (`cozo_tpu_torch/csrc/sweep_f32.cuh`:
the FFMA product on register micro-tiles fed from shared memory, the
K-slices of the table and, past d_pad 128, of the query rows, the ring's
steps, the hand-off through the staging slots, and the selection of
`sweep_select.cuh` on each finished tile) on the CPU, compiled with g++
against the stand-in CUDA runtime of `tests/_torch_sweep_select_host.py`
(the consumer and selecting warpgroups as fibers; `mbarrier`s that yield
and plain copies of the TMA boxes).  Row states "lists of 8" (kc 1, 10,
26, 32) and "lists of 16" (kc 33, 64), two consumer warpgroups each; the
heads are `test_torch_sweep_select_host_f32_heads.py`.

Inputs of small integers, so every f32 sum is exact in any order, at
d_pad 16, 48, 128 (query rows resident), 144, 256, 1,536 and 4,096
(streamed), B 70 and 130, two pieces of 512 rows, every variant (ties,
+-0.0, dead columns, rising keys), the chains over d_pad or stopped at the
real width; then the tile's edges (pieces of 256, B 1, 64, 65 and 129,
real widths that end inside a slice).  Tolerance: none; values and ids
bit-equal to `exact_knn.sweep_topk_plain`.  What this cannot show: TMA's
and the barriers' timing, races only real warps hit, the card's rounding
of chains whose sums are not exact (`tests/test_torch_cuda.py`,
`chip_smoke.py` phase 2), any time.
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
    """(threads, rows, columns a tile, columns a micro-tile, floats a
    K-slice, stages, resident, staged selection tiles): 64 query rows a
    block, two consumer warpgroups of 8 x 8 micro-tiles on tiles of 256
    columns and the selecting warpgroup; slices of 32 floats, the query
    rows resident to d_pad 128 and streamed past it to the widest, 4,096;
    the lists of 8 four stages and two staged selection tiles, the lists
    of 16 three stages and two or three tiles beside their tails."""
    assert host.f32_shape(lib8, 128) == (384, 64, 256, 8, 32, 4, 1, 2)
    assert host.f32_shape(lib8, 144) == (384, 64, 256, 8, 32, 4, 0, 2)
    assert host.f32_shape(lib8, 4096) == (384, 64, 256, 8, 32, 4, 0, 2)
    assert host.f32_shape(lib16, 128) == (384, 64, 256, 8, 32, 3, 1, 2)
    assert host.f32_shape(lib16, 4096) == (384, 64, 256, 8, 32, 3, 0, 3)
    # both widths of the last K-slice, chains stopped short, and 1,536 and
    # 4,096 over d_pad and stopped short, are cases; so are pieces of 256
    # (one tile of 256 columns, two of 128), B a whole block and one row,
    # and real widths that end inside a slice
    cases = host.f32_cases(LISTS8)
    assert {d % 32 for _, _, d, _, _, _ in cases} == {0, 16}
    assert {r > 0 for *_, r, _ in cases} == {False, True}
    assert {(d, r > 0) for _, _, d, _, r, _ in cases if d > 1024} == {
        (1536, False), (1536, True), (4096, False), (4096, True)}
    assert {p for *_, p in cases} == {256, 512}
    assert {B % 64 for _, _, _, B, _, _ in cases} >= {0, 1}
    assert {r % 32 for *_, r, _ in cases if r} >= {4, 5, 28}


@pytest.mark.parametrize("i", range(len(host.f32_cases(LISTS8))),
                         ids=host.f32_case_ids(LISTS8))
def test_f32_step_lists_of_8(lib8, i):
    host.check_f32_case(lib8, LISTS8, i)


@pytest.mark.parametrize("i", range(len(host.f32_cases(LISTS16))),
                         ids=host.f32_case_ids(LISTS16))
def test_f32_step_lists_of_16(lib16, i):
    host.check_f32_case(lib16, LISTS16, i)
