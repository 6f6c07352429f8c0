"""The selection half of the chunk step (`cozo_tpu_torch/csrc/
sweep_select.cuh`) on the CPU, row state "head 128": kc 65, 97 (the build's) and 128: a sorted head of 128 and a
tail of 128 appends in shared memory.  Held against `select_topk_plain` bit for bit;
how, and what the cases are, in `tests/_torch_sweep_select_host.py`,
which the four row states' files share.  A second build merges past 16
appends (`-DCOZO_SWEEP_HEAD_HIGH=16`): a tail of 80, so the tail's sort
runs over a length that is not a power of two, and merges come often.
"""

import pytest

from tests import _torch_sweep_select_host as host

MODE = host.MODES["head 128"]


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    return host.build_lib(tmp_path_factory, MODE)


@pytest.fixture(scope="module")
def lib_high16(tmp_path_factory):
    return host.build_lib(tmp_path_factory, MODE,
                          ("-DCOZO_SWEEP_HEAD_HIGH=16",))


@pytest.mark.parametrize("i", range(len(host.cases(MODE))),
                         ids=host.case_ids(MODE))
def test_sweep_select_on_the_host(lib, i):
    """Every kc of the row state, both kinds, every variant: values and ids
    bit-equal to the plain version."""
    host.check_case(lib, MODE, i)


@pytest.mark.parametrize("i", range(len(host.cases(MODE))),
                         ids=host.case_ids(MODE))
def test_sweep_select_on_the_host_with_tails_of_80(lib_high16, i):
    """The same cases through a build that merges past 16 appends: values
    and ids bit-equal to the plain version."""
    host.check_case(lib_high16, MODE, i)


@pytest.fixture(scope="module")
def lib_wide(tmp_path_factory):
    return host.build_wide(tmp_path_factory, MODE)


@pytest.mark.parametrize("i", range(len(host.cases(MODE, wide=True))),
                         ids=host.case_ids(MODE, wide=True))
def test_sweep_select_on_the_host_wide(lib_wide, i):
    """The wide kernel's configuration of the row state (one consumer of
    64 rows), every case and sums past 2^22: values and ids bit-equal to
    the plain version."""
    host.check_case(lib_wide, MODE, i, wide=True)


@pytest.fixture(scope="module")
def lib_wide2(tmp_path_factory):
    return host.build_wide(tmp_path_factory, MODE, consumers=2)


@pytest.mark.parametrize("i", range(len(host.cases(MODE, wide=True))),
                         ids=host.case_ids(MODE, wide=True))
def test_sweep_select_on_the_host_wide_two_consumers(lib_wide2, i):
    """The wide configuration with two consumers on the block's 64 rows,
    selecting the piece's groups of tiles in turns (groups of 1, 2 or 8
    tiles by case): values and ids bit-equal to the plain version."""
    host.check_case(lib_wide2, MODE, i, wide=True,
                    group=host.GROUPS[i % len(host.GROUPS)])
