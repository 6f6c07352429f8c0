"""Tests of the port that need an NVIDIA card (marker `cuda`): the CUDA
kernel against its plain PyTorch version, and the fused lane end to end
through the kernel.  They skip where CUDA is absent.  This file imports
neither JAX nor `cozo_tpu`, so it runs on a machine that has only the
port's dependencies:

    python -m pytest tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from chip_smoke import PHASE2_SHAPES as SHAPES
from chip_smoke import agreement_ok, compare_fused, random_case
from cozo_tpu_torch import HnswIndex, sweep_search
from cozo_tpu_torch.ops import fused_sweep as fs


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA is not available)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("B,n_total,d_pad,dead", SHAPES)
def test_kernel_matches_plain(cuda, B, n_total, d_pad, dead):
    """At every shape `chip_smoke.py` phase 2 holds the kernel to, and by
    its measure: the ids carried in the packed output agree with the plain
    version's on >= 99.9% of entries (a last-bit difference of a sum may
    cross one 2^-15 packing quantum), no dead row is live; besides, the
    values are close on >= 99% and two runs are bit-identical."""
    qs, tbl, bias = random_case(B, n_total, d_pad, dead, cuda, seed=B)
    before = fs.fused_sweep.launches
    out = fs.fused_sweep(qs, tbl, bias)
    again = fs.fused_sweep(qs, tbl, bias)
    assert fs.fused_sweep.launches == before + 2
    ref = fs.fused_sweep_plain(qs, tbl, bias)
    torch.cuda.synchronize()
    assert out.shape == (B, 2 * n_total // fs.SEG)
    assert torch.equal(out, again)
    c = compare_fused(out, ref, n_total, dead)
    assert agreement_ok(c), c
    assert c["isclose"] >= 0.99


@pytest.mark.cuda
@pytest.mark.parametrize("B,n_total,d_pad,dead", [SHAPES[2], SHAPES[4],
                                                  SHAPES[6], SHAPES[8]])
def test_launch_counts_the_route_the_shape_selects(cuda, B, n_total, d_pad,
                                                   dead):
    qs, tbl, bias = random_case(B, n_total, d_pad, dead, cuda)
    before = dict(fs.fused_sweep.route_launches)
    fs.fused_sweep(qs, tbl, bias)
    torch.cuda.synchronize()
    took = fs.route(B, n_total, d_pad)
    for r in fs.ROUTES:
        assert fs.fused_sweep.route_launches[r] == before[r] + (r == took)


@pytest.mark.cuda
def test_kernel_rejects_bad_shapes(cuda):
    qs = torch.zeros(4, 120, dtype=torch.bfloat16, device=cuda)
    tbl = torch.zeros(512, 120, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError):
        fs.fused_sweep(qs, tbl, torch.zeros(512, device=cuda))


@pytest.mark.cuda
def test_fused_lane_goes_through_the_kernel(cuda):
    rng = np.random.default_rng(1)
    data = rng.standard_normal((20_000, 64)).astype(np.float32)
    idx = HnswIndex(dim=64, m=8, ef_construction=50, distance="Cosine")
    idx.bulk_build(data, wave=4096)
    qs = data[:256] + 0.01 * rng.standard_normal((256, 64)).astype(np.float32)
    before = fs.fused_sweep.launches
    ids_f, _ = sweep_search(idx, qs, 10, compute_dtype="fused")
    assert fs.fused_sweep.launches == before + 1
    ids_b, _ = sweep_search(idx, qs, 10, compute_dtype="f32", rt=1.0)
    assert float(np.mean(ids_f[:, 0] == np.arange(256))) > 0.99
    overlap = np.mean([len(set(ids_f[i]) & set(ids_b[i])) / 10
                       for i in range(256)])
    assert overlap > 0.98
