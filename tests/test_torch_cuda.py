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

from cozo_tpu_torch import HnswIndex, sweep_search
from cozo_tpu_torch.ops import fused_sweep as fs


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA is not available)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("B,n_total,d_pad,dead", [
    (512, 16_384, 128, 100), (77, 4_096, 48, 0), (700, 131_072, 768, 3)])
def test_kernel_matches_plain(cuda, B, n_total, d_pad, dead):
    g = torch.Generator(device=cuda).manual_seed(B)
    tbl = torch.randn(n_total, d_pad, generator=g, device=cuda).bfloat16()
    qs = torch.randn(B, d_pad, generator=g, device=cuda).bfloat16()
    bias = torch.zeros(n_total, device=cuda)
    bias[n_total - dead:] = fs.NEG_FILL
    before = fs.fused_sweep.launches
    out = fs.fused_sweep(qs, tbl, bias)
    assert fs.fused_sweep.launches == before + 1
    ref = fs.fused_sweep_plain(qs, tbl, bias)
    torch.cuda.synchronize()
    assert out.shape == (B, 2 * n_total // fs.SEG)
    close = torch.isclose(out, ref, rtol=1e-6, atol=1e-6).float().mean()
    assert float(close) >= 0.99


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
