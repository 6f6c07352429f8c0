"""Parity of the port's fused sweep (`cozo_tpu_torch/ops/fused_sweep.py`)
with the JAX package's Pallas kernel (`cozo_tpu/ops/pallas_sweep.py`),
which runs here in interpret mode.  On the CPU the port's wrapper runs
its plain PyTorch version; the CUDA kernel itself is held against that
plain version on the card (tests/test_torch_cuda.py, chip_smoke.py)."""

import numpy as np
import pytest
import torch

import cozo_tpu.ops.pallas_sweep as ps
from cozo_tpu_torch.ops import fused_sweep as fs


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    """Run pallas_call in interpreter mode (CPU backend has no Mosaic)."""
    from jax.experimental import pallas as pl

    orig = pl.pallas_call

    def patched(*a, **kw):
        kw["interpret"] = True
        return orig(*a, **kw)

    monkeypatch.setattr(pl, "pallas_call", patched)
    ps._FUSED_FNS.clear()
    ps._SERVE_FNS.clear()
    yield
    ps._FUSED_FNS.clear()
    ps._SERVE_FNS.clear()


def _mk(n_total=16384, B=512, d=128, seed=0, dead=100):
    rng = np.random.default_rng(seed)
    tbl = rng.normal(size=(n_total, d)).astype(np.float32)
    bias = np.zeros(n_total, dtype=np.float32)
    if dead:
        bias[n_total - dead:] = fs.NEG_FILL
    qs = rng.normal(size=(B, d)).astype(np.float32)
    return tbl, bias, qs


def _bf16(x):
    return torch.from_numpy(x).to(torch.bfloat16)


def _ids(packed):
    col = packed.view(np.int32) & (fs.SEG - 1)
    return ((np.arange(packed.shape[1]) >> 1) * fs.SEG)[None, :] + col


def test_constants_match_jax():
    assert fs.SEG == ps.SEG and fs.NEG_FILL == ps.NEG_FILL


def test_plain_matches_jax_pallas_kernel():
    """n=16,384, B=512, d=128, 100 dead rows: the bar of
    tests/test_pallas_sweep.py (isclose 1e-6 on >= 99% of entries)."""
    import jax.numpy as jnp

    tbl, bias, qs = _mk()
    n_total, B = tbl.shape[0], qs.shape[0]
    out_j = np.asarray(ps._fused_fn(n_total, B)(
        jnp.asarray(tbl, dtype=jnp.bfloat16),
        jnp.asarray(bias.reshape(1, -1)),
        jnp.asarray(qs, dtype=jnp.bfloat16),
    ))
    before = fs.fused_sweep.launches
    out_t = fs.fused_sweep(_bf16(qs), _bf16(tbl), torch.from_numpy(bias))
    assert fs.fused_sweep.launches == before  # CPU: plain version, no launch
    out_t = out_t.numpy()
    assert out_t.shape == out_j.shape == (B, 2 * n_total // fs.SEG)
    assert np.isclose(out_t, out_j, rtol=1e-6, atol=1e-6).mean() > 0.99
    assert (_ids(out_t) == _ids(out_j)).mean() > 0.999
    # dead rows never surface
    assert not (_ids(out_t) >= n_total - 100).any()


def test_plain_matches_numpy_reference_d256():
    """A contraction the TPU kernel does not take (d_pad=256) against
    the JAX package's numpy reference."""
    tbl, bias, qs = _mk(n_total=4096, B=96, d=256, seed=3, dead=40)
    tb, qb = _bf16(tbl), _bf16(qs)
    out = fs.fused_sweep(qb, tb, torch.from_numpy(bias)).numpy()
    ref = ps.fused_ref_numpy(tb.float().numpy(), bias, qb.float().numpy())
    assert out.shape == ref.shape == (96, 2 * 4096 // fs.SEG)
    assert np.isclose(out, ref, rtol=1e-6, atol=1e-6).mean() > 0.99
    assert (_ids(out) == _ids(ref)).mean() > 0.999


def test_serve_matches_jax_serve_fn_unpadded_batch():
    """B=700 (not a multiple of the TPU's 512-row tile), IP metric:
    recall against exact top-k > 0.99 in both packages, and the re-ranked
    scores are exact f32 similarities."""
    import jax.numpy as jnp

    tbl, bias, qs = _mk(B=700, dead=0)
    n_total, B, k = tbl.shape[0], qs.shape[0], 10
    exact = qs @ tbl.T
    gt = np.argsort(-exact, axis=1)[:, :k]

    B_pad = ((B + ps.B_TILE - 1) // ps.B_TILE) * ps.B_TILE
    fn = ps._serve_fn(n_total, B_pad, k, 26, "IP", 128, 1, n_total, 128)
    tf_j, bf_j = ps._prep_fn(1, n_total, 128)(
        jnp.asarray(tbl.reshape(1, n_total, 128)),
        jnp.asarray(bias.reshape(1, n_total)),
    )
    packed_j = np.asarray(fn(tf_j, bf_j, jnp.asarray(
        tbl.reshape(1, n_total, 128)), jnp.asarray(qs)))

    t32 = torch.from_numpy(tbl.reshape(1, n_total, 128))
    tf_t, bf_t = fs.prep(t32, torch.from_numpy(bias.reshape(1, n_total)))
    packed_t = fs.serve(tf_t, bf_t, t32, torch.from_numpy(qs), k, 26, "IP",
                        128, 128).numpy()

    for packed in (packed_j, packed_t):
        assert packed.shape == (B, 2 * k)
        ids = packed[:, :k]
        hits = sum(len(set(ids[i]) & set(gt[i])) for i in range(B)) / (B * k)
        assert hits > 0.99, hits
        sc = packed[:, k:].copy().view(np.float32)
        best = np.take_along_axis(exact, ids.astype(np.int64), axis=1)
        assert np.allclose(sc, best, rtol=1e-5, atol=1e-5)
    assert (packed_t[:, :k] == packed_j[:, :k]).mean() > 0.999


def test_prep_maps_dead_rows_to_finite_fill():
    import jax.numpy as jnp

    rng = np.random.default_rng(5)
    tbl = rng.normal(size=(1, 512, 128)).astype(np.float32)
    bias = np.zeros((1, 512), np.float32)
    bias[0, ::7] = -np.inf
    tf_j, bf_j = ps._prep_fn(1, 512, 128)(jnp.asarray(tbl), jnp.asarray(bias))
    tf_t, bf_t = fs.prep(torch.from_numpy(tbl), torch.from_numpy(bias))
    assert np.array_equal(bf_t.numpy(), np.asarray(bf_j).reshape(-1))
    assert np.array_equal(tf_t.float().numpy(),
                          np.asarray(tf_j.astype(jnp.float32)))


@pytest.mark.parametrize("bad", ["d_pad", "n_total", "dtype", "bias"])
def test_wrapper_rejects_what_the_kernel_cannot_take(bad):
    qs = torch.zeros(4, 128, dtype=torch.bfloat16)
    tbl = torch.zeros(512, 128, dtype=torch.bfloat16)
    bias = torch.zeros(512)
    if bad == "d_pad":
        qs, tbl = qs[:, :120].contiguous(), tbl[:, :120].contiguous()
    elif bad == "n_total":
        tbl, bias = tbl[:500].contiguous(), bias[:500].contiguous()
    elif bad == "dtype":
        qs = qs.float()
    else:
        bias = bias[:256]
    with pytest.raises((ValueError, TypeError)):
        fs.fused_sweep(qs, tbl, bias)
