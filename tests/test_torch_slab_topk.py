"""Parity of the port's per-chunk selection (`cozo_tpu_torch/ops/
exact_knn.py`: `select_topk`, its plain version `select_topk_plain` and
the key `slab_key`) with the JAX primitives it stands for: `lax.top_k` (the
JAX package's merges) and `lax.approx_max_k` (its per-chunk selection),
both on the CPU, where `approx_max_k` is exact.  The same seeded numpy
slabs go through both; the port runs on the CPU.

Tolerances: none for the selection.  Values and ids are bit-equal to
`lax.top_k` at every kf, `+0.0` above `-0.0` included, and to
`approx_max_k` for 1 < kf < W.  The stated exceptions at kf = 1 and kf = W
are `approx_max_k`'s own (below).  The prologues: the sweep's bias and the
i8 lane's bf16 key are bit-equal to the JAX expressions; where the last
multiply meets the add (the quant lane, the int8 build step), XLA on the
CPU fuses them into one FMA (checked bit-equal below), and the port's
separate passes round the product first: they agree within half an ulp of
that product.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cozo_tpu_torch.ops import exact_knn as ek
from cozo_tpu_torch.ops.exact_knn import (merge_chunks, order_key,
                                          select_topk, select_topk_plain,
                                          slab_key)

TIES = np.array([0.0, -0.0, 1.0, -1.0, 2.5, -2.5, -np.inf], np.float32)


def slab(kind, B, W, seed):
    """[B, W] f32: `ties` draws from TIES; `random` is normal with planted
    duplicates; rows 0 and 1 all -inf and all but 3 entries -inf."""
    rng = np.random.default_rng(seed)
    if kind == "ties":
        x = rng.choice(TIES, size=(B, W))
    else:
        x = rng.standard_normal((B, W)).astype(np.float32)
        dup = rng.integers(0, W, size=(B, W // 4))
        x[np.arange(B)[:, None], dup] = x[:, :1]  # many copies of x[:, 0]
    x[0] = -np.inf
    x[1] = -np.inf
    x[1, rng.choice(W, 3, replace=False)] = rng.standard_normal(3)
    return np.ascontiguousarray(x, np.float32)


def as_bits(v):
    return np.asarray(v, np.float32).view(np.int32)


W = 500
KFS = (1, 2, 10, 26, 40, 97, 256, 499, 500)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("kind", ["ties", "random"])
@pytest.mark.parametrize("kf", KFS)
def test_plain_equals_lax_top_k(dtype, kind, kf):
    """Values and ids bit-equal to `lax.top_k`, ties and `+-0.0`
    included, f32 and bf16 keys."""
    x = slab(kind, 64, W, kf)
    xj = jnp.asarray(x)
    xt = torch.from_numpy(x)
    if dtype == "bf16":
        xj, xt = xj.astype(jnp.bfloat16), xt.to(torch.bfloat16)
    v, i = jax.lax.top_k(xj, kf)
    pv, pi = select_topk_plain(xt, kf)
    assert pv.dtype == xt.dtype and pi.dtype == torch.int64
    assert np.array_equal(as_bits(np.asarray(v, np.float32)),
                          as_bits(pv.float().numpy()))
    assert np.array_equal(np.asarray(i), pi.numpy())


@pytest.mark.parametrize("kind", ["ties", "random"])
def test_plain_is_the_stable_sort_of_the_order_key_cut_to_kf(kind):
    """The plain version's definition: `torch.sort(order_key(key),
    descending=True, stable=True)` cut to kf, at every kf."""
    x = torch.from_numpy(slab(kind, 32, W, 9))
    _, pos = torch.sort(order_key(x), dim=1, descending=True, stable=True)
    for kf in KFS:
        pv, pi = select_topk_plain(x, kf)
        assert torch.equal(pi, pos[:, :kf])
        assert torch.equal(pv, torch.gather(x, 1, pos[:, :kf]))


def test_plain_orders_plus_zero_above_minus_zero():
    """`lax.top_k(x, 2)` on [-0.0, 0.0, -0.0, 0.0] gives ids [1, 3]; a
    float sort would give [0, 1]."""
    x = np.array([[-0.0, 0.0, -0.0, 0.0]], np.float32)
    _, i = jax.lax.top_k(jnp.asarray(x), 2)
    _, pi = select_topk_plain(torch.from_numpy(x), 2)
    assert np.asarray(i).tolist() == pi.tolist() == [[1, 3]]
    _, float_sort = torch.sort(torch.from_numpy(x), dim=1, descending=True,
                               stable=True)
    assert float_sort[:, :2].tolist() == [[0, 1]]


def test_order_key_orders_as_lax_top_k():
    """The int32 key ranks every f32 as `lax.top_k` does: a descending
    stable sort of the keys is `lax.top_k` at the full width."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((8, 300)).astype(np.float32)
    x[:, ::7] = rng.choice(TIES, size=(8, len(range(0, 300, 7))))
    x[:, 5] = np.finfo(np.float32).max
    x[:, 6] = -np.finfo(np.float32).max
    x[:, 7] = np.finfo(np.float32).tiny / 4  # a subnormal
    _, i = jax.lax.top_k(jnp.asarray(x), 300)
    _, pos = torch.sort(order_key(torch.from_numpy(x)), dim=1,
                        descending=True, stable=True)
    assert np.array_equal(np.asarray(i), pos.numpy())


@pytest.mark.parametrize("kind", ["ties", "random"])
@pytest.mark.parametrize("kf", KFS)
def test_plain_against_approx_max_k(kind, kf):
    """`lax.approx_max_k(..., aggregate_to_topk=True)` on the CPU: values
    and ids bit-equal for 1 < kf < W.  Stated exceptions, both JAX's:
    at kf = 1 it compares as IEEE floats (+-0.0 equal) and takes the
    HIGHER position among the maxima; at kf = W it sorts the row as IEEE
    floats with no tie order (neither ascending nor descending position),
    so there the values are equal as floats and each run of equal values
    holds the same ids."""
    x = slab(kind, 64, W, 100 + kf)
    av, ai = map(np.asarray, jax.lax.approx_max_k(jnp.asarray(x), kf,
                                                  aggregate_to_topk=True))
    pv, pi = select_topk_plain(torch.from_numpy(x), kf)
    pv, pi = pv.numpy(), pi.numpy()
    if 1 < kf < W:
        assert np.array_equal(as_bits(av), as_bits(pv))
        assert np.array_equal(ai, pi)
    elif kf == 1:
        assert np.array_equal(av, pv)  # float equality: -0.0 == 0.0
        ieee = x + np.float32(0.0)  # -0.0 -> +0.0
        top = ieee.max(axis=1, keepdims=True)
        highest = W - 1 - np.argmax((ieee == top)[:, ::-1], axis=1)
        assert np.array_equal(ai[:, 0], highest)
    else:
        assert np.array_equal(av, pv)
        for b in range(x.shape[0]):
            for val in np.unique(pv[b]):
                assert (set(ai[b][av[b] == val].tolist())
                        == set(pi[b][pv[b] == val].tolist()))


def test_approx_max_k_exceptions_are_real():
    """The exceptions above are JAX's behaviour, not a test's slack: on
    [1, 3, 3, 2, 3, 0, 3, 1] kf = 1 gives id 6, `lax.top_k` and the port
    id 1; at kf = 3 all three give [1, 2, 4]."""
    y = np.array([[1, 3, 3, 2, 3, 0, 3, 1]], np.float32)
    assert np.asarray(jax.lax.approx_max_k(jnp.asarray(y), 1)[1]).tolist() \
        == [[6]]
    assert np.asarray(jax.lax.top_k(jnp.asarray(y), 1)[1]).tolist() == [[1]]
    assert select_topk_plain(torch.from_numpy(y), 1)[1].tolist() == [[1]]
    for ids in (jax.lax.approx_max_k(jnp.asarray(y), 3)[1],
                jax.lax.top_k(jnp.asarray(y), 3)[1],
                select_topk_plain(torch.from_numpy(y), 3)[1]):
        assert np.asarray(ids).tolist() == [[1, 2, 4]]


# -- the prologues, each held to the JAX expression it stands for ---------------


def _products(seed, B=64, n=512, d=48):
    rng = np.random.default_rng(seed)
    s32 = rng.integers(-127 * 127 * d, 127 * 127 * d, size=(B, n)).astype(
        np.int32)
    cs = (rng.random(n) * 0.01).astype(np.float32)
    q = (rng.random(B) * 0.01).astype(np.float32)
    cb = (-rng.random(n)).astype(np.float32)
    cb[::9] = -np.inf  # dead rows
    return s32, cs, q, cb


def test_sweep_bias_prologue_bit_equal():
    """`_sweep_fn` / `_build_step_fn`: dot + chunk_b[None, :]."""
    rng = np.random.default_rng(5)
    s = rng.standard_normal((64, 512)).astype(np.float32)
    b = (-rng.random(512)).astype(np.float32)
    b[::7] = -np.inf
    want = np.asarray(jax.jit(lambda s, b: s + b[None, :])(s, b))
    got = slab_key(torch.from_numpy(s), bias=torch.from_numpy(b)).numpy()
    assert np.array_equal(as_bits(want), as_bits(got))


def test_i8_sweep_prologue_bit_equal():
    """`_sweep_fn_i8` (cozo_tpu/ops/exact_knn.py:205-208): (s32 * cs * q +
    cb).astype(bf16) is bit-equal: the bf16 rounding absorbs the FMA's
    one-rounding difference on these inputs."""
    s32, cs, q, cb = _products(6)
    want = np.asarray(jax.jit(
        lambda s, cs, q, cb: (s.astype(jnp.float32) * cs[None, :]
                              * q[:, None] + cb[None, :]).astype(jnp.bfloat16)
    )(s32, cs, q, cb)).astype(np.float32)
    got = slab_key(torch.from_numpy(s32), torch.from_numpy(cs),
                   torch.from_numpy(q), torch.from_numpy(cb),
                   bf16=True).float().numpy()
    assert np.array_equal(as_bits(want), as_bits(got))


def _fma_tolerance(prod):
    """Half an ulp of the f32 product: the one rounding the port's separate
    passes make and XLA's FMA does not."""
    return np.spacing(np.abs(prod).astype(np.float32)) * 0.5


def test_quant_prologue_within_one_rounding_of_xla():
    """`_qsweep_fn` (cozo_tpu/ops/quant_knn.py:84-87): XLA on the CPU
    computes (s32 * cs) * q + cb with the last multiply and the add fused
    (one FMA: bit-equal to the f64 emulation below); the port rounds the
    product first.  The two agree within half an ulp of the product, and
    exactly on the dead rows."""
    s32, cs, q, cb = _products(7)
    want = np.asarray(jax.jit(
        lambda s, cs, q, cb: s.astype(jnp.float32) * cs[None, :] * q[:, None]
        + cb[None, :])(s32, cs, q, cb))
    sc = s32.astype(np.float32) * cs[None, :]
    fma = (sc.astype(np.float64) * q[:, None] + cb[None, :]).astype(np.float32)
    assert np.array_equal(as_bits(want), as_bits(fma))
    got = slab_key(torch.from_numpy(s32), torch.from_numpy(cs),
                   torch.from_numpy(q), torch.from_numpy(cb)).numpy()
    prod = sc * q[:, None]
    assert np.array_equal(as_bits(got), as_bits(prod + cb[None, :]))
    live = np.isfinite(want)
    assert np.array_equal(live, np.isfinite(got))
    assert (np.abs(got[live] - want[live]) <= _fma_tolerance(prod)[live]
            + np.spacing(np.abs(want[live]))).all()


def test_i8_build_prologue_within_one_rounding_of_xla():
    """`_build_step_fn_i8` (cozo_tpu/ops/bulk_build.py:261-265): dot * csc
    + cb, XLA's FMA against the port's two passes, as above."""
    rng = np.random.default_rng(8)
    s = rng.standard_normal((64, 512)).astype(np.float32)
    _, cs, _, cb = _products(8)
    want = np.asarray(jax.jit(lambda s, c, b: s * c[None, :] + b[None, :])(
        s, cs, cb))
    fma = (s.astype(np.float64) * cs[None, :] + cb[None, :]).astype(
        np.float32)
    assert np.array_equal(as_bits(want), as_bits(fma))
    got = slab_key(torch.from_numpy(s), torch.from_numpy(cs), None,
                   torch.from_numpy(cb)).numpy()
    prod = s * cs[None, :]
    live = np.isfinite(want)
    assert np.array_equal(live, np.isfinite(got))
    assert (np.abs(got[live] - want[live]) <= _fma_tolerance(prod)[live]
            + np.spacing(np.abs(want[live]))).all()


# -- the wrapper on the CPU ------------------------------------------------------


@pytest.mark.parametrize("bf16", [False, True])
def test_wrapper_writes_a_chunks_columns_of_the_merge_buffer(bf16):
    """`out=` views of a chunk's columns get the plain version's values and
    ids + offset; the other columns stay; no launch is counted."""
    s32, cs, q, cb = _products(9, B=17, n=1024)
    x, c, r, b = map(torch.from_numpy, (s32, cs, q, cb))
    kc, n_chunks = 26, 3
    bufs = ek._chunk_buffers(17, n_chunks, kc,
                             torch.bfloat16 if bf16 else torch.float32,
                             torch.device("cpu"))
    for t in bufs:
        t.fill_(7)
    before = select_topk.launches
    select_topk(x, kc, col_scale=c, row_scale=r, bias=b, bf16=bf16,
                offset=2048, out=ek._cols(bufs, 1, kc))
    assert select_topk.launches == before
    pv, pi = select_topk_plain(x, kc, c, r, b, bf16)
    assert torch.equal(bufs[0][:, kc:2 * kc], pv)
    assert torch.equal(bufs[1][:, kc:2 * kc], pi + 2048)
    assert (bufs[1][:, :kc] == 7).all() and (bufs[1][:, 2 * kc:] == 7).all()


def test_merge_chunks_breaks_ties_by_chunk_order():
    """Equal scores in two chunks: the lower chunk's (the lower global id)
    comes first, as the JAX merge's `lax.top_k` keeps it."""
    alld = torch.tensor([[3.0, 1.0, 3.0, 2.0]])
    alli = torch.tensor([[5, 9, 131077, 131080]])
    bs, bi = merge_chunks(alld, alli, 3)
    assert bs.tolist() == [[3.0, 3.0, 2.0]]
    assert bi.tolist() == [[5, 131077, 131080]]


@pytest.mark.parametrize("bad", ["kf0", "kf_wide", "dtype", "bias_len",
                                 "out_shape", "bf16_prologue"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    x = torch.zeros((4, 16))
    kw = {"kf": 3}
    if bad == "kf0":
        kw["kf"] = 0
    elif bad == "kf_wide":
        kw["kf"] = 17
    elif bad == "dtype":
        x = torch.zeros((4, 16), dtype=torch.float64)
    elif bad == "bias_len":
        kw["bias"] = torch.zeros(15)
    elif bad == "out_shape":
        kw["out"] = (torch.zeros((4, 2)), torch.zeros((4, 2), dtype=torch.int64))
    else:
        x = x.to(torch.bfloat16)
        kw["bias"] = torch.zeros(16)
    with pytest.raises((ValueError, TypeError)):
        select_topk(x, **kw)
