"""Query preparation on the device (`cozo_tpu_torch/utils/device.
prepare_queries`) against the numpy code it replaced in
`SweepTable.search` and `QuantSweepTable.quantize_queries` (the JAX
package's host code: normalise, f16 cast, max-abs int8 quantisation)."""

import numpy as np
import pytest
import torch

from cozo_tpu.ops.quant_knn import QuantSweepTable as JaxQuantTable
from cozo_tpu_torch.utils.device import int_mm, prepare_queries, quantize_i8


def numpy_prep(q, metric, half):
    """The host code of the JAX package's `SweepTable.search`."""
    q = np.asarray(q, dtype=np.float32)
    qdt = np.float16 if half else np.float32
    if half and metric != "Cosine":
        amax = float(np.max(np.abs(q))) if q.size else 0.0
        if not (amax < 6.0e4):
            qdt = np.float32
    qp = np.empty(q.shape, dtype=qdt)
    if metric == "Cosine":
        nrm = np.linalg.norm(q, axis=1, keepdims=True)
        qp[:] = q / np.where(nrm > 0, nrm, 1.0)
    else:
        qp[:] = q
    return qp


def exact_sum_queries(B, d, seed):
    """Entries k/16 with small integer k: squares and their sums are exact
    in f32 in any order, so the row norm cannot depend on how a library
    orders its reduction, and bit-equality is a fair demand."""
    rng = np.random.default_rng(seed)
    q = rng.integers(-24, 25, size=(B, d)).astype(np.float32) / 16.0
    q[3] = 0.0  # a zero row: the guard keeps it zero
    return q


@pytest.mark.parametrize("metric", ["Cosine", "L2", "IP"])
@pytest.mark.parametrize("half", [True, False])
def test_prepared_queries_bit_equal_numpy(metric, half):
    B, d, d_pad = 64, 24, 128
    q = exact_sum_queries(B, d, 5)
    want = numpy_prep(q, metric, half).astype(np.float32)
    got = prepare_queries(torch.from_numpy(q), metric, d_pad, half=half)
    assert got.shape == (B, d_pad) and got.dtype == torch.float32
    assert np.array_equal(got[:, :d].numpy(), want)  # bit-equal, f16 and f32
    assert not got[:, d:].any()


@pytest.mark.parametrize("metric", ["Cosine", "L2"])
def test_random_queries_within_one_f16_step(metric):
    """On random rows the norm's summation order may differ from numpy's
    in the last f32 bit; after the f16 round at most a rare entry moves,
    and then by one f16 step (2^-11 relative)."""
    rng = np.random.default_rng(6)
    q = rng.standard_normal((256, 100)).astype(np.float32)
    want = numpy_prep(q, metric, True).astype(np.float32)
    got = prepare_queries(torch.from_numpy(q), metric, 128, half=True)
    got = got[:, :100].numpy()
    assert (got == want).mean() >= 0.999
    np.testing.assert_allclose(got, want, rtol=2.0 ** -10, atol=0)


@pytest.mark.parametrize("metric", ["L2", "IP"])
def test_f16_overflow_guard_on_device(metric):
    """A batch whose magnitudes pass 6.0e4 (or are not finite) stays f32,
    as the host code decided before; the choice needs no host sync."""
    q = exact_sum_queries(16, 8, 7)
    q[5, 2] = 7.0e4
    got = prepare_queries(torch.from_numpy(q), metric, 128, half=True)
    assert np.array_equal(got[:, :8].numpy(), numpy_prep(q, metric, True))
    assert torch.isfinite(got).all()
    q[5, 2] = 1234.567  # inside the range: rounded to f16
    got = prepare_queries(torch.from_numpy(q), metric, 128, half=True)
    assert got[5, 2].item() == float(np.float16(1234.567))


@pytest.mark.parametrize("metric", ["Cosine", "L2", "IP"])
def test_int8_queries_bit_equal_numpy(metric):
    """The quant lane's int8 queries and scales against the JAX package's
    `QuantSweepTable.quantize_queries` (numpy)."""
    q = exact_sum_queries(64, 24, 8)
    jt = JaxQuantTable()
    jt.distance, jt.d_pad = metric, 128
    want_q, want_s = jt.quantize_queries(q)
    _, got_q, got_s = prepare_queries(torch.from_numpy(q), metric, 128,
                                      quantize=True)
    assert got_q.dtype == torch.int8
    assert np.array_equal(got_q.numpy(), want_q)
    assert np.array_equal(got_s.numpy(), want_s)


def test_quantize_rounds_half_to_even():
    x = torch.tensor([[127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -126.5]])
    q, s = quantize_i8(x)
    assert s.item() == 1.0
    assert q.tolist() == [[127, 0, 2, 2, 0, -2, -126]]
    assert np.array_equal(q.numpy()[0], np.rint(x.numpy()[0]).astype(np.int8))


def test_int_mm_is_exact():
    rng = np.random.default_rng(9)
    a = rng.integers(-127, 128, size=(5, 256), dtype=np.int8)
    b = rng.integers(-127, 128, size=(40, 256), dtype=np.int8)
    got = int_mm(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), a.astype(np.int64) @ b.astype(np.int64).T)
