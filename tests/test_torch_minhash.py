"""MinHash (`cozo_tpu_torch/ops/minhash.py`) against the JAX package's
(`cozo_tpu/ops/minhash.py`, on the CPU), on the same numpy inputs made
from a seed.

The host half is a copy: each function must give EQUAL output.  The
device half runs with `device="cpu"`, so the kernel's plain PyTorch
version `segment_min_plain`; it must be bit-identical to the JAX
package's `minhash_segments_device` (jitted on the JAX CPU device) and to
its host `minhash_segments`, over `chip_smoke.py` phase 2's cases and the
JAX test's (empty docs, the D = 1,024 tail-fix case, T on either side of
`DEVICE_MIN_TOKENS`, hashes near 2^32).  No tolerance: signatures are
integer minima."""

import numpy as np
import pytest
import torch

import cozo_tpu.ops.minhash as J
import cozo_tpu_torch.ops.minhash as T
from chip_smoke import MINHASH_CASES, minhash_inputs, minhash_tensors

CPU = "cpu"


def docs(lens, seed, hi=1 << 32, lo=0):
    """(flat hashes u32, doc starts i64) of docs of the given lengths,
    hashes drawn in [lo, hi)."""
    rng = np.random.default_rng(seed)
    lens = np.asarray(lens, np.int64)
    offs = np.zeros(len(lens), np.int64)
    np.cumsum(lens[:-1], out=offs[1:])
    flat = rng.integers(lo, hi, int(lens.sum()), dtype=np.uint64)
    return flat.astype(np.uint32), offs


# (name, lengths, n_perm, hash range): the JAX test's cases, then sizes on
# either side of DEVICE_MIN_TOKENS and hashes near 2^32
CASES = [
    ("jax-edges", (0, 5, 0, 17, 3, 0, 9, 1, 0), 64, (0, 1 << 32)),
    ("jax-tail", tuple(np.random.default_rng(9).integers(1, 8, 1024)), 32,
     (0, 1 << 32)),
    ("below-device-min", (15,) * 1000, 100, (0, 1 << 32)),
    ("above-device-min", (17,) * 1000, 128, (0, 1 << 32)),
    ("near-2^32", (4, 0, 9, 30, 1), 100, ((1 << 32) - 64, 1 << 32)),
    ("one-perm", (3, 0, 2), 1, (0, 1 << 32)),
]


# ------------------------------------------------------------ the host half


def test_host_functions_are_the_jax_packages():
    rng = np.random.default_rng(0)
    toks = [f"tok{i % 97}" for i in range(3000)] + ["", "a", "déjà vu",
                                                     "x" * 40]
    assert (T.hash_tokens(toks) == J.hash_tokens(toks)).all()
    assert (T.hash_tokens_dedup(toks) == J.hash_tokens_dedup(toks)).all()
    assert T.hash_tokens([]).dtype == J.hash_tokens([]).dtype == np.uint32
    for n in (1, 32, 100, 128, 256):
        assert (T.perm_seeds(n) == J.perm_seeds(n)).all()
    x = rng.integers(0, 1 << 32, (50, 7), dtype=np.uint64).astype(np.uint32)
    assert (T._mix32_np(x) == J._mix32_np(x)).all()
    h = T.hash_tokens(toks[:40])
    assert (T.minhash(h, 64) == J.minhash(h, 64)).all()
    assert (T.minhash(h[:0], 64) == J.minhash(h[:0], 64)).all()
    for args in ((0.7, 128, 0.5, 0.5), (0.3, 100, 1.0, 1.0),
                 (0.8, 200, 1.0, 1.0)):
        assert T.find_optimal_params(*args) == J.find_optimal_params(*args)
    sig = T.minhash(h, 128)
    assert T.band_keys(sig, 14, 9) == J.band_keys(sig, 14, 9)
    other = T.minhash(h[::2], 128)
    assert T.jaccard_estimate(sig, other) == J.jaccard_estimate(sig, other)


@pytest.mark.parametrize("n_perm", [1, 32, 128])
def test_host_segments_are_the_jax_packages(n_perm):
    """`minhash_segments` (past one 32,768-token tile) and
    `_minhash_segments_block`."""
    rng = np.random.default_rng(n_perm)
    flat, offs = docs(rng.integers(0, 25, 3000), n_perm)
    assert len(flat) > T._HOST_BLOCK_TOKENS
    want = J.minhash_segments(flat, offs, n_perm)
    assert (T.minhash_segments(flat, offs, n_perm) == want).all()
    head = flat[:offs[40]]
    assert (T._minhash_segments_block(head, offs[:40], n_perm)
            == J._minhash_segments_block(head, offs[:40], n_perm)).all()


# ---------------------------------------------------------- the device half


def test_mul32_is_exact_at_the_edges():
    """The 16-bit split multiply equals numpy's wrapping uint32 product."""
    x = np.array([0, 1, 0xFFFF, 0x10000, 0x7FFFFFFF, 0x80000000,
                  0xFFFFFFFE, 0xFFFFFFFF, 0xDEADBEEF], np.uint32)
    for c in (0x85EBCA6B, 0xC2B2AE35, 0xFFFFFFFF):
        got = T._mul32(torch.from_numpy(x.astype(np.int64)), c).numpy()
        assert (got.astype(np.uint32) == x * np.uint32(c)).all()
        assert got.min() >= 0 and got.max() < 1 << 32
    mixed = T._mix32_torch(torch.from_numpy(x.astype(np.int64))).numpy()
    assert (mixed.astype(np.uint32) == J._mix32_np(x)).all()


def _jax_device(flat, offs, n_perm):
    return J.minhash_segments_device(flat, offs, n_perm)


@pytest.mark.parametrize("name,lens,n_perm,rng_", CASES,
                         ids=[c[0] for c in CASES])
def test_device_route_is_bit_identical(name, lens, n_perm, rng_):
    flat, offs = docs(lens, len(lens), hi=rng_[1], lo=rng_[0])
    want = J.minhash_segments(flat, offs, n_perm)
    assert (_jax_device(flat, offs, n_perm) == want).all()
    h, o = minhash_tensors(flat, offs, torch.device(CPU))
    plain = T.segment_min_plain(h, o, n_perm)
    assert plain.dtype == torch.int32 and plain.shape == (len(offs), n_perm)
    assert (plain.numpy().view(np.uint32) == want).all()
    got = T.minhash_segments_device(flat, offs, n_perm, device=CPU)
    assert got.dtype == np.uint32 and (got == want).all()
    fut = T.minhash_segments_dispatch(flat, offs, n_perm, device=CPU)
    assert (fut.get() == want).all()
    assert (T.minhash_segments_auto(flat, offs, n_perm, device=CPU)
            == want).all()


@pytest.mark.parametrize("i", range(len(MINHASH_CASES)),
                         ids=[c[0] for c in MINHASH_CASES])
def test_phase2_cases_are_bit_identical(i):
    """`chip_smoke.py` phase 2's cases: the plain version against JAX's
    device function and host `minhash_segments`."""
    _, lens, n_perm = MINHASH_CASES[i]
    flat, offs = minhash_inputs(lens, i)
    want = J.minhash_segments(flat, offs, n_perm)
    assert (_jax_device(flat, offs, n_perm) == want).all()
    h, o = minhash_tensors(flat, offs, torch.device(CPU))
    out = torch.empty((len(offs), n_perm), dtype=torch.int32)
    assert T.segment_min(h, o, n_perm, out) is out
    assert (out.numpy().view(np.uint32) == want).all()


def test_phase2_cases_reach_every_edge():
    """Empty docs first, inside and last; a one-doc case; a doc past a
    2,048-hash tile; D = 1,024; n_perm 1, 32, 100, 128, 256; the edge
    hashes, and seeds on both sides of the top bit."""
    lens = [minhash_inputs(c[1], i)[1] for i, c in enumerate(MINHASH_CASES)]
    flats = [minhash_inputs(c[1], i)[0] for i, c in enumerate(MINHASH_CASES)]
    perms = {c[2] for c in MINHASH_CASES}
    assert {1, 32, 100, 128, 256} <= perms
    assert any(len(o) == 1024 for o in lens)
    assert any(len(o) == 1 for o in lens)
    ends = [np.diff(np.append(o, len(f))) for o, f in zip(lens, flats)]
    assert any(e[0] == 0 and e[-1] == 0 and (e[1:-1] == 0).any()
               for e in ends)
    assert max(int(e.max()) for e in ends) >= 100_000
    assert all({0, 0xFFFFFFFF, 0x80000000} <= set(f.tolist())
               for f in flats if len(f) >= 4)
    top = T.perm_seeds(32) >> 31
    assert top.min() == 0 and top.max() == 1


def test_dispatch_keeps_the_size_rule_and_the_knob(monkeypatch):
    """Below DEVICE_MIN_TOKENS, and with COZO_TPU_LSH_DEVICE=0 at any
    size, the host `minhash_segments` runs and the device route is not
    entered; at or above it the device route runs."""
    calls = []
    real = T._dispatch
    monkeypatch.setattr(T, "_dispatch",
                        lambda *a: calls.append(len(a[0])) or real(*a))
    small, so = docs((10,) * 100, 1)
    big, bo = docs((20,) * 1000, 2)
    assert len(small) < T.DEVICE_MIN_TOKENS <= len(big)
    for flat, offs in ((small, so), (big, bo)):
        want = J.minhash_segments(flat, offs, 64)
        assert (T.minhash_segments_dispatch(flat, offs, 64, CPU).get()
                == want).all()
        assert (T.minhash_segments_auto(flat, offs, 64, CPU) == want).all()
    assert calls == [len(big), len(big)]
    monkeypatch.setenv("COZO_TPU_LSH_DEVICE", "0")
    calls.clear()
    assert (T.minhash_segments_dispatch(big, bo, 64, CPU).get()
            == J.minhash_segments(big, bo, 64)).all()
    assert (T.minhash_segments_auto(big, bo, 64, CPU)
            == J.minhash_segments(big, bo, 64)).all()
    assert calls == []


def test_empty_inputs_return_as_in_jax():
    flat = np.empty(0, np.uint32)
    for offs in (np.empty(0, np.int64), np.zeros(3, np.int64)):
        want = J.minhash_segments_device(flat, offs, 16)
        got = T.minhash_segments_device(flat, offs, 16, device=CPU)
        assert got.shape == want.shape and (got == want).all()
        assert (T.minhash_segments_dispatch(flat, offs, 16, CPU).get()
                == want).all()


def test_segment_min_refuses_what_the_kernel_does_not_take():
    h = torch.zeros(8, dtype=torch.int32)
    o = torch.tensor([0, 3], dtype=torch.int64)
    out = torch.empty((2, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="n_perm"):
        T.segment_min(h, o, 0, torch.empty((2, 0), dtype=torch.int32))
    with pytest.raises(ValueError, match="out must be"):
        T.segment_min(h, o, 5, out)
    with pytest.raises(ValueError, match="int32"):
        T.segment_min(h.long(), o, 4, out)
    with pytest.raises(ValueError, match="int32"):
        T.segment_min(h, o.int(), 4, out)
    # a tensor that is not on the CPU never reaches the plain version
    meta = [t.to("meta") for t in (h, o, out)]
    with pytest.raises(ValueError, match="on the card"):
        T.segment_min(*meta[:2], 4, meta[2])
    with pytest.raises(ValueError, match="different devices"):
        T.segment_min(h, o, 4, meta[2])


def test_device_route_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    flat, offs = docs((20,) * 1000, 3)
    with pytest.raises(RuntimeError, match="CUDA"):
        T.minhash_segments_device(flat, offs, 32)
    with pytest.raises(RuntimeError, match="CUDA"):
        T.minhash_segments_dispatch(flat, offs, 32)
