"""What can be checked of the CUDA fused sweep without a card
(`cozo_tpu_torch/csrc/fused_sweep.cu`, `cozo_tpu_torch/ops/fused_sweep.py`):
the wrapper's choice of route, the persistent grid's division of the work,
the C interface the wrapper binds with ctypes, and the kernel's register
epilogue re-enacted thread by thread in PyTorch against the plain version.
The kernel itself is held against the plain version on the card
(tests/test_torch_cuda.py, chip_smoke.py)."""

import ctypes
import os
import re

import numpy as np
import pytest
import torch

from cozo_tpu_torch.ops import _build
from cozo_tpu_torch.ops import fused_sweep as fs
from cozo_tpu_torch.utils.device import mm_bf16

N_SM = 132  # an H100's multiprocessors


# -- (a) route selection --------------------------------------------------------


@pytest.mark.parametrize("d_pad", [16, 48, 64, 112, 128, 144, 256, 768, 1024])
def test_route_is_a_function_of_the_shape_alone(d_pad, monkeypatch):
    """Every width `_check` accepts has a route; the choice never looks at
    the build or the device (both are made to fail here)."""

    def boom(*a, **k):
        raise AssertionError("route() consulted the build or the device")

    monkeypatch.setattr(_build, "load", boom)
    monkeypatch.setattr(_build, "build", boom)
    monkeypatch.setattr(torch.cuda, "is_available", boom)
    want = "resident" if d_pad <= 128 else "kloop"
    for B in (1, 77, 16_384):
        for n_total in (256, 1_280, 1_310_720):
            assert fs.route(B, n_total, d_pad) == want
    assert want in fs.ROUTES
    assert set(fs.fused_sweep.route_launches) == set(fs.ROUTES)


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    qs = torch.randn(5, 64).to(torch.bfloat16)
    tbl = torch.randn(512, 64).to(torch.bfloat16)
    bias = torch.zeros(512)
    before = dict(fs.fused_sweep.route_launches), fs.fused_sweep.launches
    out = fs.fused_sweep(qs, tbl, bias)
    assert torch.equal(out, fs.fused_sweep_plain(qs, tbl, bias))
    assert (dict(fs.fused_sweep.route_launches), fs.fused_sweep.launches) == before


# -- (b) the persistent schedule --------------------------------------------------


@pytest.mark.parametrize("d_pad", [128, 256])
@pytest.mark.parametrize("n_total", [256, 1_280, 1_310_720])
@pytest.mark.parametrize("B", [1, 77, 16_384])
def test_work_split_covers_every_tile_once(B, n_total, d_pad):
    route, n_qt, ranges = fs.work_split(B, n_total, d_pad, N_SM)
    g, qtile = fs.SEG_GROUP[route], fs.Q_TILE[route]
    n_seg = n_total // fs.SEG
    assert n_qt == -(-B // qtile)
    units = -(-n_seg // g) * n_qt
    # contiguous, disjoint, complete, balanced to within one unit, and a
    # grid no larger than the card or the work
    assert len(ranges) == min(N_SM, units)
    assert ranges[0][0] == 0 and ranges[-1][1] == units
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    sizes = [e - b for b, e in ranges]
    assert min(sizes) >= 1 and max(sizes) - min(sizes) <= 1
    # every (query tile, segment) exactly once
    u = np.concatenate([np.arange(b, e) for b, e in ranges])
    grp, qt = u // n_qt, u % n_qt
    seen = np.zeros(n_qt * n_seg, dtype=np.int32)
    for s in range(g):
        seg = grp * g + s
        ok = seg < n_seg
        np.add.at(seen, qt[ok] * n_seg + seg[ok], 1)
    assert seen.min() == 1 and seen.max() == 1
    # the rows of the last query tile reach B
    assert (n_qt - 1) * qtile < B <= n_qt * qtile


# -- (c) the C interface ------------------------------------------------------------

_C_TYPES = {"void*": ctypes.c_void_p, "constvoid*": ctypes.c_void_p,
            "int": ctypes.c_int, "float": ctypes.c_float,
            "longlong": ctypes.c_longlong, "constlonglong*": ctypes.c_void_p}


def _extern_c_functions():
    """name -> [ctypes type of each parameter] of every function defined in
    an `extern "C"` block of csrc/*.cu."""
    found = {}
    for name in sorted(os.listdir(_build.CSRC)):
        if not name.endswith(".cu"):
            continue
        with open(os.path.join(_build.CSRC, name)) as f:
            src = f.read()
        block = src[src.index('extern "C" {'):]
        for m in re.finditer(r"^(?:const char\*|int) (\w+)\(([^)]*)\)\s*\{",
                             block, re.M):
            params = [p.strip() for p in m.group(2).split(",") if p.strip()]
            types = []
            for p in params:
                ctype = "".join(p.split()[:-1])  # drop the parameter's name
                types.append(_C_TYPES[ctype])
            found[m.group(1)] = types
    return found


@pytest.mark.parametrize("route", fs.ROUTES)
def test_ctypes_signature_matches_the_source(route):
    funcs = _extern_c_functions()
    assert funcs["cozo_fused_sweep_" + route] == fs._ARGTYPES


def test_error_string_function_matches_the_source():
    assert _extern_c_functions()["cozo_cuda_error_string"] == [ctypes.c_int]


def test_source_constants_match_the_wrapper():
    with open(os.path.join(_build.CSRC, "fused_sweep.cu")) as f:
        src = f.read()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const("SEG") == fs.SEG
    assert const("BQ") == fs.Q_TILE["resident"]
    assert const("NCONS") * const("BQ") == fs.Q_TILE["kloop"]
    assert const("R_GROUP") == fs.SEG_GROUP["resident"]
    assert const("R_KC") * const("KC") == fs.RESIDENT_MAX_D
    assert float(re.search(r"NEG_FILL = (-[\d.e]+)f;", src).group(1)) == fs.NEG_FILL


# -- (d) the register epilogue, thread by thread ---------------------------------------


def _emulate_epilogue(scores: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """The kernel's epilogue on one [64, 256] f32 score tile as its 128
    threads run it.  Thread (row r, quad lane q) holds the columns
    8j + 2q + e; per (row, q, e) a running top-2 over j with only the 8j
    bits packed; then the low id bits are OR'd in, the two e-streams
    merged, the quad merged by two xor-shuffles (1, 2), and the second
    value clamped at NEG_FILL.  Returns [64, 2]."""
    s = (scores + bias[None, :]).reshape(64, 32, 4, 2)  # [row, j, q, e]
    keep = ~(fs.SEG - 1)
    ninf = torch.full((64, 4, 2), float("-inf"))
    m1, m2 = ninf.clone(), ninf.clone()
    for j in range(32):
        p = ((s[:, j].view(torch.int32) & keep) | (8 * j)).view(torch.float32)
        m2 = torch.maximum(m2, torch.minimum(m1, p))
        m1 = torch.maximum(m1, p)

    def or_bits(x, bits):
        return (x.contiguous().view(torch.int32) | bits).view(torch.float32)

    low = (2 * torch.arange(4, dtype=torch.int32))[None, :]
    x1, x2 = or_bits(m1[..., 0], low), or_bits(m2[..., 0], low)
    y1, y2 = or_bits(m1[..., 1], low | 1), or_bits(m2[..., 1], low | 1)
    t1 = torch.maximum(x1, y1)
    t2 = torch.maximum(torch.minimum(x1, y1), torch.maximum(x2, y2))
    for off in (1, 2):
        idx = torch.arange(4) ^ off
        o1, o2 = t1[:, idx], t2[:, idx]
        t2 = torch.maximum(torch.minimum(t1, o1), torch.maximum(t2, o2))
        t1 = torch.maximum(t1, o1)
    # all four lanes of a quad now agree
    assert bool((t1 == t1[:, :1]).all()) and bool((t2 == t2[:, :1]).all())
    return torch.stack([t1[:, 0], t2[:, 0].clamp(min=fs.NEG_FILL)], dim=1)


@pytest.mark.parametrize("dead", ["none", "some", "all_but_one", "all"])
@pytest.mark.parametrize("d_pad", [48, 128])
def test_register_epilogue_equals_plain(d_pad, dead):
    g = torch.Generator().manual_seed(d_pad + len(dead))
    qs = torch.randn(64, d_pad, generator=g).to(torch.bfloat16)
    tbl = torch.randn(3 * fs.SEG, d_pad, generator=g).to(torch.bfloat16)
    bias = torch.zeros(3 * fs.SEG)
    seg1 = slice(fs.SEG, 2 * fs.SEG)
    if dead == "some":
        bias[seg1][torch.randperm(fs.SEG, generator=g)[:100]] = fs.NEG_FILL
    elif dead == "all_but_one":
        bias[seg1] = fs.NEG_FILL
        bias[fs.SEG + 77] = 0.0
    elif dead == "all":
        bias[seg1] = fs.NEG_FILL
    ref = fs.fused_sweep_plain(qs, tbl, bias)
    scores = mm_bf16(qs, tbl)
    for seg in range(3):
        cols = slice(seg * fs.SEG, (seg + 1) * fs.SEG)
        got = _emulate_epilogue(scores[:, cols], bias[cols])
        assert torch.equal(got, ref[:, 2 * seg:2 * seg + 2]), (seg, dead)
    if dead == "all":
        assert bool((ref[:, 2:4] <= fs.NEG_FILL * 0.5).all())
