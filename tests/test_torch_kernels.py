"""CUDA kernels of the PyTorch port against their plain PyTorch versions, on
the card. Every test here needs a CUDA device and skips without one.

This file imports no JAX, so it runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py -q
"""

import ctypes
import itertools

import numpy as np
import pytest
import torch

from hybrid_vit_cascade_tpu_torch.ops.cuda import _build, conv_probe, launch_counts
from hybrid_vit_cascade_tpu_torch.ops.cuda import library  # noqa: F401  (the hvc:: operators)
from hybrid_vit_cascade_tpu_torch.ops.cuda.conv3d_k3 import (
    DGRAD_S2_C1_FP32,
    DGRAD_S2_C1_TC,
    DGRAD_S2_CUDA_CORE,
    DGRAD_S2_TC,
    LAUNCHES,
    WGRAD_C1IN_S2_TC,
    WGRAD_TC,
    conv3d_k3,
    conv3d_k3_dgrad,
    conv3d_k3_dgrad_plain,
    conv3d_k3_plain,
    conv3d_k3_wgrad,
    conv3d_k3_wgrad_plain,
    dgrad_c1_uses_tensor_cores,
    dgrad_s2_instance,
    fwd_c1in_uses_tensor_cores,
    fwd_uses_tensor_cores,
    wgrad_instance,
)
from hybrid_vit_cascade_tpu_torch.ops.cuda.flash_attention import (
    bwd_dkv_uses_tensor_cores,
    bwd_dq_uses_tensor_cores,
    bwd_uses_tensor_cores,
    flash_attention_bwd,
    flash_attention_bwd_dkv,
    flash_attention_bwd_dq,
    flash_attention_bwd_plain,
    flash_attention_bwd_split,
    flash_attention_fwd,
    flash_attention_plain,
)
from hybrid_vit_cascade_tpu_torch.scripts import bench_conv_probe as bench

pytestmark = pytest.mark.cuda

# Tolerances (|got - want| <= atol + rtol·|want|). fp32: both sides
# accumulate in fp32 in another order. bf16: both sides round once to bf16
# at the end (one ulp is 2^-8 relative), from the same bf16 inputs.
TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2e-2, 2e-2)}
# Weight gradients sum up to millions of products in another order and come
# out in fp32; their inputs are the same bf16 values on both sides, so the
# bf16 case differs from the plain version only by summation order.
GRAD_TOL = {torch.float32: (1e-3, 1e-4), torch.bfloat16: (1e-3, 1e-3)}
# Flash attention's output (chip_smoke.py FLASH_OUT_TOL): |out| is about
# (e / Nk)^0.5, far under TOL's absolute part at long Nk, so the absolute
# part is scaled by the call's largest |want|.
FLASH_OUT_TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (1e-2, 2e-2)}
DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _randn(shape, dtype, dev, seed):
    g = np.random.default_rng(seed)
    return torch.from_numpy(g.standard_normal(shape, dtype=np.float32)).to(dev, dtype)


def _close(got, want, dtype, tol=TOL, floor=0.0):
    atol, rtol = tol[dtype]
    torch.cuda.synchronize()
    if tol is FLASH_OUT_TOL:
        atol *= max(float(want.float().abs().max()), floor)
    err = (got.float() - want.float()).abs()
    assert torch.isfinite(got.float()).all()
    assert bool((err <= atol + rtol * want.float().abs()).all()), float(err.max())


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("bh,nq,nk,d", [(3, 200, 77, 32), (3, 200, 77, 64), (2, 130, 300, 32),
                                        (8, 1024, 1024, 32), (4, 1024, 256, 64)])
def test_flash_matches_plain(dev, dtype, bh, nq, nk, d):
    q, k, v = (_randn((bh, n, d), dtype, dev, s) for s, n in ((0, nq), (1, nk), (2, nk)))
    scale = d ** -0.5
    before = flash_attention_fwd.launches
    out, lse = flash_attention_fwd(q, k, v, scale)
    assert flash_attention_fwd.launches == before + 1
    want_out, want_lse = flash_attention_plain(q, k, v, scale)
    assert out.dtype == dtype and lse.dtype == torch.float32
    _close(out, want_out, dtype, FLASH_OUT_TOL)
    _close(lse, want_lse, torch.float32)


def test_flash_rejects_unsupported(dev):
    q = torch.zeros((1, 8, 48), device=dev)
    with pytest.raises(ValueError):
        flash_attention_fwd(q, q, q, 1.0)
    q = torch.zeros((1, 8, 32), device=dev, dtype=torch.float16)
    with pytest.raises(TypeError):
        flash_attention_fwd(q, q, q, 1.0)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("b,cin,cout,dhw", [(2, 3, 5, (5, 6, 10)), (1, 8, 40, (5, 6, 10)),
                                            (1, 1, 32, (16, 16, 16)), (1, 64, 32, (8, 24, 40)),
                                            (1, 32, 64, (16, 16, 16))])
def test_conv_matches_plain(dev, dtype, stride, b, cin, cout, dhw):
    x = _randn((b, cin, *dhw), dtype, dev, 3)
    w = (_randn((cout, cin, 3, 3, 3), torch.float32, dev, 4) / (27 * cin) ** 0.5).to(dtype)
    bias = _randn((cout,), torch.float32, dev, 5)
    d_out = (dhw[0] - 1) // stride + 1
    counter = f"conv3d_k3s{stride}"
    before = LAUNCHES[counter]
    got = conv3d_k3(x, w, bias, stride, 1, d_out, dense=True)
    assert LAUNCHES[counter] == before + 1
    want = conv3d_k3_plain(x, w, bias, stride, 1, d_out)
    assert got.shape == want.shape and got.dtype == dtype
    _close(got, want, dtype)


def test_conv_rejects_mixed_dtype(dev):
    x = torch.zeros((1, 4, 4, 4, 4), device=dev, dtype=torch.bfloat16)
    w = torch.zeros((4, 4, 3, 3, 3), device=dev)
    with pytest.raises(TypeError):
        conv3d_k3(x, w, None, 1, 1, 4, dense=True)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("bh,nq,nk,d", [(3, 200, 77, 32), (3, 200, 77, 64), (2, 130, 300, 32),
                                        (8, 1024, 1024, 32), (4, 1024, 256, 64)])
def test_flash_bwd_matches_plain(dev, dtype, bh, nq, nk, d):
    q, dout = (_randn((bh, nq, d), dtype, dev, s) for s in (0, 3))
    k, v = (_randn((bh, nk, d), dtype, dev, s) for s in (1, 2))
    scale = d ** -0.5
    out, lse = flash_attention_fwd(q, k, v, scale)
    before = flash_attention_bwd.launches
    got = flash_attention_bwd(q, k, v, out, lse, dout, scale)
    assert flash_attention_bwd.launches == before + 1
    want = flash_attention_bwd_plain(q, k, v, out, lse, dout, scale)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == dtype
        _close(g, w, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("bh,nq,nk,d", [(3, 200, 77, 32), (3, 200, 77, 64), (2, 130, 300, 32),
                                        (8, 1024, 1024, 32), (4, 1024, 256, 64)])
def test_flash_bwd_split_matches_plain(dev, dtype, bh, nq, nk, d):
    """Kernels L (dq) and M (dk, dv): the plain backward's values, each
    launched once per split backward, the halves alone giving the same bits,
    and two runs bitwise equal (no atomics)."""
    q, dout = (_randn((bh, nq, d), dtype, dev, s) for s in (0, 3))
    k, v = (_randn((bh, nk, d), dtype, dev, s) for s in (1, 2))
    scale = d ** -0.5
    out, lse = flash_attention_fwd(q, k, v, scale)
    before = (flash_attention_bwd_dq.launches, flash_attention_bwd_dkv.launches,
              flash_attention_bwd.launches)
    got = flash_attention_bwd_split(q, k, v, out, lse, dout, scale)
    assert (flash_attention_bwd_dq.launches, flash_attention_bwd_dkv.launches,
            flash_attention_bwd.launches) == (before[0] + 1, before[1] + 1, before[2])
    want = flash_attention_bwd_plain(q, k, v, out, lse, dout, scale)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == dtype
        _close(g, w, dtype)
    again = flash_attention_bwd_split(q, k, v, out, lse, dout, scale)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert torch.equal(flash_attention_bwd_dq(q, k, v, out, lse, dout, scale), got[0])
    dk, dv = flash_attention_bwd_dkv(q, k, v, out, lse, dout, scale)
    assert torch.equal(dk, got[1]) and torch.equal(dv, got[2])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("b,cin,cout,dhw", [(2, 3, 5, (5, 6, 10)), (1, 8, 40, (5, 6, 10)),
                                            (1, 1, 32, (16, 16, 16)), (1, 64, 32, (8, 24, 40)),
                                            (2, 32, 64, (16, 16, 16)), (1, 64, 1, (6, 10, 34))])
def test_conv_grads_match_plain(dev, dtype, stride, b, cin, cout, dhw):
    x = _randn((b, cin, *dhw), dtype, dev, 6)
    w = (_randn((cout, cin, 3, 3, 3), torch.float32, dev, 7) / (27 * cin) ** 0.5).to(dtype)
    odhw = tuple((s - 1) // stride + 1 for s in dhw)
    g = _randn((b, cout, *odhw), dtype, dev, 8)
    counters = [f"conv3d_k3s{stride}_wgrad", f"conv3d_k3s{stride}_dgrad", f"conv3d_k3s{stride}"]
    before = [LAUNCHES[c] for c in counters]
    dw = conv3d_k3_wgrad(x, g, stride, 1, dense=True)
    assert dw.dtype == torch.float32
    _close(dw, conv3d_k3_wgrad_plain(x, g, stride, 1), dtype, GRAD_TOL)
    dx = conv3d_k3_dgrad(g, w, x, stride, 1, dense=True)
    assert [LAUNCHES[c] for c in counters] == [before[0] + 1, before[1] + 1, before[2]]
    assert dx.shape == x.shape and dx.dtype == dtype
    _close(dx, conv3d_k3_dgrad_plain(g, w, x, stride, 1), dtype)


# (B, Cin, Cout, (H, W), planes of x, slab plane of x's first plane, output planes)
CHAIN_CASES = [(2, 3, 5, (6, 10), 4, 2, 5),    # x inside the slab: both ends read as zeros
               (1, 8, 40, (5, 12), 6, 0, 4),   # x from slab plane 0, the back zeroed
               (1, 64, 32, (8, 24), 7, 1, 7),  # the dense form (qlo 1, all planes)
               (1, 1, 64, (16, 16), 9, 0, 8),  # one input channel; its dgrad has Cout 1
               (1, 4, 8, (6, 6), 5, -1, 3)]    # x begins before the slab


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("act", [None, "gelu", "silu"])
@pytest.mark.parametrize("case", CHAIN_CASES)
def test_chain_conv_matches_plain(dev, dtype, stride, act, case):
    """Kernels H-K: the chain conv (window, prologue, Σ/Σ² epilogue), its data
    gradient (act′ epilogue) and weight gradient (prologue replayed), on a
    D-narrowed view as the slab bodies pass it."""
    b, cin, cout, (h, w_), nv, qlo, d_out = case
    x = _randn((b, cin, nv + 3, h, w_), dtype, dev, 9).narrow(2, 1, nv)
    w = (_randn((cout, cin, 3, 3, 3), torch.float32, dev, 10) / (27 * cin) ** 0.5).to(dtype)
    bias = _randn((cout,), torch.float32, dev, 11)
    counters = [f"conv3d_k3s{stride}_chain{k}" for k in ("", "_dgrad", "_wgrad")]
    counters.append(f"conv3d_k3s{stride}")
    before = [LAUNCHES[c] for c in counters]
    out, s1, s2 = conv3d_k3(x, w, bias, stride, qlo, d_out, True, act)
    want = conv3d_k3_plain(x, w, bias, stride, qlo, d_out, True, act)
    assert out.shape == want[0].shape and out.dtype == dtype
    _close(out, want[0], dtype)
    # the epilogue's sums are those of the kernel's own rounded output
    of = out.float()
    for got_s, ref in ((s1, of.sum(dim=(2, 3, 4))), (s2, (of * of).sum(dim=(2, 3, 4)))):
        assert got_s.dtype == torch.float32
        bound = 1e-5 * (of.abs() if got_s is s1 else of * of).sum(dim=(2, 3, 4)) + 1e-5
        assert bool(((got_s - ref).abs() <= bound).all()), float((got_s - ref).abs().max())
    # no sums, same output
    assert torch.equal(conv3d_k3(x, w, bias, stride, qlo, d_out, False, act), out)
    g = _randn(tuple(out.shape), dtype, dev, 12)
    dx = conv3d_k3_dgrad(g, w, x, stride, qlo, act)
    assert dx.shape == x.shape and dx.dtype == dtype
    _close(dx, conv3d_k3_dgrad_plain(g, w, x, stride, qlo, act), dtype)
    dw = conv3d_k3_wgrad(x, g, stride, qlo, act)
    _close(dw, conv3d_k3_wgrad_plain(x, g, stride, qlo, act), dtype, GRAD_TOL)
    assert [LAUNCHES[c] for c in counters] == [before[0] + 2, before[1] + 1, before[2] + 1,
                                               before[3]]


# (B, Cin, Cout, (H, W), planes of x, slab plane of x's first plane, output
# planes at stride 1, at stride 2): weight gradients that reach the tensor-
# core instance (bf16, Cin ≥ 8) at ragged shapes: Cin not a multiple of 8 or
# 32, Cout not a multiple of 32, odd H and W, x beginning before the slab;
# W = 32 stages by cp.async (rows 16-byte aligned), the others element by
# element.
TC_CASES = [(1, 24, 20, (7, 9), 5, -1, 4, 2),
            (2, 40, 36, (5, 32), 6, 0, 5, 3),
            (1, 64, 40, (9, 24), 7, 1, 7, 4),
            (1, 8, 32, (16, 16), 9, 0, 8, 4)]


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("act", [None, "gelu", "silu"])
@pytest.mark.parametrize("case", TC_CASES)
def test_wgrad_tensor_cores_ragged(dev, stride, act, case):
    """The tensor-core weight gradient (E, G, K in bf16 with Cin ≥ 8) against
    its plain version at ragged shapes, counted in its own counter, and
    bitwise repeatable; the same call in fp32 stays on the CUDA cores."""
    b, cin, cout, (h, w_), nv, qlo, d1, d2 = case
    d_out = d1 if stride == 1 else d2
    ho, wo = ((n - 1) // stride + 1 for n in (h, w_))
    tc = f"conv3d_k3s{stride}_wgrad_tc"
    for dtype in DTYPES:
        x = _randn((b, cin, nv + 3, h, w_), dtype, dev, 13).narrow(2, 1, nv)
        g = _randn((b, cout, d_out, ho, wo), dtype, dev, 14)
        before = LAUNCHES[tc]
        dw = conv3d_k3_wgrad(x, g, stride, qlo, act)
        assert LAUNCHES[tc] == before + (dtype == torch.bfloat16)
        assert (wgrad_instance(dtype, stride, cin) == WGRAD_TC) == (dtype == torch.bfloat16)
        _close(dw, conv3d_k3_wgrad_plain(x, g, stride, qlo, act), dtype, GRAD_TOL)
        assert torch.equal(conv3d_k3_wgrad(x, g, stride, qlo, act), dw)


# Weight-gradient shapes of the main path (chip_smoke.py TRAIN_KERNELS and
# CHAIN_KERNELS) that take the tensor cores: (stride, B, Cin, Cout, planes of
# x, H, W, slab plane of x's first plane, output planes, act). Dense calls are
# the chain call over the whole volume (qlo 1).
_R = 256
TC_MAIN_SHAPES = [(1, 8, 128, 256, 16, 16, 16, 1, 16, None), (1, 1, 64, 32, _R, _R, _R, 1, _R, None),
                  (1, 1, 64, 32, 34, _R, _R, 0, 32, None), (1, 1, 64, 32, 34, _R, _R, 0, 32, "gelu"),
                  (1, 2, 64, 32, 34, _R, _R, 0, 32, None),
                  (2, 2, 32, 64, 128, 128, 128, 1, 64, None), (2, 2, 64, 128, 64, 64, 64, 1, 32, None),
                  (2, 2, 128, 256, 32, 32, 32, 1, 16, None), (2, 8, 64, 128, 32, 32, 32, 1, 16, None),
                  (2, 1, 32, 64, _R, _R, _R, 1, 128, None), (2, 1, 64, 128, 128, 128, 128, 1, 64, None),
                  (2, 1, 128, 256, 64, 64, 64, 1, 32, None), (2, 1, 32, 64, 33, _R, _R, 0, 16, None),
                  (2, 1, 32, 64, 32, _R, _R, 1, 16, None), (2, 1, 32, 64, 33, _R, _R, 0, 16, "gelu"),
                  (2, 2, 32, 64, 33, _R, _R, 0, 16, None)]


@pytest.mark.parametrize("shape", TC_MAIN_SHAPES)
def test_wgrad_tensor_cores_main_path(dev, shape):
    """The tensor-core weight gradient at the main path's bf16 shapes: within
    chip_smoke.py's tolerance of the plain version (that of dW's dtype, fp32
    1e-4, the absolute part scaled by the largest |want|: sums over up to
    16.7 M voxels; both sides sum the same bf16 products) and bitwise
    repeatable."""
    stride, b, cin, cout, nv, h, w_, qlo, d_out, act = shape
    x = _randn((b, cin, nv + 2, h, w_), torch.bfloat16, dev, 15).narrow(2, 1, nv)
    g = _randn((b, cout, d_out, (h - 1) // stride + 1, (w_ - 1) // stride + 1), torch.bfloat16,
               dev, 16)
    before = LAUNCHES[f"conv3d_k3s{stride}_wgrad_tc"]
    dw = conv3d_k3_wgrad(x, g, stride, qlo, act)
    assert LAUNCHES[f"conv3d_k3s{stride}_wgrad_tc"] == before + 1
    want = conv3d_k3_wgrad_plain(x, g, stride, qlo, act)
    torch.cuda.synchronize()
    err = (dw - want).abs()
    assert torch.isfinite(dw).all()
    assert bool((err <= 1e-4 * want.abs().max() + 1e-4 * want.abs()).all()), float(err.max())
    assert torch.equal(conv3d_k3_wgrad(x, g, stride, qlo, act), dw)


# Stride-1 conv shapes of the main path (chip_smoke.py KERNELS["conv3d_k3s1"],
# TRAIN_KERNELS["conv3d_k3s1_dgrad"], CHAIN_KERNELS["conv3d_k3s1_chain"] and
# "conv3d_k3s1_chain_dgrad"), as the chain call: (B, Cin, Cout, planes of x,
# H, W, slab plane of x's first plane, output planes, Σ/Σ², act). Dense calls
# are the chain call over the whole volume (qlo 1, no options).
_FWD_MAIN_DENSE = [(1, 128, 256, 16, 16, 16, 1, 16, False, None),
                   (1, 1, 32, 128, 128, 128, 1, 128, False, None),
                   (1, 1, 32, _R, _R, _R, 1, _R, False, None), (1, 1, 64, _R, _R, _R, 1, _R, False, None),
                   (1, 64, 32, _R, _R, _R, 1, _R, False, None), (8, 128, 256, 16, 16, 16, 1, 16, False, None)]
_FWD_MAIN_CHAIN = [
    (1, 1, 64, 34, _R, _R, 0, 32, True, None), (1, 1, 64, 33, _R, _R, 1, 32, True, None),
    (1, 1, 64, 33, _R, _R, 0, 32, True, None), (1, 1, 64, 36, _R, _R, 0, 34, False, None),
    (1, 64, 32, 34, _R, _R, 0, 32, True, None), (1, 64, 32, 34, _R, _R, 0, 32, True, "gelu"),
    (1, 1, 32, 34, _R, _R, 0, 32, True, None), (1, 1, 32, 35, _R, _R, 0, 33, False, None),
    (2, 64, 32, 34, _R, _R, 0, 32, True, None),
    (1, 1, 64, _R, _R, _R, 1, _R, True, None), (1, 64, 32, _R, _R, _R, 1, _R, True, None),
    (1, 1, 32, _R, _R, _R, 1, _R, True, None)]


def _fwd_case(shape, dtype, dev, seed):
    b, cin, cout, nv, h, w_, qlo, d_out, sums, act = shape
    x = _randn((b, cin, nv + 2, h, w_), dtype, dev, seed).narrow(2, 1, nv)
    w = (_randn((cout, cin, 3, 3, 3), torch.float32, dev, seed + 1) / (27 * cin) ** 0.5).to(dtype)
    return x, w, _randn((cout,), torch.float32, dev, seed + 2)


def _check_sums(out, s1, s2):
    """The Σ/Σ² epilogue sums the kernel's own rounded output (TOL of fp32
    sums over up to 16.7 M voxels in another order)."""
    of = out.float()
    for got_s, mag, ref in ((s1, of.abs(), of), (s2, of * of, of * of)):
        want = ref.sum(dim=(2, 3, 4))
        bound = 1e-5 * mag.sum(dim=(2, 3, 4)) + 1e-5
        assert bool(((got_s - want).abs() <= bound).all()), float((got_s - want).abs().max())


def _conv_fwd_and_dgrad(shape, dev, dense):
    """The conv and its stride-1 data gradient in bf16 against their plain
    versions, each counted on the instance ``fwd_uses_tensor_cores`` (or,
    for a 1-channel conv, ``fwd_c1in_uses_tensor_cores``, and for its data
    gradient ``dgrad_c1_uses_tensor_cores``) names."""
    b, cin, cout, nv, h, w_, qlo, d_out, sums, act = shape
    dt = torch.bfloat16
    x, w, bias = _fwd_case(shape, dt, dev, 30)
    tc = "conv3d_k3s1_tc" if dense else "conv3d_k3s1_chain_tc"
    c1in = "conv3d_k3s1_c1in_tc" if dense else "conv3d_k3s1_chain_c1in_tc"
    before, before_c1in = LAUNCHES[tc], LAUNCHES[c1in]
    res = conv3d_k3(x, w, bias, 1, qlo, d_out, sums, act, dense=dense)
    assert LAUNCHES[tc] == before + fwd_uses_tensor_cores(dt, 1, cin, cout)
    assert LAUNCHES[c1in] == before_c1in + fwd_c1in_uses_tensor_cores(dt, 1, cin, cout)
    want = conv3d_k3_plain(x, w, bias, 1, qlo, d_out, sums, act)
    out = res[0] if sums else res
    _close(out, want[0] if sums else want, dt)
    if sums:
        _check_sums(out, res[1], res[2])
    del res, want
    g = _randn(tuple(out.shape), dt, dev, 33)
    c1 = "conv3d_k3s1_dgrad_c1_tc" if dense else "conv3d_k3s1_chain_dgrad_c1_tc"
    before, before_c1 = LAUNCHES[tc], LAUNCHES[c1]
    dx = conv3d_k3_dgrad(g, w, x, 1, qlo, act, dense=dense)
    assert LAUNCHES[tc] == before + fwd_uses_tensor_cores(dt, 1, cout, cin)
    assert LAUNCHES[c1] == before_c1 + dgrad_c1_uses_tensor_cores(dt, cout, cin)
    want = conv3d_k3_dgrad_plain(g, w, x, 1, qlo, act)
    torch.cuda.synchronize()
    err = (dx.float() - want.float()).abs()
    scale = max(1.0, float(want.float().abs().max()))  # chip_smoke.py's gradient tolerance
    assert torch.isfinite(dx.float()).all()
    assert bool((err <= 2e-2 * scale + 2e-2 * want.float().abs()).all()), float(err.max())


@pytest.mark.parametrize("shape", _FWD_MAIN_DENSE)
def test_conv_tensor_cores_main_path_dense(dev, shape):
    """Kernel B and B as the stride-1 data gradient at the main path's dense
    shapes, bf16: the Cin ≥ 8, Cout ≥ 8 calls on the tensor cores."""
    _conv_fwd_and_dgrad(shape, dev, dense=True)


@pytest.mark.parametrize("shape", _FWD_MAIN_CHAIN)
def test_conv_tensor_cores_main_path_chain(dev, shape):
    """Kernel H and H as the data gradient at the streamed chains' shapes."""
    _conv_fwd_and_dgrad(shape, dev, dense=False)


# Ragged calls that reach the tensor-core conv: Cin 8 / 24 / 40 (not a
# multiple of the 16-channel chunk), Cout 8 / 40 / 48 (not a multiple of
# the 32-channel tile), odd H and W, x beginning before the slab (qlo < 0)
# and ending before the output's last planes, with every option.
TC_FWD_CASES = [(1, 8, 40, 5, 7, 9, -1, 6, True, "gelu"),
                (2, 24, 8, 6, 5, 33, 0, 5, True, "silu"),
                (1, 40, 48, 7, 9, 35, 1, 7, True, None),
                (1, 24, 40, 4, 6, 12, 0, 6, False, "gelu"),
                (2, 16, 48, 9, 11, 40, 2, 9, True, "silu")]


@pytest.mark.parametrize("case", TC_FWD_CASES)
def test_conv_tensor_cores_ragged(dev, case):
    """The tensor-core conv (bf16, stride 1) at ragged shapes: the chain
    options (window, prologue, Σ/Σ², the act′ epilogue of its data
    gradient), Σ/Σ² bitwise equal over two runs; the fp32 call stays on the
    CUDA cores."""
    b, cin, cout, nv, h, w_, qlo, d_out, sums, act = case
    _conv_fwd_and_dgrad(case, dev, dense=False)
    x, w, bias = _fwd_case(case, torch.bfloat16, dev, 40)
    first = conv3d_k3(x, w, bias, 1, qlo, d_out, True, act)
    again = conv3d_k3(x, w, bias, 1, qlo, d_out, True, act)
    assert all(torch.equal(a, c) for a, c in zip(first, again))
    xf, wf, _ = _fwd_case(case, torch.float32, dev, 40)
    before = LAUNCHES["conv3d_k3s1_chain_tc"]
    conv3d_k3(xf, wf, bias, 1, qlo, d_out, sums, act)
    assert LAUNCHES["conv3d_k3s1_chain_tc"] == before
    assert not fwd_uses_tensor_cores(torch.float32, 1, cin, cout)


def test_conv_fwd_tc_rule_matches_c(dev):
    """The C dispatch's rule (``hvc_conv3d_k3_fwd_tc``, which the wrapper
    counts tensor-core launches by) is ``fwd_uses_tensor_cores`` at every
    dtype, stride and channel count around its edges."""
    rule = _build.function("hvc_conv3d_k3_fwd_tc", (ctypes.c_int,) * 4)
    for (dtype, code), stride, cin, cout in itertools.product(
            ((torch.float32, 0), (torch.bfloat16, 1)), (1, 2), (1, 4, 7, 8, 9, 64, 256),
            (1, 4, 7, 8, 9, 64, 256)):
        assert bool(rule(stride, cin, cout, code)) == fwd_uses_tensor_cores(dtype, stride, cin,
                                                                             cout)


@pytest.mark.parametrize("shape", [(1, 64, 32, _R, _R, _R, 1, _R, True, None),
                                   (1, 64, 32, 34, _R, _R, 0, 32, True, "gelu")])
def test_conv_tensor_cores_sums_bitwise(dev, shape):
    """Two runs of the hot 64→32 chain conv's Σ/Σ² give the same bits."""
    b, cin, cout, nv, h, w_, qlo, d_out, sums, act = shape
    x, w, bias = _fwd_case(shape, torch.bfloat16, dev, 50)
    first = conv3d_k3(x, w, bias, 1, qlo, d_out, True, act)
    again = conv3d_k3(x, w, bias, 1, qlo, d_out, True, act)
    torch.cuda.synchronize()
    assert all(torch.equal(a, c) for a, c in zip(first, again))


# (BH, Nq, Nk, d) of the flash forward on the main path (chip_smoke.py
# KERNELS["flash_attention"] and _FLASH_TRAIN_SHAPES) and ragged: Nq and Nk
# not multiples of the 64-row and 64-key tiles, one query, one key.
FLASH_MAIN = [(4, 4096, 4096, 64), (4, 4096, 256, 64), (8, 4096, 4096, 32), (8, 4096, 1024, 32),
              (8, 32768, 32768, 32), (8, 32768, 4096, 32), (32, 4096, 4096, 64),
              (32, 4096, 256, 64), (16, 4096, 4096, 32), (16, 4096, 1024, 32)]
FLASH_RAGGED = [(3, 200, 77, 32), (3, 200, 77, 64), (2, 130, 4100, 32), (2, 65, 63, 64),
                (1, 1, 1, 32), (2, 1000, 129, 64)]


@pytest.mark.parametrize("bh,nq,nk,d", FLASH_MAIN + FLASH_RAGGED)
def test_flash_tensor_cores_match_plain(dev, bh, nq, nk, d):
    """The tensor-core flash forward (bf16) against its plain version, out
    within FLASH_OUT_TOL and lse (fp32 from the same bf16 inputs on both
    sides) within the fp32 one, counted in flash_attention_tc; the fp32 call
    stays on the CUDA cores."""
    q, k, v = (_randn((bh, n, d), torch.bfloat16, dev, s) for s, n in ((0, nq), (1, nk), (2, nk)))
    scale = d ** -0.5
    before = (flash_attention_fwd.launches, flash_attention_fwd.tc_launches)
    out, lse = flash_attention_fwd(q, k, v, scale)
    assert (flash_attention_fwd.launches, flash_attention_fwd.tc_launches) == \
        (before[0] + 1, before[1] + 1)
    want_out, want_lse = flash_attention_plain(q, k, v, scale)
    _close(out, want_out, torch.bfloat16, FLASH_OUT_TOL)
    _close(lse, want_lse, torch.float32)
    if nq * nk <= 4096 * 4096:
        qf, kf, vf = (t.float() for t in (q, k, v))
        flash_attention_fwd(qf, kf, vf, scale)
        assert flash_attention_fwd.tc_launches == before[1] + 1


@pytest.mark.parametrize("bh,nq,nk,d", [(8, 4096, 4096, 32), (4, 4096, 256, 64)] + FLASH_RAGGED[:4])
def test_flash_bwd_from_tensor_core_forward(dev, bh, nq, nk, d):
    """D, L and M take the tensor-core forward's out and lse (bf16) and stay
    within the bf16 tolerance of the plain backward given the same ones."""
    q, dout = (_randn((bh, nq, d), torch.bfloat16, dev, s) for s in (0, 3))
    k, v = (_randn((bh, nk, d), torch.bfloat16, dev, s) for s in (1, 2))
    scale = d ** -0.5
    before = flash_attention_fwd.tc_launches, flash_attention_bwd.tc_launches
    out, lse = flash_attention_fwd(q, k, v, scale)
    assert flash_attention_fwd.tc_launches == before[0] + 1
    want = flash_attention_bwd_plain(q, k, v, out, lse, dout, scale)
    for got in (flash_attention_bwd(q, k, v, out, lse, dout, scale),
                flash_attention_bwd_split(q, k, v, out, lse, dout, scale)):
        for g, w in zip(got, want):
            _close(g, w, torch.bfloat16)
    assert flash_attention_bwd.tc_launches == before[1] + 1  # D on the tensor cores


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("bh,nq,nk,d", [(8, 32768, 32768, 32), (3, 200, 77, 32), (3, 200, 77, 64),
                                        (2, 130, 4100, 32)])
def test_flash_bwd_bitwise_repeatable(dev, dtype, bh, nq, nk, d):
    """Kernel D sums dq in a fixed order (per-group partials, added in group
    order; no atomics): two runs give the same bits, at the stage-3 self-
    attention shape and at ragged ones."""
    q, dout = (_randn((bh, nq, d), dtype, dev, s) for s in (0, 3))
    k, v = (_randn((bh, nk, d), dtype, dev, s) for s in (1, 2))
    scale = d ** -0.5
    out, lse = flash_attention_fwd(q, k, v, scale)
    first = flash_attention_bwd(q, k, v, out, lse, dout, scale)
    again = flash_attention_bwd(q, k, v, out, lse, dout, scale)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, again))


def _ds_rounding(q, k, v, dout, scale):
    """A floor for the scale of dq and dk, tied to the inputs: where ds =
    p·(dp − delta) cancels (one key: p = 1, dp = delta), they are rounding
    alone. dp and delta each sum d ≤ 64 fp32 products of size up to
    ‖dout‖·‖v‖ (largest rows), in another order on the two sides, so they
    differ by at most 2·d·2^-24 < 2^-16 of that; dq and dk carry it by one
    product with k or q and the scale. At the long shapes this is ~1e-3,
    far under their max|want| of ~0.1."""
    def rows(t):
        return float(t.float().norm(dim=-1).max())
    big = max(float(q.float().abs().max()), float(k.float().abs().max()))
    return 2.0 ** -16 * rows(dout) * rows(v) * big * scale


@pytest.mark.parametrize("bh,nq,nk,d", FLASH_MAIN + FLASH_RAGGED)
def test_flash_bwd_tensor_cores_match_plain(dev, bh, nq, nk, d):
    """The tensor-core D (bf16) against its plain version at the main path's
    shapes and ragged ones: dq, dk and dv within FLASH_OUT_TOL (at 32,768
    keys the gradients are ~0.1, where TOL's absolute part would be loose; D
    rounds p and ds to bf16 before their products, as the TPU kernel does),
    its scale no lower than the rounding of ds (``_ds_rounding``: at one
    key dq and dk are rounding alone, max|want| may be 0), counted in
    flash_attention_bwd.tc_launches; the fp32 call stays on the CUDA
    cores."""
    q, dout = (_randn((bh, nq, d), torch.bfloat16, dev, s) for s in (0, 3))
    k, v = (_randn((bh, nk, d), torch.bfloat16, dev, s) for s in (1, 2))
    scale = d ** -0.5
    out, lse = flash_attention_plain(q, k, v, scale)
    before = (flash_attention_bwd.launches, flash_attention_bwd.tc_launches)
    got = flash_attention_bwd(q, k, v, out, lse, dout, scale)
    assert (flash_attention_bwd.launches, flash_attention_bwd.tc_launches) == \
        (before[0] + 1, before[1] + 1)
    want = flash_attention_bwd_plain(q, k, v, out, lse, dout, scale)
    floor = _ds_rounding(q, k, v, dout, scale)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == torch.bfloat16
        _close(g, w, torch.bfloat16, FLASH_OUT_TOL, floor)
    if nq * nk <= 4096 * 4096:
        f32 = [t.float() for t in (q, k, v, out)]
        flash_attention_bwd(*f32, lse, dout.float(), scale)
        assert flash_attention_bwd.tc_launches == before[1] + 1


# (BH, Nq, Nk, d) of the training shapes (chip_smoke.py _FLASH_TRAIN_SHAPES)
FLASH_TRAIN = [(32, 4096, 4096, 64), (32, 4096, 256, 64), (16, 4096, 4096, 32),
               (16, 4096, 1024, 32), (8, 32768, 32768, 32), (8, 32768, 4096, 32)]


@pytest.mark.parametrize("bh,nq,nk,d", FLASH_TRAIN + FLASH_RAGGED)
def test_flash_bwd_tensor_cores_bitwise(dev, bh, nq, nk, d):
    """Two runs of the tensor-core D give the same bits at every training
    shape: its dq adds go into one fp32 accumulator in key-tile order."""
    q, dout = (_randn((bh, nq, d), torch.bfloat16, dev, s) for s in (4, 7))
    k, v = (_randn((bh, nk, d), torch.bfloat16, dev, s) for s in (5, 6))
    scale = d ** -0.5
    out, lse = flash_attention_fwd(q, k, v, scale)
    first = flash_attention_bwd(q, k, v, out, lse, dout, scale)
    again = flash_attention_bwd(q, k, v, out, lse, dout, scale)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, again))


def test_flash_bwd_tc_rule_matches_c(dev):
    """The C dispatch's rule (``hvc_flash_attention_bwd_tc``, which the
    wrapper sizes its scratch and counts launches by) is
    ``bwd_uses_tensor_cores``."""
    rule = _build.function("hvc_flash_attention_bwd_tc", (ctypes.c_int,))
    for dtype, code in ((torch.float32, 0), (torch.bfloat16, 1)):
        assert bool(rule(code)) == bwd_uses_tensor_cores(dtype)


# Stride-2 conv shapes of the main path (chip_smoke.py KERNELS["conv3d_k3s2"]
# and CHAIN_KERNELS["conv3d_k3s2_chain"]) as the chain call, (B, Cin, Cout,
# planes of x, H, W, slab plane of x's first plane, output planes, Σ/Σ², act),
# and ragged ones that reach the tensor cores: Cin 8 / 24 / 40 (not a
# multiple of the 16-channel chunk), Cout 8 / 40 / 72 (not a multiple of the
# 64-channel tile), odd H and W, W not a multiple of 8 (element-by-element
# staging), x beginning before the slab, every option.
_S2_MAIN_DENSE = [(1, 1, 64, 64, 64, 64, 1, 32, False, None), (1, 64, 128, 32, 32, 32, 1, 16, False, None),
                  (1, 32, 64, 128, 128, 128, 1, 64, False, None),
                  (1, 64, 128, 64, 64, 64, 1, 32, False, None),
                  (1, 128, 256, 32, 32, 32, 1, 16, False, None),
                  (1, 32, 64, _R, _R, _R, 1, 128, False, None),
                  (1, 64, 128, 128, 128, 128, 1, 64, False, None),
                  (1, 128, 256, 64, 64, 64, 1, 32, False, None)]
_S2_MAIN_CHAIN = [(1, 32, 64, 33, _R, _R, 0, 16, True, None), (1, 32, 64, 32, _R, _R, 1, 16, True, None),
                  (1, 32, 64, 33, _R, _R, 0, 16, True, "gelu"), (2, 32, 64, 33, _R, _R, 0, 16, True, None),
                  (1, 32, 64, _R, _R, _R, 1, 128, True, None)]
TC_S2_CASES = [(1, 8, 40, 6, 5, 12, 0, 2, True, "gelu"), (2, 24, 8, 7, 9, 33, 0, 3, True, "silu"),
               (1, 40, 72, 7, 9, 35, 1, 4, True, None), (2, 16, 64, 9, 11, 40, 2, 4, False, "gelu"),
               (1, 24, 40, 5, 6, 16, -1, 3, True, "silu")]


def _conv_s2_check(shape, dev, dense):
    """The stride-2 conv in bf16 against its plain version, counted on the
    instance ``fwd_uses_tensor_cores`` (or, with one input channel,
    ``fwd_c1in_uses_tensor_cores``) names, Σ/Σ² bitwise over two runs."""
    b, cin, cout, nv, h, w_, qlo, d_out, sums, act = shape
    dt = torch.bfloat16
    x, w, bias = _fwd_case(shape, dt, dev, 60)
    tc = "conv3d_k3s2_tc" if dense else "conv3d_k3s2_chain_tc"
    before, before_c1in = LAUNCHES[tc], LAUNCHES["conv3d_k3s2_c1in_tc"]
    res = conv3d_k3(x, w, bias, 2, qlo, d_out, sums, act, dense=dense)
    assert LAUNCHES[tc] == before + fwd_uses_tensor_cores(dt, 2, cin, cout)
    assert LAUNCHES["conv3d_k3s2_c1in_tc"] == before_c1in + fwd_c1in_uses_tensor_cores(
        dt, 2, cin, cout)
    want = conv3d_k3_plain(x, w, bias, 2, qlo, d_out, sums, act)
    out = res[0] if sums else res
    _close(out, want[0] if sums else want, dt)
    if sums:
        _check_sums(out, res[1], res[2])
        again = conv3d_k3(x, w, bias, 2, qlo, d_out, True, act)
        torch.cuda.synchronize()
        assert all(torch.equal(a, c) for a, c in zip(res, again))


@pytest.mark.parametrize("shape", _S2_MAIN_DENSE)
def test_conv_s2_tensor_cores_main_path_dense(dev, shape):
    """Kernel C at the main path's dense shapes, bf16: the Cin ≥ 8, Cout ≥ 8
    calls on the tensor cores, the 1→64 stem on the one-input-channel
    tensor cores."""
    _conv_s2_check(shape, dev, dense=True)


@pytest.mark.parametrize("shape", _S2_MAIN_CHAIN)
def test_conv_s2_tensor_cores_main_path_chain(dev, shape):
    """Kernel I at the streamed chains' shapes, its Σ/Σ² bitwise repeatable."""
    _conv_s2_check(shape, dev, dense=False)


@pytest.mark.parametrize("case", TC_S2_CASES)
def test_conv_s2_tensor_cores_ragged(dev, case):
    """The stride-2 tensor-core conv at ragged shapes with every chain
    option; the fp32 call stays on the CUDA cores."""
    b, cin, cout, nv, h, w_, qlo, d_out, sums, act = case
    _conv_s2_check(case, dev, dense=False)
    xf, wf, bias = _fwd_case(case, torch.float32, dev, 61)
    before = LAUNCHES["conv3d_k3s2_chain_tc"]
    conv3d_k3(xf, wf, bias, 2, qlo, d_out, sums, act)
    assert LAUNCHES["conv3d_k3s2_chain_tc"] == before


# The stride-2 data gradient F/J on the tensor cores, at the main path's
# shapes that take them (chip_smoke.py _S2_GRAD_SHAPES with Cin ≥ 8 and
# CHAIN_SHAPES_S2, as the chain call: (B, Cin, Cout, planes of x, H, W, slab
# plane of x's first plane, output planes, act)) and ragged ones: Cin over a
# 32-channel tile, Cout not a multiple of 16, odd H and W, W not a multiple
# of 16 (element-by-element staging), x beginning before the slab (qlo −1 to
# 2), act′ gelu and silu.
_DGRAD_S2_MAIN_DENSE = [(8, 64, 128, 32, 32, 32, 1, 16, None), (2, 32, 64, 128, 128, 128, 1, 64, None),
                        (2, 64, 128, 64, 64, 64, 1, 32, None), (2, 128, 256, 32, 32, 32, 1, 16, None),
                        (1, 32, 64, _R, _R, _R, 1, 128, None), (1, 64, 128, 128, 128, 128, 1, 64, None),
                        (1, 128, 256, 64, 64, 64, 1, 32, None)]
_DGRAD_S2_MAIN_CHAIN = [(1, 32, 64, 33, _R, _R, 0, 16, None), (1, 32, 64, 32, _R, _R, 1, 16, None),
                        (1, 32, 64, 33, _R, _R, 0, 16, "gelu"), (2, 32, 64, 33, _R, _R, 0, 16, None),
                        (1, 32, 64, _R, _R, _R, 1, 128, None)]
_DGRAD_S2_RAGGED = [(2, 8, 40, 4, 6, 10, 2, 3, "silu"), (1, 8, 40, 6, 5, 12, 0, 2, "gelu"),
                    (1, 24, 8, 5, 6, 6, -1, 2, None), (1, 40, 72, 7, 9, 35, 1, 4, "silu"),
                    (2, 16, 64, 9, 11, 40, 2, 4, "gelu"), (1, 33, 17, 7, 16, 32, -1, 4, "gelu"),
                    (1, 8, 8, 3, 16, 16, 1, 2, None)]


def _dgrad_s2_check(shape, dev, dense):
    """F/J in bf16 against its plain version within chip_smoke.py's gradient
    tolerance (TOL with its absolute part scaled by max(1, max|want|)),
    counted on its tensor-core instance, two runs bitwise equal; the same
    call in fp32 stays on the CUDA cores."""
    b, cin, cout, nv, h, w_, qlo, d_out, act = shape
    x = _randn((b, cin, nv + 2, h, w_), torch.bfloat16, dev, 70).narrow(2, 1, nv)
    if dense:
        x = x.contiguous()
    w = (_randn((cout, cin, 3, 3, 3), torch.float32, dev, 71) / (27 * cin) ** 0.5).bfloat16()
    g = _randn((b, cout, d_out, (h - 1) // 2 + 1, (w_ - 1) // 2 + 1), torch.bfloat16, dev, 72)
    tc = "conv3d_k3s2_dgrad_tc" if dense else "conv3d_k3s2_chain_dgrad_tc"
    before = LAUNCHES[tc]
    dx = conv3d_k3_dgrad(g, w, x, 2, qlo, act, dense=dense)
    assert LAUNCHES[tc] == before + 1
    assert dgrad_s2_instance(torch.bfloat16, cin, cout, act is not None) == DGRAD_S2_TC
    want = conv3d_k3_dgrad_plain(g, w, x, 2, qlo, act)
    _close(dx, want, torch.bfloat16, floor=0.0,
           tol={torch.bfloat16: (2e-2 * max(1.0, float(want.float().abs().max())), 2e-2)})
    assert torch.equal(conv3d_k3_dgrad(g, w, x, 2, qlo, act, dense=dense), dx)
    if b * cin * nv * h * w_ <= 2**24:
        conv3d_k3_dgrad(g.float(), w.float(), x.float(), 2, qlo, act, dense=dense)
        assert LAUNCHES[tc] == before + 2


@pytest.mark.parametrize("shape", _DGRAD_S2_MAIN_DENSE)
def test_dgrad_s2_tensor_cores_main_path_dense(dev, shape):
    """Kernel F at the main path's dense shapes with Cin ≥ 8, bf16."""
    _dgrad_s2_check(shape, dev, dense=True)


@pytest.mark.parametrize("shape", _DGRAD_S2_MAIN_CHAIN + _DGRAD_S2_RAGGED)
def test_dgrad_s2_tensor_cores_chain(dev, shape):
    """Kernel J at the streamed chains' shapes and at ragged ones."""
    _dgrad_s2_check(shape, dev, dense=False)


# The token stems of configs/progressive_h200.json (voxel_dim 512: in → 128 →
# 256 → 512, Cout tiled by 64 on C/I's tensor cores), each at its stage's
# batch with D cut to 8 planes and the widths and H, W kept: stage 3 from
# 256³ (batch 2), stage 2 from 128³ (batch 4), stage 1's 1→128 from 64³
# (batch 8, whose dx takes F's CUDA cores: the one-dx-channel instance stops
# at Cout 64). (B, Cin, Cout, D, H, W)
H200_STEM = [(2, 32, 128, 8, 256, 256), (2, 128, 256, 8, 128, 128), (2, 256, 512, 8, 64, 64),
             (4, 32, 128, 8, 128, 128), (4, 128, 256, 8, 64, 64), (4, 256, 512, 8, 32, 32),
             (8, 1, 128, 8, 64, 64)]


@pytest.mark.parametrize("dense", [True, False])
@pytest.mark.parametrize("shape", H200_STEM)
def test_h200_stem_s2_matches_plain(dev, shape, dense):
    """C, F and G (``dense``) or I, J and K (the chain call from slab plane
    0 over D + 1 planes, Σ/Σ² and the gelu prologue) at the h200 stems'
    widths in bf16, each on the instance its rule names, against its plain
    version (the tolerances of the main-path tests above)."""
    b, cin, cout, d, h, w_ = shape
    if cin == 1 and not dense:
        pytest.skip("the 1→128 stem runs dense only")
    nv, qlo, sums, act = (d, 1, False, None) if dense else (d + 1, 0, True, "gelu")
    _conv_s2_check((b, cin, cout, nv, h, w_, qlo, d // 2, sums, act), dev, dense)
    dt = torch.bfloat16
    x = _randn((b, cin, nv, h, w_), dt, dev, 73)
    w = (_randn((cout, cin, 3, 3, 3), torch.float32, dev, 74) / (27 * cin) ** 0.5).to(dt)
    g = _randn((b, cout, d // 2, h // 2, w_ // 2), dt, dev, 75)
    tc = "conv3d_k3s2_dgrad_tc" if dense else "conv3d_k3s2_chain_dgrad_tc"
    before = LAUNCHES[tc]
    dx = conv3d_k3_dgrad(g, w, x, 2, qlo, act, dense=dense)
    on_tc = dgrad_s2_instance(dt, cin, cout, act is not None) == DGRAD_S2_TC
    assert LAUNCHES[tc] == before + on_tc
    want = conv3d_k3_dgrad_plain(g, w, x, 2, qlo, act)
    _close(dx, want, dt, tol={dt: (2e-2 * max(1.0, float(want.float().abs().max())), 2e-2)})
    counter = {WGRAD_TC: "conv3d_k3s2_wgrad_tc", WGRAD_C1IN_S2_TC: "conv3d_k3s2_wgrad_c1in_tc"}[
        wgrad_instance(dt, 2, cin)]
    before = LAUNCHES[counter]
    dw = conv3d_k3_wgrad(x, g, 2, qlo, act, dense=dense)
    assert LAUNCHES[counter] == before + 1
    want = conv3d_k3_wgrad_plain(x, g, 2, qlo, act)
    err = (dw - want).abs()
    assert bool((err <= 1e-4 * want.abs().max() + 1e-4 * want.abs()).all()), float(err.max())


def test_dgrad_s2_tc_rule_matches_c(dev):
    """The C dispatch's rule (``hvc_conv3d_k3s2_dgrad_tc``, which the
    wrapper counts launches on either tensor-core instance by) is
    ``dgrad_s2_instance`` at every dtype, channel count around its edges and
    act′ setting."""
    rule = _build.function("hvc_conv3d_k3s2_dgrad_tc", (ctypes.c_int,) * 4)
    for (dtype, code), cin, cout, dact in itertools.product(
            ((torch.float32, 0), (torch.bfloat16, 1)), (1, 2, 4, 7, 8, 9, 64, 256),
            (1, 4, 7, 8, 9, 63, 64, 65, 256), (0, 1, 2)):
        assert rule(cin, cout, dact, code) == dgrad_s2_instance(dtype, cin, cout, dact != 0)


@pytest.mark.parametrize("bh,nq,nk,d", FLASH_TRAIN + FLASH_RAGGED)
def test_flash_bwd_dkv_tensor_cores(dev, bh, nq, nk, d):
    """The tensor-core M (bf16) at the training shapes and ragged ones: dk and
    dv within FLASH_OUT_TOL of the plain backward (floored by the rounding of
    ds, as D's test), counted in flash_attention_bwd_dkv.tc_launches, two runs
    bitwise equal and bitwise D's dk and dv (the same body without the dq
    phase); the fp32 call stays on the CUDA cores."""
    q, dout = (_randn((bh, nq, d), torch.bfloat16, dev, s) for s in (8, 11))
    k, v = (_randn((bh, nk, d), torch.bfloat16, dev, s) for s in (9, 10))
    scale = d ** -0.5
    out, lse = flash_attention_fwd(q, k, v, scale)
    before = (flash_attention_bwd_dkv.launches, flash_attention_bwd_dkv.tc_launches)
    got = flash_attention_bwd_dkv(q, k, v, out, lse, dout, scale)
    assert (flash_attention_bwd_dkv.launches, flash_attention_bwd_dkv.tc_launches) == \
        (before[0] + 1, before[1] + 1)
    want = flash_attention_bwd_plain(q, k, v, out, lse, dout, scale)[1:]
    floor = _ds_rounding(q, k, v, dout, scale)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == torch.bfloat16
        _close(g, w, torch.bfloat16, FLASH_OUT_TOL, floor)
    again = flash_attention_bwd_dkv(q, k, v, out, lse, dout, scale)
    fused = flash_attention_bwd(q, k, v, out, lse, dout, scale)[1:]
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert all(torch.equal(a, b) for a, b in zip(got, fused))
    if nq * nk <= 4096 * 4096:
        f32 = [t.float() for t in (q, k, v, out)]
        flash_attention_bwd_dkv(*f32, lse, dout.float(), scale)
        assert flash_attention_bwd_dkv.tc_launches == before[1] + 2


def test_flash_bwd_dkv_tc_rule_matches_c(dev):
    """The C dispatch's rule (``hvc_flash_attention_bwd_dkv_tc``) is
    ``bwd_dkv_uses_tensor_cores``."""
    rule = _build.function("hvc_flash_attention_bwd_dkv_tc", (ctypes.c_int,))
    for dtype, code in ((torch.float32, 0), (torch.bfloat16, 1)):
        assert bool(rule(code)) == bwd_dkv_uses_tensor_cores(dtype)


@pytest.mark.parametrize("bh,nq,nk,d", FLASH_TRAIN + FLASH_RAGGED)
def test_flash_bwd_dq_tensor_cores(dev, bh, nq, nk, d):
    """The tensor-core L (bf16) at the training shapes and ragged ones: dq
    within FLASH_OUT_TOL of the plain backward (floored by the rounding of
    ds, as D's test: L rounds ds to bf16 before dS·K, as the TPU kernel
    does), counted in flash_attention_bwd_dq.tc_launches, two runs bitwise
    equal (one writer a row, no atomics); the fp32 call stays on the CUDA
    cores."""
    q, dout = (_randn((bh, nq, d), torch.bfloat16, dev, s) for s in (12, 15))
    k, v = (_randn((bh, nk, d), torch.bfloat16, dev, s) for s in (13, 14))
    scale = d ** -0.5
    out, lse = flash_attention_fwd(q, k, v, scale)
    before = (flash_attention_bwd_dq.launches, flash_attention_bwd_dq.tc_launches)
    got = flash_attention_bwd_dq(q, k, v, out, lse, dout, scale)
    assert (flash_attention_bwd_dq.launches, flash_attention_bwd_dq.tc_launches) == \
        (before[0] + 1, before[1] + 1)
    want = flash_attention_bwd_plain(q, k, v, out, lse, dout, scale)[0]
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    _close(got, want, torch.bfloat16, FLASH_OUT_TOL, _ds_rounding(q, k, v, dout, scale))
    again = flash_attention_bwd_dq(q, k, v, out, lse, dout, scale)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    if nq * nk <= 4096 * 4096:
        f32 = [t.float() for t in (q, k, v, out)]
        flash_attention_bwd_dq(*f32, lse, dout.float(), scale)
        assert flash_attention_bwd_dq.tc_launches == before[1] + 2


def test_flash_bwd_dq_tc_rule_matches_c(dev):
    """The C dispatch's rule (``hvc_flash_attention_bwd_dq_tc``) is
    ``bwd_dq_uses_tensor_cores``."""
    rule = _build.function("hvc_flash_attention_bwd_dq_tc", (ctypes.c_int,))
    for dtype, code in ((torch.float32, 0), (torch.bfloat16, 1)):
        assert bool(rule(code)) == bwd_dq_uses_tensor_cores(dtype)


# The one-output-channel data gradient at ragged shapes, as the chain call
# (B, Cin, Cout, planes of x, H, W, slab plane of x's first plane, output
# planes, Σ/Σ², act) of the forward conv with Cin = 1: g's channels 8, 24, 40
# and 64 (not all multiples of 16), H and W off the 4 × 64 tile, W not a
# multiple of 8 (element-by-element staging), x beginning before the slab,
# more planes than a block's 32, act′ gelu and silu.
C1_CASES = [(1, 1, 8, 35, 9, 66, 1, 35, False, None), (2, 1, 40, 5, 6, 20, -1, 7, False, "gelu"),
            (1, 1, 24, 4, 5, 70, 2, 3, False, "silu"), (1, 1, 64, 6, 7, 33, 0, 5, False, "gelu"),
            (2, 1, 32, 40, 4, 64, 1, 40, False, None)]


@pytest.mark.parametrize("case", C1_CASES)
def test_dgrad_c1_tensor_cores_ragged(dev, case):
    """The one-output-channel tensor-core instance (bf16) within
    chip_smoke.py's gradient tolerance of the plain data gradient, counted in
    conv3d_k3s1_chain_dgrad_c1_tc, two runs bitwise equal; the fp32 call
    stays on the CUDA cores."""
    b, cin, cout, nv, h, w_, qlo, d_out, sums, act = case
    _conv_fwd_and_dgrad(case, dev, dense=False)
    x, w, _ = _fwd_case(case, torch.bfloat16, dev, 80)
    g = _randn((b, cout, d_out, h, w_), torch.bfloat16, dev, 81)
    first = conv3d_k3_dgrad(g, w, x, 1, qlo, act)
    assert torch.equal(conv3d_k3_dgrad(g, w, x, 1, qlo, act), first)
    before = LAUNCHES["conv3d_k3s1_chain_dgrad_c1_tc"]
    conv3d_k3_dgrad(g.float(), w.float(), x.float(), 1, qlo, act)
    assert LAUNCHES["conv3d_k3s1_chain_dgrad_c1_tc"] == before
    assert dgrad_c1_uses_tensor_cores(torch.bfloat16, cout, cin)


def test_dgrad_c1_tc_rule_matches_c(dev):
    """The C dispatch's rule (``hvc_conv3d_k3s1_c1_tc``, which the wrapper
    counts launches by) is ``dgrad_c1_uses_tensor_cores`` at every dtype,
    channel count around its edges, prologue and Σ/Σ² setting."""
    rule = _build.function("hvc_conv3d_k3s1_c1_tc", (ctypes.c_int,) * 5)
    for (dtype, code), cin, cout, (act, act_code), sums in itertools.product(
            ((torch.float32, 0), (torch.bfloat16, 1)), (1, 4, 7, 8, 9, 32, 64, 65, 256),
            (1, 2, 8, 64), ((None, 0), ("gelu", 1), ("silu", 2)), (False, True)):
        assert bool(rule(cin, cout, act_code, int(sums), code)) == \
            dgrad_c1_uses_tensor_cores(dtype, cin, cout, act, sums)


# The one-input-channel instances at the main path's shapes (chip_smoke.py
# KERNELS, TRAIN_KERNELS and CHAIN_KERNELS with Cin = 1), as the chain call
# (B, Cin, Cout, planes of x, H, W, slab plane of x's first plane, output
# planes, Σ/Σ², act): 1→32 and 1→64 over 256³ (dense: qlo 1, no options),
# 1→32 over 128³ (stage 2's upsample conv, batch 1 forward, batch 2
# training), the training slabs of both chains' stats and store passes, and
# the eval chains over the whole volume with Σ/Σ².
C1IN_MAIN = [(1, 1, 32, _R, _R, _R, 1, _R, False, None), (1, 1, 64, _R, _R, _R, 1, _R, False, None),
             (1, 1, 32, 128, 128, 128, 1, 128, False, None),
             (2, 1, 32, 128, 128, 128, 1, 128, False, None),
             (1, 1, 64, 34, _R, _R, 0, 32, True, None), (1, 1, 64, 33, _R, _R, 1, 32, True, None),
             (1, 1, 64, 36, _R, _R, 0, 34, False, None), (1, 1, 32, 34, _R, _R, 0, 32, True, None),
             (1, 1, 32, 35, _R, _R, 0, 33, False, None), (1, 1, 64, _R, _R, _R, 1, _R, True, None),
             (1, 1, 32, _R, _R, _R, 1, _R, True, None)]
# Ragged: Cout 8 / 40 / 96 (masked Cout tiles of 32 and 64, two tiles), H and
# W off the 4 × 64 and 2 × 2 × 64 tiles, W not a multiple of 8 (element-wise
# copies and stores), x before the slab and inside it, every option.
C1IN_RAGGED = [(1, 1, 8, 5, 6, 70, -1, 7, True, "gelu"), (2, 1, 40, 6, 5, 33, 2, 6, True, "silu"),
               (1, 1, 96, 9, 4, 64, 0, 9, True, None), (1, 1, 64, 4, 9, 130, 1, 4, False, "gelu"),
               (2, 1, 32, 7, 7, 24, 0, 6, False, None)]


def _c1in_check(shape, dev, seed):
    """The one-input-channel conv (values, Σ/Σ² bitwise over two runs) and
    its weight gradient (bitwise over two runs) in bf16 against their plain
    versions, each counted on its one-input-channel counter; the forward at
    TOL, dW at chip_smoke.py's gradient tolerance (fp32 1e-4, the absolute
    part scaled by the largest |want|: sums over up to 16.7 M voxels)."""
    b, cin, cout, nv, h, w_, qlo, d_out, sums, act = shape
    dense = qlo == 1 and nv == d_out and not sums and act is None
    dt = torch.bfloat16
    x, w, bias = _fwd_case(shape, dt, dev, seed)
    counter = "conv3d_k3s1_c1in_tc" if dense else "conv3d_k3s1_chain_c1in_tc"
    before = LAUNCHES[counter]
    res = conv3d_k3(x, w, bias, 1, qlo, d_out, sums, act, dense=dense)
    assert LAUNCHES[counter] == before + 1
    want = conv3d_k3_plain(x, w, bias, 1, qlo, d_out, sums, act)
    out = res[0] if sums else res
    _close(out, want[0] if sums else want, dt)
    if sums:
        _check_sums(out, res[1], res[2])
        again = conv3d_k3(x, w, bias, 1, qlo, d_out, sums, act, dense=dense)
        assert all(torch.equal(a, c) for a, c in zip(res, again))
    del res, want
    g = _randn((b, cout, d_out, h, w_), dt, dev, seed + 5)
    before = LAUNCHES["conv3d_k3s1_wgrad_c1in_tc"]
    dw = conv3d_k3_wgrad(x, g, 1, qlo, act, dense=dense)
    assert LAUNCHES["conv3d_k3s1_wgrad_c1in_tc"] == before + 1
    want = conv3d_k3_wgrad_plain(x, g, 1, qlo, act)
    torch.cuda.synchronize()
    err = (dw - want).abs()
    assert torch.isfinite(dw).all()
    assert bool((err <= 1e-4 * want.abs().max() + 1e-4 * want.abs()).all()), float(err.max())
    assert torch.equal(conv3d_k3_wgrad(x, g, 1, qlo, act, dense=dense), dw)


@pytest.mark.parametrize("shape", C1IN_MAIN)
def test_c1in_tensor_cores_main_path(dev, shape):
    """The one-input-channel forward and weight gradient at every bf16
    Cin = 1 shape of the main path."""
    _c1in_check(shape, dev, 90)


@pytest.mark.parametrize("case", C1IN_RAGGED)
def test_c1in_tensor_cores_ragged(dev, case):
    """The one-input-channel instances at ragged shapes, and the same calls
    in fp32 on the CUDA cores (GRAD_TOL)."""
    _c1in_check(case, dev, 91)
    b, cin, cout, nv, h, w_, qlo, d_out, sums, act = case
    x, w, bias = _fwd_case(case, torch.float32, dev, 92)
    g = _randn((b, cout, d_out, h, w_), torch.float32, dev, 93)
    before = (LAUNCHES["conv3d_k3s1_chain_c1in_tc"], LAUNCHES["conv3d_k3s1_wgrad_c1in_tc"])
    res = conv3d_k3(x, w, bias, 1, qlo, d_out, sums, act)
    dw = conv3d_k3_wgrad(x, g, 1, qlo, act)
    assert (LAUNCHES["conv3d_k3s1_chain_c1in_tc"], LAUNCHES["conv3d_k3s1_wgrad_c1in_tc"]) == before
    want = conv3d_k3_plain(x, w, bias, 1, qlo, d_out, sums, act)
    _close(res[0] if sums else res, want[0] if sums else want, torch.float32)
    _close(dw, conv3d_k3_wgrad_plain(x, g, 1, qlo, act), torch.float32, GRAD_TOL)


@pytest.mark.parametrize("act", [None, "gelu"])
def test_c1in_rule_excludes_dact(dev, act):
    """The data gradient of a conv with one output channel is the forward on
    g with one input channel: without act′ it takes the one-input-channel
    instance, with act′ (a fused prologue) the CUDA cores; both match the
    plain data gradient."""
    b, cin, nv, h, w_, qlo = 1, 24, 6, 5, 40, 0
    x = _randn((b, cin, nv + 2, h, w_), torch.bfloat16, dev, 94).narrow(2, 1, nv)
    w = (_randn((1, cin, 3, 3, 3), torch.float32, dev, 95) / (27 * cin) ** 0.5).to(torch.bfloat16)
    g = _randn((b, 1, nv, h, w_), torch.bfloat16, dev, 96)
    before = LAUNCHES["conv3d_k3s1_chain_c1in_tc"]
    dx = conv3d_k3_dgrad(g, w, x, 1, qlo, act)
    assert LAUNCHES["conv3d_k3s1_chain_c1in_tc"] == before + (act is None)
    assert fwd_c1in_uses_tensor_cores(torch.bfloat16, 1, 1, cin, act is not None) is (act is None)
    want = conv3d_k3_dgrad_plain(g, w, x, 1, qlo, act)
    torch.cuda.synchronize()
    err = (dx.float() - want.float()).abs()
    scale = max(1.0, float(want.float().abs().max()))
    assert bool((err <= 2e-2 * scale + 2e-2 * want.float().abs()).all()), float(err.max())


def test_conv_c1in_tc_rule_matches_c(dev):
    """The C dispatch's rule (``hvc_conv3d_k3s1_c1in_tc``, which the wrapper
    counts launches by) is ``fwd_c1in_uses_tensor_cores`` at every dtype,
    channel count around its edges and act′ setting."""
    rule = _build.function("hvc_conv3d_k3s1_c1in_tc", (ctypes.c_int,) * 4)
    for (dtype, code), cin, cout, dact in itertools.product(
            ((torch.float32, 0), (torch.bfloat16, 1)), (1, 2, 7, 8, 64),
            (1, 4, 7, 8, 9, 32, 33, 64, 65, 256), (0, 1, 2)):
        assert bool(rule(cin, cout, dact, code)) == \
            fwd_c1in_uses_tensor_cores(dtype, 1, cin, cout, dact != 0)


# The stride-2 1→64 stem's forward (one input channel) and data gradient
# (one dx channel) on the tensor cores, as the chain call (B, Cin, Cout,
# planes of x, H, W, slab plane of x's first plane, output planes, Σ/Σ², act):
# stage 1's batch of 8 at 64³ (chip_smoke.py _S2_STEM) and the reconstruct's
# batch of 1; ragged: Cout 8 / 40 / 96 (masked and two Cout tiles, the data
# gradient's K steps 1-4), odd D, H and W, W not a multiple of 16 (element
# by element), x before the slab and inside it, more planes than a block's.
S2_STEM_MAIN = [(8, 1, 64, 64, 64, 64, 1, 32, False, None), (1, 1, 64, 64, 64, 64, 1, 32, False, None)]
S2_STEM_RAGGED = [(2, 1, 8, 5, 6, 10, 1, 3, True, "gelu"), (1, 1, 40, 7, 9, 35, 1, 4, False, None),
                  (1, 1, 96, 6, 9, 64, 0, 3, True, None), (2, 1, 24, 5, 6, 70, -1, 4, True, "silu"),
                  (1, 1, 48, 33, 30, 66, 0, 16, False, None), (8, 1, 64, 20, 17, 13, 1, 10, True, None)]


def _s2_stem_check(shape, dev, seed):
    """The one-input-channel stride-2 conv (values, Σ/Σ² bitwise over two
    runs) and, without act′, the one-dx-channel data gradient (two runs
    bitwise) in bf16 against their plain versions, each counted on its
    tensor-core counter; the data gradient at chip_smoke.py's gradient
    tolerance (TOL with the absolute part scaled by max(1, max|want|))."""
    b, cin, cout, nv, h, w_, qlo, d_out, sums, act = shape
    dense = qlo == 1 and d_out == (nv - 1) // 2 + 1 and not sums and act is None
    dt = torch.bfloat16
    x, w, bias = _fwd_case(shape, dt, dev, seed)
    before = LAUNCHES["conv3d_k3s2_c1in_tc"]
    res = conv3d_k3(x, w, bias, 2, qlo, d_out, sums, act, dense=dense)
    assert LAUNCHES["conv3d_k3s2_c1in_tc"] == before + 1
    want = conv3d_k3_plain(x, w, bias, 2, qlo, d_out, sums, act)
    out = res[0] if sums else res
    _close(out, want[0] if sums else want, dt)
    if sums:
        _check_sums(out, res[1], res[2])
        again = conv3d_k3(x, w, bias, 2, qlo, d_out, sums, act, dense=dense)
        assert all(torch.equal(a, c) for a, c in zip(res, again))
    del res, want
    g = _randn((b, cout, d_out, (h - 1) // 2 + 1, (w_ - 1) // 2 + 1), dt, dev, seed + 5)
    before = LAUNCHES["conv3d_k3s2_dgrad_c1in_tc"]
    dx = conv3d_k3_dgrad(g, w, x, 2, qlo, dense=dense)
    want_tc = dgrad_s2_instance(dt, 1, cout) == DGRAD_S2_C1_TC
    assert LAUNCHES["conv3d_k3s2_dgrad_c1in_tc"] == before + want_tc
    want = conv3d_k3_dgrad_plain(g, w, x, 2, qlo)
    _close(dx, want, dt, floor=0.0,
           tol={dt: (2e-2 * max(1.0, float(want.float().abs().max())), 2e-2)})
    assert torch.equal(conv3d_k3_dgrad(g, w, x, 2, qlo, dense=dense), dx)


@pytest.mark.parametrize("shape", S2_STEM_MAIN)
def test_s2_stem_tensor_cores_main_path(dev, shape):
    """The stem's forward and data gradient at the main path's shapes."""
    _s2_stem_check(shape, dev, 100)


@pytest.mark.parametrize("case", S2_STEM_RAGGED)
def test_s2_stem_tensor_cores_ragged(dev, case):
    """Both instances at ragged shapes (Cout 96 is over the data gradient's
    64 channels: its CUDA cores), and the same calls in fp32 on the CUDA
    cores."""
    _s2_stem_check(case, dev, 101)
    b, cin, cout, nv, h, w_, qlo, d_out, sums, act = case
    x, w, bias = _fwd_case(case, torch.float32, dev, 102)
    g = _randn((b, cout, d_out, (h - 1) // 2 + 1, (w_ - 1) // 2 + 1), torch.float32, dev, 103)
    before = (LAUNCHES["conv3d_k3s2_c1in_tc"], LAUNCHES["conv3d_k3s2_dgrad_c1in_tc"])
    res = conv3d_k3(x, w, bias, 2, qlo, d_out, sums, act)
    dx = conv3d_k3_dgrad(g, w, x, 2, qlo)
    assert (LAUNCHES["conv3d_k3s2_c1in_tc"], LAUNCHES["conv3d_k3s2_dgrad_c1in_tc"]) == before
    want = conv3d_k3_plain(x, w, bias, 2, qlo, d_out, sums, act)
    _close(res[0] if sums else res, want[0] if sums else want, torch.float32)
    _close(dx, conv3d_k3_dgrad_plain(g, w, x, 2, qlo), torch.float32)


@pytest.mark.parametrize("act", [None, "gelu"])
def test_dgrad_s2_c1_rule_excludes_dact(dev, act):
    """With act′ the one-dx-channel data gradient stays on the CUDA cores;
    both match the plain data gradient."""
    b, cout, nv, h, w_, qlo, d_out = 1, 64, 7, 6, 20, 0, 4
    x = _randn((b, 1, nv + 2, h, w_), torch.bfloat16, dev, 104).narrow(2, 1, nv)
    w = (_randn((cout, 1, 3, 3, 3), torch.float32, dev, 105) / 27 ** 0.5).to(torch.bfloat16)
    g = _randn((b, cout, d_out, (h - 1) // 2 + 1, (w_ - 1) // 2 + 1), torch.bfloat16, dev, 106)
    before = LAUNCHES["conv3d_k3s2_dgrad_c1in_tc"]
    dx = conv3d_k3_dgrad(g, w, x, 2, qlo, act)
    assert LAUNCHES["conv3d_k3s2_dgrad_c1in_tc"] == before + (act is None)
    want = conv3d_k3_dgrad_plain(g, w, x, 2, qlo, act)
    _close(dx, want, torch.bfloat16, floor=0.0,
           tol={torch.bfloat16: (2e-2 * max(1.0, float(want.float().abs().max())), 2e-2)})


def test_dgrad_s2_c1_bitwise_repeatable(dev):
    """The one-dx-channel data gradient at the stem's training shape: two
    runs give the same bits (fixed-order sums, one writer per dx element)."""
    b, cout, d = 8, 64, 64
    x = torch.empty((b, 1, d, d, d), dtype=torch.bfloat16, device=dev)
    w = (_randn((cout, 1, 3, 3, 3), torch.float32, dev, 107) / 27 ** 0.5).to(torch.bfloat16)
    g = _randn((b, cout, d // 2, d // 2, d // 2), torch.bfloat16, dev, 108)
    runs = [conv3d_k3_dgrad(g, w, x, 2, 1, dense=True) for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(runs[0], runs[1])


# The stem's data gradient in fp32 on the one-dx-channel kernel's CUDA-core
# form (dgrad_s2_c1_f32_kernel): (B, Cout, planes of x, H, W, slab plane of
# x's first plane, output planes, g's storage offset in floats). Main path:
# stage 1's batch of 8 at 64³ and the reconstruct's batch of 1 (dense: qlo
# 1); ragged: Cout 8 / 16 / 24 / 40 / 64, odd D, H and W, W not a multiple
# of 8 (element by element), x before and inside the slab, several plane,
# row and column tiles, and g off its 16-byte alignment (element by element
# at the hot shape).
DGRAD_S2_C1_F32 = [(8, 64, 64, 64, 64, 1, 32, 0), (1, 64, 64, 64, 64, 1, 32, 0),
                   (8, 64, 64, 64, 64, 1, 32, 1), (1, 64, 9, 7, 13, 1, 5, 0),
                   (8, 16, 6, 5, 10, 1, 3, 0), (1, 40, 5, 9, 35, -1, 4, 0),
                   (2, 8, 17, 10, 70, 0, 9, 0), (1, 64, 20, 9, 66, 2, 11, 0),
                   (1, 24, 3, 3, 3, 1, 2, 0), (2, 64, 33, 30, 128, 0, 17, 0)]


@pytest.mark.parametrize("case", DGRAD_S2_C1_F32)
def test_dgrad_s2_c1_fp32(dev, case):
    """The one-dx-channel data gradient in fp32 against its plain version
    (fp32 TOL with the absolute part scaled by max(1, max|want|), as
    chip_smoke.py [7d]: both sides sum the same fp32 products in another
    order), counted on its fp32 counter and on no tensor-core one, and two
    runs bitwise equal."""
    b, cout, nv, h, w_, qlo, d_out, off = case
    dt = torch.float32
    dense = qlo == 1 and d_out == (nv - 1) // 2 + 1
    x = _randn((b, 1, nv + 2, h, w_), dt, dev, 130).narrow(2, 1, nv)
    if dense:
        x = x.contiguous()
    w = _randn((cout, 1, 3, 3, 3), dt, dev, 131) / 27 ** 0.5
    g_shape = (b, cout, d_out, (h - 1) // 2 + 1, (w_ - 1) // 2 + 1)
    n = int(np.prod(g_shape))
    g = _randn((n + off,), dt, dev, 132)[off:].view(g_shape)
    assert dgrad_s2_instance(dt, 1, cout) == DGRAD_S2_C1_FP32
    before = dict(LAUNCHES)
    dx = conv3d_k3_dgrad(g, w, x, 2, qlo, dense=dense)
    assert LAUNCHES["conv3d_k3s2_dgrad_c1in_fp32"] == before["conv3d_k3s2_dgrad_c1in_fp32"] + 1
    assert LAUNCHES["conv3d_k3s2_dgrad_c1in"] == before["conv3d_k3s2_dgrad_c1in"] + 1
    assert LAUNCHES["conv3d_k3s2_dgrad_c1in_tc"] == before["conv3d_k3s2_dgrad_c1in_tc"]
    want = conv3d_k3_dgrad_plain(g, w, x, 2, qlo)
    _close(dx, want, dt, tol={dt: (1e-4 * max(1.0, float(want.abs().max())), 1e-4)})
    assert torch.equal(conv3d_k3_dgrad(g, w, x, 2, qlo, dense=dense), dx)


def test_conv_s2_c1in_tc_rule_matches_c(dev):
    """The C dispatch's rule (``hvc_conv3d_k3s2_c1in_tc``, which the wrapper
    counts launches by) is ``fwd_c1in_uses_tensor_cores`` at stride 2, at
    every dtype, channel count around its edges and act′ setting."""
    rule = _build.function("hvc_conv3d_k3s2_c1in_tc", (ctypes.c_int,) * 4)
    for (dtype, code), cin, cout, dact in itertools.product(
            ((torch.float32, 0), (torch.bfloat16, 1)), (1, 2, 7, 8, 64),
            (1, 4, 7, 8, 9, 32, 33, 64, 65, 256), (0, 1, 2)):
        assert bool(rule(cin, cout, dact, code)) == \
            fwd_c1in_uses_tensor_cores(dtype, 2, cin, cout, dact != 0)
    assert dgrad_s2_instance(torch.float32, 1, 64) == DGRAD_S2_C1_FP32


# The stride-2 1→64 stem's weight gradient at Cin = 1 on the tensor cores
# (wgrad_c1in_s2_tc_kernel): (B, Cout, planes of x, H, W, slab plane of x's
# first plane, output planes, act). Main path: stage 1's batch of 8 at 64³
# and the reconstruct's batch of 1 (dense: qlo 1); ragged: Cout 8 / 24 / 40
# (masked Cout tiles), odd D, H and W, W not a multiple of 16 (element by
# element), x before and inside the slab, several column tiles, gelu and silu
# prologues.
WGRAD_S2_C1IN_MAIN = [(8, 64, 64, 64, 64, 1, 32, None), (1, 64, 64, 64, 64, 1, 32, None)]
WGRAD_S2_C1IN_RAGGED = [(2, 8, 5, 6, 10, 1, 3, None), (1, 40, 7, 9, 35, 1, 4, "gelu"),
                        (2, 24, 9, 7, 13, -1, 5, "silu"), (1, 64, 33, 30, 66, 0, 16, None),
                        (8, 64, 20, 17, 13, 2, 10, "gelu"), (1, 64, 17, 64, 160, 0, 8, None)]


def _wgrad_s2_c1in_check(case, dtype, dev, seed):
    """The stride-2 weight gradient with one input channel against its plain
    version (chip_smoke.py's tolerance for dW: fp32 1e-4, the absolute part
    scaled by the largest |want|; both sides sum the same products), counted
    on the stride-2 one-input-channel counter in bf16 and on none in fp32,
    and bitwise repeatable."""
    b, cout, nv, h, w_, qlo, d_out, act = case
    x = _randn((b, 1, nv + 2, h, w_), dtype, dev, seed).narrow(2, 1, nv)
    g = _randn((b, cout, d_out, (h - 1) // 2 + 1, (w_ - 1) // 2 + 1), dtype, dev, seed + 1)
    dense = qlo == 1 and d_out == (nv - 1) // 2 + 1 and act is None
    before = dict(LAUNCHES)
    dw = conv3d_k3_wgrad(x, g, 2, qlo, act, dense=dense)
    bf16 = dtype == torch.bfloat16
    assert LAUNCHES["conv3d_k3s2_wgrad_c1in_tc"] == before["conv3d_k3s2_wgrad_c1in_tc"] + bf16
    assert LAUNCHES["conv3d_k3s2_wgrad_c1in"] == before["conv3d_k3s2_wgrad_c1in"] + 1
    assert (wgrad_instance(dtype, 2, 1) == WGRAD_C1IN_S2_TC) == bf16
    for other in ("conv3d_k3s2_wgrad_tc", "conv3d_k3s1_wgrad_c1in_tc"):
        assert LAUNCHES[other] == before[other]
    want = conv3d_k3_wgrad_plain(x, g, 2, qlo, act)
    torch.cuda.synchronize()
    err = (dw - want).abs()
    assert torch.isfinite(dw).all()
    assert bool((err <= 1e-4 * max(1.0, float(want.abs().max())) + 1e-4 * want.abs()).all()), \
        float(err.max())
    assert torch.equal(conv3d_k3_wgrad(x, g, 2, qlo, act, dense=dense), dw)


@pytest.mark.parametrize("case", WGRAD_S2_C1IN_MAIN)
def test_wgrad_s2_c1in_tensor_cores_main_path(dev, case):
    """The stem's weight gradient at the main path's shapes, bf16."""
    _wgrad_s2_c1in_check(case, torch.bfloat16, dev, 110)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", WGRAD_S2_C1IN_RAGGED)
def test_wgrad_s2_c1in_tensor_cores_ragged(dev, dtype, case):
    """The same at ragged shapes and views, bf16 on the tensor cores and fp32
    on the CUDA cores."""
    _wgrad_s2_c1in_check(case, dtype, dev, 111)


def test_wgrad_tc_rule_matches_c(dev):
    """The C dispatch's rule (``hvc_conv3d_k3_wgrad_tc``, which the wrapper
    counts launches and sizes the split by) is ``wgrad_instance`` at every
    dtype, stride and Cin around its edges."""
    rule = _build.function("hvc_conv3d_k3_wgrad_tc", (ctypes.c_int,) * 3)
    for (dtype, code), stride, cin in itertools.product(
            ((torch.float32, 0), (torch.bfloat16, 1)), (1, 2), (1, 2, 3, 4, 7, 8, 9, 64, 256)):
        assert rule(stride, cin, code) == wgrad_instance(dtype, stride, cin)


# Kernel family N, the conv probes: (weights, data) of each wrapper at N
# columns; V1 also at the V0 control's m = 256.
PROBE_CASES = ["V1", "V0", "V2", "V3", "V3'", "V5", "V6", "V4", "V8"]


def _variant(key: str) -> str:
    """The wrapper's name of probe case `key`: V3 → v3, V3' → v3p."""
    return key.lower().replace("'", "p")


def _probe_counters(key: str, n: int) -> dict:
    """The launches one call of probe case `key` at N columns adds to
    ``conv_probe.LAUNCHES``: its wrapper's counter, and the counter of the
    wgmma instance the wrapper's rule names (every case)."""
    case = bench.BY_KEY[key]
    want = {case.kernel: 1}
    if key in ("V3", "V3'", "V4", "V6", "V5", "V8"):
        v = _variant(key)
        instance = getattr(conv_probe, f"probe_{v}_instance")(n)
        want[f"conv_probe_{v}_wgmma"] = int(instance == getattr(conv_probe, f"{v.upper()}_WGMMA"))
    if key == "V2":
        instance = conv_probe.probe_v2_instance(conv_probe.K, n)
        want["conv_probe_v2_wgmma"] = int(instance == conv_probe.V2_WGMMA)
    elif key in ("V1", "V0"):
        instance = conv_probe.probe_v1_instance(case.w_shape[0], conv_probe.K, n)
        want["conv_probe_v1_wgmma"] = int(instance == conv_probe.V1_WGMMA_V0)
        want["conv_probe_v1_wgmma_m32"] = int(instance == conv_probe.V1_WGMMA_M32)
    return want


@pytest.mark.parametrize("n", [77, 2120, 4096])
@pytest.mark.parametrize("key", PROBE_CASES)
def test_conv_probe_matches_plain(dev, key, n):
    """Each probe kernel against its plain version in bf16, at a ragged N (77:
    rows not 16-byte aligned; 2,120: aligned, ragged last tile) and at 4,096;
    both sum the same bf16 products in fp32, in another order. One launch per
    call, whatever the number of passes (the r axis is a loop in the kernel),
    counted on the wgmma instance its rule names."""
    case = bench.BY_KEY[key]
    kern, plain = case.wrapper, case.plain
    shapes = [(n, conv_probe.K), case.w_shape] if key == "V2" else [case.w_shape, (case.x_rows, n)]
    args = [_randn(s, torch.bfloat16, dev, i + 20) for i, s in enumerate(shapes)]
    before = dict(conv_probe.LAUNCHES)
    got = kern(*args, 3)
    after = dict(conv_probe.LAUNCHES)
    assert after == {**before, **{k: before[k] + v for k, v in _probe_counters(key, n).items()}}
    want = plain(*args, 1)
    assert got.shape == want.shape and got.dtype == torch.float32
    torch.cuda.synchronize()
    err = (got - want).abs()
    assert torch.isfinite(got).all()
    assert bool((err <= 1e-4 * want.abs().max() + 1e-4 * want.abs()).all()), float(err.max())
    assert torch.equal(kern(*args, 1), got)  # every pass rewrites the same values


# make_v1 on its wgmma instances (V0: m = 256, V1: m = 32) and v2 on its own:
# (m, N, passes). The probes' N (131,072: P streams from device memory), N in
# L2, ragged last N tiles (2,120, 200), m of one and of five m64 tiles (a
# ragged 256-row item), m under 32, and N not a multiple of 8 (77, 1,001),
# where make_v1 must take an mma.sync instance and v2 its wgmma one.
PROBE_V1_WGMMA = [(256, 131072, 2), (256, 8192, 3), (256, 2120, 2), (256, 200, 1), (64, 4096, 2),
                  (320, 4096, 2), (256, 77, 2), (256, 1001, 1), (128, 77, 1),
                  (32, 131072, 2), (32, 8192, 3), (32, 2120, 2), (32, 200, 1), (32, 77, 2),
                  (8, 1000, 1)]
PROBE_V2_WGMMA = [(131072, 2), (8192, 3), (2120, 2), (200, 1), (77, 2), (1, 1)]


@pytest.mark.parametrize("m,n,passes", PROBE_V1_WGMMA)
def test_probe_v1_wgmma(dev, m, n, passes):
    """probe_v1 against its plain version (1e-4·max|want| + 1e-4·|want|: both
    sum the same bf16 products in fp32, in another order), counted on the
    wgmma instance ``probe_v1_instance`` names (V0's at m % 64 = 0, V1's at m
    ≤ 32, none at a ragged N), every other counter unchanged, and bitwise
    repeatable."""
    w = _randn((m, conv_probe.K), torch.bfloat16, dev, 120)
    p = _randn((conv_probe.K, n), torch.bfloat16, dev, 121)
    before = dict(conv_probe.LAUNCHES)
    got = conv_probe.probe_v1(w, p, passes)
    instance = conv_probe.probe_v1_instance(m, conv_probe.K, n)
    wgmma = {"conv_probe_v1_wgmma": int(instance == conv_probe.V1_WGMMA_V0),
             "conv_probe_v1_wgmma_m32": int(instance == conv_probe.V1_WGMMA_M32)}
    assert sum(wgmma.values()) == (n % 8 == 0 and (m % 64 == 0 or m <= 32))
    assert conv_probe.LAUNCHES == {**before, "conv_probe_v1": before["conv_probe_v1"] + 1,
                                   **{k: before[k] + v for k, v in wgmma.items()}}
    want = conv_probe.probe_v1_plain(w, p, 1)
    torch.cuda.synchronize()
    err = (got - want).abs()
    assert torch.isfinite(got).all()
    assert bool((err <= 1e-4 * want.abs().max() + 1e-4 * want.abs()).all()), float(err.max())
    assert torch.equal(conv_probe.probe_v1(w, p, passes), got)


@pytest.mark.parametrize("n,passes", PROBE_V2_WGMMA)
def test_probe_v2_wgmma(dev, n, passes):
    """probe_v2 against its plain version (the same bound), counted on its
    wgmma instance at every N, every other counter unchanged, and bitwise
    repeatable."""
    p = _randn((n, conv_probe.K), torch.bfloat16, dev, 122)
    w = _randn((conv_probe.K, conv_probe.COUT), torch.bfloat16, dev, 123)
    before = dict(conv_probe.LAUNCHES)
    got = conv_probe.probe_v2(p, w, passes)
    assert conv_probe.probe_v2_instance(conv_probe.K, n) == conv_probe.V2_WGMMA
    assert conv_probe.LAUNCHES == {**before, "conv_probe_v2": before["conv_probe_v2"] + 1,
                                   "conv_probe_v2_wgmma": before["conv_probe_v2_wgmma"] + 1}
    want = conv_probe.probe_v2_plain(p, w, 1)
    torch.cuda.synchronize()
    err = (got - want).abs()
    assert torch.isfinite(got).all()
    assert bool((err <= 1e-4 * want.abs().max() + 1e-4 * want.abs()).all()), float(err.max())
    assert torch.equal(conv_probe.probe_v2(p, w, passes), got)


# v3 on its wgmma instance: (N, passes). The probe's N (P streams from device
# memory), N in L2, ragged last N tiles (2,120, 200), the smallest aligned N,
# and N not a multiple of 8 (77, 1,001: the mma.sync instance).
PROBE_V3_WGMMA = [(131072, 2), (8192, 3), (2120, 2), (200, 1), (8, 1), (77, 2), (1001, 1)]


@pytest.mark.parametrize("n,passes", PROBE_V3_WGMMA)
def test_probe_v3_wgmma(dev, n, passes):
    """probe_v3 against its plain version (1e-4·max|want| + 1e-4·|want|: both
    sum the same bf16 products in fp32, in another order), counted on the
    wgmma instance ``probe_v3_instance`` names (N % 8 = 0), every other
    counter unchanged, and bitwise repeatable."""
    w = _randn((conv_probe.TAPS * conv_probe.COUT, conv_probe.CIN), torch.bfloat16, dev, 124)
    p = _randn((conv_probe.K, n), torch.bfloat16, dev, 125)
    before = dict(conv_probe.LAUNCHES)
    got = conv_probe.probe_v3(w, p, passes)
    wgmma = int(conv_probe.probe_v3_instance(n) == conv_probe.V3_WGMMA)
    assert wgmma == (n % 8 == 0)
    assert conv_probe.LAUNCHES == {**before, "conv_probe_v3": before["conv_probe_v3"] + 1,
                                   "conv_probe_v3_wgmma": before["conv_probe_v3_wgmma"] + wgmma}
    want = conv_probe.probe_v3_plain(w, p, 1)
    torch.cuda.synchronize()
    err = (got - want).abs()
    assert torch.isfinite(got).all()
    assert bool((err <= 1e-4 * want.abs().max() + 1e-4 * want.abs()).all()), float(err.max())
    assert torch.equal(conv_probe.probe_v3(w, p, passes), got)


# v4, v6, v5 and v8 on their wgmma instances: (N, passes). The probes' N, N
# in L2, ragged last N tiles (2,120 and 200: a last 128-column item of 72
# columns), and N not a multiple of 8 (77, 1: probe_tapsum on mma.sync).
PROBE_TAP_WGMMA = [(131072, 2), (8192, 3), (2120, 2), (200, 1), (77, 2), (1, 1)]


def _check_tap_wgmma(dev, key: str, n: int, passes: int, seed: int) -> None:
    """probe_v3p / v4 / v6 / v5 / v8 against its plain version (1e-4·max|want| +
    1e-4·|want|: both sum the same bf16 products in fp32, in another order),
    counted on the wgmma instance the wrapper's rule names (N % 8 = 0),
    every other counter unchanged, bitwise equal over a rerun and between 1
    and `passes` passes. V6's w27p carries 1e4 in its rows 864-895, the row
    group its plain version drops: a kernel that read them would miss by
    ~1e4·|x|·8."""
    case = bench.BY_KEY[key]
    w = _randn(case.w_shape, torch.bfloat16, dev, seed)
    if key == "V6":
        w[conv_probe.TAPS * conv_probe.COUT:] = 1e4
    x = _randn((case.x_rows, n), torch.bfloat16, dev, seed + 1)
    took = _probe_counters(key, n)
    assert took[f"conv_probe_{_variant(key)}_wgmma"] == (n % 8 == 0)
    before = dict(conv_probe.LAUNCHES)
    got = case.wrapper(w, x, passes)
    assert conv_probe.LAUNCHES == {**before, **{k: before[k] + v for k, v in took.items()}}
    want = case.plain(w, x, 1)
    torch.cuda.synchronize()
    err = (got - want).abs()
    assert got.shape == want.shape == (conv_probe.COUT, n) and got.dtype == torch.float32
    assert torch.isfinite(got).all()
    assert bool((err <= 1e-4 * want.abs().max() + 1e-4 * want.abs()).all()), float(err.max())
    assert torch.equal(case.wrapper(w, x, passes), got)
    assert torch.equal(case.wrapper(w, x, 1), got)


# v3p on its per-tap wgmma instance: the probe's N at one and three passes, N
# in L2, ragged last items (8,200: a last 256-column item of 8 columns;
# 2,120, 200) and N not a multiple of 8 (8,191, 77, 1: probe_tapsum on
# mma.sync).
PROBE_V3P_WGMMA = [(131072, 1), (131072, 3), (8192, 2), (8200, 2), (8191, 2), (2120, 2),
                   (200, 1), (77, 2), (1, 1)]


@pytest.mark.parametrize("n,passes", PROBE_V3P_WGMMA)
def test_probe_v3p_wgmma(dev, n, passes):
    """v3p on ``probe_pertap_wgmma`` (``WgV3p``: 27 per-tap dots into one
    accumulator, X as A in registers, w27 resident as B), counted on
    ``conv_probe_v3p_wgmma`` only at N % 8 = 0."""
    _check_tap_wgmma(dev, "V3'", n, passes, 134)


@pytest.mark.parametrize("n,passes", PROBE_TAP_WGMMA)
def test_probe_v4_wgmma(dev, n, passes):
    """v4 on ``probe_tapsum_wgmma<WgV4>`` (w27 resident as A, one chain)."""
    _check_tap_wgmma(dev, "V4", n, passes, 126)


@pytest.mark.parametrize("n,passes", PROBE_TAP_WGMMA)
def test_probe_v6_wgmma(dev, n, passes):
    """v6 on V4's ``probe_tapsum_wgmma<WgV4>`` (w27p's first 864 rows), with
    w27p's dropped row group planted."""
    _check_tap_wgmma(dev, "V6", n, passes, 128)


@pytest.mark.parametrize("n,passes", PROBE_TAP_WGMMA)
def test_probe_v5_wgmma(dev, n, passes):
    """v5 on ``probe_tapsum_wgmma<WgV5>`` (w14 resident as A, two k64 chunks
    a tap)."""
    _check_tap_wgmma(dev, "V5", n, passes, 130)


@pytest.mark.parametrize("n,passes", PROBE_TAP_WGMMA)
def test_probe_v8_wgmma(dev, n, passes):
    """v8 on ``probe_tapsum_wgmma<WgV8>`` (w9 resident as A, three k64 chunks
    a tap, tap 9's half-tile zeros)."""
    _check_tap_wgmma(dev, "V8", n, passes, 132)


def test_probe_v1_wgmma_rule_matches_c(dev):
    """The C rules (``hvc_probe_v1_rule``, ``hvc_probe_v2_rule`` and
    ``hvc_probe_v{3,3p,4,6,5,8}_rule``, which the wrappers count wgmma
    launches by) are ``probe_v1_instance``, ``probe_v2_instance`` and
    ``probe_v{3,3p,4,6,5,8}_instance`` at every m, K and N around their edges."""
    rule = _build.function("hvc_probe_v1_rule", (ctypes.c_int,) * 3)
    for m, n in itertools.product((1, 31, 32, 33, 63, 64, 65, 128, 192, 256, 320),
                                  (1, 7, 8, 9, 16, 77, 2120, 131072)):
        assert rule(m, conv_probe.K, n) == conv_probe.probe_v1_instance(m, conv_probe.K, n)
    rule2 = _build.function("hvc_probe_v2_rule", (ctypes.c_int,) * 2)
    for k, n in itertools.product((0, 32, 64, 1728, 1792, 1856, 4096), (1, 7, 77, 2120, 131072)):
        assert rule2(k, n) == conv_probe.probe_v2_instance(k, n)
    for v in ("v3", "v3p", "v4", "v6", "v5", "v8"):
        rule = _build.function(f"hvc_probe_{v}_rule", (ctypes.c_int,))
        mirror = getattr(conv_probe, f"probe_{v}_instance")
        for n in (1, 7, 8, 9, 16, 77, 200, 2120, 8192, 131072):
            assert rule(n) == mirror(n)


# ---------------------------------------------- the hvc:: torch.library ops ---

def _counts_after(fn):
    """(result, launch-count increments) of fn()."""
    before = launch_counts()
    res = fn()
    torch.cuda.synchronize()
    after = launch_counts()
    return res, {k: after[k] - before[k] for k in after if after[k] != before[k]}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("bh,nq,nk,d", [(3, 200, 77, 32), (4, 1024, 256, 64)])
def test_flash_op_is_the_wrapper(dev, dtype, bh, nq, nk, d):
    """hvc::flash_attention_fwd on the card launches kernel A once, counted as
    the wrapper counts it, and gives the wrapper's bits."""
    q, k, v = (_randn((bh, n, d), dtype, dev, s) for s, n in ((0, nq), (1, nk), (2, nk)))
    want, counted = _counts_after(lambda: flash_attention_fwd(q, k, v, d ** -0.5))
    got, counts = _counts_after(lambda: torch.ops.hvc.flash_attention_fwd(q, k, v, d ** -0.5))
    assert counts == counted and counts["flash_attention"] == 1
    assert all(torch.equal(a, b) for a, b in zip(got, want))


# (x shape, Cout, stride, qlo, d_out, sums, act, dense): the dense conv on
# each instance (CUDA cores, tensor cores, one input channel), chain calls
# with sums and prologue, a one-output-channel call
_OP_CONV = [((1, 8, 6, 8, 16), 16, 1, 1, 6, False, None, True),
            ((1, 32, 8, 8, 16), 64, 2, 1, 4, False, None, True),
            ((1, 1, 8, 8, 32), 32, 1, 1, 8, False, None, True),
            ((1, 1, 8, 8, 32), 64, 2, 1, 4, False, None, True),
            ((2, 3, 5, 6, 10), 5, 1, 0, 4, True, "gelu", False),
            ((1, 32, 6, 8, 16), 64, 2, 2, 3, True, "silu", False),
            ((1, 64, 6, 8, 16), 32, 1, 1, 6, True, "gelu", False),
            ((1, 32, 6, 8, 16), 1, 1, 1, 6, False, None, False)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", _OP_CONV)
def test_conv_op_is_the_wrapper(dev, dtype, case):
    """hvc::conv3d_k3 on the card launches the kernel the wrapper launches,
    once, counted as the wrapper counts it (its letter and instance), and
    gives the wrapper's bits: out and, with sums, Σ and Σ²."""
    xs, cout, stride, qlo, d_out, sums, act, dense = case
    x = _randn(xs, dtype, dev, 3)
    w = (_randn((cout, xs[1], 3, 3, 3), torch.float32, dev, 4) / (27 * xs[1]) ** 0.5).to(dtype)
    bias = _randn((cout,), torch.float32, dev, 5)
    args = (x, w, bias, stride, qlo, d_out, sums, act)
    want, counted = _counts_after(lambda: conv3d_k3(*args, dense=dense))
    got, counts = _counts_after(lambda: torch.ops.hvc.conv3d_k3(*args, dense))
    letter = f"conv3d_k3s{stride}{'' if dense else '_chain'}"
    assert counts == counted and counts[letter] == 1
    assert all(torch.equal(a, b) for a, b in zip(got, want if sums else (want,)))
    if not sums:
        assert got[1].shape == got[2].shape == (0,)
