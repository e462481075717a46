"""The tensor-core instances of the split backward's dq kernel (L) and of the
one-output-channel stride-1 data gradient, on the CPU: their dispatch rules,
the tilings the replays assume against the kernel sources, and torch replays
of each kernel's schedule and roundings against the plain versions and the
JAX package.

- L (``csrc/flash_attention_bwd_split.cu``, ``flash_bwd_dq_tc_kernel``):
  bf16 on the tensor cores (``bwd_dq_uses_tensor_cores``); per query tile of
  64 rows and key tile of 64, 16 keys at a time: s and dp in fp32, p =
  exp2(s·scale·log2e − lse·log2e), ds = p·(dp − delta) rounded to bf16, dq
  added in fp32, scaled and rounded once. Against
  ``flash_attention_bwd_plain`` (flash bf16 tolerance of chip_smoke.py,
  FLASH_OUT_TOL: 1e-2·max|want| + 2e-2·|want|) and dq of the JAX split
  backward ``_bwd_pallas`` (``HVC_FLASH_FUSED_BWD=0``, interpret mode;
  ROADMAP's flash bf16 tolerance, 3e-2).
- The one-output-channel data gradient (``csrc/conv3d_k3.cu``,
  ``conv_c1_tc_kernel``): bf16, Cout = 1 as the kernel sees it, 8 ≤ g's
  channels ≤ 64, no prologue, no sums (``dgrad_c1_uses_tensor_cores``); per
  block of 32 output planes × 4 rows × 64 columns, per input plane the
  products P[tap, position] over every staged position, then the fixed-order
  shifted 27-way sum, the act′ epilogue and one rounding. Against
  ``conv3d_k3_dgrad_plain`` (fp32, 1e-4: the same products in another order)
  and dx of the JAX ``conv3d_k3s1_chain`` VJP (interpret mode; the conv VJP's
  tolerance of tests/test_pallas_conv.py, 1e-4 relative, 1e-3 absolute).
"""

import importlib
import itertools
import math
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hybrid_vit_cascade_tpu.ops.pallas.conv3d_k3 import conv3d_k3s1_chain as jax_chain_s1
from hybrid_vit_cascade_tpu_torch.ops.cuda import _build
from hybrid_vit_cascade_tpu_torch.ops.cuda import conv3d_k3 as ck
from hybrid_vit_cascade_tpu_torch.ops.cuda import flash_attention as fa
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

jfa = importlib.import_module("hybrid_vit_cascade_tpu.ops.pallas.flash_attention")

# ------------------------------------------------------ L on the tensor cores ---

# L's tiling on the tensor cores, as the kernel source states it: 4 warps of 16
# query rows, key tiles of 64, 16 keys a step of the sweep.
L_ROWS, L_KEYS, L_STEP = 64, 64, 16


@pytest.mark.parametrize("dtype,tc", [(torch.bfloat16, True), (torch.float32, False)])
def test_flash_bwd_dq_dispatch_rule(dtype, tc):
    """bf16 takes the tensor-core L (``dq_uses_tc`` in C), fp32 the CUDA
    cores, as D and M."""
    assert fa.bwd_dq_uses_tensor_cores(dtype) is tc
    assert fa.bwd_dq_uses_tensor_cores(dtype) is fa.bwd_dkv_uses_tensor_cores(dtype)


def test_flash_bwd_dq_tc_tiling_is_the_kernels():
    src = (_build.CSRC_DIR / "flash_attention_bwd_split.cu").read_text()
    warps = int(re.search(r"constexpr int kDqTcWarps = (\d+);", src).group(1))
    assert "constexpr int kDqTcRows = 16 * kDqTcWarps;" in src and 16 * warps == L_ROWS
    assert int(re.search(r"constexpr int kDqTcKv = (\d+);", src).group(1)) == L_KEYS
    assert "for (int j = 0; j < kDqTcKv / 16; ++j) {" in src
    assert "bool dq_uses_tc(int dtype) { return dtype == 1; }" in src


def _l_tc_emulated(q, k, v, out, lse, dout, scale):
    """dq as the tensor-core L computes it from bf16 inputs: per head and query
    tile of ``L_ROWS`` rows, key tiles of ``L_KEYS`` in order, ``L_STEP`` keys
    at a time (keys past Nk are not there: the kernel's zero rows and p = 0),
    s = q·kᵀ and dp = dout·vᵀ in fp32, p = exp2(s·scale·log2e −
    lse·log2e), ds = p·(dp − delta) rounded to bf16, dq += bf16(ds)·k in
    fp32; dq = bf16(dq·scale)."""
    bh, nq, d = q.shape
    nk = k.shape[1]
    qf, kf, vf, dof = (t.float() for t in (q, k, v, dout))
    delta = (dof * out.float()).sum(-1)
    c, l2 = scale * math.log2(math.e), lse * math.log2(math.e)
    dq = torch.empty((bh, nq, d), dtype=torch.bfloat16)
    for h, r0 in itertools.product(range(bh), range(0, nq, L_ROWS)):
        rows = slice(r0, r0 + L_ROWS)
        acc = torch.zeros((min(L_ROWS, nq - r0), d))
        for k0 in range(0, nk, L_KEYS):
            for j0 in range(k0, min(k0 + L_KEYS, nk), L_STEP):
                kc, vc = kf[h, j0:j0 + L_STEP], vf[h, j0:j0 + L_STEP]
                p = torch.exp2((qf[h, rows] @ kc.T) * c - l2[h, rows, None])
                ds = p * ((dof[h, rows] @ vc.T) - delta[h, rows, None])
                acc += ds.to(torch.bfloat16).float() @ kc
        dq[h, rows] = (acc * scale).to(torch.bfloat16)
    return dq


def _bf16_inputs(bh, nq, nk, d, seed):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal(sh).astype(np.float32)).to(torch.bfloat16)
                 for sh in ((bh, nq, d), (bh, nk, d), (bh, nk, d), (bh, nq, d)))


# (BH, Nq, Nk, d): ragged query and key tails (Nq, Nk not multiples of 64 or
# 16), several query and key tiles, d = 32 and 64, one key
L_EMULATED = [(2, 96, 300, 32), (2, 130, 77, 64), (1, 64, 129, 32), (3, 200, 77, 64),
              (2, 17, 1, 32)]


@pytest.mark.parametrize("bh,nq,nk,d", L_EMULATED)
def test_flash_bwd_dq_tc_emulated_matches_plain(bh, nq, nk, d):
    """Within the card's bf16 flash tolerance (FLASH_OUT_TOL, its scale
    floored at 1e-3 for the one-key case, where dq cancels to rounding: ds =
    p·(dp − delta) with p = 1 and dp = delta) of the plain fp32 backward: ds
    is rounded to bf16 before dS·K (2^-9 relative), the output to bf16."""
    q, k, v, dout = _bf16_inputs(bh, nq, nk, d, 51)
    scale = d ** -0.5
    out, lse = fa.flash_attention_plain(q, k, v, scale)
    got = _l_tc_emulated(q, k, v, out, lse, dout, scale)
    want = fa.flash_attention_bwd_plain(q, k, v, out, lse, dout, scale)[0]
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    wf = want.float()
    err = (got.float() - wf).abs()
    scale_abs = max(float(wf.abs().max()), 1e-3)
    assert bool((err <= 1e-2 * scale_abs + 2e-2 * wf.abs()).all()), float(err.max())


@pytest.mark.parametrize("bh,nq,nk,d", L_EMULATED[:2])
def test_flash_bwd_dq_tc_emulated_matches_jax(monkeypatch, bh, nq, nk, d):
    """Against dq of the JAX flash attention in bf16 through its split
    backward ``_bwd_pallas`` (``FUSED_BWD`` off: ``_bwd_dq_kernel``,
    interpret mode), which rounds ds to bf16 as the replay does; ROADMAP's
    flash bf16 tolerance, 3e-2 absolute and relative (JAX's bf16 pre-scale of
    q moves every score by up to 2^-8 relative)."""
    q, k, v, dout = _bf16_inputs(bh, nq, nk, d, 52)
    scale = d ** -0.5
    out, lse = fa.flash_attention_plain(q, k, v, scale)
    got = _l_tc_emulated(q, k, v, out, lse, dout, scale)

    def loss(q_):  # (B, H, N, d) with B = 1, H = BH
        k_, v_ = (jnp.asarray(t.float().numpy()[None], jnp.bfloat16) for t in (k, v))
        o = jfa.flash_attention(q_, k_, v_, scale, block_q=32, block_kv=32)
        return (o.astype(jnp.float32) * jnp.asarray(dout.float().numpy()[None])).sum()

    monkeypatch.setattr(jfa, "FUSED_BWD", False)  # HVC_FLASH_FUSED_BWD=0: _bwd_pallas
    want = jax.grad(loss)(jnp.asarray(q.float().numpy()[None], jnp.bfloat16))
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32))[0],
                               rtol=3e-2, atol=3e-2)


# ------------------------ the one-output-channel data gradient on the tensor cores ---

# conv_c1_tc_kernel's tiling, as its source states it: output planes, rows and
# columns of a block, and the channels it holds.
C1_PLANES, C1_TH, C1_TW, C1_CI = 32, 4, 64, 64


@pytest.mark.parametrize("dtype,cin,cout,act,sums,tc", [
    (torch.bfloat16, 64, 1, None, False, True), (torch.bfloat16, 32, 1, None, False, True),
    (torch.bfloat16, 8, 1, None, False, True), (torch.bfloat16, 40, 1, None, False, True),
    (torch.bfloat16, 7, 1, None, False, False), (torch.bfloat16, 65, 1, None, False, False),
    (torch.bfloat16, 128, 1, None, False, False), (torch.bfloat16, 64, 2, None, False, False),
    (torch.bfloat16, 64, 1, "gelu", False, False), (torch.bfloat16, 64, 1, None, True, False),
    (torch.float32, 64, 1, None, False, False), (torch.float32, 32, 1, None, False, False)])
def test_dgrad_c1_dispatch_rule(dtype, cin, cout, act, sums, tc):
    """bf16 with one output channel, 8 ≤ Cin ≤ 64 (g's channels), no prologue
    and no sums takes the one-output-channel tensor-core instance
    (``c1_uses_tc`` in C): every data gradient of the 1→32 and 1→64 convs in
    bf16. fp32 and the other channel counts stay on the CUDA cores; a call
    with Cin ≥ 8 and Cout ≥ 8 is the other tensor-core conv's."""
    assert ck.dgrad_c1_uses_tensor_cores(dtype, cin, cout, act, sums) is tc
    assert not (tc and ck.fwd_uses_tensor_cores(dtype, 1, cin, cout))


def test_dgrad_c1_tiling_is_the_kernels():
    src = (_build.CSRC_DIR / "conv3d_k3.cu").read_text()
    assert f"constexpr int kC1Planes = {C1_PLANES};" in src
    assert f"constexpr int kC1Th = {C1_TH}, kC1Tw = {C1_TW};" in src
    assert f"constexpr int kC1Ci = {C1_CI};" in src
    assert "return stride == 1 && bf16 && cout == 1 && cin >= 8 && cin <= kC1Ci && act == 0 && !sums;" \
        in src


def _c1_tc_emulated(xk, wk, qk, do, act=None, dact_x=None):
    """The output (B, 1, do, H, W) in xk's dtype of the one-output-channel conv
    as ``conv_c1_tc_kernel`` computes it: xk the input view (planes qk + 0 …
    of the slab; for a data gradient g), wk (1, C, 3, 3, 3). Per block of
    ``C1_PLANES`` output planes × ``C1_TH`` rows × ``C1_TW`` columns and per
    input plane in the view: the staged 6 rows × 80 columns (from column
    ow0 − 8, zero outside), P = w[tap, ci]·staged[ci, position] in fp32, then
    for dz = 0, 1, 2 the 9 taps of dz summed in tap order at their shifts and
    added to output plane i − dz (so each output adds its dz = 0, 1, 2 sums in
    that order); act′ of dact_x, one rounding. Also returns how often each
    output element was written."""
    B, C, nvk, H, W = xk.shape
    a = wk.reshape(C, 27).T.float()
    xf = xk.float()
    out = torch.zeros((B, 1, do, H, W), dtype=xk.dtype)
    writes = torch.zeros((B, 1, do, H, W), dtype=torch.int32)
    for b, tz, ty, tx in itertools.product(range(B), range(-(-do // C1_PLANES)),
                                           range(-(-H // C1_TH)), range(-(-W // C1_TW))):
        od0, oh0, ow0 = C1_PLANES * tz, C1_TH * ty, C1_TW * tx
        n_out = min(C1_PLANES, do - od0)
        acc = torch.zeros((n_out, C1_TH, C1_TW))
        for i in range(n_out + 2):
            p = od0 - qk + i
            if not 0 <= p < nvk:
                continue
            staged = torch.zeros((C, C1_TH + 2, C1_TW + 16))
            for r, col in itertools.product(range(C1_TH + 2), range(C1_TW + 16)):
                ih, iw = oh0 - 1 + r, ow0 - 8 + col
                if 0 <= ih < H and 0 <= iw < W:
                    staged[:, r, col] = xf[b, :, p, ih, iw]
            P = (a @ staged.reshape(C, -1)).reshape(27, C1_TH + 2, C1_TW + 16)
            for dz in range(3):
                s = torch.zeros((C1_TH, C1_TW))
                for t in range(9):
                    dy, dx = divmod(t, 3)
                    s = s + P[9 * dz + t, dy:dy + C1_TH, dx + 7:dx + 7 + C1_TW]
                if 0 <= i - dz < n_out:
                    acc[i - dz] += s
        nh, nw = min(C1_TH, H - oh0), min(C1_TW, W - ow0)
        val = acc[:, :nh, :nw]
        region = (b, 0, slice(od0, od0 + n_out), slice(oh0, oh0 + nh), slice(ow0, ow0 + nw))
        if act is not None:
            val = val * ck.dact_plain(act, dact_x[region])
        out[region] = val.to(xk.dtype)
        writes[region] += 1
    return out, writes


def _c1_dgrad_emulated(g, w, x, qlo, act=None):
    """dx of the stride-1 (chain) conv of a 1-channel x for output gradient
    g, as ``conv3d_k3_dgrad`` runs it: the one-output-channel conv on g with
    channel-transposed, tap-flipped weights, slab offset 2 − qlo, x's planes."""
    wk = w.transpose(0, 1).flip(2, 3, 4)
    return _c1_tc_emulated(g, wk, 2 - qlo, x.shape[2], act, x)


# (B, Cout of the forward conv, planes of x, H, W, slab plane of x's first
# plane, output planes, act): the dense form (qlo 1, every plane); a
# training slab's window (x from slab plane 0, one output plane short); x
# beginning before the slab; more planes than a block's 32 (two plane
# ranges, the second ragged); H, W not multiples of the 4 × 64 tile; Cin of
# the kernel (g's channels) not a multiple of 16; act′ gelu and silu.
C1_EMULATED = [(1, 32, 6, 5, 70, 1, 6, None), (1, 64, 7, 4, 64, 0, 6, "gelu"),
               (2, 24, 5, 6, 20, -1, 7, "silu"), (1, 8, 35, 3, 9, 1, 35, None),
               (1, 40, 4, 9, 66, 2, 3, "gelu")]


@pytest.mark.parametrize("case", C1_EMULATED)
def test_dgrad_c1_tc_emulated_matches_plain(case):
    """The replay writes every dx element once and agrees with
    ``conv3d_k3_dgrad_plain`` in fp32 (both sum the same products in another
    order: 1e-4)."""
    b, cout, nv, h, w_, qlo, d_out, act = case
    rng = np.random.default_rng(53)
    x = torch.from_numpy(rng.standard_normal((b, 1, nv, h, w_)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((cout, 1, 3, 3, 3)) / np.sqrt(27))
                         .astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((b, cout, d_out, h, w_)).astype(np.float32))
    got, writes = _c1_dgrad_emulated(g, w, x, qlo, act)
    assert bool((writes == 1).all())
    want = ck.conv3d_k3_dgrad_plain(g, w, x, 1, qlo, act)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("cout,act", [(32, None), (64, "gelu")])
def test_dgrad_c1_tc_emulated_matches_jax(cout, act):
    """Against dx of the JAX stride-1 chain conv with one input channel
    (``conv3d_k3s1_chain`` VJP, its dgrad ``_conv_fwd`` with vp = 2 in
    interpret mode, fp32) at 32→1 and 64→1, the smallest width its shape gate
    takes (W % 128 = 0), x windowed at the front (view planes 1-6 of 7), with
    and without the fused prologue's act′; the conv VJP's tolerance
    (tests/test_pallas_conv.py: 1e-4 relative, 1e-3 absolute)."""
    B, H, W, dext = 1, 4, 128, 7
    vlo, vhi = 1, dext
    d_out = dext - 2
    rng = np.random.default_rng(54)
    x = rng.standard_normal((B, 1, dext, H, W)).astype(np.float32)
    w = (rng.uniform(-1, 1, (cout, 1, 3, 3, 3)) / np.sqrt(27)).astype(np.float32)
    bias = np.zeros(cout, np.float32)
    g = rng.standard_normal((B, cout, d_out * H * W)).astype(np.float32)
    meta = (dext, H, W, False) + (() if act is None else (act,))
    _, vjp = jax.vjp(lambda xv: jax_chain_s1(meta, xv, jnp.asarray([vlo, vhi], jnp.int32),
                                             jnp.asarray(w), jnp.asarray(bias)),
                     jnp.asarray(x.reshape(B, 1, -1)))
    want = np.asarray(vjp(jnp.asarray(g))[0]).reshape(B, 1, dext, H, W)[:, :, vlo:vhi]
    xt = torch.from_numpy(x).narrow(2, vlo, vhi - vlo)
    got, writes = _c1_dgrad_emulated(torch.from_numpy(g).reshape(B, cout, d_out, H, W),
                                     torch.from_numpy(w), xt, vlo, act)
    assert bool((writes == 1).all())
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-3)
