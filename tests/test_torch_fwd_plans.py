"""The plans of the port's tensor-core forward kernels, on the CPU: which
instance of the stride-1 conv (B/H) and of the flash forward (A) a call
takes, how many Σ/Σ² partials the conv writes, and torch emulations of both
tensor-core kernels' arithmetic against the plain versions and the JAX
package.

- ``fwd_uses_tensor_cores`` / ``fwd_plan``: bf16 at stride 1 with Cin ≥ 8 and
  Cout ≥ 8 takes the tensor-core conv, everything else the CUDA-core one (the
  rule of ``fwd_uses_tc`` in csrc/conv3d_k3.cu); the partial buffer the
  wrapper allocates holds one entry per block of either instance's grid, at
  every conv shape of ``chip_smoke.py`` (forward, and the stride-1 data
  gradient with its qlo = 2 − qlo).
- The tensor-core conv's staging and tap addressing (4 × 4 × 32 voxel tiles,
  the channels-innermost patch with Cin padded to 16, one row offset per tap,
  Cout masked to the 32-channel tile, the epilogue's bias, act′ and rounding,
  Σ/Σ² per block), replayed in torch, against ``conv3d_k3_plain`` /
  ``conv3d_k3_dgrad_plain`` and the JAX ``conv3d_k3s1_chain`` (interpret
  mode).
- The tensor-core flash forward's arithmetic (key tiles of 64, online softmax
  in base 2, p rounded to bf16 into P·V and into the row sum, natural-log
  lse), replayed in torch, against ``flash_attention_plain`` and the JAX
  ``_flash_fwd_padded`` (interpret mode).
"""

import importlib
import itertools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from hybrid_vit_cascade_tpu.ops.pallas.conv3d_k3 import conv3d_k3s1_chain as jax_chain_s1
from hybrid_vit_cascade_tpu_torch.ops.cuda import conv3d_k3 as ck
from hybrid_vit_cascade_tpu_torch.ops.cuda import flash_attention as fa

jfa = importlib.import_module("hybrid_vit_cascade_tpu.ops.pallas.flash_attention")

BF16, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("dtype,stride,cin,cout,tc", [
    (BF16, 1, 64, 32, True), (BF16, 1, 32, 64, True), (BF16, 1, 8, 8, True),
    (BF16, 1, 128, 256, True), (BF16, 1, 24, 40, True), (BF16, 1, 7, 32, False),
    (BF16, 1, 1, 64, False), (BF16, 1, 64, 1, False), (BF16, 1, 32, 7, False),
    (BF16, 2, 32, 64, False), (F32, 1, 64, 32, False), (F32, 1, 1, 32, False)])
def test_conv_fwd_dispatch_rule(dtype, stride, cin, cout, tc):
    assert ck.fwd_uses_tensor_cores(dtype, stride, cin, cout) is tc
    assert ck.fwd_plan((1, cin, 8, 16, 16), cout, stride, dtype)[0] is tc


def _c_blocks(tc: bool, stride: int, do: int, h: int, w: int) -> int:
    """The blocks per (batch, Cout tile) that csrc/conv3d_k3.cu launches:
    launch_tc's tiles of 4 planes × 4 rows × 32 columns, or launch's grid of
    Do planes × 8-row tiles × 32 (stride 1) or 16 (stride 2) columns."""
    if tc:
        return -(-do // 4) * -(-h // 4) * -(-w // 32)
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    return do * -(-ho // 8) * -(-wo // (32 if stride == 1 else 16))


def _fwd_calls():
    """(name, out_shape, cout, stride) of every conv-forward kernel call at the
    shapes of chip_smoke.py: the forward at each dense and chain shape, and
    the stride-1 data gradient (the forward on g, Cin and Cout swapped, nv
    output planes, qlo = 2 − qlo)."""
    calls = []
    for name in ("conv3d_k3s1", "conv3d_k3s2"):
        s = 1 if name == "conv3d_k3s1" else 2
        for b, cin, cout, (d, h, w) in chip_smoke.KERNELS[name]["shapes"]:
            calls.append((name, (b, cin, (d - 1) // s + 1, h, w), cout, s))
    for b, cin, cout, (d, h, w) in chip_smoke.TRAIN_KERNELS["conv3d_k3s1_dgrad"]["shapes"]:
        calls.append(("conv3d_k3s1_dgrad", (b, cout, d, h, w), cin, 1))
    for name, spec in chip_smoke.CHAIN_KERNELS.items():
        s = chip_smoke._chain_stride(name)
        for b, cin, cout, nv, h, w, _, d_out, _, _ in spec["shapes"] + spec["ragged"]:
            if name.endswith("wgrad") or (name.endswith("dgrad") and s == 2):
                continue
            if name.endswith("dgrad"):
                calls.append((name, (b, cout, nv, h, w), cin, 1))
            else:
                calls.append((name, (b, cin, d_out, h, w), cout, s))
    return calls


@pytest.mark.parametrize("dtype", [BF16, F32])
def test_conv_fwd_partials_match_the_kernel_grid(dtype):
    """At every conv-forward call of the main path the plan's blocks are
    the grid the kernel of its instance launches, and the Σ/Σ² partial
    buffer (B · Cout · blocks · 2 fp32, ``_fwd``) holds one entry per block
    and output channel of either instance's grid, the larger of the two; the
    hot bf16 calls take the tensor cores."""
    calls = _fwd_calls()
    assert len(calls) > 40
    for name, out_shape, cout, stride in calls:
        b, cin, do, h, w = out_shape
        tc, tile, nblk = ck.fwd_plan(out_shape, cout, stride, dtype)
        assert tc == ck.fwd_uses_tensor_cores(dtype, stride, cin, cout)
        assert nblk == _c_blocks(tc, stride, do, h, w), (name, out_shape)
        assert ck.fwd_partial_blocks(out_shape, stride) == max(
            _c_blocks(True, stride, do, h, w), _c_blocks(False, stride, do, h, w)), (name, out_shape)
        assert tile == ((4, 4, 32) if tc else (1, 8, 32 if stride == 1 else 16))
        if dtype == BF16 and (cin, cout) in ((64, 32), (32, 64)) and stride == 1:
            assert tc, (name, out_shape)


def test_conv_fwd_hot_plan():
    """The 64→32 conv at 256³: 64 × 64 × 8 = 32,768 tensor-core blocks of 512
    voxels; the CUDA-core plan of the same call in fp32: 256 × 32 × 8."""
    assert ck.fwd_plan((1, 64, 256, 256, 256), 32, 1, BF16) == (True, (4, 4, 32), 32768)
    assert ck.fwd_plan((1, 64, 256, 256, 256), 32, 1, F32) == (False, (1, 8, 32), 65536)


# ----------------------------------------------- the tensor-core conv ---

def _conv_tc_emulated(x, w, bias, qlo, d_out, act=None, dact=None):
    """out (and Σ, Σ²) as the tensor-core conv computes it, in fp32 products
    of the operands in x's dtype: per 4 × 4 × 32 voxel tile, the patch
    [position][ci] (positions (pd, ph, pw) of the 6 × 6 × 34 input window
    from view plane od0 − qlo, row oh0 − 1, column ow0 − 1; zero outside the
    view, the image and Cin, which is padded to 16), Cout padded to 32, the
    27 taps read as one row offset (dz·6 + dy)·34 + dx from each voxel's
    position, Cin in chunks of 16; then bias, act′(dact_x) at the voxel,
    rounding to x's dtype; Σ/Σ² one partial per block, the blocks in
    order."""
    B, cin, nv, H, W = x.shape
    cout = w.shape[0]
    td, th, tw = ck._FWD_TILE_TC
    pd_n, ph_n, pw_n = td + 2, th + 2, tw + 2
    cpad, copad = -(-cin // 16) * 16, -(-cout // 32) * 32
    xa = ck.act_plain(act, x).float()
    wf = torch.zeros((copad, cpad, 27))
    wf[:cout, :cin] = w.float().reshape(cout, cin, 27)
    bf = torch.zeros(copad) if bias is None else torch.cat([bias.float(), torch.zeros(copad - cout)])
    vox = torch.tensor([(vz * ph_n + vy) * pw_n + vx for vz, vy, vx in
                        itertools.product(range(td), range(th), range(tw))])
    toff = [((t // 9) * ph_n + (t // 3) % 3) * pw_n + t % 3 for t in range(27)]
    pos = torch.tensor(list(itertools.product(range(pd_n), range(ph_n), range(pw_n))))
    tiles = list(itertools.product(range(-(-d_out // td)), range(-(-H // th)), range(-(-W // tw))))
    out = torch.zeros((B, cout, d_out, H, W), dtype=x.dtype)
    partial = torch.zeros((B, cout, len(tiles), 2))
    for b in range(B):
        for blk, (tz, ty, tx) in enumerate(tiles):
            od0, oh0, ow0 = tz * td, ty * th, tx * tw
            p, ih, iw = pos[:, 0] + od0 - qlo, pos[:, 1] + oh0 - 1, pos[:, 2] + ow0 - 1
            ok = (p >= 0) & (p < nv) & (ih >= 0) & (ih < H) & (iw >= 0) & (iw < W)
            patch = torch.zeros((len(pos), cpad))
            patch[ok, :cin] = xa[b, :, p[ok], ih[ok], iw[ok]].T
            acc = torch.zeros((copad, len(vox)))
            for c0 in range(0, cpad, 16):
                for tap in range(27):
                    acc += wf[:, c0:c0 + 16, tap] @ patch[vox + toff[tap], c0:c0 + 16].T
            val = (acc + bf[:, None]).reshape(copad, td, th, tw)[:cout]
            dz, dy, dx_ = (min(n, lim) for n, lim in ((td, d_out - od0), (th, H - oh0),
                                                     (tw, W - ow0)))
            val = val[:, :dz, :dy, :dx_]
            if dact is not None:
                val = val * ck.dact_plain(dact[0], dact[1][b, :, od0:od0 + dz, oh0:oh0 + dy,
                                                           ow0:ow0 + dx_])
            r = val.to(x.dtype)
            out[b, :, od0:od0 + dz, oh0:oh0 + dy, ow0:ow0 + dx_] = r
            rf = r.float()
            partial[b, :, blk, 0] = rf.sum(dim=(1, 2, 3))
            partial[b, :, blk, 1] = (rf * rf).sum(dim=(1, 2, 3))
    sums = torch.zeros((2, B, cout))
    for blk in range(len(tiles)):
        sums[0] += partial[:, :, blk, 0]
        sums[1] += partial[:, :, blk, 1]
    return out, sums[0], sums[1]


# (B, Cin, Cout, (H, W), planes of x, slab plane of x's first plane, output
# planes): Cin not a multiple of 16, Cout not a multiple of 32, odd H and W,
# W over one 32-column tile, x beginning before the slab and inside it, the
# window ending before the last output's planes
TC_CONV_EMULATED = [(1, 8, 40, (5, 7), 5, -1, 6), (2, 24, 8, (6, 33), 6, 0, 5),
                    (1, 20, 36, (9, 35), 7, 2, 9)]


@pytest.mark.parametrize("act", [None, "gelu", "silu"])
@pytest.mark.parametrize("case", TC_CONV_EMULATED)
def test_conv_tc_staging_matches_plain(act, case):
    """The emulated tensor-core conv (values, Σ/Σ²) and its stride-1 data
    gradient (the same kernel on g with channel-transposed, tap-flipped
    weights, qlo 2 − qlo, the act′ epilogue) against the plain versions,
    fp32 (1e-4: fp32 sums in another order)."""
    b, cin, cout, (h, w_), nv, qlo, d_out = case
    rng = np.random.default_rng(21)
    x = torch.from_numpy(rng.standard_normal((b, cin, nv, h, w_)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((cout, cin, 3, 3, 3)) /
                          np.sqrt(27 * cin)).astype(np.float32))
    bias = torch.from_numpy(rng.standard_normal(cout).astype(np.float32))
    out, s1, s2 = _conv_tc_emulated(x, w, bias, qlo, d_out, act)
    want = ck.conv3d_k3_plain(x, w, bias, 1, qlo, d_out, True, act)
    for got, ref in zip((out, s1, s2), want):
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-4, atol=1e-4)
    g = torch.from_numpy(rng.standard_normal(tuple(out.shape)).astype(np.float32))
    wt = w.transpose(0, 1).flip(2, 3, 4).contiguous()
    dx = _conv_tc_emulated(g, wt, None, 2 - qlo, nv,
                           dact=None if act is None else (act, x))[0]
    want_dx = ck.conv3d_k3_dgrad_plain(g, w, x, 1, qlo, act)
    np.testing.assert_allclose(dx.numpy(), want_dx.numpy(), rtol=1e-4, atol=1e-4)


def test_conv_tc_staging_matches_jax():
    """Against the JAX chain conv (values and Σ/Σ², interpret mode) at the
    smallest width its shape gate takes, x windowed at both ends, Cin and
    Cout ragged for the tensor-core tiles."""
    B, cin, cout, H, W, dext = 1, 12, 36, 4, 128, 7
    vlo, vhi = 1, dext - 1
    rng = np.random.default_rng(22)
    x = rng.standard_normal((B, cin, dext, H, W)).astype(np.float32)
    w = (rng.uniform(-1, 1, (cout, cin, 3, 3, 3)) / np.sqrt(27 * cin)).astype(np.float32)
    bias = rng.standard_normal(cout).astype(np.float32)
    out_j, s1_j, s2_j = jax_chain_s1((dext, H, W, True, "gelu"),
                                     jnp.asarray(x.reshape(B, cin, -1)),
                                     jnp.asarray([vlo, vhi], jnp.int32), jnp.asarray(w),
                                     jnp.asarray(bias))
    xt = torch.from_numpy(x).narrow(2, vlo, vhi - vlo)
    out, s1, s2 = _conv_tc_emulated(xt, torch.from_numpy(w), torch.from_numpy(bias), vlo,
                                    dext - 2, "gelu")
    np.testing.assert_allclose(out.reshape(B, cout, -1).numpy(), np.asarray(out_j),
                               rtol=1e-4, atol=1e-4)
    for got, ref in ((s1, s1_j), (s2, s2_j)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-3)


# ------------------------------------------ the tensor-core flash forward ---

def _flash_tc_emulated(q, k, v, scale):
    """(out, lse) as the tensor-core kernel A computes them from bf16 q, k, v:
    per tile of 64 keys S = q·kᵀ in fp32, m_new = max(m, rowmax(S)·scale·
    log2e), p = exp2(S·scale·log2e − m_new), l = l·α + Σ bf16(p) (the
    rounded values), l_e = l_e·α + Σ p, O = O·α + bf16(p)·v; out = O / l in
    bf16, lse = (m + log2 l_e)·ln 2."""
    c = scale * math.log2(math.e)
    qf, kf, vf = q.float(), k.float(), v.float()
    bh, nq, d = q.shape
    m = torch.full((bh, nq), -math.inf)
    l = torch.zeros((bh, nq))
    le = torch.zeros((bh, nq))
    o = torch.zeros((bh, nq, d))
    for t0 in range(0, k.shape[1], 64):
        s = qf @ kf[:, t0:t0 + 64].transpose(1, 2)
        m_new = torch.maximum(m, s.amax(-1) * c)
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s * c - m_new[..., None])
        pr = p.to(torch.bfloat16).float()
        l = l * alpha + pr.sum(-1)
        le = le * alpha + p.sum(-1)
        o = o * alpha[..., None] + pr @ vf[:, t0:t0 + 64]
        m = m_new
    return (o / l[..., None]).to(q.dtype), (m + torch.log2(le)) * math.log(2.0)


# (BH, Nq, Nk, d): ragged Nq and Nk (not multiples of 64), several key tiles
FLASH_EMULATED = [(2, 77, 200, 32), (2, 130, 77, 64), (1, 64, 129, 32), (3, 50, 300, 64)]


def _bf16_qkv(bh, nq, nk, d, seed):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(BF16)
                 for s in ((bh, nq, d), (bh, nk, d), (bh, nk, d)))


@pytest.mark.parametrize("shape", FLASH_EMULATED)
def test_flash_tc_emulated_matches_plain(shape):
    """Within chip_smoke.py's tolerances: the output's bf16 one (2e-2 +
    2e-2·|want|: it rounds once to bf16 on both sides, and p's rounding to
    bf16 moves it by a few bf16 ulps at most), the lse's fp32 one (1e-4 +
    1e-4·|want|: fp32 from the same bf16 inputs on both sides)."""
    bh, nq, nk, d = shape
    q, k, v = _bf16_qkv(bh, nq, nk, d, 31)
    out, lse = _flash_tc_emulated(q, k, v, d ** -0.5)
    want_out, want_lse = fa.flash_attention_plain(q, k, v, d ** -0.5)
    assert out.dtype == BF16 and lse.dtype == F32
    np.testing.assert_allclose(out.float().numpy(), want_out.float().numpy(), rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(lse.numpy(), want_lse.numpy(), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("shape", FLASH_EMULATED)
def test_flash_tc_emulated_matches_jax(shape):
    """Against the JAX forward kernel ``_flash_fwd_padded`` (interpret mode)
    on the same bf16 inputs, prepared as ``_flash_fwd_core`` prepares them
    (q pre-scaled by scale·log2e in bf16, d padded to 128 with the ones-lane,
    keys padded to the block). Both round p to bf16 into P·V and normalize
    by the sum of the rounded values; they differ in the key blocks (64
    here, 128 there), in the lse (JAX's from the rounded sum, 2^-9 relative
    per p at most), and in JAX's pre-scale, where the constant scale·log2e
    and then q·(that constant) round to bf16, scaling every score by up to
    2^-8 (0.26% relative at d = 32 and 64): bf16 tolerance 3e-2 on out
    (ROADMAP's flash bf16 bound), and 2e-3 + 2^-8·|lse| on the natural-log
    lse."""
    bh, nq, nk, d = shape
    q, k, v = _bf16_qkv(bh, nq, nk, d, 32)
    scale = d ** -0.5
    out, lse = _flash_tc_emulated(q, k, v, scale)
    qj, kj, vj = (jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in (q, k, v))
    d_pad, bq, bkv = 128, 64, 128
    nq_pad, nk_pad = -(-nq // bq) * bq, -(-nk // bkv) * bkv
    qs = qj * jnp.asarray(scale * jfa.LOG2E, jnp.bfloat16)
    qp = jnp.pad(qs, ((0, 0), (0, nq_pad - nq), (0, d_pad - d)))
    kp = jnp.pad(kj, ((0, 0), (0, nk_pad - nk), (0, d_pad - d)))
    vp = jnp.pad(vj, ((0, 0), (0, nk_pad - nk), (0, d_pad - d))).at[:, :, d].set(1.0)
    out_j, lse_j = jfa._flash_fwd_padded(qp, kp, vp, nk, bq, bkv, d, interpret=True)
    out_j = np.asarray(out_j[:, :nq, :d].astype(jnp.float32))
    lse_j = np.asarray(lse_j[:, :nq, 0]) * math.log(2.0)
    np.testing.assert_allclose(out.float().numpy(), out_j, rtol=3e-2, atol=3e-2)
    np.testing.assert_allclose(lse.numpy(), lse_j, rtol=2.0 ** -8, atol=2e-3)
