"""The plans of the port's tensor-core forward kernels, on the CPU: which
instance of the conv (B/H at stride 1, C/I at stride 2) and of the flash
forward (A) a call takes, how many Σ/Σ² partials the conv writes, and torch
emulations of the tensor-core kernels' arithmetic against the plain versions
and the JAX package.

- ``fwd_uses_tensor_cores`` / ``fwd_plan``: bf16 with Cin ≥ 8 and Cout ≥ 8
  takes the tensor-core conv at either stride, everything else the CUDA-core
  one (the rule of ``fwd_uses_tc`` in csrc/conv3d_k3.cu); the partial buffer
  the wrapper allocates holds one entry per block of either instance's grid,
  at every conv shape of ``chip_smoke.py`` (forward, and the stride-1 data
  gradient with its qlo = 2 − qlo).
- The stride-2 tensor-core conv's staging (2 × 4 × 16 voxel tiles, raw rows
  of 8-column vectors from column 2·ow0 − 8, the even and the odd columns
  apart in the channels-innermost patch, the window and the act prologue at
  the load, the weights in ``s2_tc_weights``'s layout, Cout tiles of 64,
  Σ/Σ² per block), replayed in torch, against ``conv3d_k3_plain`` and the JAX
  ``conv3d_k3s2_chain`` (``_conv_fwd_s2`` in interpret mode).
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
from hybrid_vit_cascade_tpu.ops.pallas.conv3d_k3s2 import conv3d_k3s2_chain as jax_chain_s2
from hybrid_vit_cascade_tpu_torch.ops.cuda import conv3d_k3 as ck
from hybrid_vit_cascade_tpu_torch.ops.cuda import flash_attention as fa
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

jfa = importlib.import_module("hybrid_vit_cascade_tpu.ops.pallas.flash_attention")

BF16, F32 = torch.bfloat16, torch.float32


TC, C1IN, CC = ck.FWD_TC, ck.FWD_C1IN_TC, ck.FWD_CUDA_CORE


@pytest.mark.parametrize("dtype,stride,cin,cout,tc", [
    (BF16, 1, 64, 32, TC), (BF16, 1, 32, 64, TC), (BF16, 1, 8, 8, TC),
    (BF16, 1, 128, 256, TC), (BF16, 1, 24, 40, TC), (BF16, 1, 7, 32, CC),
    (BF16, 1, 1, 64, C1IN), (BF16, 1, 64, 1, CC), (BF16, 1, 32, 7, CC),
    (BF16, 2, 32, 64, TC), (F32, 1, 64, 32, CC), (F32, 1, 1, 32, CC),
    (BF16, 2, 8, 8, TC), (BF16, 2, 128, 256, TC), (BF16, 2, 24, 40, TC),
    (BF16, 2, 1, 64, C1IN), (BF16, 2, 7, 32, CC), (BF16, 2, 32, 7, CC),
    (F32, 2, 32, 64, CC)])
def test_conv_fwd_dispatch_rule(dtype, stride, cin, cout, tc):
    """The instance a call with Σ/Σ² takes: the 16-channel-chunk tensor
    cores (``fwd_uses_tensor_cores``), the one-input-channel tensor cores
    (bf16 1→64 at stride 1 or 2) or the CUDA cores."""
    assert ck.fwd_uses_tensor_cores(dtype, stride, cin, cout) is (tc == TC)
    assert ck.fwd_c1in_uses_tensor_cores(dtype, stride, cin, cout) is (tc == C1IN)
    assert ck.fwd_plan((1, cin, 8, 16, 16), cout, stride, dtype)[0] == tc


def _c_blocks(instance: int, stride: int, do: int, h: int, w: int) -> int:
    """The blocks per (batch, Cout tile) that csrc/conv3d_k3.cu launches:
    launch_tc's tiles of 4 planes × 4 rows × 32 columns (stride 1),
    launch_tc_s2's of 2 planes × 4 rows × 16 output columns (stride 2),
    launch_c1in_tc<1>'s of 4 planes × 4 rows × 64 columns (stride 1),
    launch_c1in_tc<2>'s of 4 planes × 4 rows × 32 output columns (stride 2),
    or launch's grid of Do planes × 8-row tiles × 32 (stride 1) or 16
    (stride 2) columns."""
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    if instance == TC and stride == 1:
        return -(-do // 4) * -(-h // 4) * -(-w // 32)
    if instance == TC:
        return -(-do // 2) * -(-ho // 4) * -(-wo // 16)
    if instance == C1IN and stride == 1:
        return -(-do // 4) * -(-h // 4) * -(-w // 64)
    if instance == C1IN:
        return -(-do // 4) * -(-ho // 4) * -(-wo // 32)
    return do * -(-ho // 8) * -(-wo // (32 if stride == 1 else 16))


def _fwd_calls():
    """(name, out_shape, cout, stride) of every conv-forward kernel call at the
    shapes of chip_smoke.py: the forward at each dense and chain shape, and
    the stride-1 data gradient (the forward on g, Cin and Cout swapped, nv
    output planes, qlo = 2 − qlo)."""
    calls = []
    for name in chip_smoke.KERNELS:
        if not name.startswith("conv3d"):
            continue
        s = 2 if name.startswith("conv3d_k3s2") else 1
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
        inst, tile, nblk = ck.fwd_plan(out_shape, cout, stride, dtype)
        assert (inst == TC) == ck.fwd_uses_tensor_cores(dtype, stride, cin, cout)
        assert (inst == C1IN) == ck.fwd_c1in_uses_tensor_cores(dtype, stride, cin, cout)
        assert nblk == _c_blocks(inst, stride, do, h, w), (name, out_shape)
        assert ck.fwd_partial_blocks(out_shape, stride) == max(
            _c_blocks(i, stride, do, h, w) for i in (TC, C1IN, CC)
        ), (name, out_shape)
        tc_tile = (4, 4, 32) if stride == 1 else (2, 4, 16)
        c1in_tile = (4, 4, 64) if stride == 1 else (4, 4, 32)
        assert tile == {TC: tc_tile, C1IN: c1in_tile, CC: (1, 8, 32 if stride == 1 else 16)}[inst]
        if dtype == BF16 and cin >= 8 and cout >= 8:
            assert inst == TC, (name, out_shape)
        if dtype == BF16 and cin == 1 and cout >= 8:
            assert inst == C1IN, (name, out_shape)


def test_conv_fwd_hot_plan():
    """The 64→32 conv at 256³: 64 × 64 × 8 = 32,768 tensor-core blocks of 512
    voxels; the CUDA-core plan of the same call in fp32: 256 × 32 × 8."""
    assert ck.fwd_plan((1, 64, 256, 256, 256), 32, 1, BF16) == (True, (4, 4, 32), 32768)
    assert ck.fwd_plan((1, 64, 256, 256, 256), 32, 1, F32) == (False, (1, 8, 32), 65536)


def test_conv_s2_hot_plan():
    """The 32→64 stride-2 conv from 256³ on the tensor cores: 64 × 32 × 8 =
    16,384 blocks of 2 × 4 × 16 output voxels, one Cout tile of 64 each; the
    CUDA-core plan of the same call in fp32: 128 planes × 16 × 8."""
    assert ck.fwd_plan((1, 32, 128, 256, 256), 64, 2, BF16) == (True, (2, 4, 16), 16384)
    assert ck.fwd_plan((1, 32, 128, 256, 256), 64, 2, F32) == (False, (1, 8, 16), 16384)


def _s2_calls():
    """(B, Cin, Cout, output planes, H, W) of every stride-2 conv forward of
    chip_smoke.py, dense and chain, main path and ragged."""
    calls = [(b, cin, cout, (d - 1) // 2 + 1, h, w)
             for name in ("conv3d_k3s2", "conv3d_k3s2_c1in")
             for b, cin, cout, (d, h, w) in (chip_smoke.KERNELS[name]["shapes"]
                                            + chip_smoke.KERNELS[name]["ragged"])]
    spec = chip_smoke.CHAIN_KERNELS["conv3d_k3s2_chain"]
    calls += [(b, cin, cout, d_out, h, w)
              for b, cin, cout, _, h, w, _, d_out, _, _ in spec["shapes"] + spec["ragged"]]
    return calls


@pytest.mark.parametrize("call", _s2_calls())
def test_conv_s2_partials_cover_tc_grid(call):
    """At every stride-2 conv of the main path and the ragged ones, the
    Σ/Σ² buffer holds one partial per block of the stride-2 tensor-core grid
    (2 × 4 × 16 output voxels a block, launch_tc_s2), which the bf16 calls
    with Cin, Cout ≥ 8 take, of the one-input-channel grid (4 × 4 × 32,
    launch_c1in_tc<2>), which the bf16 1→64 stem takes, and of the CUDA-core
    grid."""
    b, cin, cout, do, h, w = call
    nblk = ck.fwd_partial_blocks((b, cin, do, h, w), 2)
    tc_blocks, c1in_blocks = _c_blocks(TC, 2, do, h, w), _c_blocks(C1IN, 2, do, h, w)
    assert nblk == max(tc_blocks, c1in_blocks, _c_blocks(CC, 2, do, h, w))
    inst, tile, blocks = ck.fwd_plan((b, cin, do, h, w), cout, 2, BF16)
    assert (inst == TC) == (cin >= 8 and cout >= 8)
    assert (inst == C1IN) == (cin == 1 and cout >= 8)
    if inst == TC:
        assert tile == (2, 4, 16) and blocks == tc_blocks <= nblk
    if inst == C1IN:
        assert tile == (4, 4, 32) and blocks == c1in_blocks <= nblk


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
    td, th, tw = ck._FWD_TILE_TC[1]
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


# ------------------------------------------ the stride-2 tensor-core conv ---

def _conv_tc_s2_emulated(x, w, bias, qlo, d_out, act=None):
    """out, Σ, Σ² as the stride-2 tensor-core conv computes them, fp32
    products of the operands in x's dtype: per 2 × 4 × 16 output-voxel tile,
    the raw rows (5 planes from view plane 2·od0 − qlo × 9 rows from 2·oh0 −
    1) of 8-column vectors from input column 2·ow0 − 8, zero outside the view,
    the image and Cin, the prologue applied; the patch [row][position][ci]
    takes raw column 7 + pw at position (pw % 2)·17 + pw // 2 (even columns,
    then odd); output voxel (vz, vy, ox) reads patch row (2vz + dz)·9 + 2vy +
    dy, position ox + (0, 17, 1)[dx] at tap (dz, dy, dx); the weights from
    ``s2_tc_weights`` (Cout tiles of 64, Cin chunks of 16); then bias and
    rounding to x's dtype; Σ/Σ² one partial per block, the blocks in
    order."""
    B, cin, nv, H, W = x.shape
    cout = w.shape[0]
    td, th, tw = ck._FWD_TILE_TC[2]
    ho, wo = (H - 1) // 2 + 1, (W - 1) // 2 + 1
    pd_n, ph_n, pw_n, nraw = 2 * td + 1, 2 * th + 1, 2 * tw + 1, 8 * 5
    xa = ck.act_plain(act, x).float()
    wt = ck.s2_tc_weights(w).float()
    n_co, n_ci = wt.shape[:2]
    cpad = 16 * n_ci
    pos_of = torch.tensor([(pw % 2) * (tw + 1) + pw // 2 for pw in range(pw_n)])
    vz, vy, ox = (t.reshape(-1) for t in torch.meshgrid(
        torch.arange(td), torch.arange(th), torch.arange(tw), indexing="ij"))
    bf = torch.zeros(n_co * 64) if bias is None else \
        torch.cat([bias.float(), torch.zeros(n_co * 64 - cout)])
    tiles = list(itertools.product(range(-(-d_out // td)), range(-(-ho // th)), range(-(-wo // tw))))
    out = torch.zeros((B, cout, d_out, ho, wo), dtype=x.dtype)
    partial = torch.zeros((B, cout, len(tiles), 2))
    for b in range(B):
        for blk, (tz, ty, tx) in enumerate(tiles):
            od0, oh0, ow0 = tz * td, ty * th, tx * tw
            raw = torch.zeros((cpad, pd_n, ph_n, nraw))
            p = torch.arange(pd_n) + 2 * od0 - qlo
            ih = torch.arange(ph_n) + 2 * oh0 - 1
            c = torch.arange(nraw) + 2 * ow0 - 8
            pm, hm, cm = (p >= 0) & (p < nv), (ih >= 0) & (ih < H), (c >= 0) & (c < W)
            sub = xa[b][:, p[pm]][:, :, ih[hm]][:, :, :, c[cm]]
            raw[:cin, pm.nonzero()[:, 0, None, None], hm.nonzero()[:, 0, None],
                cm.nonzero()[:, 0]] = sub
            patch = torch.zeros((pd_n * ph_n, pw_n, cpad))
            patch[:, pos_of] = raw[:, :, :, 7:7 + pw_n].reshape(cpad, pd_n * ph_n, pw_n).permute(1, 2, 0)
            acc = torch.zeros((n_co * 64, len(vz)))
            for ct in range(n_co):
                for ch in range(n_ci):
                    for tap in range(27):
                        dz, dy, dx = tap // 9, (tap // 3) % 3, tap % 3
                        rows = (2 * vz + dz) * ph_n + 2 * vy + dy
                        bmat = patch[rows, ox + (0, tw + 1, 1)[dx], 16 * ch:16 * ch + 16]
                        acc[64 * ct:64 * ct + 64] += wt[ct, ch, tap] @ bmat.T
            val = (acc + bf[:, None]).reshape(-1, td, th, tw)[:cout]
            dz_, dy_, dx_ = (min(n, lim) for n, lim in ((td, d_out - od0), (th, ho - oh0),
                                                       (tw, wo - ow0)))
            r = val[:, :dz_, :dy_, :dx_].to(x.dtype)
            out[b, :, od0:od0 + dz_, oh0:oh0 + dy_, ow0:ow0 + dx_] = r
            rf = r.float()
            partial[b, :, blk, 0] = rf.sum(dim=(1, 2, 3))
            partial[b, :, blk, 1] = (rf * rf).sum(dim=(1, 2, 3))
    sums = torch.zeros((2, B, cout))
    for blk in range(len(tiles)):
        sums[0] += partial[:, :, blk, 0]
        sums[1] += partial[:, :, blk, 1]
    return out, sums[0], sums[1]


# (B, Cin, Cout, (H, W), planes of x, slab plane of x's first plane, output
# planes): Cin not a multiple of 16, Cout not a multiple of 64 and over one
# tile, odd H and W, Wo over one 16-column tile, x beginning before the slab
# and inside it, the window ending before the last output's planes
TC_S2_EMULATED = [(1, 8, 40, (5, 7), 5, -1, 3), (2, 24, 8, (6, 33), 6, 0, 3),
                  (1, 20, 72, (9, 35), 7, 2, 4)]


@pytest.mark.parametrize("act", [None, "silu"])
@pytest.mark.parametrize("case", TC_S2_EMULATED)
def test_conv_tc_s2_staging_matches_plain(act, case):
    """The emulated stride-2 tensor-core conv (values, Σ/Σ²) against the
    plain version, fp32 (1e-4: fp32 sums in another order)."""
    b, cin, cout, (h, w_), nv, qlo, d_out = case
    rng = np.random.default_rng(23)
    x = torch.from_numpy(rng.standard_normal((b, cin, nv, h, w_)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((cout, cin, 3, 3, 3)) /
                          np.sqrt(27 * cin)).astype(np.float32))
    bias = torch.from_numpy(rng.standard_normal(cout).astype(np.float32))
    got = _conv_tc_s2_emulated(x, w, bias, qlo, d_out, act)
    want = ck.conv3d_k3_plain(x, w, bias, 2, qlo, d_out, True, act)
    for g, ref in zip(got, want):
        np.testing.assert_allclose(g.numpy(), ref.numpy(), rtol=1e-4, atol=1e-4)


def test_s2_tc_weights_layout():
    """``s2_tc_weights``: element (co, ci, tap) of the weights at [co // 64,
    ci // 16, tap, co % 64, ci % 16], zeros in the padding."""
    rng = np.random.default_rng(24)
    w = torch.from_numpy(rng.standard_normal((72, 20, 3, 3, 3)).astype(np.float32))
    wt = ck.s2_tc_weights(w)
    assert tuple(wt.shape) == (2, 2, 27, 64, 16) and wt.is_contiguous()
    flat = w.reshape(72, 20, 27)
    for co, ci, tap in itertools.product((0, 63, 64, 71), (0, 15, 16, 19), (0, 13, 26)):
        assert wt[co // 64, ci // 16, tap, co % 64, ci % 16] == flat[co, ci, tap]
    assert wt[1, :, :, 8:].abs().sum() == 0 and wt[:, 1, :, :, 4:].abs().sum() == 0


def test_conv_tc_s2_staging_matches_jax():
    """Against the JAX stride-2 chain conv (values and Σ/Σ², interpret mode)
    at the smallest width its shape gate takes (W % 256 = 0), x windowed at
    the front, the gelu prologue, Cin and Cout ragged for the tensor-core
    tiles."""
    B, cin, cout, H, W, dext = 1, 12, 72, 4, 256, 7
    vlo, vhi = 1, dext
    d_out = (dext - 1) // 2
    rng = np.random.default_rng(25)
    x = rng.standard_normal((B, cin, dext, H, W)).astype(np.float32)
    w = (rng.uniform(-1, 1, (cout, cin, 3, 3, 3)) / np.sqrt(27 * cin)).astype(np.float32)
    bias = rng.standard_normal(cout).astype(np.float32)
    out_j, s1_j, s2_j = jax_chain_s2((dext, H, W, True, "gelu"),
                                     jnp.asarray(x.reshape(B, cin, -1)),
                                     jnp.asarray([vlo, vhi], jnp.int32), jnp.asarray(w),
                                     jnp.asarray(bias))
    xt = torch.from_numpy(x).narrow(2, vlo, vhi - vlo)
    out, s1, s2 = _conv_tc_s2_emulated(xt, torch.from_numpy(w), torch.from_numpy(bias), vlo,
                                       d_out, "gelu")
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
