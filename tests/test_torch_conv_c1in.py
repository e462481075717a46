"""The one-input-channel tensor-core instances of the stride-1 conv forward
(B/H) and weight gradient (E/K), on the CPU: their dispatch rules against
the kernel sources, their plans (the Σ/Σ² partials and the weight
gradient's splits at every conv shape of ``chip_smoke.py``), and torch
replays of each kernel's arithmetic against the plain versions and the JAX
package.

- The forward (``csrc/conv3d_k3.cu``, ``conv_c1in_tc_kernel``): bf16 at
  stride 1 with Cin = 1, Cout ≥ 8 and no act′ epilogue
  (``fwd_c1in_uses_tensor_cores``); per block of 4 planes × 4 rows × 64
  columns and Cout tile of 32 (Cout ≤ 32) or 64, three copies of the input
  patch pre-shifted by dx − 1 (built from x's 8-column vectors from column
  ow0 − 8, zero outside the view and the image, the act prologue rounded to
  x's dtype), tap t = (dz, dy, dx) read as row (dz, dy) of copy dx, taps
  27-31 zero; the accumulators start at the bias, one rounding, Σ/Σ² of the
  rounded values one partial per block. Against ``conv3d_k3_plain`` (fp32,
  1e-4: the same products in another order; bf16 at the card's TOL) and the
  JAX ``conv3d_k3s1_chain`` (``_conv_kernel_smallcin`` in interpret mode;
  tests/test_pallas_conv.py's 1e-5/1e-4 for the values).
- The weight gradient (``csrc/conv3d_k3_bwd.cu``, ``wgrad_c1in_tc_kernel``):
  bf16 at stride 1 with Cin = 1 (instance 2 of ``wgrad_instance``); tiles of
  2 planes × 2 rows × 64 columns, split s taking the tiles s, s + splits, …,
  the same copies, warp w the K steps 2w and 2w + 1 of a tile, every
  ``kW1Flush`` tiles and after the last the 8 warps' accumulators added in
  warp order into the split's partial, the partials summed by
  ``sum_split_partials_kernel``'s order. Against ``conv3d_k3_wgrad_plain``
  (fp32, 1e-4) and dW of the JAX ``conv3d_k3s1_chain`` VJP (``_wgrad`` in
  interpret mode; the conv VJP's 1e-4/1e-3 of tests/test_pallas_conv.py).
"""

import itertools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from hybrid_vit_cascade_tpu.ops.pallas.conv3d_k3 import conv3d_k3s1_chain as jax_chain_s1
from hybrid_vit_cascade_tpu_torch.ops.cuda import _build
from hybrid_vit_cascade_tpu_torch.ops.cuda import conv3d_k3 as ck
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

BF16, F32 = torch.bfloat16, torch.float32
H100_SMS = 132


def _src(name):
    return (_build.CSRC_DIR / name).read_text()


def _const(src, name):
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


# ----------------------------------------------------------------- rules ---

@pytest.mark.parametrize("dtype,stride,cin,cout,dact,tc", [
    (BF16, 1, 1, 64, False, True), (BF16, 1, 1, 32, False, True), (BF16, 1, 1, 8, False, True),
    (BF16, 1, 1, 40, False, True), (BF16, 1, 1, 256, False, True), (BF16, 1, 1, 7, False, False),
    (BF16, 1, 1, 1, False, False), (BF16, 1, 1, 64, True, False), (BF16, 1, 2, 64, False, False),
    (BF16, 1, 7, 64, False, False), (BF16, 2, 1, 64, False, True), (F32, 1, 1, 64, False, False),
    (F32, 1, 1, 32, False, False)])
def test_fwd_c1in_dispatch_rule(dtype, stride, cin, cout, dact, tc):
    """bf16 at stride 1 or 2, Cin = 1, Cout ≥ 8, no act′: the
    one-input-channel tensor cores; the other instances' rules take none of
    those calls."""
    assert ck.fwd_c1in_uses_tensor_cores(dtype, stride, cin, cout, dact) is tc
    if tc:
        assert not ck.fwd_uses_tensor_cores(dtype, stride, cin, cout)
        assert not ck.dgrad_c1_uses_tensor_cores(dtype, cin, cout)


@pytest.mark.parametrize("dtype,stride,cin,instance", [
    (BF16, 1, 1, ck.WGRAD_C1IN_TC), (BF16, 2, 1, ck.WGRAD_C1IN_S2_TC),
    (BF16, 1, 2, ck.WGRAD_CUDA_CORE), (BF16, 1, 7, ck.WGRAD_CUDA_CORE),
    (BF16, 1, 8, ck.WGRAD_TC), (BF16, 2, 64, ck.WGRAD_TC), (F32, 1, 1, ck.WGRAD_CUDA_CORE),
    (F32, 2, 1, ck.WGRAD_CUDA_CORE)])
def test_wgrad_c1in_dispatch_rule(dtype, stride, cin, instance):
    assert ck.wgrad_instance(dtype, stride, cin) == instance
    assert ck.wgrad_plan((1, cin, 8, 16, 16), 64, stride, dtype, H100_SMS)[0] == instance


def test_c1in_rules_and_tilings_are_the_kernels():
    """The Python rules, tiles and blockings state what the sources do."""
    fwd, bwd = _src("conv3d_k3.cu"), _src("conv3d_k3_bwd.cu")
    assert ("return (stride == 1 || stride == 2) && bf16 && cin == 1 && cout >= 8 && dact == 0;"
            in fwd)
    assert "constexpr int kCiTd = 4, kCiTh = 4, kCiTw = 64;" in fwd
    assert ck._FWD_TILE_C1IN[1] == (4, 4, 64)
    assert "return cout <= 32\n" in fwd  # Cout tiles of 32 for Cout ≤ 32, else 64
    assert ("  if (cin >= 8) return 1;\n  if (cin != 1) return 0;\n  return stride == 1 ? 2 : 3;"
            in bwd)
    assert "constexpr int kW1Td = 2, kW1Th = 2, kW1Tw = 64;" in bwd
    assert (_const(bwd, "kW1Co"), _const(bwd, "kW1Warps"), _const(bwd, "kW1Stages")) == (32, 8, 3)
    assert "__launch_bounds__(kW1Threads, 3)" in bwd
    assert ck.wgrad_blocking(ck.WGRAD_C1IN_TC, 1, 1) == ((2, 2, 64), 32, 1, 3)
    assert "constexpr int kW1Flush = 16384 / (kW1Nv / kW1Warps);" in bwd


def test_c1in_copy_pitches_spread_the_taps():
    """Both kernels' copy pitches start tap t = (dz, dy, dx) 16·t bytes (mod
    128) after tap 0, and the zero rows of taps 27-31 continue the pattern,
    so the 8 rows of every ldmatrix phase are 8 different bank groups."""
    for src, pre, planes, rows in ((_src("conv3d_k3.cu"), "kCi", 6, 6),
                                   (_src("conv3d_k3_bwd.cu"), "kW1", 4, 4)):
        row, plane, copy = (2 * _const(src, pre + n) for n in ("Row", "Plane", "Copy"))
        assert row >= 2 * 64 and plane >= rows * row and copy >= planes * plane
        offs = [dx * copy + dz * plane + dy * row
                for dz, dy, dx in itertools.product(range(3), repeat=3)]
        assert [o % 128 for o in offs] == [16 * t % 128 for t in range(27)]
        assert 3 * copy % 128 == 16 * 27 % 128  # the zero rows' start
        for t0 in range(0, 27, 8):
            assert len({(16 * t) % 128 for t in range(t0, t0 + 8)}) == 8


def test_c1in_variant_switches_match_the_kernels():
    """scripts/c1in_variants.py edits copies of both kernels' sources (the
    forward's direct stores, the weight gradient's other orientation, parts
    switched off): every switch still finds its text."""
    from hybrid_vit_cascade_tpu_torch.scripts import c1in_variants

    for name, switches in c1in_variants.SWITCHES.items():
        src = c1in_variants.ablated_source(name)
        assert all(new in src for _, new in switches.values())
        assert set(c1in_variants.VARIANTS[name]) <= {0, 1, 2, 4, 8, 16}


# ----------------------------------------------------------------- plans ---

def _c1in_calls():
    """(B, Cout, output planes, H, W) of every stride-1 conv forward with one
    input channel in chip_smoke.py: dense, chain, main path and ragged."""
    spec = chip_smoke.KERNELS["conv3d_k3s1_c1in"]
    calls = [(b, cout, d, h, w) for b, cin, cout, (d, h, w) in spec["shapes"] + spec["ragged"]]
    spec = chip_smoke.CHAIN_KERNELS["conv3d_k3s1_chain_c1in"]
    calls += [(b, cout, d_out, h, w) for b, cin, cout, _, h, w, _, d_out, _, _ in
              spec["shapes"] + spec["ragged"]]
    assert all(c[1] == 1 for c in spec["shapes"] + spec["ragged"])
    return calls


@pytest.mark.parametrize("call", _c1in_calls())
def test_fwd_c1in_partials_cover_every_grid(call):
    """At every one-input-channel conv of chip_smoke.py the bf16 call plans
    the one-input-channel grid (4 × 4 × 64 voxels a block), and the Σ/Σ²
    buffer holds one partial per block of each of the three instances'
    grids."""
    b, cout, do, h, w = call
    out_shape = (b, 1, do, h, w)
    inst, tile, blocks = ck.fwd_plan(out_shape, cout, 1, BF16)
    assert (inst, tile) == (ck.FWD_C1IN_TC, (4, 4, 64))
    assert blocks == -(-do // 4) * -(-h // 4) * -(-w // 64)
    nblk = ck.fwd_partial_blocks(out_shape, 1)
    for t in ((4, 4, 64), (4, 4, 32), (1, 8, 32)):
        assert nblk >= -(-do // t[0]) * -(-h // t[1]) * -(-w // t[2])
    assert ck.fwd_plan(out_shape, cout, 1, F32)[0] == ck.FWD_CUDA_CORE


def _wgrad_c1in_calls():
    """(B, Cout, output planes, H, W) of every stride-1 weight gradient with
    one input channel in chip_smoke.py, and ragged ones."""
    spec = chip_smoke.TRAIN_KERNELS["conv3d_k3s1_c1in_wgrad"]
    calls = [(b, cout, d, h, w) for b, cin, cout, (d, h, w) in spec["shapes"] + spec["ragged"]]
    spec = chip_smoke.CHAIN_KERNELS["conv3d_k3s1_chain_wgrad"]
    calls += [(b, cout, d_out, h, w) for b, cin, cout, _, h, w, _, d_out, _, _ in
              spec["shapes"] + spec["ragged"] if cin == 1]
    return calls + [(1, 8, 3, 5, 9), (2, 40, 7, 6, 70), (1, 64, 1, 1, 1)]


@pytest.mark.parametrize("call", _wgrad_c1in_calls())
def test_wgrad_c1in_splits_cover_every_tile(call):
    """The plan's splits give every tile of 2 × 2 × 64 voxels to one split,
    in the kernel's order (split s: tiles s, s + splits, …), none empty,
    three blocks an SM at most; the partial buffer is splits × Cout × 27."""
    b, cout, do, h, w = call
    for sms in (H100_SMS, 5):
        inst, splits, n_tiles = ck.wgrad_plan((b, 1, do, h, w), cout, 1, BF16, sms)
        assert inst == ck.WGRAD_C1IN_TC
        assert n_tiles == b * -(-do // 2) * -(-h // 2) * -(-w // 64)
        parts = [list(range(s, n_tiles, splits)) for s in range(splits)]
        assert all(parts) and sorted(t for p in parts for t in p) == list(range(n_tiles))
        assert splits == 1 or splits * -(-cout // 32) <= 3 * sms


def test_wgrad_c1in_hot_plan():
    """1→64 at 256³: 65,536 tiles in 198 splits × 2 Cout tiles, three blocks
    on each of the 132 SMs."""
    assert ck.wgrad_plan((1, 1, 256, 256, 256), 64, 1, BF16, H100_SMS) == \
        (ck.WGRAD_C1IN_TC, 198, 65536)


# ---------------------------------------------------------- the forward ---

def _copies(xa, b, p0, ih0, ow0, planes, rows, width, nv, H, W):
    """The kernels' three copies of a patch: raw rows of x from column
    ow0 − 8 (zero outside the view and the image), copy dx column c = raw
    column c + 7 + dx (the byte-permute shifts)."""
    raw = torch.zeros((planes, rows, width + 16))
    for pd, ph in itertools.product(range(planes), range(rows)):
        p, ih = p0 + pd, ih0 + ph
        if 0 <= p < nv and 0 <= ih < H:
            lo, hi = max(ow0 - 8, 0), min(ow0 + width + 8, W)
            if hi > lo:
                raw[pd, ph, lo - (ow0 - 8):hi - (ow0 - 8)] = xa[b, 0, p, ih, lo:hi]
    return torch.stack([raw[:, :, 7 + dx:7 + dx + width] for dx in range(3)])


def _taps(copies, vz, vy, cols):
    """B rows of the 32 taps (27-31 zero) for voxels (vz, vy, cols)."""
    rows = [copies[t % 3, vz + t // 9, vy + (t // 3) % 3, cols] for t in range(27)]
    return torch.cat([torch.stack(rows), torch.zeros((5, len(cols)))])


def _fwd_c1in_emulated(x, w, bias, qlo, d_out, act=None):
    """out, Σ, Σ² as ``conv_c1in_tc_kernel`` computes them: per block and Cout
    tile, the copies, P = W[co, tap]·B[tap, voxel] over 32 taps added to the
    bias, one rounding to x's dtype, Σ/Σ² of the rounded values inside the
    output one partial per block, the blocks' partials in order."""
    B, _, nv, H, W = x.shape
    cout = w.shape[0]
    td, th, tw = ck._FWD_TILE_C1IN[1]
    co_t = 32 if cout <= 32 else 64
    xa = ck.act_plain(act, x).float()
    wpad = torch.zeros((-(-cout // co_t) * co_t, 32))
    wpad[:cout, :27] = w.float().reshape(cout, 27)
    bpad = torch.zeros(wpad.shape[0])
    bpad[:cout] = bias.float()
    out = torch.zeros((B, cout, d_out, H, W), dtype=x.dtype)
    tiles = list(itertools.product(range(-(-d_out // td)), range(-(-H // th)), range(-(-W // tw))))
    partial = torch.zeros((B, cout, len(tiles), 2))
    for b, (blk, (tz, ty, tx)) in itertools.product(range(B), enumerate(tiles)):
        od0, oh0, ow0 = tz * td, ty * th, tx * tw
        copies = _copies(xa, b, od0 - qlo, oh0 - 1, ow0, td + 2, th + 2, tw, nv, H, W)
        bmat = torch.cat([_taps(copies, vz, vy, torch.arange(tw))
                          for vz, vy in itertools.product(range(td), range(th))], dim=1)
        for co0 in range(0, cout, co_t):
            acc = bpad[co0:co0 + co_t, None] + wpad[co0:co0 + co_t] @ bmat
            nz, ny, nx = min(td, d_out - od0), min(th, H - oh0), min(tw, W - ow0)
            n_co = min(co_t, cout - co0)
            val = acc.reshape(co_t, td, th, tw)[:n_co, :nz, :ny, :nx].to(x.dtype)
            out[b, co0:co0 + n_co, od0:od0 + nz, oh0:oh0 + ny, ow0:ow0 + nx] = val
            vf = val.float()
            partial[b, co0:co0 + n_co, blk, 0] = vf.sum(dim=(1, 2, 3))
            partial[b, co0:co0 + n_co, blk, 1] = (vf * vf).sum(dim=(1, 2, 3))
    sums = torch.zeros((2, B, cout))
    for blk in range(len(tiles)):
        sums += partial[:, :, blk].permute(2, 0, 1)
    return out, sums[0], sums[1]


# (B, Cout, planes of x, H, W, slab plane of x's first plane, output planes):
# Cout 8 / 40 (Cout tiles of 32 and 64, masked), H not a multiple of 4, W of
# 64 or 8, x beginning before the slab, inside it, ending before the last
# output's planes, more output planes than a block's 4.
C1IN_FWD = [(1, 8, 5, 6, 70, -1, 7), (2, 40, 6, 5, 33, 2, 6), (1, 32, 9, 4, 64, 0, 9),
            (1, 64, 4, 9, 130, 1, 4)]


@pytest.mark.parametrize("act", [None, "gelu", "silu"])
@pytest.mark.parametrize("case", C1IN_FWD)
def test_fwd_c1in_emulated_matches_plain(act, case):
    """The replay (values and Σ/Σ²) against ``conv3d_k3_plain`` in fp32
    (1e-4: the same products, in another order)."""
    b, cout, nv, h, w_, qlo, d_out = case
    rng = np.random.default_rng(61)
    x = torch.from_numpy(rng.standard_normal((b, 1, nv, h, w_)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((cout, 1, 3, 3, 3)) / np.sqrt(27)).astype(np.float32))
    bias = torch.from_numpy(rng.standard_normal(cout).astype(np.float32))
    got = _fwd_c1in_emulated(x, w, bias, qlo, d_out, act)
    want = ck.conv3d_k3_plain(x, w, bias, 1, qlo, d_out, True, act)
    for g, r in zip(got, want):
        np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=1e-4, atol=1e-4)


def test_fwd_c1in_emulated_bf16_rounding():
    """In bf16 the replay rounds once, as the plain version does: within
    the card's bf16 TOL (2e-2, 2e-2) of ``conv3d_k3_plain``, and its Σ/Σ² are
    those of its own rounded output (fp32 sums in another order, 1e-5)."""
    rng = np.random.default_rng(62)
    x = torch.from_numpy(rng.standard_normal((1, 1, 6, 5, 70)).astype(np.float32)).to(BF16)
    w = torch.from_numpy((rng.standard_normal((40, 1, 3, 3, 3)) / np.sqrt(27))
                         .astype(np.float32)).to(BF16)
    bias = torch.from_numpy(rng.standard_normal(40).astype(np.float32))
    out, s1, s2 = _fwd_c1in_emulated(x, w, bias, 0, 5, "gelu")
    want = ck.conv3d_k3_plain(x, w, bias, 1, 0, 5, False, "gelu")
    assert out.dtype == BF16
    of, wf = out.float(), want.float()
    assert bool(((of - wf).abs() <= 2e-2 + 2e-2 * wf.abs()).all())
    for got, ref in ((s1, of.sum(dim=(2, 3, 4))), (s2, (of * of).sum(dim=(2, 3, 4)))):
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("cout,window,act", [(32, (2, 7), "gelu"), (64, (0, 6), "silu")])
def test_fwd_c1in_emulated_matches_jax(cout, window, act):
    """Against the JAX chain conv with one input channel (values and Σ/Σ²;
    ``_conv_kernel_smallcin`` in interpret mode, fp32) at the smallest width
    its shape gate takes, x windowed (qlo 2, then 0), with the gelu and silu
    prologues; the values at tests/test_pallas_conv.py's 1e-5 absolute,
    1e-4 relative."""
    B, H, W, dext = 1, 4, 128, 7
    vlo, vhi = window
    rng = np.random.default_rng(63)
    x = rng.standard_normal((B, 1, dext, H, W)).astype(np.float32)
    w = (rng.uniform(-1, 1, (cout, 1, 3, 3, 3)) / np.sqrt(27)).astype(np.float32)
    bias = rng.standard_normal(cout).astype(np.float32)
    out_j, s1_j, s2_j = jax_chain_s1((dext, H, W, True, act), jnp.asarray(x.reshape(B, 1, -1)),
                                     jnp.asarray([vlo, vhi], jnp.int32), jnp.asarray(w),
                                     jnp.asarray(bias))
    xt = torch.from_numpy(x).narrow(2, vlo, vhi - vlo)
    out, s1, s2 = _fwd_c1in_emulated(xt, torch.from_numpy(w), torch.from_numpy(bias), vlo,
                                     dext - 2, act)
    np.testing.assert_allclose(out.reshape(B, cout, -1).numpy(), np.asarray(out_j),
                               rtol=1e-4, atol=1e-5)
    for got, ref in ((s1, s1_j), (s2, s2_j)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-3)


# --------------------------------------------------- the weight gradient ---

def _wgrad_c1in_emulated(x, g, qlo, act, sms, flush=None):
    """dW (Cout, 1, 3, 3, 3) fp32 as ``wgrad_c1in_tc_kernel`` computes it: per
    Cout tile of 32 and split (the plan's), the tiles s, s + splits, …; per
    tile the copies and the g tile [co][voxel] (voxels plane, row, column),
    warp w adding g[:, 32w … 32w + 31] · B[those voxels, tap] into its own
    accumulators; every ``flush`` tiles (the kernel's kW1Flush) and after
    the last, the warps' accumulators added in warp order into the split's
    partial (stored first, added after); the partials summed as
    ``sum_split_partials_kernel`` does (warp y the splits y, y + 8, …, then
    the 8 warps in order)."""
    B, _, nv, H, W = x.shape
    cout, do = g.shape[1], g.shape[2]
    (td, th, tw), co_t, _, _ = ck.wgrad_blocking(ck.WGRAD_C1IN_TC, 1, 1)
    nw = _const(_src("conv3d_k3_bwd.cu"), "kW1Warps")
    flush = flush or 16384 // (td * th * tw // nw)
    _, splits, n_tiles = ck.wgrad_plan((B, 1, do, H, W), cout, 1, BF16, sms)
    xa = ck.act_plain(act, x).float()
    gf = g.float()
    tiles_w, tiles_h, tiles_d = -(-W // tw), -(-H // th), -(-do // td)
    partial = torch.zeros((splits, cout, 27))
    for co0, sp in itertools.product(range(0, cout, co_t), range(splits)):
        n_co = min(co_t, cout - co0)
        acc = torch.zeros((nw, co_t, 32))
        tiles = list(range(sp, n_tiles, splits))
        for done, tile in enumerate(tiles, 1):
            tx, rest = tile % tiles_w, tile // tiles_w
            ty, rest = rest % tiles_h, rest // tiles_h
            tz, b = rest % tiles_d, rest // tiles_d
            od0, oh0, ow0 = tz * td, ty * th, tx * tw
            copies = _copies(xa, b, od0 - qlo, oh0 - 1, ow0, td + 2, th + 2, tw, nv, H, W)
            gt = torch.zeros((co_t, td, th, tw))
            nz, ny, nx = min(td, do - od0), min(th, H - oh0), min(tw, W - ow0)
            gt[:n_co, :nz, :ny, :nx] = gf[b, co0:co0 + n_co, od0:od0 + nz, oh0:oh0 + ny,
                                          ow0:ow0 + nx]
            gt = gt.reshape(co_t, -1)
            for wi in range(nw):  # K steps 2w, 2w + 1: plane w / 4, row (w / 2) % 2
                vz, vy, c0 = wi >> 2, (wi >> 1) & 1, (wi & 1) * 32
                k0 = (vz * th + vy) * tw + c0
                acc[wi] += gt[:, k0:k0 + 32] @ _taps(copies, vz, vy, torch.arange(c0, c0 + 32)).T
            if done % flush == 0 or done == len(tiles):
                red = acc[0].clone()
                for wi in range(1, nw):
                    red += acc[wi]
                part = red[:n_co, :27]
                partial[sp, co0:co0 + n_co] = part if done <= flush else \
                    partial[sp, co0:co0 + n_co] + part
                acc.zero_()
    parts = torch.zeros((8, cout, 27))
    for y in range(8):
        for s in range(y, splits, 8):
            parts[y] += partial[s]
    dw = parts[0].clone()
    for y in range(1, 8):
        dw += parts[y]
    return dw.reshape(cout, 1, 3, 3, 3)


# (B, Cout, planes of x, H, W, slab plane of x's first plane, output planes,
# SMs): Cout 8 / 40 / 64 (masked Cout tiles), W not a multiple of 8 or 64,
# odd H, x before the slab and inside it, a split of several tiles (few SMs)
C1IN_WGRAD = [(1, 8, 5, 5, 70, -1, 7, 1), (2, 40, 6, 3, 33, 2, 6, 2), (1, 64, 9, 4, 64, 0, 8, 1),
              (1, 32, 4, 7, 130, 1, 4, 132)]


@pytest.mark.parametrize("act", [None, "gelu"])
@pytest.mark.parametrize("case", C1IN_WGRAD)
def test_wgrad_c1in_emulated_matches_plain(act, case):
    """The replay against ``conv3d_k3_wgrad_plain`` in fp32 (1e-4: the same
    products, in another order)."""
    b, cout, nv, h, w_, qlo, d_out, sms = case
    rng = np.random.default_rng(64)
    x = torch.from_numpy(rng.standard_normal((b, 1, nv, h, w_)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((b, cout, d_out, h, w_)).astype(np.float32))
    got = _wgrad_c1in_emulated(x, g, qlo, act, sms)
    want = ck.conv3d_k3_wgrad_plain(x, g, 1, qlo, act)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4, atol=1e-4)


def test_wgrad_c1in_flush_cadence():
    """Flushing the warps' accumulators every tile or every other tile of a
    split (the first flush storing, the later ones adding) gives the
    one-flush result within fp32 rounding."""
    rng = np.random.default_rng(65)
    x = torch.from_numpy(rng.standard_normal((1, 1, 7, 6, 70)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((1, 24, 6, 6, 70)).astype(np.float32))
    once = _wgrad_c1in_emulated(x, g, 0, "silu", 1)
    want = ck.conv3d_k3_wgrad_plain(x, g, 1, 0, "silu")
    for flush in (1, 2):
        got = _wgrad_c1in_emulated(x, g, 0, "silu", 1, flush=flush)
        np.testing.assert_allclose(got.numpy(), once.numpy(), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("cout,window,act", [(32, (2, 7), "gelu"), (64, (0, 6), "silu")])
def test_wgrad_c1in_emulated_matches_jax(cout, window, act):
    """Against dW of the JAX chain conv with one input channel
    (``conv3d_k3s1_chain`` VJP, its ``_wgrad`` in interpret mode, fp32) at the
    smallest width its shape gate takes, x windowed (qlo 2, then 0), with the
    gelu and silu prologues replayed; the conv VJP's tolerance
    (tests/test_pallas_conv.py: 1e-4 relative, 1e-3 absolute)."""
    B, H, W, dext = 1, 4, 128, 7
    vlo, vhi = window
    d_out = dext - 2
    rng = np.random.default_rng(66)
    x = rng.standard_normal((B, 1, dext, H, W)).astype(np.float32)
    w = (rng.uniform(-1, 1, (cout, 1, 3, 3, 3)) / np.sqrt(27)).astype(np.float32)
    bias = np.zeros(cout, np.float32)
    g = rng.standard_normal((B, cout, d_out * H * W)).astype(np.float32)
    _, vjp = jax.vjp(lambda wv: jax_chain_s1((dext, H, W, False, act),
                                             jnp.asarray(x.reshape(B, 1, -1)),
                                             jnp.asarray([vlo, vhi], jnp.int32), wv,
                                             jnp.asarray(bias)), jnp.asarray(w))
    want = np.asarray(vjp(jnp.asarray(g))[0])
    xt = torch.from_numpy(x).narrow(2, vlo, vhi - vlo)
    got = _wgrad_c1in_emulated(xt, torch.from_numpy(g).reshape(B, cout, d_out, H, W), vlo, act, 2)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-3)
