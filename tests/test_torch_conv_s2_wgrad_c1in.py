"""The stride-2 1→64 stem's weight gradient G at Cin = 1 on the tensor cores
(``csrc/conv3d_k3_bwd.cu``, ``wgrad_c1in_s2_tc_kernel``: instance 3 of
``wgrad_instance``, bf16 at stride 2 with one input channel), on the CPU: its
rule and tiling against the kernel source, the cover of its split grid, and a
torch replay of its arithmetic against the plain version and the JAX
package.

The replay: per Cout tile of 32 and split (the plan's: split s takes the
tiles s, s + splits, …), tiles of 2 output planes × 4 rows × 32 columns; per
tile the 5 × 9 staged input rows sorted by column parity into three copies
(copy 1 the even columns 2·(ow0 + c), copy 2 the odd ones 2·(ow0 + c) + 1,
copy 0 the odd ones shifted by one, 2·(ow0 + c) − 1; zero outside the view
and the image; the act prologue rounded to x's dtype), tap t = (dz, dy, dx) of
output voxel (pz, py, c) read as plane 2·pz + dz, row 2·py + dy, column c of
copy dx, taps 27-31 zero; warp w (plane w / 4, row w % 4) adds its 32
voxels' products into its own accumulators; every ``kW2Flush`` tiles and
after the last the 8 warps' accumulators go in warp order into the split's
partial (stored first, added after); the partials are summed in
``sum_split_partials_kernel``'s order. Held against
``conv3d_k3_wgrad_plain`` (fp32, 1e-4: the same products in another order;
bf16 at the card's gradient tolerance), dW of the JAX main path's stem
(``ConvNCDHW`` at stride 2, XLA's VJP) and dW of ``conv3d_k3s2_flat`` and
``conv3d_k3s2_chain`` (``_wgrad_s2`` in interpret mode, the chain with its
window and act prologue) at tests/test_pallas_conv_s2.py's VJP tolerance
(1e-4 relative, 1e-3 absolute).
"""

import itertools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from hybrid_vit_cascade_tpu.ops.conv3d import ConvNCDHW
from hybrid_vit_cascade_tpu.ops.pallas.conv3d_k3s2 import (
    conv3d_k3s2_chain,
    conv3d_k3s2_flat,
    supports_s2,
)
from hybrid_vit_cascade_tpu_torch.ops.cuda import _build
from hybrid_vit_cascade_tpu_torch.ops.cuda import conv3d_k3 as ck
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

BF16, F32 = torch.bfloat16, torch.float32
H100_SMS = 132
BWD = (_build.CSRC_DIR / "conv3d_k3_bwd.cu").read_text()


def _const(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", BWD).group(1))


TILE = tuple(int(v) for v in re.search(
    r"constexpr int kW2Td = (\d+), kW2Th = (\d+), kW2Tw = (\d+);", BWD).groups())
WARPS = _const("kW1Warps")


# ----------------------------------------------------------------- rules ---

@pytest.mark.parametrize("dtype,stride,cin,instance", [
    (BF16, 2, 1, ck.WGRAD_C1IN_S2_TC), (BF16, 1, 1, ck.WGRAD_C1IN_TC),
    (BF16, 2, 2, ck.WGRAD_CUDA_CORE), (BF16, 2, 7, ck.WGRAD_CUDA_CORE),
    (BF16, 2, 8, ck.WGRAD_TC), (BF16, 2, 32, ck.WGRAD_TC), (F32, 2, 1, ck.WGRAD_CUDA_CORE),
    (F32, 1, 1, ck.WGRAD_CUDA_CORE)])
def test_wgrad_c1in_s2_rule(dtype, stride, cin, instance):
    """bf16 at stride 2 with one input channel takes the stride-2
    one-input-channel instance; fp32 and Cin 2-7 stay on the CUDA cores."""
    assert ck.wgrad_instance(dtype, stride, cin) == instance
    assert ck.wgrad_plan((8, cin, 32, 64, 64), 64, stride, dtype, H100_SMS)[0] == instance


def test_wgrad_c1in_s2_rule_and_tiling_are_the_kernel():
    """The Python rule, tile and blocking state what the source does: the
    rule's instance 3, the 2 × 4 × 32 tile (one output row of 32 voxels a
    warp), Cout tiles of 32, two blocks an SM, a flush every 16,384 voxels a
    warp, and the dispatch and query entry points."""
    assert ("  if (cin >= 8) return 1;\n  if (cin != 1) return 0;\n"
            "  return stride == 1 ? 2 : 3;") in BWD
    assert TILE == (2, 4, 32) and TILE[0] * TILE[1] == WARPS == 8
    assert ck.wgrad_blocking(ck.WGRAD_C1IN_S2_TC, 2, 1) == ((2, 4, 32), 32, 1, 2)
    assert _const("kW1Co") == 32
    assert "__launch_bounds__(kW1Threads, 2)\nwgrad_c1in_s2_tc_kernel" in BWD
    assert "constexpr int kW2Flush = 16384 / (kW2Nv / kW1Warps);" in BWD
    assert ("  if (instance == 3)\n    return launch_wgrad_c1in_s2_tc(x, g, partial, out, batch, "
            "cout, nv, qlo, xb, act, H, W, Do,") in BWD
    assert 'extern "C" int hvc_conv3d_k3_wgrad_tc(int stride, int cin, int dtype)' in BWD
    # two blocks of the kernel's shared memory fit one SM (228 KB, 1 KB a block reserved)
    nv = TILE[0] * TILE[1] * TILE[2]
    assert "constexpr int kW2Nv = kW2Td * kW2Th * kW2Tw;" in BWD
    smem = ((_const("kW2Stages") * (_const("kW1Co") * (nv + 8)
                                    + (2 * TILE[0] + 1) * (2 * TILE[1] + 1) * (2 * TILE[2] // 8 + 1)
                                    * 8) + _const("kW2Zero") + _const("kW2ZeroLen")) * 2
            + _const("kW1Co") * 32 * 4)
    assert smem == 86000 and 2 * (smem + 1024) <= 233472


def test_wgrad_c1in_s2_pitches_spread_the_taps():
    """The copies start tap t = (dz, dy, dx) 16·(7t mod 8) bytes (mod 128)
    after tap 0, the zero rows of taps 27-31 continue the pattern from a
    128-byte boundary, every tap's read stays inside its copy, and the zero
    rows hold every offset a lane reads."""
    row, plane, copy = (_const("kW2" + n) for n in ("Row", "Plane", "Copy"))
    zero, zero_len = _const("kW2Zero"), _const("kW2ZeroLen")
    planes, rows = 2 * TILE[0] + 1, 2 * TILE[1] + 1
    assert row >= TILE[2] and plane >= rows * row and copy >= planes * plane
    assert zero >= 3 * copy and zero % 64 == 0
    lanes = [2 * (dx * copy + dz * plane + dy * row) % 128
             for dz, dy, dx in itertools.product(range(3), repeat=3)]
    lanes += [(2 * zero + 16 * (7 * t % 8)) % 128 for t in range(27, 32)]
    assert lanes == [16 * (7 * t % 8) for t in range(32)]
    for t0 in range(0, 32, 8):
        assert len(set(lanes[t0:t0 + 8])) == 8
    # a warp's taps: planes 2·pz + dz < 5, rows 2·py + dy < 9
    assert max(2 * (TILE[0] - 1) + 2, 2 * (TILE[1] - 1) + 2) < max(planes, rows) + 1
    # a zero row's element offset (< 64), the K step's 16 columns and the
    # column half's 8, and the 8 elements it reads
    assert 63 + 16 + 8 <= zero_len
    # the g tile's channel rows: an odd number of 16-byte units apart
    assert "constexpr int kW2Gld = kW2Nv + 8;" in BWD
    assert (2 * (TILE[0] * TILE[1] * TILE[2] + 8) // 16) % 2 == 1


# ---------------------------------------------------------------- splits ---

# (B, Cout, planes of x, H, W, slab plane of x's first plane, output planes):
# the stem's weight gradients in chip_smoke.py (dense: qlo 1), and ragged
# ones: odd D, H and W, W not a multiple of 16 or of the 64-column input
# span, batch 1, 2 and 8, x before and inside the slab, several plane, row
# and column tiles, Cout 8 / 24 / 40 / 64 (masked Cout tiles).
STEM_MAIN = sorted({(b, cout, d, h, w, 1, (d - 1) // 2 + 1) for b, cin, cout, (d, h, w) in
                    chip_smoke.TRAIN_KERNELS["conv3d_k3s2_c1in_wgrad"]["shapes"]
                    + chip_smoke.TRAIN_KERNELS["conv3d_k3s2_c1in_wgrad"]["ragged"]})
STEM_RAGGED = [(1, 64, 9, 7, 13, 1, 5), (8, 16, 6, 5, 10, 1, 3), (1, 40, 5, 9, 35, -1, 4),
               (2, 8, 17, 10, 70, 0, 9), (1, 64, 20, 9, 66, 2, 11), (1, 24, 3, 3, 3, 1, 2)]


def _n_tiles(b, do, h, w):
    ho, wo = (h - 1) // 2 + 1, (w - 1) // 2 + 1
    return b * -(-do // TILE[0]) * -(-ho // TILE[1]) * -(-wo // TILE[2])


@pytest.mark.parametrize("call", STEM_MAIN + STEM_RAGGED)
def test_wgrad_c1in_s2_splits_cover_every_tile(call):
    """The plan's splits give every 2 × 4 × 32 tile to one split, in the
    kernel's order (split s: tiles s, s + splits, …), none empty, two blocks
    an SM at most; the stem's 8 × 32³ output is 1,024 tiles in 128 splits."""
    b, cout, nv, h, w, qlo, do = call
    for sms in (H100_SMS, 5):
        inst, splits, n_tiles = ck.wgrad_plan((b, 1, do, h, w), cout, 2, BF16, sms)
        assert inst == ck.WGRAD_C1IN_S2_TC
        assert n_tiles == _n_tiles(b, do, h, w)
        parts = [list(range(s, n_tiles, splits)) for s in range(splits)]
        assert all(parts) and sorted(t for p in parts for t in p) == list(range(n_tiles))
        assert splits == 1 or splits * -(-cout // 32) <= 2 * sms
    if (b, cout, nv, h, w) == (8, 64, 64, 64, 64):
        assert ck.wgrad_plan((b, 1, do, h, w), cout, 2, BF16, H100_SMS) == \
            (ck.WGRAD_C1IN_S2_TC, 128, 1024)


def test_wgrad_c1in_s2_tiles_read_their_staged_patch():
    """Output voxel (pz, py, c) of a tile at (od0, oh0, ow0) reads input
    plane 2·(od0 + pz) + dz − qlo, row 2·(oh0 + py) + dy − 1 and column
    2·(ow0 + c) + dx − 1: staged plane 2·pz + dz < 5, row 2·py + dy < 9, and
    copy dx's column c, which the three raw vectors from 2·ow0 + 16·j − 8
    hold (j = c / 8)."""
    td, th, tw = TILE
    for pz, dz in itertools.product(range(td), range(3)):
        assert 2 * pz + dz < 2 * td + 1
    for py, dy in itertools.product(range(th), range(3)):
        assert 2 * py + dy < 2 * th + 1
    for c, dx in itertools.product(range(tw), range(3)):
        col, j = 2 * c + dx - 1, c // 8  # relative to 2·ow0
        assert 16 * j - 8 <= col < 16 * j + 16
    assert "constexpr int kW2Nvec = 2 * kW2Tw / 8 + 1;" in BWD  # vectors 0 … 2j + 2 ≤ 8


# ---------------------------------------------------------------- replay ---

def _copies(xa, b, p0, ih0, ow0, nv, H, W):
    """The kernel's three copies of a tile's patch: 5 planes × 9 rows of x's
    raw columns from 2·ow0 − 8 (zero outside the view and the image), copy
    dx column c = raw column 7 + 2·c + dx, i.e. input column 2·(ow0 + c) +
    dx − 1 (the byte-permute sort)."""
    td, th, tw = TILE
    planes, rows = 2 * td + 1, 2 * th + 1
    raw = torch.zeros((planes, rows, 2 * tw + 16))
    c0 = 2 * ow0 - 8
    for pd, ph in itertools.product(range(planes), range(rows)):
        p, ih = p0 + pd, ih0 + ph
        if 0 <= p < nv and 0 <= ih < H:
            lo, hi = max(c0, 0), min(c0 + 2 * tw + 16, W)
            if hi > lo:
                raw[pd, ph, lo - c0:hi - c0] = xa[b, 0, p, ih, lo:hi]
    cols = torch.arange(tw)
    return torch.stack([raw[:, :, 7 + 2 * cols + dx] for dx in range(3)])


def _taps(copies, pz, py):
    """B[tap, c] of warp (pz, py): 27 taps from the copies, 5 zero rows."""
    rows = [copies[t % 3, 2 * pz + t // 9, 2 * py + (t // 3) % 3] for t in range(27)]
    return torch.cat([torch.stack(rows), torch.zeros((5, TILE[2]))])


def _wgrad_c1in_s2_emulated(x, g, qlo, act, sms, flush=None):
    """dW (Cout, 1, 3, 3, 3) fp32 as ``wgrad_c1in_s2_tc_kernel`` computes it
    (module docstring), with the plan's splits for a card of ``sms`` SMs and
    a flush every ``flush`` tiles (the kernel's kW2Flush by default)."""
    B, _, nv, H, W = x.shape
    cout, do, ho, wo = g.shape[1:]
    td, th, tw = TILE
    co_t = ck.wgrad_blocking(ck.WGRAD_C1IN_S2_TC, 2, 1)[1]
    flush = flush or 16384 // (td * th * tw // WARPS)
    _, splits, n_tiles = ck.wgrad_plan((B, 1, do, H, W), cout, 2, BF16, sms)
    xa = ck.act_plain(act, x).float()
    gf = g.float()
    tiles_w, tiles_h, tiles_d = -(-wo // tw), -(-ho // th), -(-do // td)
    partial = torch.zeros((splits, cout, 27))
    for co0, sp in itertools.product(range(0, cout, co_t), range(splits)):
        n_co = min(co_t, cout - co0)
        acc = torch.zeros((WARPS, co_t, 32))
        tiles = list(range(sp, n_tiles, splits))
        for done, tile in enumerate(tiles, 1):
            tx, rest = tile % tiles_w, tile // tiles_w
            ty, rest = rest % tiles_h, rest // tiles_h
            tz, b = rest % tiles_d, rest // tiles_d
            od0, oh0, ow0 = tz * td, ty * th, tx * tw
            copies = _copies(xa, b, 2 * od0 - qlo, 2 * oh0 - 1, ow0, nv, H, W)
            gt = torch.zeros((co_t, td, th, tw))
            nz, ny, nx = min(td, do - od0), min(th, ho - oh0), min(tw, wo - ow0)
            gt[:n_co, :nz, :ny, :nx] = gf[b, co0:co0 + n_co, od0:od0 + nz, oh0:oh0 + ny,
                                          ow0:ow0 + nx]
            gt = gt.reshape(co_t, -1)
            for wi in range(WARPS):  # output plane w / 4, row w % 4: K steps 2w, 2w + 1
                pz, py = wi // th, wi % th
                acc[wi] += gt[:, wi * tw:(wi + 1) * tw] @ _taps(copies, pz, py).T
            if done % flush == 0 or done == len(tiles):
                red = acc[0].clone()
                for wi in range(1, WARPS):
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


def _case(call, seed, dtype=F32):
    b, cout, nv, h, w, qlo, do = call
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((b, 1, nv, h, w)).astype(np.float32)).to(dtype)
    g = torch.from_numpy(rng.standard_normal((b, cout, do, (h - 1) // 2 + 1, (w - 1) // 2 + 1))
                         .astype(np.float32)).to(dtype)
    return x, g


@pytest.mark.parametrize("act", [None, "gelu"])
@pytest.mark.parametrize("call,sms", [(c, s) for c, s in zip(STEM_RAGGED, (1, 2, 132, 1, 3, 132))])
def test_wgrad_c1in_s2_emulated_matches_plain(act, call, sms):
    """The replay against ``conv3d_k3_wgrad_plain`` in fp32 (1e-4: the same
    products, in another order) on ragged shapes and views, with splits of
    one tile and of several."""
    x, g = _case(call, 81)
    got = _wgrad_c1in_s2_emulated(x, g, call[5], act, sms)
    want = ck.conv3d_k3_wgrad_plain(x, g, 2, call[5], act)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4, atol=1e-4)


def test_wgrad_c1in_s2_flush_cadence():
    """Flushing the warps' accumulators every tile or every other tile of a
    split (the first flush storing, the later ones adding) gives the
    one-flush result within fp32 rounding."""
    call = (2, 24, 9, 10, 70, 0, 5)
    x, g = _case(call, 82)
    once = _wgrad_c1in_s2_emulated(x, g, 0, "silu", 1)
    want = ck.conv3d_k3_wgrad_plain(x, g, 2, 0, "silu")
    for flush in (1, 2):
        got = _wgrad_c1in_s2_emulated(x, g, 0, "silu", 1, flush=flush)
        np.testing.assert_allclose(got.numpy(), once.numpy(), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("act", [None, "gelu"])
def test_wgrad_c1in_s2_emulated_bf16(act):
    """In bf16 (x and g rounded, the prologue rounded to bf16) the replay is
    within chip_smoke.py's gradient tolerance (2e-2 relative, 2e-2 ·
    max(1, max|want|) absolute) of the plain weight gradient."""
    call = (2, 64, 9, 7, 13, 1, 5)
    x, g = _case(call, 83, BF16)
    got = _wgrad_c1in_s2_emulated(x, g, 1, act, 2)
    want = ck.conv3d_k3_wgrad_plain(x, g, 2, 1, act)
    scale = max(1.0, float(want.abs().max()))
    assert bool(((got - want).abs() <= 2e-2 * scale + 2e-2 * want.abs()).all())


def test_wgrad_c1in_s2_emulated_matches_jax_stem():
    """Against dW of the JAX main path's stem, ``ConvNCDHW`` at stride 2 with
    one input channel (XLA's VJP), 1→64 on an odd 9 × 7 × 13 volume, batch
    2: the dense call (qlo 1, ⌈D/2⌉ planes)."""
    B, cout, D, H, W = 2, 64, 9, 7, 13
    rng = np.random.default_rng(84)
    x = rng.standard_normal((B, 1, D, H, W)).astype(np.float32)
    w = (rng.uniform(-1, 1, (cout, 1, 3, 3, 3)) / np.sqrt(27)).astype(np.float32)
    bias = rng.standard_normal(cout).astype(np.float32)
    conv = ConvNCDHW(cout, 3, stride=2, padding=1)
    out, vjp = jax.vjp(lambda wv: conv.apply({"params": {"kernel": wv, "bias": jnp.asarray(bias)}},
                                             jnp.asarray(x)), jnp.asarray(w))
    ct = rng.standard_normal(out.shape).astype(np.float32)
    want = np.asarray(vjp(jnp.asarray(ct))[0])
    got = _wgrad_c1in_s2_emulated(torch.from_numpy(x), torch.from_numpy(ct), 1, None, 2)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-3)


def test_wgrad_c1in_s2_emulated_matches_jax_pallas():
    """Against dW of ``conv3d_k3s2_flat``'s VJP (``_wgrad_s2`` in interpret
    mode) at one input channel and the smallest width ``supports_s2`` takes
    (W = 256): its VALID-in-D contract is the chain call with qlo 0 over
    2·D' + 1 planes."""
    B, cout, dp, H, W = 1, 64, 2, 4, 256
    assert supports_s2(1, 3, 2, H, W)
    dext = 2 * dp + 1
    rng = np.random.default_rng(85)
    x = rng.standard_normal((B, 1, dext, H, W)).astype(np.float32)
    w = (rng.uniform(-1, 1, (cout, 1, 3, 3, 3)) / np.sqrt(27)).astype(np.float32)
    bias = np.zeros(cout, np.float32)
    ct = rng.standard_normal((B, cout, dp * (H // 2) * (W // 2))).astype(np.float32)
    _, vjp = jax.vjp(lambda wv: conv3d_k3s2_flat((dext, H, W), jnp.asarray(x.reshape(B, 1, -1)),
                                                 wv, jnp.asarray(bias)), jnp.asarray(w))
    want = np.asarray(vjp(jnp.asarray(ct))[0])
    got = _wgrad_c1in_s2_emulated(torch.from_numpy(x),
                                  torch.from_numpy(ct).reshape(B, cout, dp, H // 2, W // 2),
                                  0, None, 2)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-3)


def test_wgrad_c1in_s2_emulated_matches_jax_chain():
    """Against dW of ``conv3d_k3s2_chain``'s VJP (``_wgrad_s2`` in interpret
    mode with its plane window and the gelu prologue replayed) at one input
    channel, W = 256: x is the window's view, qlo its first plane."""
    B, cout, dp, H, W = 1, 32, 2, 4, 256
    dext, (vlo, vhi) = 2 * dp + 1, (1, 4)
    rng = np.random.default_rng(86)
    x = rng.standard_normal((B, 1, dext, H, W)).astype(np.float32)
    w = (rng.uniform(-1, 1, (cout, 1, 3, 3, 3)) / np.sqrt(27)).astype(np.float32)
    bias = np.zeros(cout, np.float32)
    ct = rng.standard_normal((B, cout, dp * (H // 2) * (W // 2))).astype(np.float32)
    _, vjp = jax.vjp(lambda wv: conv3d_k3s2_chain((dext, H, W, False, "gelu"),
                                                  jnp.asarray(x.reshape(B, 1, -1)),
                                                  jnp.asarray([vlo, vhi], jnp.int32), wv,
                                                  jnp.asarray(bias)), jnp.asarray(w))
    want = np.asarray(vjp(jnp.asarray(ct))[0])
    xt = torch.from_numpy(x).narrow(2, vlo, vhi - vlo)
    got = _wgrad_c1in_s2_emulated(xt, torch.from_numpy(ct).reshape(B, cout, dp, H // 2, W // 2),
                                  vlo, "gelu", 2)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-3)
