"""The stride-2 1→64 stem of stage 1 on the tensor cores, on the CPU: the
dispatch rules of its forward and data gradient against the kernel sources,
the cover of every grid and the halo each block stages, and torch replays of
each kernel's arithmetic against the plain versions and the JAX package.

- The data gradient (``csrc/conv3d_k3_bwd.cu``, ``dgrad_s2_c1_tc_kernel``):
  bf16 with one dx channel, 8 ≤ Cout ≤ 64 and no act′ (instance 2 of
  ``dgrad_s2_instance``). Per block of 4 × 32 g positions (8 × 64 dx voxels a
  plane) and 8 g planes (16 dx planes, from the even padding-1 index at or
  before the view's first plane), each g plane's 5 × 40 staged positions (the
  halo row and column the odd dx rows and columns read, zero outside g),
  P[tap, position] = Σ_co w[co, tap] · g[co, position] (taps as M), then
  every dx voxel gathers its 1, 2, 4 or 8 taps by parity in a fixed order:
  even index 2u takes d = 1 from u, odd 2u + 1 takes d = 0 from u + 1, then
  d = 2 from u; dx plane 2·oz − 1 adds plane oz's dz = 0 part to the dz = 2
  part plane oz − 1 left. One rounding. Against ``conv3d_k3_dgrad_plain``
  (fp32, 1e-4; bf16 at the card's gradient tolerance), the JAX main path's
  ``ConvNCDHW`` VJP (XLA) and the VJP of ``conv3d_k3s2_flat`` (``_dgrad_s2`` in
  interpret mode) at the VJP tolerance of tests/test_pallas_conv_s2.py
  (1e-4 relative, 1e-3 absolute).
- Its fp32 form (``dgrad_s2_c1_f32_kernel``, instance 3 of
  ``dgrad_s2_instance``: fp32 with one dx channel, 8 ≤ Cout ≤ 64, no act′):
  the same blocks, walk, gather and store, 5 × 36 staged g positions a plane
  and P in fp32 FMAs on the CUDA cores (warp w: taps 7·(w % 4) …, positions
  96·(w / 4) + lane + {0, 32, 64}). The replay tests run over both kernels'
  staged windows.
- The forward (``csrc/conv3d_k3.cu``, ``conv_c1in_s2_tc_kernel``): bf16 with
  one input channel, Cout ≥ 8 and no act′ (``fwd_c1in_uses_tensor_cores`` at
  stride 2). Per block of 4 × 4 × 32 output voxels and Cout tile of 32 (Cout
  ≤ 32) or 64, the 9 × 9 staged input rows de-interleaved by column parity
  into three copies (even columns for dx = 1, odd for dx = 2, odd shifted by
  one for dx = 0; zero outside the view and the image, the act prologue
  rounded to x's dtype), tap t = (dz, dy, dx) read as plane 2·vz + dz, row
  2·vy + dy of copy dx, taps 27-31 zero; the accumulators start at the bias,
  one rounding, Σ/Σ² of the rounded values one partial per block. Against
  ``conv3d_k3_plain`` (fp32, 1e-4; bf16 at the card's TOL), the JAX
  ``ConvNCDHW`` (XLA) and ``conv3d_k3s2_flat`` (``_conv_fwd_s2`` in interpret
  mode) at tests/test_pallas_conv_s2.py's forward tolerance (1e-5 relative,
  1e-4 absolute).
"""

import functools
import itertools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from hybrid_vit_cascade_tpu.ops.conv3d import ConvNCDHW
from hybrid_vit_cascade_tpu.ops.pallas.conv3d_k3s2 import conv3d_k3s2_flat, supports_s2
from hybrid_vit_cascade_tpu_torch.ops.cuda import _build
from hybrid_vit_cascade_tpu_torch.ops.cuda import conv3d_k3 as ck
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

BF16, F32 = torch.bfloat16, torch.float32
CC, TC, C1, C1F = ck.DGRAD_S2_CUDA_CORE, ck.DGRAD_S2_TC, ck.DGRAD_S2_C1_TC, ck.DGRAD_S2_C1_FP32


def _src(name):
    return (_build.CSRC_DIR / name).read_text()


def _const(src, name):
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


def _pair(src, a, b):
    m = re.search(rf"constexpr int {a} = (\d+), {b} = (\d+);", src)
    return int(m.group(1)), int(m.group(2))


BWD, FWD = _src("conv3d_k3_bwd.cu"), _src("conv3d_k3.cu")
F1_TY, F1_TX = _pair(BWD, "kF1Ty", "kF1Tx")  # g rows × columns a block
F1_NP = _const(BWD, "kF1Np")  # g planes a block walks
F1_COLS = F1_TX + 8  # staged g columns: the tile's and a vector with the halo column
F1F_COLS = _const(BWD, "kF1fCols")  # the fp32 form's: the tile's and the halo, in 4-float vectors
F1F_TAPS, F1F_POS = _const(BWD, "kF1fTaps"), _const(BWD, "kF1fPos")  # a warp's taps, a lane's positions
# staged g columns of each one-dx-channel kernel, which the replays take
C1_COLS = {"tc": F1_COLS, "f32": F1F_COLS}


# ----------------------------------------------------------------- rules ---

@pytest.mark.parametrize("dtype,cin,cout,dact,instance", [
    (BF16, 1, 64, False, C1), (BF16, 1, 8, False, C1), (BF16, 1, 40, False, C1),
    (BF16, 1, 17, False, C1), (BF16, 1, 7, False, CC), (BF16, 1, 65, False, CC),
    (BF16, 1, 128, False, CC), (BF16, 1, 64, True, CC), (BF16, 2, 64, False, CC),
    (BF16, 7, 64, False, CC), (BF16, 8, 64, False, TC), (BF16, 32, 64, True, TC),
    (F32, 1, 64, False, C1F), (F32, 32, 64, False, CC), (F32, 1, 8, False, C1F),
    (F32, 1, 40, False, C1F), (F32, 1, 65, False, CC), (F32, 1, 7, False, CC),
    (F32, 1, 64, True, CC), (F32, 8, 64, False, CC)])
def test_dgrad_s2_instance_rule(dtype, cin, cout, dact, instance):
    """bf16 with one dx channel, 8 ≤ Cout ≤ 64 and no act′ takes the
    one-dx-channel tensor cores, the same call in fp32 their CUDA-core form;
    bf16 with Cin, Cout ≥ 8 the tensor-core F/J; the rest of fp32 and bf16
    the CUDA cores."""
    assert ck.dgrad_s2_instance(dtype, cin, cout, dact) == instance


@pytest.mark.parametrize("dtype,cin,cout,dact,c1in", [
    (BF16, 1, 64, False, True), (BF16, 1, 8, False, True), (BF16, 1, 40, False, True),
    (BF16, 1, 96, False, True), (BF16, 1, 7, False, False), (BF16, 1, 64, True, False),
    (BF16, 2, 64, False, False), (F32, 1, 64, False, False)])
def test_fwd_c1in_s2_rule(dtype, cin, cout, dact, c1in):
    """The stride-2 conv with one input channel, Cout ≥ 8 and no act′ takes
    the one-input-channel tensor cores (tiles of 4 × 4 × 32 output voxels in
    its Σ/Σ² plan); no other instance's rule takes those calls."""
    assert ck.fwd_c1in_uses_tensor_cores(dtype, 2, cin, cout, dact) is c1in
    assert not (c1in and ck.fwd_uses_tensor_cores(dtype, 2, cin, cout))
    inst, tile, _ = ck.fwd_plan((1, cin, 8, 16, 16), cout, 2, dtype)
    if not dact:
        assert (inst == ck.FWD_C1IN_TC) is c1in
        assert not c1in or tile == (4, 4, 32)


def test_s2_stem_rules_and_tilings_are_the_kernels():
    """The Python rules and tiles state what the sources do, and the
    wrapper's entry points exist."""
    assert ("return (stride == 1 || stride == 2) && bf16 && cin == 1 && cout >= 8 && dact == 0;"
            in FWD)
    assert "constexpr int kC2Td = 4, kC2Th = 4, kC2Tw = 32;" in FWD
    assert ck._FWD_TILE_C1IN[2] == (4, 4, 32)
    assert 'extern "C" int hvc_conv3d_k3s2_c1in_tc(int cin, int cout, int dact, int dtype)' in FWD
    assert ("  if (!bf16) return cin == 1 && cout >= 8 && cout <= kF1Co && dact == 0 ? 3 : 0;\n"
            "  if (cin >= 8 && cout >= 8) return 1;\n"
            "  return cin == 1 && cout >= 8 && cout <= kF1Co && dact == 0 ? 2 : 0;") in BWD
    assert ("  if (instance == 3) return launch_dgrad_s2_c1_f32(g, w, dx, batch, cout, nv, qlo, H, "
            "W, Do, s);") in BWD
    assert _const(BWD, "kF1Co") == ck.DGRAD_C1_CO_MAX == 64
    assert (F1_TY, F1_TX, F1_NP) == (4, 32, 8)
    assert "static_assert(2 * kF1Ty == kF1Warps" in BWD
    # the plane ranges of _dgrad_blocks: 8 g planes a block from the even
    # padding-1 index at or before the view's first plane
    assert all(line in BWD for line in (
        "const int ozs = (((qlo - 1) & ~1) >> 1) + tile / (n_tx * n_ty) * kF1Np;",
        "const int iz_lo = (qlo - 1) & ~1, iz_hi = qlo - 1 + nv;",
        "const int n_tz = (iz_hi - iz_lo + 2 * kF1Np - 1) / (2 * kF1Np);"))
    assert "int hvc_conv3d_k3s2_dgrad_tc(int cin, int cout, int dact, int dtype)" in BWD


def test_s2_stem_pitches_spread_the_taps():
    """The forward's copies start tap t = (dz, dy, dx) 16·(7t mod 8) bytes
    (mod 128) after tap 0, the zero rows of taps 27-31 continue the pattern
    from a 128-byte boundary, and every read stays inside its region; the
    data gradient's staged channel rows are an odd number of 16-byte units
    (its ldmatrix.trans rows hit 8 bank groups) and its P rows ≡ 8 or 24
    floats mod 32 (a half-warp's float2 stores of 4 taps hit 32 banks)."""
    row, plane, copy = (_const(FWD, "kC2" + n) for n in ("Row", "Plane", "Copy"))
    zero, zero_len = _const(FWD, "kC2Zero"), _const(FWD, "kC2ZeroLen")
    assert row >= 32 and plane >= 9 * row and copy >= 9 * plane and zero >= 3 * copy
    offs = [2 * (dx * copy + dz * plane + dy * row)
            for dz, dy, dx in itertools.product(range(3), repeat=3)]
    lanes = [o % 128 for o in offs] + [(2 * zero + 16 * (7 * t % 8)) % 128 for t in range(27, 32)]
    assert lanes == [16 * (7 * t % 8) for t in range(32)]
    for t0 in range(0, 32, 8):
        assert len(set(lanes[t0:t0 + 8])) == 8
    # a zero row's element offset (< 64) plus the step's row and columns
    assert 63 + 2 * row + 24 + 8 <= zero_len
    assert all(line in BWD for line in ("constexpr int kF1Rows = kF1Ty + 1;",
                                        "constexpr int kF1Cols = kF1Tx + 8;",
                                        "constexpr int kF1Ld = kF1Rows * kF1Cols;"))
    ld, pt = (F1_TY + 1) * F1_COLS, _const(BWD, "kF1Pt")
    assert (2 * ld // 16) % 2 == 1 and 2 * ld % 16 == 0
    assert pt % 32 in (8, 24) and pt >= 16 * -(-ld // 16)


def test_dgrad_s2_c1_f32_tiling_is_the_kernel():
    """The fp32 form's staging and products as the source states them: 36
    staged columns (9 four-float vectors, the tile's 32 and the halo column;
    720-byte channel rows, 144-byte rows: every cp.async destination
    16-byte aligned), and its eight warps' (tap group, position half) with
    three positions a lane cover taps 0-26 × the 180 staged positions, every
    one once, besides tap 27 and positions 180-191, which the gather never
    reads (its largest position is row 4, column 32); the weights' 8-float
    rows of each group are two float4 broadcasts."""
    assert (F1F_COLS, F1F_TAPS, F1F_POS) == (36, 7, 3)
    ld, pt = (F1_TY + 1) * F1F_COLS, 2 * 32 * F1F_POS  # kF1fLd, kF1fPt
    assert F1F_COLS % 4 == 0 and F1F_COLS > F1_TX and 4 * ld % 16 == 0 and 4 * F1F_COLS % 16 == 0
    assert all(line in BWD for line in (
        "constexpr int kF1fLd = kF1Rows * kF1fCols;",
        "constexpr int kF1fHalf = 32 * kF1fPos;",
        "constexpr int kF1fPt = 2 * kF1fHalf;",
        "  const int grp = warp % 4, half = warp / 4;",
        "    const float* gp = src + half * kF1fHalf + lane;",
        "      for (int k = 0; k < kF1fPos; ++k) gv[k] = gp[co * kF1fLd + 32 * k];",
        "          ps[tap * kF1fPt + half * kF1fHalf + lane + 32 * k] = acc[j][k];",
        "    const float* src = gbuf + buf * kF1fBuf;",
        "  c1_walk<kF1fPt, kF1fCols>(ozs, Do, ps, ry, u, stage, products, store);",
        "  c1_walk<kF1Pt, kF1Cols>(ozs, Do, ps, ry, u, stage, products, store);"))
    cover = [(F1F_TAPS * (w % 4) + j, 32 * F1F_POS * (w // 4) + lane + 32 * k)
             for w in range(8) for lane in range(32) for j in range(F1F_TAPS)
             for k in range(F1F_POS)]
    assert len(set(cover)) == len(cover)
    assert {c for c in cover if c[0] < 27 and c[1] < ld} == \
        set(itertools.product(range(27), range(ld)))
    reads = {r * F1F_COLS + u + e for r in range(F1_TY + 1) for u in range(F1_TX) for e in (0, 1)}
    assert max(reads) == F1_TY * F1F_COLS + F1_TX < ld <= pt
    smem = 4 * (2 * (64 * ld + pt - ld) + 27 * pt + 64 * 32)
    assert smem == 121184 and "// 121,184 bytes:" in BWD


# ---------------------------------------------------- grids and halos ---

# (B, Cout, planes of x, H, W, slab plane of x's first plane, output planes):
# the stem's calls in chip_smoke.py (dense: qlo 1), and ragged ones: odd D, H
# and W, W not a multiple of 8 or 16, batch 1, 2 and 8, x before and inside
# the slab, several plane, row and column tiles, Cout 8 / 16 / 24 / 40 / 64.
STEM_MAIN = sorted({(b, cout, d, h, w, 1, (d - 1) // 2 + 1) for name, kind in
                    (("conv3d_k3s2_c1in", chip_smoke.KERNELS),
                     ("conv3d_k3s2_c1in_dgrad", chip_smoke.TRAIN_KERNELS))
                    for b, cin, cout, (d, h, w) in kind[name]["shapes"]})
STEM_RAGGED = [(1, 64, 9, 7, 13, 1, 5), (8, 16, 6, 5, 10, 1, 3), (1, 40, 5, 9, 35, -1, 4),
               (2, 8, 17, 10, 70, 0, 9), (1, 64, 20, 9, 66, 2, 11), (1, 24, 3, 3, 3, 1, 2)]


def _stem_calls():
    return STEM_MAIN + STEM_RAGGED


def _dgrad_blocks(nv, H, W, qlo):
    """The data gradient's grid as launch_dgrad_s2_c1_tc sizes it: (first g
    plane, g row, g column) of each block."""
    Ho, Wo = (H - 1) // 2 + 1, (W - 1) // 2 + 1
    iz_first, iz_end = (qlo - 1) & ~1, qlo - 1 + nv
    n_tz = -(-(iz_end - iz_first) // (2 * F1_NP))
    return [((iz_first >> 1) + tz * F1_NP, ty * F1_TY, tx * F1_TX)
            for tz, ty, tx in itertools.product(range(n_tz), range(-(-Ho // F1_TY)),
                                                range(-(-Wo // F1_TX)))]


def _parity_reads(i):
    """The g indices dx index i reads along one dimension: d = 1 from i / 2
    (even), d = 0 from (i + 1) / 2 and d = 2 from (i − 1) / 2 (odd)."""
    return [i // 2] if i % 2 == 0 else [(i + 1) // 2, (i - 1) // 2]


@pytest.mark.parametrize("kernel", sorted(C1_COLS))
@pytest.mark.parametrize("call", _stem_calls())
def test_dgrad_s2_c1_grid_covers_dx_once(call, kernel):
    """Per dimension, the blocks' dx ranges cover the view's planes, rows and
    columns exactly once, and every g index a dx voxel reads lies in its
    block's staged window: g planes ozs … ozs + 8, rows oy0 … oy0 + 4,
    columns ox0 … ox0 + 32 < ox0 + 40 (the fp32 form: + 36)."""
    b, cout, nv, H, W, qlo, d_out = call
    blocks = _dgrad_blocks(nv, H, W, qlo)
    for axis, (n, lo) in enumerate(((nv, qlo - 1), (H, 0), (W, 0))):
        starts = sorted({blk[axis] for blk in blocks})
        span = (2 * F1_NP, 2 * F1_TY, 2 * F1_TX)[axis]
        staged = (F1_NP + 1, F1_TY + 1, C1_COLS[kernel])[axis]
        seen = []
        for s in starts:
            for i in range(2 * s, 2 * s + span):
                if lo <= i < lo + n:
                    seen.append(i)
                    assert all(s <= o < s + staged for o in _parity_reads(i))
                    assert all(o <= s + span // 2 for o in _parity_reads(i))
        assert sorted(seen) == list(range(lo, lo + n))


def _fwd_tiles(d_out, H, W):
    Ho, Wo = (H - 1) // 2 + 1, (W - 1) // 2 + 1
    td, th, tw = ck._FWD_TILE_C1IN[2]
    return [(tz * td, ty * th, tx * tw)
            for tz, ty, tx in itertools.product(range(-(-d_out // td)), range(-(-Ho // th)),
                                                range(-(-Wo // tw)))]


@pytest.mark.parametrize("call", _stem_calls())
def test_fwd_c1in_s2_grid_covers_out_once(call):
    """Per dimension the tiles cover the output once, each output voxel's
    taps read staged planes 2·vz + dz < 9 and rows 2·vy + dy < 9 of the
    block's patch, and copy dx's column c is input column 2·(ow0 + c) + dx −
    1, which the three raw vectors from 2·ow0 + 16·j − 8 hold."""
    b, cout, nv, H, W, qlo, d_out = call
    tiles = _fwd_tiles(d_out, H, W)
    Ho, Wo = (H - 1) // 2 + 1, (W - 1) // 2 + 1
    for axis, n in enumerate((d_out, Ho, Wo)):
        span = ck._FWD_TILE_C1IN[2][axis]
        seen = [o for s in sorted({t[axis] for t in tiles}) for o in range(s, s + span) if o < n]
        assert sorted(seen) == list(range(n))
    td, th, tw = ck._FWD_TILE_C1IN[2]
    assert "constexpr int kC2Pd = 2 * kC2Td + 1, kC2Ph = 2 * kC2Th + 1;" in FWD
    assert max(2 * v + d for v in range(td) for d in range(3)) < 2 * td + 1
    assert max(2 * v + d for v in range(th) for d in range(3)) < 2 * th + 1
    for j, e, dx in itertools.product(range(tw // 8), range(8), range(3)):
        col = 2 * (8 * j + e) + dx - 1  # relative to 2·ow0
        assert 16 * j - 8 <= col < 16 * j + 16


# --------------------------------------------------- the data gradient ---

def _dgrad_s2_c1_emulated(g, w, x_shape, qlo, cols=F1_COLS):
    """dx (x_shape, g's dtype) as ``dgrad_s2_c1_tc_kernel`` computes it (and,
    in fp32 with ``cols`` F1F_COLS, ``dgrad_s2_c1_f32_kernel``): per block and
    g plane the staged window of ``cols`` columns (zero outside g and past
    Cout), P = W[tap, co] · G[co, position] in fp32 products of the operands
    in g's dtype, the parity gather of each dx row and column pair in the
    kernel's order, the dz = 2 part carried to the next g plane, one
    rounding."""
    B, cout, Do, Ho, Wo = g.shape
    _, _, nv, H, W = x_shape
    kp = 16 * -(-cout // 16)
    wt = torch.zeros((32, kp))
    wt[:27, :cout] = w.float().reshape(cout, 27).T
    gf = g.float()
    dx = torch.zeros((B, 1, nv, H, W))
    rows = F1_TY + 1
    ry = torch.arange(2 * F1_TY)
    u = torch.arange(F1_TX)

    def part(P, dz):
        """(even, odd) dx columns of each dx row: dy = 1 from row ry / 2 for
        even ry; dy = 0 from row (ry + 1) / 2, then dy = 2 from (ry − 1) / 2."""
        e, o = torch.zeros((2 * F1_TY, F1_TX)), torch.zeros((2 * F1_TY, F1_TX))
        for r in range(2 * F1_TY):
            terms = [(1, r // 2)] if r % 2 == 0 else [(0, (r + 1) // 2), (2, (r - 1) // 2)]
            for dy, gr in terms:
                t = dz * 9 + dy * 3
                e[r] = e[r] + P[t + 1, gr, u]
                o[r] = o[r] + (P[t, gr, u + 1] + P[t + 2, gr, u])
        return e, o

    def store(b, iz, oy0, ox0, e, o):
        pv = iz - (qlo - 1)
        if not 0 <= pv < nv:
            return
        for r in range(2 * F1_TY):
            iy = 2 * oy0 + r
            if iy >= H:
                continue
            for par, val in ((0, e[r]), (1, o[r])):
                ix = 2 * (ox0 + u) + par
                keep = ix < W
                dx[b, 0, pv, iy, ix[keep]] = val[keep].to(g.dtype).float()

    for b, (ozs, oy0, ox0) in itertools.product(range(B), _dgrad_blocks(nv, H, W, qlo)):
        pend = (torch.zeros((2 * F1_TY, F1_TX)), torch.zeros((2 * F1_TY, F1_TX)))
        for i in range(F1_NP + 1):
            oz = ozs + i
            parts = [(torch.zeros((2 * F1_TY, F1_TX)),) * 2] * 3
            if 0 <= oz < Do:
                win = torch.zeros((kp, rows, cols))
                nr, nc = max(0, min(rows, Ho - oy0)), max(0, min(cols, Wo - ox0))
                win[:cout, :nr, :nc] = gf[b, :, oz, oy0:oy0 + nr, ox0:ox0 + nc]
                P = (wt @ win.reshape(kp, -1))[:27].reshape(27, rows, cols)
                parts = [part(P, dz) for dz in range(3)]
            if i > 0:
                store(b, 2 * oz - 1, oy0, ox0, pend[0] + parts[0][0], pend[1] + parts[0][1])
            if i < F1_NP:
                store(b, 2 * oz, oy0, ox0, *parts[1])
            pend = parts[2]
    return dx.to(g.dtype)


def _grad_case(call, seed, dtype=F32):
    b, cout, nv, H, W, qlo, d_out = call
    rng = np.random.default_rng(seed)
    g = torch.from_numpy(rng.standard_normal((b, cout, d_out, (H - 1) // 2 + 1,
                                              (W - 1) // 2 + 1)).astype(np.float32)).to(dtype)
    w = torch.from_numpy((rng.standard_normal((cout, 1, 3, 3, 3)) / np.sqrt(27))
                         .astype(np.float32)).to(dtype)
    return g, w, torch.zeros((b, 1, nv, H, W), dtype=dtype)


@pytest.mark.parametrize("kernel", sorted(C1_COLS))
@pytest.mark.parametrize("call", STEM_RAGGED)
def test_dgrad_s2_c1_emulated_matches_plain(call, kernel):
    """The replay of either kernel against ``conv3d_k3_dgrad_plain`` in
    fp32 (1e-4: the same products, in another order) on ragged shapes, batch
    1, 2 and 8."""
    g, w, x = _grad_case(call, 71)
    got = _dgrad_s2_c1_emulated(g, w, x.shape, call[5], C1_COLS[kernel])
    want = ck.conv3d_k3_dgrad_plain(g, w, x, 2, call[5])
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4, atol=1e-4)


def test_dgrad_s2_c1_emulated_bf16_rounding():
    """In bf16 the replay rounds once: within chip_smoke.py's gradient
    tolerance (2e-2 relative, 2e-2 · max(1, max|want|) absolute) of the plain
    data gradient."""
    call = (2, 64, 9, 7, 13, 1, 5)
    g, w, x = _grad_case(call, 72, BF16)
    got = _dgrad_s2_c1_emulated(g, w, x.shape, 1)
    want = ck.conv3d_k3_dgrad_plain(g, w, x, 2, 1)
    assert got.dtype == BF16
    gf, wf = got.float(), want.float()
    scale = max(1.0, float(wf.abs().max()))
    assert bool(((gf - wf).abs() <= 2e-2 * scale + 2e-2 * wf.abs()).all())


@functools.cache
def _jax_stem_dgrad():
    """(ct, w, x shape, dx) of the VJP (dx) of the JAX main path's stem,
    ``ConvNCDHW`` at stride 2 with one input channel (XLA), at 1→64 on an
    odd 9 × 7 × 13 volume, batch 2."""
    B, cout, D, H, W = 2, 64, 9, 7, 13
    rng = np.random.default_rng(73)
    x = rng.standard_normal((B, 1, D, H, W)).astype(np.float32)
    w = (rng.uniform(-1, 1, (cout, 1, 3, 3, 3)) / np.sqrt(27)).astype(np.float32)
    bias = rng.standard_normal(cout).astype(np.float32)
    conv = ConvNCDHW(cout, 3, stride=2, padding=1)
    params = {"params": {"kernel": jnp.asarray(w), "bias": jnp.asarray(bias)}}
    out, vjp = jax.vjp(lambda xv: conv.apply(params, xv), jnp.asarray(x))
    ct = rng.standard_normal(out.shape).astype(np.float32)
    return ct, w, x.shape, np.asarray(vjp(jnp.asarray(ct))[0])


@pytest.mark.parametrize("kernel", sorted(C1_COLS))
def test_dgrad_s2_c1_emulated_matches_jax_stem(kernel):
    """Either kernel's replay against the VJP of the JAX main path's stem
    (``_jax_stem_dgrad``)."""
    ct, w, x_shape, want = _jax_stem_dgrad()
    got = _dgrad_s2_c1_emulated(torch.from_numpy(ct), torch.from_numpy(w), x_shape, 1,
                                C1_COLS[kernel])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-3)


@functools.cache
def _jax_pallas_dgrad():
    """(ct, w, x shape, dx) of ``conv3d_k3s2_flat``'s VJP (``_dgrad_s2`` in
    interpret mode) at one input channel and the smallest width
    ``supports_s2`` takes (W = 256): its VALID-in-D contract is the chain
    call with qlo 0 over 2·D' + 1 planes."""
    B, cout, dp, H, W = 1, 64, 2, 4, 256
    assert supports_s2(1, 3, 2, H, W)
    dext = 2 * dp + 1
    rng = np.random.default_rng(74)
    x = rng.standard_normal((B, 1, dext * H * W)).astype(np.float32)
    w = (rng.uniform(-1, 1, (cout, 1, 3, 3, 3)) / np.sqrt(27)).astype(np.float32)
    bias = np.zeros(cout, np.float32)
    ct = rng.standard_normal((B, cout, dp * (H // 2) * (W // 2))).astype(np.float32)
    _, vjp = jax.vjp(lambda xv: conv3d_k3s2_flat((dext, H, W), xv, jnp.asarray(w),
                                                 jnp.asarray(bias)), jnp.asarray(x))
    want = np.asarray(vjp(jnp.asarray(ct))[0]).reshape(B, 1, dext, H, W)
    return ct.reshape(B, cout, dp, H // 2, W // 2), w, (B, 1, dext, H, W), want


@pytest.mark.parametrize("kernel", sorted(C1_COLS))
def test_dgrad_s2_c1_emulated_matches_jax_pallas(kernel):
    """Either kernel's replay against dx of ``conv3d_k3s2_flat``'s VJP
    (``_jax_pallas_dgrad``: ``_dgrad_s2`` in interpret mode)."""
    ct, w, x_shape, want = _jax_pallas_dgrad()
    got = _dgrad_s2_c1_emulated(torch.from_numpy(ct), torch.from_numpy(w), x_shape, 0,
                                C1_COLS[kernel])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-3)


# ---------------------------------------------------------- the forward ---

def _copies_s2(xa, b, p0, ih0, ow0, nv, H, W):
    """The forward's three copies of a block's patch: 9 planes × 9 rows of
    x's raw columns from 2·ow0 − 8 (zero outside the view and the image),
    copy dx column c = raw column 7 + 2·c + dx, i.e. input column 2·(ow0 +
    c) + dx − 1 (the byte-permute sort)."""
    td, th, tw = ck._FWD_TILE_C1IN[2]
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


def _fwd_c1in_s2_emulated(x, w, bias, qlo, d_out, act=None):
    """out, Σ, Σ² as ``conv_c1in_s2_tc_kernel`` computes them: per block and
    Cout tile, the copies, P = W[co, tap] · B[tap, voxel] over 32 taps (tap
    t of voxel (vz, vy, c): copy t % 3, plane 2·vz + t / 9, row 2·vy + (t /
    3) % 3, column c; 27-31 zero) added to the bias, one rounding, Σ/Σ² of the
    rounded values inside the output one partial per block, the blocks'
    partials in order."""
    B, _, nv, H, W = x.shape
    cout = w.shape[0]
    Ho, Wo = (H - 1) // 2 + 1, (W - 1) // 2 + 1
    td, th, tw = ck._FWD_TILE_C1IN[2]
    co_t = 32 if cout <= 32 else 64
    xa = ck.act_plain(act, x).float()
    wpad = torch.zeros((-(-cout // co_t) * co_t, 32))
    wpad[:cout, :27] = w.float().reshape(cout, 27)
    bpad = torch.zeros(wpad.shape[0])
    bpad[:cout] = bias.float()
    out = torch.zeros((B, cout, d_out, Ho, Wo), dtype=x.dtype)
    tiles = _fwd_tiles(d_out, H, W)
    partial = torch.zeros((B, cout, len(tiles), 2))
    cols = torch.arange(tw)
    for b, (blk, (od0, oh0, ow0)) in itertools.product(range(B), enumerate(tiles)):
        copies = _copies_s2(xa, b, 2 * od0 - qlo, 2 * oh0 - 1, ow0, nv, H, W)
        bmat = torch.cat([
            torch.cat([torch.stack([copies[t % 3, 2 * vz + t // 9, 2 * vy + (t // 3) % 3, cols]
                                    for t in range(27)]), torch.zeros((5, tw))])
            for vz, vy in itertools.product(range(td), range(th))], dim=1)
        for co0 in range(0, cout, co_t):
            acc = bpad[co0:co0 + co_t, None] + wpad[co0:co0 + co_t] @ bmat
            nz, ny, nx = min(td, d_out - od0), min(th, Ho - oh0), min(tw, Wo - ow0)
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


def _fwd_case(call, seed, dtype=F32):
    b, cout, nv, H, W, qlo, d_out = call
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((b, 1, nv, H, W)).astype(np.float32)).to(dtype)
    w = torch.from_numpy((rng.standard_normal((cout, 1, 3, 3, 3)) / np.sqrt(27))
                         .astype(np.float32)).to(dtype)
    bias = torch.from_numpy(rng.standard_normal(cout).astype(np.float32))
    return x, w, bias


@pytest.mark.parametrize("act", [None, "gelu"])
@pytest.mark.parametrize("call", STEM_RAGGED + [(1, 96, 6, 9, 64, 0, 3)])
def test_fwd_c1in_s2_emulated_matches_plain(act, call):
    """The replay (values and Σ/Σ²) against ``conv3d_k3_plain`` in fp32
    (1e-4: the same products, in another order) on ragged shapes, Cout tiles
    of 32 and 64 (masked, and two at Cout 96)."""
    x, w, bias = _fwd_case(call, 75)
    qlo, d_out = call[5], call[6]
    got = _fwd_c1in_s2_emulated(x, w, bias, qlo, d_out, act)
    want = ck.conv3d_k3_plain(x, w, bias, 2, qlo, d_out, True, act)
    for g, r in zip(got, want):
        np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=1e-4, atol=1e-4)


def test_fwd_c1in_s2_emulated_bf16_rounding():
    """In bf16 the replay rounds once, as the plain version does: within
    the card's bf16 TOL (2e-2, 2e-2) of ``conv3d_k3_plain``, and its Σ/Σ² are
    those of its own rounded output (fp32 sums in another order, 1e-5)."""
    x, w, bias = _fwd_case((8, 64, 9, 7, 13, 1, 5), 76, BF16)
    out, s1, s2 = _fwd_c1in_s2_emulated(x, w, bias, 1, 5, "silu")
    want = ck.conv3d_k3_plain(x, w, bias, 2, 1, 5, False, "silu")
    assert out.dtype == BF16
    of, wf = out.float(), want.float()
    assert bool(((of - wf).abs() <= 2e-2 + 2e-2 * wf.abs()).all())
    for got, ref in ((s1, of.sum(dim=(2, 3, 4))), (s2, (of * of).sum(dim=(2, 3, 4)))):
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-5, atol=1e-5)


def test_fwd_c1in_s2_emulated_matches_jax_stem():
    """Against the JAX main path's stem, ``ConvNCDHW`` at stride 2 with one
    input channel (XLA), 1→64 on an odd 9 × 7 × 13 volume, batch 2: the dense
    call (qlo 1, ⌈D/2⌉ planes)."""
    B, cout, D, H, W = 2, 64, 9, 7, 13
    rng = np.random.default_rng(77)
    x = rng.standard_normal((B, 1, D, H, W)).astype(np.float32)
    w = (rng.uniform(-1, 1, (cout, 1, 3, 3, 3)) / np.sqrt(27)).astype(np.float32)
    bias = rng.standard_normal(cout).astype(np.float32)
    conv = ConvNCDHW(cout, 3, stride=2, padding=1)
    want = np.asarray(conv.apply({"params": {"kernel": jnp.asarray(w), "bias": jnp.asarray(bias)}},
                                 jnp.asarray(x)))
    got = _fwd_c1in_s2_emulated(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(bias),
                                1, (D - 1) // 2 + 1)[0]
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)


def test_fwd_c1in_s2_emulated_matches_jax_pallas():
    """Against ``conv3d_k3s2_flat`` (``_conv_fwd_s2`` in interpret mode) at
    one input channel and the smallest width ``supports_s2`` takes (W =
    256): the chain call with qlo 0 over 2·D' + 1 planes."""
    B, cout, dp, H, W = 1, 64, 2, 4, 256
    assert supports_s2(1, 3, 2, H, W)
    dext = 2 * dp + 1
    rng = np.random.default_rng(78)
    x = rng.standard_normal((B, 1, dext, H, W)).astype(np.float32)
    w = (rng.uniform(-1, 1, (cout, 1, 3, 3, 3)) / np.sqrt(27)).astype(np.float32)
    bias = rng.standard_normal(cout).astype(np.float32)
    want = np.asarray(conv3d_k3s2_flat((dext, H, W), jnp.asarray(x.reshape(B, 1, -1)),
                                       jnp.asarray(w), jnp.asarray(bias)))
    got = _fwd_c1in_s2_emulated(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(bias),
                                0, dp)[0]
    np.testing.assert_allclose(got.reshape(B, cout, -1).numpy(), want, rtol=1e-5, atol=1e-4)


# ------------------------------------------ the fp32 data gradient's row ---

@pytest.mark.parametrize("dtype,want", [(F32, C1F), (BF16, C1)])
def test_stem_dgrad_row_instances_and_fp32_bound(dtype, want):
    """chip_smoke.py times the stem's data gradient (8 × 1→64, g 32³ → dx 64³)
    in bf16 on the one-dx-channel tensor cores and in fp32 on their CUDA-core
    form dgrad_s2_c1_f32_kernel (its ``fp32`` entry). The fp32 bound is the bytes
    of g (67.1 MB) and dx (8.4 MB) over 3.35 TB/s, 0.0225 ms, over the
    products at the fp32 rate outside the tensor cores (67 TFLOP/s: 0.0135
    ms)."""
    b, cin, cout, dhw = chip_smoke.TRAIN_KERNELS["conv3d_k3s2_c1in_dgrad"]["hot"]
    assert (b, cin, cout, dhw) == chip_smoke._S2_STEM == (8, 1, 64, (64, 64, 64))
    assert ck.dgrad_s2_instance(dtype, cin, cout) == want
    ms, by, terms = chip_smoke.bound("conv3d_k3s2_c1in_dgrad", chip_smoke._S2_STEM, itemsize=4,
                                     peak_flops=chip_smoke.PEAK_FLOPS_FP32)
    g_bytes, dx_bytes = 4 * 8 * 64 * 32 ** 3, 4 * 8 * 64 ** 3
    assert (g_bytes, dx_bytes) == (67_108_864, 8_388_608)
    assert by == "bytes" and abs(ms - (g_bytes + dx_bytes + 4 * 27 * 64) / 3.35e12 * 1e3) < 1e-9
    assert round(ms, 4) == 0.0225 and round(terms["products_ms"], 4) == 0.0135
