"""The plans of the port's fixed-order backward kernels, on the CPU: which
weight-gradient instance a call takes, how the splits of the weight gradient
and the key-tile groups of the fused flash backward (kernel D) cover their
work, and torch emulations of both kernels' orders of summation against the
plain versions and the JAX package.

- ``wgrad_instance``: bf16 with Cin ≥ 8 takes the tensor-core instance of
  E/G/K, bf16 at stride 1 with Cin = 1 the one-input-channel one, fp32 and
  the rest the CUDA-core one (the rule of ``wgrad_instance`` in
  csrc/conv3d_k3_bwd.cu).
- ``wgrad_plan`` / ``split_tiles``: the splits cover every voxel tile exactly
  once, none empty, at every main-path shape (contiguous ranges on the CUDA
  cores, every splits-th tile on the tensor cores).
- ``dq_groups``: kernel D's groups (its fp32 instance, on the CUDA cores)
  cover every key tile of a head exactly once, in order, none empty.
- Kernel D's dq on the CUDA cores: each group's partial summed over its key
  tiles in order, then the partials in group order, against
  ``flash_attention_bwd_plain`` and the JAX fused backward
  ``_bwd_pallas_fused`` (Pallas interpret mode), fp32.
- Kernel D on the tensor cores: its rule (``bwd_uses_tensor_cores``), its
  persistent schedule (every (head, key tile) once, each item waiting only
  on an item handed out before it, as the kernel source hands them out), its
  scratch (``bwd_tc_scratch``), and a torch replay of its arithmetic (key tiles of
  128, query tiles of 64, p and ds rounded to bf16 into their products, dq
  added in key-tile order into one fp32 accumulator) against
  ``flash_attention_bwd_plain`` and the JAX ``_bwd_pallas_fused``.
- The switches of ``scripts/wgrad_phases.py``, ``scripts/flash_bwd_phases.py``
  and ``scripts/conv_s2_weights.py`` still match their kernels.
- The tensor-core weight gradient's staging (raw 8-column vectors from
  column S·ow0 − 8, the channels-innermost patch, even/odd columns apart at
  stride 2) and split order, replayed in torch, against
  ``conv3d_k3_wgrad_plain`` and against the JAX chain conv's weight gradient
  (``conv3d_k3s1_chain`` / ``conv3d_k3s2_chain`` VJP in interpret mode).
- The tensor-core stride-2 data gradient (F/J): its rule
  (``dgrad_s2_instance``), its weight layout
  (``s2_dgrad_tc_weights``), its cover of the view's planes by blocks of two
  planes paired by their padding-1 index, and a torch replay of its parity
  classes, staging and epilogue (the window, act′ for gelu and silu) against
  ``conv3d_k3_dgrad_plain`` and the JAX ``conv3d_k3s2_chain`` VJP.
- The tensor-core dk/dv kernel (M): its rule (``bwd_dkv_uses_tensor_cores``)
  and the dk/dv half of the tensor-core D replay against
  ``flash_attention_bwd_plain`` and the JAX split backward ``_bwd_pallas``.
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
from hybrid_vit_cascade_tpu.ops.pallas.conv3d_k3s2 import conv3d_k3s2_chain as jax_chain_s2
from hybrid_vit_cascade_tpu_torch.ops.cuda import _build
from hybrid_vit_cascade_tpu_torch.ops.cuda import conv3d_k3 as ck
from hybrid_vit_cascade_tpu_torch.ops.cuda import flash_attention as fa
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

jfa = importlib.import_module("hybrid_vit_cascade_tpu.ops.pallas.flash_attention")

H100_SMS = 132


def _covers_in_order(n, parts, per):
    ranges = [range(s * per, min(n, (s + 1) * per)) for s in range(parts)]
    assert all(len(r) > 0 for r in ranges)
    assert [i for r in ranges for i in r] == list(range(n))


_TC, _C1IN, _CC = ck.WGRAD_TC, ck.WGRAD_C1IN_TC, ck.WGRAD_CUDA_CORE


@pytest.mark.parametrize("dtype,cin,tc", [(torch.bfloat16, 64, _TC), (torch.bfloat16, 8, _TC),
                                          (torch.bfloat16, 24, _TC), (torch.bfloat16, 7, _CC),
                                          (torch.bfloat16, 1, _C1IN), (torch.float32, 64, _CC),
                                          (torch.float32, 1, _CC)])
def test_wgrad_dispatch_rule(dtype, cin, tc):
    """The instance at stride 1 (the bf16 1-channel call on the
    one-input-channel tensor cores); at stride 2 the bf16 1-channel stem
    takes the stride-2 form of that instance."""
    assert ck.wgrad_instance(dtype, 1, cin) == tc
    assert ck.wgrad_plan((1, cin, 8, 16, 16), 32, 1, dtype, H100_SMS)[0] == tc
    assert ck.wgrad_instance(dtype, 2, cin) == (ck.WGRAD_C1IN_S2_TC if tc == _C1IN else tc)


# (B, Cin, output planes, H, W, Cout, stride): the weight gradients of the
# training step (dense and streamed chains) and ragged ones
WGRAD_SHAPES = [(1, 64, 256, 256, 256, 32, 1), (1, 64, 32, 256, 256, 32, 1),
                (2, 64, 32, 256, 256, 32, 1), (8, 128, 16, 16, 16, 256, 1),
                (1, 1, 256, 256, 256, 64, 1), (1, 32, 128, 256, 256, 64, 2),
                (1, 32, 16, 256, 256, 64, 2), (2, 128, 16, 32, 32, 256, 2),
                (1, 24, 4, 7, 9, 20, 1), (2, 40, 3, 5, 32, 36, 2), (1, 3, 5, 6, 10, 5, 2)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", WGRAD_SHAPES)
def test_wgrad_splits_cover_tiles_in_order(dtype, shape):
    b, cin, do, h, w, cout, stride = shape
    for sms in (H100_SMS, 7):
        tc, splits, n_tiles = ck.wgrad_plan((b, cin, do, h, w), cout, stride, dtype, sms)
        (td, th, tw), co_blk, ci_blk, per_sm = ck.wgrad_blocking(tc, stride, cin)
        ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
        assert n_tiles == b * -(-do // td) * -(-ho // th) * -(-wo // tw)
        if tc:  # split s takes tiles s, s + splits, ...
            parts = [list(range(sp, n_tiles, splits)) for sp in range(splits)]
            assert all(parts) and sorted(t for p in parts for t in p) == list(range(n_tiles))
        else:  # contiguous ranges, per as the kernel takes it
            _covers_in_order(n_tiles, splits, -(-n_tiles // splits))
        blocks = splits * -(-cout // co_blk) * -(-cin // ci_blk)
        assert splits == 1 or blocks <= per_sm * sms


def test_wgrad_hot_plan_fills_the_card():
    """The 64→32 stride-1 weight gradient at 256³ on the tensor cores: one
    block per SM (66 splits × 2 input-channel chunks)."""
    assert ck.wgrad_plan((1, 64, 256, 256, 256), 32, 1, torch.bfloat16, H100_SMS) == \
        (True, 66, 65536)


# (BH, Nk) of the training shapes (chip_smoke.py _FLASH_TRAIN_SHAPES) and ragged
@pytest.mark.parametrize("bh,nk", [(32, 4096), (32, 256), (16, 4096), (16, 1024), (8, 32768),
                                   (8, 4096), (3, 77), (2, 4100), (1, 1), (65535, 64)])
def test_dq_groups_cover_key_tiles(bh, nk):
    for sms in (H100_SMS, 1, 500):
        groups, per = fa.dq_groups(nk, bh, sms)
        n_tiles = -(-nk // fa._BKV)
        _covers_in_order(n_tiles, groups, per)
        assert groups * bh < fa._D_BLOCKS_PER_SM * sms + bh  # about 4 blocks per SM


def test_dq_groups_stage3_scratch():
    """At the stage-3 self-attention, 64 groups of 8 key tiles: 512 blocks,
    and a 2.1 GB fp32 partial (64 × 8 × 32,768 × 32 × 4 bytes)."""
    groups, per = fa.dq_groups(32768, 8, H100_SMS)
    assert (groups, per) == (64, 8)
    assert groups * 8 * 32768 * 32 * 4 == 2_147_483_648


def _dq_by_groups(q, k, v, out, lse, dout, scale, sms):
    """Kernel D's dq in its order of summation, fp32: group g adds the dq
    shares of its key tiles in order into its partial; then the partials are
    added in group order."""
    bh, _, _ = q.shape
    groups, per = fa.dq_groups(k.shape[1], bh, sms)
    qf, kf, vf, dof = (t.float() for t in (q, k, v, dout))
    delta = (dof * out.float()).sum(-1, keepdim=True)
    n_tiles = -(-k.shape[1] // fa._BKV)
    dq = torch.zeros_like(qf)
    for g in range(groups):
        part = None
        for kt in range(g * per, min(n_tiles, (g + 1) * per)):
            ks, vs = (t[:, kt * fa._BKV:(kt + 1) * fa._BKV] for t in (kf, vf))
            p = torch.exp(qf @ ks.transpose(1, 2) * scale - lse[..., None])
            ds = p * (dof @ vs.transpose(1, 2) - delta)
            share = (ds @ ks) * scale
            part = share if part is None else part + share
        dq = dq + part
    return dq


@pytest.mark.parametrize("nq,nk,d,sms,with_jax", [(96, 300, 32, 2, True), (72, 130, 64, 1, False),
                                                   (50, 200, 32, 4, False)])
def test_dq_group_partials_match_plain_and_jax(monkeypatch, nq, nk, d, sms, with_jax):
    rng = np.random.default_rng(7)
    q, dout = (rng.standard_normal((1, 2, nq, d)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((1, 2, nk, d)).astype(np.float32) for _ in range(2))
    scale = d ** -0.5
    qt, kt, vt, dot = (torch.from_numpy(a[0]) for a in (q, k, v, dout))
    out, lse = fa.flash_attention_plain(qt, kt, vt, scale)
    got = _dq_by_groups(qt, kt, vt, out, lse, dot, scale, sms)
    assert fa.dq_groups(nk, 2, sms)[0] > 1  # more than one partial to add
    want = fa.flash_attention_bwd_plain(qt, kt, vt, out, lse, dot, scale)[0]
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)
    if not with_jax:
        return

    def loss(q_, k_, v_):
        o = jfa.flash_attention(q_, k_, v_, scale, block_q=32, block_kv=32)
        return (o * jnp.asarray(dout)).sum()

    monkeypatch.setattr(jfa, "FUSED_BWD", True)  # the JAX default: _bwd_pallas_fused
    want_j = jax.grad(loss)(*(jnp.asarray(a) for a in (q, k, v)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want_j)[0], rtol=5e-4, atol=5e-4)


# ------------------------------------------ D on the tensor cores ---

@pytest.mark.parametrize("dtype,tc", [(torch.bfloat16, True), (torch.float32, False)])
def test_flash_bwd_dispatch_rule(dtype, tc):
    """bf16 takes the tensor-core D (``bwd_uses_tc`` in C), fp32 the CUDA
    cores: TF32 products would leave the fp32 tolerance."""
    assert fa.bwd_uses_tensor_cores(dtype) is tc


# (BH, Nq, Nk) of the training shapes (chip_smoke.py _FLASH_TRAIN_SHAPES) and ragged
D_TC_SHAPES = [(32, 4096, 4096), (32, 4096, 256), (16, 4096, 4096), (16, 4096, 1024),
               (8, 32768, 32768), (8, 32768, 4096), (3, 200, 77), (2, 130, 4100), (1, 1, 1),
               (5, 64, 129)]


# The tensor-core D's hand-out of work items, as csrc/flash_bwd_tc.cuh (the
# body D and M share) states it: item i (from one atomic counter) is key tile i / BH of head
# i % BH, and a (head, query tile)'s counter is waited on until it reads kt.
_D_TC_HANDOUT = ("const long long n_items = static_cast<long long>(bhs) * "
                 "((nk + kTbKeys - 1) / kTbKeys);",
                 "if (tid == 0) item_s = atomicAdd(counters, 1);",
                 "const long long bh = item % bhs;",
                 "const int kt = item / bhs;",
                 "if (tid == 0) wait_for(cnt, kt);")


def _d_tc_items(bh, nk):
    """(head, key tile) of each work item of the tensor-core D, in the order
    the kernel hands them out (key tiles of ``_TC_KEYS`` keys)."""
    return [(i % bh, i // bh) for i in range(bh * -(-nk // fa._TC_KEYS))]


def test_flash_bwd_tc_schedule_is_the_kernels():
    """The schedule the tests replay (``_d_tc_items``) is the one the kernel
    source states: its hand-out lines and its tile constants (8 warps × 16
    keys, query tiles of 64) equal the port's ``_TC_KEYS`` / ``_TC_ROWS``."""
    src = (_build.CSRC_DIR / "flash_bwd_tc.cuh").read_text()
    for line in _D_TC_HANDOUT:
        assert src.count(line) == 1, line
    warps = int(re.search(r"constexpr int kTbWarps = (\d+);", src).group(1))
    assert re.search(r"constexpr int kTbKeys = 16 \* kTbWarps;", src)
    assert 16 * warps == fa._TC_KEYS
    assert int(re.search(r"constexpr int kTbRows = (\d+);", src).group(1)) == fa._TC_ROWS


@pytest.mark.parametrize("bh,nq,nk", D_TC_SHAPES)
def test_flash_bwd_tc_schedule(bh, nq, nk):
    """Every (head, key tile) is one work item, handed out once; an item's
    dq adds wait only on the same head's previous key tile, an item with a
    lower index, so handed out (and running) before it: no wait can be on a
    block that has not started, whatever the grid."""
    items = _d_tc_items(bh, nk)
    n_kt = -(-nk // fa._TC_KEYS)
    assert sorted(items) == [(h, kt) for h in range(bh) for kt in range(n_kt)]
    pos = {it: i for i, it in enumerate(items)}
    for i, (h, kt) in enumerate(items):
        if kt > 0:  # the kernel's wait: item i on item i − BH
            assert pos[(h, kt - 1)] == i - bh < i
    # heads interleave: the first key tiles of every head go out first
    assert items[:bh] == [(h, 0) for h in range(bh)]


@pytest.mark.parametrize("bh,nq,nk", D_TC_SHAPES[:6])
def test_flash_bwd_tc_scratch(bh, nq, nk):
    """One fp32 (BH, Nq, d) accumulator and 1 + one counter per (head, query
    tile of 64), in place of the CUDA-core instance's G partials: at the
    stage-3 self-attention 32 MB (inside the 50 MB L2) against 2.1 GB."""
    d = 32 if bh in (8, 16) else 64
    acc, cnt = fa.bwd_tc_scratch(bh, nq, d)
    assert acc == bh * nq * d
    assert cnt == 1 + bh * -(-nq // 64)
    groups, _ = fa.dq_groups(nk, bh, H100_SMS)
    assert acc <= groups * bh * nq * d
    if (bh, nq, nk) == (8, 32768, 32768):
        assert acc * 4 == 33_554_432 and groups * acc * 4 == 2_147_483_648


def _d_tc_emulated(q, k, v, out, lse, dout, scale, dq=True):
    """(dq, dk, dv) as the tensor-core D computes them from bf16 inputs: per
    work item (``_d_tc_items``: 128 keys of one head) and query tile of 64,
    Sᵀ = K·qᵀ and dPᵀ = V·doutᵀ in fp32, p = exp2(s·scale·log2e −
    lse·log2e), ds = p·(dp − delta); dv += bf16(p)·dout, dk += bf16(ds)·q;
    the tile's dq share bf16(ds)ᵀ·K written (first key tile) or added (the
    rest, in key-tile order) into one fp32 accumulator; dq = bf16(acc·scale),
    dk = bf16(dk·scale), dv = bf16(dv). Without ``dq``: (dk, dv) as the
    tensor-core M computes them, the same body without the dq phase (each
    item's dk and dv rows its own, so the order of the items is free)."""
    bh, nq, d = q.shape
    nk = k.shape[1]
    qf, kf, vf, dof = (t.float() for t in (q, k, v, dout))
    delta = (dof * out.float()).sum(-1)
    c, l2 = scale * math.log2(math.e), lse * math.log2(math.e)
    acc = torch.full((bh, nq, d), float("nan"))
    dk, dv = torch.zeros((bh, nk, d)), torch.zeros((bh, nk, d))
    for h, kt in _d_tc_items(bh, nk):
        k0 = kt * fa._TC_KEYS
        ks, vs = kf[h, k0:k0 + fa._TC_KEYS], vf[h, k0:k0 + fa._TC_KEYS]
        for r0 in range(0, nq, fa._TC_ROWS):
            qs, ds_ = qf[h, r0:r0 + fa._TC_ROWS], dof[h, r0:r0 + fa._TC_ROWS]
            p = torch.exp2((ks @ qs.T) * c - l2[h, r0:r0 + fa._TC_ROWS])
            ds = p * ((vs @ ds_.T) - delta[h, r0:r0 + fa._TC_ROWS])
            pb, dsb = (t.to(torch.bfloat16).float() for t in (p, ds))
            dv[h, k0:k0 + fa._TC_KEYS] += pb @ ds_
            dk[h, k0:k0 + fa._TC_KEYS] += dsb @ qs
            if not dq:
                continue
            share = dsb.T @ ks
            if kt == 0:
                acc[h, r0:r0 + fa._TC_ROWS] = share
            else:
                acc[h, r0:r0 + fa._TC_ROWS] += share
    bf = torch.bfloat16
    grads = (dk * scale).to(bf), dv.to(bf)
    return ((acc * scale).to(bf), *grads) if dq else grads


def _bf16_inputs(bh, nq, nk, d, seed):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal(sh).astype(np.float32)).to(torch.bfloat16)
                 for sh in ((bh, nq, d), (bh, nk, d), (bh, nk, d), (bh, nq, d)))


# (BH, Nq, Nk, d): ragged query and key tails, several key tiles and query tiles
D_TC_EMULATED = [(2, 96, 300, 32), (2, 130, 77, 64), (1, 64, 129, 32)]


@pytest.mark.parametrize("bh,nq,nk,d", D_TC_EMULATED)
def test_flash_bwd_tc_emulated_matches_plain(bh, nq, nk, d):
    """Within the card's tolerance of the flash backward in bf16
    (chip_smoke.py FLASH_OUT_TOL: 1e-2·max|want| + 2e-2·|want|): both sides
    take the same bf16 inputs and fp32 lse; the replay rounds p and ds to
    bf16 before their products (2^-9 relative each) and its outputs to
    bf16."""
    q, k, v, dout = _bf16_inputs(bh, nq, nk, d, 41)
    scale = d ** -0.5
    out, lse = fa.flash_attention_plain(q, k, v, scale)
    got = _d_tc_emulated(q, k, v, out, lse, dout, scale)
    want = fa.flash_attention_bwd_plain(q, k, v, out, lse, dout, scale)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape
        wf = w.float()
        err = (g.float() - wf).abs()
        assert bool((err <= 1e-2 * wf.abs().max() + 2e-2 * wf.abs()).all()), float(err.max())


@pytest.mark.parametrize("bh,nq,nk,d", D_TC_EMULATED[:2])
def test_flash_bwd_tc_emulated_matches_jax(monkeypatch, bh, nq, nk, d):
    """Against the gradients of the JAX flash attention in bf16 through its
    fused backward ``_bwd_pallas_fused`` (interpret mode), which rounds p and
    ds to bf16 as the replay does. JAX runs its own forward, whose bf16
    pre-scale of q moves every score by up to 2^-8 relative (the forward
    test's note), so the two differ by more than rounding: ROADMAP's flash
    bf16 tolerance, 3e-2 absolute and relative."""
    q, k, v, dout = _bf16_inputs(bh, nq, nk, d, 42)
    scale = d ** -0.5
    out, lse = fa.flash_attention_plain(q, k, v, scale)
    got = _d_tc_emulated(q, k, v, out, lse, dout, scale)

    def loss(q_, k_, v_):  # (B, H, N, d) with B = 1, H = BH
        o = jfa.flash_attention(q_, k_, v_, scale, block_q=32, block_kv=32)
        return (o.astype(jnp.float32) * jnp.asarray(dout.float().numpy()[None])).sum()

    monkeypatch.setattr(jfa, "FUSED_BWD", True)  # the JAX default: _bwd_pallas_fused
    want = jax.grad(loss, argnums=(0, 1, 2))(
        *(jnp.asarray(t.float().numpy()[None], jnp.bfloat16) for t in (q, k, v)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.float().numpy(), np.asarray(w.astype(jnp.float32))[0],
                                   rtol=3e-2, atol=3e-2)


# ------------------------------------------ M on the tensor cores ---

@pytest.mark.parametrize("dtype,tc", [(torch.bfloat16, True), (torch.float32, False)])
def test_flash_bwd_dkv_dispatch_rule(dtype, tc):
    """bf16 takes the tensor-core M (``dkv_uses_tc`` in C), fp32 the CUDA
    cores, as D."""
    assert fa.bwd_dkv_uses_tensor_cores(dtype) is tc
    assert fa.bwd_dkv_uses_tensor_cores(dtype) is fa.bwd_uses_tensor_cores(dtype)


@pytest.mark.parametrize("bh,nq,nk,d", D_TC_EMULATED)
def test_flash_bwd_dkv_tc_emulated_matches_plain(bh, nq, nk, d):
    """The tensor-core M's dk and dv within FLASH_OUT_TOL (chip_smoke.py:
    1e-2·max|want| + 2e-2·|want|) of the plain fp32 backward: p and ds are
    rounded to bf16 before their products (2^-9 relative each), the outputs
    to bf16; and equal to the replay of D's dk and dv, whose body M is."""
    q, k, v, dout = _bf16_inputs(bh, nq, nk, d, 43)
    scale = d ** -0.5
    out, lse = fa.flash_attention_plain(q, k, v, scale)
    got = _d_tc_emulated(q, k, v, out, lse, dout, scale, dq=False)
    want = fa.flash_attention_bwd_plain(q, k, v, out, lse, dout, scale)[1:]
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape
        wf = w.float()
        err = (g.float() - wf).abs()
        assert bool((err <= 1e-2 * wf.abs().max() + 2e-2 * wf.abs()).all()), float(err.max())
    fused = _d_tc_emulated(q, k, v, out, lse, dout, scale)[1:]
    assert all(torch.equal(a, b) for a, b in zip(got, fused))


@pytest.mark.parametrize("bh,nq,nk,d", D_TC_EMULATED[:2])
def test_flash_bwd_dkv_tc_emulated_matches_jax(monkeypatch, bh, nq, nk, d):
    """Against dk and dv of the JAX flash attention in bf16 through its split
    backward ``_bwd_pallas`` (``FUSED_BWD`` off: ``_bwd_dkv_kernel``, interpret
    mode), which rounds p and ds to bf16 as the replay does; ROADMAP's flash
    bf16 tolerance, 3e-2 absolute and relative (JAX's bf16 pre-scale of q
    moves every score by up to 2^-8 relative)."""
    q, k, v, dout = _bf16_inputs(bh, nq, nk, d, 44)
    scale = d ** -0.5
    out, lse = fa.flash_attention_plain(q, k, v, scale)
    got = _d_tc_emulated(q, k, v, out, lse, dout, scale, dq=False)

    def loss(k_, v_):  # (B, H, N, d) with B = 1, H = BH
        q_ = jnp.asarray(q.float().numpy()[None], jnp.bfloat16)
        o = jfa.flash_attention(q_, k_, v_, scale, block_q=32, block_kv=32)
        return (o.astype(jnp.float32) * jnp.asarray(dout.float().numpy()[None])).sum()

    monkeypatch.setattr(jfa, "FUSED_BWD", False)  # HVC_FLASH_FUSED_BWD=0: _bwd_pallas
    want = jax.grad(loss, argnums=(0, 1))(
        *(jnp.asarray(t.float().numpy()[None], jnp.bfloat16) for t in (k, v)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.float().numpy(), np.asarray(w.astype(jnp.float32))[0],
                                   rtol=3e-2, atol=3e-2)


# ------------------------------------------ the tensor-core weight gradient ---

def _wgrad_tc_emulated(x, g, stride, qlo, act, sms=H100_SMS):
    """dW as the tensor-core instance computes it, in fp32: per tile, the raw
    rows of 8-column vectors from input column S·ow0 − 8, the patch
    [row][position][ci] (patch column pw = raw column − 7; at stride 2 even
    columns first), the 27 taps read per voxel from the patch, the products
    added per split (split s: tiles s, s + splits, ...), the splits in
    order."""
    B, cin, nv, H, W = x.shape
    cout, do, ho, wo = g.shape[1:]
    (td, th, tw), _, ci_blk, _ = ck._WGRAD_TC[stride]
    s = stride
    pd, ph, pw_n = (td - 1) * s + 3, (th - 1) * s + 3, (tw - 1) * s + 3
    nvec = ((tw - 1) * s + 9) // 8 + 1
    pwe = pw_n if s == 1 else tw + 1
    pcol = (lambda c: c) if s == 1 else (lambda c: (c & 1) * pwe + (c >> 1))
    cpad = -(-cin // ci_blk) * ci_blk
    xs = ck.act_plain(act, x).float()  # the prologue, rounded to x's dtype
    _, splits, n_tiles = ck.wgrad_plan((B, cin, do, H, W), cout, stride, torch.bfloat16, sms)
    tiles_w, tiles_h, tiles_d = -(-wo // tw), -(-ho // th), -(-do // td)
    gf = g.float()
    dw = torch.zeros((cout, cin, 27))
    for sp in range(splits):
        part = torch.zeros((cout, cpad, 27))
        for tile in range(sp, n_tiles, splits):
            tx, rest = tile % tiles_w, tile // tiles_w
            ty, rest = rest % tiles_h, rest // tiles_h
            tz, b = rest % tiles_d, rest // tiles_d
            od0, oh0, ow0 = tz * td, ty * th, tx * tw
            raw = torch.zeros((cpad, pd, ph, nvec * 8))
            for r_d in range(pd):
                p = od0 * s - qlo + r_d
                if not 0 <= p < nv:
                    continue
                for r_h in range(ph):
                    ih = oh0 * s - 1 + r_h
                    if not 0 <= ih < H:
                        continue
                    for c in range(nvec * 8):
                        col = ow0 * s - 8 + c
                        if 0 <= col < W:
                            raw[:cin, r_d, r_h, c] = xs[b, :, p, ih, col]
            patch = torch.zeros((pd, ph, pw_n | 1, cpad))
            for c in range(7, 7 + pw_n):
                patch[:, :, pcol(c - 7), :] = raw[:, :, :, c].permute(1, 2, 0)
            gt = torch.zeros((cout, td, th, tw))
            dz_, dy_, dx_ = (min(n, lim) for n, lim in ((td, do - od0), (th, ho - oh0),
                                                        (tw, wo - ow0)))
            gt[:, :dz_, :dy_, :dx_] = gf[b, :, od0:od0 + dz_, oh0:oh0 + dy_, ow0:ow0 + dx_]
            for tap in range(27):
                dz, dy, dx = tap // 9, (tap // 3) % 3, tap % 3
                cols = [pcol(t * s + dx) for t in range(tw)]
                bmat = torch.stack([torch.stack([patch[vz * s + dz, vy * s + dy, cols]
                                                 for vy in range(th)]) for vz in range(td)])
                part[:, :, tap] += gt.reshape(cout, -1) @ bmat.reshape(-1, cpad)
        dw += part[:, :cin]
    return dw.reshape(cout, cin, 3, 3, 3)


# (B, Cin, Cout, (H, W), planes of x, slab plane of x's first plane, output
# planes at stride 1, at stride 2)
TC_EMULATED = [(1, 24, 20, (7, 9), 5, -1, 4, 2), (2, 10, 36, (5, 32), 6, 0, 5, 3),
               (1, 9, 7, (9, 35), 7, 1, 7, 4)]


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("act", [None, "gelu"])
@pytest.mark.parametrize("case", TC_EMULATED)
def test_wgrad_tc_staging_matches_plain(stride, act, case):
    b, cin, cout, (h, w), nv, qlo, d1, d2 = case
    d_out = d1 if stride == 1 else d2
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.standard_normal((b, cin, nv, h, w)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal(
        (b, cout, d_out, (h - 1) // stride + 1, (w - 1) // stride + 1)).astype(np.float32))
    got = _wgrad_tc_emulated(x, g, stride, qlo, act, sms=3)
    want = ck.conv3d_k3_wgrad_plain(x, g, stride, qlo, act)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("stride", [1, 2])
def test_wgrad_tc_staging_matches_jax(stride):
    """Against the JAX chain conv's weight gradient (interpret mode) at the
    smallest width its shape gate takes, x windowed at the front."""
    B, cin, cout, H, W, dext = 1, 8, 4, 4, 128 * stride, 5
    vlo, vhi = 1, dext
    d_out = dext - 2 if stride == 1 else (dext - 1) // 2
    rng = np.random.default_rng(12)
    x = rng.standard_normal((B, cin, dext, H, W)).astype(np.float32)
    w = (rng.uniform(-1, 1, (cout, cin, 3, 3, 3)) / np.sqrt(27 * cin)).astype(np.float32)
    bias = np.zeros(cout, np.float32)
    ho, wo = H // stride, W // stride
    g = rng.standard_normal((B, cout, d_out * ho * wo)).astype(np.float32)
    jfn = jax_chain_s1 if stride == 1 else jax_chain_s2
    _, vjp = jax.vjp(lambda wv: jfn((dext, H, W, False, "silu"), jnp.asarray(x.reshape(B, cin, -1)),
                                    jnp.asarray([vlo, vhi], jnp.int32), wv, jnp.asarray(bias)),
                     jnp.asarray(w))
    want = np.asarray(vjp(jnp.asarray(g))[0])
    xt = torch.from_numpy(x).narrow(2, vlo, vhi - vlo)
    got = _wgrad_tc_emulated(xt, torch.from_numpy(g).reshape(B, cout, d_out, ho, wo), stride,
                             vlo, "silu", sms=2)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_wgrad_phase_switches_match_the_kernel():
    """scripts/wgrad_phases.py switches the tensor-core kernel's phases off by
    editing a copy of its source: every switch still finds its line."""
    from hybrid_vit_cascade_tpu_torch.scripts import wgrad_phases

    src = wgrad_phases.ablated_source()
    assert all(new in src for _, new in wgrad_phases.SWITCHES.values())


@pytest.mark.parametrize("script", ["flash_bwd_phases", "conv_s2_weights", "dgrad_s2_phases"])
def test_switches_match_the_kernel(script):
    """scripts/flash_bwd_phases.py (D's phases switched off, M's grid),
    scripts/conv_s2_weights.py (C/I's weights staged from w) and
    scripts/dgrad_s2_phases.py (F/J's phases switched off) edit a copy of
    their kernel's source: every switch still finds its text."""
    phases = importlib.import_module(f"hybrid_vit_cascade_tpu_torch.scripts.{script}")
    src = phases.ablated_source()
    assert all(new in src for _, new in phases.SWITCHES.values())


# ------------------------------------------ F/J on the tensor cores ---

@pytest.mark.parametrize("dtype,cin,cout,tc", [
    (torch.bfloat16, 32, 64, True), (torch.bfloat16, 8, 8, True), (torch.bfloat16, 24, 40, True),
    (torch.bfloat16, 7, 64, False), (torch.bfloat16, 64, 7, False), (torch.bfloat16, 1, 64, False),
    (torch.float32, 32, 64, False), (torch.float32, 1, 64, False)])
def test_dgrad_s2_dispatch_rule(dtype, cin, cout, tc):
    """bf16 with Cin ≥ 8 and Cout ≥ 8 takes the tensor-core F/J (instance 1
    of ``dgrad_s2_instance`` in csrc/conv3d_k3_bwd.cu); fp32 the CUDA cores,
    the bf16 1-channel stem the one-dx-channel instance
    (tests/test_torch_conv_s2_c1in.py)."""
    assert (ck.dgrad_s2_instance(dtype, cin, cout) == ck.DGRAD_S2_TC) is tc


def test_s2_dgrad_tc_weights_layout():
    """``s2_dgrad_tc_weights``: element (co, ci, tap) of the weights at
    [ci // 32, co // 16, tap, ci % 32, co % 16], zeros in the padding."""
    rng = np.random.default_rng(26)
    w = torch.from_numpy(rng.standard_normal((20, 40, 3, 3, 3)).astype(np.float32))
    wt = ck.s2_dgrad_tc_weights(w)
    assert tuple(wt.shape) == (2, 2, 27, 32, 16) and wt.is_contiguous()
    flat = w.reshape(20, 40, 27)
    for co, ci, tap in itertools.product((0, 15, 16, 19), (0, 31, 32, 39), (0, 13, 26)):
        assert wt[ci // 32, co // 16, tap, ci % 32, co % 16] == flat[co, ci, tap]
    assert wt[1, :, :, 8:].abs().sum() == 0 and wt[:, 1, :, :, 4:].abs().sum() == 0


# The tensor-core F/J's cover of the view's planes, as csrc/conv3d_k3_bwd.cu
# states it: blocks of two planes iz0, iz0 + 1 in padding-1 terms (iz = view
# plane + qlo − 1), iz0 even, from the even iz at or before the first plane.
_DGRAD_TC_TILING = ("const int iz0 = ((qlo - 1) & ~1) + 2 * static_cast<int>(rest % n_tz);",
                    "const int iz_first = (qlo - 1) & ~1, iz_end = qlo - 1 + nv;",
                    "const int n_tz = (iz_end - iz_first + 1) / 2;",
                    "const int pv = iz0 + z - (qlo - 1)")


def _dgrad_tc_plane_pairs(qlo, nv):
    """(iz0, view planes of z = 0, 1) of each plane pair of the tensor-core
    F/J, None where the plane lies outside the view (not written)."""
    iz_first, iz_end = (qlo - 1) & ~1, qlo - 1 + nv
    out = []
    for tz in range((iz_end - iz_first + 1) // 2):
        iz0 = iz_first + 2 * tz
        pvs = [iz0 + z - (qlo - 1) for z in (0, 1)]
        out.append((iz0, [pv if 0 <= pv < nv else None for pv in pvs]))
    return out


def test_dgrad_tc_tiling_is_the_kernels():
    src = (_build.CSRC_DIR / "conv3d_k3_bwd.cu").read_text()
    for line in _DGRAD_TC_TILING:
        assert src.count(line) == 1, line
    assert "constexpr int kDtTy = 8, kDtTx = 32;" in src
    assert "constexpr int kDtCi = 32;" in src and "constexpr int kDtCo = 16;" in src
    assert (ck._DGRAD_TC_CI, ck._DGRAD_TC_CO) == (32, 16)


# (qlo, planes of x): the chain shapes of chip_smoke.py (CHAIN_SHAPES_S2,
# CHAIN_RAGGED_S2: qlo −1, 0, 1, 2) and odd counts
@pytest.mark.parametrize("qlo,nv", [(0, 33), (1, 32), (1, 256), (2, 4), (0, 6), (-1, 5), (2, 7),
                                    (-1, 1), (1, 1), (0, 2)])
def test_dgrad_tc_plane_pairs_cover_the_view(qlo, nv):
    """Every view plane is written by exactly one block, in the z slot its
    padding-1 parity names (even iz in slot 0), and no block writes outside
    the view."""
    pairs = _dgrad_tc_plane_pairs(qlo, nv)
    written = [pv for _, pvs in pairs for pv in pvs if pv is not None]
    assert sorted(written) == list(range(nv))
    for iz0, pvs in pairs:
        assert iz0 % 2 == 0
        for z, pv in enumerate(pvs):
            if pv is not None:
                assert (pv + qlo - 1) % 2 == z
    assert all(any(pv is not None for pv in pvs) for _, pvs in pairs)


def _dgrad_tc_emulated(g, w, x, qlo, act=None):
    """dx of the stride-2 chain conv as the tensor-core F/J computes it, fp32
    products of the operands in g's dtype: per block of two planes
    (``_dgrad_tc_plane_pairs``) × 8 rows × 32 columns and Cin tile of 32,
    the g patch (planes iz0 / 2 + {0, 1}, 5 rows from row 4·ty, 17 columns
    from 16·tx; zero outside g and Cout) and per parity class (pz, py, px) the
    products over its taps with the weights from ``s2_dgrad_tc_weights`` (a
    voxel at even index takes d = 1 from g index u, one at odd index d = 0
    from u + 1 and d = 2 from u), Cout chunk by chunk; the classes interleave
    into the block's fp32 tile, act′(x) multiplies it, one rounding to g's
    dtype, view planes only. Also returns how often each dx element was
    written."""
    B, cin, nv, H, W = x.shape
    cout, do, ho, wo = g.shape[1:]
    wt = ck.s2_dgrad_tc_weights(w).float()
    n_ci, n_co = wt.shape[:2]
    gp = torch.zeros((B, n_co * 16, do + nv + 4, ho + 4, wo + 16))  # g, zero-padded: plane −1 …
    gp[:, :cout, 1:do + 1, :ho, :wo] = g.float()
    dx = torch.zeros((B, cin, nv, H, W), dtype=g.dtype)
    writes = torch.zeros((B, cin, nv, H, W), dtype=torch.int32)
    for b, (iz0, pvs), ty, tx, cit in itertools.product(
            range(B), _dgrad_tc_plane_pairs(qlo, nv), range(-(-H // 8)), range(-(-W // 32)),
            range(n_ci)):
        oz0, oy0, ox0 = iz0 // 2, 4 * ty, 16 * tx
        patch = gp[b, :, oz0 + 1:oz0 + 3, oy0:oy0 + 5, ox0:ox0 + 17]  # (co, 2, 5, 17)
        tile = torch.zeros((32, 2, 8, 32))
        for pz, py, px in itertools.product((0, 1), repeat=3):
            acc = torch.zeros((32, 4, 16))
            for dz, dy, dx_ in itertools.product(*((0, 2) if p else (1,) for p in (pz, py, px))):
                tap = dz * 9 + dy * 3 + dx_
                rz, ry, rx = int(dz == 0), int(dy == 0), int(dx_ == 0)
                for ch in range(n_co):
                    gt = patch[16 * ch:16 * ch + 16, rz, ry:ry + 4, rx:rx + 16]
                    acc += torch.einsum("ic,cyx->iyx", wt[cit, ch, tap], gt)
            tile[:, pz, py::2, px::2] = acc
        ci0, iy0, ix0 = 32 * cit, 8 * ty, 32 * tx
        nc, nh, nw = min(32, cin - ci0), min(8, H - iy0), min(32, W - ix0)
        for z, pv in enumerate(pvs):
            if pv is None:
                continue
            val = tile[:nc, z, :nh, :nw]
            if act is not None:
                val = val * ck.dact_plain(act, x[b, ci0:ci0 + nc, pv, iy0:iy0 + nh, ix0:ix0 + nw])
            dx[b, ci0:ci0 + nc, pv, iy0:iy0 + nh, ix0:ix0 + nw] = val.to(g.dtype)
            writes[b, ci0:ci0 + nc, pv, iy0:iy0 + nh, ix0:ix0 + nw] += 1
    return dx, writes


# (B, Cin, Cout, planes of x, H, W, slab plane of x's first plane, output
# planes, act): chip_smoke.py CHAIN_RAGGED_S2 with the act′ epilogue on, and
# ragged ones for the tiles: Cin over a 32-channel tile, Cout not a multiple
# of 16, H and W not multiples of 8 and 32 (odd), x beginning before the slab
DGRAD_TC_EMULATED = [(2, 3, 5, 4, 6, 10, 2, 3, "silu"), (1, 8, 40, 6, 5, 12, 0, 2, "gelu"),
                     (1, 4, 8, 5, 6, 6, -1, 2, None), (1, 40, 20, 7, 9, 35, 1, 4, "gelu"),
                     (1, 12, 17, 5, 17, 33, -1, 3, "silu"), (2, 9, 16, 3, 8, 32, 1, 2, None)]


@pytest.mark.parametrize("case", DGRAD_TC_EMULATED)
def test_dgrad_tc_emulated_matches_plain(case):
    """The replay writes every dx element once and agrees with
    ``conv3d_k3_dgrad_plain`` in fp32 (both sum the same products in another
    order: 1e-4)."""
    b, cin, cout, nv, h, w_, qlo, d_out, act = case
    rng = np.random.default_rng(27)
    x = torch.from_numpy(rng.standard_normal((b, cin, nv, h, w_)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((cout, cin, 3, 3, 3)) / np.sqrt(27 * cin))
                         .astype(np.float32))
    g = torch.from_numpy(rng.standard_normal(
        (b, cout, d_out, (h - 1) // 2 + 1, (w_ - 1) // 2 + 1)).astype(np.float32))
    got, writes = _dgrad_tc_emulated(g, w, x, qlo, act)
    assert bool((writes == 1).all())
    want = ck.conv3d_k3_dgrad_plain(g, w, x, 2, qlo, act)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("act", [None, "gelu"])
def test_dgrad_tc_emulated_matches_jax(act):
    """Against dx of the JAX stride-2 chain conv (``conv3d_k3s2_chain`` VJP,
    ``_dgrad_s2`` in interpret mode, fp32) at the smallest width its shape
    gate takes (W % 256 = 0), x windowed at the front (view planes 1-6 of 7:
    the first block's even plane lies outside the view), Cin and Cout ragged
    for the tiles, with and without the fused prologue's act′; the stride-2
    VJP's tolerance (tests/test_pallas_conv_s2.py: 1e-4 relative, 1e-3
    absolute)."""
    B, cin, cout, H, W, dext = 1, 12, 20, 4, 256, 7
    vlo, vhi = 1, dext
    d_out = (dext - 1) // 2
    rng = np.random.default_rng(28)
    x = rng.standard_normal((B, cin, dext, H, W)).astype(np.float32)
    w = (rng.uniform(-1, 1, (cout, cin, 3, 3, 3)) / np.sqrt(27 * cin)).astype(np.float32)
    bias = np.zeros(cout, np.float32)
    ho, wo = H // 2, W // 2
    g = rng.standard_normal((B, cout, d_out * ho * wo)).astype(np.float32)
    meta = (dext, H, W, False) + (() if act is None else (act,))
    _, vjp = jax.vjp(lambda xv: jax_chain_s2(meta, xv, jnp.asarray([vlo, vhi], jnp.int32),
                                             jnp.asarray(w), jnp.asarray(bias)),
                     jnp.asarray(x.reshape(B, cin, -1)))
    want = np.asarray(vjp(jnp.asarray(g))[0]).reshape(B, cin, dext, H, W)[:, :, vlo:vhi]
    xt = torch.from_numpy(x).narrow(2, vlo, vhi - vlo)
    got, writes = _dgrad_tc_emulated(torch.from_numpy(g).reshape(B, cout, d_out, ho, wo),
                                     torch.from_numpy(w), xt, vlo, act)
    assert bool((writes == 1).all())
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-3)
