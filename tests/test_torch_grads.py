"""Gradients of the PyTorch port's kernel modules against the JAX package, on
the CPU, plus the train-mode layers (BatchNorm statistics, dropout) and the
flax-GroupNorm sites.

The same numpy inputs go through the JAX function and the port. Where the JAX
function is a Pallas kernel it runs in interpret mode, as the JAX package's
own tests run it on the CPU; the port's wrappers run their plain versions
on CPU tensors."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hybrid_vit_cascade_tpu.models.encoders import MultiScaleXrayEncoder as JaxEncoder
from hybrid_vit_cascade_tpu.models.layers import group_norm as jax_flax_group_norm
from hybrid_vit_cascade_tpu.ops.conv3d import group_norm_core as jax_group_norm
from hybrid_vit_cascade_tpu.ops.pallas.conv3d_k3 import conv3d_k3s1_flat
from hybrid_vit_cascade_tpu.ops.pallas.conv3d_k3s2 import conv3d_k3s2_flat
from hybrid_vit_cascade_tpu.ops.pallas.flash_attention import flash_attention as jax_flash
from hybrid_vit_cascade_tpu_torch import convert
from hybrid_vit_cascade_tpu_torch.models.encoders import MultiScaleXrayEncoder
from hybrid_vit_cascade_tpu_torch.models.layers import Dropout
from hybrid_vit_cascade_tpu_torch.models.vit3d import HybridViT3D
from hybrid_vit_cascade_tpu_torch.ops.attention import dot_product_attention
from hybrid_vit_cascade_tpu_torch.ops.conv3d import conv3d_ncdhw, group_norm_core
from tests.test_torch_models import jax_variables
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

# VJP tolerances of the JAX kernels' own tests: tests/test_flash_attention.py:52
# (gradients 5e-4) and tests/test_pallas_conv.py / test_pallas_conv_s2.py
# (VJP rtol 1e-4, atol 1e-3).
ATTN_TOL = dict(rtol=5e-4, atol=5e-4)
CONV_TOL = dict(rtol=1e-4, atol=1e-3)


def _f32(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _leaf(a):
    return torch.from_numpy(a).requires_grad_()


@pytest.mark.parametrize("nq,nk,d", [(96, 80, 32), (72, 90, 64), (64, 130, 32)])
def test_attention_grads_match_jax_kernel(rng, nq, nk, d):
    """dq, dk, dv of the port's attention Function (kernel D's plain version)
    against jax.vjp of the Pallas flash attention (fused backward)."""
    q, k, v = (_f32(rng, (1, 2, n, d)) for n in (nq, nk, nk))
    ct = _f32(rng, (1, 2, nq, d))
    scale = d ** -0.5
    out, vjp = jax.vjp(lambda a, b, c: jax_flash(a, b, c, scale, block_q=32, block_kv=32),
                       *(jnp.asarray(a) for a in (q, k, v)))
    want = vjp(jnp.asarray(ct))
    tq, tk, tv = (_leaf(a) for a in (q, k, v))
    got = dot_product_attention(tq, tk, tv, scale)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out), rtol=2e-5, atol=2e-5)
    got.backward(torch.from_numpy(ct))
    for t, w, name in zip((tq, tk, tv), want, "qkv"):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), **ATTN_TOL, err_msg=f"d{name}")


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("b,cin,cout,d,h,w", [(1, 4, 8, 4, 4, 256), (1, 1, 8, 2, 4, 256),
                                              (2, 8, 4, 2, 4, 256)])
def test_conv_grads_match_jax_kernel(rng, stride, b, cin, cout, d, h, w):
    """dx, dW and db of the port's conv Function (kernels B-as-dgrad / F, E / G
    in their plain versions) against the VJP of the Pallas flat convs. The JAX
    flat convs are VALID in D over D+2 (s1) or 2D'+1 (s2) planes, so x is
    zero-padded in D by (1, 1) or (1, 0) on the JAX side."""
    x = _f32(rng, (b, cin, d, h, w))
    wt = _f32(rng, (cout, cin, 3, 3, 3), 0.1)
    bias = _f32(rng, (cout,))
    od, oh, ow = d // stride, h // stride, w // stride
    ct = _f32(rng, (b, cout, od, oh, ow))
    front, back = (1, 1) if stride == 1 else (1, 0)
    xp = np.pad(x, ((0, 0), (0, 0), (front, back), (0, 0), (0, 0)))
    dims = (xp.shape[2], h, w)
    flat = conv3d_k3s1_flat if stride == 1 else conv3d_k3s2_flat
    out, vjp = jax.vjp(lambda a, k, c: flat(dims, a, k, c),
                       jnp.asarray(xp.reshape(b, cin, -1)), jnp.asarray(wt), jnp.asarray(bias))
    jdx, jdw, jdb = vjp(jnp.asarray(ct.reshape(b, cout, -1)))
    jdx = np.asarray(jdx).reshape(xp.shape)[:, :, front:front + d]

    tx, tw, tb = _leaf(x), _leaf(wt), _leaf(bias)
    got = conv3d_ncdhw(tx, tw, tb, stride)
    np.testing.assert_allclose(got.detach().numpy().reshape(b, cout, -1), np.asarray(out),
                               rtol=1e-5, atol=1e-4)
    got.backward(torch.from_numpy(ct))
    np.testing.assert_allclose(tx.grad.numpy(), jdx, **CONV_TOL, err_msg="dx")
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jdw), **CONV_TOL, err_msg="dW")
    np.testing.assert_allclose(tb.grad.numpy(), np.asarray(jdb), **CONV_TOL, err_msg="db")


def test_conv_grads_only_where_needed(rng):
    """No data gradient for an input that needs none (XLA prunes it in JAX)."""
    import hybrid_vit_cascade_tpu_torch.ops.conv3d as c3

    calls = []
    orig = c3.conv3d_k3_dgrad
    try:
        c3.conv3d_k3_dgrad = lambda *a, **k: calls.append(1) or orig(*a, **k)
        x = torch.from_numpy(_f32(rng, (1, 2, 4, 4, 4)))
        w = _leaf(_f32(rng, (3, 2, 3, 3, 3)))
        conv3d_ncdhw(x, w, None, 2).sum().backward()
        assert w.grad is not None and calls == []
        xg = x.clone().requires_grad_()
        conv3d_ncdhw(xg, w.detach(), None, 2).sum().backward()
        assert xg.grad is not None and calls == [1]
    finally:
        c3.conv3d_k3_dgrad = orig


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,groups", [((2, 16, 4, 5, 6), 4), ((1, 32, 3, 4, 5), 8)])
def test_group_norm_core_vjp_matches_jax(rng, dtype, shape, groups):
    """The hand-written GroupNorm VJP against jax.vjp of the JAX custom VJP.
    bf16: both keep full tensors in bf16 and round at other places (XLA's CPU
    backend fuses bf16 elementwise chains in fp32), so a few bf16 ulps."""
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == "float32" else dict(rtol=3e-2, atol=3e-2)
    x = _f32(rng, shape, 2.0) + 0.5
    scale = _f32(rng, shape[1:2]) + 1.0
    bias = _f32(rng, shape[1:2])
    ct = _f32(rng, shape)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    out, vjp = jax.vjp(lambda a, s, c: jax_group_norm(a, s, c, groups),
                       jnp.asarray(x).astype(jdt), jnp.asarray(scale), jnp.asarray(bias))
    jdx, jds, jdb = vjp(jnp.asarray(ct).astype(jdt))
    tx = torch.from_numpy(x).to(tdt).requires_grad_()
    ts, tb = _leaf(scale), _leaf(bias)
    got = group_norm_core(tx, ts, tb, groups)
    assert got.dtype == tdt
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(out, np.float32), **tol)
    got.backward(torch.from_numpy(ct).to(tdt))
    assert tx.grad.dtype == tdt and ts.grad.dtype == torch.float32
    np.testing.assert_allclose(tx.grad.float().numpy(), np.asarray(jdx, np.float32), **tol)
    np.testing.assert_allclose(ts.grad.numpy(), np.asarray(jds), rtol=1e-4, atol=5e-3)
    np.testing.assert_allclose(tb.grad.numpy(), np.asarray(jdb), rtol=1e-4, atol=5e-3)


@pytest.mark.parametrize("site", ["encoder_down", "stage1_stem"])
def test_flax_group_norm_sites_bf16(rng, site):
    """At bf16, the GroupNorms at the JAX package's flax nn.GroupNorm sites
    (the encoders' down blocks, the stage-1 channels-last token stem) match
    flax: fp32 statistics, normalisation and affine, one rounding to bf16 —
    within one bf16 ulp (rtol 2^-7) of flax's result."""
    if site == "encoder_down":
        enc = MultiScaleXrayEncoder(64, stages=(1,), dtype=torch.bfloat16)
        norm, groups, shape = enc.down["to_stage1_a"].norm, 32, (2, 64, 6, 7)
    else:
        vit = HybridViT3D((32, 32, 32), 1, 32, 1, 4, context_dim=32, dtype=torch.bfloat16,
                          layout="NDHWC")
        norm, groups, shape = vit.stem_norms[0], 8, (2, 8, 4, 4, 4)
    C = shape[1]
    x = (3.0 + _f32(rng, shape)).astype(np.float32)
    scale = 1.0 + _f32(rng, (C,), 0.1)
    bias = _f32(rng, (C,), 0.1)
    xb = jnp.asarray(np.moveaxis(x, 1, -1)).astype(jnp.bfloat16)  # channels-last, as in JAX
    want = jax_flax_group_norm(groups, dtype=jnp.bfloat16).apply(
        {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}}, xb)
    want = np.moveaxis(np.asarray(want, np.float32), -1, 1)
    with torch.no_grad():
        norm.weight.copy_(torch.from_numpy(scale))
        norm.bias.copy_(torch.from_numpy(bias))
        got = norm(torch.from_numpy(x).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2.0 ** -7, atol=1e-6)


def test_encoder_batchnorm_train_mode_matches_flax(rng):
    """Train-mode BatchNorm: batch statistics in the forward and the running
    statistics flax writes under mutable=['batch_stats'] (momentum 0.9,
    biased variance), for the shared encoder called at stage 2 then stage 3."""
    E = 32
    xr = rng.standard_normal((2, 2, 1, 64, 64)).astype(np.float32)
    jm = JaxEncoder(base_dim=E, num_views=2)
    tree, jv = jax_variables(jm, rng, jnp.asarray(xr), stage=2)
    tm = MultiScaleXrayEncoder(E, stages=(2, 3))
    tm.load_state_dict(convert.multiscale_encoder(tree["params"], tree["batch_stats"]), strict=True)
    variables = jv
    for stage in (2, 3):
        want, upd = jm.apply(variables, jnp.asarray(xr), stage=stage, train=True,
                             mutable=["batch_stats"])
        variables = {"params": jv["params"], "batch_stats": upd["batch_stats"]}
        with torch.no_grad():
            got = tm(torch.from_numpy(xr), stage=stage, train=True)
        np.testing.assert_allclose(got[0].numpy(), np.moveaxis(np.asarray(want[0]), -1, 1),
                                   rtol=1e-4, atol=1e-4)
    stats = jax.tree.map(np.asarray, variables["batch_stats"])
    want_sd = convert.multiscale_encoder(tree["params"], stats)
    got_sd = tm.state_dict()
    for name in want_sd:
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(got_sd[name].numpy(), want_sd[name].numpy(),
                                       rtol=1e-5, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dropout_rate_and_scaling(dtype):
    """p = 0 and no seed are the identity; at p = 0.1 about a tenth of the
    elements are zeroed and the rest scaled by 1/(1 − p) (in x's dtype, as
    the JAX FastDropout divides by keep_prob cast to x's dtype); a seed and a
    site give one mask, another site another."""
    x = torch.rand(400, 500, dtype=torch.float32).add_(0.5).to(dtype)
    assert torch.equal(Dropout(0.0)(x, seed=3), x)
    assert torch.equal(Dropout(0.1)(x, seed=None), x)
    drop = Dropout(0.1)
    y = drop(x, seed=3)
    zero = y == 0
    assert abs(zero.float().mean().item() - 0.1) < 0.005
    assert torch.equal(y[~zero], (x / torch.tensor(0.9, dtype=dtype))[~zero])
    assert torch.equal(drop(x, seed=3), y)
    other = Dropout(0.1)
    other.site = 1
    assert not torch.equal(other(x, seed=3) == 0, zero)
