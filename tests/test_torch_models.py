"""Modules of the PyTorch port against the JAX package, with converted weights.

JAX variables are built with ``jax.eval_shape`` of ``init`` and filled from a
numpy seed (no ``model.init`` run); ``hybrid_vit_cascade_tpu_torch.convert``
turns them into the port's state_dict. fp32 on the CPU; the tolerance is
1e-4 (different summation orders through a block's products and norms)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hybrid_vit_cascade_tpu.models.encoders import MultiScaleXrayEncoder as JaxEncoder
from hybrid_vit_cascade_tpu.models.vit3d import HybridViT3D as JaxViT
from hybrid_vit_cascade_tpu.models.vit3d import HybridViTBlock3D as JaxBlock
from hybrid_vit_cascade_tpu.ops.slab import chain_apply_dense as jax_chain
from hybrid_vit_cascade_tpu_torch import convert
from hybrid_vit_cascade_tpu_torch.models.encoders import MultiScaleXrayEncoder
from hybrid_vit_cascade_tpu_torch.models.vit3d import HybridViT3D, HybridViTBlock3D
from hybrid_vit_cascade_tpu_torch.ops.chain import chain_apply_dense

TOL = dict(rtol=1e-4, atol=1e-4)


def _key(k) -> str:
    return str(getattr(k, "key", k))


def random_variables(template, rng):
    """A numpy variables tree shaped like a jax.eval_shape template: weights
    U(±1/√fan_in), norm scales near 1, BatchNorm variances in [1, 1.3], every
    other leaf small and non-zero (AdaLN weights included, so the gated
    paths count)."""

    def leaf(path, s):
        keys = [_key(k) for k in path]
        name, parent = keys[-1], keys[-2] if len(keys) > 1 else ""
        shape = s.shape
        if name == "var":
            a = 1.0 + 0.3 * rng.random(shape)
        elif name == "scale" or name.endswith("_scale"):
            a = 1.0 + 0.1 * rng.standard_normal(shape)
        elif name in ("residual_weight", "detail_weight"):
            a = 0.3 + 0.4 * rng.random(shape)
        elif name == "pos_embed":
            a = 0.02 * rng.standard_normal(shape)
        elif name == "initial_volume":
            a = rng.standard_normal(shape)
        elif name == "kernel" or name.endswith("_kernel"):
            oidhw = name.endswith("_kernel") or parent.startswith("ConvNCDHW")
            fan_in = np.prod(shape[1:]) if oidhw else np.prod(shape[:-1])
            a = rng.uniform(-1.0, 1.0, shape) / np.sqrt(fan_in)
        else:
            a = 0.1 * rng.standard_normal(shape)
        return np.asarray(a, np.float32)

    return jax.tree_util.tree_map_with_path(leaf, template)


def jax_variables(module, rng, *args, **kwargs):
    """(numpy tree, jnp tree) for module.init(key, *args, **kwargs)."""
    template = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args, **kwargs))
    tree = random_variables(template, rng)
    return tree, jax.tree.map(jnp.asarray, tree)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _ndhwc_to_ncdhw(a):
    return np.moveaxis(np.asarray(a), -1, 1)


def test_vit_block_matches_jax(rng):
    E, H, C = 32, 4, 24
    x = rng.standard_normal((2, 40, E)).astype(np.float32)
    ctx = rng.standard_normal((2, 12, C)).astype(np.float32)
    cond = rng.standard_normal((2, 1024)).astype(np.float32)
    jm = JaxBlock(voxel_dim=E, num_heads=H, context_dim=C, attn_impl="xla")
    tree, jv = jax_variables(jm, rng, jnp.asarray(x), jnp.asarray(ctx), jnp.asarray(cond))
    want = np.asarray(jm.apply(jv, jnp.asarray(x), jnp.asarray(ctx), jnp.asarray(cond)))
    tm = HybridViTBlock3D(E, H, context_dim=C)
    tm.load_state_dict(convert.vit_block(tree["params"]), strict=True)
    with torch.no_grad():
        got = tm(_t(x), _t(ctx), _t(cond)).numpy()
    assert np.abs(want - x).max() > 1e-2  # the block is not the identity
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("layout,in_ch,external", [("NCDHW", 4, False), ("NDHWC", 1, False),
                                                   ("NCDHW", 32, True)])
def test_vit3d_matches_jax(rng, layout, in_ch, external):
    E, H, C, S = 32, 4, 32, 32
    vol = (S, S, S)
    if external:  # stage-3 form: the caller ran the stem; 16³ tokens
        x = rng.standard_normal((1, E, 16, 16, 16)).astype(np.float32)
    else:
        x = rng.standard_normal((1, in_ch, *vol)).astype(np.float32)
    ctx = rng.standard_normal((1, 16, C)).astype(np.float32)
    cond = rng.standard_normal((1, 1024)).astype(np.float32)
    jm = JaxViT(volume_size=vol, in_channels=in_ch, voxel_dim=E, depth=1, num_heads=H,
                context_dim=C, attn_impl="xla", layout=layout, external_stem=external)
    jx = jnp.asarray(x if layout == "NCDHW" else np.moveaxis(x, 1, -1))
    tree, jv = jax_variables(jm, rng, jx, jnp.asarray(ctx), jnp.asarray(cond))
    want = _ndhwc_to_ncdhw(jm.apply(jv, jx, jnp.asarray(ctx), jnp.asarray(cond)))
    tm = HybridViT3D(vol, in_ch, E, 1, H, context_dim=C, external_stem=external)
    tm.load_state_dict(convert.vit3d(tree["params"]), strict=True)
    with torch.no_grad():
        got = tm(_t(x), _t(ctx), _t(cond)).numpy()
    assert got.shape == want.shape == (1, 1, *vol)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("stage,init_stage", [(1, 1), (2, 2), (3, 2)])
def test_multiscale_encoder_matches_jax(rng, stage, init_stage):
    E = 32
    xr = rng.standard_normal((2, 2, 1, 64, 64)).astype(np.float32)
    jm = JaxEncoder(base_dim=E, num_views=2)
    tree, jv = jax_variables(jm, rng, jnp.asarray(xr), stage=init_stage)
    want = jm.apply(jv, jnp.asarray(xr), stage=stage)
    tm = MultiScaleXrayEncoder(E, stages=(1,) if init_stage == 1 else (2, 3))
    tm.load_state_dict(convert.multiscale_encoder(tree["params"], tree["batch_stats"]),
                       strict=True)
    with torch.no_grad():
        got = tm(_t(xr), stage=stage)
    feats = np.moveaxis(np.asarray(want[0]), -1, 1)  # NHWC → NCHW
    hw = 64 // 8 // {1: 4, 2: 2, 3: 1}[stage]  # encoder ÷8, then the stage's branch
    assert got[0].shape == feats.shape == (2, E, hw, hw)
    np.testing.assert_allclose(got[0].numpy(), feats, **TOL)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def _chain_arrays(rng, spec):
    """numpy chain from a spec of ("conv", out, in, k, stride) / ("gn", ch, groups) / ("act", name)."""
    chain = []
    for op in spec:
        if op[0] == "conv":
            _, o, i, k, s = op
            w = (rng.uniform(-1, 1, (o, i, k, k, k)) / np.sqrt(i * k ** 3)).astype(np.float32)
            chain.append(("conv", w, (0.1 * rng.standard_normal(o)).astype(np.float32), s))
        elif op[0] == "gn":
            _, ch, g = op
            chain.append(("gn", g, (1 + 0.1 * rng.standard_normal(ch)).astype(np.float32),
                          (0.1 * rng.standard_normal(ch)).astype(np.float32)))
        else:
            chain.append(op)
    return chain


@pytest.mark.parametrize("name", ["detail", "stem"])
def test_chain_matches_jax(rng, name):
    if name == "detail":  # DetailEnhancer's chain
        spec = [("conv", 64, 1, 3, 1), ("gn", 64, 16), ("act", "gelu"), ("conv", 32, 64, 3, 1),
                ("gn", 32, 8), ("act", "gelu"), ("conv", 1, 32, 1, 1)]
    else:  # Stage3ViTTrunk's upsample conv + token stem + projection
        spec = [("conv", 32, 1, 3, 1), ("gn", 32, 8), ("act", "gelu"), ("conv", 8, 32, 3, 2),
                ("gn", 8, 8), ("act", "silu"), ("conv", 32, 8, 3, 1)]
    chain = _chain_arrays(rng, spec)
    x = rng.standard_normal((1, 1, 12, 10, 16)).astype(np.float32)
    jchain = [tuple(jnp.asarray(p) if isinstance(p, np.ndarray) else p for p in op)
              for op in chain]
    tchain = [tuple(_t(p) if isinstance(p, np.ndarray) else p for p in op) for op in chain]
    want = np.asarray(jax_chain(jnp.asarray(x), jchain))
    got = chain_apply_dense(_t(x), tchain).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)
