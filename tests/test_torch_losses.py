"""The port's loss ops, losses and metrics against the JAX package, on the CPU:
values and gradients with respect to the prediction, from the same numpy
inputs. The perceptual loss uses the JAX loss's own seed-1234 VGG filters,
carried over by ``convert.vgg16``. fp32 throughout; tolerances are stated
per test (different summation orders, and FFTs of another library)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hybrid_vit_cascade_tpu.losses import metrics as jmetrics
from hybrid_vit_cascade_tpu.losses import multiscale as jloss
from hybrid_vit_cascade_tpu.losses.vgg_weights import save_vgg16_variables
from hybrid_vit_cascade_tpu.ops import drr as jdrr
from hybrid_vit_cascade_tpu.ops import pool as jpool
from hybrid_vit_cascade_tpu.ops import ssim as jssim
from hybrid_vit_cascade_tpu.ops.resize import resize_bilinear as jax_resize_bilinear
from hybrid_vit_cascade_tpu_torch import convert
from hybrid_vit_cascade_tpu_torch.losses import metrics
from hybrid_vit_cascade_tpu_torch.losses import multiscale as tloss
from hybrid_vit_cascade_tpu_torch.ops import drr, pool, ssim
from hybrid_vit_cascade_tpu_torch.ops.resize import resize_bilinear
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)


def _f32(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _close(got, want, rtol, atol_rel=1e-5):
    """|got − want| ≤ atol + rtol·|want| with atol = atol_rel·max|want| (so a
    mean-reduced loss's O(1/N) gradients are held at their own scale)."""
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol_rel * float(np.abs(want).max()) + 1e-12)


def _value_and_grad(jfn, tfn, pred, *rest):
    """(jax value, jax d/dpred, torch value, torch d/dpred) of a scalar loss."""
    jv, jg = jax.value_and_grad(lambda p: jfn(p, *(jnp.asarray(a) for a in rest)))(jnp.asarray(pred))
    tp = torch.from_numpy(pred).requires_grad_()
    tv = tfn(tp, *(torch.from_numpy(a) for a in rest))
    tv.backward()
    return np.asarray(jv), np.asarray(jg), tv.detach().numpy(), tp.grad.numpy()


@pytest.mark.parametrize("window,axes", [(11, (-3, -2, -1)), (3, (-3, -2, -1)), (5, (2, 3))])
def test_box_filter_same_matches_jax(rng, window, axes):
    x = _f32(rng, (2, 1, 9, 12, 13))
    want = jpool.box_filter_same(jnp.asarray(x), window, axes)
    _close(pool.box_filter_same(torch.from_numpy(x), window, axes).numpy(), want, 1e-5, 1e-6)


@pytest.mark.parametrize("window,stride,padding,axes", [(2, None, 0, (-3, -2, -1)),
                                                        (3, 1, 1, (-2, -1)), (3, 2, 1, (2,))])
def test_avg_pool_nd_matches_jax(rng, window, stride, padding, axes):
    x = _f32(rng, (2, 3, 8, 9, 10))
    want = jpool.avg_pool_nd(jnp.asarray(x), window, axes, stride=stride, padding=padding)
    got = pool.avg_pool_nd(torch.from_numpy(x), window, axes, stride=stride, padding=padding)
    _close(got.numpy(), want, 1e-5, 1e-6)


@pytest.mark.parametrize("shape", [(2, 1, 12, 12, 12), (1, 1, 8, 6, 10)])
def test_ssim3d_matches_jax(rng, shape):
    p, t = _f32(rng, shape, 0.5), _f32(rng, shape, 0.5)
    t = 0.7 * p + t  # correlated, so SSIM is far from 0
    _close(ssim.ssim3d_map(torch.from_numpy(p), torch.from_numpy(t)).numpy(),
           jssim.ssim3d_map(jnp.asarray(p), jnp.asarray(t)), 1e-4, 1e-5)
    jv, jg, tv, tg = _value_and_grad(jssim.ssim3d, ssim.ssim3d, p, t)
    _close(tv, jv, 1e-5)
    _close(tg, jg, 1e-4)


@pytest.mark.parametrize("out", [(64, 64), (20, 30), (5, 7)])
@pytest.mark.parametrize("align_corners", [False, True])
def test_resize_bilinear_matches_jax(rng, out, align_corners):
    x = _f32(rng, (2, 3, 16, 12))
    want = jax_resize_bilinear(jnp.asarray(x), out, align_corners=align_corners)
    got = resize_bilinear(torch.from_numpy(x), out, align_corners=align_corners)
    _close(got.numpy(), want, 1e-5, 1e-6)


@pytest.mark.parametrize("view", ["ap", "lateral"])
def test_drr_matches_jax(rng, view):
    v = _f32(rng, (2, 8, 10, 12), 0.5)
    _close(drr.drr_beer_lambert(torch.from_numpy(v), view).numpy(),
           jdrr.drr_beer_lambert(jnp.asarray(v), view), 1e-5, 1e-6)
    for size in (None, 32):
        _close(drr.drr_mean_projection(torch.from_numpy(v), view, size).numpy(),
               jdrr.drr_mean_projection(jnp.asarray(v), view, size), 1e-5, 1e-6)


@pytest.mark.parametrize("name", ["l1", "ssim", "tv", "tv_pred_only", "freq_even", "freq_odd"])
def test_volume_losses_match_jax(rng, name):
    """Each volume loss: value and gradient with respect to the prediction."""
    shape = (2, 1, 9, 10, 11) if name == "freq_odd" else (2, 1, 12, 12, 16)
    p, t = _f32(rng, shape, 0.5), _f32(rng, shape, 0.5)
    fns = {"l1": (jloss.l1_loss, tloss.l1_loss), "ssim": (jloss.ssim_loss, tloss.ssim_loss),
           "tv": (jloss.total_variation_loss, tloss.total_variation_loss),
           "freq_even": (jloss.frequency_loss, tloss.frequency_loss),
           "freq_odd": (jloss.frequency_loss, tloss.frequency_loss)}
    if name == "tv_pred_only":
        jv, jg, tv, tg = _value_and_grad(jloss.total_variation_loss, tloss.total_variation_loss, p)
    else:
        jv, jg, tv, tg = _value_and_grad(*fns[name], p, t)
    rtol = 1e-4 if name.startswith("freq") else 1e-5
    _close(tv, jv, rtol)
    _close(tg, jg, 1e-4, 1e-4)


def test_drr_reprojection_loss_matches_jax(rng):
    p = _f32(rng, (2, 1, 16, 16, 16), 0.5)
    xr = _f32(rng, (2, 2, 1, 32, 32), 0.5)
    jv, jg, tv, tg = _value_and_grad(
        lambda a, b: jloss.drr_reprojection_loss(a, b, img_size=32),
        lambda a, b: tloss.drr_reprojection_loss(a, b, img_size=32), p, xr)
    _close(tv, jv, 1e-5)
    _close(tg, jg, 1e-4, 1e-4)


@pytest.fixture(scope="module")
def vgg():
    """The JAX perceptual loss (seed-1234 filters) and the port's with the
    same filters."""
    jl = jloss.TriPlanarPerceptualLoss()
    tl = tloss.TriPlanarPerceptualLoss(weights=convert.vgg16(jax.tree.map(np.asarray, jl._vars)))
    return jl, tl


def test_perceptual_loss_matches_jax(rng, vgg):
    jl, tl = vgg
    p, t = _f32(rng, (2, 1, 16, 20, 24), 0.5), _f32(rng, (2, 1, 16, 20, 24), 0.5)
    jv, jg, tv, tg = _value_and_grad(jl, tl, p, t)
    _close(tv, jv, 1e-4)
    _close(tg, jg, 1e-3, 1e-4)


def test_vgg_npz_loads_without_jax(rng, vgg, tmp_path):
    """The .npz that the JAX package's save_vgg16_variables writes loads with
    numpy into the port's filters, and gives the same loss."""
    jl, tl = vgg
    path = str(tmp_path / "vgg.npz")
    save_vgg16_variables(jax.tree.map(np.asarray, jl._vars), path)
    loaded = tloss.load_vgg16_npz(path)
    for k, v in convert.vgg16(jax.tree.map(np.asarray, jl._vars)).items():
        torch.testing.assert_close(loaded[k], v, rtol=0, atol=0)
    p, t = (torch.from_numpy(_f32(rng, (1, 1, 8, 8, 8))) for _ in range(2))
    loss = tloss.MultiScaleLoss(vgg_weights=path)
    torch.testing.assert_close(loss.perceptual(p, t), tl(p, t))


def test_seeded_vgg_is_deterministic():
    a, b = tloss.seeded_vgg16(1234), tloss.seeded_vgg16(1234)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["Conv_0.weight"], tloss.seeded_vgg16(1)["Conv_0.weight"])
    assert tuple(a["Conv_6.weight"].shape) == (256, 256, 3, 3)


@pytest.mark.parametrize("stage", [1, 2, 3])
def test_multiscale_loss_matches_jax(rng, vgg, stage):
    """MultiScaleLoss per stage: every key of the loss dict and the gradient of
    the total with respect to the prediction."""
    jl_vgg, tl_vgg = vgg
    shape = (2, 1, 16, 16, 16)
    p, t = _f32(rng, shape, 0.5), _f32(rng, shape, 0.5)
    xr = _f32(rng, (2, 2, 1, 32, 32), 0.5)
    jobj = jloss.MultiScaleLoss(perceptual=jl_vgg)
    tobj = tloss.MultiScaleLoss(perceptual=tl_vgg)
    xin = xr if stage == 3 else None

    def jtotal(a):
        return jobj(a, jnp.asarray(t), stage=stage,
                    input_xrays=None if xin is None else jnp.asarray(xin))

    (jv, jd), jg = jax.value_and_grad(lambda a: (jtotal(a)["total_loss"], jtotal(a)),
                                      has_aux=True)(jnp.asarray(p))
    tp = torch.from_numpy(p).requires_grad_()
    td = tobj(tp, torch.from_numpy(t), stage=stage,
              input_xrays=None if xin is None else torch.from_numpy(xin))
    assert sorted(td) == sorted(jd)
    for k in jd:
        _close(td[k].detach().numpy(), jd[k], 1e-4)
    td["total_loss"].backward()
    _close(tp.grad.numpy(), jg, 1e-3, 1e-4)


def test_metrics_match_jax(rng):
    p, t = _f32(rng, (2, 1, 12, 12, 12), 0.5), _f32(rng, (2, 1, 12, 12, 12), 0.5)
    jp, jt, tp, tt = jnp.asarray(p), jnp.asarray(t), torch.from_numpy(p), torch.from_numpy(t)
    _close(metrics.psnr(tp, tt).numpy(), jmetrics.psnr(jp, jt), 1e-5)
    _close(metrics.ssim_metric(tp, tt).numpy(), jmetrics.ssim_metric(jp, jt), 1e-4)
    _close(metrics.mae(tp, tt).numpy(), jmetrics.mae(jp, jt), 1e-5)
