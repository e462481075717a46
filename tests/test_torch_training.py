"""The port's staged training step against the JAX package, on the CPU.

- The optimizer: three updates from identical gradients give the optax
  chain's parameters (rtol 1e-5, atol 1e-6); a frozen subtree is left
  bitwise unchanged.
- The whole step of each stage on the scaled cascade of
  tests/test_torch_cascade.py (8³→16³→32³, 64² X-rays, E=32, 4 heads, one
  block per stage, fp32): loss and the gradient of every trainable parameter
  (clipped in place by the step) against ``jax.value_and_grad`` of
  MultiScaleLoss ∘ model.apply(train=False, stop_grad_stage1=stage ≥ 2),
  clipped to the same global norm. Dropout bits cannot match across frameworks,
  so the parity is taken with the deterministic forward; train-mode
  BatchNorm and dropout are held separately (tests/test_torch_grads.py) and,
  here, dropout under activation checkpointing. Tolerances: loss 2e-4,
  gradients rtol 1e-3 / atol 5e-5 (tests/test_training.py:506).
"""

import weakref

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn as nn

from hybrid_vit_cascade_tpu.losses import MultiScaleLoss as JaxLoss
from hybrid_vit_cascade_tpu.losses import TriPlanarPerceptualLoss as JaxPerceptual
from hybrid_vit_cascade_tpu.models import ProgressiveCascadeModel as JaxCascade
from hybrid_vit_cascade_tpu.training import make_optimizer as jax_make_optimizer
from hybrid_vit_cascade_tpu.training.trainer import make_eval_step as jax_make_eval_step
from hybrid_vit_cascade_tpu.training.trainer import resize_target as jax_resize_target
from hybrid_vit_cascade_tpu_torch import convert
from hybrid_vit_cascade_tpu_torch.config import Config
from hybrid_vit_cascade_tpu_torch.inference.infer import build_model
from hybrid_vit_cascade_tpu_torch.losses.multiscale import MultiScaleLoss, TriPlanarPerceptualLoss
from hybrid_vit_cascade_tpu_torch.training.measure import train_steps
from hybrid_vit_cascade_tpu_torch.training.schedules import (
    apply_stage_freeze,
    cosine_schedule,
    make_optimizer,
    stage_freeze_labels,
)
from hybrid_vit_cascade_tpu_torch.training.trainer import (
    make_eval_step,
    resize_target,
    stage_step,
)
from tests.test_torch_models import jax_variables
from tests.test_torch_slab import force_streaming
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

S1, S2, S3 = 8, 16, 32
XR, E, HEADS = 64, 32, 4
LOSS_TOL = dict(rtol=2e-4, atol=2e-4)
GRAD_TOL = dict(rtol=1e-3, atol=5e-5)


# --------------------------------------------------------------- optimizer ---

_SHAPES = {"stage1": {"w": (4, 3)}, "stage2": {"w": (5,), "b": (2, 2)},
           "xray_encoder": {"k": (3, 3)}}


class _Tree(nn.Module):
    """Top-level submodules named like the cascade's param subtrees."""

    def __init__(self, tree):
        super().__init__()
        for top, leaves in tree.items():
            self.add_module(top, nn.ParameterDict(
                {k: nn.Parameter(torch.from_numpy(v.copy())) for k, v in leaves.items()}))


@pytest.mark.parametrize("warmup", [0, 2])
def test_optimizer_matches_optax(rng, warmup):
    params = {top: {k: rng.standard_normal(s).astype(np.float32) for k, s in leaves.items()}
              for top, leaves in _SHAPES.items()}
    # the first gradient's global norm is far above the clip, the others below
    grads = [{top: {k: (rng.standard_normal(s) * sc).astype(np.float32)
                    for k, s in leaves.items()} for top, leaves in _SHAPES.items()}
             for sc in (5.0, 0.05, 0.2)]
    trainable = ["stage2", "xray_encoder"]
    kw = dict(weight_decay=0.01, gradient_clip=1.0, warmup_steps=warmup)
    tx = jax_make_optimizer(1e-2, 10, trainable_prefixes=trainable, params=params, **kw)
    jp = jax.tree.map(jnp.asarray, params)
    opt_state = tx.init(jp)
    for g in grads:
        updates, opt_state = tx.update(jax.tree.map(jnp.asarray, g), opt_state, jp)
        jp = optax.apply_updates(jp, updates)

    model = _Tree(params)
    opt = make_optimizer(apply_stage_freeze(model, trainable), 1e-2, 10, **kw)
    for g in grads:
        for top, leaves in g.items():
            for k, v in leaves.items():
                p = getattr(model, top)[k]
                if p.requires_grad:
                    p.grad = torch.from_numpy(v)
        opt.step()
    for top, leaves in params.items():
        for k, v in leaves.items():
            got = getattr(model, top)[k].detach().numpy()
            if top in trainable:
                np.testing.assert_allclose(got, np.asarray(jp[top][k]), rtol=1e-5, atol=1e-6,
                                           err_msg=f"{top}.{k}")
            else:
                assert np.array_equal(got, v), f"{top}.{k} moved while frozen"


def test_optimizer_is_freed_without_gc():
    """Dropping the optimizer frees it (and its Adam moments) at once: its
    hooks hold no reference cycle back to it."""
    p = nn.Parameter(torch.ones(4))
    opt = make_optimizer([p], 1e-2, 10)
    p.grad = torch.ones(4)
    opt.step()
    ref = weakref.ref(opt)
    del opt
    assert ref() is None


@pytest.mark.parametrize("warmup", [0, 3])
def test_schedule_matches_optax(warmup):
    if warmup:
        want = optax.warmup_cosine_decay_schedule(0.0, 2e-4, warmup, 20)
    else:
        want = optax.cosine_decay_schedule(2e-4, 20)
    got = cosine_schedule(2e-4, 20, warmup)
    assert got(0) == (0.0 if warmup else 2e-4)  # the first step takes the peak without warmup
    for t in range(0, 25):
        np.testing.assert_allclose(got(t), float(want(t)), rtol=1e-6, atol=1e-12)


# ------------------------------------------------------------- train step ---

def _config() -> Config:
    cfg = Config.from_json("configs/progressive_cascade.json")
    m = cfg.model
    m.voxel_dim, m.xray_feature_dim, m.dtype = E, E, "float32"
    m.stage_depths, m.stage_heads, m.stage_sizes = (1, 1, 1), (HEADS,) * 3, (S1, S2, S3)
    for n, s in zip((1, 2, 3), (S1, S2, S3)):
        cfg.training.stages[f"stage{n}"].target_resolution = (s, s, s)
    cfg.data.xray_size = XR
    return cfg


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(11)
    jm = JaxCascade(stage_sizes=(S1, S2, S3), voxel_dim=E, stage_depths=(1, 1, 1),
                    stage_heads=(HEADS,) * 3, xray_feature_dim=E, attn_impl="xla")
    tree, jv = jax_variables(jm, rng, jnp.zeros((1, 2, 1, XR, XR)), max_stage=3)
    batch = {"drr_stacked": (0.5 * rng.standard_normal((2, 2, 1, XR, XR))).astype(np.float32),
             "ct_volume": rng.uniform(-1, 1, (2, 1, S3, S3, S3)).astype(np.float32)}
    jvgg = JaxPerceptual()
    vgg = convert.vgg16(jax.tree.map(np.asarray, jvgg._vars))
    return jm, tree, jv, batch, jvgg, vgg


def _port_model(tree, **kw):
    cfg = _config()
    for k, v in kw.items():
        setattr(cfg.model, k, v)
    model = build_model(cfg)
    model.load_state_dict(convert.cascade(tree), strict=True)
    return cfg, model


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("stage,slab_count", [(1, None), (2, None), (3, None), (3, 4)],
                         ids=["1", "2", "3", "3-slab4"])
def test_train_step_matches_jax(setup, monkeypatch, stage, slab_count):
    """slab_count: stage 3 with stage3_slab_scan on and that many slabs on
    both sides, the eval schedule pinned to the training flags ('train'), so
    the deterministic step streams its chains as a train=True step would
    (every level streamed: no dense tail at this size, see force_streaming)."""
    jm, tree, jv, batch, jvgg, vgg = setup
    if slab_count is not None:
        force_streaming(monkeypatch)
        jm = jm.clone(stage3_slab_scan=True, slab_count=slab_count, stage3_eval_schedule="train")
    res = (S1, S2, S3)[stage - 1]
    jobj = JaxLoss(perceptual=jvgg)
    xr = jnp.asarray(batch["drr_stacked"])

    def jax_loss(params):
        pred = jm.apply({"params": params, "batch_stats": jv["batch_stats"]}, xr,
                        max_stage=stage, train=False, stop_grad_stage1=stage >= 2)
        target = jax_resize_target(jnp.asarray(batch["ct_volume"]), (res,) * 3)
        ld = jobj(pred, target, stage=stage, input_xrays=xr if stage == 3 else None)
        return ld["total_loss"], ld

    (_, jld), jgrads = jax.value_and_grad(jax_loss, has_aux=True)(jv["params"])
    want_grads = convert.cascade({"params": jax.tree.map(np.asarray, jgrads),
                                  "batch_stats": tree["batch_stats"]})

    cfg, model = _port_model(tree)
    if slab_count is not None:
        cfg, model = _port_model(tree, stage3_slab_scan=True, slab_count=slab_count)
        model.stage3.eval_schedule = "train"
        assert model.stage3._schedule(False) == (True, slab_count, "streamed", None)
    state, step = stage_step(model, cfg, stage,
                             MultiScaleLoss(perceptual=TriPlanarPerceptualLoss(weights=vgg)),
                             train=False)
    frozen = {n: p.detach().clone() for n, p in model.named_parameters() if not p.requires_grad}
    trainable_tops = {n.split(".", 1)[0] for n, p in model.named_parameters() if p.requires_grad}
    assert trainable_tops == ({"stage1"} if stage == 1 else {f"stage{stage}", "xray_encoder"})
    state, metrics = step(state, _torch_batch(batch), None)

    assert state.step == 1 and sorted(metrics) == sorted(jld)
    for k in jld:
        np.testing.assert_allclose(metrics[k].numpy(), np.asarray(jld[k]), **LOSS_TOL, err_msg=k)
    # the step leaves the gradients clipped in place to the global norm of
    # the trainable ones (torch's clip_grad_norm_: clip / (norm + 1e-6))
    norm = float(torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(want_grads[n]) for n, _ in model.named_parameters()
         if n not in frozen])))
    scale = min(1.0, cfg.training.gradient_clip / (norm + 1e-6))
    n_checked = 0
    for name, p in model.named_parameters():
        if name in frozen:
            assert p.grad is None and torch.equal(p.detach(), frozen[name]), name
            continue
        np.testing.assert_allclose(p.grad.numpy(), want_grads[name].numpy() * scale,
                                   **GRAD_TOL, err_msg=name)
        n_checked += 1
    assert n_checked == sum(p.requires_grad for p in model.parameters()) > 0


def test_stage1_steps_track_jax(setup):
    """Three deterministic stage-1 steps (forward, backward, update) give the
    loss sequence of JAX's value_and_grad + the optax chain on the same
    weights: the optimizer state carries over as optax's does."""
    jm, tree, jv, batch, jvgg, vgg = setup
    jobj = JaxLoss(perceptual=jvgg)
    xr, ct = jnp.asarray(batch["drr_stacked"]), jnp.asarray(batch["ct_volume"])

    def jax_loss(params):
        pred = jm.apply({"params": params, "batch_stats": jv["batch_stats"]}, xr, max_stage=1,
                        train=False)
        return jobj(pred, jax_resize_target(ct, (S1,) * 3), stage=1)["total_loss"]

    tx = jax_make_optimizer(1e-4, 50, 0.01, 1.0, trainable_prefixes=["stage1"],
                            params=jv["params"])
    params, want = jv["params"], []
    opt_state = tx.init(params)
    for _ in range(3):
        value, grads = jax.value_and_grad(jax_loss)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        want.append(float(value))

    cfg, model = _port_model(tree)
    state, step = stage_step(model, cfg, 1,
                             MultiScaleLoss(perceptual=TriPlanarPerceptualLoss(weights=vgg)),
                             steps_per_epoch=1, train=False)
    got = []
    for _ in range(3):
        state, metrics = step(state, _torch_batch(batch), None)
        got.append(float(metrics["total_loss"]))
    np.testing.assert_allclose(got, want, **LOSS_TOL)
    assert got[2] < got[0]


def test_eval_step_matches_jax(setup):
    jm, tree, jv, batch, _, _ = setup
    target_fn = lambda b: jax_resize_target(b["ct_volume"], (S2,) * 3)  # noqa: E731
    jstep = jax_make_eval_step(jm, target_fn, {"max_stage": 2})
    want = jstep(jv["params"], jv["batch_stats"], jax.tree.map(jnp.asarray, batch))
    _, model = _port_model(tree)
    step = make_eval_step(model, lambda b: resize_target(b["ct_volume"], (S2,) * 3),
                          {"max_stage": 2})
    got = step(_torch_batch(batch))
    assert sorted(got) == sorted(want) == ["loss", "psnr", "ssim"]
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), **LOSS_TOL, err_msg=k)


def test_stage_freeze_labels_follow_top_level_names(setup):
    _, tree, _, _, _, _ = setup
    _, model = _port_model(tree)
    labels = stage_freeze_labels(model, ["stage2", "xray_encoder"])
    for name, lab in labels.items():
        top = name.split(".", 1)[0]
        assert lab == ("train" if top in ("stage2", "xray_encoder") else "freeze"), name


def _stage3_grads(tree, batch, seed, **model_kw):
    """Gradients of one train-mode stage-3 step (dropout on, seeded)."""
    cfg, model = _port_model(tree, **model_kw)
    state, step = stage_step(model, cfg, 3)
    step(state, _torch_batch(batch), torch.Generator().manual_seed(seed))
    return {n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None}


def test_remat_replays_dropout(setup):
    """Activation checkpointing in both remat modes gives the gradients of the
    run without it: the recomputed forward draws the same dropout masks."""
    _, tree, _, batch, _, _ = setup
    plain = _stage3_grads(tree, batch, 5, use_gradient_checkpointing=False)
    for mode in ("block", "mlp"):
        got = _stage3_grads(tree, batch, 5, use_gradient_checkpointing=True, remat_mode=mode)
        assert sorted(got) == sorted(plain)
        for name in plain:
            torch.testing.assert_close(got[name], plain[name], rtol=1e-5, atol=1e-7, msg=name)
    other = _stage3_grads(tree, batch, 6, use_gradient_checkpointing=False)
    assert any(not torch.allclose(other[n], plain[n]) for n in plain)  # dropout is on


def test_train_mode_needs_a_generator(setup):
    _, tree, _, batch, _, _ = setup
    _, model = _port_model(tree)
    with pytest.raises(ValueError, match="Generator"):
        model(torch.from_numpy(batch["drr_stacked"]), max_stage=1, train=True)


def test_measure_train_steps_runs_on_cpu(setup):
    """The measuring loop of the full-width runs, at the scaled config on the
    CPU: finite losses, one time per timed step, no kernel launched (plain
    versions), and a profile that finds no device kernel."""
    _, tree, _, _, _, vgg = setup
    cfg, model = _port_model(tree)
    res = train_steps(model, cfg, 2, 1, 2, torch.Generator().manual_seed(0),
                      loss_obj=MultiScaleLoss(perceptual=TriPlanarPerceptualLoss(weights=vgg)),
                      profile=True)
    assert len(res["total_loss"]) == 3 and np.isfinite(res["total_loss"]).all()
    assert len(res["step_ms"]) == 2 and res["steps_per_sec"] > 0
    assert set(res["launches_per_step"].values()) == {0}
    assert res["profile"]["kernel_ms"] == 0 and res["profile"]["idle_share"] == 1.0
    assert "peak_allocated_gb" not in res
