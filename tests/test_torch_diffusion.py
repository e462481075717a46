"""The port's diffusion family against the JAX package, with converted
weights: ``NoiseSchedule`` (tables within 1e-6, the identities exact on
JAX's tables, the DDIM timestep table equal), the depth lifter (dense and
streamed, forward 2e-5, gradients 5e-4 abs / 5e-3 rel: the bounds of
tests/test_models.py:215-257), ``UnifiedHybridViTCascade``'s losses (2e-4)
and gradients (‖port − JAX‖ ≤ 1e-3·‖JAX‖ a parameter, tighter than
tests/test_torch_direct.py's 1%) from JAX's
own t and noise, ``ddim_sample`` and ``cascaded_ddim_sample`` from JAX's x_T
(2e-4), ``convert.diffusion``, ``build_model`` at the three configs' full
widths by shape, ``Trainer.fit`` / ``fit_diffusion_cascade`` (the
counterparts of tests/test_training.py:373-450) and the engine's refusal.

Scaled ladder of tests/test_models.py:258-282: 16³ → 32³ volumes,
voxel_dim = xray_embed_dim = 32, 4 heads, one block a stage, 64² X-rays,
batch 1, T = 10, fp32 on the CPU; the JAX attention takes its XLA reference, not the
Pallas kernel in interpret mode. The JAX model's variables are drawn from numpy once
a module, its jitted functions shared across tests."""

import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hybrid_vit_cascade_tpu.config import Config as JaxConfig
from hybrid_vit_cascade_tpu.config import StageConfig as JaxStageConfig
from hybrid_vit_cascade_tpu.models import diffusion as jax_diffusion
from hybrid_vit_cascade_tpu.models.depth_lifting import CascadedDepthLifting as JaxLifting
from hybrid_vit_cascade_tpu.models.depth_lifting import (
    CascadedDepthWeightNetwork as JaxWeightNetwork,
)
from hybrid_vit_cascade_tpu.training import schedules as jax_schedules
from hybrid_vit_cascade_tpu.training import trainer as jax_trainer
from hybrid_vit_cascade_tpu_torch import cli, convert
from hybrid_vit_cascade_tpu_torch.config import Config, StageConfig
from hybrid_vit_cascade_tpu_torch.inference.infer import (
    DIFFUSION_NOT_SERVED,
    InferenceEngine,
    build_model,
    save_checkpoint,
)
from hybrid_vit_cascade_tpu_torch.models.depth_lifting import (
    CascadedDepthLifting,
    CascadedDepthWeightNetwork,
)
from hybrid_vit_cascade_tpu_torch.models.diffusion import (
    NoiseSchedule,
    UnifiedHybridViTCascade,
    cascaded_ddim_sample,
    ddim_timesteps,
)
from hybrid_vit_cascade_tpu_torch.ops.cuda import conv3d_k3 as ck
from hybrid_vit_cascade_tpu_torch.training.checkpoint import load_entry
from hybrid_vit_cascade_tpu_torch.training.measure import train_steps
from hybrid_vit_cascade_tpu_torch.training.trainer import (
    Trainer,
    diffusion_stage_configs,
    diffusion_state,
)
from tests import test_torch_bwd_plans as bwd_plans
from tests import test_torch_fwd_plans as fwd_plans
from tests.test_torch_models import jax_variables, random_variables
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

XR, E, HEADS, T = 64, 32, 4, 10
LADDER = (
    dict(name="s1", volume_size=(16, 16, 16), voxel_dim=E, vit_depth=1, num_heads=HEADS,
         use_depth_lifting=True, use_physics_loss=True),
    dict(name="s2", volume_size=(32, 32, 32), voxel_dim=E, vit_depth=1, num_heads=HEADS,
         use_depth_lifting=True, use_physics_loss=True),
)
TOL = dict(rtol=2e-4, atol=2e-4)
LIFT_TOL = dict(rtol=2e-5, atol=2e-5)
LIFT_GRAD_TOL = dict(rtol=5e-3, atol=5e-4)
# a gradient by the norm of its difference to JAX's against the norm of JAX's,
# as tests/test_torch_direct.py holds its updates (there 1%): its sums run
# over up to 2·32³ voxels, so an element near 0 carries the rounding of terms
# at the full scale
GRAD_RATIO = 1e-3


def _merge(a, b):
    if isinstance(a, dict) and isinstance(b, dict):
        return {k: _merge(a[k], b[k]) if k in a and k in b else (a[k] if k in a else b[k])
                for k in {**a, **b}}
    return a


def _port(tree, v_param: bool = True, lift_slabs: int = 0) -> UnifiedHybridViTCascade:
    model = UnifiedHybridViTCascade(LADDER, xray_embed_dim=E, num_timesteps=T,
                                    v_parameterization=v_param, lift_slabs=lift_slabs)
    model.load_state_dict(convert.diffusion(tree), strict=True)
    return model.eval()


def _jax_ladder(stages, seed: int, v_params=(True, False)) -> dict:
    """The scaled JAX ladder ``stages`` (each parameterisation of
    ``v_params``), its variables from numpy (each stage's init shape, merged
    as fit_diffusion_cascade merges them), inputs (every stage's x0, the
    X-rays, a previous volume at the second-to-last stage's size), and jitted
    loss / gradient functions."""
    rng = np.random.default_rng(seed)
    names = [c["name"] for c in stages]
    xr = rng.standard_normal((1, 2, 1, XR, XR)).astype(np.float32)
    x0 = {n: (0.3 * rng.standard_normal((1, 1, *c["volume_size"]))).astype(np.float32)
          for n, c in zip(names, stages)}
    prev = (0.3 * rng.standard_normal((1, 1, *stages[-2]["volume_size"]))).astype(np.float32)
    models = {v: jax_diffusion.UnifiedHybridViTCascade(
        stage_configs=stages, xray_embed_dim=E, num_timesteps=T, v_parameterization=v,
        attn_impl="xla") for v in v_params}
    jm = models[v_params[0]]
    k = jax.random.PRNGKey(0)
    shapes = [jax.eval_shape(lambda: jm.init(k, jnp.asarray(x0[names[0]]), jnp.asarray(xr),
                                             names[0], k))]
    for i in range(1, len(stages)):
        p_i = jnp.zeros((1, 1, *stages[i - 1]["volume_size"]))
        shapes.append(jax.eval_shape(lambda n=names[i], p=p_i: jm.init(
            k, jnp.asarray(x0[n]), jnp.asarray(xr), n, k, prev_stage_volume=p)))
    tree = {}
    for sh in shapes:
        tree = _merge(tree, sh)
    tree = random_variables(tree, rng)
    jv = jax.tree.map(jnp.asarray, tree)

    def loss(v_param, stage, grads=True):
        m = models[v_param]
        p = jnp.asarray(prev) if stage == names[-1] else None

        def f(params, x, key):
            out = m.apply({"params": params, "batch_stats": jv["batch_stats"]}, x,
                          jnp.asarray(xr), stage, key, prev_stage_volume=p)
            return out["loss"], out
        if grads:
            return jax.jit(jax.value_and_grad(f, has_aux=True))
        return jax.jit(lambda *a: (f(*a), None))

    return dict(tree=tree, jv=jv, xr=xr, x0=x0, prev=prev, models=models, loss=loss)


@pytest.fixture(scope="module")
def ladder():
    """The scaled two-stage JAX model (both parameterisations): ``_jax_ladder``
    of LADDER."""
    return _jax_ladder(LADDER, 31)


# ------------------------------------------------------------ the schedule ---

@pytest.mark.parametrize("steps,kind", [(10, "cosine"), (1000, "cosine"), (10, "linear"),
                                        (1000, "linear")])
def test_schedule_tables_match_jax(steps, kind):
    want = jax.jit(lambda: jax_diffusion.NoiseSchedule(steps, kind).tables())()
    sched = NoiseSchedule(steps, kind)
    got = (sched.sqrt_alphas_cumprod, sched.sqrt_one_minus_alphas_cumprod)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == (steps,)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-6)


def test_schedule_identities_exact(rng):
    """On JAX's tables, q_sample, v_target and the two x₀ predictions (the
    ε one with its 1e-8 clamp) agree with JAX's bit for bit in fp32."""
    js = jax_diffusion.NoiseSchedule(1000, "cosine")
    sa, so = (np.array(a) for a in js.tables())
    sched = NoiseSchedule(1000, "cosine")
    sched.sqrt_alphas_cumprod = torch.from_numpy(sa)
    sched.sqrt_one_minus_alphas_cumprod = torch.from_numpy(so)
    t = np.array([0, 1, 498, 999], np.int32)
    a, b = (rng.standard_normal((4, 1, 3, 4, 5)).astype(np.float32) for _ in range(2))
    ja, jb, jt = jnp.asarray(a), jnp.asarray(b), jnp.asarray(t)
    ta, tb, tt = torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(t).long()
    pairs = [(js.q_sample(ja, jt, jb), sched.q_sample(ta, tt, tb)),
             (js.v_target(ja, jb, jt), sched.v_target(ta, tb, tt)),
             (js.pred_x_start_from_v(ja, jb, jt), sched.pred_x_start_from_v(ta, tb, tt)),
             (js.pred_x_start_from_eps(ja, jb, jt), sched.pred_x_start_from_eps(ta, tb, tt))]
    for want, got in pairs:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("n", [2, 4, 10, 20, 25])
def test_ddim_timesteps_equal_jax(n):
    want = jax.jit(lambda: jnp.linspace(999, 0, n).round().astype(jnp.int32))()
    np.testing.assert_array_equal(ddim_timesteps(1000, n), np.asarray(want))


# ---------------------------------------------------------- depth lifting ---

def test_depth_weight_network_matches_jax(rng):
    feats = rng.standard_normal((2, 8, 8, 32)).astype(np.float32)
    jm = JaxWeightNetwork(max_depth=16)
    tree, jv = jax_variables(jm, rng, jnp.asarray(feats))
    want = np.asarray(jax.jit(jm.apply)(jv, jnp.asarray(feats)))  # (B, H, W, D)
    tm = CascadedDepthWeightNetwork(16, 32)
    tm.load_state_dict(convert.flax_tree(tree["params"]), strict=True)
    with torch.no_grad():
        got = tm(torch.from_numpy(feats).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got.sum(-1), 1.0, rtol=1e-5)
    np.testing.assert_allclose(got, want, **LIFT_TOL)


@pytest.mark.parametrize("prev_ch,slabs", [(None, 0), (1, 0), (32, 4)])
def test_depth_lifting_matches_jax(rng, prev_ch, slabs):
    """Forward and the gradients of Σ out² (parameters, features and prev)
    against JAX at D, H, W, C = 16, 8, 8, 32 with depth_sizes (8, 16): no
    prev (the lift alone), a 1-channel and a C-channel prev, dense and in 4
    slabs; the streamed port equals the dense port within the same bounds."""
    D, H, W, C = 16, 8, 8, 32
    feats = rng.standard_normal((2, H, W, C)).astype(np.float32)
    prev = None if prev_ch is None else rng.standard_normal((2, 8, H, W, prev_ch)).astype(np.float32)
    jprev = None if prev is None else jnp.asarray(prev)
    jm = JaxLifting(feature_dim=C, depth_sizes=(8, 16), lift_slabs=slabs)
    # the fusion's parameters exist in every case (the port builds them for a
    # depth that can fuse); without a prev they go unused
    tree, jv = jax_variables(jm, rng, jnp.asarray(feats), D, jnp.zeros((2, 8, H, W, 1)))

    def jloss(params, f, p):
        out = jm.apply({"params": params}, f, D, p)
        return jnp.sum(out ** 2), out
    argnums = (0, 1, 2) if prev is not None else (0, 1)
    (_, want), grads = jax.jit(jax.value_and_grad(jloss, argnums=argnums, has_aux=True))(
        jv["params"], jnp.asarray(feats), jprev)
    want = np.asarray(want)
    gp, gf, gprev = grads + ((None,) if prev is None else ())

    outs = {}
    for s in sorted({0, slabs}):
        tm = CascadedDepthLifting(C, D, (8, 16), True, lift_slabs=s)
        tm.load_state_dict(convert.flax_tree(tree["params"]), strict=True)
        tf = torch.from_numpy(feats).permute(0, 3, 1, 2).requires_grad_()
        tp = None if prev is None else torch.from_numpy(prev).permute(0, 4, 1, 2, 3).requires_grad_()
        out = tm(tf, tp)
        (out ** 2).sum().backward()
        outs[s] = (out.detach().permute(0, 2, 3, 4, 1).numpy(), tm, tf, tp)
    for s, (got, tm, tf, tp) in outs.items():
        assert got.shape == (2, D, H, W, C)
        np.testing.assert_allclose(got, want, **LIFT_TOL)
        grads = convert.flax_tree(jax.tree.map(np.asarray, gp))
        for name, p in tm.named_parameters():
            if p.grad is None:  # the fusion, without a prev
                assert prev is None and not np.any(grads[name].numpy()), name
                continue
            np.testing.assert_allclose(p.grad.numpy(), grads[name].numpy(), **LIFT_GRAD_TOL,
                                       err_msg=name)
        np.testing.assert_allclose(tf.grad.permute(0, 2, 3, 1).numpy(), np.asarray(gf),
                                   **LIFT_GRAD_TOL)
        if tp is not None:
            np.testing.assert_allclose(tp.grad.permute(0, 2, 3, 4, 1).numpy(), np.asarray(gprev),
                                       **LIFT_GRAD_TOL)
    if slabs:
        np.testing.assert_allclose(outs[slabs][0], outs[0][0], **LIFT_TOL)
        for (name, a), (_, b) in zip(outs[0][1].named_parameters(), outs[slabs][1].named_parameters()):
            np.testing.assert_allclose(b.grad.numpy(), a.grad.numpy(), **LIFT_GRAD_TOL, err_msg=name)


# --------------------------------------------------------------- the model ---

def _jax_draws(key, shape):
    """t and noise as UnifiedHybridViTCascade draws them from ``key``
    (diffusion.py:203-205)."""
    t_rng, noise_rng = jax.random.split(key)
    t = jax.random.randint(t_rng, (shape[0],), 0, T)
    return np.array(t), np.array(jax.random.normal(noise_rng, shape, jnp.float32))


@pytest.mark.parametrize("stage,v_param,grads", [("s1", True, True), ("s2", False, True),
                                                 ("s2", True, False), ("s1", False, False)])
def test_loss_and_grads_match_jax(ladder, stage, v_param, grads):
    """loss, diffusion_loss and physics_loss (2e-4) at stage 1 and at the
    refiner with a previous volume, under both parameterisations,
    train=False; in two of the four cases, which take both stages and both
    parameterisations, the gradient of every parameter the stage reaches."""
    _hold_loss_and_grads(ladder, _port(ladder["tree"], v_param), stage, v_param, grads)


def _hold_loss_and_grads(ladder, model, stage, v_param, grads) -> None:
    """The port model's loss components at ``stage`` (2e-4) against JAX's from
    JAX's own t and noise, a refiner conditioned on ladder["prev"]; with
    ``grads`` every parameter's gradient by GRAD_RATIO (exact zeros where
    JAX's is zero)."""
    key = jax.random.PRNGKey(5)
    x0 = ladder["x0"][stage]
    (_, want), jgrads = ladder["loss"](v_param, stage, grads)(ladder["jv"]["params"],
                                                              jnp.asarray(x0), key)
    t, noise = _jax_draws(key, x0.shape)
    last = model.stage_configs[-1]["name"]
    prev = torch.from_numpy(ladder["prev"]) if stage == last else None
    got = model(torch.from_numpy(x0), torch.from_numpy(ladder["xr"]), stage,
                prev_stage_volume=prev, t=torch.from_numpy(t), noise=torch.from_numpy(noise))
    for k in ("loss", "diffusion_loss", "physics_loss"):
        np.testing.assert_allclose(float(got[k].detach()), float(want[k]), err_msg=k, **TOL)
    assert float(got["physics_loss"].detach()) > 0
    if not grads:
        return
    got["loss"].backward()
    wg = convert.diffusion({"params": jax.tree.map(np.asarray, jgrads),
                            "batch_stats": ladder["tree"]["batch_stats"]})
    ratios = {}
    depths = [c["volume_size"][0] for c in model.stage_configs]
    for name, p in model.named_parameters():
        if p.grad is None:  # another stage's, or prev_proj of a stage without prev
            assert not np.any(wg[name].numpy()), name
            continue
        if name.endswith(("stem_convs.0.bias",
                          *(f"depth_lifter.depth_{d}.Conv_1.bias" for d in depths))):
            # 0 in exact arithmetic: at these widths the stem's first GroupNorm
            # and the weight network's second have one channel a group, and a
            # bias in front of them cancels; both sides hold rounding only
            scale = float(wg[name.replace(".bias", ".weight")].norm())
            assert max(float(p.grad.norm()), float(wg[name].norm())) <= 1e-4 * scale, name
            continue
        ratios[name] = float((p.grad - wg[name]).norm() / wg[name].norm())
    worst = sorted(ratios.items(), key=lambda kv: -kv[1])[:5]
    assert len(ratios) > 40 and worst[0][1] <= GRAD_RATIO, worst


# the ladder's three stages cut to 8³ → 16³ → 32³ (stage3_high's place at 32³)
LADDER3 = tuple(dict(c, name=n, volume_size=(s, s, s))
                for c, n, s in zip(LADDER + LADDER[1:], ("s1", "s2", "s3"), (8, 16, 32)))


def test_three_stage_ladder_matches_jax():
    """A three-stage scaled ladder: the third stage (32³) conditioned on a
    16³ previous volume, its loss components and the gradient of every
    parameter against JAX, as test_loss_and_grads_match_jax holds two
    stages; the first two stages' parameters take no gradient on either
    side."""
    lad = _jax_ladder(LADDER3, 33, v_params=(True,))
    model = UnifiedHybridViTCascade(LADDER3, xray_embed_dim=E, num_timesteps=T)
    model.load_state_dict(convert.diffusion(lad["tree"]), strict=True)
    _hold_loss_and_grads(lad, model.eval(), "s3", True, True)
    assert not any(p.grad is not None for n, p in model.named_parameters()
                   if n.startswith(("stage_s1.", "stage_s2.", "prev_proj_s2.")))


def test_refiner_lift_slabs_matches_dense(ladder):
    key = jax.random.PRNGKey(3)
    t, noise = _jax_draws(key, ladder["x0"]["s2"].shape)
    outs = []
    for slabs in (0, 4):
        out = _port(ladder["tree"], lift_slabs=slabs)(
            torch.from_numpy(ladder["x0"]["s2"]), torch.from_numpy(ladder["xr"]), "s2",
            prev_stage_volume=torch.from_numpy(ladder["prev"]), t=torch.from_numpy(t),
            noise=torch.from_numpy(noise))
        outs.append(float(out["loss"].detach()))
    np.testing.assert_allclose(outs[1], outs[0], rtol=1e-4)


def test_samplers_match_jax(ladder):
    """cascaded_ddim_sample over both stages, 4 steps, from the x_T JAX draws
    (its per-stage key splits); its first stage is ddim_sample from that
    stage's x_T with no previous volume, and the refiner's is ddim_sample
    conditioned on it."""
    jm, jv, xr = ladder["models"][True], ladder["jv"], jnp.asarray(ladder["xr"])
    key = jax.random.PRNGKey(9)
    model = _port(ladder["tree"])
    txr = torch.from_numpy(ladder["xr"])
    want = jax.jit(lambda v, x: jax_diffusion.cascaded_ddim_sample(jm, v, x, key, 4))(jv, xr)
    rng, x_T = key, {}
    for c in LADDER:
        rng, k = jax.random.split(rng)
        x_T[c["name"]] = torch.from_numpy(np.array(
            jax.random.normal(k, (1, 1, *c["volume_size"]), jnp.float32)))
    assert np.abs(np.asarray(want["s1"])).max() > 1e-2
    got = cascaded_ddim_sample(model, txr, num_steps=4, x_T=x_T)
    assert list(got) == list(want) == ["s1", "s2"]
    for name in got:
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]), err_msg=name, **TOL)


def test_convert_loads_strict_with_jax_counts(ladder):
    sd = convert.diffusion(ladder["tree"])
    model = UnifiedHybridViTCascade(LADDER, xray_embed_dim=E, num_timesteps=T)
    model.load_state_dict(sd, strict=True)
    params = ladder["tree"]["params"]
    assert sorted(params) == sorted({n.split(".", 1)[0] for n, _ in model.named_parameters()})
    for top, sub in params.items():
        want = sum(np.size(a) for a in jax.tree.leaves(sub))
        got = sum(p.numel() for n, p in model.named_parameters() if n.split(".", 1)[0] == top)
        assert got == want, top


_STAGE_SHAPES = {}


def _jax_stage_shapes(jcfg, ladder, i):
    """jax.eval_shape of the JAX model's init at ladder stage i. The three
    configs share their stages, and a stage's tree depends on its own config,
    the previous stage's size and the X-ray width, not on lift_slabs (the
    streamed and dense lifters share one tree, tests/test_models.py:226-227),
    so each stage is traced once a module."""
    c = ladder[i]
    prev_size = tuple(ladder[i - 1]["volume_size"]) if i else None
    key = (json.dumps(c, sort_keys=True), prev_size, jcfg.model.xray_feature_dim)
    if key not in _STAGE_SHAPES:
        jm = jax_trainer.build_model(jcfg)
        k = jax.random.PRNGKey(0)
        xr = jax.ShapeDtypeStruct((1, 2, 1, 512, 512), jnp.float32)
        x0 = jax.ShapeDtypeStruct((1, 1, *c["volume_size"]), jnp.float32)
        prev = jax.ShapeDtypeStruct((1, 1, *prev_size), jnp.float32) if i else None
        _STAGE_SHAPES[key] = jax.eval_shape(
            lambda a, b, p: jm.init(k, a, b, c["name"], k, prev_stage_volume=p), x0, xr, prev)
    return _STAGE_SHAPES[key]


@pytest.mark.parametrize("name", ["diffusion_64", "diffusion_progressive", "diffusion_quality_r5",
                                  "diffusion_progressive@256"])
def test_build_model_full_width_shapes(name):
    """The configs' ladders equal JAX's, and every parameter's shape is what
    jax.eval_shape of the JAX model's per-stage init gives (the port on the
    meta device). "@256": the config with ``volume_size`` 256³ set here (no
    file under configs/ asks for it), whose ladder reaches stage3_high."""
    name, _, size = name.partition("@")
    cfg = Config.from_json(f"configs/{name}.json")
    jcfg = JaxConfig.from_json(f"configs/{name}.json")
    if size:
        cfg.model.volume_size = jcfg.model.volume_size = (int(size),) * 3
    ladder = diffusion_stage_configs(cfg.model)
    assert [dict(c) for c in ladder] == [dict(c) for c in jax_trainer.diffusion_stage_configs(jcfg.model)]
    tree = {}
    for i in range(len(ladder)):
        tree = _merge(tree, _jax_stage_shapes(jcfg, ladder, i))
    want = {n: tuple(t.shape) for n, t in convert.diffusion(
        jax.tree.map(lambda s: np.zeros(s.shape, np.float32), tree)).items()}
    with torch.device("meta"):
        model = build_model(cfg)
    assert type(model).__name__ == "UnifiedHybridViTCascade"
    got = {n: tuple(t.shape) for n, t in model.state_dict().items()}
    assert got == want
    assert model.stage_configs[-1]["volume_size"] == tuple(cfg.model.volume_size)
    assert len(ladder) == {64: 1, 128: 2, 256: 3}[cfg.model.volume_size[0]]
    lifter = getattr(model, f"stage_{ladder[-1]['name']}").depth_lifter
    assert lifter.lift_slabs == cfg.model.diffusion_lift_slabs


# ------------------------------------------------------------- the trainer ---

def _cfg(tmp_path, cls=Config, stage_cls=StageConfig, size: int = 16, **training):
    cfg = cls()
    m = cfg.model
    m.family, m.volume_size, m.voxel_dim, m.vit_depth = "diffusion", (size,) * 3, E, 1
    m.num_heads, m.xray_feature_dim = HEADS, E
    d = cfg.data
    d.synthetic, d.synthetic_patients, d.xray_size, d.train_split, d.val_split = True, 2, XR, 1.0, 0.0
    cfg.training.batch_size = 2
    cfg.training.num_epochs = 1
    cfg.training.stages = {"stage1": stage_cls(1, 2, 1e-4, (8, 8, 8)),
                           "stage2": stage_cls(1, 2, 1e-4, (16, 16, 16))}
    for k, v in training.items():
        setattr(cfg.training, k, v)
    cfg.checkpoints.save_dir = str(tmp_path / "ckpt")
    cfg.checkpoints.save_every = 0
    return cfg


# the trainer's ladder: 4³ → 8³, the smallest the stage takes, to keep the
# epochs and the chain eval cheap on the CPU
TINY = (dict(name="lo", volume_size=(4, 4, 4), voxel_dim=E, vit_depth=1, num_heads=HEADS,
             use_depth_lifting=True, use_physics_loss=True),
        dict(name="hi", volume_size=(8, 8, 8), voxel_dim=E, vit_depth=1, num_heads=HEADS,
             use_depth_lifting=True, use_physics_loss=True))


def test_fit_trains_one_stage(tmp_path):
    """``fit`` on a diffusion config without diffusion_progressive trains one
    stage (fit_diffusion); the DDIM eval gives finite, nonzero metrics. At 8³
    (tests/test_training.py:375 trains 16³: 4,096 tokens, slow on the CPU)."""
    metrics = Trainer(_cfg(tmp_path, size=8, diffusion_sample_steps=4),
                      device="cpu").fit(progress=False)
    assert np.isfinite(metrics["loss"])
    assert np.isfinite(metrics["psnr"]) and metrics["psnr"] != 0.0
    assert 0.0 <= metrics["ssim"] <= 1.0 and metrics["ssim"] != 0.0
    assert (tmp_path / "ckpt" / "latest" / "checkpoint.pt").exists()


def test_fit_diffusion_cascade_chains_and_resumes(tmp_path, capsys):
    """The two-stage ladder: per-stage checkpoints, finite chain metrics
    (also in the JSONL), prev_proj_hi trained; a second run skips both
    stages."""
    cfg = _cfg(tmp_path, size=8, diffusion_sample_steps=2)

    def run():
        tr = Trainer(cfg, device="cpu")
        tr.model = UnifiedHybridViTCascade(TINY, xray_embed_dim=E, num_timesteps=T)
        return tr, tr.fit_diffusion_cascade(progress=True)
    tr, metrics = run()
    for nm in ("lo", "hi"):
        assert np.isfinite(metrics[f"chain_{nm}_psnr"]), metrics
        assert 0.0 <= metrics[f"chain_{nm}_ssim"] <= 1.0, metrics
        assert (tmp_path / "ckpt" / f"diffusion_{nm}" / "latest" / "checkpoint.pt").exists()
    sd = load_entry(tmp_path / "ckpt" / "diffusion_hi" / "latest")[0]["state_dict"]
    assert "prev_proj_hi.weight" in sd
    rows = [json.loads(r) for r in (tmp_path / "ckpt" / "training_log.jsonl").read_text().splitlines()]
    assert [r["phase"] for r in rows] == ["diffusion_lo", "diffusion_hi", "diffusion_chain_eval"]
    assert all(np.isfinite(v) for k, v in rows[-1].items() if k != "phase")
    capsys.readouterr()
    run()
    out = capsys.readouterr().out
    assert "[diffusion_lo] complete" in out and "[diffusion_hi] complete" in out


def test_fit_diffusion_resumes_its_own_root(tmp_path, monkeypatch):
    """The port's ``fit_diffusion`` saves the whole two-stage ladder at the
    run's root, and a second run with more epochs resumes from it: every
    tensor of the ladder as the first run left it (``load_ladder_state``'s
    whole-ladder load, strict), the saved optimizer step, epoch 1 first.
    The converted JAX root, which holds the last stage alone, is held in
    tests/test_torch_orbax.py."""
    cfg = _cfg(tmp_path, size=8, diffusion_sample_steps=2)

    def trainer():
        tr = Trainer(cfg, device="cpu")
        tr.model = UnifiedHybridViTCascade(TINY, xray_embed_dim=E, num_timesteps=T)
        return tr
    trainer().fit_diffusion(progress=False)
    saved, meta = load_entry(tmp_path / "ckpt" / "latest")
    opt, _ = load_entry(tmp_path / "ckpt" / "latest_opt")
    saved = saved["state_dict"]
    assert meta["epoch"] == 0 and any(k.startswith("stage_lo.") for k in saved)
    seen = {}

    def record(self, state, train_step, eval_step, batch_size, start_epoch, *a, **kw):
        seen.update(start=start_epoch, step=state.step,
                    state={k: v.clone() for k, v in self.model.state_dict().items()})
        return {}
    monkeypatch.setattr(Trainer, "_run_epochs", record)
    fresh = trainer()
    assert not all(torch.equal(fresh.model.state_dict()[k], v) for k, v in saved.items())
    fresh.fit_diffusion(epochs=2, progress=False)
    assert seen["start"] == 1 and seen["step"] == opt["step"] > 0
    assert sorted(seen["state"]) == sorted(saved)
    assert all(torch.equal(seen["state"][k], v) for k, v in saved.items())


_TINY_INIT_SHAPES = {}


@pytest.mark.parametrize("freeze", [False, True])
def test_trainable_sets_match_jax(tmp_path, monkeypatch, freeze):
    """The parameters each stage's optimizer takes: the top-level subtrees the
    JAX fit_diffusion_cascade labels 'train' (its optimizer's prefixes,
    captured with the epoch loop stubbed out) on the same ladder."""
    seen = []
    real = jax_schedules.make_optimizer

    def capture(*a, trainable_prefixes=None, params=None, **kw):
        labels = jax_schedules.stage_freeze_labels(params, trainable_prefixes)
        seen.append(sorted(k for k, v in labels.items() if "train" in jax.tree.leaves(v)))
        return real(*a, trainable_prefixes=trainable_prefixes, params=params, **kw)

    def no_epochs(self, state, *a, **kw):
        self._last_state = state
        return {}
    # the variables by shape only, no optimizer state: nothing is compiled;
    # both cases share each stage's shapes
    init = jax_trainer.Trainer._init_diffusion_stage

    def init_shapes(self, stage_cfgs, stage_idx, rng):
        if stage_idx not in _TINY_INIT_SHAPES:
            _TINY_INIT_SHAPES[stage_idx] = jax.eval_shape(
                lambda: init(self, stage_cfgs, stage_idx, rng))
        return _TINY_INIT_SHAPES[stage_idx]
    monkeypatch.setattr(jax_trainer.Trainer, "_init_diffusion_stage", init_shapes)
    monkeypatch.setattr(jax_trainer.Trainer, "_make_state",
                        lambda self, v, tx, mesh=None: types.SimpleNamespace(
                            params=v["params"], batch_stats=v["batch_stats"]))
    monkeypatch.setattr(jax_trainer, "make_optimizer", capture)
    monkeypatch.setattr(jax_trainer.Trainer, "_run_epochs", no_epochs)
    jcfg = _cfg(tmp_path / "jax", JaxConfig, JaxStageConfig, size=8,
                freeze_shared_diffusion=freeze)
    jtr = jax_trainer.Trainer(jcfg)
    jtr.model = jax_diffusion.UnifiedHybridViTCascade(stage_configs=TINY, xray_embed_dim=E,
                                                      num_timesteps=T)
    jtr.fit_diffusion_cascade(stage_configs=TINY, resume=False, progress=False, chain_eval=False)

    tr = Trainer(_cfg(tmp_path / "port", size=8, freeze_shared_diffusion=freeze), device="cpu")
    tr.model = UnifiedHybridViTCascade(TINY, xray_embed_dim=E, num_timesteps=T)
    got = []
    for i in range(len(TINY)):
        state = diffusion_state(tr.model, tr.cfg, i, 1e-4, 1, freeze)
        names = {id(p): n for n, p in tr.model.named_parameters()}
        got.append(sorted({names[id(p)].split(".", 1)[0]
                           for g in state.optimizer.param_groups for p in g["params"]}))
    assert got == seen
    assert ("xray_encoder" in got[1]) is not freeze


def test_engine_and_cli_infer_refuse_diffusion(tmp_path, capsys):
    cfg = _cfg(tmp_path)
    model = build_model(cfg)
    save_checkpoint(tmp_path / "diffusion.pt", cfg, model)
    with pytest.raises(NotImplementedError) as err:
        InferenceEngine(tmp_path / "diffusion.pt", device="cpu")
    assert str(err.value) == DIFFUSION_NOT_SERVED
    assert "ddim_sample" in DIFFUSION_NOT_SERVED and "cascaded_ddim_sample" in DIFFUSION_NOT_SERVED
    with pytest.raises(NotImplementedError, match="cascaded_ddim_sample"):
        cli.main(["infer", "--checkpoint", str(tmp_path / "diffusion.pt"), "--synthetic",
                  "--device", "cpu", "--output", str(tmp_path / "out")])
    cli.main(["inspect", "--checkpoint", str(tmp_path / "diffusion.pt")])
    report = json.loads(capsys.readouterr().out)
    assert "error" not in report and "stage_stage1_low.vit_backbone.pos_embed" in report["arrays"]


# ------------------------------------------ the denoiser's 17-channel stem ---

def test_stem_17_channels_take_the_tensor_cores():
    """The noisy volume and the 16-channel prior make a 17-channel stem: in
    bf16 its forward (C), data gradient (F) and weight gradient (G) take the
    tensor-core instances, whose weight layouts hold the one real channel of
    the last chunk and zeros."""
    assert ck.fwd_uses_tensor_cores(torch.bfloat16, 2, 17, 64)
    assert ck.dgrad_s2_instance(torch.bfloat16, 17, 64) == ck.DGRAD_S2_TC
    assert ck.wgrad_instance(torch.bfloat16, 2, 17) == ck.WGRAD_TC
    w = torch.randn(64, 17, 3, 3, 3)
    wt = ck.s2_tc_weights(w)  # (Cout tiles, 16-channel chunks, taps, 64, 16)
    assert wt.shape == (1, 2, 27, 64, 16) and not wt[0, 1, :, :, 1:].any()
    assert torch.equal(wt[0, 1, :, :, 0], w[:, 16].reshape(64, 27).T)
    wd = ck.s2_dgrad_tc_weights(w)  # (32-channel dx tiles, 16-channel g chunks, taps, 32, 16)
    assert wd.shape == (1, 4, 27, 32, 16) and not wd[0, :, :, 17:].any()


@pytest.mark.parametrize("which", ["forward", "dgrad", "wgrad"])
def test_stem_17_channels_tc_replay_matches_plain(which):
    """The torch replays of the tensor-core stride-2 conv, data gradient and
    weight gradient (tests/test_torch_fwd_plans.py, test_torch_bwd_plans.py)
    at Cin = 17 against the plain versions, fp32 (1e-4)."""
    rng = np.random.default_rng(17)
    x = torch.from_numpy(rng.standard_normal((1, 17, 5, 6, 18)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((64, 17, 3, 3, 3)) / np.sqrt(27 * 17))
                         .astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((1, 64, 3, 3, 9)).astype(np.float32))
    if which == "forward":
        bias = torch.from_numpy(rng.standard_normal(64).astype(np.float32))
        got = fwd_plans._conv_tc_s2_emulated(x, w, bias, 0, 3)
        want = ck.conv3d_k3_plain(x, w, bias, 2, 0, 3, True)
    elif which == "dgrad":
        got, writes = bwd_plans._dgrad_tc_emulated(g, w, x, 0, None)
        assert bool((writes == 1).all())
        got, want = (got,), (ck.conv3d_k3_dgrad_plain(g, w, x, 2, 0, None),)
    else:
        got = (bwd_plans._wgrad_tc_emulated(x, g, 2, 0, None, sms=3),)
        want = (ck.conv3d_k3_wgrad_plain(x, g, 2, 0, None),)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4, atol=1e-4)


def test_measure_times_a_ladder_stage_on_cpu(tmp_path):
    """training.measure's train_steps on a diffusion ladder stage: the
    refiner's step (its own trainable set) at a small config."""
    cfg = _cfg(tmp_path, size=8)
    model = UnifiedHybridViTCascade(TINY, xray_embed_dim=E, num_timesteps=T)
    res = train_steps(model, cfg, 2, 1, 1, torch.Generator().manual_seed(0))
    assert len(res["step_ms"]) == 1 and all(np.isfinite(res["total_loss"]))
    assert set(res["metrics"][0]) == {"total_loss", "loss", "diffusion_loss", "physics_loss"}
    trained = {n.split(".", 1)[0] for n, p in model.named_parameters() if p.requires_grad}
    assert trained == {"stage_hi", "prev_proj_hi", "xray_encoder", "Dense_0", "Dense_1"}
