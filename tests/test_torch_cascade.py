"""The port's whole slice — ProgressiveCascadeModel and InferenceEngine —
against the JAX package, with converted weights.

Scaled config of tests/test_parity_cascade.py:46-47, 322-325: 8³→16³→32³
volumes, 64² X-rays, E=32, 4 heads, one block per stage. fp32 on the CPU,
rtol/atol 2e-4 (the tolerance of test_parity_cascade.py:345)."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hybrid_vit_cascade_tpu.config import Config as JaxConfig
from hybrid_vit_cascade_tpu.models import ProgressiveCascadeModel as JaxCascade
from hybrid_vit_cascade_tpu.models.cascade import Stage3Refiner256 as JaxStage3
from hybrid_vit_cascade_tpu_torch import convert
from hybrid_vit_cascade_tpu_torch.config import Config
from hybrid_vit_cascade_tpu_torch.inference.infer import (
    InferenceEngine,
    build_model,
    denormalize_ct,
    save_checkpoint,
)
from hybrid_vit_cascade_tpu_torch.models import cascade as tcascade
from hybrid_vit_cascade_tpu_torch.models.cascade import ProgressiveCascadeModel, Stage3Refiner256
from tests.test_torch_models import jax_variables
from tests.test_torch_slab import force_streaming

CONFIGS = Path(__file__).resolve().parents[1] / "configs"
S1, S2, S3 = 8, 16, 32
XR, E, HEADS = 64, 32, 4
TOL = dict(rtol=2e-4, atol=2e-4)


def _config() -> Config:
    cfg = Config()
    m = cfg.model
    m.family, m.voxel_dim, m.xray_feature_dim = "cascade", E, E
    m.stage_depths, m.stage_heads, m.stage_sizes = (1, 1, 1), (HEADS,) * 3, (S1, S2, S3)
    m.dtype = "float32"
    cfg.data.xray_size = XR
    return cfg


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(7)
    jm = JaxCascade(stage_sizes=(S1, S2, S3), voxel_dim=E, stage_depths=(1, 1, 1),
                    stage_heads=(HEADS,) * 3, xray_feature_dim=E, attn_impl="xla")
    tree, jv = jax_variables(jm, rng, jnp.zeros((1, 2, 1, XR, XR)), max_stage=3)
    xr = rng.standard_normal((2, 2, 1, XR, XR)).astype(np.float32)
    want = jax.tree.map(np.asarray, jm.apply(jv, jnp.asarray(xr), max_stage=3,
                                             return_intermediate=True, train=False))
    return tree, xr, want


@pytest.mark.parametrize("max_stage", [1, 2, 3])
def test_cascade_matches_jax(setup, max_stage):
    tree, xr, want = setup
    tm = ProgressiveCascadeModel(xray_feature_dim=E, voxel_dim=E, stage_depths=(1, 1, 1),
                                 stage_heads=(HEADS,) * 3, stage_sizes=(S1, S2, S3))
    tm.load_state_dict(convert.cascade(tree), strict=True)
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(xr), return_intermediate=True, max_stage=max_stage)
    assert sorted(got) == [f"stage{s}" for s in range(1, max_stage + 1)]
    for s, size in zip(range(1, max_stage + 1), (S1, S2, S3)):
        g = got[f"stage{s}"].numpy()
        assert g.shape == (2, 1, size, size, size)
        np.testing.assert_allclose(g, want[f"stage{s}"], **TOL, err_msg=f"stage{s}")


def test_inference_engine_loads_checkpoint(setup, tmp_path):
    tree, xr, want = setup
    cfg = _config()
    model = build_model(cfg)
    model.load_state_dict(convert.cascade(tree), strict=True)
    path = tmp_path / "cascade.pt"
    save_checkpoint(path, cfg, model)

    engine = InferenceEngine(path, device="cpu")
    assert engine.cfg.model.stage_sizes == (S1, S2, S3)
    vol = engine.reconstruct(xr)
    assert vol.shape == (2, 1, S3, S3, S3) and vol.dtype == torch.float32
    np.testing.assert_allclose(vol.numpy(), want["stage3"], **TOL)
    stages = engine.reconstruct(xr, max_stage=2, return_intermediate=True)
    np.testing.assert_allclose(stages["stage2"].numpy(), want["stage2"], **TOL)

    # a stage-2 engine loads the same file without stage 3's weights
    engine2 = InferenceEngine(path, device="cpu", max_stage=2)
    assert not hasattr(engine2.model, "stage3")
    np.testing.assert_allclose(engine2.reconstruct(xr).numpy(), want["stage2"], **TOL)
    with pytest.raises(ValueError):
        engine2.reconstruct(xr, max_stage=3)


def test_inference_engine_rejects_foreign_keys(setup, tmp_path):
    tree, _, _ = setup
    cfg = _config()
    state = convert.cascade(tree)
    state["stage2.unknown"] = torch.zeros(1)
    path = tmp_path / "bad.pt"
    torch.save({"config": cfg.to_dict(), "state_dict": state}, path)
    with pytest.raises(KeyError):
        InferenceEngine(path, device="cpu")


def test_build_model_families():
    cfg = _config()
    cfg.model.dtype = "bfloat16"
    model = build_model(cfg)
    assert model.stage3.detail_enhancer.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in model.parameters())
    cfg.model.family = "diffusion"
    with pytest.raises(NotImplementedError, match="diffusion"):
        build_model(cfg)


def test_denormalize_ct():
    v = np.array([-1.0, 0.0, 1.0], np.float32)
    np.testing.assert_allclose(denormalize_ct(v), [-200.0, 0.0, 200.0])
    np.testing.assert_allclose(denormalize_ct(np.array([0.0, 1.0]), "full"), [-1024.0, 3071.0])


@pytest.mark.parametrize("name", [None] + sorted(p.name for p in CONFIGS.glob("*.json")))
def test_config_matches_jax(name):
    """The port's Config loads every config file (and the defaults) into the
    dict the JAX package's Config loads, and round-trips it."""
    if name is None:
        want, got = JaxConfig().to_dict(), Config().to_dict()
    else:
        want = JaxConfig.from_json(str(CONFIGS / name)).to_dict()
        got = Config.from_json(str(CONFIGS / name)).to_dict()
    assert got == want
    assert Config.from_dict(got).to_dict() == got


# ------------------------------------------------- stage-3 chain schedules ---

S3_KW = dict(volume_size=(32, 32, 32), voxel_dim=32, vit_depth=1, num_heads=4,
             xray_feature_dim=16)
# the set-up of tests/test_slab.py:216-246: 'train' pins a train=False call to
# the configured flags; the default 'auto' streams it with one slab
S3_SCHEDULES = {"dense": dict(slab_scan=False, eval_schedule="train"),
                "slab4": dict(slab_scan=True, slab_count=4, eval_schedule="train"),
                "slab4_recompute": dict(slab_scan=True, slab_count=4, slab_impl="recompute",
                                        eval_schedule="train"),
                "auto": dict()}


@pytest.fixture(scope="module")
def stage3_setup():
    rng = np.random.default_rng(3)
    vol = rng.normal(0, 0.5, (1, 16, 16, 16, 1)).astype(np.float32)
    feats = rng.standard_normal((1, 4, 4, 16)).astype(np.float32)
    cond = rng.standard_normal((1, 1024)).astype(np.float32)
    jm = JaxStage3(**S3_KW, attn_impl="xla", remat=False, **S3_SCHEDULES["dense"])
    tree, jv = jax_variables(jm, rng, jnp.asarray(vol), jnp.asarray(feats), jnp.asarray(cond))
    p = tree["params"]
    trunk = dict(p["vit_trunk"])
    sd = {"residual_weight": torch.from_numpy(p["residual_weight"]),
          "detail_weight": torch.from_numpy(p["detail_weight"])}
    sd.update(convert.vit3d(trunk.pop("vit_refiner"), "vit_trunk.vit_refiner."))
    sd.update({f"vit_trunk.{k}": torch.from_numpy(v) for k, v in trunk.items()})
    sd.update({f"detail_enhancer.{k}": torch.from_numpy(v)
               for k, v in p["detail_enhancer"].items()})
    return jv, sd, vol, feats, cond


@pytest.mark.parametrize("schedule", sorted(S3_SCHEDULES))
def test_stage3_refiner_schedules_match_jax(stage3_setup, monkeypatch, schedule):
    """Stage3Refiner256 on each chain schedule against the JAX module on the
    same one (train=False), the same weights: 2e-4. The streamed schedules
    stream every level (no dense tail at this size, see force_streaming)."""
    jv, sd, vol, feats, cond = stage3_setup
    force_streaming(monkeypatch)
    kw = S3_SCHEDULES[schedule]
    jm = JaxStage3(**S3_KW, attn_impl="xla", remat=False, **kw)
    want = np.moveaxis(np.asarray(jm.apply(jv, jnp.asarray(vol), jnp.asarray(feats),
                                           jnp.asarray(cond))), -1, 1)
    tm = Stage3Refiner256(**S3_KW, remat=False, **kw)
    tm.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = tm(torch.from_numpy(np.moveaxis(vol, -1, 1)),
                 torch.from_numpy(np.moveaxis(feats, -1, 1)), torch.from_numpy(cond)).numpy()
    assert got.shape == want.shape == (1, 1, 32, 32, 32)
    np.testing.assert_allclose(got, want, **TOL)


def test_build_model_follows_slab_flags(monkeypatch):
    """configs/progressive_cascade.json trains stage 3 slab-streamed (8 slabs)
    and every train=False call streams it with one slab, every endpoint
    stored: both conv chains go through chain_apply_streamed with those
    arguments, as in the JAX package."""
    cfg = Config.from_json(str(CONFIGS / "progressive_cascade.json"))
    m = cfg.model
    assert (m.stage3_slab_scan, m.slab_count, m.slab_impl) == (True, 8, "streamed")
    m.voxel_dim, m.xray_feature_dim, m.dtype = E, E, "float32"
    m.stage_depths, m.stage_heads, m.stage_sizes = (1, 1, 1), (HEADS,) * 3, (S1, S2, S3)
    model = build_model(cfg)
    s3 = model.stage3
    assert s3.eval_schedule == "auto"
    assert s3._schedule(True) == (True, 8, "streamed", None)
    assert s3._schedule(False) == (True, 1, "streamed", 0.0)

    calls = []
    real = tcascade.chain_apply_streamed

    def spy(x, chain, num_slabs, **kw):
        calls.append((num_slabs, kw.get("store_min_flops")))
        return real(x, chain, num_slabs, **kw)

    monkeypatch.setattr(tcascade, "chain_apply_streamed", spy)
    xr = torch.from_numpy(np.random.default_rng(0).standard_normal((1, 2, 1, XR, XR),
                                                                   dtype=np.float32))
    with torch.no_grad():
        model(xr, max_stage=3)
        assert calls == [(1, 0.0), (1, 0.0)]  # the trunk's chain, then the detail chain
        calls.clear()
        model(xr, max_stage=3, train=True, generator=torch.Generator().manual_seed(0))
        assert calls == [(8, None), (8, None)]
