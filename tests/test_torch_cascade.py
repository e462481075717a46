"""The port's whole slice — ProgressiveCascadeModel and InferenceEngine —
against the JAX package, with converted weights.

Scaled config of tests/test_parity_cascade.py:46-47, 322-325: 8³→16³→32³
volumes, 64² X-rays, E=32, 4 heads, one block per stage. fp32 on the CPU,
rtol/atol 2e-4 (the tolerance of test_parity_cascade.py:345)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hybrid_vit_cascade_tpu.config import Config
from hybrid_vit_cascade_tpu.models import ProgressiveCascadeModel as JaxCascade
from hybrid_vit_cascade_tpu_torch import convert
from hybrid_vit_cascade_tpu_torch.inference.infer import (
    InferenceEngine,
    build_model,
    denormalize_ct,
    save_checkpoint,
)
from hybrid_vit_cascade_tpu_torch.models.cascade import ProgressiveCascadeModel
from tests.test_torch_models import jax_variables

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
    cfg.model.family = "direct_vit"
    with pytest.raises(NotImplementedError):
        build_model(cfg)


def test_denormalize_ct():
    v = np.array([-1.0, 0.0, 1.0], np.float32)
    np.testing.assert_allclose(denormalize_ct(v), [-200.0, 0.0, 200.0])
    np.testing.assert_allclose(denormalize_ct(np.array([0.0, 1.0]), "full"), [-1024.0, 3071.0])
