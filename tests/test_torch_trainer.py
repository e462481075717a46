"""The port's training entry point on the CPU: CheckpointManager patterns
(the counterparts of tests/test_training.py:111-174), Trainer.fit_cascade
stage by stage (:217), resume (:287), the frozen-encoder split stage-3 step
(:319), the cascade's ``stage2_volume`` forward against the JAX package's
with converted weights (2e-4, the tolerance of test_parity_cascade.py:345),
and ``cli train --device cpu``.

Scaled config of tests/test_parity_cascade.py:46-47: 8³→16³→32³ volumes,
64² X-rays, E=32, 4 heads, one block per stage, fp32, two synthetic
patients."""

import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hybrid_vit_cascade_tpu.models import ProgressiveCascadeModel as JaxCascade
from hybrid_vit_cascade_tpu_torch import cli, convert
from hybrid_vit_cascade_tpu_torch.config import Config, StageConfig
from hybrid_vit_cascade_tpu_torch.inference.infer import InferenceEngine, build_model
from hybrid_vit_cascade_tpu_torch.training import trainer as trainer_mod
from hybrid_vit_cascade_tpu_torch.training.checkpoint import (
    CheckpointManager,
    filtered_restore,
    load_entry,
    shape_matched_transfer,
)
from hybrid_vit_cascade_tpu_torch.training.schedules import make_optimizer
from hybrid_vit_cascade_tpu_torch.training.trainer import Trainer, stage_step
from tests.test_torch_models import jax_variables
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

S1, S2, S3 = 8, 16, 32
XR, E, HEADS = 64, 32, 4
TOL = dict(rtol=2e-4, atol=2e-4)


# ------------------------------------------------------------- checkpoints ---

def _tree(scale=1.0):
    return {"state_dict": {"stage1.w": torch.full((3,), scale),
                           "stage2.b": torch.full((2,), scale * 2)}}


def test_save_restore_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path), save_every=2)
    mgr.save(_tree(1.5), epoch=0, metrics={"loss": 0.5, "psnr": 20.0, "ssim": 0.7},
             config={"a": 1})
    restored, meta = mgr.restore("latest")
    assert torch.equal(restored["state_dict"]["stage1.w"], torch.full((3,), 1.5))
    assert meta["epoch"] == 0 and meta["config"] == {"a": 1}
    assert not list(tmp_path.glob("*.tmp"))  # written under .tmp, renamed into place
    assert json.loads((tmp_path / "best_records.json").read_text()) == {
        "loss": 0.5, "psnr": 20.0, "ssim": 0.7}


def test_triple_best_checkpoints(tmp_path):
    mgr = CheckpointManager(str(tmp_path), save_every=0)
    mgr.save(_tree(1), 0, {"loss": 0.5, "psnr": 20.0, "ssim": 0.5})
    improved = mgr.save(_tree(2), 1, {"loss": 0.6, "psnr": 25.0, "ssim": 0.4})
    assert improved == {"psnr": True}  # loss worse, ssim worse, psnr better
    assert mgr.restore("best_psnr")[1]["epoch"] == 1
    assert mgr.restore("best_loss")[1]["epoch"] == 0
    # a new manager over the directory keeps the records
    assert CheckpointManager(str(tmp_path)).save(_tree(3), 2, {"loss": 0.55}) == {}


def test_periodic_checkpoints(tmp_path):
    mgr = CheckpointManager(str(tmp_path), save_every=2)
    for e in range(4):
        mgr.save(_tree(e), e, {"loss": 1.0})
    assert (tmp_path / "epoch_0001").exists() and (tmp_path / "epoch_0003").exists()
    assert not (tmp_path / "epoch_0000").exists()


def _params():
    torch.manual_seed(0)
    return [torch.nn.Parameter(torch.randn(3, 2)), torch.nn.Parameter(torch.randn(4))]


def test_opt_state_roundtrip(tmp_path):
    """The optimizer state, step and schedule position come back exactly:
    the resumed optimizer's next update is the uninterrupted one's."""
    params = _params()
    opt = make_optimizer(params, 1e-2, 10)
    for _ in range(3):
        for p in params:
            p.grad = torch.ones_like(p)
        opt.step()
    mgr = CheckpointManager(str(tmp_path), save_every=0)
    mgr.save({"state_dict": {}}, 0, {"loss": 1.0},
             opt={"optimizer": opt.state_dict(), "step": 3})

    twin = [torch.nn.Parameter(p.detach().clone()) for p in params]
    fresh = make_optimizer(twin, 1e-2, 10)
    restored = mgr.restore_opt(fresh)
    assert restored is not None and restored["step"] == 3
    fresh.load_state_dict(restored["optimizer"])
    assert fresh.param_groups[0]["lr"] == opt.param_groups[0]["lr"] != 1e-2
    for ps in (params, twin):
        for p in ps:
            p.grad = torch.full_like(p, 0.5)
    opt.step()
    fresh.step()
    for a, b in zip(params, twin):
        assert torch.equal(a, b)


def test_restore_opt_absent_or_mismatched(tmp_path):
    """No latest_opt, or one that does not fit the optimizer (other
    parameter count or shapes): None, so resume starts a fresh optimizer."""
    mgr = CheckpointManager(str(tmp_path), save_every=0)
    params = _params()
    mgr.save({"state_dict": {}}, 0, {"loss": 1.0})  # no opt
    assert mgr.restore_opt(make_optimizer(params, 1e-3, 10)) is None
    opt = make_optimizer(params, 1e-3, 10)
    for p in params:
        p.grad = torch.ones_like(p)
    opt.step()
    mgr.save({"state_dict": {}}, 1, {"loss": 1.0}, opt={"optimizer": opt.state_dict(), "step": 1})
    assert mgr.restore_opt(make_optimizer(params[:1], 1e-3, 10)) is None
    other = [torch.nn.Parameter(torch.zeros(2, 3)), torch.nn.Parameter(torch.zeros(4))]
    assert mgr.restore_opt(make_optimizer(other, 1e-3, 10)) is None
    assert mgr.restore_opt(make_optimizer(params, 1e-3, 10))["step"] == 1


def test_filtered_restore():
    params = _tree()["state_dict"]
    loaded = {"stage1.w": torch.zeros(3), "stage2.b": torch.zeros(2)}
    out = filtered_restore(params, loaded, include_prefixes=["stage1"])
    assert float(out["stage1.w"].sum()) == 0.0
    assert float(out["stage2.b"].sum()) != 0.0


def test_shape_matched_transfer():
    params = {"a": torch.zeros(2, 3), "b": torch.zeros(4), "c": torch.zeros(5)}
    loaded = {"a": torch.ones(2, 3, dtype=torch.float64), "b": torch.ones(9), "d": torch.ones(1)}
    out, transferred, skipped = shape_matched_transfer(params, loaded)
    assert (transferred, skipped) == (1, 2)
    assert float(out["a"].sum()) == 6.0 and out["a"].dtype == torch.float32
    assert float(out["b"].sum()) == 0.0  # shape mismatch skipped


# ----------------------------------------------------------------- trainer ---

def _cfg(tmp_path, stage2_epochs=1, **training) -> Config:
    cfg = Config()
    m = cfg.model
    m.family, m.voxel_dim, m.xray_feature_dim, m.dtype = "cascade", E, E, "float32"
    m.stage_depths, m.stage_heads, m.stage_sizes = (1, 1, 1), (HEADS,) * 3, (S1, S2, S3)
    cfg.data.synthetic, cfg.data.synthetic_patients, cfg.data.xray_size = True, 2, XR
    cfg.data.train_split, cfg.data.val_split = 1.0, 0.0
    cfg.training.stages = {"stage1": StageConfig(2, 2, 1e-3, (S1,) * 3),
                           "stage2": StageConfig(stage2_epochs, 2, 1e-3, (S2,) * 3),
                           "stage3": StageConfig(1, 2, 1e-3, (S3,) * 3)}
    for k, v in training.items():
        setattr(cfg.training, k, v)
    cfg.checkpoints.save_dir = str(tmp_path / "ckpt")
    cfg.checkpoints.save_every = 0
    return cfg


def test_fit_cascade_stagewise_tiny(tmp_path, capsys):
    """Stage 1 → freeze → stage 2 → freeze → stage 3 on the streamed slab
    chains with 'mlp' remat: per-stage checkpoints and logs, and the
    epoch-end figures the config asks for after every epoch."""
    cfg = _cfg(tmp_path)
    cfg.model.stage3_slab_scan, cfg.model.slab_count, cfg.model.remat_mode = True, 4, "mlp"
    cfg.training.viz_every = 1
    metrics = Trainer(cfg, device="cpu").fit()
    assert sorted(metrics) == ["loss", "psnr", "ssim"] and np.isfinite(metrics["loss"])
    for stage in ("stage1", "stage2", "stage3"):
        for entry in ("latest", "latest_opt", "best_loss", "best_psnr", "best_ssim"):
            assert (tmp_path / "ckpt" / stage / entry / "checkpoint.pt").exists(), (stage, entry)
    rows = [json.loads(r) for r in (tmp_path / "ckpt" / "training_log.jsonl").read_text().splitlines()]
    epochs = [("stage1", 0), ("stage1", 1), ("stage2", 0), ("stage3", 0)]
    assert [(r["phase"], r["epoch"]) for r in rows if "viz_files" not in r] == epochs
    assert [(r["phase"], r["epoch"]) for r in rows if "viz_files" in r] == epochs
    assert "visualization failed" not in capsys.readouterr().out


def test_trainer_refuses_what_is_not_ported(tmp_path, monkeypatch):
    """The observability flags are ported (tests/test_torch_observability.py),
    so nothing is refused: a config that sets any of them builds a Trainer
    that keeps it. wandb is taken as absent, so no run starts."""
    from hybrid_vit_cascade_tpu_torch.utils import wandb_compat

    monkeypatch.setattr(wandb_compat, "WANDB_AVAILABLE", False)
    for flag, value in (("use_wandb", True), ("profile_dir", "p"), ("debug_nans", True)):
        trainer = Trainer(_cfg(tmp_path, **{flag: value}), device="cpu")
        assert getattr(trainer.cfg.training, flag) == value


def test_resume_skips_completed_and_continues_in_progress(tmp_path, capsys):
    """A finished stage is restored from disk and skipped; an interrupted one
    resumes at its saved epoch with its optimizer step and schedule."""
    import csv

    stages = ("stage1", "stage2")
    Trainer(_cfg(tmp_path, stage2_epochs=1), device="cpu").fit_cascade(stages=stages,
                                                                       progress=False)
    ckpt = tmp_path / "ckpt"
    assert json.loads((ckpt / "stage2" / "latest" / "meta.json").read_text())["epoch"] == 0
    Trainer(_cfg(tmp_path, stage2_epochs=3), device="cpu").fit_cascade(stages=stages)
    assert "[stage1] complete at epoch 1; skipping" in capsys.readouterr().out
    assert json.loads((ckpt / "stage2" / "latest" / "meta.json").read_text())["epoch"] == 2
    assert json.loads((ckpt / "stage1" / "latest" / "meta.json").read_text())["epoch"] == 1
    rows = list(csv.DictReader((ckpt / "training_log.csv").open()))
    assert len([r for r in rows if r["phase"] == "stage1"]) == 2, "stage1 must not retrain"
    assert [r["epoch"] for r in rows if r["phase"] == "stage2"] == ["0", "1", "2"]
    opt, _ = load_entry(ckpt / "stage2" / "latest_opt")
    assert opt["step"] == 3 and opt["optimizer"]["param_groups"][0]["schedule_step"] == 3


def test_split_step_requires_the_frozen_encoder(tmp_path):
    cfg = _cfg(tmp_path, stage3_split_step=True)
    with pytest.raises(ValueError, match="requires freeze_shared_encoder_stage3"):
        stage_step(build_model(cfg), cfg, 3)


def test_frozen_encoder_pins_statistics(tmp_path):
    """One train-mode stage-3 step of each form: the shared encoder is out of
    the optimizer and its BatchNorm running statistics stay bitwise; the
    split step also discards stage 1's private encoder updates (its stage-2
    forward's), the full step lets them move, as in the JAX package."""
    out = {}
    for split in (False, True):
        cfg = _cfg(tmp_path, freeze_shared_encoder_stage3=True, stage3_split_step=split)
        torch.manual_seed(0)
        model = build_model(cfg)
        before = {k: v.clone() for k, v in model.state_dict().items()}
        state, step = stage_step(model, cfg, 3)
        assert all(not p.requires_grad for n, p in model.named_parameters()
                   if n.startswith("xray_encoder."))
        rng = np.random.default_rng(0)
        batch = {"drr_stacked": torch.from_numpy(rng.uniform(-1, 1, (2, 2, 1, XR, XR))
                                                 .astype(np.float32)),
                 "ct_volume": torch.from_numpy(rng.uniform(-1, 1, (2, 1, S3, S3, S3))
                                               .astype(np.float32))}
        step(state, batch, torch.Generator().manual_seed(1))
        after = model.state_dict()
        changed = {k for k in before if not torch.equal(before[k], after[k])}
        out[split] = changed
        assert not any(k.startswith("xray_encoder.") for k in changed)
        assert any(k.startswith("stage3.") for k in changed)
    assert any(k.startswith("stage1.xray_encoder.") and "running" in k for k in out[False])
    assert not any(k.startswith("stage1.") for k in out[True])


@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    """``cli train --device cpu`` on a scaled copy of configs/quality_r5.json
    (frozen encoder, split stage-3 step, 8-slab stage-3 schedule)."""
    tmp = tmp_path_factory.mktemp("cli")
    raw = json.loads((Path(__file__).resolve().parents[1] / "configs" / "quality_r5.json")
                     .read_text())
    raw["model"].update(voxel_dim=E, xray_feature_dim=E, stage_depths=[1, 1, 1],
                        stage_heads=[HEADS] * 3, stage_sizes=[S1, S2, S3], dtype="float32")
    for n, s in zip((1, 2, 3), (S1, S2, S3)):
        raw["training"]["stages"][f"stage{n}"].update(num_epochs=1, batch_size=2,
                                                      target_resolution=[s] * 3)
    raw["training"]["viz_every"] = 0
    raw["data"].update(synthetic_patients=3, xray_size=XR, train_split=0.67, val_split=0.34)
    path = tmp / "cfg.json"
    path.write_text(json.dumps(raw))
    return tmp, path


def test_cli_train_writes_every_stage(cli_run, capsys):
    tmp, path = cli_run
    save = tmp / "run"
    cli.main(["train", "--config", str(path), "--device", "cpu", "--save-dir", str(save)])
    final = json.loads(capsys.readouterr().out.strip().splitlines()[-1])["final"]
    assert sorted(final) == ["loss", "psnr", "ssim"] and all(np.isfinite(list(final.values())))
    for n in (1, 2, 3):
        for entry in ("latest", "latest_opt", "best_loss", "best_psnr", "best_ssim"):
            assert (save / f"stage{n}" / entry / "meta.json").exists(), (n, entry)

    # the shared encoder (parameters and BatchNorm buffers) is pinned through
    # stage 3, which trained
    s2, _ = load_entry(save / "stage2" / "latest")
    s3, meta = load_entry(save / "stage3" / "latest")
    s2, s3 = s2["state_dict"], s3["state_dict"]
    enc = [k for k in s2 if k.startswith("xray_encoder.")]
    assert any("running_var" in k for k in enc)
    assert all(torch.equal(s2[k], s3[k]) for k in enc)
    assert any(not torch.equal(s2[k], s3[k]) for k in s2 if k.startswith("stage3."))

    # the split forward (stage 3 on the precomputed stage-2 volume) is the
    # full cascade's forward
    cfg = Config.from_dict(meta["config"])
    model = build_model(cfg)
    model.load_state_dict(s3)
    xr = torch.from_numpy(np.random.default_rng(3).uniform(-1, 1, (1, 2, 1, XR, XR))
                          .astype(np.float32))
    with torch.no_grad():
        full = model(xr, max_stage=3)
        split = model(xr, max_stage=3, stage2_volume=model(xr, max_stage=2))
    np.testing.assert_allclose(split.numpy(), full.numpy(), rtol=1e-6, atol=1e-6)

    # a trained run serves from its own checkpoint; the same command resumes
    engine = InferenceEngine(save / "stage3" / "best_psnr", device="cpu")
    assert engine.reconstruct(xr).shape == (1, 1, S3, S3, S3)
    cli.main(["train", "--config", str(path), "--device", "cpu", "--save-dir", str(save)])
    out = capsys.readouterr().out
    assert all(f"[stage{n}] complete at epoch 0; skipping" in out for n in (1, 2, 3))


def test_trainer_defaults_to_the_card(cli_run, monkeypatch):
    """An entry point runs on the card unless the caller asks for the CPU:
    without one, the default refuses instead of training on the CPU."""
    _, path = cli_run
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["train", "--config", str(path)])


def test_stage2_volume_forward_matches_jax():
    rng = np.random.default_rng(5)
    jm = JaxCascade(stage_sizes=(S1, S2, S3), voxel_dim=E, stage_depths=(1, 1, 1),
                    stage_heads=(HEADS,) * 3, xray_feature_dim=E, attn_impl="xla")
    tree, jv = jax_variables(jm, rng, jnp.zeros((1, 2, 1, XR, XR)), max_stage=3)
    xr = rng.standard_normal((2, 2, 1, XR, XR)).astype(np.float32)
    vol2 = rng.uniform(-1, 1, (2, 1, S2, S2, S2)).astype(np.float32)
    want = np.asarray(jm.apply(jv, jnp.asarray(xr), max_stage=3, train=False,
                               stage2_volume=jnp.asarray(vol2)))
    cfg = _cfg_model_only()
    model = build_model(cfg)
    model.load_state_dict(convert.cascade(tree), strict=True)
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(xr), max_stage=3,
                           stage2_volume=torch.from_numpy(vol2), return_intermediate=True)
    assert sorted(got) == ["stage3"]
    np.testing.assert_allclose(got["stage3"].numpy(), want, **TOL)
    with pytest.raises(ValueError, match="max_stage=3"):
        model(torch.from_numpy(xr), max_stage=2, stage2_volume=torch.from_numpy(vol2))


def _cfg_model_only() -> Config:
    cfg = Config()
    m = cfg.model
    m.family, m.voxel_dim, m.xray_feature_dim, m.dtype = "cascade", E, E, "float32"
    m.stage_depths, m.stage_heads, m.stage_sizes = (1, 1, 1), (HEADS,) * 3, (S1, S2, S3)
    return cfg


def test_trainer_module_runs_split_step_on_the_split_backward(tmp_path, monkeypatch):
    """With the JAX package's switch off (FUSED_BWD False) the split
    stage-3 step's backward takes the split flash backward."""
    from hybrid_vit_cascade_tpu_torch.ops import attention

    calls = []
    real = attention.fa.flash_attention_bwd_split
    monkeypatch.setattr(attention, "FUSED_BWD", False)
    monkeypatch.setattr(attention.fa, "flash_attention_bwd_split",
                        lambda *a: calls.append(1) or real(*a))
    monkeypatch.setattr(attention.fa, "flash_attention_bwd", None)  # D must not run
    cfg = _cfg(tmp_path, freeze_shared_encoder_stage3=True, stage3_split_step=True)
    model = build_model(cfg)
    state, step = trainer_mod.stage_step(model, cfg, 3)
    batch = {"drr_stacked": torch.zeros(1, 2, 1, XR, XR), "ct_volume": torch.zeros(1, 1, S3, S3, S3)}
    step(state, batch, torch.Generator().manual_seed(0))
    assert len(calls) == 2  # stage 3's one block: self- and cross-attention
