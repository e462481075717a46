"""The port's training observability and the last data tool, on the CPU:
``Trainer`` with ``use_wandb`` (a recording stand-in for wandb),
``profile_dir``, ``debug_nans`` and ``viz_every`` together; the figures'
failure path; ``estimate_memory_usage`` and ``write_reference_tree`` against
the JAX package's.

Scaled cascade of tests/test_torch_trainer.py (8³→16³→32³, 64² X-rays, E=32,
one block a stage, fp32, two synthetic patients), one epoch a stage."""

import json
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from hybrid_vit_cascade_tpu.data import synthetic as jax_synthetic
from hybrid_vit_cascade_tpu.utils import viz as jax_viz
from hybrid_vit_cascade_tpu_torch.data import synthetic
from hybrid_vit_cascade_tpu_torch.data.nifti import read_nifti
from hybrid_vit_cascade_tpu_torch.training.trainer import Trainer
from hybrid_vit_cascade_tpu_torch.utils import viz, wandb_compat
from tests.test_torch_direct import configs
from tests.test_torch_trainer import _cfg
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

# What the JAX trainer logs to wandb: each epoch {"phase", "train_loss", **val}
# with the eval step's keys (hybrid_vit_cascade_tpu/training/trainer.py:844-847,
# make_eval_step :188-204), and the figures under viz/<phase>/<name>
# (:918-951).
JAX_EPOCH_KEYS = {"phase", "train_loss", "loss", "psnr", "ssim"}
JAX_FIGURES = ("prediction_vs_gt", "xray_features", "attention_salience")


class _FakeWandb:
    """Records init, log and Image calls."""

    def __init__(self):
        self.calls = []

    def init(self, **kwargs):
        self.calls.append(("init", kwargs))

    def log(self, metrics, step=None):
        self.calls.append(("log", metrics, step))

    def Image(self, path):  # noqa: N802 (wandb's name)
        return ("image", path)


@pytest.fixture
def fake_wandb(monkeypatch):
    fake = _FakeWandb()
    monkeypatch.setattr(wandb_compat, "wandb", fake)
    monkeypatch.setattr(wandb_compat, "WANDB_AVAILABLE", True)
    monkeypatch.setattr(wandb_compat, "_active", False)
    return fake


def _one_epoch_a_stage(tmp_path, **training):
    cfg = _cfg(tmp_path, **training)
    for sc in cfg.training.stages.values():
        sc.num_epochs = 1
    return cfg


def _rows(cfg):
    path = Path(cfg.checkpoints.save_dir) / "training_log.jsonl"
    return [json.loads(r) for r in path.read_text().splitlines()]


def test_trainer_observability_flags(tmp_path, fake_wandb):
    """All four flags at once: one Chrome trace a phase, the figures of every
    epoch with their JSONL row, and wandb's init, epoch rows and images under
    JAX's keys."""
    prof = tmp_path / "prof"
    cfg = _one_epoch_a_stage(tmp_path, use_wandb=True, profile_dir=str(prof), debug_nans=True,
                             viz_every=1)
    metrics = Trainer(cfg, device="cpu").fit()
    assert np.isfinite(metrics["loss"])
    phases = ("stage1", "stage2", "stage3")

    assert sorted(p.name for p in prof.iterdir()) == [f"{s}_epoch000.json" for s in phases]
    for s in phases:
        trace = json.loads((prof / f"{s}_epoch000.json").read_text())
        names = {e.get("name", "") for e in trace["traceEvents"]}
        assert any(n.startswith("aten::") for n in names), s  # the CPU ops of the epoch

    rows = _rows(cfg)
    assert [(r["phase"], "viz_files" in r) for r in rows] == [(s, v) for s in phases
                                                              for v in (False, True)]
    viz_dir = Path(cfg.checkpoints.save_dir) / "viz" / "epoch_000"
    for r in rows[1::2]:
        want = sorted(f"{r['phase']}_{f}.png" for f in JAX_FIGURES)
        assert r["viz_dir"] == str(viz_dir) and r["viz_files"] == want
        for f in want:
            with Image.open(viz_dir / f) as img:
                assert img.size[0] > 50 and img.size[1] > 50

    kinds = [c[0] for c in fake_wandb.calls]
    assert kinds == ["init"] + ["log"] * 6
    assert fake_wandb.calls[0][1] == {"project": "hybrid-vit-cascade-tpu", "config": cfg.to_dict()}
    for i, s in enumerate(phases):
        (_, epoch_row, step), (_, images, img_step) = fake_wandb.calls[1 + 2 * i:3 + 2 * i]
        assert set(epoch_row) == JAX_EPOCH_KEYS and epoch_row["phase"] == s and step == 0
        assert sorted(images) == sorted(f"viz/{s}/{f}" for f in JAX_FIGURES) and img_step == 0
        assert all(v == ("image", str(viz_dir / f"{s}_{k.rsplit('/', 1)[1]}.png"))
                   for k, v in images.items())


def test_single_model_fit_writes_the_figures(tmp_path, fake_wandb):
    """``fit``'s single-model branch (the scaled ``direct_vit`` of
    tests/test_torch_direct.py, one epoch) writes JAX's three figures, logs
    their row and sends them to wandb."""
    cfg = configs(patients=2)[0]
    cfg.checkpoints.save_dir = str(tmp_path / "ckpt")
    t = cfg.training
    t.num_epochs, t.batch_size, t.use_wandb, t.viz_every = 1, 1, True, 1
    Trainer(cfg, device="cpu").fit(progress=False)
    viz_dir = Path(cfg.checkpoints.save_dir) / "viz" / "epoch_000"
    want = sorted(f"train_{f}.png" for f in JAX_FIGURES)
    assert [(r["epoch"], r["phase"], r["viz_dir"], r["viz_files"]) for r in _rows(cfg)
            if "viz_files" in r] == [(0, "train", str(viz_dir), want)]
    for f in want:
        with Image.open(viz_dir / f) as img:
            assert img.size[0] > 50 and img.size[1] > 50
    images = fake_wandb.calls[-1][1]
    assert sorted(images) == sorted(f"viz/train/{f}" for f in JAX_FIGURES)


class _NaNXrays:
    """A dataset whose X-rays are NaN."""

    def __init__(self, ds):
        self.ds = ds

    def __len__(self):
        return len(self.ds)

    def __getitem__(self, i):
        item = dict(self.ds[i])
        item["drr_stacked"] = np.full_like(item["drr_stacked"], np.nan)
        return item


def test_debug_nans_raises_at_the_first_step(tmp_path):
    cfg = _one_epoch_a_stage(tmp_path, debug_nans=True)
    trainer = Trainer(cfg, device="cpu")
    trainer.train_ds = _NaNXrays(trainer.train_ds)
    with pytest.raises(FloatingPointError, match="phase stage1, epoch 0, step 0"):
        trainer.fit_cascade(stages=("stage1",))


def test_viz_failure_does_not_stop_training(tmp_path, monkeypatch, capsys):
    """Where matplotlib is missing (the card's machine) the figures fail, the
    run says so, and training goes on."""
    def no_matplotlib():
        raise ImportError("No module named 'matplotlib'")

    monkeypatch.setattr(viz, "_plt", no_matplotlib)
    cfg = _one_epoch_a_stage(tmp_path, viz_every=1)
    Trainer(cfg, device="cpu").fit_cascade(stages=("stage1",))
    assert "[viz] epoch 0 visualization failed: No module named 'matplotlib'" in \
        capsys.readouterr().out
    assert [r["phase"] for r in _rows(cfg)] == ["stage1"]


def test_training_curves_and_memory_report(tmp_path):
    log = tmp_path / "log.jsonl"
    log.write_text("\n".join(json.dumps({"epoch": e, "train_loss": 1.0 / (e + 1), "psnr": 20 + e,
                                         "ssim": 0.5}) for e in range(3)))
    viz.plot_training_curves(str(log), str(tmp_path / "curves.png"))
    assert (tmp_path / "curves.png").stat().st_size > 0
    assert viz.device_memory_report() == {}  # no card here


@pytest.mark.parametrize("size,batch,dim,nbytes", [((64, 64, 64), 8, 256, 2),
                                                    ((256, 256, 256), 1, 256, 2),
                                                    ((128, 96, 112), 2, 512, 4),
                                                    ((8, 8, 8), 3, 32, 4)])
def test_estimate_memory_usage_matches_jax(size, batch, dim, nbytes):
    assert viz.estimate_memory_usage(size, batch, dim, nbytes) == \
        jax_viz.estimate_memory_usage(size, batch, dim, nbytes)


def test_write_reference_tree_matches_jax(tmp_path):
    """The same patient ids and files; equal PNG pixels and decoded NIfTI
    voxels (the gzip bytes hold a timestamp)."""
    kw = dict(num_patients=2, base_size=24, xray_size=40, seed=3)
    got = synthetic.write_reference_tree(tmp_path / "port", **kw)
    want = jax_synthetic.write_reference_tree(tmp_path / "jax", **kw)
    assert got == want == ["patient000", "patient001"]
    for pid in want:
        files = sorted(p.name for p in (tmp_path / "jax" / pid).iterdir())
        assert sorted(p.name for p in (tmp_path / "port" / pid).iterdir()) == files
        for f in files:
            a, b = tmp_path / "port" / pid / f, tmp_path / "jax" / pid / f
            if f.endswith(".png"):
                with Image.open(a) as ia, Image.open(b) as ib:
                    assert ia.mode == ib.mode == "L"
                    np.testing.assert_array_equal(np.asarray(ia), np.asarray(ib))
            else:
                np.testing.assert_array_equal(read_nifti(a), read_nifti(b))
