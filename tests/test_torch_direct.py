"""The port's direct-regression family against the JAX package, with converted
weights: ``DirectCTRegression``'s forward (2e-4, the tolerance of
tests/test_parity_cascade.py:345), three steps of ``Trainer.fit``'s step
against the JAX step (losses, parameters and BatchNorm statistics), the
serving commands ``infer`` / ``eval`` against the JAX CLI, ``diagnose``'s
capture, ``cli train`` with its resume and ``cli transfer`` against the JAX
CLI's.

Scaled shapes of tests/test_parity_model.py:32-34: a 32³ volume, 64² X-rays,
voxel_dim = xray_feature_dim = 32, 4 heads, one block, fp32 on the CPU."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hybrid_vit_cascade_tpu import cli as jax_cli
from hybrid_vit_cascade_tpu import inference as jax_inference
from hybrid_vit_cascade_tpu.config import Config as JaxConfig
from hybrid_vit_cascade_tpu.losses import MultiScaleLoss as JaxLoss
from hybrid_vit_cascade_tpu.models import layers as jax_layers
from hybrid_vit_cascade_tpu.training.checkpoint import CheckpointManager as JaxCheckpoints
from hybrid_vit_cascade_tpu.training.schedules import make_optimizer as jax_make_optimizer
from hybrid_vit_cascade_tpu.training.trainer import TrainState as JaxTrainState
from hybrid_vit_cascade_tpu.training.trainer import build_model as jax_build_model
from hybrid_vit_cascade_tpu.training.trainer import make_train_step as jax_make_train_step
from hybrid_vit_cascade_tpu_torch import cli, convert
from hybrid_vit_cascade_tpu_torch.config import Config
from hybrid_vit_cascade_tpu_torch.inference.infer import (
    InferenceEngine,
    build_model,
    save_checkpoint,
)
from hybrid_vit_cascade_tpu_torch.models.direct import DirectCTRegression
from hybrid_vit_cascade_tpu_torch.models.layers import Dropout
from hybrid_vit_cascade_tpu_torch.training.checkpoint import load_entry
from hybrid_vit_cascade_tpu_torch.training.trainer import Trainer, single_model_step
from tests.test_torch_models import jax_variables

S, XR, E, HEADS = 32, 64, 32, 4
TOL = dict(rtol=2e-4, atol=2e-4)


def configs(depth: int = 1, patients: int = 4):
    """The port's and the JAX package's Config of the scaled direct_vit."""
    out = []
    for cls in (Config, JaxConfig):
        cfg = cls()
        m = cfg.model
        m.family, m.volume_size, m.voxel_dim, m.xray_feature_dim = "direct_vit", (S,) * 3, E, E
        m.vit_depth, m.num_heads, m.dtype, m.attn_impl = depth, HEADS, "float32", "xla"
        cfg.data.xray_size, cfg.data.synthetic, cfg.data.synthetic_patients = XR, True, patients
        out.append(cfg)
    return out


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The scaled model's JAX variables from numpy, the port model on their
    conversion, a port checkpoint file and a JAX Orbax entry of them."""
    root = tmp_path_factory.mktemp("direct")
    cfg, jcfg = configs()
    jm = jax_build_model(jcfg)
    tree, jv = jax_variables(jm, np.random.default_rng(21), jnp.zeros((1, 2, 1, XR, XR)))
    model = build_model(cfg)
    model.load_state_dict(convert.direct_regression(tree), strict=True)
    save_checkpoint(root / "direct.pt", cfg, model)
    JaxCheckpoints(str(root / "jax")).save(jv, epoch=0, metrics={}, config=jcfg.to_dict())
    return dict(root=root, jm=jm, tree=tree, jv=jv, port=root / "direct.pt",
                jax_entry=root / "jax" / "latest")


def test_forward_matches_jax(setup, rng):
    xr = rng.standard_normal((2, 2, 1, XR, XR)).astype(np.float32)
    want = np.asarray(jax.jit(lambda v, x: setup["jm"].apply(v, x))(setup["jv"], jnp.asarray(xr)))
    model = DirectCTRegression((S,) * 3, E, 1, HEADS, E)
    model.load_state_dict(convert.direct_regression(setup["tree"]), strict=True)
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(xr)).numpy()
    assert got.shape == want.shape == (2, 1, S, S, S)
    assert np.abs(want).max() > 1e-2
    np.testing.assert_allclose(got, want, **TOL)


def test_fit_steps_track_jax(setup, rng, monkeypatch):
    """Three train-mode steps of the step ``Trainer.fit`` builds (batch-
    statistics BatchNorm with running-statistic updates, MultiScaleLoss stage
    1, AdamW) against the JAX ``make_train_step`` with its optax chain, dropout
    off in both (its bits differ by framework): the loss of every step, then
    every parameter and BatchNorm statistic."""
    monkeypatch.setattr(jax_layers.FastDropout, "__call__", lambda self, x, deterministic: x)
    cfg, _ = configs()
    lr, total = 1e-3, 10
    batch = {"drr_stacked": rng.uniform(-1, 1, (2, 2, 1, XR, XR)).astype(np.float32),
             "ct_volume": rng.uniform(-1, 1, (2, 1, S, S, S)).astype(np.float32)}

    jloss = JaxLoss({"stage1": cfg.loss.stage1}, perceptual=object())
    step = jax_make_train_step(setup["jm"], lambda p, b: jloss(p, b["ct_volume"], stage=1))
    t = cfg.training
    tx = jax_make_optimizer(lr, total, t.weight_decay, t.gradient_clip, t.warmup_steps)
    jv = jax.tree.map(jnp.array, setup["jv"])
    state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=jv["params"],
                          batch_stats=jv["batch_stats"], opt_state=tx.init(jv["params"]), tx=tx)
    want = []
    for _ in range(3):
        state, m = step(state, jax.tree.map(jnp.asarray, batch), jax.random.PRNGKey(1))
        want.append(float(m["total_loss"]))

    model = build_model(cfg)
    model.load_state_dict(convert.direct_regression(setup["tree"]), strict=True)
    for m in model.modules():
        if isinstance(m, Dropout):
            m.rate = 0.0
    tstate, tstep = single_model_step(model, cfg, total, lr)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    got = []
    for _ in range(3):
        tstate, m = tstep(tstate, tb, torch.Generator().manual_seed(0))
        got.append(float(m["total_loss"]))
    np.testing.assert_allclose(got, want, **TOL)
    assert len(set(got)) == 3  # each step moved the weights

    final = convert.direct_regression(jax.tree.map(np.asarray, {"params": state.params,
                                                                "batch_stats": state.batch_stats}))
    sd = model.state_dict()
    start = convert.direct_regression(setup["tree"])
    # A bias that feeds a train-mode BatchNorm, or a GroupNorm of one channel
    # a group (the stem's first), has gradient 0 in exact arithmetic: AdamW
    # turns the rounding left of it into steps of up to lr, differently in
    # each package. Every other tensor is held by the norm of its difference
    # to JAX against the norm of JAX's update: AdamW's steps are ±lr wherever
    # a gradient is small, so elementwise bounds would hold rounding too.
    zero_grad = {f"xray_encoder.conv{i}.bias" for i in (1, 2, 3)}
    zero_grad.add("vit_backbone.stem_convs.0.bias")
    ratios = {}
    for k, w in final.items():
        if k.endswith("num_batches_tracked"):
            continue
        assert not torch.equal(w, start[k]), k  # every tensor moved
        if k in zero_grad:
            assert float((sd[k] - start[k]).abs().max()) <= 3 * lr * 1.01, k
            continue
        ratios[k] = float((sd[k] - w).norm() / (w - start[k]).norm())
    assert len(ratios) > 40 and max(ratios.values()) <= 0.01, ratios


# ------------------------------------------------------------------ the CLI ---

def _run(main, argv, capsys) -> dict:
    main(argv)
    return json.loads(capsys.readouterr().out)


@pytest.fixture(scope="module")
def jax_engine(setup):
    return jax_inference.InferenceEngine(str(setup["jax_entry"]))


@pytest.fixture
def jax_cli_engine(jax_engine, monkeypatch):
    """The JAX CLI's engine: the module's, whose forward is compiled."""
    monkeypatch.setattr(jax_inference, "InferenceEngine", lambda path: jax_engine)


def _close(got: dict, want: dict):
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **TOL)


def test_cli_infer_and_eval_match_jax(setup, tmp_path, capsys, jax_cli_engine):
    """``infer`` (exports and the other-family metrics psnr, psnr_dynamic,
    ssim, l1) and ``eval`` (their summary over the test split)."""
    args = ["infer", "--synthetic", "--index", "1"]
    want = _run(jax_cli.main, args + ["--checkpoint", str(setup["jax_entry"]),
                                      "--output", str(tmp_path / "jax")], capsys)
    got = _run(cli.main, args + ["--checkpoint", str(setup["port"]), "--device", "cpu",
                                 "--output", str(tmp_path / "port")], capsys)
    assert list(got["metrics"]) == ["psnr", "psnr_dynamic", "ssim", "l1"]
    _close(got["metrics"], want["metrics"])
    assert list(got["exports"]) == list(want["exports"])
    np.testing.assert_allclose(np.load(got["exports"]["npy"]), np.load(want["exports"]["npy"]),
                               **TOL)

    want = _run(jax_cli.main, ["eval", "--synthetic", "--checkpoint", str(setup["jax_entry"]),
                               "--output", str(tmp_path / "jax.json")], capsys)
    got = _run(cli.main, ["eval", "--synthetic", "--checkpoint", str(setup["port"]),
                          "--device", "cpu", "--output", str(tmp_path / "port.json")], capsys)
    assert list(got) == list(want) == ["psnr", "psnr_dynamic", "ssim", "l1"]
    for k in want:
        _close(got[k], want[k])


def test_cli_diagnose_captures_cross_attention(setup, capsys):
    """``diagnose`` on direct_vit captures every block's cross-attention
    (here one, (1, 4, 16³ tokens, 8² X-ray tokens)) and grades finite losses;
    afterwards the model holds no map and the capture is off."""
    engine = InferenceEngine(setup["port"], device="cpu")
    got = _run(cli.main, ["diagnose", "--synthetic", "--checkpoint", str(setup["port"]),
                          "--device", "cpu"], capsys)
    assert got["captured_attention"] == ["cross_attention"]
    assert got["losses"] and all(np.isfinite(v) for v in got["losses"].values())
    ca = engine.model.vit_backbone.blocks[0].cross_attn
    assert not ca.store_attention and ca.attention_weights is None


def _cli_config(tmp_path, depth: int = 1, epochs: int = 1):
    cfg, jcfg = configs(depth, patients=3)
    for c in (cfg, jcfg):
        c.training.num_epochs, c.training.batch_size = epochs, 2
        c.data.train_split, c.data.val_split = 0.67, 0.34
    path = tmp_path / f"direct_d{depth}.json"
    path.write_text(json.dumps(cfg.to_dict()))
    return path


def test_cli_train_writes_entries_and_resumes(tmp_path, capsys):
    """``cli train --device cpu`` on the scaled direct_vit: one epoch into
    ``save_dir`` (latest, latest_opt, best_*), finite metrics; the same
    command again resumes at its last epoch and trains nothing."""
    path, save = _cli_config(tmp_path), tmp_path / "run"
    argv = ["train", "--config", str(path), "--device", "cpu", "--save-dir", str(save)]
    cli.main(argv)
    final = json.loads(capsys.readouterr().out.strip().splitlines()[-1])["final"]
    assert sorted(final) == ["loss", "psnr", "ssim"] and all(np.isfinite(list(final.values())))
    for entry in ("latest", "latest_opt", "best_loss", "best_psnr", "best_ssim"):
        assert (save / entry / "checkpoint.pt").exists(), entry
    opt, _ = load_entry(save / "latest_opt")
    assert opt["step"] == 1  # 2 train patients at batch 2
    cli.main(argv)
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == {"final": {}}
    assert len((save / "training_log.jsonl").read_text().splitlines()) == 1


def test_cli_transfer_matches_jax(setup, tmp_path, capsys):
    """``transfer --init-only`` from the one-block model into a two-block
    one: the same transferred / skipped line as the JAX CLI's, the source's
    tensors copied, the entry at epoch −1; without --init-only it trains on."""
    path = _cli_config(tmp_path, depth=2)
    jax_cli.main(["transfer", "--from-checkpoint", str(setup["jax_entry"]), "--init-only",
                  "--config", str(path), "--save-dir", str(tmp_path / "jax")])
    want = capsys.readouterr().out.strip().splitlines()[-1]
    cli.main(["transfer", "--from-checkpoint", str(setup["port"]), "--init-only", "--config",
              str(path), "--device", "cpu", "--save-dir", str(tmp_path / "port")])
    got = capsys.readouterr().out.strip().splitlines()[-1]
    assert got == want and got.startswith("transfer: ") and " 0 skipped" not in got
    tree, meta = load_entry(tmp_path / "port" / "latest")
    assert meta["epoch"] == -1
    src = convert.direct_regression(setup["tree"])
    assert all(torch.equal(tree["state_dict"][k], v) for k, v in src.items()
               if "running" not in k and "num_batches" not in k)
    assert InferenceEngine(tmp_path / "port" / "latest", device="cpu").model.vit_backbone \
        .blocks[1] is not None
    cli.main(["transfer", "--from-checkpoint", str(setup["port"]), "--config", str(path),
              "--device", "cpu", "--save-dir", str(tmp_path / "port")])
    final = json.loads(capsys.readouterr().out.strip().splitlines()[-1])["final"]
    assert np.isfinite(final["loss"])
    assert load_entry(tmp_path / "port" / "latest")[1]["epoch"] == 0


def test_build_model_and_trainer_families(tmp_path):
    """build_model builds every direct family; diffusion alone is refused,
    by build_model and by the Trainer."""
    cfg, _ = configs()
    for family, cls in (("direct128_h200", "Direct128ModelH200"),
                        ("direct256_h200", "Direct256ModelH200"),
                        ("direct256_b200", "Direct256ModelB200"),
                        ("direct_vit", "DirectCTRegression")):
        cfg.model.family = family
        with torch.device("meta"):
            assert type(build_model(cfg)).__name__ == cls
    cfg.model.family = "diffusion"
    with pytest.raises(NotImplementedError, match="diffusion"):
        build_model(cfg)
    cfg.checkpoints.save_dir = str(tmp_path)
    with pytest.raises(NotImplementedError, match="diffusion"):
        Trainer(cfg, device="cpu")


def test_transfer_defaults_to_the_card(tmp_path, monkeypatch):
    """``transfer`` reads --device, default cuda: without a card its Trainer
    refuses instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["transfer", "--from-checkpoint", "x", "--config", str(_cli_config(tmp_path)),
                  "--save-dir", str(tmp_path / "run")])
