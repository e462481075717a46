"""Data-parallel training of the port (hybrid_vit_cascade_tpu_torch/parallel)
on gloo ranks of the CPU.

One launch of this file under torchrun (``--ranks``: 2 ranks, a module
fixture) runs every multi-rank check, while this process computes the
references: one process's step on the global batch, and the JAX step on a
2-device CPU mesh (``tests/conftest.py``'s virtual devices); one process's
``fit_cascade`` runs beside them (``--one``). Checked:

- the loader's split and ``data_axis`` against the JAX ``_mesh_for_batch``
  (no ranks);
- synced ``BatchNorm2d``: 2 ranks × 1 sample equal 1 process × 2 samples in
  the output, the input and parameter gradients and the running statistics;
- the optimizer's gradient hook averages before it clips;
- a train-mode stage-1 step of the scaled cascade (8³→16³→32³, 64² X-rays,
  E=32, fp32; dropout off on both sides, its bits differ by framework and
  by rank) against the JAX step on the mesh (loss, gradients, updated
  parameters and BatchNorm running statistics at ``LOSS_TOL`` /
  ``GRAD_TOL``) and against one process on the global batch;
- ``fit_cascade`` over 2 ranks with a stage at batch 1 (one rank idles):
  only rank 0 writes, every entry restores equal on both ranks, the ranks'
  parameters are bitwise equal after every stage, and the logged losses are
  one process's;
- ``cli dryrun --devices 2 --device cpu``.

AdamW's first step moves an element by about the learning rate (1e-5 here)
whatever its gradient's size, so the updated parameters are held by their
updates, θ_after − θ_before, against the reference's (``_check_updates``):
within 5% of lr where the gradient is well above rounding, within 2·lr
where it is rounding noise (a bias in front of a norm) and its sign may
differ between two runs.
"""

from __future__ import annotations

import hashlib
import json
import os
import signal
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from hybrid_vit_cascade_tpu_torch.config import Config
from hybrid_vit_cascade_tpu_torch.data.pipeline import DataLoader
from hybrid_vit_cascade_tpu_torch.inference.infer import build_model
from hybrid_vit_cascade_tpu_torch.losses.multiscale import MultiScaleLoss
from hybrid_vit_cascade_tpu_torch.models.encoders import BatchNorm2d
from hybrid_vit_cascade_tpu_torch.models.layers import Dropout
from hybrid_vit_cascade_tpu_torch.parallel import mesh
from hybrid_vit_cascade_tpu_torch.training.checkpoint import CheckpointManager, load_entry
from hybrid_vit_cascade_tpu_torch.training.schedules import make_optimizer
from hybrid_vit_cascade_tpu_torch.training.trainer import Trainer, stage_step
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parents[1]
S1, S2, S3 = 8, 16, 32
XR, E, HEADS = 64, 32, 4
LR = 1e-5
UPDATE_MIN_GRAD, UPDATE_TOL = 1e-6, 0.05  # _check_updates
RANKS = 2
TIMEOUT_S = 240


def _config(save_dir: str = "") -> Config:
    """configs/progressive_cascade.json at the scaled shapes; for ``fit``:
    one epoch a stage at batches 2 / 1 / 2 on 3 synthetic patients,
    validated on the same 3 (a batch of 2 split over the ranks, then 1 that
    each rank takes whole)."""
    cfg = Config.from_json(str(ROOT / "configs" / "progressive_cascade.json"))
    m = cfg.model
    m.voxel_dim, m.xray_feature_dim, m.dtype = E, E, "float32"
    m.stage_depths, m.stage_heads, m.stage_sizes = (1, 1, 1), (HEADS,) * 3, (S1, S2, S3)
    for n, s, b in zip((1, 2, 3), (S1, S2, S3), (2, 1, 2)):
        sc = cfg.training.stages[f"stage{n}"]
        sc.target_resolution, sc.num_epochs, sc.batch_size = (s, s, s), 1, b
    cfg.training.stages["stage1"].learning_rate = LR
    cfg.data.xray_size, cfg.data.synthetic, cfg.data.synthetic_patients = XR, True, 4
    cfg.data.train_split, cfg.data.val_split = 0.75, 0.0  # 3 train; validate on train
    cfg.checkpoints.save_dir = save_dir
    return cfg


def _no_dropout(model: torch.nn.Module) -> torch.nn.Module:
    for m in model.modules():
        if isinstance(m, Dropout):
            m.rate = 0.0
    return model


def _digest(tensors: dict) -> dict:
    return {k: hashlib.sha256(v.detach().contiguous().numpy().tobytes()).hexdigest()
            for k, v in tensors.items()}


# ------------------------------------------------- what each rank runs ---

def _bn_inputs():
    g = torch.Generator().manual_seed(3)
    return (torch.randn(2, 4, 5, 6, generator=g), torch.randn(2, 4, 5, 6, generator=g),
            torch.rand(4, generator=g) + 0.5, torch.randn(4, generator=g))


def _bn_run(x, w_out, weight, bias, group) -> dict:
    """One train-mode BatchNorm2d forward and the backward of Σ y·w_out."""
    bn = BatchNorm2d(4)
    with torch.no_grad():
        bn.weight.copy_(weight)
        bn.bias.copy_(bias)
    x = x.clone().requires_grad_(True)
    with mesh.use_data_group(group):
        y = bn(x, train=True)
        (y * w_out).sum().backward()
    return {"y": y.detach(), "x_grad": x.grad, "weight_grad": bn.weight.grad,
            "bias_grad": bn.bias.grad, "running_mean": bn.running_mean.clone(),
            "running_var": bn.running_var.clone()}


def _opt_grads(r: int):
    """Rank r's gradients of two parameters (the second has none on rank 1)."""
    g = torch.Generator().manual_seed(10 + r)
    return torch.randn(5, generator=g) * 3.0, (torch.randn(3, generator=g) if r == 0 else None)


def _step_run(setup: dict, index: int, group) -> dict:
    """The scaled cascade's train-mode stage-1 step on samples
    [index·b, (index + 1)·b) of the global batch under ``group``."""
    cfg = _config()
    model = _no_dropout(build_model(cfg))
    model.load_state_dict(setup["state_dict"], strict=True)
    state, step = stage_step(model, cfg, 1, MultiScaleLoss(), steps_per_epoch=1)
    per = setup["batch"]["drr_stacked"].shape[0] // group.size
    batch = {k: torch.from_numpy(v[index * per:(index + 1) * per])
             for k, v in setup["batch"].items()}
    with mesh.use_data_group(group):
        state, metrics = step(state, batch, torch.Generator().manual_seed(1))
    return {"loss": float(mesh.all_reduce_mean(metrics["total_loss"], group)),
            "grads": {n: p.grad.clone() for n, p in model.named_parameters()
                      if p.grad is not None},
            "state_dict": {k: v.clone() for k, v in model.state_dict().items()}}


def _fit_run(save_dir: Path) -> dict:
    """fit_cascade stage by stage; the parameters' digests after each stage,
    the entries written (by name), every entry restored."""
    writes = []
    real_write = CheckpointManager._write

    def counted(self, name, tree, meta):
        writes.append(f"{self.save_dir.name}/{name}")
        real_write(self, name, tree, meta)

    CheckpointManager._write = counted
    try:
        trainer = Trainer(_config(str(save_dir)), device="cpu")
        _no_dropout(trainer.model)
        after = {}
        for stage in ("stage1", "stage2", "stage3"):
            trainer.fit_cascade(stages=(stage,), progress=False)
            after[stage] = _digest(trainer.model.state_dict())
    finally:
        CheckpointManager._write = real_write
    entries = {f"{d.parent.name}/{d.name}": _digest({**load_entry(d)[0].get("state_dict", {})})
               for d in sorted(save_dir.glob("stage*/*")) if d.is_dir()}
    return {"writes": writes, "after": after, "entries": entries,
            "loggers": (trainer.csv is not None, trainer.jsonl is not None)}


def _rank_main(workdir: Path) -> None:
    mesh.init_from_env("cpu")
    r = mesh.rank()
    try:
        x, w_out, weight, bias = _bn_inputs()
        bn = _bn_run(x[r:r + 1], w_out[r:r + 1], weight, bias, mesh.data_group(RANKS))
        for k in ("weight_grad", "bias_grad"):  # the global loss is Σ over the ranks
            torch.distributed.all_reduce(bn[k])

        p = [torch.nn.Parameter(torch.zeros(5)), torch.nn.Parameter(torch.zeros(3))]
        opt = make_optimizer(p, 1e-3, 10, gradient_clip=0.5)
        p[0].grad, p[1].grad = _opt_grads(r)
        with mesh.use_data_group(mesh.data_group(RANKS)):
            opt.step()
        opt_out = [q.grad.clone() for q in p]

        step = _step_run(torch.load(workdir / "setup.pt", weights_only=False), r,
                         mesh.data_group(RANKS))
        fit = _fit_run(workdir / "fit")
        one = mesh.data_group(1)
        groups = {"one": (one.size, one.index, one.pg), "subgroups": dict(mesh._subgroups)}
    finally:
        mesh.shutdown()
    torch.save({"bn": bn, "opt": opt_out, "step": step, "fit": fit, "groups": groups},
               workdir / f"rank{r}.pt")


# --------------------------------------------------- launch and references ---

def _launch(argv, workdir: Path, name: str) -> subprocess.Popen:
    log = open(workdir / f"{name}.log", "w")
    env = {**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "2"}
    return subprocess.Popen(argv, cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT,
                            start_new_session=True)


def _wait(proc: subprocess.Popen, workdir: Path, name: str) -> tuple:
    """(rc, output) of a launch; killed with its process group (torchrun's
    ranks too) at TIMEOUT_S."""
    try:
        rc = proc.wait(timeout=TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()
        rc = "timeout"
    return rc, (workdir / f"{name}.log").read_text()


def _jax_step(jm, jv, batch):
    """The JAX stage-1 step, train mode, dropout off, on a 2-device data
    mesh: (loss, gradients, updated parameters, merged batch_stats)."""
    import jax
    import jax.numpy as jnp
    import optax

    from hybrid_vit_cascade_tpu.losses import MultiScaleLoss as JaxLoss
    from hybrid_vit_cascade_tpu.models import layers as jax_layers
    from hybrid_vit_cascade_tpu.parallel import data_sharding, make_mesh, replicated_sharding
    from hybrid_vit_cascade_tpu.training import make_optimizer as jax_make_optimizer
    from hybrid_vit_cascade_tpu.training.trainer import _merge_stats
    from hybrid_vit_cascade_tpu.training.trainer import resize_target as jax_resize_target

    jobj = JaxLoss()

    def loss_fn(params, batch_stats, b):
        pred, upd = jm.apply({"params": params, "batch_stats": batch_stats}, b["drr_stacked"],
                             max_stage=1, train=True, mutable=["batch_stats"],
                             rngs={"dropout": jax.random.PRNGKey(1)})
        ld = jobj(pred, jax_resize_target(b["ct_volume"], (S1,) * 3), stage=1)
        return ld["total_loss"], upd["batch_stats"]

    mesh_ = make_mesh(data=RANKS, model=1, devices=jax.devices()[:RANKS])
    repl, dsh = replicated_sharding(mesh_), data_sharding(mesh_)
    params = jax.device_put(jv["params"], repl)
    stats = jax.device_put(jv["batch_stats"], repl)
    b = {k: jax.device_put(jnp.asarray(v), dsh) for k, v in batch.items()}
    real = jax_layers.FastDropout.__call__
    jax_layers.FastDropout.__call__ = lambda self, x, deterministic: x
    try:
        with mesh_:
            (loss, new_stats), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
                params, stats, b)
    finally:
        jax_layers.FastDropout.__call__ = real
    cfg = _config()
    tx = jax_make_optimizer(LR, cfg.training.stages["stage1"].num_epochs,
                            cfg.training.weight_decay, cfg.training.gradient_clip,
                            trainable_prefixes=["stage1"], params=jv["params"])
    grads, stats = jax.tree.map(np.asarray, (grads, new_stats))
    params = jax.jit(lambda g, p: optax.apply_updates(p, tx.update(g, tx.init(p), p)[0]))(
        grads, jv["params"])
    return (float(loss), grads, jax.tree.map(np.asarray, params),
            jax.tree.map(np.asarray, _merge_stats(jv["batch_stats"], stats)))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Launch the ranks and the dryrun, compute the references meanwhile,
    then collect every rank's results."""
    import jax.numpy as jnp

    from hybrid_vit_cascade_tpu.models import ProgressiveCascadeModel as JaxCascade
    from hybrid_vit_cascade_tpu_torch import convert
    from tests.test_torch_models import jax_variables

    work = tmp_path_factory.mktemp("parallel")
    rng = np.random.default_rng(23)
    jm = JaxCascade(stage_sizes=(S1, S2, S3), voxel_dim=E, stage_depths=(1, 1, 1),
                    stage_heads=(HEADS,) * 3, xray_feature_dim=E, attn_impl="xla")
    tree, jv = jax_variables(jm, rng, jnp.zeros((1, 2, 1, XR, XR)), max_stage=3)
    batch = {"drr_stacked": (0.5 * rng.standard_normal((2, 2, 1, XR, XR))).astype(np.float32),
             "ct_volume": rng.uniform(-1, 1, (2, 1, S3, S3, S3)).astype(np.float32)}
    setup = {"state_dict": convert.cascade(tree), "batch": batch}
    torch.save(setup, work / "setup.pt")
    ranks = _launch([sys.executable, "-m", "torch.distributed.run", "--standalone",
                     "--nproc_per_node", str(RANKS), str(Path(__file__)), "--ranks", str(work)],
                    work, "ranks")
    dryrun = _launch([sys.executable, "-m", "hybrid_vit_cascade_tpu_torch.cli", "dryrun",
                      "--devices", str(RANKS), "--device", "cpu"], work, "dryrun")
    fit = _launch([sys.executable, str(Path(__file__)), "--one", str(work / "one")], work, "one")
    try:
        one = SimpleNamespace(bn=_bn_run(*_bn_inputs(), None),
                              step=_step_run(setup, 0, mesh.SOLO),
                              jax=_jax_step(jm, jv, batch), tree=tree)
    finally:
        done = {name: _wait(proc, work, name)
                for name, proc in (("ranks", ranks), ("dryrun", dryrun), ("one", fit))}
    for name in ("ranks", "one"):
        rc, text = done[name]
        assert rc == 0, f"{name}: rc {rc}\n{text[-4000:]}"
    one.log = [json.loads(line) for line in
               (work / "one" / "training_log.jsonl").read_text().splitlines()]
    got = [torch.load(work / f"rank{r}.pt", weights_only=False) for r in range(RANKS)]
    return SimpleNamespace(one=one, ranks=got, done=done, work=work, start=setup["state_dict"])


# ------------------------------------------------------------------ tests ---

class _Items:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"i": np.array([i])}


@pytest.mark.parametrize("world", [1, 2, 3, 4])
@pytest.mark.parametrize("batch", [4, 6, 12])
def test_loader_split_is_the_global_batch(world, batch):
    """Over k ranks the ranks' batch s, in rank order, is one process's batch
    s, and every rank yields as many batches; a validation batch that does
    not divide goes whole to every rank."""
    ds = _Items(29)
    k = mesh.data_axis(batch, world)
    one = [b["i"][:, 0].tolist() for b in DataLoader(ds, batch, seed=5, num_prefetch=0)]
    parts = [[b["i"][:, 0].tolist() for b in DataLoader(ds, batch, seed=5, num_prefetch=2,
                                                        rank=r, world=k)] for r in range(k)]
    assert all(len(p) == len(one) == 29 // batch for p in parts)
    for s, want in enumerate(one):
        assert sum((p[s] for p in parts), []) == want
        assert all(len(p[s]) == batch // k for p in parts)
    val = [[b["i"][:, 0].tolist() for b in DataLoader(ds, batch, shuffle=False, drop_last=False,
                                                      num_prefetch=0, rank=r, world=k)]
           for r in range(k)]
    for s in range(-(-29 // batch)):
        size = min(batch, 29 - s * batch)
        want = list(range(s * batch, s * batch + size))
        if k > 1 and size % k:
            assert all(v[s] == want for v in val)
        else:
            assert sum((v[s] for v in val), []) == want


@pytest.mark.parametrize("batch,world", [(8, 1), (8, 2), (8, 4), (8, 8), (2, 4), (1, 2),
                                         (1, 8), (6, 4), (6, 8), (3, 3), (4, 6), (12, 8)])
def test_data_axis_is_jax_mesh_for_batch(batch, world):
    """``data_axis`` takes as many ranks as the JAX trainer's
    ``_mesh_for_batch`` takes devices, on the 8 virtual CPU devices."""
    import jax

    from hybrid_vit_cascade_tpu.parallel import make_mesh
    from hybrid_vit_cascade_tpu.training.trainer import Trainer as JaxTrainer

    stub = SimpleNamespace(mesh=make_mesh(data=world, model=1, devices=jax.devices()[:world]))
    want = JaxTrainer._mesh_for_batch(stub, batch).shape["data"]
    assert mesh.data_axis(batch, world) == want


def test_without_a_group_everything_is_the_identity():
    t = torch.arange(3.0)
    assert mesh.world() == 1 and mesh.rank() == 0 and mesh.is_main()
    assert mesh.data_group(3) is mesh.SOLO and mesh.ambient_group() is None
    assert mesh.all_reduce_mean(t, mesh.SOLO) is t
    assert mesh.all_reduce_mean(t, mesh.SOLO, differentiable=True) is t
    p = torch.nn.Parameter(torch.ones(2))
    p.grad = torch.full((2,), 3.0)
    grad = p.grad
    mesh.all_reduce_grads([p], mesh.SOLO)
    assert p.grad is grad and torch.equal(grad, torch.full((2,), 3.0))
    assert mesh.broadcast_object({"a": 1}) == {"a": 1}
    assert mesh.init_from_env("cuda") == torch.device("cuda")  # no torchrun: nothing started


def test_synced_batchnorm_is_the_global_batch(runs):
    want = runs.one.bn
    for r, got in enumerate(x["bn"] for x in runs.ranks):
        for k in ("y", "x_grad"):
            torch.testing.assert_close(got[k], want[k][r:r + 1], rtol=1e-6, atol=1e-6, msg=k)
        for k in ("weight_grad", "bias_grad", "running_mean", "running_var"):
            torch.testing.assert_close(got[k], want[k], rtol=1e-6, atol=1e-6, msg=k)


def test_gradient_hook_averages_before_the_clip(runs):
    """The optimizer's pre-hooks: the ranks' mean (zeros for a missing
    gradient), then the global-norm clip to 0.5."""
    (a0, b0), (a1, _) = _opt_grads(0), _opt_grads(1)
    mean = [(a0 + a1) / 2, b0 / 2]
    scale = min(1.0, 0.5 / (float(torch.linalg.vector_norm(torch.cat(mean))) + 1e-6))
    assert scale < 1.0  # the clip acts
    for got in (x["opt"] for x in runs.ranks):
        for g, m in zip(got, mean):
            torch.testing.assert_close(g, m * scale, rtol=1e-6, atol=1e-7)


def test_step_matches_jax_on_a_data_mesh(runs):
    from hybrid_vit_cascade_tpu_torch import convert
    from tests.test_torch_training import GRAD_TOL, LOSS_TOL

    loss, grads, params, stats = runs.one.jax
    want_grads = convert.cascade({"params": grads, "batch_stats": runs.one.tree["batch_stats"]})
    want_sd = convert.cascade({"params": params, "batch_stats": stats})
    got = runs.ranks[0]["step"]
    np.testing.assert_allclose(got["loss"], loss, **LOSS_TOL)
    trainable = sorted(got["grads"])
    assert trainable and all(n.startswith("stage1.") for n in trainable)
    norm = float(torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(want_grads[n]) for n in trainable])))
    scale = min(1.0, _config().training.gradient_clip / (norm + 1e-6))
    for n in trainable:
        np.testing.assert_allclose(got["grads"][n].numpy(), want_grads[n].numpy() * scale,
                                   **GRAD_TOL, err_msg=n)
    moved = 0
    for k, w in want_sd.items():
        if "running" in k:
            np.testing.assert_allclose(got["state_dict"][k].numpy(), w.numpy(), **GRAD_TOL,
                                       err_msg=k)
            moved += not torch.equal(w, runs.start[k])
    assert moved >= 6  # the stage-1 encoder's three BatchNorms updated their statistics
    _check_updates(got["state_dict"], want_sd, {n: want_grads[n] * scale for n in trainable},
                   runs.start)


def _check_updates(got_sd: dict, want_sd: dict, want_grads: dict, start: dict) -> None:
    """The parameters' updates, θ_after − θ_before, against the reference's
    where the reference gradient is well above rounding (|g| ≥ UPDATE_MIN_GRAD):
    there AdamW's first step moves an element by lr·g/(|g| + 1e-8) ≈ ±lr, and
    the two updates agree within UPDATE_TOL·lr (θ's own rounding is ≤ 2.4e-7
    for |θ| < 2). Elsewhere, where a gradient is rounding noise and its sign
    may differ, an element moves by at most lr either way: within 2·lr. The
    elements held to UPDATE_TOL are most of them, and there the update is
    at least lr / 2, so a missing or wrong-signed step fails."""
    held = total = 0
    for n, g in want_grads.items():
        if n not in got_sd:
            continue
        d_got, d_want = got_sd[n] - start[n], want_sd[n] - start[n]
        big = g.abs() >= UPDATE_MIN_GRAD
        held, total = held + int(big.sum()), total + g.numel()
        err = (d_got - d_want).abs()
        assert float(err.max()) <= 2 * LR, n
        worst = float(err[big].max()) if bool(big.any()) else 0.0
        assert worst <= UPDATE_TOL * LR, (n, worst)
        assert bool((d_want[big].abs() >= LR / 2).all()), n
    assert held >= total / 2, (held, total)


def test_step_matches_one_process(runs):
    """The 2-rank step is one process's step on the global batch (fp32):
    the loss and the BatchNorm statistics at rtol 1e-5; the gradients at
    rtol 1e-5 with an absolute part of 1e-4 of the tensor's largest entry
    (two ranks' partial sums add in another order than one batch's) and
    1e-7 (a bias in front of a norm has a rounding-noise gradient); the
    parameters by their updates (``_check_updates``)."""
    want, got = runs.one.step, runs.ranks[0]["step"]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    assert sorted(got["grads"]) == sorted(want["grads"])
    for n, w in want["grads"].items():
        torch.testing.assert_close(got["grads"][n], w, rtol=1e-5,
                                   atol=1e-4 * float(w.abs().max()) + 1e-7, msg=n)
    for k, w in want["state_dict"].items():
        if "running" in k:
            torch.testing.assert_close(got["state_dict"][k], w, rtol=1e-5, atol=1e-7, msg=k)
    _check_updates(got["state_dict"], want["state_dict"], want["grads"], runs.start)
    for k, w in runs.ranks[1]["step"]["state_dict"].items():
        assert torch.equal(w, got["state_dict"][k]), k


def test_fit_writes_on_rank_zero_only(runs):
    r0, r1 = (x["fit"] for x in runs.ranks)
    assert r1["writes"] == [] and r1["loggers"] == (False, False)
    assert r0["loggers"] == (True, True)
    assert len(r0["writes"]) == len(set(r0["writes"]))  # each entry written once
    for n in (1, 2, 3):
        for e in ("latest", "latest_opt", "best_loss", "best_psnr", "best_ssim"):
            assert f"stage{n}/{e}" in r0["writes"], (n, e)
    assert r0["entries"] == r1["entries"] and len(r0["entries"]) == 15
    assert not list((runs.work / "fit").glob("stage*/*.tmp"))
    rows = (runs.work / "fit" / "training_log.csv").read_text().splitlines()
    assert len(rows) == 4  # the header and one row a stage


def test_fit_ranks_agree_after_every_stage(runs):
    """Bitwise, the batch-1 stage 2 (rank 1 idle, then broadcast) included."""
    r0, r1 = (x["fit"] for x in runs.ranks)
    for stage in ("stage1", "stage2", "stage3"):
        assert r0["after"][stage] == r1["after"][stage], stage
    assert "[trainer] batch 1 % 2 devices != 0 -> using 1 devices, 1 idle" in runs.done["ranks"][1]


def test_group_of_one_runs_no_collective(runs):
    """A stage at batch 1 trains on rank 0 alone: its group has no process
    group, so its collectives are the identity, and it is made once."""
    for r, got in enumerate(x["groups"] for x in runs.ranks):
        assert got["one"] == (1, 0 if r == 0 else -1, None)
        assert got["subgroups"] == {1: None}


def test_fit_logs_one_process_losses(runs):
    from tests.test_torch_training import LOSS_TOL

    got = [json.loads(line) for line in
           (runs.work / "fit" / "training_log.jsonl").read_text().splitlines()]
    assert [r["phase"] for r in got] == [r["phase"] for r in runs.one.log] == [
        "stage1", "stage2", "stage3"]
    for g, w in zip(got, runs.one.log):
        for k in ("train_loss", "loss", "psnr", "ssim"):
            np.testing.assert_allclose(g[k], w[k], **LOSS_TOL, err_msg=f"{g['phase']} {k}")


def test_cli_dryrun(runs):
    rc, text = runs.done["dryrun"]
    line = [t for t in text.splitlines() if t.startswith("dryrun(")]
    assert rc == 0 and line and line[-1].startswith("dryrun(2): OK, 2 gloo ranks on cpu"), text
    assert "ranks bitwise equal: True" in line[-1] and "model axis is not ported" in line[-1]


def _one_main(save_dir: Path) -> None:
    """The one-process reference of ``_fit_run``."""
    trainer = Trainer(_config(str(save_dir)), device="cpu")
    _no_dropout(trainer.model)
    trainer.fit_cascade(progress=False)


if __name__ == "__main__" and sys.argv[1:2] == ["--ranks"]:
    _rank_main(Path(sys.argv[2]))
if __name__ == "__main__" and sys.argv[1:2] == ["--one"]:
    _one_main(Path(sys.argv[2]))
