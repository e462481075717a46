"""The Orbax reader: ``convert_orbax.py`` (the one file that imports both
packages) turns a JAX run's checkpoint directory into the port's, with the
port-side half in ``convert.variables`` / ``convert.adamw_state`` and
``training.checkpoint.write_entry``.

(a) each of the six families, at the tests' scaled shapes, saved by the JAX
``CheckpointManager`` from conftest's 8-device mesh, converts to exactly
``convert.<family>`` of its variables and loads ``strict=True`` into the
port's ``build_model``; the cascade's and ``direct_vit``'s reconstruct agree
with JAX's within tests/test_torch_serving.py's 2e-4. (b) optax's AdamW
state after two updates, converted, then one more update in both packages
on the same gradient: parameters within 1e-6 relative (fp32), equal step and
schedule step, ``lr`` equal to the JAX schedule at the count; for a staged
cascade stage 2 and for the single-model chain; no model step is compiled.
(c) a JAX cascade run (stage 1 complete, stage 2 mid-stage, best records,
an ``epoch_0001`` entry, a stale ``latest.tmp``) converted by the command's
``main`` and resumed by the port's ``fit_cascade``; the root of a
non-progressive diffusion run over a two-stage ladder, which holds the
ladder's last stage alone (JAX ``fit_diffusion``), written by the JAX
``Trainer``, converted, loaded into the port's ladder bitwise JAX's arrays
and resumed by the port's ``fit_diffusion``. (d) each
refusal raises and writes nothing. (e) a restored optimizer keeps its
implementation flags (``fused``, ``foreach``)."""

import json
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec

import convert_orbax
from hybrid_vit_cascade_tpu.config import Config as JaxConfig
from hybrid_vit_cascade_tpu.inference import infer as jax_infer
from hybrid_vit_cascade_tpu.training import schedules as jax_schedules
from hybrid_vit_cascade_tpu.training.checkpoint import CheckpointManager as JaxCheckpoints
from hybrid_vit_cascade_tpu.training.trainer import build_model as jax_build_model
from hybrid_vit_cascade_tpu_torch import convert
from hybrid_vit_cascade_tpu_torch.config import Config
from hybrid_vit_cascade_tpu_torch.inference.infer import InferenceEngine, build_model
from hybrid_vit_cascade_tpu_torch.training.checkpoint import load_entry, load_optimizer_state
from hybrid_vit_cascade_tpu_torch.training.schedules import apply_stage_freeze, make_optimizer
from hybrid_vit_cascade_tpu_torch.training.trainer import Trainer, cascade_trainable
from tests.test_torch_models import jax_variables
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

XR, E, HEADS = 64, 32, 4
TOL = dict(rtol=2e-4, atol=2e-4)  # tests/test_torch_serving.py's
OPT_RTOL = 1e-6


def _configs(family: str, **training):
    """(port Config, JAX Config) of ``family`` at the tests' scaled shapes:
    the cascade 8³ → 16³ → 32³, ``direct_vit`` 32³, the decoders with
    24-channel X-ray features (the B200's take none), the diffusion ladder's
    one 16³ stage; 64² X-rays, E = 32, fp32, synthetic data."""
    out = []
    for cls in (Config, JaxConfig):
        cfg = cls()
        m = cfg.model
        m.family, m.dtype, m.voxel_dim, m.xray_feature_dim = family, "float32", E, E
        if family == "cascade":
            m.stage_depths, m.stage_heads, m.stage_sizes = (1, 1, 1), (HEADS,) * 3, (8, 16, 32)
            m.attn_impl = "xla"
        elif family in ("direct_vit", "diffusion"):
            m.volume_size = (32,) * 3 if family == "direct_vit" else (16,) * 3
            m.vit_depth, m.num_heads, m.attn_impl = 1, HEADS, "xla"
        else:
            m.xray_feature_dim = 24
        cfg.data.xray_size, cfg.data.synthetic, cfg.data.synthetic_patients = XR, True, 2
        cfg.data.train_split, cfg.data.val_split = 1.0, 0.0
        for k, v in training.items():
            setattr(cfg.training, k, v)
        out.append(cfg)
    return out


FAMILIES = ("cascade", "direct_vit", "direct128_h200", "direct256_h200", "direct256_b200",
            "diffusion")
_TREES: dict = {}


def family_tree(family: str):
    """(numpy variables, JAX model, JAX Config) of the scaled family, the
    variables drawn from numpy with flax's init traced for shapes only."""
    if family not in _TREES:
        _, jcfg = _configs(family)
        jm = jax_build_model(jcfg)
        xr = jnp.zeros((1, 2, 1, XR, XR))
        rng = np.random.default_rng(FAMILIES.index(family))
        if family == "cascade":
            tree, _ = jax_variables(jm, rng, xr, max_stage=3)
        elif family == "diffusion":
            size = tuple(jcfg.model.volume_size)
            tree, _ = jax_variables(jm, rng, jnp.zeros((1, 1, *size)), xr, "stage1_low",
                                    jax.random.PRNGKey(0))
        else:
            tree, _ = jax_variables(jm, rng, xr)
        _TREES[family] = (tree, jm, jcfg)
    return _TREES[family]


def on_mesh(tree):
    """``tree`` on conftest's 8 virtual devices: each leaf split over the
    mesh along its first axis of a multiple of 8, the others replicated (a
    replicated leaf with such an axis would be saved in eight slices, each a
    compile of its own: seconds a family)."""
    mesh = Mesh(np.array(jax.devices()).reshape(-1), ("data",))
    assert mesh.size == 8

    def put(leaf):
        leaf = np.asarray(leaf)
        axes = [i for i, n in enumerate(leaf.shape) if n % 8 == 0]
        spec = PartitionSpec(*([None] * axes[0] + ["data"])) if axes else PartitionSpec()
        return jax.device_put(leaf, NamedSharding(mesh, spec))

    return jax.tree.map(put, tree)


def _np(tree):
    """An optax state's leaves as numpy, optax's MaskedNode as None (as the
    converter's Orbax restore gives them)."""
    if isinstance(tree, optax.MaskedNode):
        return None
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return np.asarray(tree)


# ------------------------------------------------------ (a) every family ---

@pytest.fixture(scope="module")
def converted(tmp_path_factory):
    """A JAX save_dir ``jax_<family>`` a family with its ``latest`` entry,
    saved from the 8-device mesh, each converted to ``port_<family>``."""
    root = tmp_path_factory.mktemp("families")
    lines = []
    for family in FAMILIES:
        tree, _, jcfg = family_tree(family)
        JaxCheckpoints(str(root / f"jax_{family}")).save(
            on_mesh(tree), epoch=0, metrics={}, config=jcfg.to_dict())
        convert_orbax.convert_run(root / f"jax_{family}", root / f"port_{family}",
                                  log=lines.append)
    return root, lines


@pytest.mark.parametrize("family", FAMILIES)
def test_family_converts_exactly(converted, family):
    root, lines = converted
    tree, _, jcfg = family_tree(family)
    entry = root / f"port_{family}" / "latest"
    got, meta = load_entry(entry)
    want = convert.variables(family, tree)
    assert sorted(got["state_dict"]) == sorted(want)
    assert all(torch.equal(got["state_dict"][k], want[k]) for k in want)
    assert meta["config"]["model"]["family"] == family and meta["epoch"] == 0
    cfg = Config.from_dict(meta["config"])
    model = build_model(cfg)
    model.load_state_dict(got["state_dict"], strict=True)
    params = dict(model.named_parameters())
    assert f"latest: {family}, {sum(v.numel() for k, v in want.items() if k in params)} " \
        f"parameters, 0 moments, epoch 0" in lines


@pytest.mark.parametrize("family", ["cascade", "direct_vit"])
def test_converted_reconstruct_matches_jax(converted, family):
    root, _ = converted
    xr = np.random.default_rng(3).uniform(-1, 1, (1, 2, 1, XR, XR)).astype(np.float32)
    want = jax_infer.InferenceEngine(str(root / f"jax_{family}" / "latest"))
    got = InferenceEngine(root / f"port_{family}" / "latest", device="cpu")
    kw = {"max_stage": 3} if family == "cascade" else {}
    w = np.asarray(want.reconstruct(jnp.asarray(xr), **kw))
    g = got.reconstruct(torch.from_numpy(xr), **kw).numpy()
    assert g.shape == w.shape
    np.testing.assert_allclose(g, w, **TOL)


# ------------------------------------------------- (b) the optimizer state ---

_LEAF = {"params": {"a": {"kernel": np.zeros((3, 4), np.float32)}, "b": np.zeros(4, np.float32)}}
BAD_CONVERTERS = {  # each breaks what the moments' conversion rests on
    "scales": lambda v: {"a": convert._t(v["params"]["a"]["kernel"]) * 2,
                         "b": convert._t(v["params"]["b"])},
    "mixes": lambda v: {"a": convert._t(v["params"]["a"]["kernel"]),
                        "b": convert._t(v["params"]["b"]) + convert._t(v["params"]["a"]["kernel"])[0]},
    "slices": lambda v: {"a": convert._t(v["params"]["a"]["kernel"])[:2],
                         "b": convert._t(v["params"]["b"])},
}


@pytest.mark.parametrize("how", sorted(BAD_CONVERTERS))
def test_leaf_sources_refuses_a_converter_that_is_no_permutation(monkeypatch, how):
    """``leaf_sources`` passes a transpose and refuses a converter that
    scales, mixes two leaves or drops values: the moments would not map."""
    monkeypatch.setitem(convert.FAMILIES, "toy", lambda v: {
        "a": convert._t(v["params"]["a"]["kernel"]).T.contiguous(),
        "b": convert._t(v["params"]["b"])})
    assert convert.leaf_sources("toy", _LEAF) == {"a": ("params", "a", "kernel"),
                                                  "b": ("params", "b")}
    monkeypatch.setitem(convert.FAMILIES, "toy", BAD_CONVERTERS[how])
    with pytest.raises(AssertionError, match="mixes|permutation"):
        convert.leaf_sources("toy", _LEAF)


def _grads(params, seed: int):
    """A seeded gradient of ``params``' shapes, global norm ~0.1 (under the
    clip: clip_by_global_norm and clip_grad_norm_ round differently)."""
    rng = np.random.default_rng(seed)
    leaves, treedef = jax.tree.flatten(params)
    n = sum(x.size for x in leaves)
    return jax.tree.unflatten(treedef, [
        jnp.asarray(rng.standard_normal(x.shape).astype(np.float32) * (0.1 / np.sqrt(n)))
        for x in leaves])


_TX: dict = {}


def optax_tx(params, lr: float, total: int, warmup: int = 0, prefixes=None):
    """The JAX trainer's optimizer (``make_optimizer``, its weight decay and
    clip) and its update jitted, one compile per optimizer and tree."""
    key = (lr, total, warmup, tuple(prefixes or ()), jax.tree.structure(params))
    if key not in _TX:
        tx = jax_schedules.make_optimizer(lr, total, 0.01, 1.0, warmup,
                                          trainable_prefixes=prefixes,
                                          params=params if prefixes else None)
        _TX[key] = tx, jax.jit(tx.update)
    return _TX[key]


# (family, trainable prefixes, lr, total steps, warmup): a staged cascade
# stage 2, and the single-model chain with a warmup
OPT_CASES = {"cascade_stage2": ("cascade", cascade_trainable(2), 5e-5, 3, 0),
             "direct_vit": ("direct_vit", None, 1e-4, 8, 2)}


@pytest.mark.parametrize("case", sorted(OPT_CASES))
def test_adamw_state_continues_optax(tmp_path, case):
    family, prefixes, lr, total, warmup = OPT_CASES[case]
    tree, _, jcfg = family_tree(family)
    params = jax.tree.map(jnp.asarray, tree["params"])
    t = jcfg.training
    assert (t.weight_decay, t.gradient_clip) == (0.01, 1.0)
    tx, update = optax_tx(params, lr, total, warmup, prefixes)
    state = tx.init(params)
    for i in range(2):
        updates, state = update(_grads(params, i), state, params)
        params = optax.apply_updates(params, updates)
    # the state through Orbax and the converter's reader, as a run's latest_opt
    JaxCheckpoints(str(tmp_path)).save(
        {"params": params, "batch_stats": tree.get("batch_stats", {})}, 0, {},
        opt={"opt_state": state, "step": jnp.asarray(2, jnp.int32)})
    opt_tree, _ = convert_orbax.restore(tmp_path, "latest_opt")
    adam, sched = convert_orbax.adam_chain(opt_tree["opt_state"])
    assert int(adam["count"]) == int(sched["count"]) == 2

    cfg, _ = _configs(family)
    model = build_model(cfg)
    variables = {**tree, "params": jax.tree.map(np.asarray, params)}
    model.load_state_dict(convert.variables(family, variables), strict=True)
    trainable = (apply_stage_freeze(model, prefixes) if prefixes else list(model.parameters()))
    opt = make_optimizer(trainable, lr, total, t.weight_decay, t.gradient_clip, warmup)
    saved = convert.adamw_state(family, variables, adam["mu"], adam["nu"], int(adam["count"]),
                                int(sched["count"]), int(opt_tree["step"]), model, opt)
    assert saved["step"] == 2
    load_optimizer_state(opt, saved["optimizer"])
    schedule = (optax.warmup_cosine_decay_schedule(0.0, lr, warmup, max(total, warmup + 1))
                if warmup else optax.cosine_decay_schedule(lr, max(total, 1)))
    assert opt.param_groups[0]["lr"] == pytest.approx(float(schedule(2)), rel=1e-6)

    grads = _grads(params, 2)
    updates, state = update(grads, state, params)
    params = optax.apply_updates(params, updates)
    g_sd = convert.variables(family, {**tree, "params": jax.tree.map(np.asarray, grads)})
    for name, p in model.named_parameters():
        p.grad = g_sd[name].clone() if p.requires_grad else None
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    opt.step()
    want = convert.variables(family, {**tree, "params": jax.tree.map(np.asarray, params)})
    moved = 0
    for name, p in model.named_parameters():
        w, g = want[name].numpy(), p.detach().numpy()
        np.testing.assert_allclose(g, w, rtol=OPT_RTOL, atol=OPT_RTOL * np.abs(w).max(),
                                   err_msg=name)
        if p.requires_grad:
            moved += not torch.equal(p.detach(), before[name])
        else:
            assert torch.equal(p.detach(), before[name]), name  # frozen: not even decayed
    assert moved == len(trainable)
    chain = state.inner_states["train"].inner_state if prefixes else state
    adam3, sched3 = chain[1][0], chain[1][2]
    assert int(adam3.count) == int(sched3.count) == 3
    assert {int(opt.state[p]["step"]) for p in trainable} == {3}
    assert opt.param_groups[0]["schedule_step"] == 3
    assert opt.param_groups[0]["lr"] == pytest.approx(float(schedule(3)), rel=1e-6)


# ------------------------------------------------ (c) a whole cascade run ---

def _staged_state(params, prefixes, lr: float, total: int, updates: int):
    """The JAX trainer's optax state for a stage after ``updates`` steps
    (jitted: the one compile (b)'s stage 2 shares)."""
    tx, update = optax_tx(params, lr, total, prefixes=prefixes)
    state = tx.init(params)
    for i in range(updates):
        state = update(_grads(params, 10 + i), state, params)[1]
    return state


def test_cascade_run_converts_and_resumes(tmp_path, capsys):
    """JAX ``fit_cascade``'s layout, written by its CheckpointManager: stage 1
    complete (one epoch of one), stage 2 after epochs 0 and 1 of 3 (its
    ``epoch_0001`` entry at save_every 2), each stage's best records and
    latest_opt, a stale ``latest.tmp``, the run's CSV log. The command
    converts it; the port's fit_cascade then skips stage
    1 with its best_psnr weights and runs stage 2's epoch 2 alone, from the
    converted optimizer state, keeping stage 2's best records."""
    from hybrid_vit_cascade_tpu.config import StageConfig as JaxStage
    from hybrid_vit_cascade_tpu.utils.logging import CSVLogger as JaxCSV
    from hybrid_vit_cascade_tpu_torch.config import StageConfig

    tree, _, _ = family_tree("cascade")
    cfg, jcfg = _configs("cascade")
    for c, stage in ((cfg, StageConfig), (jcfg, JaxStage)):
        c.training.stages = {"stage1": stage(1, 2, 1e-4, (8, 8, 8)),
                             "stage2": stage(3, 2, 5e-5, (16, 16, 16)),
                             "stage3": stage(1, 2, 2e-5, (32, 32, 32))}
        c.checkpoints.save_every = 2
    jax_dir, port_dir = tmp_path / "jax", tmp_path / "port"
    jcfg.checkpoints.save_dir, cfg.checkpoints.save_dir = str(jax_dir), str(port_dir)
    params = jax.tree.map(jnp.asarray, tree["params"])
    stats = tree["batch_stats"]
    csv = JaxCSV(str(jax_dir / "training_log.csv"))
    s1 = JaxCheckpoints(str(jax_dir / "stage1"), save_every=2)
    s1.save({"params": params, "batch_stats": stats}, 0, {"psnr": 11.0}, config=jcfg.to_dict(),
            opt={"opt_state": _staged_state(params, ["stage1"], 1e-4, 1, 0),
                 "step": jnp.asarray(0, jnp.int32)})
    csv.log(epoch=0, phase="stage1", loss=0.5)
    s2 = JaxCheckpoints(str(jax_dir / "stage2"), save_every=2)
    stage2 = cascade_trainable(2)
    for epoch, psnr in ((0, 12.0), (1, 11.5)):
        s2.save({"params": params, "batch_stats": stats}, epoch,
                {"psnr": psnr},
                config=jcfg.to_dict(),
                opt={"opt_state": _staged_state(params, stage2, 5e-5, 3, epoch + 1),
                     "step": jnp.asarray(epoch + 1, jnp.int32)})
        csv.log(epoch=epoch, phase="stage2", loss=0.4 + epoch)
    (jax_dir / "stage2" / "latest.tmp").mkdir()
    (jax_dir / "stage2" / "latest.tmp" / "partial").write_text("a write cut short")

    assert convert_orbax.main(["--from", str(jax_dir), "--to", str(port_dir)]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[-1]) == {"converted": str(port_dir)}
    want = ["stage1/best_psnr", "stage1/latest", "stage1/latest_opt", "stage2/best_psnr",
            "stage2/epoch_0001", "stage2/latest", "stage2/latest_opt"]
    assert [line.split(":")[0] for line in lines[:-1]] == want
    assert lines[want.index("stage2/latest_opt")].endswith(" moments, step 2")
    assert not (port_dir / "stage2" / "latest.tmp").exists()
    for f in ("stage1/best_records.json", "stage2/best_records.json", "training_log.csv"):
        assert (port_dir / f).read_bytes() == (jax_dir / f).read_bytes(), f

    tr = Trainer(cfg, device="cpu")
    tr.fit_cascade(stages=("stage1", "stage2"))
    out = capsys.readouterr().out
    assert "[stage1] complete at epoch 0; skipping" in out
    assert [line.split(":")[0] for line in out.splitlines() if line.startswith("[stage2] epoch")] \
        == ["[stage2] epoch 2"]
    rows = [r.split(",") for r in (port_dir / "training_log.csv").read_text().splitlines()[1:]]
    assert [(r[0], r[1]) for r in rows] == [("0", "stage1"), ("0", "stage2"), ("1", "stage2"),
                                            ("2", "stage2")]
    opt, meta = load_entry(port_dir / "stage2" / "latest_opt")
    assert meta["epoch"] == 2 and opt["step"] == 3
    assert opt["optimizer"]["param_groups"][0]["schedule_step"] == 3
    assert {float(s["step"]) for s in opt["optimizer"]["state"].values()} == {3.0}
    best = json.loads((port_dir / "stage2" / "best_records.json").read_text())
    assert best["psnr"] >= 12.0
    carried = load_entry(port_dir / "stage1" / "best_psnr")[0]["state_dict"]
    now = tr.model.state_dict()
    assert all(torch.equal(now[k], v) for k, v in carried.items() if k.startswith("stage1."))


# the two-stage ladder both trainers build for (c)'s diffusion run, in place
# of diffusion_stage_configs (which gives a volume under 64³ one stage)
TINY_LADDER = tuple(dict(name=n, volume_size=(s, s, s), voxel_dim=E, vit_depth=1,
                         num_heads=HEADS, use_depth_lifting=True, use_physics_loss=True)
                    for n, s in (("lo", 4), ("hi", 8)))


def test_fit_diffusion_root_converts_and_resumes(tmp_path, monkeypatch, capsys):
    """JAX ``fit_diffusion`` (``diffusion_progressive`` off) over a two-stage
    ladder trains and saves the last stage alone at the run's root. The JAX
    Trainer writes that root (its epoch loop stands in for one epoch's save:
    the stage's variables, optimizer state and step as its ``_run_epochs``
    saves them); the command converts it to the stage's keys alone; they
    load into the port's ladder (``load_ladder_state``) bitwise the JAX
    arrays, the other stage untouched; the port's ``fit_diffusion`` resumes
    from it at epoch 1 with the converted optimizer state."""
    from hybrid_vit_cascade_tpu.training import trainer as jax_trainer
    from hybrid_vit_cascade_tpu_torch.models.diffusion import load_ladder_state
    from hybrid_vit_cascade_tpu_torch.training import trainer as port_trainer

    for mod in (jax_trainer, port_trainer):
        monkeypatch.setattr(mod, "diffusion_stage_configs", lambda m: TINY_LADDER)
    cfg, jcfg = _configs("diffusion", num_epochs=2, batch_size=2, diffusion_sample_steps=2)
    jax_dir, port_dir = tmp_path / "jax", tmp_path / "port"
    for c, d in ((cfg, port_dir), (jcfg, jax_dir)):
        c.model.volume_size = (8, 8, 8)
        c.checkpoints.save_dir, c.checkpoints.save_every = str(d), 0

    def one_epoch(self, state, train_step, eval_step, *a, **kw):
        self.ckpt.save({"params": state.params, "batch_stats": state.batch_stats}, 0,
                       {"loss": 1.0, "psnr": 10.0, "ssim": 0.5}, config=self.cfg.to_dict(),
                       opt={"opt_state": state.opt_state, "step": state.step})
        self._saved = jax.tree.map(np.asarray, {"params": state.params,
                                                "batch_stats": state.batch_stats})
        return {}
    monkeypatch.setattr(jax_trainer.Trainer, "_run_epochs", one_epoch)
    jtr = jax_trainer.Trainer(jcfg)
    jtr.fit_diffusion(progress=False)
    jtree = jtr._saved
    assert sorted(jtree["params"]) == ["Dense_0", "Dense_1", "prev_proj_hi", "stage_hi",
                                       "xray_encoder"]

    capsys.readouterr()
    assert convert_orbax.main(["--from", str(jax_dir), "--to", str(port_dir)]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    entries = [line.split(":")[0] for line in lines[:-1]]
    assert entries[-2:] == ["latest", "latest_opt"] and set(entries[:-2]) <= {
        "best_loss", "best_psnr", "best_ssim"}
    got = load_entry(port_dir / "latest")[0]["state_dict"]
    want = convert.variables("diffusion", jtree)
    assert sorted(got) == sorted(want)
    assert all(torch.equal(got[k], want[k]) for k in want)
    model = build_model(cfg)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    assert load_ladder_state(model, got) == ["hi"]
    now = model.state_dict()
    assert all(torch.equal(now[k], want[k]) for k in want)
    assert all(torch.equal(now[k], before[k]) for k in now if k not in want)
    assert any(k.startswith("stage_lo.") for k in now) and not any(
        k.startswith(("stage_lo.", "prev_proj_lo")) for k in want)
    with pytest.raises(RuntimeError, match="alone must hold every key"):
        load_ladder_state(model, {k: v for k, v in got.items() if not k.startswith("Dense_0")})

    tr = Trainer(cfg, device="cpu")
    tr.fit_diffusion(progress=False)
    rows = [json.loads(r) for r in (port_dir / "training_log.jsonl").read_text().splitlines()]
    assert [(r["epoch"], r["phase"]) for r in rows] == [(1, "diffusion_hi")]
    opt, meta = load_entry(port_dir / "latest_opt")
    assert meta["epoch"] == 1 and opt["step"] == 1 + int(np.asarray(jtr_step(jax_dir)))


def jtr_step(run: Path):
    """The step the JAX run's latest_opt holds."""
    opt_tree, _ = convert_orbax.restore(run, "latest_opt")
    return opt_tree["step"]


# ------------------------------------------------------------ (d) refusals ---

@pytest.fixture(scope="module")
def direct_run(tmp_path_factory):
    """A JAX save_dir holding the scaled direct_vit's ``latest``."""
    root = tmp_path_factory.mktemp("refusals") / "jax"
    tree, _, jcfg = family_tree("direct_vit")
    JaxCheckpoints(str(root)).save(tree, epoch=4, metrics={}, config=jcfg.to_dict())
    return root


def _edit_config(run: Path, **model):
    meta = json.loads((run / "latest" / "meta.json").read_text())
    meta["config"]["model"].update(model)
    (run / "latest" / "meta.json").write_text(json.dumps(meta))


def _add_opt(run: Path, tx_of_params):
    params = jax.tree.map(jnp.asarray, family_tree("direct_vit")[0]["params"])
    JaxCheckpoints(str(run))._write("latest_opt", {"opt_state": tx_of_params(params).init(params),
                                                   "step": jnp.asarray(0, jnp.int32)}, {})


REFUSALS = {
    "unknown_family": (lambda run: _edit_config(run, family="mystery"), "unknown model family"),
    "strict_load": (lambda run: _edit_config(run, voxel_dim=48), "does not load"),
    "optimizer_shape": (lambda run: _add_opt(run, lambda p: optax.adam(1e-3)),
                        "optimizer tree of another shape"),
    "trainable_set": (lambda run: _add_opt(run, lambda p: jax_schedules.make_optimizer(
        1e-4, 4, trainable_prefixes=["xray_encoder"], params=p)),
        r"trainable set .* none for \['initial_volume'"),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_refusal_writes_nothing(direct_run, tmp_path, case):
    edit, message = REFUSALS[case]
    run = tmp_path / "jax"
    shutil.copytree(direct_run, run)
    edit(run)
    with pytest.raises(convert_orbax.ConversionError, match=message):
        convert_orbax.convert_run(run, tmp_path / "port")
    assert sorted(p.name for p in tmp_path.iterdir()) == ["jax"]


# ---------------------------------------------------- (e) the device flags ---

def test_restore_keeps_the_live_optimizers_flags():
    """A state written by a CPU optimizer (fused False, foreach None) loaded
    into a fused one: ``load_state_dict`` alone takes the file's flags; the
    port's restore keeps the live ones and takes the rest from the file."""
    p = torch.nn.Parameter(torch.arange(6.0))
    cpu = make_optimizer([p], 1e-3, 10, weight_decay=0.05)
    p.grad = torch.ones(6)
    cpu.step()
    saved = cpu.state_dict()
    assert saved["param_groups"][0]["fused"] is False

    def card():
        q = torch.nn.Parameter(p.detach().clone())
        return q, make_optimizer([q], 1e-3, 10, weight_decay=0.0)

    q, plain = card()
    plain.param_groups[0].update(fused=True, foreach=False)
    plain.load_state_dict(saved)
    assert plain.param_groups[0]["fused"] is False  # the fault the restore repairs
    q, live = card()
    live.param_groups[0].update(fused=True, foreach=False)
    load_optimizer_state(live, saved)
    g = live.param_groups[0]
    assert g["fused"] is True and g["foreach"] is False
    assert g["weight_decay"] == 0.05 and g["schedule_step"] == 1
    assert g["lr"] == cpu.param_groups[0]["lr"]
    assert torch.equal(live.state[q]["exp_avg"], cpu.state[p]["exp_avg"])
    q.grad = torch.ones(6)
    live.step()  # the fused implementation runs on the restored state
    assert float(live.state[q]["step"]) == 2.0 and g["schedule_step"] == 2


def test_chip_smoke_jax_layout_is_the_jax_tree():
    """``chip_smoke.py`` [20] stands in for a restored JAX entry with
    ``cascade_jax_layout`` (the card's machine has no JAX): on the scaled
    cascade it gives back the JAX tree itself, every name, shape and value."""
    import chip_smoke

    tree, _, _ = family_tree("cascade")
    got = chip_smoke.cascade_jax_layout(convert.cascade(tree))
    want = jax.tree_util.tree_flatten_with_path(tree)[0]
    have = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    assert sorted(map(str, have)) == sorted(str(p) for p, _ in want)
    for path, leaf in want:
        np.testing.assert_array_equal(have[path], np.asarray(leaf, np.float32), err_msg=str(path))
