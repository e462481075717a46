#!/usr/bin/env python3
"""Convert a JAX run's checkpoint directory into the PyTorch port's.

    python convert_orbax.py --from <JAX save_dir> --to <port save_dir>

Runs on a host with JAX, Orbax and PyTorch (a CPU is enough; every array is
restored onto one CPU device, whatever mesh wrote it). This is the one file
of the repository that imports both ``hybrid_vit_cascade_tpu`` and
``hybrid_vit_cascade_tpu_torch``; the port itself never imports JAX.

It walks every layout the JAX ``Trainer`` writes: the root of ``save_dir``
(``fit``), ``stage1/`` to ``stage3/`` (``fit_cascade``) and
``diffusion_{name}/`` (``fit_diffusion_cascade``). In each it converts the
entries ``latest``, ``best_loss``, ``best_psnr``, ``best_ssim`` and
``epoch_NNNN`` (Orbax ``{"params", "batch_stats"}`` trees → the port's
``{"state_dict"}`` through ``convert.variables`` for the family named in the
entry's embedded config) and ``latest_opt`` (optax's AdamW state → the port's
``{"optimizer", "step"}`` through ``convert.adamw_state``), each written with
its ``meta.json`` by ``write_entry``; it copies ``best_records.json``,
``meta.json``, ``training_log.csv`` and ``training_log.jsonl`` as they are
and skips ``*.tmp``. The port's ``cli infer`` / ``eval`` / ``inspect`` /
``diagnose`` / ``export`` / ``transfer`` then read the converted entries, and
``cli train`` resumes the run: same epoch, schedule position and best
records, completed stages skipped.

Each entry's arrays are restored with the JAX package's
``CheckpointManager.restore`` against a template read from the entry's own
Orbax metadata, each leaf a ``ShapeDtypeStruct`` on one CPU device: the
file's own tree (optax's masked leaves included, which name the trainable
set) restores on any host, from any mesh.

The root of a diffusion run that did not train progressively (JAX
``fit_diffusion``) holds the ladder's last stage alone, with the shared
encoder and time MLP: its entries convert to that stage's keys, which
``models.diffusion.load_ladder_state`` loads strict into the port's ladder
(the port's ``fit_diffusion`` resumes from them through it).

It refuses, writing nothing: an unknown model family; a tree whose names or
shapes do not load ``strict=True`` into the port's ``build_model`` of the
embedded config (a diffusion tree: the whole ladder or one stage of it, the
root's the last stage); an optimizer tree of another shape than the two the JAX
``make_optimizer`` builds; and an optimizer state whose trainable set is not
the port's rule for its directory. Output is written into ``<to>.converting``
and renamed to ``<to>`` at the end. One line is printed per entry.
"""

from __future__ import annotations

import argparse
import json
import re
import shutil
import sys
from pathlib import Path

ENTRY = re.compile(r"latest|best_loss|best_psnr|best_ssim|epoch_\d{4}")
COPIED = ("best_records.json", "meta.json", "training_log.csv", "training_log.jsonl")


class ConversionError(ValueError):
    """A checkpoint directory that cannot be converted as it stands."""


def restore(directory: Path, name: str):
    """(numpy tree, meta) of one Orbax entry, restored onto one CPU device
    through the JAX package's ``CheckpointManager``."""
    import jax
    import numpy as np
    import orbax.checkpoint as ocp
    from jax.sharding import SingleDeviceSharding

    from hybrid_vit_cascade_tpu.training.checkpoint import CheckpointManager

    item = ocp.StandardCheckpointer().metadata((directory / name).absolute()).item_metadata
    cpu = SingleDeviceSharding(jax.devices("cpu")[0])
    template = jax.tree.map(lambda m: jax.ShapeDtypeStruct(m.shape, m.dtype, sharding=cpu),
                            getattr(item, "tree", item))
    tree, meta = CheckpointManager(str(directory)).restore(name, template)
    return jax.tree.map(np.asarray, tree), meta


def adam_chain(opt_state):
    """(ScaleByAdamState, ScaleByScheduleState) of a restored optax state,
    each as Orbax restores a named tuple (a dict of its fields), from either
    shape the JAX ``make_optimizer`` builds: the bare chain ``(clip,
    (adam, decay, schedule))``, or with ``trainable_prefixes`` the same chain
    under ``PartitionState.inner_states["train"]`` and ``MaskedState``."""
    chain = opt_state
    if isinstance(chain, dict):
        groups = chain.get("inner_states") if set(chain) == {"inner_states"} else None
        if not isinstance(groups, dict) or set(groups) != {"train", "freeze"} \
                or not isinstance(groups["train"], dict) or set(groups["train"]) != {"inner_state"}:
            raise ConversionError(f"optimizer tree of another shape: {sorted(chain)}")
        chain = groups["train"]["inner_state"]
    ok = (isinstance(chain, (list, tuple)) and len(chain) == 2 and chain[0] is None
          and isinstance(chain[1], (list, tuple)) and len(chain[1]) == 3)
    if ok:
        adam, decay, schedule = chain[1]
        ok = (isinstance(adam, dict) and set(adam) == {"count", "mu", "nu"} and decay is None
              and isinstance(schedule, dict) and set(schedule) == {"count"})
    if not ok:
        raise ConversionError("optimizer tree of another shape than clip_by_global_norm + "
                              "adamw (bare or under the stage partition)")
    return adam, schedule


def _stage_optimizer(rel: str, cfg, model):
    """The port's optimizer for directory ``rel`` of a run of ``cfg``, over
    ``model``'s parameters as the port's Trainer builds it there: its
    trainable set and hyperparameters. Its schedule's length is not in the
    checkpoint (optax keeps the count only); the resuming Trainer's own
    optimizer sets the learning rate at the saved count."""
    from hybrid_vit_cascade_tpu_torch.training.schedules import apply_stage_freeze, make_optimizer
    from hybrid_vit_cascade_tpu_torch.training.trainer import cascade_trainable, diffusion_state

    t, family = cfg.training, cfg.model.family
    if re.fullmatch(r"stage[123]", rel):
        if family != "cascade":
            raise ConversionError(f"{rel}/ holds a {family} run; only the cascade trains in stages")
        n = int(rel[-1])
        sc = t.stages[rel]
        params = apply_stage_freeze(model, cascade_trainable(n, t.freeze_shared_encoder_stage3))
        return make_optimizer(params, sc.learning_rate, sc.num_epochs, t.weight_decay,
                              t.gradient_clip)
    if rel.startswith("diffusion_") or (rel == "" and family == "diffusion"):
        if family != "diffusion":
            raise ConversionError(f"{rel}/ holds a {family} run, not a diffusion ladder")
        names = [s["name"] for s in model.stage_configs]
        if rel:
            name = rel[len("diffusion_"):]
            if name not in names:
                raise ConversionError(f"{rel}/: no stage of that name in the ladder {names}")
            idx = names.index(name)
            sc = t.stages.get(f"stage{idx + 1}")
            lr, freeze = (sc.learning_rate if sc else t.learning_rate), t.freeze_shared_diffusion
        else:  # fit_diffusion: the ladder's last stage
            idx, lr, freeze = len(names) - 1, t.learning_rate, False
        return diffusion_state(model, cfg, idx, lr, t.num_epochs, freeze).optimizer
    for p in model.parameters():
        p.requires_grad_(True)
    return make_optimizer(model.parameters(), t.learning_rate, t.num_epochs, t.weight_decay,
                          t.gradient_clip, t.warmup_steps)


def convert_dir(src: Path, dst: Path, rel: str, log) -> None:
    """Convert the entries of one JAX checkpoint directory into ``dst``."""
    from hybrid_vit_cascade_tpu_torch import convert
    from hybrid_vit_cascade_tpu_torch.config import Config
    from hybrid_vit_cascade_tpu_torch.inference.infer import build_model
    from hybrid_vit_cascade_tpu_torch.models.diffusion import load_ladder_state
    from hybrid_vit_cascade_tpu_torch.training.checkpoint import write_entry

    dst.mkdir(parents=True, exist_ok=True)
    for name in COPIED:
        if (src / name).is_file():
            shutil.copy2(src / name, dst / name)
    where = f"{rel}/" if rel else ""
    latest, models = None, {}
    names = sorted(p.name for p in src.iterdir() if p.is_dir() and ENTRY.fullmatch(p.name))
    for name in names:
        tree, meta = restore(src, name)
        cfg = Config.from_dict(meta.get("config", {}))
        family = cfg.model.family
        try:
            sd = convert.variables(family, tree)
        except ValueError as e:
            raise ConversionError(f"{where}{name}: {e}") from None
        key = json.dumps(meta.get("config", {}), sort_keys=True)
        model = models[key] = models.get(key) or build_model(cfg)
        try:
            if family == "diffusion":
                held = load_ladder_state(model, sd)
                ladder = [c["name"] for c in model.stage_configs]
                if rel == "" and held not in (ladder, ladder[-1:]):
                    raise RuntimeError(f"the root holds stage {held}, not the ladder's last "
                                       f"({ladder[-1]!r}) that fit_diffusion trains")
            else:
                model.load_state_dict(sd, strict=True)
        except RuntimeError as e:
            raise ConversionError(f"{where}{name}: the tree does not load into the port's "
                                  f"{family} model of its config: {e}") from None
        write_entry(dst / name, {"state_dict": sd}, meta)
        n = sum(p.numel() for p in model.parameters())
        log(f"{where}{name}: {family}, {n} parameters, 0 moments, epoch {meta.get('epoch')}")
        if name == "latest":
            latest = (tree, cfg, model)
    if not (src / "latest_opt").is_dir():
        return
    if latest is None:
        raise ConversionError(f"{where}latest_opt without {where}latest")
    tree, cfg, model = latest
    opt_tree, meta = restore(src, "latest_opt")
    if not isinstance(opt_tree, dict) or set(opt_tree) != {"opt_state", "step"}:
        raise ConversionError(f"{where}latest_opt: not an {{opt_state, step}} tree")
    adam, schedule = adam_chain(opt_tree["opt_state"])
    optimizer = _stage_optimizer(rel, cfg, model)
    try:
        state = convert.adamw_state(cfg.model.family, tree, adam["mu"], adam["nu"],
                                    int(adam["count"]), int(schedule["count"]),
                                    int(opt_tree["step"]), model, optimizer)
    except ValueError as e:
        raise ConversionError(f"{where}latest_opt: {e}") from None
    optimizer.load_state_dict(state["optimizer"])  # what the port's resume loads
    write_entry(dst / "latest_opt", state, meta)
    moments = sum(t.numel() for s in state["optimizer"]["state"].values()
                  for k, t in s.items() if k in ("exp_avg", "exp_avg_sq"))
    n = sum(p.numel() for g in optimizer.param_groups for p in g["params"])
    log(f"{where}latest_opt: {cfg.model.family}, {n} parameters, {moments} moments, "
        f"step {state['step']}")


def run_dirs(src: Path) -> list:
    """The directories of a JAX save_dir that hold its checkpoints, relative:
    the root, ``stageN`` and ``diffusion_{name}``."""
    subs = sorted(p.name for p in src.iterdir() if p.is_dir()
                  and re.fullmatch(r"stage[123]|diffusion_\w+", p.name))
    return [""] + subs


def convert_run(src: str | Path, dst: str | Path, log=print) -> None:
    """Convert the JAX run ``src`` into a new port save_dir ``dst``: all of
    it, or (ConversionError) nothing."""
    src, dst = Path(src), Path(dst)
    if not src.is_dir():
        raise ConversionError(f"{src} is not a directory")
    if dst.exists():
        raise ConversionError(f"{dst} exists; the converter writes a new directory")
    tmp = dst.with_name(dst.name + ".converting")
    if tmp.exists():
        shutil.rmtree(tmp)
    try:
        for rel in run_dirs(src):
            convert_dir(src / rel, tmp / rel, rel, log)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    tmp.rename(dst)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--from", dest="src", required=True, help="the JAX run's save_dir")
    ap.add_argument("--to", dest="dst", required=True, help="the port's save_dir to write")
    args = ap.parse_args(argv)
    import jax

    jax.config.update("jax_platforms", "cpu")
    try:
        convert_run(args.src, args.dst)
    except ConversionError as e:
        print(f"convert_orbax: {e}; nothing written", file=sys.stderr)
        return 2
    print(json.dumps({"converted": str(args.dst)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
