"""Command line of the port (counterpart of hybrid_vit_cascade_tpu/cli.py):
``python -m hybrid_vit_cascade_tpu_torch.cli <cmd>``.

  train    — a model family from a JSON config (the cascade stagewise)
  transfer — shape-matched weight transfer into a config's model, then train
  infer    — checkpoint → .npy / NIfTI / PNG export and the item's metrics
  eval     — whole-test-split metric summary (evaluation_metrics.json)
  diagnose — the diagnostic suite and health grades of one reconstruction
  inspect  — a checkpoint's tensor names and shapes

Each takes the JAX command's flags and config semantics (``_load_cfg``) plus
``--device`` (default ``cuda``; ``cpu`` runs the plain versions of the
kernels); a command that reads a checkpoint reads its embedded config, and
``infer``, ``eval`` and ``diagnose`` build the dataset at the model's top
resolution. As in the JAX package, ``train``'s ``--epochs`` sets
``training.num_epochs`` and ``--lr`` overrides the learning rate, which the
single-model families read and the cascade's stagewise training does not
(each stage has its own). Not ported yet: ``export``, ``bench``, ``dryrun``.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path


def _load_cfg(args):
    from .config import Config

    cfg = Config.from_json(args.config) if args.config else Config()
    if getattr(args, "synthetic", False):
        cfg.data.synthetic = True
    if getattr(args, "family", None):
        cfg.model.family = args.family
    if getattr(args, "epochs", None) is not None:
        cfg.training.num_epochs = args.epochs
    if getattr(args, "save_dir", None):
        cfg.checkpoints.save_dir = args.save_dir
    if getattr(args, "data_path", None):
        cfg.data.dataset_path = args.data_path
    return cfg


def cmd_train(args) -> None:
    from .training.trainer import Trainer

    cfg = _load_cfg(args)
    if getattr(args, "profile_dir", None):
        cfg.training.profile_dir = args.profile_dir
    if getattr(args, "debug_nans", False):
        cfg.training.debug_nans = True
    if getattr(args, "vgg_weights", None):
        cfg.loss.vgg_weights = args.vgg_weights
    if getattr(args, "viz_every", None):
        cfg.training.viz_every = args.viz_every
    trainer = Trainer(cfg, device=args.device)
    metrics = trainer.fit(lr_override=args.lr, resume=not args.no_resume)
    print(json.dumps({"final": metrics}))


def cmd_transfer(args) -> None:
    """Shape-matched transfer (e.g. a 128³ decoder's weights into the 256³
    one): every parameter of the config's model whose name and shape a
    parameter of ``--from-checkpoint`` has is copied, the rest keep their
    init; the result is written as ``save_dir/latest`` at epoch −1 (no
    optimizer state), from which ``fit`` then trains unless ``--init-only``."""
    from .inference.infer import load_checkpoint
    from .training.checkpoint import shape_matched_transfer
    from .training.trainer import Trainer

    cfg = _load_cfg(args)
    trainer = Trainer(cfg, device=args.device)
    _, loaded = load_checkpoint(args.from_checkpoint)
    params = {k: p.detach() for k, p in trainer.model.named_parameters()}
    new, transferred, skipped = shape_matched_transfer(params, loaded)
    print(f"transfer: {transferred} leaves transferred, {skipped} skipped "
          f"({transferred / max(transferred + skipped, 1) * 100:.1f}%)")
    trainer.model.load_state_dict({**trainer.model.state_dict(), **new})
    trainer.ckpt.save({"state_dict": trainer._state_dict_cpu()}, epoch=-1, metrics={},
                      config=cfg.to_dict())
    if not args.init_only:
        metrics = trainer.fit(lr_override=args.lr, resume=True)
        print(json.dumps({"final": metrics}))


def _dataset(args, cfg, num_patients: int):
    """The synthetic phantoms or the patient folders, at the model's top
    resolution."""
    from .config import data_volume_size
    from .data.dataset import PatientDRRDataset
    from .data.synthetic import SyntheticCTDataset

    if args.synthetic or cfg.data.synthetic:
        return SyntheticCTDataset(num_patients=num_patients, volume_size=data_volume_size(cfg),
                                  xray_size=cfg.data.xray_size)
    return PatientDRRDataset(args.data_path or cfg.data.dataset_path,
                             target_xray_size=cfg.data.xray_size,
                             target_volume_size=data_volume_size(cfg),
                             normalization=cfg.data.normalization)


def _upscale(args):
    return tuple(int(x) for x in args.upscale.split(",")) if args.upscale else None


def cmd_infer(args) -> None:
    from .inference.infer import InferenceEngine

    engine = InferenceEngine(args.checkpoint, device=args.device)
    cfg = engine.cfg
    if args.pa_xray or args.lat_xray:
        # a raw X-ray pair straight from image files, no dataset folder
        if not (args.pa_xray and args.lat_xray):
            raise SystemExit("--pa-xray and --lat-xray must be given together")
        from .data.dataset import NORMALIZATION_PRESETS
        from .inference.infer import load_xray_pair

        # raw images follow the checkpoint's normalisation preset, the range
        # the dataset feeds at train time ([-1, 1] for soft_tissue)
        xr = load_xray_pair(args.pa_xray, args.lat_xray, size=cfg.data.xray_size,
                            normalize_range=NORMALIZATION_PRESETS[cfg.data.normalization]["range"])
        paths = engine.export(xr, args.output, prefix="raw_pair", upscale=_upscale(args),
                              denormalize=args.denormalize)
        print(json.dumps({"exports": paths}, indent=2))
        return
    item = _dataset(args, cfg, max(1, args.index + 1))[args.index]
    paths = engine.export(item["drr_stacked"][None], args.output, prefix=item["patient_id"],
                          upscale=_upscale(args), denormalize=args.denormalize,
                          target=item["ct_volume"][None])
    metrics = engine.evaluate_sample(item)
    print(json.dumps({"exports": paths, "metrics": metrics}, indent=2))


def cmd_eval(args) -> None:
    from .data.dataset import create_train_val_datasets
    from .inference.infer import InferenceEngine

    engine = InferenceEngine(args.checkpoint, device=args.device)
    cfg = engine.cfg
    ds = _dataset(args, cfg, cfg.data.synthetic_patients)
    _, _, test = create_train_val_datasets(ds, cfg.data.train_split, cfg.data.val_split,
                                           split_mode=cfg.data.split_mode)
    if len(test) == 0:
        test = ds
    summary = engine.evaluate_dataset(test, out_json=args.output)
    print(json.dumps(summary, indent=2))


def cmd_diagnose(args) -> None:
    """Health-grade one reconstruction with the diagnostic suite and live
    stage-1 cross-attention capture."""
    from .inference.infer import InferenceEngine

    engine = InferenceEngine(args.checkpoint, device=args.device)
    ds = _dataset(args, engine.cfg, max(1, args.index + 1))
    report = engine.diagnose(ds[args.index], max_stage=args.stage)
    text = json.dumps(report, indent=2)
    if args.output:
        Path(args.output).write_text(text)
    print(text)


def cmd_inspect(args) -> None:
    from .inference.infer import inspect_checkpoint

    print(json.dumps(inspect_checkpoint(args.checkpoint), indent=2))


def _device_flag(p) -> None:
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the plain versions of the kernels)")


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="hybrid_vit_cascade_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    t = sub.add_parser("train", help="train a model family (the cascade stagewise)")
    t.add_argument("--config", default=None)
    t.add_argument("--family", default=None)
    t.add_argument("--synthetic", action="store_true")
    t.add_argument("--epochs", type=int, default=None)
    t.add_argument("--lr", type=float, default=None, help="LR override on resume")
    t.add_argument("--save-dir", default=None)
    t.add_argument("--data-path", default=None)
    t.add_argument("--no-resume", action="store_true")
    t.add_argument("--profile-dir", default=None, help="not ported: raises when given")
    t.add_argument("--debug-nans", action="store_true", help="not ported: raises when given")
    t.add_argument("--vgg-weights", default=None,
                   help="converted ImageNet VGG16 .npz for the perceptual loss")
    t.add_argument("--viz-every", type=int, default=0,
                   help="epoch-end figures every N epochs (not ported: the run says so)")
    _device_flag(t)
    t.set_defaults(fn=cmd_train)

    i = sub.add_parser("infer", help="reconstruct + export .npy / NIfTI / PNG")
    i.add_argument("--checkpoint", required=True, help="checkpoint file or entry directory")
    i.add_argument("--output", default="inference_out")
    i.add_argument("--index", type=int, default=0)
    i.add_argument("--data-path", default=None)
    i.add_argument("--synthetic", action="store_true")
    i.add_argument("--upscale", default=None, help="D,H,W")
    i.add_argument("--denormalize", action="store_true", help="export in HU")
    i.add_argument("--pa-xray", default=None, help="raw AP X-ray image file (with --lat-xray)")
    i.add_argument("--lat-xray", default=None, help="raw lateral X-ray image file")
    _device_flag(i)
    i.set_defaults(fn=cmd_infer)

    e = sub.add_parser("eval", help="test-split metrics")
    e.add_argument("--checkpoint", required=True)
    e.add_argument("--output", default="evaluation_metrics.json")
    e.add_argument("--data-path", default=None)
    e.add_argument("--synthetic", action="store_true")
    _device_flag(e)
    e.set_defaults(fn=cmd_eval)

    dg = sub.add_parser("diagnose", help="diagnostic-loss suite + health grades on one sample")
    dg.add_argument("--checkpoint", required=True)
    dg.add_argument("--index", type=int, default=0)
    dg.add_argument("--stage", type=int, default=1, help="cascade max_stage for the graded forward")
    dg.add_argument("--synthetic", action="store_true")
    dg.add_argument("--data-path", default=None)
    dg.add_argument("--output", default=None, help="optional JSON path")
    _device_flag(dg)
    dg.set_defaults(fn=cmd_diagnose)

    x = sub.add_parser("transfer",
                       help="shape-matched weight transfer (e.g. 128³→256³) then train")
    x.add_argument("--from-checkpoint", required=True, help="source checkpoint file or entry")
    x.add_argument("--config", default=None)
    x.add_argument("--family", default=None)
    x.add_argument("--synthetic", action="store_true")
    x.add_argument("--epochs", type=int, default=None)
    x.add_argument("--lr", type=float, default=None)
    x.add_argument("--save-dir", default=None)
    x.add_argument("--data-path", default=None)
    x.add_argument("--init-only", action="store_true", help="only write the transferred init")
    _device_flag(x)
    x.set_defaults(fn=cmd_transfer)

    n = sub.add_parser("inspect", help="dump checkpoint keys/shapes")
    n.add_argument("--checkpoint", required=True)
    n.set_defaults(fn=cmd_inspect)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
