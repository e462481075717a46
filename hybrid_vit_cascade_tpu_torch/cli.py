"""Command line of the port (counterpart of hybrid_vit_cascade_tpu/cli.py):
``python -m hybrid_vit_cascade_tpu_torch.cli train --config <json>``.

``train`` takes the JAX command's flags and config semantics (``_load_cfg``)
plus ``--device`` (default ``cuda``; ``cpu`` runs the plain versions of the
kernels) and prints ``{"final": metrics}``. As in the JAX package,
``--epochs`` sets ``training.num_epochs``, which the cascade's stagewise
training does not read (each stage has its own ``num_epochs``), and ``--lr``
is not read by it either. Not ported yet: ``infer``, ``eval``, ``diagnose``,
``transfer``, ``inspect``, ``export``, ``bench``, ``dryrun``.
"""

from __future__ import annotations

import argparse
import json


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


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="hybrid_vit_cascade_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    t = sub.add_parser("train", help="train a model family (the cascade, stagewise)")
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
    t.add_argument("--device", default="cuda",
                   help="torch device to train on (default cuda; cpu runs the plain versions)")
    t.set_defaults(fn=cmd_train)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
