"""Training CLI (counterpart of the JAX package's ``train/cli.py``).

Usage::

    python -m segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch.train.cli \
        --create_synthetic --num_samples 20 --epochs 5 [--device cpu]

``--device`` (default ``cuda``) is the one the model, the loader and
the steps run on; without a card the default raises. ``--mesh_data``
and ``--mesh_space`` lay out a (data, space) mesh, one process per
device under ``torchrun`` (``--nproc_per_node`` = their product; rank i
on ``cuda:i``, or on the CPU over gloo with ``--device cpu``): the
batch's rows over ``data`` and, above 1, each volume's D slabs over
``space`` (the global depth a multiple of ``mesh_space * 2^len(
features)``); only rank 0 writes. Also callable as
``train_main(argv)``.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
from typing import Optional, Sequence

import torch

logger = logging.getLogger(__name__)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Train 3D brain tumor segmentation (PyTorch/CUDA)")
    p.add_argument("--epochs", type=int, default=50)
    p.add_argument("--batch_size", type=int, default=2)
    p.add_argument("--grad_accum", type=int, default=1,
                   help="microbatches per optimizer update (batch_size "
                        "must divide evenly)")
    p.add_argument("--ema_decay", type=float, default=0.0,
                   help="parameter EMA decay (e.g. 0.999); validation, "
                        "save-on-best and serving use the EMA weights. "
                        "0 = off")
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--data_dir", type=str, default="data/synthetic/BraTS2024")
    p.add_argument("--create_synthetic", action="store_true")
    p.add_argument("--num_samples", type=int, default=100)
    p.add_argument("--experiment_name", type=str, default=None)
    p.add_argument("--use_wandb", action="store_true")
    p.add_argument("--resume", type=str, default=None)
    p.add_argument("--save_latest_every", type=int, default=0,
                   help="also checkpoint the current state to "
                        "latest_<experiment> every N epochs")
    p.add_argument("--num_workers", type=int, default=4)
    p.add_argument("--preset", type=str, default="standard",
                   choices=["standard", "fast", "high_quality",
                            "lightweight", "production"])
    p.add_argument("--image_size", type=int, nargs=3, default=None)
    p.add_argument("--patch_size", type=int, nargs=3, default=None,
                   help="train on native-resolution foreground-biased "
                        "patches instead of whole volumes resized")
    p.add_argument("--fg_patch_prob", type=float, default=0.5)
    p.add_argument("--features", type=int, nargs="+", default=None,
                   help="encoder channel progression, e.g. 32 64 128")
    p.add_argument("--synthetic_shape", type=int, nargs=3, default=None,
                   help="native shape of generated synthetic volumes")
    p.add_argument("--mesh_data", type=int, default=1,
                   help="data-parallel mesh axis size (1 = one device; "
                        "more: one process per device under torchrun)")
    p.add_argument("--mesh_space", type=int, default=1,
                   help="spatial mesh axis: each volume split along D "
                        "over this many devices (1 = no split)")
    p.add_argument("--no_remat", action="store_true")
    p.add_argument("--dtype", type=str, default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to train on (default cuda)")
    return p


def train_main(argv: Optional[Sequence[str]] = None):
    """Parse ``argv``, build the data, the model and the trainer, train;
    returns (trainer, history)."""
    from ..config import get_config
    from ..data.pipeline import create_brats_data_loaders
    from ..data.synthetic import create_enhanced_synthetic_data
    from ..device import resolve_device
    from ..models import UNet3D
    from ..parallel.mesh import is_primary
    from .trainer import ModernBrainTumorTrainer

    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    mesh = sharding = None
    if args.mesh_data * args.mesh_space > 1:
        from ..parallel.mesh import (batch_sharding, create_mesh,
                                     initialize_distributed)
        device = initialize_distributed(
            device=None if args.device == "cuda" else args.device)
        mesh = create_mesh(args.mesh_data, args.mesh_space)
        sharding = batch_sharding(mesh)
        logger.info("mesh: %s", mesh)
    else:
        device = resolve_device(args.device)

    cfg = get_config(args.preset)
    cfg = cfg.replace(epochs=args.epochs, batch_size=args.batch_size,
                      grad_accum=args.grad_accum,
                      ema_decay=args.ema_decay, use_wandb=args.use_wandb)
    if args.image_size:
        cfg = cfg.replace(data=dataclasses.replace(
            cfg.data, image_size=tuple(args.image_size)))
    model_kw = {}
    if args.no_remat or args.dtype == "float32":
        model_kw.update(remat=not args.no_remat, compute_dtype=args.dtype)
    if args.features:
        model_kw.update(features=tuple(args.features))
    if model_kw:
        cfg = cfg.replace(model=dataclasses.replace(cfg.model, **model_kw))
    cfg.create_directories()

    shape = (tuple(args.synthetic_shape) if args.synthetic_shape
             else (240, 240, 155))

    def synthesize(n):
        """The cohort written by rank 0; the other ranks wait for it."""
        if mesh is None or is_primary():
            create_enhanced_synthetic_data(n, args.data_dir, shape=shape)
        if mesh is not None:
            torch.distributed.barrier()

    if args.create_synthetic:
        logger.info("generating %d synthetic samples at %s",
                    args.num_samples, shape)
        synthesize(args.num_samples)

    def loaders():
        return create_brats_data_loaders(
            args.data_dir, batch_size=args.batch_size,
            num_workers=args.num_workers, image_size=cfg.data.image_size,
            seed=cfg.seed, device=device, aug_cfg=cfg.augment,
            patch_size=tuple(args.patch_size) if args.patch_size else None,
            fg_patch_prob=args.fg_patch_prob, sharding=sharding)

    train_loader, val_loader = loaders()
    if len(train_loader.dataset) == 0:
        logger.warning("no training data found in %s: generating a "
                       "synthetic cohort", args.data_dir)
        synthesize(max(args.num_samples, 10))
        train_loader, val_loader = loaders()

    # the normal path, as JAX's CLI builds its model (no ps2d region)
    mc = cfg.model
    model = UNet3D(in_channels=mc.in_channels, out_channels=mc.out_channels,
                   features=mc.features, dropout_rate=mc.dropout_rate,
                   remat=mc.remat, compute_dtype=mc.compute_dtype,
                   s2d_train=mc.s2d_train, s2d_eval=mc.s2d_eval,
                   deep_sup_full_res=cfg.loss.deep_supervision_full_res,
                   seed=cfg.seed, device=device)
    trainer = ModernBrainTumorTrainer(
        model, learning_rate=args.lr,
        experiment_name=args.experiment_name, config=cfg, mesh=mesh,
        save_latest_every=args.save_latest_every)
    if args.resume:
        trainer.load_checkpoint(args.resume)
    history = trainer.train(train_loader, val_loader, args.epochs)
    logger.info("done; best val dice %.4f", trainer.best_dice)
    return trainer, history


main = train_main

if __name__ == "__main__":
    train_main()
