"""FABind+ confidence-head training entry point.

Counterpart of fabind_tpu/cli/train_confidence.py, on the GPU by default:

  python -m fabind_tpu_torch.cli.train_confidence --data DATA \\
      --init-ckpt runs/reg [--torch-ckpt fabind_plus_best_ckpt.bin] \\
      --output runs/conf [--pose-source teacher|inference] [--device cpu]

`--data` is the reference's processed PDBbind store (its train and valid
rows under FABind+'s filters, as the reference trains the head) or a
directory of .npz samples (all of them). Loads a FABind+ regression
checkpoint (a `cli.train` run with
--init-ckpt, a released-format `.bin` with --torch-ckpt; either goes
through `checkpoints.load_weights`, and the confidence head it lacks keeps
its seeded init), freezes everything but the head, and
trains the pairwise ranking loss over cfg.train.num_copies stochastic
copies per complex (`train/confidence.py`). A step's metrics go to the log
every 50 steps, then an epoch summary; the weights go to
<output>/ckpt/params_epoch{e} (`checkpoints.save_params`). Not ported:
--wandb (metrics go to metrics.jsonl and, when it imports, TensorBoard).
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from fabind_tpu_torch.cli.common import load_model, resolve_device
from fabind_tpu_torch.config import parse_overrides, preset
from fabind_tpu_torch.data.dataset import Loader, NPZSource, open_source
from fabind_tpu_torch.data.types import FABindBatch
from fabind_tpu_torch.train.checkpoints import save_params
from fabind_tpu_torch.train.confidence import (build_confidence_optimizer,
                                               make_confidence_train_step,
                                               sample_copy_inputs)
from fabind_tpu_torch.utils.logging_utils import Logger

# a step's metrics go to the log every LOG_EVERY steps, as in the JAX CLI
LOG_EVERY = 50


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--data", required=True,
                   help="the reference's processed PDBbind root or a "
                        "directory of per-complex .npz samples")
    p.add_argument("--output", default="runs/confidence")
    p.add_argument("--init-ckpt", default=None,
                   help="a fabind_plus cli.train run (or its ckpt/ "
                        "directory, or a save_params file)")
    p.add_argument("--torch-ckpt", default=None,
                   help="released torch state dict "
                        "(fabind_plus_best_ckpt.bin, a .bin or .pt)")
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--num-copies", type=int, default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--ranking-loss", default=None,
                   choices=["logsigmoid", "dynamic_hinge"])
    p.add_argument("--pair-scope", default=None, choices=["within", "global"],
                   help="'within' (default, the reference protocol): pairs "
                        "of copies of one complex only; 'global': every "
                        "pair of the batch")
    p.add_argument("--pose-source", default=None,
                   choices=["teacher", "inference"],
                   help="'teacher' (default): teacher-forced training "
                        "forwards, dropout the only difference; "
                        "'inference': stochastic inference passes from "
                        "randomized ligand starts and sampled pocket "
                        "centers")
    p.add_argument("--keep-cls-2A", action="store_true")
    p.add_argument("--stack-mlp", action="store_true")
    p.add_argument("--set", action="append", default=[], metavar="KEY=VALUE")
    p.add_argument("--device", default=None,
                   help="torch device (default cuda; raises without CUDA "
                        "unless --device cpu)")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    device = resolve_device(args.device, "cli.train_confidence")
    overrides = {"confidence_training": True, **parse_overrides(args.set)}
    for key, value in (("total_epochs", args.epochs),
                       ("batch_size", args.batch_size),
                       ("num_copies", args.num_copies),
                       ("ranking_loss", args.ranking_loss),
                       ("ranking_pair_scope", args.pair_scope)):
        if value:
            overrides[key] = value
    if args.seed is not None:
        overrides["seed"] = args.seed
    if args.keep_cls_2A:
        overrides["keep_cls_2A"] = True
    if args.stack_mlp:
        overrides["stack_mlp"] = True
    cfg = preset("fabind_plus", **overrides)

    logger = Logger(args.output)
    try:
        logger.log_message(f"device: {device}")
        source, names = open_source(args.data, variant="fabind_plus",
                                    use_esm2_feat=cfg.model.use_esm2_feat)
        if not isinstance(source, NPZSource):
            # the reference trains the head on the train and valid groups
            # (train_confidence.py:132-133)
            splits = source.splits("fabind_plus")
            names = splits["train"] + splits["valid"]
        logger.log_message(f"confidence train set: {len(names)} complexes")
        loader = Loader(source, names, cfg, group="train",
                        seed=cfg.train.seed, workers=8, prefetch_depth=2)

        ckpt = args.torch_ckpt or args.init_ckpt
        if not ckpt:
            logger.log_message("WARNING: training confidence from scratch "
                               "(no --init-ckpt/--torch-ckpt)")
        model = load_model(cfg, ckpt, device, seed=cfg.train.seed)
        pose_source = args.pose_source or "teacher"
        optimizer = build_confidence_optimizer(cfg, model)
        step_fn = make_confidence_train_step(model, cfg, optimizer,
                                             pose_source=pose_source)
        n_head = sum(p.numel() for p in model.parameters()
                     if p.requires_grad)
        n_all = sum(p.numel() for p in model.parameters())
        logger.log_message(f"params: {n_all / 1e6:.2f}M, of which the "
                           f"confidence head trains {n_head / 1e6:.3f}M")

        gen = torch.Generator().manual_seed(cfg.train.seed + 1)
        host_rng = np.random.RandomState(cfg.train.seed + 2)
        os.makedirs(os.path.join(args.output, "ckpt"), exist_ok=True)
        step = 0
        for epoch in range(cfg.train.total_epochs):
            t0 = time.time()
            sums, n_batches = {}, 0
            for arrays, meta in loader.epoch(epoch, with_meta=True):
                batch = FABindBatch.from_numpy(arrays, device)
                shapes = meta["cfg"].shapes
                inits = centers = None
                if pose_source == "inference":
                    inits, centers = sample_copy_inputs(
                        model, batch, cfg, cfg.train.num_copies, host_rng,
                        use_clustering=True, shapes=shapes)
                metrics = step_fn(batch, gen, inits, centers, shapes=shapes)
                step += 1
                n_batches += 1
                for k, v in metrics.items():
                    sums[k] = sums.get(k, 0.0) + v
                if step % LOG_EVERY == 0:
                    logger.log_metrics(metrics, step)
            summary = {k: v / max(n_batches, 1) for k, v in sums.items()}
            logger.log_metrics(summary, step, phase="epoch")
            logger.log_message(
                f"epoch {epoch}: loss={summary.get('confidence_loss', 0):.4f}"
                f" ranking_acc={summary.get('ranking_accuracy', 0):.3f} "
                f"hit_rate={summary.get('hit_rate', 0):.3f} "
                f"({time.time() - t0:.1f}s)")
            save_params(os.path.join(args.output, "ckpt",
                                     f"params_epoch{epoch}"),
                        model.state_dict())
        return 0
    finally:
        logger.close()


if __name__ == "__main__":
    raise SystemExit(main())
