"""Training driver of the port.

Counterpart of fabind_tpu/cli/train.py:

  python -m fabind_tpu_torch.cli.train --preset fabind --data DATA \\
      --output runs/exp1 [--epochs N] [--batch-size B] [--bf16] [--dp N]

`--data` is the reference's processed PDBbind store (its train and valid
splits under the preset's filters) or a directory of .npz samples (the
first 90% by name train, the rest validate). Evaluates at stages 1 and 2;
checkpoints under <output>/ckpt
(`--resume` continues from the latest, mid-epoch included); on SIGTERM or
SIGINT it finishes the step in flight, checkpoints with the data-order
position and exits 0. Runs on CUDA; `--device cpu` runs on the CPU.

`--dp N` trains data-parallel over N cards (0, the default: every visible
card; fewer than N raises): one spawned process per card
(parallel.dp.launch, nccl; gloo on the CPU), each a Trainer rank with
`host_shard=(rank, N)`. `--batch-size` stays the global batch and must
divide by N; each rank loads and steps its B / N rows, and the step equals
one process's on the global batch (train/trainer.py). Rank 0 writes the
log, metrics.jsonl and the checkpoints; on `--resume` every rank reads the
same checkpoint; every rank evaluates the whole validation set (no
collective waits on one rank's evaluation) and rank 0 logs it. SIGTERM or
SIGINT to the launcher reaches every rank; the flag is reduced (max) after
each step, so all ranks stop after the same one, rank 0 checkpoints, and
all exit 0. With one card the run takes the one-process path: no process
group, no spawn. `--device cpu --dp N` runs N CPU ranks.

Not ported: `--wandb` (metrics go to metrics.jsonl and, when it imports,
TensorBoard), `--compile-cache` (nothing is compiled ahead of the first
step but the CUDA kernels, which build into build/kernels) and a launch
over several hosts.
"""
from __future__ import annotations

import argparse
import os
import signal
import time
from typing import Callable, Optional

import torch

from fabind_tpu_torch.cli.common import resolve_device
from fabind_tpu_torch.config import parse_overrides, preset
from fabind_tpu_torch.data.buckets import resolve_buckets
from fabind_tpu_torch.data.dataset import Loader, NPZSource, open_source
from fabind_tpu_torch.data.types import FABindBatch, to_device
from fabind_tpu_torch.ops import dropout, edge_gate
from fabind_tpu_torch.parallel.dp import DPGroup, dp_devices, launch
from fabind_tpu_torch.train.checkpoints import TrainCheckpointer
from fabind_tpu_torch.train.trainer import Trainer
from fabind_tpu_torch.utils.logging_utils import Logger
from fabind_tpu_torch.utils.metrics import MetricAccumulator

# profiler window, in steps taken by this run
PROFILE_STEPS = (10, 15)
# a step's metrics go to the log every LOG_EVERY steps, as in the JAX CLI
LOG_EVERY = 50


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--preset", default="fabind",
                   choices=["fabind", "fabind_plus"])
    p.add_argument("--data", required=True,
                   help="the reference's processed PDBbind root (data.pt "
                        "or data_new.pt under dataset/processed) or a "
                        "directory of per-complex .npz samples")
    p.add_argument("--output", default="runs/default")
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--bf16", action="store_true",
                   help="bf16 mixed precision, float32 master weights")
    p.add_argument("--remat", action=argparse.BooleanOptionalAction,
                   default=False,
                   help="recompute each EGNN layer in the backward "
                        "(torch.utils.checkpoint): same gradients, less "
                        "activation memory, about one more forward of the "
                        "layers")
    p.add_argument("--dp", type=int, default=0,
                   help="data-parallel ranks, one per card (0 = every "
                        "visible card); --batch-size is the global batch")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--eval-every", type=int, default=1,
                   help="evaluate (stages 1 and 2) every N epochs; 0 = never")
    p.add_argument("--save-every-steps", type=int, default=0,
                   help="also checkpoint every N steps (mid-epoch "
                        "resumable); 0 = per epoch only")
    p.add_argument("--save-every-epochs", type=int, default=1,
                   help="checkpoint every N epochs (the last always saves)")
    p.add_argument("--keep", type=int, default=3,
                   help="checkpoint retention: the newest N steps")
    p.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler trace (Chrome JSON) of this "
                        "run's steps %d-%d, with the program's spans, here"
                        % PROFILE_STEPS)
    p.add_argument("--workers", type=int, default=8,
                   help="host featurization threads; 0 = inline")
    p.add_argument("--prefetch", type=int, default=2,
                   help="batches prepared ahead of the device (0 = off)")
    p.add_argument("--transfer-dtype", default="fp32",
                   choices=["fp32", "bf16"],
                   help="upload dtype of a training batch's ESM rows "
                        "(prot_feat, the largest host->device bytes); bf16 "
                        "halves them and rounds the inputs to bf16; "
                        "validation batches go in fp32")
    p.add_argument("--buckets", default="auto",
                   help="shape buckets: 'auto' ('auto:K') measures the "
                        "train split and picks up to 3 (K); 'none' pads "
                        "every complex to cfg.shapes; or explicit "
                        "'lig:pocket:protein,...'")
    p.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                   help="config override, e.g. --set max_ligand=32 (any "
                        "ModelConfig/ShapeConfig/TrainConfig field)")
    p.add_argument("--device", default=None,
                   help="torch device (default cuda; raises without CUDA "
                        "unless --device cpu)")
    return p.parse_args(argv)


def to_batch(arrays, device, transfer_dtype: str) -> FABindBatch:
    """Collated numpy arrays -> a batch on `device`; with transfer_dtype
    bf16 the ESM rows travel in bf16 and are widened on the device."""
    if transfer_dtype == "bf16":
        pf = torch.from_numpy(arrays["prot_feat"]).to(torch.bfloat16)
        arrays = dict(arrays, prot_feat=to_device(pf, device).float())
    return FABindBatch.from_numpy(arrays, device)


def main(argv=None, on_step: Optional[Callable] = None) -> int:
    """Train. `on_step(step, metrics, meta)`, when given, is called after
    every step with the step count after it, the step's metrics (floats)
    and the batch's loader meta (pdb names, n_valid, the bucket's cfg); with
    more than one rank it is not called (the ranks are other processes)."""
    args = parse_args(argv)
    devices = dp_devices(args.device, args.dp)
    if len(devices) == 1:
        return run(args, resolve_device(str(devices[0]), "cli.train"),
                   on_step)
    launch(rank_main, (argv,), devices)
    return 0


def rank_main(rank: int, world: int, device, argv) -> list:
    """One data-parallel rank of `cli.train argv` (the target
    parallel.dp.launch runs): trains its share and returns its steps, each
    {"step", "metrics", "n_valid", "gate", "dropout", "dropout_rows"} with
    the kernel launches the step made in this process."""
    args = parse_args(argv)
    steps = []
    last = {}

    def record(step, metrics, meta):
        now = {"gate": edge_gate.KERNEL.launches,
               "dropout": dropout.KERNEL.launches,
               "dropout_rows": dropout.KERNEL.variants.get("rows", 0)}
        steps.append({"step": step, "metrics": metrics,
                      "n_valid": meta["n_valid"],
                      **{k: v - last.get(k, 0) for k, v in now.items()}})
        last.update(now)

    def start_counts():
        last.update(gate=edge_gate.KERNEL.launches,
                    dropout=dropout.KERNEL.launches,
                    dropout_rows=dropout.KERNEL.variants.get("rows", 0))

    start_counts()
    rc = run(args, resolve_device(str(device), "cli.train"), record,
             DPGroup(rank, world, device), on_eval=start_counts)
    if rc != 0:
        raise RuntimeError(f"rank {rank} returned {rc}")
    return steps


def run(args: argparse.Namespace, device, on_step: Optional[Callable],
        group: Optional[DPGroup] = None,
        on_eval: Optional[Callable] = None) -> int:
    """The training run of `args` on `device`: one process, or with
    `group` one data-parallel rank. `on_eval` is called after each
    evaluation."""
    world = 1 if group is None else group.world
    lead = group is None or group.rank == 0
    overrides = parse_overrides(args.set)
    if args.epochs:
        overrides["total_epochs"] = args.epochs
    if args.batch_size:
        overrides["batch_size"] = args.batch_size
    if args.seed is not None:
        overrides["seed"] = args.seed
    if args.bf16:
        overrides["bf16"] = True
    overrides.setdefault("remat", args.remat)
    cfg = preset(args.preset, **overrides)
    if cfg.train.batch_size % world:
        raise SystemExit(f"--batch-size {cfg.train.batch_size} is the "
                         f"global batch and must divide by --dp {world}")

    # rank 0 writes the log and metrics.jsonl; the other ranks log to
    # stdout only
    logger = (Logger(args.output) if lead
              else Logger(name=f"fabind_tpu_torch.rank{group.rank}"))
    logger.log_message(f"device: {device}"
                       + (f" ({torch.cuda.get_device_name(device)})"
                          if device.type == "cuda" else ""))
    source, _ = open_source(args.data, variant=args.preset,
                            use_esm2_feat=cfg.model.use_esm2_feat)
    if isinstance(source, NPZSource):
        n = len(source.names)
        splits = {"train": source.names[: int(0.9 * n)],
                  "valid": source.names[int(0.9 * n):], "test": []}
    else:
        splits = source.splits(args.preset)
    logger.log_message(f"splits: { {k: len(v) for k, v in splits.items()} }")
    buckets = resolve_buckets(args.buckets, cfg, source, splits["train"],
                              group="train")
    if buckets is not None:
        logger.log_message("train buckets: " + str(
            [(s.max_ligand, s.max_pocket, s.max_protein) for s in buckets]))
    train_loader = Loader(
        source, splits["train"], cfg, group="train",
        batch_size=cfg.train.batch_size // world, seed=cfg.train.seed,
        workers=args.workers, prefetch_depth=args.prefetch, buckets=buckets,
        host_shard=None if group is None else (group.rank, world))
    valid_loader = Loader(source, splits["valid"], cfg, group="valid",
                          workers=args.workers, prefetch_depth=args.prefetch,
                          buckets=buckets)

    trainer = Trainer(cfg, device, group=group)
    ckptr = TrainCheckpointer(args.output + "/ckpt", max_to_keep=args.keep)
    start_epoch, skip_batches = 0, 0
    if args.resume:
        restored = ckptr.restore()
        if restored is not None:
            state, meta = restored
            trainer.load_state_dict(state)
            start_epoch = int(meta.get("epoch", 0))
            skip_batches = int(meta.get("batch_in_epoch", 0))
            logger.log_message(f"resumed at step {trainer.step} (epoch "
                               f"{start_epoch}, batch {skip_batches})")
    n_params = sum(p.numel() for p in trainer.model.parameters())
    logger.log_message(f"model params: {n_params / 1e6:.2f}M")

    # preemption: on SIGTERM/SIGINT finish the step in flight, checkpoint
    # with the data-order position and return
    preempted = {"flag": False}

    def on_signal(signum, frame):
        preempted["flag"] = True
        logger.log_message(f"signal {signum}: checkpointing then exiting")

    old_handlers = {s: signal.signal(s, on_signal)
                    for s in (signal.SIGTERM, signal.SIGINT)}
    prof = None
    run_steps = 0
    try:
        for epoch in range(start_epoch, cfg.train.total_epochs):
            t0 = time.perf_counter()
            batch_in_epoch = skip_batches
            n_samples = 0
            for arrays, meta in train_loader.epoch(
                    epoch, with_meta=True, skip_batches=skip_batches):
                batch = to_batch(arrays, device, args.transfer_dtype)
                if args.profile_dir and run_steps == PROFILE_STEPS[0]:
                    prof = torch.profiler.profile(activities=_activities())
                    prof.start()
                metrics = trainer.train_step(batch, meta["cfg"])
                batch_in_epoch += 1
                n_samples += meta["n_valid"]
                run_steps += 1
                if prof is not None and run_steps == PROFILE_STEPS[1]:
                    prof = _stop_profile(prof, args.profile_dir, logger)
                step = trainer.step
                if on_step is not None:
                    on_step(step, metrics, meta)
                if step % LOG_EVERY == 0:
                    logger.log_metrics(metrics, step)
                mid_meta = {"epoch": epoch, "batch_in_epoch": batch_in_epoch}
                # every rank stops after the same step
                stop = (preempted["flag"] if group is None
                        else group.all_max(preempted["flag"]) > 0)
                if stop:
                    if lead:
                        ckptr.save(trainer.state_dict(), meta=mid_meta)
                        ckptr.close()
                    logger.log_message(f"preemption checkpoint at step {step}")
                    return 0
                if (lead and args.save_every_steps
                        and step % args.save_every_steps == 0):
                    ckptr.save(trainer.state_dict(), meta=mid_meta)
            skip_batches = 0
            secs = time.perf_counter() - t0
            if group is not None:   # every rank's real samples
                n_samples = int(group.all_sum(torch.tensor(
                    float(n_samples), device=device)).item())
            logger.log_message(
                f"epoch {epoch} done in {secs:.1f}s; dropped "
                f"{train_loader.n_dropped} oversize samples")
            # the epoch's rate: its real samples over the loop's wall time
            # (loading, steps; not the checkpoint or the evaluation)
            logger.log_metrics({"epoch": epoch, "seconds": secs,
                                "samples": n_samples,
                                "samples_per_s": n_samples / secs},
                               trainer.step, phase="epoch")
            if lead and ((epoch + 1) % max(args.save_every_epochs, 1) == 0
                         or epoch + 1 == cfg.train.total_epochs):
                ckptr.save(trainer.state_dict(),
                           meta={"epoch": epoch + 1, "batch_in_epoch": 0})
            if (args.eval_every > 0 and (epoch + 1) % args.eval_every == 0
                    and valid_loader.indices):
                evaluate(trainer, valid_loader, device, logger)
                if on_eval is not None:
                    on_eval()
        if prof is not None:
            _stop_profile(prof, args.profile_dir, logger)
        ckptr.close()
        return 0
    finally:
        for s, h in old_handlers.items():
            signal.signal(s, h)
        logger.close()


def evaluate(trainer: Trainer, loader: Loader, device,
             logger: Logger) -> dict:
    """Stage 1 (the precomputed pocket) and stage 2 (the predicted one)
    over the validation loader, float32 batches on the float32 weights
    (--bf16 and --transfer-dtype apply to training batches only, as in the
    JAX CLI); logs and returns {stage: summary}."""
    out = {}
    for stage in (1, 2):
        acc = MetricAccumulator()
        for arrays, meta in loader.epoch(0, with_meta=True):
            batch = FABindBatch.from_numpy(arrays, device)
            acc.update(trainer.eval_step(batch, stage, meta["cfg"]), batch)
        out[stage] = acc.summarize()
        logger.log_metrics(out[stage], trainer.step,
                           phase=f"valid_stage{stage}")
    return out


def _activities():
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def _stop_profile(prof, out_dir: str, logger: Logger):
    prof.stop()
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "train_steps.json")
    prof.export_chrome_trace(path)
    logger.log_message(f"profiler trace -> {path}")
    return None


if __name__ == "__main__":
    raise SystemExit(main())
