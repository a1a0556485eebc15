"""The training step of FABind: one model and one optimizer state shared by
every shape bucket.

Counterpart of fabind_tpu/train/trainer.py (`create_train_state`,
`make_train_step`, `BucketedTrainStep`, `make_eval_step`):
- each step draws its dropout masks, recycle count, gumbel uniforms and
  stage coin from generators seeded from (cfg.train.seed, step), as the JAX
  step folds its step count into its key, so a resumed run draws what an
  unbroken one would;
- bf16 (cfg.train.bf16) is mixed precision with float32 master weights: a
  bfloat16 copy of the weights (a second module, refreshed from the master
  weights every step) runs on the batch's float fields cast to bfloat16,
  its outputs are cast back to float32, the losses read the float32 batch,
  and the bfloat16 gradients are cast to float32 for the update, as the
  JAX step differentiates through its cast. A second module instead of a
  functional call keeps the weights in place for a recomputation in the
  backward (cfg.remat). The FABind+ LayerNorm edge MLP keeps its
  statistics in float32 in the copy, as in serving. Evaluation runs the
  float32 master weights on the float32 batch, as the JAX eval step does;
- a step whose loss or gradient norm is not finite changes nothing: no
  optimizer step, so the parameters, Adam's moments and count, the
  accumulator and the schedule stay as they were. Its metrics read 0 and
  skipped_nan 1. The trainer's own step count advances either way, as the
  JAX state.step does. Deciding it reads the metrics back to the host
  once per step.
- data parallelism (`group`, a parallel.dp.DPGroup): rank r of N holds
  rows r, r + N, ... of the global batch and draws what the global batch
  draws at them (layers.RowMap: dropout masks, gumbel uniforms, pocket
  noise; the stage gate's mean over every row). Each loss term's
  denominator is the global batch's (losses.fabind_losses(all_sum=)), so
  summing the ranks' float32 master gradients with one all_reduce gives
  the one-process gradient of the global batch, and every rank takes the
  same optimizer step. Not a DistributedDataParallel wrapper: the bf16
  copy's gradients are cast onto the master weights first, and a
  parameter the stage gate leaves unused counts as a zero gradient. The
  metrics are summed the same way, so the NaN skip reads the global loss
  and gradient norm on every rank. The initial weights are rank 0's.
- traced (utils/tracing.py): spans train.step, train.forward, train.loss,
  train.backward, train.readback and train.optimizer (the forward's
  train.gate_sync and model.* spans inside train.forward).
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from fabind_tpu_torch.config import FABindConfig
from fabind_tpu_torch.data.types import FABindBatch
from fabind_tpu_torch.models.fabind import FABindOutput, init_params, make_model
from fabind_tpu_torch.models.layers import RowMap, dropout_rng
from fabind_tpu_torch.parallel.dp import DPGroup
from fabind_tpu_torch.train.losses import fabind_losses
from fabind_tpu_torch.train.schedule import TrainOptimizer, global_norm
from fabind_tpu_torch.utils import tracing
from fabind_tpu_torch.utils.precision import cast_batch_bf16, cast_module_bf16

Tensor = torch.Tensor


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The generator of training step `step`: a function of (seed, step)
    only, so a resumed run draws what an unbroken one would."""
    s = int(np.random.SeedSequence([seed, step]).generate_state(
        1, np.uint64)[0] >> 1)
    return torch.Generator(device).manual_seed(s)


def output_float32(out: FABindOutput) -> FABindOutput:
    """The output with its bfloat16 tensors in float32."""
    return dataclasses.replace(out, **{
        f.name: getattr(out, f.name).float()
        for f in dataclasses.fields(out)
        if isinstance(getattr(out, f.name), Tensor)
        and getattr(out, f.name).dtype == torch.bfloat16})


class Trainer:
    """Model, optimizer and step count of one training run on `device`.

    train_step(batch, bucket_cfg) takes one step in the batch's shape bucket
    and returns its metrics as floats; eval_step(batch, stage, bucket_cfg)
    runs the deterministic forward. The weights are seeded from
    cfg.train.seed unless `state_dict` is given. With `group` the trainer
    is one data-parallel rank (module docstring): its batches are its rows
    of the global batch, and its metrics the global batch's."""

    def __init__(self, cfg: FABindConfig, device="cuda",
                 state_dict: Optional[Dict[str, Tensor]] = None,
                 group: Optional[DPGroup] = None):
        self.cfg = cfg
        self.device = torch.device(device)
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError("Trainer: CUDA is not available; pass "
                                   "device='cpu' to train on the CPU")
            # per-process flags, as the serving engine's: fp32 products in
            # full precision (no TF32); bf16 products accumulate in fp32
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
            cuda_matmul = torch.backends.cuda.matmul
            cuda_matmul.allow_bf16_reduced_precision_reduction = False
        model = make_model(cfg)
        if state_dict is None:
            init_params(model, torch.Generator().manual_seed(cfg.train.seed))
        else:
            model.load_state_dict(state_dict, strict=True)
        self.model = model.to(self.device)
        self.group = group
        if group is not None:
            group.broadcast_flat_([*self.model.parameters(),
                                   *self.model.buffers()])
        self.model16 = None
        if cfg.train.bf16:
            self.model16 = cast_module_bf16(copy.deepcopy(self.model))
        self.optimizer = TrainOptimizer(self.model.parameters(), cfg.train)
        self.step = 0

    def _compute(self, batch: FABindBatch):
        """(the module that computes, the batch it reads): the model and
        the batch, or under bf16 the bfloat16 copy, refreshed from the
        master weights, and the batch's bfloat16 cast."""
        if self.model16 is None:
            return self.model, batch
        with torch.no_grad():
            torch._foreach_copy_(list(self.model16.parameters()),
                                 list(self.model.parameters()))
        return self.model16, cast_batch_bf16(batch)

    def _forward_loss(self, batch: FABindBatch, cfg_b: FABindConfig,
                      gen: torch.Generator, gumbel_u: Optional[Tensor]):
        """The training forward and the losses on `batch`, and their
        backward: the float32 gradients in the master weights' .grad."""
        group = self.group
        with tracing.span("train.forward"):
            model, b = self._compute(batch)
            model.train()
            model.zero_grad(set_to_none=True)
            rows = (RowMap() if group is None
                    else group.row_map(batch.batch_size))
            with dropout_rng(gen, rows):
                out = model(b, train=True, shapes=cfg_b.shapes,
                            gumbel_u=gumbel_u)
            out = output_float32(out)
        with tracing.span("train.loss"):
            loss, metrics = fabind_losses(
                out, batch, self.cfg.model, self.cfg.train,
                all_sum=None if group is None else group.all_sum)
        with tracing.span("train.backward"):
            loss.backward()
            if self.model16 is not None:
                for p16, p in zip(self.model16.parameters(),
                                  self.model.parameters()):
                    p.grad = None if p16.grad is None else p16.grad.float()
                self.model16.zero_grad(set_to_none=True)
        return metrics

    @tracing.spanned("train.step", lambda self, *_: {"step": self.step})
    def train_step(self, batch: FABindBatch,
                   bucket_cfg: Optional[FABindConfig] = None,
                   gumbel_u: Optional[Tensor] = None) -> Dict[str, float]:
        """One step on `batch` (float32 fields) in `bucket_cfg`'s shapes
        (default cfg). `gumbel_u` [B, Nr, 2] of the global batch replaces
        the step's gumbel uniforms (tests)."""
        cfg_b = bucket_cfg or self.cfg
        gen = step_generator(self.cfg.train.seed, self.step, self.device)
        metrics = self._forward_loss(batch, cfg_b, gen, gumbel_u)
        params = list(self.model.parameters())
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in params]
        if self.group is not None:
            self.group.sum_flat_(grads)
            for p, g in zip(params, grads):
                p.grad = g
        grad_norm = global_norm(grads)
        names = list(metrics)
        vals = torch.stack([metrics[k].detach().float().reshape(())
                            for k in names] + [grad_norm])
        if self.group is not None:
            # each rank's metrics are its share of the global batch's; the
            # gate and the gradient norm are already the same on every rank
            summed = self.group.all_sum(vals)
            same = [names.index("use_stage2"), len(names)]
            summed[same] = vals[same]
            vals = summed
        with tracing.span("train.readback"):
            vals = vals.cpu().numpy().astype(np.float64)
        ok = bool(np.isfinite(vals[names.index("loss")])
                  and np.isfinite(vals[-1]))
        with tracing.span("train.optimizer"):
            if ok:
                self.optimizer.step()
            self.model.zero_grad(set_to_none=True)
        if ok:
            out = dict(zip(names, vals[:-1].tolist()))
            out["grad_norm"] = float(vals[-1])
        else:
            out = {k: 0.0 for k in names}
            out["grad_norm"] = 0.0
        out["skipped_nan"] = 0.0 if ok else 1.0
        self.step += 1
        return out

    def eval_step(self, batch: FABindBatch, stage: int = 2,
                  bucket_cfg: Optional[FABindConfig] = None) -> FABindOutput:
        """The deterministic forward at `stage` (1: the precomputed pocket,
        2: the predicted one) of the float32 master weights on the float32
        batch, whatever cfg.train.bf16 says: the JAX eval step runs
        state.params, and bf16 is a property of the training step only."""
        return eval_forward(self.model, batch, stage,
                            (bucket_cfg or self.cfg).shapes)

    # ------------------------------------------------------------ state
    def state_dict(self) -> Dict:
        """Model, optimizer (moments, update count, accumulator) and step,
        as CPU tensors."""
        return {"model": to_cpu(self.model.state_dict()),
                "optimizer": to_cpu(self.optimizer.state_dict()),
                "step": self.step}

    def load_state_dict(self, sd: Dict) -> None:
        self.model.load_state_dict(sd["model"], strict=True)
        self.optimizer.load_state_dict(sd["optimizer"])
        self.step = int(sd["step"])


def eval_forward(model, batch: FABindBatch, stage: int = 2,
                 shapes=None) -> FABindOutput:
    """The deterministic forward of `model` at `stage` in the shape bucket
    `shapes` (default the model's): the evaluation step of `cli.train` and
    `cli.evaluate`."""
    model.eval()
    with torch.inference_mode():
        return model(batch, stage=stage, train=False, shapes=shapes)


def to_cpu(obj):
    """A copy of nested dicts/lists of tensors with every tensor on the
    CPU (one copy per tensor: a device tensor's `.cpu()` is already one)."""
    if isinstance(obj, Tensor):
        t = obj.detach()
        return t.clone() if t.device.type == "cpu" else t.cpu()
    if isinstance(obj, dict):
        return {k: to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(to_cpu(v) for v in obj)
    return obj
