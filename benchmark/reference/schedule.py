"""Learning-rate schedules and the optimizer of FABind training.

Own copy of fabind_tpu/train/schedule.py in torch terms:
- `build_schedule(cfg)(t)` is the learning rate of optimizer update t, equal
  to the JAX package's optax schedule at every t: a linear warmup from
  0.5 * lr to lr over warmup_epochs * steps_per_epoch updates, then
  constant | poly_decay | cosine_decay | cosine_decay_restart | exp_decay.
- `TrainOptimizer` is the JAX package's `build_optimizer` chain: gradient
  accumulation over cfg.gradient_accumulate_step micro-batches (the running
  mean of optax.MultiSteps), then the global-norm clip at 1.0 as
  optax.clip_by_global_norm computes it (g / ||g|| * 1.0 when ||g|| >= 1;
  torch's clip_grad_norm_ divides by ||g|| + 1e-6 instead), then torch's
  AdamW / Adam (b1 0.9, b2 0.999, eps 1e-8, optax's defaults; decoupled
  weight decay scaled by the scheduled lr, as optax.adamw) at the lr of its
  update count, which advances once per update, as optax's does.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List

import torch

from benchmark.reference.config import TrainConfig

Tensor = torch.Tensor
CLIP_NORM = 1.0


def build_schedule(cfg: TrainConfig) -> Callable[[int], float]:
    """The learning rate of optimizer update t (t = 0 for the first)."""
    warmup_steps = cfg.warmup_epochs * cfg.steps_per_epoch
    main_steps = max(
        (cfg.total_epochs - cfg.warmup_epochs) * cfg.steps_per_epoch, 1)
    lr = cfg.lr
    name = cfg.lr_scheduler

    def warmup(t: int) -> float:
        if warmup_steps <= 0:
            return 0.5 * lr
        frac = 1.0 - min(max(t, 0), warmup_steps) / warmup_steps
        return 0.5 * lr * frac + lr * (1.0 - frac)

    if name == "constant":
        def main(t: int) -> float:
            return lr
    elif name == "poly_decay":
        def main(t: int) -> float:
            return lr * (1.0 - min(max(t, 0), main_steps) / main_steps)
    elif name == "exp_decay":
        def main(t: int) -> float:
            return lr if t <= 0 else lr * 0.995 ** t
    elif name == "cosine_decay":
        alpha = 1e-5 / lr

        def main(t: int) -> float:
            c = 0.5 * (1 + math.cos(math.pi * min(t, main_steps) / main_steps))
            return lr * ((1 - alpha) * c + alpha)
    elif name == "cosine_decay_restart":
        t0, eta = 10, 1e-4

        def main(t: int) -> float:
            return eta + 0.5 * (lr - eta) * (1 + math.cos(math.pi * (t % t0)
                                                          / t0))
    else:
        raise ValueError(name)

    def schedule(t: int) -> float:
        return warmup(t) if t < warmup_steps else main(t - warmup_steps)

    return schedule


def global_norm(grads: List[Tensor]) -> Tensor:
    """sqrt of the sum of squares over every gradient (float32 gradients;
    a few launches however many tensors)."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))


class TrainOptimizer:
    """Accumulate -> clip -> AdamW/Adam at the scheduled lr, over `params`
    whose .grad holds a micro-batch's gradient when `step` is called."""

    def __init__(self, params, cfg: TrainConfig):
        self.params = [p for p in params]
        self.cfg = cfg
        self.schedule = build_schedule(cfg)
        kw = dict(lr=self.schedule(0), betas=(0.9, 0.999), eps=1e-8)
        if cfg.optim == "adamw":
            self.opt = torch.optim.AdamW(self.params,
                                         weight_decay=cfg.weight_decay, **kw)
        elif cfg.optim == "adam":
            self.opt = torch.optim.Adam(self.params, weight_decay=0.0, **kw)
        else:
            raise ValueError(cfg.optim)
        self.k = max(cfg.gradient_accumulate_step, 1)
        self.mini_step = 0          # micro-batches in the accumulator
        self.updates = 0            # optimizer updates so far
        self.acc: List[Tensor] = []

    def step(self) -> bool:
        """Take this micro-batch's gradient; returns True when it completed
        an update (every k-th call)."""
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in self.params]
        if self.k > 1:
            if not self.acc:
                self.acc = [torch.zeros_like(p) for p in self.params]
            # optax.MultiSteps' running mean: acc += (g - acc) / (n + 1)
            torch._foreach_add_(self.acc, torch._foreach_div(
                torch._foreach_sub(grads, self.acc), self.mini_step + 1))
            self.mini_step += 1
            if self.mini_step < self.k:
                return False
            grads = [a.clone() for a in self.acc]
            torch._foreach_zero_(self.acc)
            self.mini_step = 0
        if self.cfg.clip_grad:
            # g / ||g|| * 1.0 when ||g|| >= 1, else g (CLIP_NORM is 1.0, so
            # dividing by ||g|| / CLIP_NORM is the same rounding)
            norm = global_norm(grads)
            torch._foreach_div_(grads, torch.where(
                norm < CLIP_NORM, torch.ones_like(norm), norm / CLIP_NORM))
        for p, g in zip(self.params, grads):
            p.grad = g
        for group in self.opt.param_groups:
            group["lr"] = self.schedule(self.updates)
        self.opt.step()
        self.updates += 1
        return True

    def state_dict(self) -> Dict:
        return {"opt": self.opt.state_dict(), "updates": self.updates,
                "mini_step": self.mini_step,
                "acc": [a.detach().cpu() for a in self.acc]}

    def load_state_dict(self, sd: Dict) -> None:
        self.opt.load_state_dict(sd["opt"])
        self.updates = int(sd["updates"])
        self.mini_step = int(sd["mini_step"])
        dev = self.params[0].device
        self.acc = [a.to(dev) for a in sd["acc"]]
