"""The reference's training steps: the first steps of a training run worked
out again from the raw complexes and the weights.

`loader_batches` rebuilds the batches the port's host loader (one process,
worker threads) cuts from a shuffled epoch: the shuffle and one seed per
sample from RandomState(seed + epoch), each sample featurized with its own
RandomState (noisy crop, rotation), routed to the smallest bucket it fits
and batched per bucket in the order the buckets fill. `train_steps` takes
the steps in float32: the training forward inside the step's generator
(dropout masks, recycle counts, gumbel uniforms, stage coin), the losses,
the backward, the clip and AdamW (schedule.py).
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from benchmark.reference.batching import build_sample, collate
from benchmark.reference.buckets import route_sample
from benchmark.reference.losses import fabind_losses
from benchmark.reference.models.fabind import make_model
from benchmark.reference.models.layers import dropout_rng
from benchmark.reference.schedule import TrainOptimizer, global_norm
from benchmark.reference.types import FABindBatch

BETA1 = 0.9


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The generator of training step `step`, a function of (seed, step)."""
    s = int(np.random.SeedSequence([seed, step]).generate_state(
        1, np.uint64)[0] >> 1)
    return torch.Generator(device).manual_seed(s)


def loader_batches(pool: Sequence[Dict], cfg, bucket_cfgs, batch_size: int,
                   seed: int, n: int, epoch: int = 0
                   ) -> List[Tuple[Dict, object, List[int]]]:
    """The first n full batches of the epoch: (host arrays, bucket cfg,
    pool indices of its rows)."""
    rng = np.random.RandomState(seed + epoch)
    order = list(range(len(pool)))
    rng.shuffle(order)
    seeds = rng.randint(0, 2 ** 31 - 1, size=len(order))
    bufs = {id(c): [] for c in bucket_cfgs}
    out = []
    for i, idx in enumerate(order):
        s = build_sample(pool[idx], cfg, group="train",
                         rng=np.random.RandomState(seeds[i]))
        c = route_sample(s, bucket_cfgs)
        if c is None:
            continue
        buf = bufs[id(c)]
        buf.append((idx, s))
        if len(buf) == batch_size:
            out.append((collate([x for _, x in buf], c, n_valid=batch_size),
                        c, [j for j, _ in buf]))
            bufs[id(c)] = []
            if len(out) == n:
                break
    return out


def leaf_norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(v.float().norm()) for k, v in tensors.items()}


def train_steps(cfg, state_dict: Dict[str, torch.Tensor], batches,
                device) -> Dict:
    """Take one step per batch from the weights `state_dict`: {"losses":
    per step, "grad1": {leaf: the norm of the first step's gradient as the
    optimizer takes it}, "change": {leaf: the norm of the parameters'
    change after the last step}}."""
    model = make_model(cfg)
    model.load_state_dict(state_dict, strict=True)
    model = model.to(device=device, dtype=torch.float32).train()
    start = {k: v.detach().clone() for k, v in model.named_parameters()}
    opt = TrainOptimizer(model.parameters(), cfg.train)
    names = [k for k, _ in model.named_parameters()]
    losses, grad1 = [], {}
    for step, (arrays, c, _) in enumerate(batches):
        batch = FABindBatch.from_numpy(arrays, device)
        gen = step_generator(cfg.train.seed, step, device)
        model.zero_grad(set_to_none=True)
        with dropout_rng(gen):
            out = model(batch, train=True, shapes=c.shapes)
        loss, _ = fabind_losses(out, batch, cfg.model, cfg.train)
        loss.backward()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in model.parameters()]
        if not (torch.isfinite(loss) and torch.isfinite(global_norm(grads))):
            raise FloatingPointError(f"reference step {step} is not finite")
        opt.step()
        losses.append(float(loss.detach()))
        if step == 0:
            grad1 = first_gradients(opt, names)
        model.zero_grad(set_to_none=True)
    change = {k: p.detach() - start[k] for k, p in model.named_parameters()}
    return {"losses": losses, "grad1": grad1, "change": leaf_norms(change)}


def first_gradients(opt, names: List[str]) -> Dict[str, float]:
    """Each leaf's gradient norm as the optimizer took it in its first
    update: AdamW's first moment after one update is (1 - beta1) g."""
    state = opt.opt.state
    return {k: float(state[p]["exp_avg"].norm()) / (1 - BETA1)
            if p in state else 0.0 for k, p in zip(names, opt.params)}
