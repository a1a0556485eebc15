"""Pocket-center selection from residue classification logits.

Counterpart of fabind_tpu/ops/gumbel.py: the deterministic no-random gumbel
softmax center and the rounded-sigmoid center of inference, and the
training forward's gumbel-softmax center, whose uniform draws come from an
explicit torch.Generator or are passed in as a tensor (so a test can feed
the draws the JAX package made).
"""
from __future__ import annotations

from typing import Optional

import torch

from benchmark.reference.ops.geometry import safe_div

Tensor = torch.Tensor


def _straight_through(y_soft: Tensor, hard: bool, dim: int) -> Tensor:
    if not hard:
        return y_soft
    idx = y_soft.argmax(dim=dim, keepdim=True)
    y_hard = torch.zeros_like(y_soft).scatter_(dim, idx, 1.0)
    return y_hard - y_soft.detach() + y_soft


def gumbel_softmax_no_random(logits: Tensor, tau: float = 1.0,
                             hard: bool = False, dim: int = -1) -> Tensor:
    """Plain softmax of logits/tau, optionally straight-through hard."""
    return _straight_through(torch.softmax(logits / tau, dim=dim), hard, dim)


def gumbel_softmax(logits: Tensor, generator: Optional[torch.Generator] = None,
                   tau: float = 1.0, hard: bool = False, dim: int = -1,
                   u: Optional[Tensor] = None) -> Tensor:
    """torch.nn.functional.gumbel_softmax's function with explicit draws:
    u uniform in [tiny, 1) (from `generator`, or given), g = -log(-log u),
    softmax((logits + g) / tau), then straight-through when `hard`."""
    if u is None:
        u = torch.rand(logits.shape, generator=generator,
                       device=logits.device, dtype=logits.dtype)
        u = u.clamp(min=torch.finfo(logits.dtype).tiny)
    g = -torch.log(-torch.log(u.to(logits.dtype)))
    return _straight_through(torch.softmax((logits + g) / tau, dim=dim), hard,
                             dim)


def pocket_center_from_cls(cls_logits: Tensor, coords: Tensor, mask: Tensor,
                           tau: float, hard: bool,
                           generator: Optional[torch.Generator] = None,
                           u: Optional[Tensor] = None) -> Tensor:
    """Soft pocket center: p = sigmoid(logit); two-class log-prob
    [log(1-p), log(p)] clamped to [1e-6, 1-1e-6]; gumbel softmax (the
    no-random one unless a `generator` or uniforms `u` [B, Nr, 2] are given);
    center = sum w_i x_i / sum w_i with w the class-1 weight on valid rows.

    cls_logits/mask: [B, Nr]; coords: [B, Nr, 3] -> [B, 3].
    """
    p_true = torch.sigmoid(cls_logits)[..., None]
    prob = torch.cat([1.0 - p_true, p_true], dim=-1).clamp(1e-6, 1 - 1e-6)
    if generator is None and u is None:
        one_hot = gumbel_softmax_no_random(torch.log(prob), tau=tau, hard=hard)
    else:
        one_hot = gumbel_softmax(torch.log(prob), generator, tau=tau,
                                 hard=hard, u=u)
    w = one_hot[..., 1] * mask.to(one_hot.dtype)
    num = (w[..., None] * coords).sum(1)
    den = w.sum(1, keepdim=True)
    return safe_div(num, den)


def pocket_center_rounded(cls_logits: Tensor, coords: Tensor, mask: Tensor,
                          tau: float, hard: bool) -> Tensor:
    """Inference-time center: mean of residues whose sigmoid rounds to 1;
    the no-random gumbel center when no residue is predicted positive."""
    pos = (torch.sigmoid(cls_logits) >= 0.5) & mask
    w = pos.to(coords.dtype)
    den = w.sum(1, keepdim=True)
    rounded = safe_div((w[..., None] * coords).sum(1), den)
    fallback = pocket_center_from_cls(cls_logits, coords, mask, tau, hard)
    return torch.where(den > 0, rounded, fallback)
