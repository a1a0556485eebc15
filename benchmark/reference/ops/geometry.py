"""Geometric primitives: safe division, masked means, pairwise distances,
the LAS projection, and the per-sample RMSD and centroid distance the losses
report.

Counterpart of fabind_tpu/ops/geometry.py. n_channel is 1 throughout the
FABind family, so radial is the scalar squared distance per edge.
"""
from __future__ import annotations

import torch

Tensor = torch.Tensor


def safe_div(a: Tensor, b: Tensor) -> Tensor:
    return a / torch.where(b == 0, torch.ones_like(b), b)


def las_projection_step(x: Tensor, las_ref: Tensor, las_adj: Tensor,
                        step_size: float, clamp: float,
                        steps: int = 1) -> Tensor:
    """LAS projected-gradient corrections on ligand coords.

    For every LAS edge (i, j):
      force_ij = 2 * (|x_i - x_j|^2 - |t_i - t_j|^2) * 2 * (x_i - x_j)
      delta_j  = sum_i force_ij
      x += clamp(delta * step_size, ±clamp)

    x, las_ref: [B, Nc, 3] (normalized); las_adj: [B, Nc, Nc] bool,
    symmetric, zero diagonal.
    """
    ref_d2 = ((las_ref[:, :, None, :] - las_ref[:, None, :, :]) ** 2).sum(-1)
    adj = las_adj.to(x.dtype)
    for _ in range(steps):
        diff = x[:, :, None, :] - x[:, None, :, :]          # x_i - x_j
        cur_d2 = (diff * diff).sum(-1)
        coef = 4.0 * (cur_d2 - ref_d2) * adj                # [B, Nc, Nc]
        delta = torch.einsum("bij,bijd->bjd", coef, diff)
        x = x + torch.clamp(delta * step_size, -clamp, clamp)
    return x


def safe_sqrt(d2: Tensor) -> Tensor:
    """sqrt with a zero (not inf) gradient at 0."""
    pos = d2 > 0
    return torch.where(pos, torch.sqrt(torch.where(pos, d2, 1.0)), 0.0)


def pairwise_dist(a: Tensor, b: Tensor) -> Tensor:
    """[..., M, 3] x [..., N, 3] -> [..., M, N] Euclidean distances."""
    d2 = ((a[..., :, None, :] - b[..., None, :, :]) ** 2).sum(-1)
    return safe_sqrt(d2)


def masked_mean(v: Tensor, mask: Tensor, dim=None) -> Tensor:
    """Mean of v over the True entries of mask along `dim` (all dims when
    None); 0 where the mask is empty."""
    m = mask.to(v.dtype)
    if dim is None:
        return safe_div((v * m).sum(), m.sum())
    return safe_div((v * m).sum(dim), m.sum(dim))


def rmsd(pred: Tensor, true: Tensor, mask: Tensor) -> Tensor:
    """Per-sample ligand RMSD [B] from [B, Nc, 3] coords and mask [B, Nc]."""
    return torch.sqrt(masked_mean(((pred - true) ** 2).sum(-1), mask, dim=1))


def centroid_dist(pred: Tensor, true: Tensor, mask: Tensor) -> Tensor:
    """Per-sample distance [B] between the masked centroids."""
    m = mask[..., None].to(pred.dtype)
    den = m.sum(1).clamp(min=1.0)
    return torch.linalg.norm((pred * m).sum(1) / den - (true * m).sum(1) / den,
                             dim=-1)
