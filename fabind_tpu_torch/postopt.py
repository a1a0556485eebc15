"""Post-optimization of predicted poses against the LAS conformer
constraints.

Counterpart of fabind_tpu/postopt.py `configuration_loss` and
`post_optimize_batch`: the reference's per-molecule Adam loop (lr 0.1;
loss = sum |cdist(x, x) - ref_dis| over the LAS mask + 2 sum relu(1.22 -
cdist)) run on the whole batch at once, on the batch's device.

Gradient conventions are the JAX package's: `safe_sqrt` has a zero gradient
at 0 and `abs` and `relu` a zero gradient at 0 (in both frameworks), so the
excluded-volume term may keep its constant diagonal.
"""
from __future__ import annotations

from typing import Tuple

import torch

from fabind_tpu_torch.ops.geometry import pairwise_dist

Tensor = torch.Tensor


def configuration_loss(x: Tensor, ref_dis: Tensor, las_mask: Tensor,
                       atom_mask: Tensor) -> Tensor:
    """Per-sample loss [B] of poses x [B, Nc, 3] against the reference
    distances ref_dis [B, Nc, Nc] on the LAS pairs, plus the excluded volume
    (1.22 A) over every valid pair."""
    d = pairwise_dist(x, x)
    pm = atom_mask[..., :, None] & atom_mask[..., None, :]
    las = (las_mask & pm).to(x.dtype)
    loss = ((d - ref_dis).abs() * las).sum((-1, -2))
    # the reference includes the (constant, zero-gradient) diagonal: pm,
    # not pm & ~eye
    return loss + 2.0 * (torch.relu(1.22 - d) * pm.to(x.dtype)).sum((-1, -2))


def post_optimize_batch(pred_coords: Tensor, ref_coords: Tensor,
                        las_mask: Tensor, atom_mask: Tensor,
                        steps: int = 1000, lr: float = 0.1
                        ) -> Tuple[Tensor, Tensor]:
    """Batched pose refinement: `steps` Adam steps on the sum over the batch
    of `configuration_loss`.

    pred_coords [B, Nc, 3] (the start), ref_coords [B, Nc, 3] (the rdkit
    conformer whose distances are the constraint), las_mask [B, Nc, Nc],
    atom_mask [B, Nc]. Returns (optimized coords, final loss [B]), both
    detached, in pred_coords' dtype and device.

    torch.optim.Adam's update is the formula of optax.adam(lr, b1=0.9,
    b2=0.999, eps=1e-8): m and v as exponential averages, both
    bias-corrected, x -= lr * m_hat / (sqrt(v_hat) + eps).

    Safe to call under `torch.inference_mode()`: the inputs are cloned into
    ordinary tensors and the loop runs with autograd on.
    """
    with torch.inference_mode(False), torch.enable_grad():
        ref, las, mask = (t.detach().clone()
                          for t in (ref_coords, las_mask, atom_mask))
        ref_dis = pairwise_dist(ref, ref)
        x = pred_coords.detach().clone().requires_grad_()
        opt = torch.optim.Adam([x], lr=lr, betas=(0.9, 0.999), eps=1e-8)
        for _ in range(steps):
            opt.zero_grad(set_to_none=True)
            configuration_loss(x, ref_dis, las, mask).sum().backward()
            opt.step()
        x = x.detach()
        return x, configuration_loss(x, ref_dis, las, mask)
