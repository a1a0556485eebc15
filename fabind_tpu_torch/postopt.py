"""Post-optimization of predicted poses against the LAS conformer
constraints, and the legacy distance-map docking.

Counterpart of fabind_tpu/postopt.py:
- `configuration_loss` and `post_optimize_batch`: the reference's
  per-molecule Adam loop (lr 0.1; loss = sum |cdist(x, x) - ref_dis| over
  the LAS mask + 2 sum relu(1.22 - cdist)) run on the whole batch at once,
  on the batch's device;
- `distance_map_loss`, `distance_optimize_batch` and `distance_dock_best_of`:
  TankBind-style docking that discards the coordinate head's pose and fits
  coordinates to the predicted distance map plus the LAS constraints, from
  random starts around the pocket center, keeping each complex's restart
  with the lowest final loss.

Gradient conventions are the JAX package's: `safe_sqrt` has a zero gradient
at 0 and `abs` and `relu` a zero gradient at 0 (in both frameworks), so the
excluded-volume term may keep its constant diagonal.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from fabind_tpu_torch.ops.geometry import pairwise_dist, safe_sqrt

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


def distance_map_loss(epoch: float, x: Tensor, y_pred: Tensor,
                      protein_xyz: Tensor, ref_dis: Tensor, las_mask: Tensor,
                      atom_mask: Tensor, pkt_mask: Tensor,
                      dis_thres: float = 10.0, mode: int = 0) -> Tensor:
    """Per-sample loss [B] of poses x [B, Nc, 3] against the predicted
    distance map y_pred [B, Np, Nc] to the pocket residues protein_xyz
    [B, Np, 3]: err(min(cdist(P, x), dis_thres) - y_pred) summed over the
    valid pairs, plus the configuration loss weighted 5e-3 * (epoch - 500)
    after step 500. mode picks err: 0 |e|, 1 e^2, 2 sqrt(|e| + 1e-5)."""
    dis = pairwise_dist(protein_xyz, x)
    pm = (pkt_mask[..., :, None] & atom_mask[..., None, :]).to(x.dtype)
    err = torch.clamp(dis, max=dis_thres) - y_pred
    if mode == 0:
        err = err.abs()
    elif mode == 1:
        err = err ** 2
    elif mode == 2:
        err = safe_sqrt(err.abs() + 1e-5)
    else:
        raise ValueError(f"unknown distance loss mode {mode}")
    inter = (err * pm).sum((-1, -2))
    conf = configuration_loss(x, ref_dis, las_mask, atom_mask)
    return inter + max(epoch - 500.0, 0.0) * 5e-3 * conf


def pocket_starts(protein_xyz: Tensor, pkt_mask: Tensor, shape,
                  generator: Optional[torch.Generator] = None) -> Tensor:
    """Random starts of `shape` [..., B, Nc, 3]: every atom uniform within
    +-5 A of its complex's pocket center (the mean of the valid pocket
    residues protein_xyz [B, Np, 3], pkt_mask [B, Np])."""
    pc = ((protein_xyz * pkt_mask[..., None]).sum(-2, keepdim=True)
          / pkt_mask.sum(-1).clamp(min=1)[..., None, None])
    u = torch.rand(tuple(shape), generator=generator,
                   dtype=protein_xyz.dtype, device=protein_xyz.device)
    return pc + 5.0 * (2.0 * u - 1.0)


def distance_optimize_batch(y_pred: Tensor, protein_xyz: Tensor,
                            ref_coords: Tensor, las_mask: Tensor,
                            atom_mask: Tensor, pkt_mask: Tensor,
                            generator: Optional[torch.Generator] = None,
                            steps: int = 5000, lr: float = 0.1,
                            dis_thres: float = 10.0, mode: int = 0,
                            x0: Optional[Tensor] = None
                            ) -> Tuple[Tensor, Tensor]:
    """`steps` Adam steps (lr 0.1) on the sum over the batch of
    `distance_map_loss`, step i at epoch i, from x0 [B, Nc, 3] or, without
    it, from atoms uniform within +-5 A of the pocket center (the mean of
    the valid pocket residues), drawn from `generator`. Returns (coords,
    the final loss [B] at epoch = steps), detached.

    Safe under `torch.inference_mode()`, like `post_optimize_batch`."""
    with torch.inference_mode(False), torch.enable_grad():
        y, prot, ref, las, am, pm = (
            t.detach().clone() for t in (y_pred, protein_xyz, ref_coords,
                                         las_mask, atom_mask, pkt_mask))
        ref_dis = pairwise_dist(ref, ref)
        if x0 is None:
            x0 = pocket_starts(prot, pm, ref.shape, generator)
        x = x0.detach().clone().requires_grad_()
        opt = torch.optim.Adam([x], lr=lr, betas=(0.9, 0.999), eps=1e-8)
        for epoch in range(steps):
            opt.zero_grad(set_to_none=True)
            distance_map_loss(float(epoch), x, y, prot, ref_dis, las, am, pm,
                              dis_thres, mode).sum().backward()
            opt.step()
        x = x.detach()
        return x, distance_map_loss(float(steps), x, y, prot, ref_dis, las,
                                    am, pm, dis_thres, mode)


def distance_dock_best_of(y_pred: Tensor, protein_xyz: Tensor,
                          ref_coords: Tensor, las_mask: Tensor,
                          atom_mask: Tensor, pkt_mask: Tensor,
                          generator: Optional[torch.Generator] = None,
                          n_repeat: int = 1, steps: int = 5000,
                          lr: float = 0.1, dis_thres: float = 10.0,
                          mode: int = 0, x0s: Optional[Tensor] = None
                          ) -> Tuple[Tensor, Tensor, Tensor]:
    """n_repeat random restarts of `distance_optimize_batch`, and per
    complex the one with the lowest final loss. The restarts run as one
    batch of n_repeat x B poses: the loss is a sum of per-pose terms and
    Adam acts elementwise, so each restart follows its own trajectory.
    Starts come from x0s [R, B, Nc, 3], or are drawn from `generator`, one
    restart after the other.

    Returns (best coords [B, Nc, 3], all coords [R, B, Nc, 3], final losses
    [R, B])."""
    R = n_repeat
    B, Nc, _ = ref_coords.shape

    def rep(t):
        return t.unsqueeze(0).expand(R, *t.shape).reshape(R * t.shape[0],
                                                           *t.shape[1:])

    if x0s is None:
        x0s = pocket_starts(protein_xyz, pkt_mask, (R, B, Nc, 3), generator)
    xs, losses = distance_optimize_batch(
        rep(y_pred), rep(protein_xyz), rep(ref_coords), rep(las_mask),
        rep(atom_mask), rep(pkt_mask), steps=steps, lr=lr,
        dis_thres=dis_thres, mode=mode, x0=x0s.reshape(R * B, Nc, 3))
    xs, losses = xs.reshape(R, B, Nc, 3), losses.reshape(R, B)
    best = losses.argmin(0)
    return xs[best, torch.arange(B, device=best.device)], xs, losses
