"""The loss stack of FABind training, and the confidence head's ranking
loss.

Own copy of fabind_tpu/train/losses.py `fabind_losses` and
`confidence_ranking_loss`. `fabind_losses`: masked means over
the valid entries of dense tensors; trailing-batch padding duplicates
(batch.sample_valid False) weigh zero in every term and metric. The
pocket-cls BCE sums over the padded grid (legacy_padded_bce, the
reference's rescaled padded mean), so its value depends on the bucket's Nr.

Every term is a ratio of sums over the batch: a masked mean pooled over
the ligand atoms, pair cells, residues or pocket rows of every sample, or
a row mean over the valid samples. Under data parallelism a rank holds
some rows, and `all_sum` makes each denominator the global batch's, so a
rank's loss is its share of the global loss: the ranks' gradients and
metrics sum to the one-process values on the global batch. Two metrics
are not such ratios: `use_stage2` (the batch-level gate, equal on every
rank) and the counters `keep_less_5` and `pocket_overflow`, plain sums.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from benchmark.reference.config import ModelConfig, TrainConfig
from benchmark.reference.ops import geometry
from benchmark.reference.ops.geometry import safe_div

Tensor = torch.Tensor


def smooth_l1(pred: Tensor, target: Tensor, beta: float = 1.0) -> Tensor:
    d = (pred - target).abs()
    return torch.where(d < beta, 0.5 * d * d / beta, d - 0.5 * beta)


def huber(pred: Tensor, target: Tensor, delta: float) -> Tensor:
    d = (pred - target).abs()
    return torch.where(d < delta, 0.5 * d * d, delta * (d - 0.5 * delta))


def bce_with_logits(logits: Tensor, labels: Tensor) -> Tensor:
    return (logits.clamp(min=0) - logits * labels
            + torch.log1p(torch.exp(-logits.abs())))


def coord_criterion(name: str):
    if name == "SmoothL1":
        return smooth_l1
    if name == "MSE":
        return lambda p, t: (p - t) ** 2
    raise ValueError(name)


def _plain(pred: Tensor, gt: Tensor, lig_mask: Tensor, crit,
           den: Tensor) -> Tensor:
    """The criterion's mean over the ligand atoms of lig_mask, pooled over
    `den` atoms (the mask's count, or a global batch's under data
    parallelism)."""
    per_atom = crit(pred, gt).mean(-1)
    return safe_div((per_atom * lig_mask.to(per_atom.dtype)).sum(), den)


def _permute(pred: Tensor, perm: Tensor) -> Tensor:
    """pred [B, Nc, 3] gathered along atoms by perm [B, ..., Nc]."""
    B = pred.shape[0]
    flat = perm.reshape(B, -1)
    out = torch.gather(pred, 1, flat[..., None].expand(B, flat.shape[1], 3))
    return out.reshape(*perm.shape, 3)


def permutation_coord_loss(pred: Tensor, gt: Tensor, lig_mask: Tensor,
                           isomorphisms: Optional[Tensor],
                           iso_mask: Optional[Tensor], crit,
                           den: Tensor) -> Tensor:
    """Permutation-invariant coordinate loss: per sample, the ligand-graph
    automorphism (isomorphisms [B, n_iso, Nc], rows with iso_mask False are
    identity copies) with the least coordinate loss, chosen without
    gradient, then the criterion through it, pooled over `den` atoms as
    `_plain`."""
    if isomorphisms is None:
        return _plain(pred, gt, lig_mask, crit, den)
    per_atom = crit(_permute(pred, isomorphisms), gt[:, None]).mean(-1)
    m = lig_mask[:, None, :].to(per_atom.dtype)
    per_iso = (per_atom * m).sum(-1) / m.sum(-1).clamp(min=1.0)
    per_iso = torch.where(iso_mask, per_iso, torch.inf)
    best = per_iso.detach().argmin(1)                             # [B]
    best_iso = torch.gather(
        isomorphisms, 1,
        best[:, None, None].expand(-1, 1, isomorphisms.shape[-1]))[:, 0]
    return _plain(_permute(pred, best_iso), gt, lig_mask, crit, den)


def fabind_losses(out, batch, mcfg: ModelConfig, tcfg: TrainConfig,
                  all_sum: Optional[Callable[[Tensor], Tensor]] = None
                  ) -> Tuple[Tensor, Dict[str, Tensor]]:
    """(total loss, metrics) of a FABindOutput `out` (float32) against the
    float32 batch. `all_sum` (a data-parallel rank's sum over every rank)
    pools each term's denominator over the global batch (module
    docstring)."""
    crit = coord_criterion(tcfg.coord_loss_function)
    B = batch.lig_feat.shape[0]
    if batch.sample_valid is not None:
        sv = batch.sample_valid.bool()
    else:
        sv = torch.ones(B, dtype=torch.bool, device=batch.lig_feat.device)
    svf = sv.float()

    out = dataclasses.replace(
        out, lig_mask=out.lig_mask & sv[:, None],
        pair_valid=out.pair_valid & sv[:, None, None],
        prot_mask=out.prot_mask & sv[:, None],
        pkt_mask=out.pkt_mask & sv[:, None])
    pv = out.pair_valid

    # the pooled means' denominators: this batch's counts, or the global
    # batch's under data parallelism (one collective for all of them)
    pools = {"lig": out.lig_mask, "pair": pv, "prot": out.prot_mask,
             "rows": sv, "pkt": out.pkt_mask}
    dens = torch.stack([m.float().sum() for m in pools.values()])
    if all_sum is not None:
        dens = all_sum(dens)
    den = dict(zip(pools, dens.unbind()))

    def pooled(v, key):
        """masked_mean of v over pool `key`, with its denominator."""
        return safe_div((v * pools[key].to(v.dtype)).sum(), den[key])

    def row_mean(x):
        return (x * svf).sum() / den["rows"].clamp(min=1.0)

    if tcfg.permutation_invariant and batch.isomorphisms is not None:
        com_coord_loss = permutation_coord_loss(
            out.coords, batch.lig_coords, out.lig_mask, batch.isomorphisms,
            batch.iso_mask, crit, den["lig"])
    else:
        com_coord_loss = _plain(out.coords, batch.lig_coords, out.lig_mask,
                                crit, den["lig"])
    com_coord_loss = tcfg.coord_loss_weight * com_coord_loss

    # distance-map losses (MSE)
    contact_loss = pooled((out.y_pred - out.dis_map_target) ** 2, "pair")
    contact_by_pred = pooled(
        (out.y_pred_by_coord - out.dis_map_target) ** 2, "pair")
    contact_distill = pooled((out.y_pred_by_coord - out.y_pred) ** 2, "pair")
    w = tcfg.pair_distance_loss_weight
    wd = tcfg.pair_distance_distill_loss_weight
    zero = torch.zeros((), device=out.coords.device)
    if tcfg.dismap_choice == "wodm":
        contact_loss = contact_distill = zero
        dismap_total = w * contact_by_pred
    else:
        # 'npair' and 'ori' train identically (the reference special-cases
        # only 'wodm')
        dismap_total = (w * contact_loss + w * contact_by_pred
                        + wd * contact_distill)

    # pocket classification
    bce = bce_with_logits(out.pocket_cls_logits,
                          out.pocket_cls_label) * svf[:, None]
    if tcfg.legacy_padded_bce:
        pocket_cls_loss = bce.sum() / den["prot"].clamp(min=1)
    else:
        pocket_cls_loss = pooled(bce, "prot")
    pocket_cls_loss = tcfg.pocket_cls_loss_weight * pocket_cls_loss

    pocket_coord_loss = tcfg.pocket_distance_loss_weight * row_mean(
        huber(out.pred_pocket_center, batch.coords_center,
              tcfg.pocket_coord_huber_delta).mean(-1))

    radius_loss = zero
    if mcfg.is_plus and not mcfg.force_fix_radius:
        radius_loss = tcfg.pocket_radius_loss_weight * row_mean(
            huber(out.pocket_radius_pred, batch.ligand_radius,
                  tcfg.pocket_coord_huber_delta))

    # flexible docking: the docked pocket against the batch's pocket
    # residues (holo self-consistency)
    flex_pocket_loss = zero
    if mcfg.flexible_docking:
        gt_pkt = torch.gather(
            batch.prot_xyz, 1,
            out.pkt_idx.long()[..., None].expand(-1, -1, 3))
        per = crit(out.pocket_coords, gt_pkt).mean(-1)
        flex_pocket_loss = (tcfg.flex_pocket_coord_loss_weight
                            * pooled(per, "pkt"))

    total = (com_coord_loss + dismap_total + pocket_cls_loss
             + pocket_coord_loss + radius_loss + flex_pocket_loss)

    coords = out.coords.detach()
    rmsd = geometry.rmsd(coords, batch.lig_coords, out.lig_mask)
    centroid = geometry.centroid_dist(coords, batch.lig_coords, out.lig_mask)
    stage2 = float(out.use_stage2)
    metrics = {
        "loss": total,
        "com_coord_loss": com_coord_loss,
        "contact_loss": contact_loss,
        "contact_by_pred_loss": contact_by_pred,
        "contact_distill_loss": contact_distill,
        "pocket_cls_loss": pocket_cls_loss,
        "pocket_coord_loss": pocket_coord_loss,
        "pocket_radius_loss": radius_loss,
        "flex_pocket_coord_loss": flex_pocket_loss,
        "rmsd_mean": row_mean(rmsd),
        "rmsd_lt2": row_mean((rmsd < 2.0).float()),
        "rmsd_lt5": row_mean((rmsd < 5.0).float()),
        "centroid_dis_mean": row_mean(centroid),
        "use_stage2": torch.full((), stage2, device=coords.device),
        # counters over the real rows, only when the predicted crop docked
        "keep_less_5": (out.keep_less_5.float() * svf).sum() * stage2,
        "pocket_overflow": (out.pocket_overflow.float() * svf).sum() * stage2,
    }
    return total, metrics


def confidence_ranking_loss(scores: Tensor, rmsds: Tensor,
                            valid: Optional[Tensor] = None,
                            loss_type: str = "logsigmoid",
                            keep_cls_2a: bool = False,
                            groups: Optional[Tensor] = None) -> Tensor:
    """Pairwise ranking loss over scored poses [n]: a pose with the lower
    RMSD should score higher. A pair (i, j) has i "better" when its RMSD is
    strictly lower, or equal with the lower index (the orientation of a
    stable sort), so every unordered valid pair counts once, ties included.
    `valid` [n] masks padding entries out of every pair.

    groups None: the mean over every pair of the flat set. groups [n]: pairs
    form within a group (a complex's copies) only; each group's sum is
    normalized by its own pair count and the groups that formed a pair are
    averaged, the mean of the reference's one-complex steps.

    loss_type "logsigmoid": -log sigmoid(s_better - s_worse);
    "dynamic_hinge": relu((r_worse - r_better) - (s_better - s_worse)).
    keep_cls_2a adds the BCE of the scores against RMSD < 2 A over the
    valid entries."""
    s = scores.float()
    r = rmsds.float()
    n = s.shape[0]
    v = (torch.ones(n, dtype=torch.bool, device=s.device) if valid is None
         else valid.bool())
    idx = torch.arange(n, device=s.device)
    better = ((r[:, None] < r[None, :])
              | ((r[:, None] == r[None, :]) & (idx[:, None] < idx[None, :])))
    better = better & v[:, None] & v[None, :]
    if groups is not None:
        better = better & (groups[:, None] == groups[None, :])
    bf = better.float()
    diff = s[:, None] - s[None, :]              # score(better) - score(worse)
    if loss_type == "logsigmoid":
        pair_loss = -F.logsigmoid(diff) * bf
    elif loss_type == "dynamic_hinge":
        margin = r[None, :] - r[:, None]        # rmsd(worse) - rmsd(better)
        pair_loss = torch.relu(margin - diff) * bf
    else:
        raise ValueError(loss_type)
    if groups is None:
        loss = pair_loss.sum() / bf.sum().clamp(min=1.0)
    else:
        onehot = (groups[None, :] == groups.unique()[:, None]).float()
        g_pairs = torch.einsum("gi,ij,gj->g", onehot, bf, onehot)
        g_loss = torch.einsum("gi,ij,gj->g", onehot, pair_loss, onehot)
        has = (g_pairs > 0).float()
        loss = ((g_loss / g_pairs.clamp(min=1.0) * has).sum()
                / has.sum().clamp(min=1.0))
    if keep_cls_2a:
        vf = v.float()
        ce = ((bce_with_logits(s, (r < 2.0).float()) * vf).sum()
              / vf.sum().clamp(min=1.0))
        loss = loss + ce
    return loss
