"""FABind+ best-of-N sampling: N stochastic docking passes per complex,
ranked by the confidence head.

Own copy of the library half of fabind_tpu/cli/sample.py. Dropout stays on
in inference, drawn from one torch.Generator per pass (`layers.dropout_rng`),
pocket centers are optionally resampled by host DBSCAN over the residues the
pocket stage predicts positive, and the caller keeps the pose with the
highest confidence. `cfg.model.sampling_pocket_mode` picks the protocol:

  - "stochastic" (default, the reference protocol): every pass is one
    stochastic forward; its pocket stage's logits give that pass's clusters
    and the same stage's embeddings and radius feed its docking.
  - "fixed": one deterministic pocket stage per batch, clustered once; each
    pass picks a cluster at random and runs a whole stochastic forward
    docked at that center.

A stochastic forward also draws its recycle count from 1..n_iter
(cfg.random_n_iter), as the JAX package's does. The draws cannot equal the
JAX package's threefry/rbg streams. What holds instead: the same seed on the
same device gives the same poses, and passes with different indices draw
different masks and counts.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch
from scipy.spatial.distance import cdist

from fabind_tpu_torch.data.types import to_device
from fabind_tpu_torch.models.layers import dropout_rng
from fabind_tpu_torch.ops.gumbel import pocket_center_rounded

Tensor = torch.Tensor


def dbscan_labels(pts: np.ndarray, eps: float, min_samples: int
                  ) -> np.ndarray:
    """DBSCAN cluster labels of points [n, 3], equal to scikit-learn's
    `DBSCAN(eps, min_samples).fit(pts).labels_`: neighbours within eps
    (inclusive, float64 distances, the point itself counted toward
    min_samples); clusters numbered in the index order of their first
    unlabelled core point and grown fully before the next one starts, so a
    border point shared by two clusters keeps the first; noise is -1."""
    pts = np.asarray(pts, np.float64)
    adj = cdist(pts, pts) <= eps
    core = adj.sum(1) >= min_samples
    labels = np.full(len(pts), -1, np.int64)
    n_clusters = 0
    for i in np.flatnonzero(core):
        if labels[i] != -1:
            continue
        labels[i] = n_clusters
        frontier = np.array([i])
        while frontier.size:
            # unlabelled neighbours of the frontier's core points join;
            # only core points grow the cluster further
            reach = adj[frontier[core[frontier]]].any(0) & (labels == -1)
            labels[reach] = n_clusters
            frontier = np.flatnonzero(reach)
        n_clusters += 1
    return labels


def dbscan_clusters(cls_probs: np.ndarray, coords: np.ndarray,
                    mask: np.ndarray, eps: float, min_samples: int) -> list:
    """Per batch row, the list of DBSCAN cluster mean-coordinates over the
    residues with probability > 0.5 (the top 50 valid residues when fewer
    than 50 are), empty when nothing clusters. cls_probs [B, Nr], coords
    [B, Nr, 3] and mask [B, Nr] are host float32/bool arrays."""
    out = []
    for p, valid, xyz in zip(cls_probs, mask, coords):
        pos = (p > 0.5) & valid
        if pos.sum() < 50:
            order = np.argsort(np.where(valid, p, -np.inf))[-50:]
            pos = np.zeros_like(pos)
            pos[order] = True
            pos &= valid
        pts = xyz[pos]
        if len(pts) == 0:
            out.append([])
            continue
        labels = dbscan_labels(pts, eps, min_samples)
        out.append([pts[labels == c].mean(axis=0)
                    for c in range(labels.max() + 1)])
    return out


def pick_cluster_centers(clusters: list, choose_prob: float,
                         default_centers: np.ndarray,
                         rng: np.random.RandomState) -> np.ndarray:
    """Per row with clusters, a uniformly random cluster's mean with
    probability choose_prob, else the default center. The draws (randint,
    then rand, per row with clusters) are the JAX package's, so one
    RandomState gives the same picks on both sides."""
    centers = default_centers.copy()
    for b, cl in enumerate(clusters):
        if not cl:
            continue
        cid = rng.randint(0, len(cl))
        if rng.rand() < choose_prob:
            centers[b] = cl[cid]
    return centers


class _HostCopy:
    """A device tensor's copy to the host, started now and waited for only
    when read: on the card a non-blocking copy into pinned memory and an
    event, so reading it waits for the work queued before the copy, not
    for the work queued after it."""

    def __init__(self, t: Tensor):
        if t.device.type == "cuda":
            self.host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self.host.copy_(t, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host, self.event = t, None

    def numpy(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return self.host.float().numpy()


def _probs(logits: _HostCopy) -> np.ndarray:
    """Sigmoid of the pocket logits on the host, in float32 (a bf16 model's
    logits come back in bf16)."""
    return 1.0 / (1.0 + np.exp(-logits.numpy()))


def pass_generator(seed: int, batch_idx: int, s: int, device
                   ) -> torch.Generator:
    """The dropout generator of sampling pass s of batch batch_idx, on
    `device`."""
    g = torch.Generator(device=device)
    g.manual_seed(((seed * 1000003 + batch_idx) * 1000003 + s) % 2 ** 63)
    return g


def sample_poses(model, batch, cfg, sample_size: int, seed: int = 0,
                 batch_idx: int = 0) -> Tuple[Tensor, Tensor]:
    """`sample_size` stochastic docking passes over one batch of bucket cfg
    (`cfg.shapes`, with the protocol of `cfg.model.sampling_pocket_mode`
    and `cfg.model.use_clustering`); returns (coords [S, B, Nc, 3], scores
    [S, B]) on the batch's device, in the model's dtype. Nothing is copied
    back but each pass's pocket logits, which the host clusters.

    Pass s draws its dropout masks from `pass_generator(seed, batch_idx,
    s)`: its pocket stage first, then its docking. The cluster picks draw
    from one numpy RandomState per batch seeded from (seed, batch_idx), as
    the JAX package's do. Cluster centers go to the crop in float32."""
    m = cfg.model
    shapes = cfg.shapes
    use_clustering = m.use_clustering
    pocket_mode = m.sampling_pocket_mode
    if pocket_mode not in ("fixed", "stochastic"):
        raise ValueError(f"sampling_pocket_mode {pocket_mode!r}")
    device = batch.prot_xyz.device
    rng = np.random.RandomState((seed * 1000003 + batch_idx) % (2 ** 31))
    if use_clustering:
        prot_xyz = batch.prot_xyz.float().cpu().numpy()
        prot_mask = batch.prot_mask.cpu().numpy()

    def cluster_center(clusters, default: np.ndarray) -> Tensor:
        return to_device(torch.from_numpy(pick_cluster_centers(
            clusters, m.choose_cluster_prob, default, rng)), device)

    def rounded_center(cls_logits: Tensor) -> Tensor:
        return pocket_center_rounded(cls_logits, batch.prot_xyz,
                                     batch.prot_mask, m.gs_tau,
                                     m.gs_hard).float()

    gens = [pass_generator(seed, batch_idx, s, device)
            for s in range(sample_size)]
    coords: List[Tensor] = []
    scores: List[Tensor] = []
    with torch.inference_mode():
        if pocket_mode == "stochastic":
            # every pocket stage is launched, with the copy of its logits
            # and its default center, before the first copy is read: the
            # host clusters pass s while the device runs the pocket stages
            # behind it and the docks already queued
            pockets = []
            for g in gens:
                with dropout_rng(g):
                    pocket = model._pocket_pred(batch, shapes)
                center = rounded_center(pocket[2])
                host = ((_HostCopy(pocket[2]), _HostCopy(center))
                        if use_clustering else None)
                pockets.append((pocket, center, host))
            for g, (pocket, center, host) in zip(gens, pockets):
                if use_clustering:
                    center = cluster_center(dbscan_clusters(
                        _probs(host[0]), prot_xyz, prot_mask, m.dbscan_eps,
                        m.dbscan_min_samples), host[1].numpy())
                with dropout_rng(g):
                    c, conf, _ = model.inference_diag(batch, center, shapes,
                                                      pocket=pocket)
                coords.append(c)
                scores.append(conf)
        else:
            pocket = model._pocket_pred(batch, shapes)
            default = rounded_center(pocket[2])
            if use_clustering:
                clusters = dbscan_clusters(
                    _probs(_HostCopy(pocket[2])), prot_xyz, prot_mask,
                    m.dbscan_eps, m.dbscan_min_samples)
                default_np = default.cpu().numpy()
            for g in gens:
                center = (cluster_center(clusters, default_np)
                          if use_clustering else default)
                with dropout_rng(g):
                    c, conf, _ = model.inference_diag(batch, center, shapes)
                coords.append(c)
                scores.append(conf)
    return torch.stack(coords), torch.stack(scores)
