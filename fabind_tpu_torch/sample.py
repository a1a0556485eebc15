"""FABind+ best-of-N sampling: N stochastic docking passes per complex,
ranked by the confidence head.

Own copy of the library half of fabind_tpu/cli/sample.py. Dropout stays on
in inference, keyed by one seed per pass (`pass_seed`, the counter-based
operator of ops/dropout.py), pocket centers are optionally resampled by
host DBSCAN over the residues the pocket stage predicts positive, and the
caller keeps the pose with the highest confidence.
`cfg.model.sampling_pocket_mode` picks the protocol:

  - "stochastic" (default, the reference protocol): every pass is one
    stochastic forward; its pocket stage's logits give that pass's clusters
    and the same stage's embeddings and radius feed its docking.
  - "fixed": one deterministic pocket stage per batch, clustered once; each
    pass picks a cluster at random and runs a whole stochastic forward
    docked at that center.

A pass runs in two halves, with DBSCAN on the host between them, and
`sample_poses` takes them from the live model (`live_halves`) or from an
exported artifact (aot.ExportedInference.sampling_halves): the programs run
the same functions (`stochastic_pocket`, `stochastic_dock`,
`stochastic_inference`) with the seed and the recycle counts as tensors.
Each half draws the recycle count of its loop on the host from the pass's
seed (`recycle_counts`, cfg.random_n_iter, as the JAX package's
non-deterministic forward). The draws cannot equal the JAX package's
threefry/rbg streams. What holds instead: the same seed gives the same
poses, live or exported, and passes with different indices draw different
masks and counts.

The serving engine's live halves (`live_halves(dock=)`) dock the
stochastic mode's dock half by replaying its bucket's CUDA graphs
(graphs.py: one capture per bucket serves every drawn recycle count, the
pass's seed copied in before each replay); the pocket half, its default
center, the crop, the read-back, DBSCAN and the picks stay eager, in the
order below.

Data-parallel serving (`sample_poses(replicas=)`) runs each half on every
replica's contiguous block of rows, in the replica's thread, with its row
map (the masks the whole batch draws at those rows); the host step between
the halves (DBSCAN and the cluster picks, one RandomState row after row)
stays on the whole batch, so the picks are one replica's.

Traced (utils/tracing.py): `sample.pocket_half` and `sample.dock_half`
around each half (ids: pass, bucket; the model's `model.*` spans nest under
them, in the replica's thread); `sample.pass` (ids: pass, bucket and the
drawn `pocket` and `dock` recycle counts) around the calling thread's part
of a pass after its pocket half was launched: `sample.readback` (the wait
for the host copies of the pass's logits and default center),
`sample.cluster` (DBSCAN and the pass's picks) and the launch of its dock
half. The fixed mode reads back and clusters once per batch, before the
passes, and picks inside each pass's `sample.cluster`. Counters:
`sample.passes` by bucket, and `sample.centers` by where each row's center
came from, "cluster" or "default" (GET /health reports both).
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch
from scipy.spatial.distance import cdist

from fabind_tpu_torch.config import ModelConfig
from fabind_tpu_torch.data.buckets import bucket_label
from fabind_tpu_torch.data.types import to_device
from fabind_tpu_torch.models.layers import (RowMap, dropout_seed,
                                            recycle_count)
from fabind_tpu_torch.ops.dropout import site_id
from fabind_tpu_torch.ops.gumbel import pocket_center_rounded
from fabind_tpu_torch.parallel.dp import ReplicaSet
from fabind_tpu_torch.utils import tracing

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
    return _picks(clusters, choose_prob, default_centers, rng)[0]


def _picks(clusters: list, choose_prob: float, default_centers: np.ndarray,
           rng: np.random.RandomState) -> Tuple[np.ndarray, np.ndarray]:
    """pick_cluster_centers' centers and, per row, whether its center is a
    cluster's."""
    centers = default_centers.copy()
    took = np.zeros(len(clusters), bool)
    for b, cl in enumerate(clusters):
        if not cl:
            continue
        cid = rng.randint(0, len(cl))
        if rng.rand() < choose_prob:
            centers[b] = cl[cid]
            took[b] = True
    return centers, took


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


def pass_seed(seed: int, batch_idx: int, s: int) -> int:
    """The dropout seed of sampling pass s of batch batch_idx."""
    return ((seed * 1000003 + batch_idx) * 1000003 + s) % 2 ** 63


# the recycle loops' sites (layers.assign_sites names them so)
POCKET_LOOP_SITE = site_id("pocket_pred_model")
DOCK_LOOP_SITE = site_id("complex_model")


def recycle_counts(m: ModelConfig, seed: int) -> Tuple[int, int]:
    """(pocket stage, docking) recycle counts of the stochastic forward of
    `seed`: the counts its model draws (EfficientMCAttModel.draw_count)."""
    if not m.random_n_iter:
        return m.pocket_pred_n_iter, m.n_iter
    return (recycle_count(seed, POCKET_LOOP_SITE, m.pocket_pred_n_iter),
            recycle_count(seed, DOCK_LOOP_SITE, m.n_iter))


def stochastic_pocket(model, batch, shapes, seed, count,
                      rows: RowMap = RowMap()):
    """The pocket half of a stochastic pass: the pocket stage under `seed`
    with recycle count `count` (ints, or tensors in a traced program), and
    its rounded default center in float32. Returns (pocket outputs,
    center [B, 3]). `rows`: the batch's row map in a data-parallel
    batch."""
    with dropout_seed(seed, rows):
        pocket = model._pocket_pred(batch, shapes, count)
    m = model.cfg
    return pocket, pocket_center_rounded(pocket[2], batch.prot_xyz,
                                         batch.prot_mask, m.gs_tau,
                                         m.gs_hard).float()


def stochastic_dock(model, batch, shapes, pocket, center, seed, count,
                    rows: RowMap = RowMap(), dock=None):
    """The dock half of a stochastic pass: docking from the pass's pocket
    outputs at `center`. `dock` stands in for the model's docking stage
    (the serving engine's graphs, graphs.py); the crop is the model's.
    Returns (coords [B,Nc,3], confidence [B])."""
    with dropout_seed(seed, rows):
        coords, conf, _ = model.inference_diag(batch, center, shapes,
                                               pocket=pocket, count=count,
                                               dock=dock)
    return coords, conf


def stochastic_inference(model, batch, shapes, center, seed, pocket_count,
                         count, rows: RowMap = RowMap()):
    """A whole stochastic forward docked at `center` (the fixed pocket
    mode's pass). Returns (coords [B,Nc,3], confidence [B])."""
    with dropout_seed(seed, rows):
        coords, conf, _ = model.inference_diag(
            batch, center, shapes, pocket_count=pocket_count, count=count)
    return coords, conf


def live_halves(model, cfg, rows: RowMap = RowMap(), dock=None):
    """(pocket_fn, dock_fn) of the live model in bucket cfg, with the
    per-mode contract of sample_poses' `halves`:

      - "stochastic": pocket_fn(batch, seed) -> (pocket outputs, center);
        dock_fn(batch, pocket, center, seed) -> (coords, confidence)
      - "fixed": pocket_fn(batch) -> pocket outputs (deterministic);
        dock_fn(batch, center, seed) -> (coords, confidence)

    seed is the pass's int seed; the recycle counts are drawn from it.
    `rows` is the batch's row map when it is a replica's block. `dock`
    stands in for the docking stage of the stochastic mode's dock half
    (stochastic_dock)."""
    m, shapes = cfg.model, cfg.shapes
    if m.sampling_pocket_mode == "stochastic":
        def pocket_fn(batch, seed):
            return stochastic_pocket(model, batch, shapes, seed,
                                     recycle_counts(m, seed)[0], rows)

        def dock_fn(batch, pocket, center, seed):
            return stochastic_dock(model, batch, shapes, pocket, center,
                                   seed, recycle_counts(m, seed)[1], rows,
                                   dock)
    else:
        def pocket_fn(batch):
            return model._pocket_pred(batch, shapes)

        def dock_fn(batch, center, seed):
            return stochastic_inference(model, batch, shapes, center, seed,
                                        *recycle_counts(m, seed), rows)
    return pocket_fn, dock_fn


def sample_poses(model, batch, cfg, sample_size: int, seed: int = 0,
                 batch_idx: int = 0, halves=None,
                 replicas=None) -> Tuple[Tensor, Tensor]:
    """`sample_size` stochastic docking passes over one batch of bucket cfg
    (`cfg.shapes`, with the protocol of `cfg.model.sampling_pocket_mode`
    and `cfg.model.use_clustering`); returns (coords [S, B, Nc, 3], scores
    [S, B]) on the batch's device, in the model's dtype. Nothing is copied
    back but each pass's pocket logits, which the host clusters.

    `halves=(pocket_fn, dock_fn)` runs the passes through other halves with
    `live_halves`' contract (an exported artifact's; `model` may then be
    None). Pass s is keyed by `pass_seed(seed, batch_idx, s)`: its pocket
    half first, then its docking. The cluster picks draw from one numpy
    RandomState per batch seeded from (seed, batch_idx), as the JAX
    package's do. Cluster centers go to the crop in float32.

    `replicas` (a parallel.dp.ReplicaSet): `batch` is the list of its
    blocks (ReplicaSet.split) and `model` is not read; each half runs on
    every block with its replica's module and row map, in the replica's
    thread, and the result comes back in row order on the first device."""
    m = cfg.model
    use_clustering = m.use_clustering
    pocket_mode = m.sampling_pocket_mode
    if pocket_mode not in ("fixed", "stochastic"):
        raise ValueError(f"sampling_pocket_mode {pocket_mode!r}")
    if replicas is None:
        # one replica: every call runs at once in this thread
        replicas, blocks = ReplicaSet(None, [batch.prot_xyz.device]), [batch]
        parts = [halves or live_halves(model, cfg)]
    else:
        blocks = batch
        B = sum(b.batch_size for b in blocks)
        parts = [live_halves(replicas.modules[r], cfg,
                             replicas.row_map(r, B))
                 for r in range(len(blocks))]
    rng = np.random.RandomState((seed * 1000003 + batch_idx) % (2 ** 31))
    bucket = bucket_label(cfg.shapes)
    rows = sum(b.batch_size for b in blocks)
    if use_clustering:
        prot_xyz = np.concatenate([b.prot_xyz.float().cpu().numpy()
                                   for b in blocks])
        prot_mask = np.concatenate([b.prot_mask.cpu().numpy()
                                    for b in blocks])

    def each(fn, *per_block):
        """fn(r, block, *args[r]) submitted to every replica: futures."""
        return [replicas.submit(r, fn, r, b, *(a[r] for a in per_block))
                for r, b in enumerate(blocks)]

    def cluster_centers(clusters, default: np.ndarray) -> List[Tensor]:
        """The pass's picked centers [B, 3], as each block's rows on its
        device."""
        centers, took = _picks(clusters, m.choose_cluster_prob, default, rng)
        taken = int(took.sum())
        tracing.count("sample.centers", taken, key="cluster")
        tracing.count("sample.centers", len(took) - taken, key="default")
        out, start = [], 0
        for b in blocks:
            n = b.batch_size
            out.append(to_device(torch.from_numpy(centers[start:start + n]),
                                 b.prot_xyz.device))
            start += n
        return out

    def probs_of(hosts) -> np.ndarray:
        return np.concatenate([_probs(h) for h in hosts])

    def pass_span(s: int, sd: int):
        """The calling thread's span of pass s (the counts its halves
        draw), and the pass counted."""
        pc, dc = recycle_counts(m, sd)
        tracing.count("sample.passes", key=bucket)
        if not use_clustering:
            tracing.count("sample.centers", rows, key="default")
        return tracing.span("sample.pass", **{"pass": s}, bucket=bucket,
                            pocket=pc, dock=dc)

    def half(name: str, s: int):
        """The span of a half of pass s, in the thread that runs it."""
        return tracing.span(name, **{"pass": s}, bucket=bucket)

    seeds = [pass_seed(seed, batch_idx, s) for s in range(sample_size)]
    docks = []
    with torch.inference_mode():
        if pocket_mode == "stochastic":
            def pocket_half(r, b, s, sd):
                with half("sample.pocket_half", s):
                    pocket, center = parts[r][0](b, sd)
                    host = ((_HostCopy(pocket[2]), _HostCopy(center))
                            if use_clustering else None)
                return pocket, center, host

            def dock_half(r, b, pocket, center, s, sd):
                with half("sample.dock_half", s):
                    return parts[r][1](b, pocket, center, sd)

            # every pocket half is launched, with the copy of its logits
            # and its default center, before the first copy is read: the
            # host clusters pass s while the device runs the pocket halves
            # behind it and the docks already queued
            pockets = [each(lambda r, b, s=s, sd=sd: pocket_half(r, b, s, sd))
                       for s, sd in enumerate(seeds)]
            for s, (sd, futs) in enumerate(zip(seeds, pockets)):
                with pass_span(s, sd):
                    outs = [f.result() for f in futs]
                    centers = [c for _, c, _ in outs]
                    if use_clustering:
                        with tracing.span("sample.readback"):
                            probs = probs_of([h[0] for _, _, h in outs])
                            default = np.concatenate([h[1].numpy()
                                                      for _, _, h in outs])
                        with tracing.span("sample.cluster"):
                            centers = cluster_centers(dbscan_clusters(
                                probs, prot_xyz, prot_mask, m.dbscan_eps,
                                m.dbscan_min_samples), default)
                    docks.append(each(
                        lambda r, b, o, c, s=s, sd=sd: dock_half(
                            r, b, o[0], c, s, sd), outs, centers))
        else:
            def pocket_half(r, b):
                with tracing.span("sample.pocket_half", bucket=bucket):
                    pocket = parts[r][0](b)
                    default = pocket_center_rounded(
                        pocket[2], b.prot_xyz, b.prot_mask, m.gs_tau,
                        m.gs_hard).float()
                return pocket, default

            def dock_half(r, b, c, s, sd):
                with half("sample.dock_half", s):
                    return parts[r][1](b, c, sd)

            outs = [f.result() for f in each(pocket_half)]
            defaults = [d for _, d in outs]
            if use_clustering:
                with tracing.span("sample.readback"):
                    probs = probs_of([_HostCopy(p[2]) for p, _ in outs])
                    default_np = np.concatenate([d.cpu().numpy()
                                                 for d in defaults])
                with tracing.span("sample.cluster"):
                    clusters = dbscan_clusters(
                        probs, prot_xyz, prot_mask, m.dbscan_eps,
                        m.dbscan_min_samples)
            for s, sd in enumerate(seeds):
                with pass_span(s, sd):
                    centers = defaults
                    if use_clustering:
                        with tracing.span("sample.cluster"):
                            centers = cluster_centers(clusters, default_np)
                    docks.append(each(
                        lambda r, b, c, s=s, sd=sd: dock_half(r, b, c, s, sd),
                        centers))
        passes = [replicas.gather([f.result() for f in futs])
                  for futs in docks]
    return (torch.stack([c for c, _ in passes]),
            torch.stack([conf for _, conf in passes]))
