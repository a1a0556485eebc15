"""FABind+ best-of-N sampling, the plain reference of its protocol: what
decides `correct` in the sampling cell.

The published protocol (QizhiPei/FABind, FABind_plus/fabind/
inference_sampling_fabind.py:69, 148-154, 172, 203-210 and
fabind/models/model.py:147-167, 482-502): each of N passes over a batch is
one forward with dropout kept on; the residues the pocket stage predicts
positive (probability > 0.5, or the 50 most probable valid residues when
fewer are) are clustered by DBSCAN (eps, min_samples); a row with clusters
docks, with probability `choose_cluster_prob`, at the mean of a cluster
drawn uniformly, else at the rounded default center of the pocket stage;
each request keeps the pose of highest confidence over the passes.

Departures from the published code, each the port's as well:
- The draws are counter-based rather than torch's and numpy's global
  generators: pass s of batch i runs under the seed `pass_seed(seed, i, s)`
  (its dropout masks through the Philox of ops/dropout.py, keyed by the
  element's flat index in the batch, and its recycle counts drawn on the
  host from it, `recycle_counts`); the picks draw from one numpy
  RandomState per batch seeded from (seed, i): randint, then rand, for
  each row with clusters, pass after pass.
- Requests are batched as the serving engine batches them (buckets, a
  batch of B rows, the last request repeated as padding), since a mask
  depends on the element's place in the batch.
- `sampling_pocket_mode` "stochastic" (the default): each pass's own
  pocket stage gives its clusters, its default center, its crop radius and
  the embeddings it docks from. "fixed": one deterministic pocket stage
  per batch is clustered once, and each pass is a whole stochastic
  forward docked at its pick.

Plain float32 (`dock.full_precision`: TF32 off), batch by batch, with no
kernel, graph or cache. Its DBSCAN is its own (the textbook depth-first
expansion); it imports nothing of the port or of JAX. `best_of` can follow
another run's decisions: dock each pass at that run's picked center and
crop (the program's), so that the poses are compared where they started
from the same pocket.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from benchmark.reference.dock import routed_batches, to_batch
from benchmark.reference.models.layers import dropout_seed, recycle_count
from benchmark.reference.ops.dropout import site_id
from benchmark.reference.ops.gumbel import pocket_center_rounded

POCKET_LOOP_SITE = site_id("pocket_pred_model")
DOCK_LOOP_SITE = site_id("complex_model")
MIN_POSITIVE = 50


def pass_seed(seed: int, batch_idx: int, s: int) -> int:
    """The seed of pass s of batch `batch_idx` (its masks and counts)."""
    return ((seed * 1000003 + batch_idx) * 1000003 + s) % 2 ** 63


def batch_rng(seed: int, batch_idx: int) -> np.random.RandomState:
    """The generator of one batch's cluster picks."""
    return np.random.RandomState((seed * 1000003 + batch_idx) % 2 ** 31)


def recycle_counts(m, seed: int) -> Tuple[int, int]:
    """(pocket stage, docking) recycle counts of the pass of `seed`."""
    if not m.random_n_iter:
        return m.pocket_pred_n_iter, m.n_iter
    return (recycle_count(seed, POCKET_LOOP_SITE, m.pocket_pred_n_iter),
            recycle_count(seed, DOCK_LOOP_SITE, m.n_iter))


def probabilities(logits: np.ndarray) -> np.ndarray:
    """The pocket stage's residue probabilities, in float32."""
    x = np.asarray(logits, np.float32)
    return (1.0 / (1.0 + np.exp(-x))).astype(np.float32)


def dbscan(pts: np.ndarray, eps: float, min_samples: int) -> np.ndarray:
    """DBSCAN labels of points [n, 3] (noise -1): a point with at least
    min_samples points within eps (itself included, distances in float64)
    is a core point; clusters are numbered in the order of their first
    core point and grown depth first through core points, so a border
    point reachable from two clusters keeps the first."""
    pts = np.asarray(pts, np.float64)
    d = np.sqrt(((pts[:, None, :] - pts[None, :, :]) ** 2).sum(-1))
    near = [np.flatnonzero(row <= eps) for row in d]
    core = np.array([len(n) >= min_samples for n in near], bool)
    labels = np.full(len(pts), -1, np.int64)
    label = 0
    for i in range(len(pts)):
        if labels[i] != -1 or not core[i]:
            continue
        stack = [i]
        while stack:
            j = stack.pop()
            if labels[j] != -1:
                continue
            labels[j] = label
            if core[j]:
                stack.extend(int(v) for v in near[j] if labels[v] == -1)
        label += 1
    return labels


def clusters(probs: np.ndarray, xyz: np.ndarray, mask: np.ndarray, eps: float,
             min_samples: int) -> List[List[np.ndarray]]:
    """Per row, the mean coordinates of each DBSCAN cluster of its
    positive residues (module docstring), in label order."""
    out = []
    for p, xy, valid in zip(probs, xyz, mask):
        pos = (p > 0.5) & valid
        if pos.sum() < MIN_POSITIVE:
            top = np.argsort(np.where(valid, p, -np.inf))[-MIN_POSITIVE:]
            pos = np.zeros_like(pos)
            pos[top] = True
            pos &= valid
        pts = np.asarray(xy, np.float32)[pos]
        if not len(pts):
            out.append([])
            continue
        labels = dbscan(pts, eps, min_samples)
        out.append([pts[labels == c].mean(axis=0)
                    for c in range(labels.max() + 1)])
    return out


def picks(rows_clusters: Sequence[List[np.ndarray]], choose_prob: float,
          default: np.ndarray, rng: np.random.RandomState) -> np.ndarray:
    """Per row, a uniformly drawn cluster's mean with probability
    choose_prob, else the default center [B, 3] (float32)."""
    out = np.array(default, np.float32, copy=True)
    for b, cl in enumerate(rows_clusters):
        if not cl:
            continue
        k = rng.randint(0, len(cl))
        if rng.rand() < choose_prob:
            out[b] = cl[k]
    return out


def sample_batch(model, batch, shapes, m, sample_size: int, seed: int,
                 batch_idx: int, follow: Optional[List[Dict]] = None
                 ) -> List[Dict]:
    """The passes over one batch, each {"seed", "logits" [B, Nr] (the
    logits its clusters came from), "default" [B, 3], "radius" [B] (its
    pocket stage's predicted radius), "center" [B, 3] (the center it docked
    at, protein-mean frame), "crop" (idx, mask) [B, Np], "coords"
    [B, Nc, 3] (protein-mean frame), "conf" [B]}, as numpy. With
    `follow` (one such record per pass), pass s docks at follow[s]'s center
    and crop instead of its own, and nothing is clustered."""
    rng = batch_rng(seed, batch_idx)
    xyz = batch.prot_xyz.float().cpu().numpy()
    valid = batch.prot_mask.cpu().numpy()
    pick = m.use_clustering and follow is None

    def decide(pocket):
        """(logits, default center, clusters or None) of a pocket stage."""
        logits = pocket[2].float().cpu().numpy()
        default = pocket_center_rounded(pocket[2], batch.prot_xyz,
                                        batch.prot_mask, m.gs_tau, m.gs_hard)
        return logits, default.float().cpu().numpy(), (
            clusters(probabilities(logits), xyz, valid, m.dbscan_eps,
                     m.dbscan_min_samples) if pick else None)

    fixed = m.sampling_pocket_mode == "fixed"
    if fixed:
        once = decide(model._pocket_pred(batch, shapes))
    out = []
    for s in range(sample_size):
        sd = pass_seed(seed, batch_idx, s)
        pc, dc = recycle_counts(m, sd)
        with dropout_seed(sd):
            pocket = model._pocket_pred(batch, shapes, pc)
        logits, default, cl = once if fixed else decide(pocket)
        center = (picks(cl, m.choose_cluster_prob, default, rng) if pick
                  else default)
        if follow is not None:
            center = np.asarray(follow[s]["center"], np.float32)
            idx, mask = (torch.as_tensor(np.asarray(a),
                                         device=batch.prot_xyz.device)
                         for a in follow[s]["crop"])
        else:
            ctr = torch.as_tensor(center, dtype=torch.float32,
                                  device=batch.prot_xyz.device)
            idx, mask = model._predicted_crop(
                ctr, batch, shapes, model._crop_radius(pocket[3]))[:2]
        with dropout_seed(sd):
            docked = model._dock(batch, pocket[0], pocket[1], idx, mask, True,
                                 shapes.ctx_k, dc)
        out.append({"seed": sd, "logits": logits, "default": default,
                    "radius": pocket[3].float().cpu().numpy(),
                    "center": center,
                    "crop": (idx.cpu().numpy(), mask.cpu().numpy()),
                    "coords": docked[0].float().cpu().numpy(),
                    "conf": docked[5].float().cpu().numpy()})
    return out


def best_of(model, raws: Sequence[Dict], bucket_cfgs, batch_size: int,
            sample_size: int, seed: int, device,
            follow: Optional[List[Dict]] = None) -> List[Dict]:
    """Best-of-N of every request, batch by batch in the engine's order:
    per batch {"rows": the request index of each batch row, "n_real",
    "max_pocket" (its bucket's pocket slots), "xyz" [B, Nr, 3] and "mask"
    [B, Nr] (the residues it clustered),
    "passes": sample_batch's records}. `follow`, a list of such batches
    (another run's), docks each pass at its decisions."""
    out = []
    with torch.inference_mode():
        for bi, (chunk, c, arrays, n_real) in enumerate(routed_batches(
                raws, bucket_cfgs, batch_size)):
            batch = to_batch(arrays, device)
            passes = sample_batch(
                model, batch, c.shapes, bucket_cfgs[-1].model, sample_size,
                seed, bi, None if follow is None else follow[bi]["passes"])
            out.append({"rows": [chunk[min(b, n_real - 1)][0]
                                 for b in range(batch_size)],
                        "n_real": n_real,
                        "max_pocket": c.shapes.max_pocket,
                        "xyz": batch.prot_xyz.float().cpu().numpy(),
                        "mask": batch.prot_mask.cpu().numpy(),
                        "passes": passes})
    return out


def requests(batches: List[Dict], raws: Sequence[Dict], bucket_cfgs
             ) -> Dict[int, Dict]:
    """Per request index: {"coords" [N, n_atoms, 3] world frame,
    "conf" [N], "winner": the pass of highest confidence}, from
    `best_of`'s batches (each request's real row)."""
    from benchmark.reference.batching import build_sample

    out = {}
    for b in batches:
        for row in range(b["n_real"]):
            i = b["rows"][row]
            s = build_sample(raws[i], bucket_cfgs[-1], group="test")
            n, off = s["lig_feat"].shape[0], s["coord_offset"]
            coords = np.stack([p["coords"][row, :n] + off
                               for p in b["passes"]])
            conf = np.array([p["conf"][row] for p in b["passes"]])
            out[i] = {"coords": coords, "conf": conf,
                      "winner": int(np.argmax(conf))}
    return out
