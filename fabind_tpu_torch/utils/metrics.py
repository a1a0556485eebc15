"""Evaluation metrics, on the host.

Own copy (numpy) of fabind_tpu/utils/metrics.py: ligand RMSD
mean/quantiles/<2 A/<5 A, the centroid-distance family, pocket
classification accuracy, pocket-center MAE/RMSE/DCC, the Kabsch and
symmetry-corrected RMSDs, contact classification over distance maps and
affinity metrics. Its inputs may be torch tensors on any device or numpy
arrays.

One deviation: the JAX package takes the contact AUROC from scikit-learn
and leaves the key out when scikit-learn is missing. The port computes it
itself (`roc_auc`, the Mann-Whitney rank statistic with tied scores given
their average rank, which is what scikit-learn's trapezoidal ROC area
equals) and always returns it when both classes are present.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np


def _np(x) -> np.ndarray:
    """A tensor (any device, any float dtype; bf16 and fp16 become float32)
    or array as a numpy array."""
    if hasattr(x, "detach"):
        x = x.detach().cpu()
        if x.is_floating_point() and x.element_size() < 4:
            x = x.float()
        return x.numpy()
    return np.asarray(x)


def ligand_rmsd(pred: np.ndarray, true: np.ndarray, mask: np.ndarray
                ) -> np.ndarray:
    """Per-sample RMSD [B] from dense [B, Nc, 3] + mask [B, Nc]."""
    sd = ((pred - true) ** 2).sum(-1)
    m = mask.astype(np.float64)
    return np.sqrt((sd * m).sum(-1) / np.maximum(m.sum(-1), 1.0))


def centroid_distance(pred: np.ndarray, true: np.ndarray, mask: np.ndarray
                      ) -> np.ndarray:
    m = mask.astype(np.float64)[..., None]
    cp = (pred * m).sum(1) / np.maximum(m.sum(1), 1.0)
    ct = (true * m).sum(1) / np.maximum(m.sum(1), 1.0)
    return np.linalg.norm(cp - ct, axis=-1)


def summarize_rmsd(rmsd: np.ndarray, prefix: str = "rmsd") -> Dict[str, float]:
    """mean / 25% / 50% / 75% / <2Å / <5Å (utils/utils.py:588-602)."""
    r = np.asarray(rmsd, np.float64)
    return {
        f"{prefix}_mean": float(r.mean()),
        f"{prefix}_25": float(np.quantile(r, 0.25)),
        f"{prefix}_50": float(np.quantile(r, 0.50)),
        f"{prefix}_75": float(np.quantile(r, 0.75)),
        f"{prefix}_lt2": float((r < 2.0).mean()),
        f"{prefix}_lt5": float((r < 5.0).mean()),
    }


def pocket_cls_ok(logits: np.ndarray, labels: np.ndarray,
                  mask: np.ndarray) -> np.ndarray:
    """Per-sample bool: residue classification fully correct on valid
    residues (utils/utils.py:533-543 semantics: all-match of the rounded
    sigmoid). Shared by pocket_cls_accuracy and MetricAccumulator so the
    two can never diverge."""
    pred = (1 / (1 + np.exp(-logits)) >= 0.5)
    return ((pred == (labels > 0.5)) | ~mask).all(axis=-1)


def pocket_cls_accuracy(logits: np.ndarray, labels: np.ndarray,
                        mask: np.ndarray) -> float:
    """Fraction of complexes whose residue classification is fully correct
    on valid residues."""
    return float(pocket_cls_ok(_np(logits), _np(labels), _np(mask)).mean())


def pocket_center_metrics(pred_center: np.ndarray, true_center: np.ndarray,
                          prefix: str = "pocket_center") -> Dict[str, float]:
    """MAE/MSE/RMSE + DCC = %(dist < 4Å) (utils/metrics.py:62-77)."""
    d = pred_center - true_center
    dist = np.linalg.norm(d, axis=-1)
    return {
        f"{prefix}_avg_dist": float(dist.mean()),
        f"{prefix}_mae": float(np.abs(d).mean()),
        f"{prefix}_rmse": float(np.sqrt((d ** 2).mean())),
        f"{prefix}_dcc_lt4": float((dist < 4.0).mean()),
    }


def kabsch_rmsd(pred: np.ndarray, true: np.ndarray) -> float:
    """Optimal-superposition RMSD for a single ligand [n, 3] (used by
    pose-quality analyses; complements the direct RMSD used for docking
    accuracy)."""
    pred, true = _np(pred), _np(true)
    p = pred - pred.mean(0)
    q = true - true.mean(0)
    h = p.T @ q
    u, _, vt = np.linalg.svd(h)
    d = np.sign(np.linalg.det(vt.T @ u.T))
    r = vt.T @ np.diag([1, 1, d]) @ u.T
    p = p @ r.T
    return float(np.sqrt(((p - q) ** 2).sum(-1).mean()))


def symmetric_rmsd(pred: np.ndarray, true: np.ndarray,
                   isomorphisms: Optional[np.ndarray] = None) -> float:
    """Symmetry-corrected RMSD: min over ligand-graph automorphisms
    (reference uses spyrmsd with a timeout fallback to plain RMSD,
    FABind_plus/fabind/utils/get_sym_rmsd.py:5-35; here automorphisms come
    from the same precomputed isomorphism lists used by the permutation
    loss)."""
    def rmsd(a, b):
        return float(np.sqrt(((a - b) ** 2).sum(-1).mean()))
    if isomorphisms is None or len(isomorphisms) == 0:
        return rmsd(pred, true)
    return min(rmsd(pred[np.asarray(iso, int)], true)
               for iso in isomorphisms)


class MetricAccumulator:
    """Streams per-batch outputs; summarizes at the end.

    Rows whose batch.sample_valid is False (trailing-batch padding
    duplicates) are excluded from every metric. With symmetric=True the
    RMSD is symmetry-corrected over batch.isomorphisms (the FABind+ eval
    protocol, FABind_plus/fabind/utils/training.py:273-289)."""

    def __init__(self, symmetric: bool = False):
        self.symmetric = symmetric
        self.rmsds = []
        self.centroids = []
        self.cls_ok = []
        self.centers_pred = []
        self.centers_true = []
        self.overflow = []  # residues dropped by the Np bucket, per sample
        self.per_pdb = []   # (pdb, rmsd) rows when update() receives pdbs

    def update(self, out, batch, pdbs=None, isomorphisms=None):
        """isomorphisms: optional per-real-sample list of FULL
        [n_iso, n_atoms] automorphism arrays (Loader meta["iso"]) — preferred
        over batch.isomorphisms, whose device copy is capped at the
        permutation loss's max_iso and would make symmetric RMSD
        pessimistic on highly symmetric ligands."""
        valid = (_np(batch.sample_valid)
                 if batch.sample_valid is not None
                 else np.ones(_np(out.coords).shape[0], bool))
        pred = _np(out.coords)[valid]
        true = _np(batch.lig_coords)[valid]
        mask = _np(out.lig_mask)[valid]
        rmsd = ligand_rmsd(pred, true, mask)
        if self.symmetric and isomorphisms is not None:
            for i in range(pred.shape[0]):
                nl = int(mask[i].sum())
                iso = isomorphisms[i] if i < len(isomorphisms) else None
                rmsd[i] = symmetric_rmsd(pred[i, :nl], true[i, :nl], iso)
        elif self.symmetric and batch.isomorphisms is not None:
            isos = _np(batch.isomorphisms)[valid]
            iso_m = _np(batch.iso_mask)[valid]
            for i in range(pred.shape[0]):
                nl = int(mask[i].sum())
                il = [isos[i, j, :nl] for j in range(isos.shape[1])
                      if iso_m[i, j]]
                rmsd[i] = symmetric_rmsd(pred[i, :nl], true[i, :nl], il)
        self.rmsds.append(rmsd)
        if pdbs is not None:
            self.per_pdb.extend(zip(pdbs, rmsd.tolist()))
        self.centroids.append(centroid_distance(pred, true, mask))
        self.centers_pred.append(_np(out.pred_pocket_center)[valid])
        self.centers_true.append(_np(batch.coords_center)[valid])
        logits = _np(out.pocket_cls_logits)[valid]
        labels = _np(out.pocket_cls_label)[valid]
        pm = _np(out.prot_mask)[valid]
        self.cls_ok.append(pocket_cls_ok(logits, labels, pm))
        ov = getattr(out, "pocket_overflow", None)
        self.overflow.append(_np(ov)[valid] if ov is not None
                             else np.zeros(int(valid.sum()), np.int32))

    def summarize(self) -> Dict[str, float]:
        rmsd = np.concatenate(self.rmsds)
        cen = np.concatenate(self.centroids)
        res = summarize_rmsd(rmsd)
        res.update(summarize_rmsd(cen, prefix="centroid"))
        res["pocket_cls_accuracy"] = float(
            np.concatenate(self.cls_ok).mean())
        res.update(pocket_center_metrics(
            np.concatenate(self.centers_pred),
            np.concatenate(self.centers_true)))
        res["n"] = int(rmsd.shape[0])
        # predicted-pocket bucket truncation (DESIGN.md scale hazard): a
        # nonzero count means max_pocket (or the auto buckets' headroom,
        # data/buckets.py suggest_buckets) should be raised
        ov = np.concatenate(self.overflow)
        res["pocket_truncated_samples"] = int((ov > 0).sum())
        if (ov > 0).any():
            res["pocket_truncated_residues_max"] = int(ov.max())
        return res

    def dump_per_pdb(self, path: str) -> None:
        """Per-pdb RMSD text dump (reference save_rmsd_dir,
        FABind_plus/fabind/utils/training.py:394-401)."""
        with open(path, "w") as f:
            for pdb, r in self.per_pdb:
                f.write(f"{pdb} {r:.6f}\n")


def roc_auc(labels: np.ndarray, scores: np.ndarray) -> float:
    """Area under the ROC curve of `scores` for the binary `labels` (both
    classes present): the Mann-Whitney U of the positives' ranks over
    n_pos * n_neg, tied scores sharing their average rank (a tie between a
    positive and a negative counts one half)."""
    labels = np.asarray(labels, bool).ravel()
    scores = np.asarray(scores, np.float64).ravel()
    order = np.argsort(scores, kind="mergesort")
    ranked = scores[order]
    first = np.concatenate(([True], ranked[1:] != ranked[:-1]))
    starts = np.flatnonzero(first)
    ends = np.append(starts[1:], len(ranked))
    ranks = np.empty(len(ranked))
    ranks[order] = ((starts + 1 + ends) / 2.0)[np.cumsum(first) - 1]
    n_pos = float(labels.sum())
    n_neg = float(len(labels)) - n_pos
    return float((ranks[labels].sum() - n_pos * (n_pos + 1) / 2)
                 / (n_pos * n_neg))


def contact_cls_metrics(y_pred: np.ndarray, y_true: np.ndarray,
                        mask: Optional[np.ndarray] = None,
                        threshold: float = 8.0,
                        prefix: str = "contact") -> Dict[str, float]:
    """Contact classification metrics over distance maps
    (reference utils/metrics.py:7-55 `myMetric`/`cls_metric`: accuracy,
    AUROC, precision, recall, F1 on contact = distance < 8 A). The AUROC
    key is present when both classes are (`roc_auc`)."""
    y_pred, y_true = _np(y_pred), _np(y_true)
    if mask is not None:
        mask = _np(mask)
        y_pred = y_pred[mask]
        y_true = y_true[mask]
    pred_c = y_pred < threshold
    true_c = y_true < threshold
    tp = float((pred_c & true_c).sum())
    fp = float((pred_c & ~true_c).sum())
    fn = float((~pred_c & true_c).sum())
    tn = float((~pred_c & ~true_c).sum())
    eps = 1e-12
    out = {
        f"{prefix}_accuracy": (tp + tn) / max(tp + tn + fp + fn, 1.0),
        f"{prefix}_precision": tp / (tp + fp + eps),
        f"{prefix}_recall": tp / (tp + fn + eps),
    }
    out[f"{prefix}_f1"] = (2 * out[f"{prefix}_precision"]
                           * out[f"{prefix}_recall"]
                           / (out[f"{prefix}_precision"]
                              + out[f"{prefix}_recall"] + eps))
    if true_c.any() and (~true_c).any():
        # smaller predicted distance = more likely contact
        out[f"{prefix}_auroc"] = roc_auc(true_c, -y_pred)
    return out


def affinity_metrics(pred: np.ndarray, true: np.ndarray,
                     prefix: str = "affinity") -> Dict[str, float]:
    """Pearson + RMSE + MAE (reference utils/metrics.py:57-60)."""
    pred = np.asarray(_np(pred), np.float64)
    true = np.asarray(_np(true), np.float64)
    pearson = float(np.corrcoef(pred, true)[0, 1]) if len(pred) > 1 else 0.0
    return {
        f"{prefix}_pearson": pearson,
        f"{prefix}_rmse": float(np.sqrt(((pred - true) ** 2).mean())),
        f"{prefix}_mae": float(np.abs(pred - true).mean()),
    }
