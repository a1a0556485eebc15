"""Evaluation metrics, on the host.

Own copy (numpy) of the parts of fabind_tpu/utils/metrics.py that
`MetricAccumulator` uses: ligand RMSD mean/quantiles/<2 A/<5 A, the
centroid-distance family, pocket classification accuracy, and pocket-center
MAE/RMSE/DCC. Its inputs may be torch tensors on any device or numpy arrays.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np


def _np(x) -> np.ndarray:
    """A tensor (any device, any float dtype) or array as a numpy array."""
    if hasattr(x, "detach"):
        x = x.detach().cpu()
        if x.is_floating_point():
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
