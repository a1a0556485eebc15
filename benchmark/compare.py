"""The comparison that decides `correct`: served poses against the
reference's, request by request.

Per request three distances, each the mean over the ligand's atoms: of the
poses as served (`pose`), of the poses each moved to its own centroid
(`shape`: what the docking layers did to the ligand, whatever pocket it was
placed in) and of the two centroids (`centroid`: where it was placed). A
request that was not served, or served a pose of another shape or with a
value that is not finite, reads infinity.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

INF = float("inf")


def distances(got: Optional[np.ndarray], want: np.ndarray) -> Dict[str, float]:
    want = np.asarray(want, np.float64)
    if got is None:
        return {"pose": INF, "shape": INF, "centroid": INF}
    got = np.asarray(got, np.float64)
    if got.shape != want.shape or not np.isfinite(got).all():
        return {"pose": INF, "shape": INF, "centroid": INF}
    cg, cw = got.mean(0), want.mean(0)
    return {"pose": float(np.linalg.norm(got - want, axis=-1).mean()),
            "shape": float(np.linalg.norm((got - cg) - (want - cw),
                                          axis=-1).mean()),
            "centroid": float(np.linalg.norm(cg - cw))}


def summary(rows: Sequence[Dict[str, float]]) -> Dict[str, float]:
    """The median and the largest of the pose and shape distances over the
    requests (the centroid's is part of the pose's)."""
    out = {}
    for key in ("pose", "shape"):
        v = np.array([r[key] for r in rows])
        out[f"{key}_median_A"] = float(np.median(v))
        out[f"{key}_max_A"] = float(v.max())
    return out


def sample(sizes: List[int], n: int, rng: np.random.Generator) -> List[int]:
    """n indices drawn from the seed's rng, the largest size among them,
    in ascending order."""
    n = min(n, len(sizes))
    pick = {int(np.argmax(sizes))}
    for j in rng.permutation(len(sizes)):
        if len(pick) >= n:
            break
        pick.add(int(j))
    return sorted(pick)


def size_of(raw: Dict) -> int:
    """A request's size for "the largest": ligand atoms x residues."""
    return int(raw["lig_feats"].shape[0] * raw["protein_xyz"].shape[0])
