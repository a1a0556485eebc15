"""Shape buckets: which padded shapes the engine serves, and which one a
request goes to.

Own copy of fabind_tpu/data/buckets.py. Each complex runs in the smallest
bucket it fits (`route_sample`); `suggest_buckets` proposes a small set of
buckets that minimizes padded compute over a measured size distribution,
under the cost model of the docking hot path (pair chains, cost
(1+Nc)(1+Np), plus an O(Nr) whole-protein pocket-prediction term).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from fabind_tpu_torch.config import FABindConfig
from fabind_tpu_torch.data.batching import build_sample


def measure_sizes(source, indices: Sequence, cfg: FABindConfig,
                  group: str = "test", limit: Optional[int] = None
                  ) -> np.ndarray:
    """[n, 3] int array of (n_ligand, n_pocket, n_protein) per sample of
    `source` (anything with `.get(index) -> raw dict`). Builds samples on
    the host only; `limit` subsamples evenly."""
    idx = list(indices)
    if limit is not None and len(idx) > limit:
        idx = [idx[i] for i in
               np.linspace(0, len(idx) - 1, limit).astype(int)]
    rng = np.random.RandomState(0)
    sizes = []
    for i in idx:
        s = build_sample(source.get(i), cfg, group=group, rng=rng)
        sizes.append((s["lig_feat"].shape[0], len(s["pocket_idx"]),
                      s["prot_xyz"].shape[0]))
    # 2-D even when empty, so suggest_buckets can fall back cleanly
    return np.asarray(sizes, np.int64).reshape(-1, 3)


def _pad8(v: int) -> int:
    return int(-(-v // 8) * 8)


# Per-variant weight of the whole-protein term in _cost, relative to the
# pair term: the JAX package's least-squares fit of step time over a
# (pocket, protein) grid gave 0.04 (base) and about 0 (FABind+); both are
# stored as 0.05 so that candidates still tie-break toward less protein
# padding. Kept equal to the JAX package's so both route alike.
_PROTEIN_WEIGHT = {"fabind": 0.05, "fabind_plus": 0.05}


def _cost(sizes: np.ndarray, dims: Tuple[int, int, int],
          protein_weight: float = 0.25) -> float:
    """Padded compute for `sizes` run at bucket `dims`: the pair-chain term
    (1+Nc)(1+Np) plus the weighted whole-protein term (1+Nc)(1+Nr)."""
    lig, pkt, prot = dims
    return len(sizes) * ((1 + lig) * (1 + pkt)
                         + protein_weight * (1 + lig) * (1 + prot))


def suggest_buckets(sizes: np.ndarray, cfg: FABindConfig, k: int = 3,
                    pocket_headroom: int = 8) -> List:
    """Partition the size distribution into at most k buckets (exact DP over
    samples sorted by their cost) and return them small to large as
    ShapeConfigs.

    The largest bucket always equals cfg.shapes, so nothing the base config
    accepts is dropped; dims are rounded up to multiples of 8 and clamped to
    cfg.shapes. `pocket_headroom` residues go on top of each group's
    measured pocket maximum: `measure_sizes` sees the crop around the true
    ligand center, the served crop is around the predicted one.
    """
    base = cfg.shapes
    w = _PROTEIN_WEIGHT.get(cfg.model.variant, 0.25)
    fit = (sizes[:, 0] <= base.max_ligand) & (sizes[:, 2] <= base.max_protein)
    sizes = sizes[fit]
    if sizes.shape[0] == 0 or k <= 1:
        return [base]

    # sort by the per-sample cost under the variant's weights, not the pair
    # term alone: the DP cuts contiguous runs of this key, and a pair-only
    # key lets a small-pair, large-protein sample force a small bucket's
    # protein dim up to its own size
    key = ((1 + sizes[:, 0]).astype(np.float64) * (1 + sizes[:, 1])
           + w * (1 + sizes[:, 0]) * (1 + sizes[:, 2]))
    s = sizes[np.argsort(key)]
    n = s.shape[0]

    def group_dims(i: int, j: int) -> Tuple[int, int, int]:
        """Bucket dims covering sorted samples i..j inclusive (maxima over
        every axis, since the key orders by cost only)."""
        m = np.max(s[i:j + 1], axis=0)
        return (min(_pad8(int(m[0])), base.max_ligand),
                min(_pad8(int(m[1]) + pocket_headroom), base.max_pocket),
                min(_pad8(int(m[2])), base.max_protein))

    # best[j, g]: least cost covering the first j samples with g groups
    INF = float("inf")
    best = np.full((n + 1, k + 1), INF)
    back = np.zeros((n + 1, k + 1), np.int64)
    best[0, 0] = 0.0
    for j in range(1, n + 1):
        for g in range(1, k + 1):
            for i in range(j):
                if best[i, g - 1] == INF:
                    continue
                c = best[i, g - 1] + _cost(s[i:j], group_dims(i, j - 1), w)
                if c < best[j, g]:
                    best[j, g] = c
                    back[j, g] = i
    g = int(np.argmin(best[n, 1:]) + 1)
    cuts = []
    j = n
    while g > 0:
        i = int(back[j, g])
        cuts.append((i, j - 1))
        j, g = i, g - 1
    cuts.reverse()

    shapes = []
    seen = set()
    for lig, pkt, prot in (group_dims(i, j) for i, j in cuts):
        if (lig, pkt, prot) in seen:
            continue
        seen.add((lig, pkt, prot))
        shapes.append(dataclasses.replace(base, max_ligand=lig,
                                          max_pocket=pkt, max_protein=prot))
    # the drop boundary stays the configured maximum
    if not any((sh.max_ligand, sh.max_pocket, sh.max_protein)
               == (base.max_ligand, base.max_pocket, base.max_protein)
               for sh in shapes):
        shapes.append(base)
    shapes.sort(key=lambda sh: (sh.max_ligand, sh.max_pocket, sh.max_protein))
    return shapes


def resolve_buckets(spec: Optional[str], cfg: FABindConfig, source=None,
                    indices: Optional[Sequence] = None, group: str = "test",
                    limit: int = 512, pocket_headroom: int = 8
                    ) -> Optional[List]:
    """A bucket spec -> a small-to-large ShapeConfig list, or None.

      - None / "" / "none"  -> None (the one cfg.shapes bucket)
      - "auto" / "auto:K"   -> up to K (default 3) buckets from the size
                               distribution of `source` at `indices`
      - "l:p:r[,l:p:r...]"  -> explicit (ligand, pocket, protein) dims
    """
    if not spec or spec == "none":
        return None
    if spec.startswith("auto"):
        if source is None or indices is None:
            raise ValueError("--buckets auto needs a dataset to measure")
        k = int(spec.split(":")[1]) if ":" in spec else 3
        sizes = measure_sizes(source, indices, cfg, group=group, limit=limit)
        return suggest_buckets(sizes, cfg, k=k,
                               pocket_headroom=pocket_headroom)
    buckets = []
    for part in spec.split(","):
        ml, mp, mr = (int(v) for v in part.split(":"))
        buckets.append(dataclasses.replace(
            cfg.shapes, max_ligand=ml, max_pocket=mp, max_protein=mr))
    return buckets


def sort_bucket_cfgs(cfg: FABindConfig, buckets) -> List[FABindConfig]:
    """One FABindConfig per bucket, smallest to largest; the largest must
    cover cfg.shapes."""
    bs = sorted(buckets or [cfg.shapes],
                key=lambda s: (s.max_ligand, s.max_pocket, s.max_protein))
    last = bs[-1]
    if (last.max_ligand < cfg.shapes.max_ligand
            or last.max_protein < cfg.shapes.max_protein):
        raise ValueError("largest bucket must cover cfg.shapes")
    return [dataclasses.replace(cfg, shapes=s) for s in bs]


def bucket_label(shapes) -> str:
    """A bucket's key in spans and counters: "LxPxR" (ligand, pocket and
    protein sizes)."""
    return f"{shapes.max_ligand}x{shapes.max_pocket}x{shapes.max_protein}"


def route_sample(s, bucket_cfgs) -> Optional[FABindConfig]:
    """The smallest bucket the sample fits, or None when it fits none.

    The pocket count only chooses between buckets: the largest bucket takes
    any pocket count (the Np crop truncates and counts it in
    pocket_overflow)."""
    n_lig = s["lig_feat"].shape[0]
    n_prot = s["prot_xyz"].shape[0]
    n_pkt = len(s["pocket_idx"])
    for i, c in enumerate(bucket_cfgs):
        sc = c.shapes
        last = i == len(bucket_cfgs) - 1
        if (n_lig <= sc.max_ligand and n_prot <= sc.max_protein
                and (last or n_pkt <= sc.max_pocket)
                and s["bond_deg"] <= sc.bond_k):
            return c
    return None
