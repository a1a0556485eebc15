"""The one traffic generator: raw docking requests from a seed and a mix's
parameters (a `traffic/<mix>.json` file).

Widened from chip_smoke.py `make_requests` (:784): globular proteins (CA
positions uniform in a ball of the size a real protein of that length has)
with ESM-shaped features, and chain-like ligands (1.5 A bonds) placed inside
the protein, with LAS masks over 1- and 2-hop neighbours. Sizes follow a
log-normal, clipped, as the mix gives them (the PDBbind-2020 time split has
a heavy tail of large ligands and proteins). Every request has its own
protein. Every seed asks for the same multiset of sizes (the distribution's
quantiles), in its own order, with its own coordinates and features: what
a seed changes is not the amount of work. numpy and scipy only.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List

import numpy as np

ROOT = Path(__file__).resolve().parent
ESM_DIM = 1280
LIG_FEAT_DIM = 56


def load_mix(name: str) -> Dict:
    """The parameters of traffic mix `name` (traffic/<name>.json)."""
    return json.loads((ROOT / "traffic" / f"{name}.json").read_text())


def _lognormal_quantiles(n: int, spec: Dict) -> np.ndarray:
    """The n quantiles (i + 1/2) / n of the log-normal with median
    spec["median"] and log-space sigma spec["sigma"], rounded and clipped
    to [min, max]."""
    from scipy.special import ndtri
    z = ndtri((np.arange(n) + 0.5) / n)
    x = np.exp(np.log(spec["median"]) + spec["sigma"] * z)
    return np.clip(np.rint(x), spec["min"], spec["max"]).astype(np.int64)


def make_request(rng: np.random.Generator, nr: int, na: int) -> Dict:
    """One raw request of nr residues and na ligand atoms."""
    radius = 2.2 * nr ** 0.38 * (5 / 3) ** 0.5
    v = rng.standard_normal((nr, 3))
    v *= (radius * rng.random((nr, 1)) ** (1 / 3)) / np.linalg.norm(
        v, axis=1, keepdims=True)
    prot = (v + rng.standard_normal(3) * 30).astype(np.float32)
    site = prot.mean(0) + rng.standard_normal(3) * 0.3 * radius
    steps = rng.standard_normal((na, 3))
    steps *= 1.5 / np.linalg.norm(steps, axis=1, keepdims=True)
    lig = np.cumsum(steps, axis=0)
    lig = (lig - lig.mean(0) + site).astype(np.float32)
    bonds = [(i, i + 1) for i in range(na - 1)]
    bonds += [(j, i) for i, j in bonds]
    las = np.abs(np.arange(na)[:, None] - np.arange(na)[None]) <= 2
    np.fill_diagonal(las, False)
    return dict(
        protein_xyz=prot,
        esm_feat=rng.standard_normal((nr, ESM_DIM), dtype=np.float32),
        lig_coords=lig, rdkit_coords=lig,
        lig_feats=rng.standard_normal((na, LIG_FEAT_DIM), dtype=np.float32),
        bond_edges=np.asarray(bonds, np.int64), las_mask=las)


def block_sizes(mix: Dict) -> np.ndarray:
    """[n, 2] (residues, ligand atoms) of one block of the mix (one call's
    requests, else the whole pool): the n quantiles of each distribution,
    paired by a fixed permutation. The same for every seed."""
    n = mix.get("requests_per_call", mix["pool_requests"])
    prot = _lognormal_quantiles(n, mix["protein_residues"])
    lig = _lognormal_quantiles(n, mix["ligand_atoms"])
    return np.stack([prot[np.random.default_rng(0).permutation(n)], lig], 1)


def sizes(mix: Dict, seed: int) -> np.ndarray:
    """[n, 2] (residues, ligand atoms) of the mix's whole pool of requests
    for `seed`: block after block, each the same multiset of sizes in an
    order drawn from the seed, so every seed (and every call) asks for the
    same work and only its order and contents differ."""
    block = block_sizes(mix)
    n = mix["pool_requests"]
    out = [block[np.random.default_rng([seed, 0, b]).permutation(len(block))]
           for b in range(-(-n // len(block)))]
    return np.concatenate(out)[:n]


def make_pool(mix: Dict, seed: int) -> List[Dict]:
    """The mix's pool of distinct requests for `seed`, in order: the same
    seed gives the same requests. Request i draws from its own stream, so a
    prefix of the pool does not depend on its length."""
    out = []
    for i, (nr, na) in enumerate(sizes(mix, seed)):
        out.append(make_request(np.random.default_rng([seed, 1, i]),
                                int(nr), int(na)))
    return out
