"""Model FLOPs of one request, defined by the model and not by what runs it.

The count is the matrix products of the reference's forward (2 M N K per
product, as the profiler's `with_flops` counts them) at the configuration's
widths and the request's real sizes (no padding: batch 1, the ligand's
atoms, the pocket crop's residues, the protein's residues) and the recycle
counts run. The forward is evaluated on the meta device under
`torch.utils.flop_counter.FlopCounterMode`: no data, only shapes, so the
count is analytic; the reference's shapes are static, so it runs there
whole. A later PR that takes a kernel off the path leaves it unchanged.
"""
from __future__ import annotations

import dataclasses
from functools import lru_cache
from typing import Dict, Tuple

import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.reference.models.fabind import make_model
from benchmark.reference.types import FABindBatch

# sizes the meta batch needs beyond the shape bucket
_FLOAT = ("lig_feat", "lig_coords", "lig_coords_init", "lig_rdkit_coords",
          "prot_feat", "prot_xyz", "pocket_label", "coords_center",
          "ligand_radius", "pocket_residue_center")


@lru_cache(maxsize=None)
def _meta_model(cfg):
    with torch.device("meta"):
        return make_model(cfg).eval()


def meta_batch(cfg, shapes) -> FABindBatch:
    """A batch of one complex that fills `shapes` exactly, on meta."""
    m = cfg.model
    Nc, Np, Nr, Kb = (shapes.max_ligand, shapes.max_pocket,
                      shapes.max_protein, shapes.bond_k)
    dims: Dict[str, Tuple] = dict(
        lig_feat=(1, Nc, m.compound_feat_dim), lig_mask=(1, Nc),
        lig_coords=(1, Nc, 3), lig_coords_init=(1, Nc, 3),
        lig_rdkit_coords=(1, Nc, 3), bond_idx=(1, Nc, Kb),
        bond_mask=(1, Nc, Kb), las_adj=(1, Nc, Nc),
        prot_feat=(1, Nr, m.protein_feat_dim), prot_mask=(1, Nr),
        prot_xyz=(1, Nr, 3), pocket_idx=(1, Np), pocket_mask=(1, Np),
        pocket_label=(1, Nr), coords_center=(1, 3), ligand_radius=(1,),
        pocket_residue_center=(1, 3))
    out = {}
    for k, shape in dims.items():
        dtype = (torch.float32 if k in _FLOAT else
                 torch.int64 if k in ("bond_idx", "pocket_idx") else
                 torch.bool)
        out[k] = torch.empty(shape, dtype=dtype, device="meta")
    return FABindBatch(**out)


@lru_cache(maxsize=4096)
def forward_flops(cfg, n_lig: int, n_pkt: int, n_prot: int,
                  pocket_count: int, dock_count: int) -> int:
    """Matrix-product FLOPs of one predicted-pocket inference forward
    (`inference_diag`) of one complex of these real sizes, with these
    recycle counts. `cfg` is a reference FABindConfig."""
    shapes = dataclasses.replace(cfg.shapes, max_ligand=n_lig,
                                 max_pocket=n_pkt, max_protein=n_prot)
    model = _meta_model(cfg)
    batch = meta_batch(cfg, shapes)
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        model.inference_diag(batch, shapes=shapes, pocket_count=pocket_count,
                             count=dock_count)
    return int(fc.get_total_flops())


def pocket_size(sample_pocket: int, shapes) -> int:
    """The pocket crop's residues in the bucket: the crop around the
    ligand (build_sample's pocket_idx), cut to the bucket's Np, at least 1."""
    return max(1, min(int(sample_pocket), shapes.max_pocket))


# -------------------------------------------------------------- closed form
# Between the size thresholds below, the forward's product FLOPs are a
# quadratic in (Nc, Np, Nr) plus the docking recycle count times another:
# every product runs over nodes, a fixed K = 1 + ctx_k neighbours per node
# (K is fixed once Np and Nr exceed ctx_k), or ligand x pocket and ligand x
# protein pairs. `fit` solves the 2 x 10 coefficients exactly from the meta
# count at chosen sizes and checks them at others; configs/<name>.json keeps
# them, so a run counts a request in microseconds.
MONOMIALS = ("1", "c", "p", "r", "cc", "pp", "rr", "cp", "cr", "pr")
FIT_SIZES = ((12, 40, 100), (20, 48, 128), (28, 60, 160), (36, 72, 200),
             (44, 90, 256), (52, 110, 300), (60, 128, 384), (70, 150, 420),
             (80, 170, 512), (90, 200, 640), (96, 256, 1024))
CHECK_SIZES = ((16, 44, 120), (33, 101, 333), (77, 233, 901))


def _basis(n_lig: int, n_pkt: int, n_prot: int):
    c, p, r = n_lig, n_pkt, n_prot
    return (1, c, p, r, c * c, p * p, r * r, c * p, c * r, p * r)


def in_closed_form(cfg, n_pkt: int, n_prot: int) -> bool:
    """Whether the closed form holds at these sizes: the top-K tables are
    full (K = ctx_k) in both graphs."""
    return n_pkt > cfg.shapes.ctx_k and n_prot > cfg.shapes.ctx_k_whole


def fit(cfg, pocket_count: int) -> dict:
    """{"base": [10 ints], "per_recycle": [10 ints]} with
    forward_flops(cfg, c, p, r, pocket_count, n) == sum(coef * monomial)
    over base + n * per_recycle, solved exactly at FIT_SIZES for n = 1, 2
    and checked at CHECK_SIZES for n = 1, 3, 8."""
    import numpy as np

    A = np.array([_basis(*s) for s in FIT_SIZES], np.float64)
    y = [np.array([forward_flops(cfg, *s, pocket_count, n)
                   for s in FIT_SIZES], np.float64) for n in (1, 2)]
    sol = [np.linalg.lstsq(A, v, rcond=None)[0] for v in y]
    per = np.rint(sol[1] - sol[0]).astype(np.int64)
    base = np.rint(sol[0]).astype(np.int64) - per
    coef = {"base": [int(v) for v in base],
            "per_recycle": [int(v) for v in per]}
    for s in CHECK_SIZES + FIT_SIZES[:2]:
        for n in (1, 3, 8):
            want = forward_flops(cfg, *s, pocket_count, n)
            if closed_form(coef, *s, n) != want:
                raise ValueError(f"closed form off at {s}, {n}: "
                                 f"{closed_form(coef, *s, n)} != {want}")
    return coef


def closed_form(coef: dict, n_lig: int, n_pkt: int, n_prot: int,
                dock_count: int) -> int:
    b = _basis(n_lig, n_pkt, n_prot)
    return int(sum(k * m for k, m in zip(coef["base"], b))
               + dock_count * sum(k * m for k, m in
                                  zip(coef["per_recycle"], b)))


def request_flops(cfg, coef: dict, n_lig: int, n_pkt: int, n_prot: int,
                  pocket_count: int, dock_count: int) -> int:
    """forward_flops through the closed form `coef` where it holds (None:
    always the meta count)."""
    if coef is not None and in_closed_form(cfg, n_pkt, n_prot):
        return closed_form(coef, n_lig, n_pkt, n_prot, dock_count)
    return forward_flops(cfg, n_lig, n_pkt, n_prot, pocket_count, dock_count)


if __name__ == "__main__":
    # python -m benchmark.flops CONFIG: print the closed form's coefficients
    # for configs/CONFIG.json ("flops" there)
    import json
    import sys

    from benchmark.configs_io import load_config

    name = sys.argv[1]
    c = load_config(name)
    print(json.dumps(fit(c.ref_cfg, c.ref_cfg.model.pocket_pred_n_iter)))
