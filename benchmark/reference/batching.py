"""Host-side sample construction + fixed-shape collation (numpy).

Own copy of fabind_tpu/data/batching.py: `build_sample` turns one raw
complex into unpadded arrays in the protein-mean frame (for the train group
with the noisy pocket crop, torsion noise and a random rotation),
`collate` pads and stacks samples into the FABindBatch field arrays. With
use_esm2_feat=False or esm2_concat_raw the protein features are (or end
with) the 15-d geometric ones of featurize.protein_gvp_features.
`data.native.collate_native` returns the same arrays with the packing done
in C (csrc/collate.cc, the counterpart of the JAX package's
fabind_tpu/data/native.py); the Loader, the engine and the CLIs call
`collate`.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from benchmark.reference.config import FABindConfig
from benchmark.reference.torsion import randomize_torsions


class SampleTooLarge(ValueError):
    pass


def uniform_random_rotation(x: np.ndarray, rng: np.random.RandomState
                            ) -> np.ndarray:
    """Uniform random 3D rotation (utils/utils.py:50-86, Avro 1992).

    Reference-exact, including its quirk: despite the reference docstring
    saying "about the mean coordinate", (x - mean) @ M + mean @ M is
    algebraically x @ M — a rotation about the ORIGIN. Both call sites
    recenter afterwards, so this matters only to new callers: do not rely
    on the mean being preserved."""
    x1 = rng.rand()
    R = np.eye(3)
    R[0, 0] = R[1, 1] = np.cos(2 * np.pi * x1)
    R[0, 1] = -np.sin(2 * np.pi * x1)
    R[1, 0] = np.sin(2 * np.pi * x1)
    x2 = 2 * np.pi * rng.rand()
    x3 = rng.rand()
    v = np.array([np.cos(x2) * np.sqrt(x3), np.sin(x2) * np.sqrt(x3),
                  np.sqrt(1 - x3)])
    H = np.eye(3) - 2 * np.outer(v, v)
    M = -(H @ R)
    x = x.reshape(-1, 3)
    mean = x.mean(axis=0)
    return (x - mean) @ M + mean @ M


def build_sample(raw: Dict[str, np.ndarray], cfg: FABindConfig,
                 group: str = "train",
                 rng: Optional[np.random.RandomState] = None,
                 isomorphisms: Optional[np.ndarray] = None) -> Dict[str, np.ndarray]:
    """One complex -> unpadded device-ready arrays.

    raw keys: protein_xyz [Nr,3] (CA), esm_feat [Nr,1280], lig_coords [n,3]
    (ground truth; absent at pure inference -> pass rdkit coords), lig_feats
    [n,56], bond_edges [E,2] (both directions), las_mask [n,n],
    rdkit_coords [n,3]. With use_esm2_feat=False, esm_feat may be absent and
    protein_full_coords [Nr,4,3] supplies the 15-d geometric features
    instead (featurize.protein_gvp_features).
    """
    rng = rng or np.random.RandomState()
    m = cfg.model
    t = cfg.train

    protein_xyz = np.asarray(raw["protein_xyz"], np.float32)
    coords = np.asarray(raw["lig_coords"], np.float32)
    rdkit_coords = np.asarray(raw["rdkit_coords"], np.float32)
    if protein_xyz.shape[0] == 0:
        # a malformed/empty PDB parses to zero residues; without this
        # guard the empty mean below silently floods the sample (and the
        # served Pose) with NaN instead of an error
        raise ValueError("protein has no residues (failed PDB parse?)")
    if coords.shape[0] == 0:
        raise ValueError("ligand has no atoms")

    # protein-mean frame (utils.py:209-211)
    bias = protein_xyz.mean(axis=0)
    protein_xyz = protein_xyz - bias
    coords = coords - bias
    com = coords.mean(axis=0)

    # pocket radius: fixed for base; ligand_radius-dependent for plus
    # (FABind_plus utils.py:214-230)
    ligand_radius = float(np.linalg.norm(coords - com, axis=1).max())
    if m.is_plus and not m.force_fix_radius:
        if m.pocket_radius_buffer <= 2.0:
            radius = m.pocket_radius_buffer * ligand_radius
        else:
            radius = m.pocket_radius_buffer + ligand_radius
        radius = max(radius, m.min_pocket_radius)
    else:
        radius = m.pocket_radius

    def keep_nodes(noise: Optional[float]) -> np.ndarray:
        c = com
        if noise:
            c = com + noise * (2 * rng.rand(3) - 1)
        return np.linalg.norm(protein_xyz - c, axis=1) < radius

    noise = t.addNoise if group == "train" else None
    keep = keep_nodes(noise)
    keep_no_noise = keep_nodes(None)
    if keep.sum() < 5:             # (utils.py:224-226)
        keep[:100] = True

    pocket_idx = np.nonzero(keep)[0].astype(np.int32)
    pocket_xyz = protein_xyz[pocket_idx]
    pocket_center = pocket_xyz.mean(axis=0)

    # train-time ligand torsion noise (utils/utils.py:280-299): randomize
    # every rotatable torsion of the conformer before rotation/placement
    rk = rdkit_coords
    if t.train_ligand_torsion_noise and group == "train":
        rk = randomize_torsions(rk, np.asarray(raw["bond_edges"]), rng,
                                bond_orders=raw.get("bond_orders"))

    # ligand init modes (utils.py:302-325); released configs use
    # pocket_center_rdkit. train group applies a uniform random rotation
    # (data.py:63-68)
    mode = m.compound_coords_init_mode
    las_full = False
    if mode == "pocket_center_rdkit":
        if group == "train" and t.train_rotation:
            rk = uniform_random_rotation(rk, rng).astype(np.float32)
        coords_init = rk - rk.mean(axis=0) + pocket_center
    elif mode == "random":
        coords_init = 4 * (2 * rng.rand(*coords.shape) - 1)
        rk = rdkit_coords
    elif mode.startswith("perturb_"):
        amp = float(mode.split("_")[1].rstrip("A"))
        coords_init = coords + amp * (2 * rng.rand(*coords.shape) - 1)
        rk = rdkit_coords
    elif mode == "compound_center":
        coords_init = com[None] + 10 * (2 * rng.rand(*coords.shape) - 1)
        rk = rdkit_coords
    elif mode == "pocket_center":
        coords_init = pocket_center[None] + 5 * (2 * rng.rand(*coords.shape) - 1)
        rk = rdkit_coords
    elif mode in ("redocking", "redocking_no_rotate"):
        # LAS reference becomes the GT coords with a FULL constraint
        # adjacency (utils.py:320-325, 356-358)
        rot = (uniform_random_rotation(coords, rng)
               if mode == "redocking" else coords)
        coords_init = rot - rot.mean(axis=0) + pocket_center
        rk = coords
        las_full = True
    else:
        raise ValueError(f"unknown compound_coords_init_mode {mode!r}")

    # bond neighbor table
    bond_edges = np.asarray(raw["bond_edges"], np.int64).reshape(-1, 2)
    n = coords.shape[0]
    nbrs: List[List[int]] = [[] for _ in range(n)]
    for i, j in bond_edges:
        if j not in nbrs[i]:
            nbrs[i].append(int(j))
    deg = max((len(v) for v in nbrs), default=0)

    las_adj = np.asarray(raw["las_mask"], bool)
    if las_full:
        las_adj = ~np.eye(coords.shape[0], dtype=bool)

    if m.use_esm2_feat and not m.esm2_concat_raw:
        prot_feat = np.asarray(raw["esm_feat"], np.float32)
    else:
        # the 15-d geometric features need the four backbone atoms
        # (protein_full_coords, written by cli.preprocess and carried by the
        # engine's structure-file path); the reference's LMDB store holds CA
        # only
        if raw.get("protein_full_coords") is None:
            raise KeyError(
                "use_esm2_feat=False/esm2_concat_raw need protein_full_coords "
                "[Nr,4,3] in the sample (produced by cli.preprocess)")
        raise NotImplementedError("the reference serves ESM2 features only")
        if m.esm2_concat_raw:   # [esm 1280 ++ gvp 15]
            prot_feat = np.concatenate(
                [np.asarray(raw["esm_feat"], np.float32), gvp], axis=1)
        else:
            prot_feat = gvp

    return {
        "lig_feat": np.asarray(raw["lig_feats"], np.float32),
        "lig_coords": coords,
        "lig_coords_init": coords_init.astype(np.float32),
        "lig_rdkit_coords": rk.astype(np.float32),
        "bond_nbrs": nbrs,
        "bond_deg": deg,
        "las_adj": las_adj,
        "prot_feat": prot_feat,
        "prot_xyz": protein_xyz,
        "pocket_idx": pocket_idx,
        # pocket_idx_no_noise=True in both released configs (utils.py:432-435)
        "pocket_label": keep_no_noise.astype(np.float32),
        "coords_center": com.astype(np.float32),
        "ligand_radius": np.float32(ligand_radius),
        "pocket_residue_center": pocket_center.astype(np.float32),
        "isomorphisms": isomorphisms,
        "coord_offset": bias.astype(np.float32),
    }


def collate(samples: Sequence[Dict], cfg: FABindConfig, max_iso: int = 8,
            n_valid: Optional[int] = None):
    """Pad + stack samples into numpy arrays keyed by FABindBatch field
    (`FABindBatch.from_numpy(arrays, device)` moves them to the device).
    Raises SampleTooLarge if a sample exceeds the shape bucket. n_valid
    marks trailing rows beyond it as padding duplicates
    (sample_valid=False)."""

    s = cfg.shapes
    B = len(samples)
    Nc, Np, Nr, Kb = s.max_ligand, s.max_pocket, s.max_protein, s.bond_k

    def zeros(*shape, dtype=np.float32):
        return np.zeros(shape, dtype)

    out = dict(
        lig_feat=zeros(B, Nc, cfg.model.compound_feat_dim),
        lig_mask=zeros(B, Nc, dtype=bool),
        lig_coords=zeros(B, Nc, 3),
        lig_coords_init=zeros(B, Nc, 3),
        lig_rdkit_coords=zeros(B, Nc, 3),
        bond_idx=zeros(B, Nc, Kb, dtype=np.int32),
        bond_mask=zeros(B, Nc, Kb, dtype=bool),
        las_adj=zeros(B, Nc, Nc, dtype=bool),
        prot_feat=zeros(B, Nr, cfg.model.protein_feat_dim),
        prot_mask=zeros(B, Nr, dtype=bool),
        prot_xyz=zeros(B, Nr, 3),
        pocket_idx=zeros(B, Np, dtype=np.int32),
        pocket_mask=zeros(B, Np, dtype=bool),
        pocket_label=zeros(B, Nr),
        coords_center=zeros(B, 3),
        ligand_radius=zeros(B),
        pocket_residue_center=zeros(B, 3),
    )
    has_iso = any(x.get("isomorphisms") is not None for x in samples)
    if has_iso:
        out["isomorphisms"] = np.tile(np.arange(Nc, dtype=np.int32),
                                      (B, max_iso, 1))
        out["iso_mask"] = zeros(B, max_iso, dtype=bool)

    for b, x in enumerate(samples):
        n = x["lig_feat"].shape[0]
        nr = x["prot_xyz"].shape[0]
        npk = len(x["pocket_idx"])
        if n > Nc:
            raise SampleTooLarge(f"ligand {n} > {Nc}")
        if nr > Nr:
            raise SampleTooLarge(f"protein {nr} > {Nr}")
        if x["bond_deg"] > Kb:
            raise SampleTooLarge(f"bond degree {x['bond_deg']} > {Kb}")
        npk_eff = min(npk, Np)

        out["lig_feat"][b, :n] = x["lig_feat"]
        out["lig_mask"][b, :n] = True
        out["lig_coords"][b, :n] = x["lig_coords"]
        out["lig_coords_init"][b, :n] = x["lig_coords_init"]
        out["lig_rdkit_coords"][b, :n] = x["lig_rdkit_coords"]
        for i, js in enumerate(x["bond_nbrs"]):
            for k, j in enumerate(js):
                out["bond_idx"][b, i, k] = j
                out["bond_mask"][b, i, k] = True
        out["las_adj"][b, :n, :n] = x["las_adj"]
        out["prot_feat"][b, :nr] = x["prot_feat"]
        out["prot_mask"][b, :nr] = True
        out["prot_xyz"][b, :nr] = x["prot_xyz"]
        out["pocket_idx"][b, :npk_eff] = x["pocket_idx"][:npk_eff]
        out["pocket_mask"][b, :npk_eff] = True
        out["pocket_label"][b, :nr] = x["pocket_label"]
        out["coords_center"][b] = x["coords_center"]
        out["ligand_radius"][b] = x["ligand_radius"]
        out["pocket_residue_center"][b] = x["pocket_residue_center"]
        if has_iso and x.get("isomorphisms") is not None:
            iso = np.asarray(x["isomorphisms"], np.int32)[:max_iso]
            out["isomorphisms"][b, :len(iso), :n] = iso
            out["iso_mask"][b, :len(iso)] = True

    if not has_iso:
        out["isomorphisms"] = None
        out["iso_mask"] = None
    out["sample_valid"] = (np.arange(B) < (B if n_valid is None else n_valid))
    return out
