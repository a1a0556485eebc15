"""Device-side batch of torch tensors.

Counterpart of fabind_tpu/data/types.py: the same fields, padded to the
ShapeConfig bucket with prefix-packed valid entries. Index tables are int64
(torch's index type); masks are bool.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from fabind_tpu_torch.utils import tracing

Tensor = torch.Tensor

_INDEX_FIELDS = ("bond_idx", "pocket_idx", "isomorphisms")


@dataclass
class FABindBatch:
    # ligand ("compound")
    lig_feat: Tensor          # [B, Nc, 56] atom features
    lig_mask: Tensor          # [B, Nc] bool
    lig_coords: Tensor        # [B, Nc, 3] ground-truth coords, protein-mean frame
    lig_coords_init: Tensor   # [B, Nc, 3] init coords (pocket_center_rdkit mode)
    lig_rdkit_coords: Tensor  # [B, Nc, 3] rdkit conformer (LAS reference)
    bond_idx: Tensor          # [B, Nc, Kb] ligand-local bond neighbors
    bond_mask: Tensor         # [B, Nc, Kb] bool
    las_adj: Tensor           # [B, Nc, Nc] bool LAS constraint adjacency

    # protein (whole)
    prot_feat: Tensor         # [B, Nr, 1280] ESM2 features
    prot_mask: Tensor         # [B, Nr] bool
    prot_xyz: Tensor          # [B, Nr, 3] CA coords, protein-mean frame

    # precomputed pocket crop (stage-1 / teacher forcing)
    pocket_idx: Tensor        # [B, Np] indices into protein rows
    pocket_mask: Tensor       # [B, Np] bool
    pocket_label: Tensor      # [B, Nr] binary residue labels

    coords_center: Tensor     # [B, 3] gt ligand centroid

    # FABind+ extras
    ligand_radius: Tensor     # [B]
    pocket_residue_center: Tensor  # [B, 3]

    isomorphisms: Optional[Tensor] = None   # [B, n_iso, Nc]
    iso_mask: Optional[Tensor] = None       # [B, n_iso] bool
    # False for trailing-batch padding duplicates; None means all rows real
    sample_valid: Optional[Tensor] = None   # [B] bool

    @property
    def batch_size(self) -> int:
        return self.lig_feat.shape[0]

    @property
    def n_lig(self) -> int:
        return self.lig_feat.shape[1]

    @property
    def n_pocket(self) -> int:
        return self.pocket_idx.shape[1]

    @property
    def n_protein(self) -> int:
        return self.prot_feat.shape[1]

    @classmethod
    @tracing.spanned("data.upload")
    def from_numpy(cls, arrays: Dict[str, Optional[np.ndarray]],
                   device) -> "FABindBatch":
        """Numpy arrays (as `data.batching.collate` returns them) -> a batch
        on `device`. Index tables become int64. A value that is already a
        tensor is taken as it is (rows kept on the device). Traced as the
        span data.upload."""
        out = {}
        for f in dataclasses.fields(cls):
            a = arrays.get(f.name)
            if a is None or isinstance(a, torch.Tensor):
                out[f.name] = a
                continue
            t = torch.from_numpy(np.ascontiguousarray(a))
            if f.name in _INDEX_FIELDS:
                t = t.long()
            out[f.name] = to_device(t, device)
        return cls(**out)


def to_device(t: Tensor, device) -> Tensor:
    """A host tensor on `device`. To a CUDA device it goes through pinned
    memory without blocking the host (the copy is ordered on the current
    stream before the kernels that read it)."""
    device = torch.device(device)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def dummy_arrays(shapes, batch_size: int = 2, seed: int = 0,
                 n_lig_valid: Optional[int] = None,
                 n_prot_valid: Optional[int] = None,
                 feat_dim: int = 56,
                 prot_feat_dim: int = 1280) -> Dict[str, np.ndarray]:
    """Random, self-consistent batch arrays made with numpy from `seed`
    (same construction as fabind_tpu's dummy_batch: chain bonds, LAS over
    chain neighbours, the pocket = the Np residues nearest the ligand
    centroid)."""
    rng = np.random.RandomState(seed)
    B = batch_size
    Nc, Np, Nr, Kb = (shapes.max_ligand, shapes.max_pocket,
                      shapes.max_protein, shapes.bond_k)
    nl = n_lig_valid or max(4, Nc // 2)
    nr = n_prot_valid or max(16, Nr // 2)
    f32 = np.float32

    lig_mask = np.broadcast_to(np.arange(Nc)[None] < nl, (B, Nc)).copy()
    prot_mask = np.broadcast_to(np.arange(Nr)[None] < nr, (B, Nr)).copy()
    prot_xyz = rng.randn(B, Nr, 3).astype(f32) * 10.0
    prot_xyz -= prot_xyz.mean(axis=1, keepdims=True)
    lig_coords = rng.randn(B, Nc, 3).astype(f32) * 3.0
    rdkit = lig_coords + 0.3 * rng.randn(B, Nc, 3).astype(f32)

    idx = np.arange(Nc)
    bond_idx = np.zeros((B, Nc, Kb), np.int32)
    bond_idx[:, :, 0] = np.maximum(idx - 1, 0)
    bond_idx[:, :, 1] = np.minimum(idx + 1, Nc - 1)
    bond_mask = np.zeros((B, Nc, Kb), bool)
    bond_mask[:, :, 0] = idx > 0
    bond_mask[:, :, 1] = idx + 1 < nl
    bond_mask &= lig_mask[:, :, None]

    las = np.zeros((B, Nc, Nc), bool)
    las[:, idx[:-1], idx[1:]] = True
    las[:, idx[1:], idx[:-1]] = True
    las &= lig_mask[:, :, None] & lig_mask[:, None, :]

    com = (np.where(lig_mask[..., None], lig_coords, 0).sum(1)
           / nl).astype(f32)
    d = np.linalg.norm(prot_xyz - com[:, None], axis=-1)
    d = np.where(prot_mask, d, 1e9)
    pocket_idx = np.sort(np.argsort(d, axis=1, kind="stable")[:, :Np], axis=1)
    n_keep = min(Np, nr)
    pocket_mask = np.broadcast_to(np.arange(Np)[None] < n_keep, (B, Np)).copy()
    pocket_idx = np.where(pocket_mask, pocket_idx, 0).astype(np.int32)
    label = np.zeros((B, Nr), f32)
    for b in range(B):
        label[b, pocket_idx[b][pocket_mask[b]]] = 1.0

    pkt_xyz = np.take_along_axis(prot_xyz, pocket_idx[..., None].astype(np.int64),
                                 axis=1)
    pkt_center = (np.where(pocket_mask[..., None], pkt_xyz, 0).sum(1)
                  / max(n_keep, 1)).astype(f32)
    init = (rdkit - np.where(lig_mask[..., None], rdkit, 0).sum(1, keepdims=True)
            / nl + pkt_center[:, None])
    lr = np.where(lig_mask, np.linalg.norm(lig_coords - com[:, None], axis=-1),
                  0).max(1)
    m3 = lig_mask[..., None]
    return dict(
        lig_feat=rng.randn(B, Nc, feat_dim).astype(f32),
        lig_mask=lig_mask,
        lig_coords=(lig_coords * m3).astype(f32),
        lig_coords_init=(init * m3).astype(f32),
        lig_rdkit_coords=(rdkit * m3).astype(f32),
        bond_idx=bond_idx,
        bond_mask=bond_mask,
        las_adj=las,
        prot_feat=rng.randn(B, Nr, prot_feat_dim).astype(f32),
        prot_mask=prot_mask,
        prot_xyz=(prot_xyz * prot_mask[..., None]).astype(f32),
        pocket_idx=pocket_idx,
        pocket_mask=pocket_mask,
        pocket_label=label,
        coords_center=com,
        ligand_radius=lr.astype(f32),
        pocket_residue_center=pkt_center,
    )


def dummy_batch(shapes, batch_size: int = 2, seed: int = 0, device="cpu",
                **kw) -> FABindBatch:
    """`dummy_arrays` as a FABindBatch on `device`."""
    return FABindBatch.from_numpy(
        dummy_arrays(shapes, batch_size, seed, **kw), device)
