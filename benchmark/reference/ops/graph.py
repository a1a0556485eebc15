"""Complex layout and on-device graph construction.

Counterpart of fabind_tpu/ops/graph.py: a fixed top-K neighbour table
[B, N, K] for ctx (intra) message passing and a dense masked bipartite
[B, Nc, Np] adjacency for inter attention, both built from current
coordinates with static shapes.

Layout per sample:
    slot 0:            glb_c
    slots 1..Nc:       ligand atoms
    slot Nc+1:         glb_p
    slots Nc+2..N-1:   pocket residues

Gathers are plain index gathers; the JAX package's one-hot-matmul gather
works around slow TPU gathers and has no counterpart here.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

Tensor = torch.Tensor

BIG = 1e9


class ComplexLayout(NamedTuple):
    """Static slot arithmetic for the [glb_c|lig|glb_p|pkt] layout."""

    n_lig: int   # Nc
    n_pkt: int   # Np (or Nr for the whole-protein graph)

    @property
    def n_nodes(self) -> int:
        return self.n_lig + self.n_pkt + 2

    @property
    def glb_c(self) -> int:
        return 0

    @property
    def glb_p(self) -> int:
        return self.n_lig + 1

    @property
    def lig_slice(self):
        return slice(1, 1 + self.n_lig)

    @property
    def pkt_slice(self):
        return slice(self.n_lig + 2, self.n_nodes)

    # the pair embedding's sides include the global token as row 0
    @property
    def cside_slice(self):
        return slice(0, self.n_lig + 1)

    @property
    def pside_slice(self):
        return slice(self.n_lig + 1, self.n_nodes)

    def movable(self, device) -> Tensor:
        """glb_c + ligand + glb_p move; the pocket is frozen between
        recycles."""
        return torch.arange(self.n_nodes, device=device) < self.n_lig + 2

    def assemble(self, glb_c: Tensor, lig: Tensor, glb_p: Tensor,
                 pkt: Tensor) -> Tensor:
        """Node array [B, N, ...] from its four parts (global rows [B, ...],
        ligand [B, Nc, ...], pocket [B, Np, ...])."""
        return torch.cat([glb_c[:, None], lig, glb_p[:, None], pkt], dim=1)

    def with_lig(self, x: Tensor, lig: Tensor) -> Tensor:
        """x with its ligand rows replaced."""
        return torch.cat([x[:, :1], lig, x[:, self.glb_p:]], dim=1)


class CtxGraph(NamedTuple):
    """Ctx (intra) edges: nbr_idx/nbr_mask [B, N, K] per normal destination
    (global rows fully masked); glbc_src [Dc] / glbp_src [Dp] static source
    slots of the two global destinations with validity [B, Dc] / [B, Dp]."""

    nbr_idx: Tensor
    nbr_mask: Tensor
    glbc_src: Tensor
    glbc_src_mask: Tensor
    glbp_src: Tensor
    glbp_src_mask: Tensor


class InterGraph(NamedTuple):
    """adj [B, Nc, Np] bool: ligand atom i <-> pocket residue j within the
    inter cutoff, both valid. Both edge directions share it."""

    adj: Tensor


def _pairwise_sq_dist(a: Tensor, b: Tensor) -> Tensor:
    diff = a[:, :, None, :] - b[:, None, :, :]
    return (diff * diff).sum(-1)


def _radius_candidates(pkt_x: Tensor, pkt_mask: Tensor,
                       intra_cutoff: float):
    d2 = _pairwise_sq_dist(pkt_x, pkt_x)
    eye = torch.eye(pkt_x.shape[1], dtype=torch.bool, device=pkt_x.device)
    within = (pkt_mask[:, :, None] & pkt_mask[:, None, :] & ~eye
              & (d2 <= intra_cutoff * intra_cutoff))
    return d2, within


def build_ctx_graph(x: Tensor, layout: ComplexLayout, lig_mask: Tensor,
                    pkt_mask: Tensor, bond_idx: Tensor, bond_mask: Tensor,
                    intra_cutoff: float, k_radius: int) -> CtxGraph:
    """Ctx neighbour table from current (normalized) coords:
    - pocket destination i: the k_radius nearest pocket residues j != i
      within intra_cutoff, plus glb_p;
    - ligand destination i: its bonded neighbours, plus glb_c;
    - glb_c <- all ligand atoms + glb_p; glb_p <- all pocket residues + glb_c.

    bond_idx/bond_mask: [B, Nc, Kb] ligand-local bond neighbours.
    """
    B = x.shape[0]
    dev = x.device
    Nc, Np, N = layout.n_lig, layout.n_pkt, layout.n_nodes
    Kb = bond_idx.shape[-1]
    k_radius = min(k_radius, Np - 1)
    K = 1 + max(k_radius, Kb)

    d2, within = _radius_candidates(x[:, layout.pkt_slice], pkt_mask,
                                    intra_cutoff)
    score = torch.where(within, -d2, -BIG)
    top_score, top_j = torch.topk(score, k_radius, dim=-1)   # [B, Np, k]
    top_valid = top_score > -BIG / 2
    pkt_nbr = torch.where(top_valid, top_j + (Nc + 2), 0)

    def pad_k(t: Tensor) -> Tensor:
        return torch.nn.functional.pad(t, (0, K - t.shape[-1]))

    # ligand rows: slot 0 = glb_c, slots 1..Kb = bonds (ligand-local -> complex)
    lig_idx = pad_k(torch.cat(
        [torch.zeros_like(bond_idx[..., :1]), bond_idx + 1], dim=-1))
    lig_nbr_mask = pad_k(torch.cat(
        [lig_mask[:, :, None], bond_mask & lig_mask[:, :, None]], dim=-1))
    # pocket rows: slot 0 = glb_p, slots 1..k = radius neighbours
    pkt_idx = pad_k(torch.cat(
        [torch.full_like(pkt_nbr[..., :1], Nc + 1), pkt_nbr], dim=-1))
    pkt_nbr_mask = pad_k(torch.cat(
        [pkt_mask[:, :, None], top_valid & pkt_mask[:, :, None]], dim=-1))
    # global rows are fully masked
    glb_idx = torch.zeros((B, K), dtype=lig_idx.dtype, device=dev)
    glb_mask = torch.zeros((B, K), dtype=torch.bool, device=dev)
    nbr_idx = layout.assemble(glb_idx, lig_idx, glb_idx, pkt_idx)
    nbr_mask = layout.assemble(glb_mask, lig_nbr_mask, glb_mask, pkt_nbr_mask)

    ones = torch.ones((B, 1), dtype=torch.bool, device=dev)
    glbc_src = torch.arange(1, Nc + 2, device=dev)            # ligand + glb_p
    glbp_src = torch.cat([torch.arange(Nc + 2, N, device=dev),
                          torch.zeros(1, dtype=torch.long, device=dev)])
    return CtxGraph(nbr_idx, nbr_mask,
                    glbc_src, torch.cat([lig_mask, ones], dim=1),
                    glbp_src, torch.cat([pkt_mask, ones], dim=1))


def ctx_overflow_count(x: Tensor, layout: ComplexLayout, pkt_mask: Tensor,
                       intra_cutoff: float, k_radius: int) -> Tensor:
    """Per-sample count of radius neighbours dropped by the top-K ctx
    table."""
    _, within = _radius_candidates(x[:, layout.pkt_slice], pkt_mask,
                                   intra_cutoff)
    k_radius = min(k_radius, layout.n_pkt - 1)
    return (within.sum(-1) - k_radius).clamp(min=0).sum(-1)


def build_inter_graph(x: Tensor, layout: ComplexLayout, lig_mask: Tensor,
                      pkt_mask: Tensor, inter_cutoff: float) -> InterGraph:
    """Dense bipartite inter adjacency from current normalized coords."""
    d2 = _pairwise_sq_dist(x[:, layout.lig_slice], x[:, layout.pkt_slice])
    adj = ((d2 <= inter_cutoff * inter_cutoff)
           & lig_mask[:, :, None] & pkt_mask[:, None, :])
    return InterGraph(adj)


def gather_nodes(v: Tensor, idx: Tensor) -> Tensor:
    """v: [B, N, ...feat]; idx: [B, *I] -> [B, *I, ...feat]."""
    B = v.shape[0]
    rows = torch.arange(B, device=v.device).view((B,) + (1,) * (idx.dim() - 1))
    return v[rows, idx]


def compact_keep_mask(keep: Tensor, n_slots: int):
    """Pack kept items (in order) into n_slots.

    keep: [B, Nr] bool -> (idx [B, n_slots] source indices (0 where unused),
    mask [B, n_slots] bool, overflow [B] kept items dropped).
    """
    B, Nr = keep.shape
    pos = torch.cumsum(keep.long(), dim=1) - 1
    pos = torch.where(keep, pos, n_slots).clamp(max=n_slots)
    src = torch.arange(Nr, device=keep.device).expand(B, Nr)
    idx = torch.zeros((B, n_slots + 1), dtype=torch.long, device=keep.device)
    idx = idx.scatter(1, pos, src)[:, :n_slots]
    count = keep.sum(1)
    mask = (torch.arange(n_slots, device=keep.device)[None, :]
            < count.clamp(max=n_slots)[:, None])
    return idx, mask, (count - n_slots).clamp(min=0)
