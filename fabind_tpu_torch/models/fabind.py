"""FABind and FABind+ top-level models (two stages: pocket prediction, then
docking).

Counterpart of fabind_tpu/models/fabind.py: pocket prediction over the
whole protein, the pocket center, the radius crop packed into the Np pocket
slots, and docking through the complex model; the eval forward (stages 1
and 2), inference, and the training forward (`forward(batch, train=True)`,
inside `layers.dropout_rng`) with its gumbel-softmax center and stage gate.
The base model works in the protein-mean frame end to end; FABind+ crops at
its predicted radius, docks in the pocket's frame and adds the pocket center
back, so both return coordinates in the protein-mean frame. Module names are
the torch reference's, so released state dicts load with strict=True.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from fabind_tpu_torch.config import ModelConfig, ShapeConfig
from fabind_tpu_torch.data.types import FABindBatch
from fabind_tpu_torch.models.att_model import EfficientMCAttModel
from fabind_tpu_torch.models.egnn import GraphInputs
from fabind_tpu_torch.models.layers import (MLPBlock, TransitionDiffOutDim,
                                            active_dropout_rng,
                                            active_stochastic, assign_sites,
                                            stage_coin)
from fabind_tpu_torch.ops import graph as G
from fabind_tpu_torch.ops.geometry import las_projection_step, pairwise_dist
from fabind_tpu_torch.ops.gumbel import (pocket_center_from_cls,
                                         pocket_center_rounded)
from fabind_tpu_torch.utils import tracing

Tensor = torch.Tensor
# (compound_out [B,Nc,C], protein_out [B,Nr,C], cls_logits [B,Nr],
#  radius_pred [B]): the pocket stage's outputs
PocketOut = Tuple[Tensor, Tensor, Tensor, Tensor]


@dataclass
class FABindOutput:
    coords: Tensor             # [B, Nc, 3] predicted ligand coords
    lig_mask: Tensor           # [B, Nc]
    y_pred: Tensor             # [B, Np, Nc] distance-map head
    y_pred_by_coord: Tensor    # [B, Np, Nc] distances from predicted coords
    dis_map_target: Tensor     # [B, Np, Nc] regression target
    pair_valid: Tensor         # [B, Np, Nc]
    pocket_cls_logits: Tensor  # [B, Nr]
    pocket_cls_label: Tensor   # [B, Nr]
    prot_mask: Tensor          # [B, Nr]
    pred_pocket_center: Tensor  # [B, 3]
    use_stage2: bool           # the predicted pocket fed the docking model
    keep_less_5: Tensor        # [B] predicted crop had <5 residues
    pocket_overflow: Tensor    # [B] residues dropped by the Np bucket
    ctx_overflow: Tensor       # [B] radius edges dropped by the ctx table
    pkt_idx: Tensor            # [B, Np]
    pkt_mask: Tensor           # [B, Np]
    pocket_radius_pred: Tensor  # [B] FABind+ radius head (zeros for base)
    confidence: Tensor         # [B] FABind+ confidence head (zeros otherwise)
    pocket_coords: Tensor      # [B, Np, 3] docked pocket residues (protein-
    #                            mean frame): moved with the ligand under
    #                            cfg.flexible_docking, else the input crop


class FABind(nn.Module):

    def __init__(self, cfg: ModelConfig, shapes: ShapeConfig):
        super().__init__()
        # cfg.rel_dis_pair_bias is read by no module, as in the JAX package
        # (layers.Attention takes the bias; nothing passes one)
        self.cfg = cfg
        self.shapes = shapes
        C, Cp = cfg.hidden_size, cfg.pocket_pred_hidden_size
        self.glb_c = nn.Parameter(torch.ones(1, C))
        self.glb_p = nn.Parameter(torch.ones(1, C))
        self.protein_linear_whole_protein = nn.Linear(cfg.protein_feat_dim, C)
        self.compound_linear_whole_protein = nn.Linear(cfg.compound_feat_dim, C)
        self.embedding_shrink = nn.Linear(C, Cp)
        self.embedding_enlarge = nn.Linear(Cp, C)
        self.pocket_pred_model = EfficientMCAttModel(
            cfg, Cp, Cp, cfg.pocket_pred_layers, cfg.pocket_pred_n_iter,
            shapes.ctx_k_whole, stage="pocket")
        # only docking is flexible: the pocket stage's protein stays rigid
        self.complex_model = EfficientMCAttModel(
            cfg, C, C, cfg.mean_layers, cfg.n_iter, shapes.ctx_k,
            flexible=cfg.flexible_docking)
        if cfg.is_plus:
            s = cfg.mlp_hidden_scale

            def head(out_dim=1, n=s, use_ln=cfg.use_ln_mlp,
                     rate=cfg.dropout):
                return MLPBlock(C, n * C, out_dim, act="relu", use_ln=use_ln,
                                dropout_rate=rate, dropout_pos="inner")

            self.protein_to_pocket = head()
            self.pocket_radius_head = head()
            self.distmap_mlp = head()
            if cfg.confidence_training:
                n = cfg.confidence_mlp_hidden_scale
                if cfg.stack_mlp:
                    self.ranking_mlp_pre = head(C, n, cfg.confidence_use_ln_mlp,
                                                cfg.confidence_dropout)
                self.ranking_score_mlp = head(1, n, cfg.confidence_use_ln_mlp,
                                              cfg.confidence_dropout)
        else:
            self.protein_to_pocket = TransitionDiffOutDim(C, out_dim=1, n=4)
            self.layernorm = nn.LayerNorm(C, eps=1e-5)
            self.distmap_mlp = MLPBlock(C, C, 1, act="relu",
                                        sequential_names=True)
        assign_sites(self)

    # ------------------------------------------------------------------ utils
    @staticmethod
    def _masked_mean(v: Tensor, mask: Tensor) -> Tensor:
        m = mask[..., None].to(v.dtype)
        return (v * m).sum(1) / m.sum(1).clamp(min=1.0)

    def _complex_h(self, compound_emb: Tensor, pocket_emb: Tensor) -> Tensor:
        B = compound_emb.shape[0]
        return torch.cat([self.glb_c.expand(B, 1, -1), compound_emb,
                          self.glb_p.expand(B, 1, -1), pocket_emb], dim=1)

    @staticmethod
    def _complex_x(lig_x: Tensor, pkt_x: Tensor) -> Tensor:
        z = torch.zeros_like(lig_x[:, :1])
        return torch.cat([z, lig_x, z, pkt_x], dim=1)

    def _graph_inputs(self, batch: FABindBatch, pkt_mask: Tensor):
        return GraphInputs(
            lig_mask=batch.lig_mask, pkt_mask=pkt_mask,
            bond_idx=batch.bond_idx, bond_mask=batch.bond_mask,
            las_adj=batch.las_adj,
            las_ref=self.cfg.normalize(batch.lig_rdkit_coords))

    # ---------------------------------------------------------- pocket stage
    @tracing.spanned("model.pocket")
    def _pocket_pred(self, batch: FABindBatch, shapes: ShapeConfig,
                     count=None) -> PocketOut:
        """Whole-protein pocket prediction: (compound_out [B,Nc,C],
        protein_out [B,Nr,C], cls_logits [B,Nr], radius_pred [B]; zeros for
        base). `count` is the recycle count (EfficientMCAttModel.forward)."""
        cfg = self.cfg
        lig_emb = self.compound_linear_whole_protein(batch.lig_feat)
        prot_emb = self.protein_linear_whole_protein(batch.prot_feat)
        h = self.embedding_shrink(self._complex_h(lig_emb, prot_emb))

        # the ligand is centered at the protein origin for pocket prediction
        init_centered = batch.lig_coords_init - self._masked_mean(
            batch.lig_coords_init, batch.lig_mask)[:, None]
        init_centered = init_centered * batch.lig_mask[..., None]
        x = cfg.normalize(self._complex_x(init_centered, batch.prot_xyz))

        gi = self._graph_inputs(batch, batch.prot_mask)
        _, h_out, _ = self.pocket_pred_model(x, h, gi,
                                             ctx_k=shapes.ctx_k_whole,
                                             count=count)
        h_out = self.embedding_enlarge(h_out)
        layout = gi.layout
        compound_out = h_out[:, layout.lig_slice]
        protein_out = h_out[:, layout.pkt_slice]
        cls_logits = self.protein_to_pocket(protein_out)[..., 0]
        cls_logits = cls_logits * batch.prot_mask.to(h_out.dtype)

        radius_pred = torch.zeros(batch.batch_size, dtype=h_out.dtype,
                                  device=h_out.device)
        if cfg.is_plus:
            # the radius head over pooled embeddings
            if cfg.use_for_radius_pred == "ligand":
                pooled = (compound_out * batch.lig_mask[..., None]).sum(1)
            elif cfg.use_for_radius_pred == "both":
                pooled = (h_out * gi.node_mask()[..., None]).sum(1)
            else:   # global
                pooled = h_out[:, layout.glb_c]
            radius_pred = F.relu(self.pocket_radius_head(pooled))[..., 0]
        return compound_out, protein_out, cls_logits, radius_pred

    # ------------------------------------------------------------------ crop
    def _crop_radius(self, radius_pred: Tensor) -> Optional[Tensor]:
        """FABind+'s per-sample crop radius [B]: the predicted radius scaled
        (buffer <= 2) or padded by pocket_radius_buffer, at least
        min_pocket_radius. None for base and force_fix_radius: the fixed
        cfg.pocket_radius."""
        cfg = self.cfg
        if not cfg.is_plus or cfg.force_fix_radius:
            return None
        if cfg.pocket_radius_buffer <= 2.0:
            r = radius_pred * cfg.pocket_radius_buffer
        else:
            r = radius_pred + cfg.pocket_radius_buffer
        return r.clamp(min=cfg.min_pocket_radius)

    def _predicted_crop(self, center: Tensor, batch: FABindBatch,
                        shapes: ShapeConfig, radius: Optional[Tensor] = None):
        """Residues within `radius` [B] (None: cfg.pocket_radius) of the
        predicted center (plus the first 100 residues when fewer than 5 are
        kept), packed into the Np pocket slots: (idx, mask, less5,
        overflow)."""
        d = torch.linalg.norm(batch.prot_xyz - center[:, None, :], dim=-1)
        r = self.cfg.pocket_radius if radius is None else radius[:, None]
        keep = (d < r) & batch.prot_mask
        Nr = batch.prot_mask.shape[1]
        first100 = torch.arange(Nr, device=keep.device)[None, :] < 100
        fallback = (first100 | keep) & batch.prot_mask
        less5 = keep.sum(1) < 5
        keep = torch.where(less5[:, None], fallback, keep)
        idx, mask, overflow = G.compact_keep_mask(keep, shapes.max_pocket)
        return idx, mask, less5, overflow

    # --------------------------------------------------------------- forward
    def forward(self, batch: FABindBatch, stage: int = 2,
                train: Optional[bool] = None,
                shapes: Optional[ShapeConfig] = None,
                gumbel_u: Optional[Tensor] = None) -> FABindOutput:
        """The forward the losses read, in the shape bucket `shapes`
        (default self.shapes).

        Eval (train False; default when not self.training): stage 1 docks
        into the precomputed pocket crop, stage 2 into the predicted one.

        Training (train True; default in .train() mode) runs inside
        `layers.dropout_rng(generator)`, which gives the dropout masks, the
        recycle counts and the gumbel-softmax uniforms (or pass them as
        `gumbel_u` [B, Nr, 2]; a part of a data-parallel batch takes its
        rows of the global batch's draws and of `gumbel_u`, layers.RowMap).
        FABind+ always docks into the precomputed crop (teacher forcing).
        Base docks into the predicted crop when a coin drawn on the host
        from the block's seed (layers.stage_coin) is below cfg.stage_prob
        and the mean center error over all rows of the global batch is
        below cfg.center_dist_threshold, as the JAX package's gate; the
        gate is decided on the host, so the step
        reads the center error back (one device sync, only when the coin
        falls below stage_prob) and docks once instead of selecting
        between two candidates."""
        cfg = self.cfg
        shapes = shapes or self.shapes
        train = self.training if train is None else train
        if train and active_dropout_rng() is None:
            raise RuntimeError(
                "the training forward draws its dropout masks and gumbel "
                "noise from layers.dropout_rng(generator); run it inside one")
        compound_out, protein_out, cls_logits, radius_pred = \
            self._pocket_pred(batch, shapes)
        B = batch.batch_size
        state = active_stochastic()
        u = None
        if train:
            # a part of a data-parallel batch draws the global batch's
            # uniforms at its rows (layers.RowMap); `gumbel_u` is given at
            # the global batch's shape too
            u = (state.rows.take(gumbel_u, B) if gumbel_u is not None
                 else state.rand((B, cls_logits.shape[1], 2),
                                 cls_logits.device, cls_logits.dtype).clamp(
                     min=torch.finfo(cls_logits.dtype).tiny))
        pred_center = pocket_center_from_cls(
            cls_logits, batch.prot_xyz, batch.prot_mask, cfg.gs_tau,
            cfg.gs_hard, u=u)

        if train and not cfg.is_plus:
            use_stage2 = False
            if stage_coin(state.seed) < cfg.stage_prob:
                err = state.rows.mean(torch.linalg.norm(
                    (batch.coords_center - pred_center).detach(), dim=-1))
                with tracing.span("train.gate_sync"):
                    use_stage2 = float(err) < cfg.center_dist_threshold
        else:
            use_stage2 = not train and stage == 2

        if use_stage2:
            center = pred_center
            if train and cfg.train_pred_pocket_noise > 0:
                center = center + cfg.train_pred_pocket_noise * (
                    2 * state.rand(center.shape, center.device,
                                   center.dtype) - 1)
            pkt_idx, pkt_mask, keep_less_5, overflow = self._predicted_crop(
                center.detach(), batch, shapes, self._crop_radius(radius_pred))
        else:
            pkt_idx, pkt_mask = batch.pocket_idx, batch.pocket_mask
            keep_less_5 = torch.zeros(B, dtype=torch.bool,
                                      device=pkt_idx.device)
            overflow = torch.zeros(B, dtype=torch.long, device=pkt_idx.device)
        out = self._dock(batch, compound_out, protein_out, pkt_idx, pkt_mask,
                         use_stage2, shapes.ctx_k)
        (coords, y_pred, y_by_coord, dis_map, pair_valid, confidence,
         ctx_overflow, pocket_coords) = out
        return FABindOutput(
            coords=coords, lig_mask=batch.lig_mask, y_pred=y_pred,
            y_pred_by_coord=y_by_coord, dis_map_target=dis_map,
            pair_valid=pair_valid, pocket_cls_logits=cls_logits,
            pocket_cls_label=batch.pocket_label.to(cls_logits.dtype),
            prot_mask=batch.prot_mask, pred_pocket_center=pred_center,
            use_stage2=use_stage2, keep_less_5=keep_less_5,
            pocket_overflow=overflow, ctx_overflow=ctx_overflow,
            pkt_idx=pkt_idx, pkt_mask=pkt_mask,
            pocket_radius_pred=radius_pred, confidence=confidence,
            pocket_coords=pocket_coords)

    # --------------------------------------------------------------- docking
    @tracing.spanned("model.dock")
    def _dock(self, batch: FABindBatch, compound_out: Tensor,
              protein_out: Tensor, pkt_idx: Tensor, pkt_mask: Tensor,
              use_stage2: bool, ctx_k: int, count=None, rounds=None):
        """Build the docking complex from a pocket selection and run the
        complex model (with recycle count `count`, or its rounds run by
        `rounds`: EfficientMCAttModel.forward) and the heads: (coords,
        y_pred, y_pred_by_coord, dis_map_target, pair_valid, confidence,
        ctx_overflow, pocket_coords)."""
        cfg = self.cfg
        pocket_emb = G.gather_nodes(protein_out, pkt_idx)        # [B, Np, C]
        pkt_xyz = G.gather_nodes(batch.prot_xyz, pkt_idx) * pkt_mask[..., None]

        # ligand init: stage 1 = host-built init; stage 2 = init re-centered
        # on the predicted pocket's mean
        if cfg.is_plus:
            # FABind+ docks in the pocket's frame: `bias` (the predicted
            # pocket's mean, or the precomputed pocket's center for stage 1)
            # is subtracted here and added back to the output
            init_centered = batch.lig_coords_init - self._masked_mean(
                batch.lig_coords_init, batch.lig_mask)[:, None]
            bias = (self._masked_mean(pkt_xyz, pkt_mask) if use_stage2
                    else batch.pocket_residue_center)
            pkt_xyz = (pkt_xyz - bias[:, None]) * pkt_mask[..., None]
            if use_stage2:
                init_centered = init_centered + self._masked_mean(
                    pkt_xyz, pkt_mask)[:, None]
            lig_init = init_centered * batch.lig_mask[..., None]
        elif use_stage2:
            pkt_center = self._masked_mean(pkt_xyz, pkt_mask)
            init_centered = batch.lig_coords_init - self._masked_mean(
                batch.lig_coords_init, batch.lig_mask)[:, None]
            lig_init = ((init_centered + pkt_center[:, None])
                        * batch.lig_mask[..., None])
        else:
            lig_init = batch.lig_coords_init

        h = self._complex_h(compound_out, pocket_emb)
        x = cfg.normalize(self._complex_x(lig_init, pkt_xyz))
        gi = self._graph_inputs(batch, pkt_mask)
        ctx_overflow = G.ctx_overflow_count(
            x, gi.layout, pkt_mask, cfg.normalize(cfg.intra_cutoff), ctx_k)
        x_out, h_out, pair_out = self.complex_model(x, h, gi, ctx_k=ctx_k,
                                                    count=count, rounds=rounds)

        layout = gi.layout
        if cfg.is_plus and cfg.only_last_LAS:
            x_out = layout.with_lig(x_out, las_projection_step(
                x_out[:, layout.lig_slice], gi.las_ref, gi.las_adj,
                cfg.geometry_reg_step_size, cfg.normalize(2.0),
                steps=cfg.geom_reg_steps))
        coords_n = x_out[:, layout.lig_slice]
        pair_valid = pkt_mask[:, :, None] & batch.lig_mask[:, None, :]

        # distance-map head: FABind+ reads the pair embedding, base the
        # product of the layer-normed node embeddings
        if cfg.is_plus:
            z = pair_out[:, 1:, 1:]
        else:
            p_ln = self.layernorm(h_out[:, layout.pkt_slice])
            c_ln = self.layernorm(h_out[:, layout.lig_slice])
            z = torch.einsum("bik,bjk->bijk", p_ln, c_ln)
        y_pred = torch.sigmoid(self.distmap_mlp(z)[..., 0]) * cfg.dis_map_thres

        d_n = pairwise_dist(x_out[:, layout.pkt_slice], coords_n)
        y_by_coord = cfg.unnormalize(d_n).clamp(0.0, cfg.dis_map_thres)
        # regression target: stage 1 vs the gt coords; stage 2 vs the init
        # coords, as the reference computes it (FABind+: in the pocket frame)
        lig_ref = batch.lig_coords_init if use_stage2 else batch.lig_coords
        if cfg.is_plus:
            lig_ref = lig_ref - bias[:, None]
        dis_map = pairwise_dist(pkt_xyz, lig_ref).clamp(max=cfg.dis_map_thres)
        dis_map = dis_map * pair_valid

        coords = cfg.unnormalize(coords_n)
        # the docked pocket residues, as the docking model returns them
        # (the input crop unless cfg.flexible_docking moved them)
        pocket_coords = cfg.unnormalize(x_out[:, layout.pkt_slice])
        if cfg.is_plus:
            coords = coords + bias[:, None]
            pocket_coords = pocket_coords + bias[:, None]
        coords = coords * batch.lig_mask[..., None]
        pocket_coords = pocket_coords * pkt_mask[..., None]

        confidence = torch.zeros(batch.batch_size, dtype=h_out.dtype,
                                 device=h_out.device)
        if cfg.is_plus and cfg.confidence_training:
            pooled = (h_out * gi.node_mask()[..., None]).sum(1)
            if cfg.stack_mlp:
                pooled = F.relu(self.ranking_mlp_pre(pooled))
            confidence = self.ranking_score_mlp(pooled)[..., 0]
        return (coords, y_pred, y_by_coord, dis_map, pair_valid, confidence,
                ctx_overflow, pocket_coords)

    # ------------------------------------------------------------- inference
    def inference_diag(self, batch: FABindBatch,
                       center_override: Optional[Tensor] = None,
                       shapes: Optional[ShapeConfig] = None,
                       pocket: Optional[PocketOut] = None,
                       pocket_count=None, count=None, dock=None):
        """Predicted-pocket inference in the shape bucket `shapes` (default
        self.shapes: one module, with one copy of the weights, serves every
        bucket): the pocket stage, or `pocket`, the outputs of one run
        before (a sampling pass docks from its own stochastic pocket stage
        without running it twice); the rounded-sigmoid pocket center
        (no-random gumbel fallback) unless `center_override` is given; the
        predicted crop; docking. `pocket_count` and `count` are the
        recycle counts of the pocket stage and of docking (default: drawn,
        EfficientMCAttModel.draw_count). `dock`, with `_dock`'s arguments
        and outputs, stands in for it (the serving engine's graph replay,
        graphs.py). Returns (coords [B,Nc,3], confidence [B] (zeros
        without a confidence head), pocket_overflow [B])."""
        coords, _, _, _, confidence, overflow = self.inference_flexible_diag(
            batch, center_override, shapes, pocket, pocket_count, count,
            dock)
        return coords, confidence, overflow

    def inference(self, batch: FABindBatch,
                  center_override: Optional[Tensor] = None):
        """Predicted-pocket inference: (coords [B,Nc,3], confidence [B])."""
        coords, confidence, _ = self.inference_diag(batch, center_override)
        return coords, confidence

    def inference_flexible(self, batch: FABindBatch,
                           center_override: Optional[Tensor] = None,
                           shapes: Optional[ShapeConfig] = None):
        """`inference` that also returns the docked pocket conformation,
        the FABFlex-style flexible-docking output: with
        cfg.flexible_docking the pocket residues move with the ligand
        across recycles, rigid configs return the input crop. Returns
        (lig_coords [B,Nc,3], pocket_coords [B,Np,3], pkt_idx [B,Np],
        pkt_mask [B,Np], confidence [B])."""
        return self.inference_flexible_diag(batch, center_override,
                                            shapes)[:5]

    def inference_flexible_diag(self, batch: FABindBatch,
                                center_override: Optional[Tensor] = None,
                                shapes: Optional[ShapeConfig] = None,
                                pocket: Optional[PocketOut] = None,
                                pocket_count=None, count=None, dock=None):
        """`inference_flexible` + pocket_overflow [B], with inference_diag's
        arguments: (lig_coords, pocket_coords, pkt_idx, pkt_mask,
        confidence, pocket_overflow)."""
        cfg = self.cfg
        shapes = shapes or self.shapes
        if pocket is None:
            pocket = self._pocket_pred(batch, shapes, pocket_count)
        compound_out, protein_out, cls_logits, radius_pred = pocket
        center = center_override
        if center is None:
            with tracing.span("model.center"):
                center = pocket_center_rounded(cls_logits, batch.prot_xyz,
                                               batch.prot_mask, cfg.gs_tau,
                                               cfg.gs_hard)
        with tracing.span("model.crop"):
            idx, mask, _, overflow = self._predicted_crop(
                center, batch, shapes, self._crop_radius(radius_pred))
        out = (dock or self._dock)(batch, compound_out, protein_out, idx,
                                   mask, True, shapes.ctx_k, count)
        return out[0], out[7], idx, mask, out[5], overflow


def init_params(model: nn.Module, generator: torch.Generator) -> None:
    """Seeded random weights: every Linear weight and bias uniform in
    ±1/sqrt(fan_in) (PyTorch's default scale), LayerNorms at identity, the
    global tokens at one, and the coordinate heads' output layers scaled by
    1e-3 as the reference initializes them. Draws on the CPU generator, so
    the weights are the same on any device."""
    with torch.no_grad():
        for name, mod in model.named_modules():
            if isinstance(mod, nn.Linear):
                a = mod.in_features ** -0.5
                w = torch.empty(mod.weight.shape).uniform_(-a, a,
                                                           generator=generator)
                if name.split(".")[-2:-1] == ["coord_mlp"] and mod.out_features == 1:
                    w *= 1e-3
                mod.weight.copy_(w)
                if mod.bias is not None:
                    mod.bias.copy_(torch.empty(mod.bias.shape).uniform_(
                        -a, a, generator=generator))
            elif isinstance(mod, nn.LayerNorm):
                mod.weight.fill_(1.0)
                mod.bias.fill_(0.0)
        model.glb_c.fill_(1.0)
        model.glb_p.fill_(1.0)


def make_model(cfg) -> FABind:
    """cfg: FABindConfig."""
    return FABind(cfg.model, cfg.shapes)
