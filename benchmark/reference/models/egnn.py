"""E(3)-equivariant message passing on the dense complex layout.

Counterpart of fabind_tpu/models/egnn.py:
- `EGCL`: messages over the per-destination top-K ctx table, with the edge
  MLP's first linear decomposed into per-node projections plus a rank-1
  radial term; the two global tokens are aggregated in a dense side branch.
- `InterAttention`: dense masked bipartite attention between ligand and
  pocket; its coordinate gate runs through the edge-gate kernel.
- `BipartiteEGCL` and `MCnoAttEGNN`: the no-attention ablation stacks,
  whose inter layers are EGCLs over the ligand-pocket edges.
- `MCAttEGNN`: the layer stack with the in-loop LAS projection. With
  cfg.remat each EGCL and InterAttention is recomputed in the backward
  (torch.utils.checkpoint), as the JAX package's `nn.remat` layers are; its
  dropout masks are keyed, not drawn from generator state, so the
  recomputation draws the forward's.

A module called more than once per recycle round (the edge and coord MLPs
of each EGCL edge group, the coord MLP of each attention direction) passes
the call's index to its dropout draws.

All coordinates here are normalized (divided by coordinate_scale).
"""
from __future__ import annotations

import copy
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from benchmark.reference.config import ModelConfig
from benchmark.reference.models.cross_att import CrossAttentionModule
from benchmark.reference.models.layers import (Dropout, InteractionModule,
                                            MLPBlock, active_stochastic,
                                            enter_stochastic)
from benchmark.reference.ops import graph as G
from benchmark.reference.ops.geometry import las_projection_step, safe_sqrt

Tensor = torch.Tensor
BIG = 1e9


class GraphInputs(NamedTuple):
    """Per-forward graph data for one complex batch."""

    lig_mask: Tensor     # [B, Nc] bool
    pkt_mask: Tensor     # [B, Np] bool
    bond_idx: Tensor     # [B, Nc, Kb] ligand-local bond neighbours
    bond_mask: Tensor    # [B, Nc, Kb] bool
    las_adj: Tensor      # [B, Nc, Nc] bool
    las_ref: Tensor      # [B, Nc, 3] normalized LAS reference coords

    @property
    def layout(self) -> G.ComplexLayout:
        return G.ComplexLayout(self.lig_mask.shape[1], self.pkt_mask.shape[1])

    def side_masks(self):
        """(protein-side, compound-side) masks, global token first."""
        ones = torch.ones_like(self.lig_mask[:, :1])
        return (torch.cat([ones, self.pkt_mask], dim=1),
                torch.cat([ones, self.lig_mask], dim=1))

    def node_mask(self) -> Tensor:
        """Per-sample validity [B, N] of the complex's nodes."""
        ones = torch.ones_like(self.lig_mask[:, :1])
        return torch.cat([ones, self.lig_mask, ones, self.pkt_mask], dim=1)


def _masked_softmax(logits: Tensor, mask: Tensor, dim: int) -> Tensor:
    out = torch.softmax(torch.where(mask, logits, -BIG), dim=dim)
    return out * mask.to(out.dtype)


def _norm_div(r_sq_sum: Tensor, cfg: ModelConfig) -> Tensor:
    """Per-sample radial normalizer, guarded against empty edge sets."""
    if cfg.rm_F_norm or cfg.norm_type == "none":
        return torch.ones_like(r_sq_sum)
    if cfg.norm_type == "per_sample":
        n = safe_sqrt(r_sq_sum)
    elif cfg.norm_type == "all_sample":
        n = safe_sqrt(r_sq_sum.sum()) * torch.ones_like(r_sq_sum)
    else:
        raise ValueError(cfg.norm_type)
    return torch.where(n == 0, 1.0, n)


def _egcl_mlps(cfg: ModelConfig, hidden: int, edge_in: int):
    """The edge/node/coord MLP trio (torch reference names)."""
    if cfg.is_plus:
        s = cfg.mlp_hidden_scale
        kw = dict(act="relu", use_ln=cfg.use_ln_mlp,
                  dropout_rate=cfg.dropout)
        return (MLPBlock(edge_in, s * edge_in, hidden, last_act=True,
                         dropout_pos="both", **kw),
                MLPBlock(2 * hidden, s * 2 * hidden, hidden, last_act=True,
                         dropout_pos="both", **kw),
                MLPBlock(hidden, s * hidden, 1, bias_out=False,
                         dropout_pos="inner", **kw))
    return (MLPBlock(edge_in, hidden, hidden, act="silu", last_act=True,
                     sequential_names=True),
            MLPBlock(2 * hidden, hidden, hidden, act="silu",
                     sequential_names=True),
            MLPBlock(hidden, hidden, 1, act="silu", bias_out=False,
                     sequential_names=True))


class EGCL(nn.Module):
    """Multi-channel E(n) conv layer on the ctx graph (decomposed edge MLP;
    n_channel = 1, so radial is the squared distance). The FABind+ edge MLP
    with a LayerNorm over its input is decomposed halfway
    (MLPBlock.ln_l1_parts): the dst block and the LayerNorm fold into
    per-node pieces, the src block stays a per-edge product."""

    def __init__(self, cfg: ModelConfig, hidden: int, coord_max: float):
        super().__init__()
        self.cfg = cfg
        self.coord_max = coord_max
        self.edge_mlp, self.node_mlp, self.coord_mlp = _egcl_mlps(
            cfg, hidden, 2 * hidden + 1)
        self.dropout = Dropout(cfg.dropout)

    def forward(self, h: Tensor, x: Tensor, ctx: G.CtxGraph,
                gi: GraphInputs):
        cfg = self.cfg
        layout = gi.layout
        C = h.shape[-1]
        ln_edges = cfg.is_plus and cfg.use_ln_mlp

        if ln_edges:
            parts = self.edge_mlp.ln_l1_parts(h)
            # coords packed with the features: one gather per edge group
            packed = torch.cat([x, h], dim=-1)                # [B, N, 3+C]
        else:
            # edge_mlp's first linear over [h_dst ++ h_src ++ radial] split
            # into per-node projections + the radial column
            w1 = self.edge_mlp.lin1.weight                    # [H, 2C+1]
            a = F.linear(h, w1[:, :C], self.edge_mlp.lin1.bias)
            s_proj = F.linear(h, w1[:, C:2 * C])              # src part
            w_r = w1[:, 2 * C]
            # coords packed with the source projection
            packed = torch.cat([x, s_proj], dim=-1)           # [B, N, 3+H]

        g_n = G.gather_nodes(packed, ctx.nbr_idx)            # [B, N, K, 3+*]
        diff_n = x[:, :, None, :] - g_n[..., :3]
        r_n = (diff_n * diff_n).sum(-1)
        m_n = ctx.nbr_mask

        g_c = packed[:, ctx.glbc_src]                        # [B, Dc, 3+H]
        diff_c = x[:, layout.glb_c][:, None, :] - g_c[..., :3]
        r_c = (diff_c * diff_c).sum(-1)
        m_c = ctx.glbc_src_mask

        g_p = packed[:, ctx.glbp_src]
        diff_p = x[:, layout.glb_p][:, None, :] - g_p[..., :3]
        r_p = (diff_p * diff_p).sum(-1)
        m_p = ctx.glbp_src_mask

        # per-sample radial F-norm over the full ctx edge set
        r_sq = (torch.where(m_n, r_n * r_n, 0.0).sum((1, 2))
                + torch.where(m_c, r_c * r_c, 0.0).sum(1)
                + torch.where(m_p, r_p * r_p, 0.0).sum(1))
        div = _norm_div(r_sq, cfg)

        def messages(src, radial, div_b, dst, call):
            """Edge messages from the gathered source rows and the
            destination node(s) `dst` (an index or a broadcast slice);
            `call` is the edge group's index in the dropout keys."""
            if ln_edges:
                return self.edge_mlp.finish(self.edge_mlp.ln_l1_edges(
                    parts, parts.a[dst][..., None, :], parts.t[dst][..., None],
                    parts.q[dst][..., None], src, radial / div_b), call)
            m = self.edge_mlp.finish(
                a[dst][..., None, :] + src + (radial / div_b)[..., None] * w_r,
                call)
            return m if cfg.is_plus else self.dropout(m, call)

        msg_n = messages(g_n[..., 3:], r_n, div[:, None, None],
                         (slice(None), slice(None)), 0)
        msg_c = messages(g_c[..., 3:], r_c, div[:, None],
                         (slice(None), layout.glb_c), 1)
        msg_p = messages(g_p[..., 3:], r_p, div[:, None],
                         (slice(None), layout.glb_p), 2)

        # coord update: segment mean of diff * coord_mlp(m)
        def coord_agg(msg, diff, mask, call):
            w = self.coord_mlp.scalar_call(msg, call)[..., None]
            t = diff * w * mask[..., None].to(diff.dtype)
            cnt = mask.sum(-1, keepdim=True).clamp(min=1)
            return t.sum(-2) / cnt.to(diff.dtype)

        def node_sum(msg, mask):
            return (msg * mask[..., None].to(msg.dtype)).sum(-2)

        agg_n = coord_agg(msg_n, diff_n, m_n, 0)
        agg_x = layout.assemble(coord_agg(msg_c, diff_c, m_c, 1),
                                agg_n[:, layout.lig_slice],
                                coord_agg(msg_p, diff_p, m_p, 2),
                                agg_n[:, layout.pkt_slice])
        x_out = x + agg_x.clamp(-self.coord_max, self.coord_max)

        agg_hn = node_sum(msg_n, m_n)
        agg_h = layout.assemble(node_sum(msg_c, m_c),
                                agg_hn[:, layout.lig_slice],
                                node_sum(msg_p, m_p),
                                agg_hn[:, layout.pkt_slice])
        out = self.node_mlp(torch.cat([h, agg_h], dim=-1))
        if not cfg.is_plus:
            out = self.dropout(out, 3)
        return h + out, x_out


def add_trio_encoder(mod: nn.Module, cfg: ModelConfig, hidden: int) -> None:
    """Give `mod` the trio encoder's modules (reference names):
    cross_attn_module with cfg.add_cross_attn_layer, else inter_layer (an
    InteractionModule, outer-product with cfg.opm), and attn_bias_proj."""
    if cfg.add_cross_attn_layer:
        mod.cross_attn_module = CrossAttentionModule(
            hidden, rm_layernorm=cfg.rm_layernorm, dropout_rate=cfg.dropout,
            is_plus=cfg.is_plus, mlp_hidden_scale=cfg.mlp_hidden_scale,
            use_ln_mlp=cfg.use_ln_mlp, mha_heads=cfg.mha_heads,
            keep_trig_attn=cfg.keep_trig_attn)
    else:
        mod.inter_layer = InteractionModule(hidden, hidden, hidden, hidden,
                                            rm_layernorm=cfg.rm_layernorm,
                                            opm=cfg.opm)
    mod.attn_bias_proj = nn.Linear(hidden, 1)


def trio_encoder(mod: nn.Module, h: Tensor, gi: GraphInputs,
                 pair_embed: Optional[Tensor], pair_mask: Optional[Tensor],
                 p_p_dist_embed: Optional[Tensor],
                 c_c_dist_embed: Optional[Tensor], call: int = 0):
    """The pair update before an inter layer, with the modules
    add_trio_encoder gave `mod`: the cross attention updates both sides and
    the pair; the InteractionModule's pair is added to the entry pair
    under cfg.explicit_pair_embed, else it is the pair. `call` indexes the cross attention's dropout draws in
    the round. Returns (h, pair_embed)."""
    cfg = mod.cfg
    layout = gi.layout
    p_mask_side, c_mask_side = gi.side_masks()
    p_side = h[:, layout.pside_slice]
    c_side = h[:, layout.cside_slice]
    if cfg.add_cross_attn_layer:
        p_side, c_side, pair_embed = mod.cross_attn_module(
            p_side, p_mask_side, c_side, c_mask_side, pair_embed, pair_mask,
            p_p_dist_embed, c_c_dist_embed, call)
        return torch.cat([c_side, p_side], dim=1), pair_embed
    upd, _ = mod.inter_layer(p_side, c_side, p_mask_side, c_mask_side)
    return h, (pair_embed + upd if cfg.explicit_pair_embed else upd)


class InterAttention(nn.Module):
    """Interfacial attention on the bipartite ligand-pocket graph. With
    cfg.add_attn_pair_bias a trio encoder first updates the pair embedding
    (the cross attention, or without cfg.add_cross_attn_layer an
    InteractionModule over the sides, added to the entry pair under
    cfg.explicit_pair_embed), whose projection biases both directions'
    logits; without it there is no bias and the pair passes through."""

    def __init__(self, cfg: ModelConfig, hidden: int, coord_max: float):
        super().__init__()
        self.cfg = cfg
        self.hidden = hidden
        self.coord_max = coord_max
        if cfg.add_attn_pair_bias:
            add_trio_encoder(self, cfg, hidden)
        self.linear_q = nn.Linear(hidden, hidden)
        # torch Linear(1+C -> 2C) on cat([radial, h]), split at runtime in
        # interleaved order (k = kv[..., 0::2], v = kv[..., 1::2])
        self.linear_kv = nn.Linear(1 + hidden, 2 * hidden)
        if cfg.is_plus:
            s = cfg.mlp_hidden_scale
            self.coord_mlp = MLPBlock(
                hidden, s * hidden, 1, act="relu", use_ln=cfg.use_ln_mlp,
                bias_out=False, dropout_rate=cfg.dropout, dropout_pos="inner")
            if cfg.inter_additional_mlp:
                self.node_mlp = MLPBlock(
                    hidden, s * hidden, hidden, act="relu",
                    use_ln=cfg.use_ln_mlp, last_act=True,
                    dropout_rate=cfg.dropout, dropout_pos="both")
        else:
            self.coord_mlp = MLPBlock(hidden, hidden, 1, act="silu",
                                      bias_out=False, sequential_names=True)
        self.dropout = Dropout(cfg.dropout)

    def forward(self, h: Tensor, x: Tensor, adj: Tensor, gi: GraphInputs,
                pair_embed: Optional[Tensor], pair_mask: Optional[Tensor],
                p_p_dist_embed: Optional[Tensor] = None,
                c_c_dist_embed: Optional[Tensor] = None):
        cfg = self.cfg
        layout = gi.layout

        pair_bias_pc = None
        if cfg.add_attn_pair_bias:
            h, pair_embed = trio_encoder(
                self, h, gi, pair_embed, pair_mask, p_p_dist_embed,
                c_c_dist_embed)
            # one pair-bias cell (p, c) serves both edge directions
            pair_bias_pc = self.attn_bias_proj(pair_embed)[..., 0][:, 1:, 1:]

        # radial over inter edges
        x_l = x[:, layout.lig_slice]
        x_p = x[:, layout.pkt_slice]
        diff_lp = x_l[:, :, None, :] - x_p[:, None, :, :]    # [B, Nc, Np, 3]
        r_raw = (diff_lp * diff_lp).sum(-1)
        r_sq_sum = 2.0 * torch.where(adj, r_raw * r_raw, 0.0).sum((1, 2))
        r = r_raw / _norm_div(r_sq_sum, cfg)[:, None, None]

        q = self.linear_q(h)
        kv_w = self.linear_kv.weight                          # [2C, 1+C]
        kv_node = F.linear(h, kv_w[:, 1:], self.linear_kv.bias)
        kv_node = kv_node.unflatten(-1, (self.hidden, 2))
        k_node, v_node = kv_node[..., 0], kv_node[..., 1]
        w_r = kv_w[:, 0].unflatten(0, (self.hidden, 2))
        k_r, v_r = w_r[:, 0], w_r[:, 1]

        # coord_mlp.linear1 over v_edge = v_node + r * v_r: a per-node
        # projection plus a rank-1 radial correction (exact without a
        # LayerNorm on the input)
        lig, pkt = layout.lig_slice, layout.pkt_slice
        decompose = not (cfg.is_plus and cfg.use_ln_mlp)
        phi_l = phi_p = None
        if decompose:
            # both directions' gates from one r [B, Nc, Np], in one launch
            u_r = F.linear(v_r, self.coord_mlp.lin1.weight)
            phi_l, phi_p = self.coord_mlp.finish_scalar_rank1_pair(
                self.coord_mlp.lin1(v_node[:, lig]),
                self.coord_mlp.lin1(v_node[:, pkt]), r, u_r)

        def direction(q_d, k_node_s, v_node_s, r_ds, adj_ds, bias_ds,
                      x_d, x_s, phi, call):
            """Destinations d attend over sources s. The coord update
            sum_s t (x_d - x_s) is (sum_s t) x_d - t @ x_s; `call` is the
            direction's index in the coord MLP's dropout keys."""
            logits = torch.einsum("bdc,bsc->bds", q_d, k_node_s)
            logits = logits + r_ds * (q_d @ k_r)[..., None]
            if bias_ds is not None:
                logits = logits + bias_ds
            A = _masked_softmax(logits, adj_ds, dim=-1)
            agg = torch.einsum("bds,bsc->bdc", A, v_node_s)
            agg = agg + (A * r_ds).sum(-1)[..., None] * v_r
            if phi is None:
                phi = self.coord_mlp.scalar_call(
                    v_node_s[:, None, :, :] + r_ds[..., None] * v_r, call)
            t = A * phi
            dx = t.sum(-1)[..., None] * x_d - torch.einsum("bds,bsx->bdx",
                                                           t, x_s)
            return agg, dx

        agg_l, dx_l = direction(q[:, lig], k_node[:, pkt], v_node[:, pkt],
                                r, adj, None if pair_bias_pc is None
                                else pair_bias_pc.transpose(1, 2),
                                x_l, x_p, phi_l, 0)
        agg_p, dx_p = direction(q[:, pkt], k_node[:, lig], v_node[:, lig],
                                r.transpose(1, 2), adj.transpose(1, 2),
                                pair_bias_pc, x_p, x_l, phi_p, 1)

        z_h = torch.zeros_like(h[:, 0])
        agg = layout.assemble(z_h, agg_l, z_h, agg_p)
        h = h + self.dropout(agg)
        if cfg.is_plus and cfg.inter_additional_mlp:
            h = h + self.node_mlp(h)

        z_x = torch.zeros_like(x[:, 0])
        dx = layout.assemble(z_x, dx_l, z_x, dx_p)
        x = x + dx.clamp(-self.coord_max, self.coord_max)
        return h, x, pair_embed


class MCAttEGNN(nn.Module):
    """n_layers x (EGCL -> InterAttention -> LAS projection) + an output
    EGCL, with linear in/out."""

    def __init__(self, cfg: ModelConfig, in_dim: int, hidden: int,
                 out_dim: int, n_layers: int):
        super().__init__()
        self.cfg = cfg
        self.n_layers = n_layers
        coord_max = cfg.normalize(10.0)
        self.linear_in = nn.Linear(in_dim, hidden)
        self.dropout = Dropout(cfg.dropout)
        for i in range(n_layers):
            self.add_module(f"gcl_{i}", EGCL(cfg, hidden, coord_max))
            self.add_module(f"att_{i}", InterAttention(cfg, hidden, coord_max))
        self.out_layer = EGCL(cfg, hidden, coord_max)
        self.dropout_out = Dropout(cfg.dropout)
        self.linear_out = nn.Linear(hidden, out_dim)

    def _run_layer(self, layer: nn.Module, *args):
        """One EGCL or InterAttention call. With cfg.remat, while
        gradients are recorded, the layer keeps only its inputs and is
        recomputed in the backward (jax.checkpoint's trade: one more
        forward of the layer for O(n_layers) fewer live activations). The
        recomputation runs after the stochastic forward's block has closed,
        so it re-enters the forward's keys (seed and round), and its
        dropout draws are the forward's."""
        if not (self.cfg.remat and torch.is_grad_enabled()):
            return layer(*args)
        # the keys as they are now: the recycle loop moves state.round on
        state = copy.copy(active_stochastic())

        def run(*a):
            with enter_stochastic(state):
                return layer(*a)

        return checkpoint(run, *args, use_reentrant=False,
                          preserve_rng_state=False)

    def forward(self, h: Tensor, x: Tensor, gi: GraphInputs,
                pair_embed: Optional[Tensor], pair_mask: Optional[Tensor],
                intra_cutoff: float, inter_cutoff: float, ctx_k: int,
                p_p_dist_embed: Optional[Tensor] = None,
                c_c_dist_embed: Optional[Tensor] = None):
        """Returns (h, x, pair_embed). The distance embeddings feed the
        triangle attention (cfg.keep_trig_attn)."""
        cfg = self.cfg
        layout = gi.layout
        las_clamp = cfg.normalize(15.0)
        movable = layout.movable(x.device)[None, :, None]

        def maybe_fix(x_old, x_new):
            if cfg.fix_pocket:
                return torch.where(movable, x_new, x_old)
            return x_new

        h = self.dropout(self.linear_in(h))
        # edges are built once per call from the entry coords, as the
        # reference builds them once per recycle
        ctx = G.build_ctx_graph(x, layout, gi.lig_mask, gi.pkt_mask,
                                gi.bond_idx, gi.bond_mask, intra_cutoff, ctx_k)
        adj = G.build_inter_graph(x, layout, gi.lig_mask, gi.pkt_mask,
                                  inter_cutoff).adj
        for i in range(self.n_layers):
            h, x_new = self._run_layer(self._modules[f"gcl_{i}"], h, x, ctx,
                                       gi)
            x = maybe_fix(x, x_new)
            h, x_new, pair_new = self._run_layer(
                self._modules[f"att_{i}"], h, x, adj, gi, pair_embed,
                pair_mask, p_p_dist_embed, c_c_dist_embed)
            # FABind+ threads the updated pair embedding through the stack;
            # base discards it, so every layer biases off the entry pair
            if cfg.is_plus:
                pair_embed = pair_new
            x = maybe_fix(x, x_new)
            if not cfg.rm_LAS_constrained_optim and not cfg.only_last_LAS:
                x_l = las_projection_step(
                    x[:, layout.lig_slice], gi.las_ref, gi.las_adj,
                    cfg.geometry_reg_step_size, las_clamp,
                    steps=cfg.geom_reg_steps)
                x = layout.with_lig(x, x_l)

        h, x_new = self._run_layer(self.out_layer, h, x, ctx, gi)
        x = maybe_fix(x, x_new)
        h = self.linear_out(self.dropout_out(h))
        return h, x, pair_embed


class BipartiteEGCL(nn.Module):
    """The EGCL evaluated on the inter edges (the no-attention ablations'
    `att_{i}` layers): messages flow ligand -> pocket and pocket -> ligand
    over the dense bipartite adjacency, with the ctx EGCL's MLPs and
    parameter names. The global tokens get no message and run the residual
    node MLP on a zero aggregate. The edge MLP's first linear is decomposed
    as in EGCL, per node (FABind+'s LayerNorm form through
    MLPBlock.ln_l1_parts). Dropout calls: the two directions are 0 and 1,
    base's node output 2."""

    def __init__(self, cfg: ModelConfig, hidden: int, coord_max: float):
        super().__init__()
        self.cfg = cfg
        self.coord_max = coord_max
        self.edge_mlp, self.node_mlp, self.coord_mlp = _egcl_mlps(
            cfg, hidden, 2 * hidden + 1)
        self.dropout = Dropout(cfg.dropout)

    def forward(self, h: Tensor, x: Tensor, adj: Tensor, gi: GraphInputs):
        cfg = self.cfg
        layout = gi.layout
        lig, pkt = layout.lig_slice, layout.pkt_slice
        C = h.shape[-1]
        x_l, x_p = x[:, lig], x[:, pkt]
        diff_lp = x_l[:, :, None, :] - x_p[:, None, :, :]    # [B, Nc, Np, 3]
        r = (diff_lp * diff_lp).sum(-1)
        # both edge directions share the radial: a factor 2 in the F-norm
        div = _norm_div(2.0 * torch.where(adj, r * r, 0.0).sum((1, 2)), cfg)
        r_n = r / div[:, None, None]

        if cfg.is_plus and cfg.use_ln_mlp:
            parts = self.edge_mlp.ln_l1_parts(h)
            s_proj = F.linear(h, parts.w_src)                 # per node

            def messages(dst, src, radial, call):
                pre = self.edge_mlp.ln_l1_edges(
                    parts, parts.a[:, dst][:, :, None],
                    parts.t[:, dst][:, :, None], parts.q[:, dst][:, :, None],
                    h[:, src][:, None], radial, s_proj[:, src][:, None])
                return self.edge_mlp.finish(pre, call)
        else:
            w1 = self.edge_mlp.lin1.weight                    # [H, 2C+1]
            a = F.linear(h, w1[:, :C], self.edge_mlp.lin1.bias)
            s_proj = F.linear(h, w1[:, C:2 * C])
            w_r = w1[:, 2 * C]

            def messages(dst, src, radial, call):
                m = self.edge_mlp.finish(
                    a[:, dst][:, :, None] + s_proj[:, src][:, None]
                    + radial[..., None] * w_r, call)
                return m if cfg.is_plus else self.dropout(m, call)

        msg_l = messages(lig, pkt, r_n, 0)                    # [B, Nc, Np, H]
        msg_p = messages(pkt, lig, r_n.transpose(1, 2), 1)    # [B, Np, Nc, H]

        def coord_agg(msg, diff, mask, call):
            w = self.coord_mlp.scalar_call(msg, call)[..., None]
            t = diff * w * mask[..., None].to(diff.dtype)
            cnt = mask.sum(-1, keepdim=True).clamp(min=1)
            return t.sum(-2) / cnt.to(diff.dtype)

        adj_t = adj.transpose(1, 2)
        z_x = torch.zeros_like(x[:, 0])
        dx = layout.assemble(z_x, coord_agg(msg_l, diff_lp, adj, 0), z_x,
                             coord_agg(msg_p, -diff_lp.transpose(1, 2),
                                       adj_t, 1))
        x_out = x + dx.clamp(-self.coord_max, self.coord_max)

        z_h = torch.zeros_like(msg_l[:, 0, 0])
        agg = layout.assemble(
            z_h, torch.einsum("bds,bdsc->bdc", adj.to(msg_l.dtype), msg_l),
            z_h, torch.einsum("bds,bdsc->bdc", adj_t.to(msg_p.dtype), msg_p))
        out = self.node_mlp(torch.cat([h, agg], dim=-1))
        if not cfg.is_plus:
            out = self.dropout(out, 2)
        return h + out, x_out


class MCnoAttEGNN(nn.Module):
    """The ablation stacks: n_layers x (EGCL -> [trio encoder] ->
    BipartiteEGCL -> LAS projection) + an output EGCL. `with_cross_attn`
    runs one trio encoder (cross attention, or the InteractionModule pair
    update without cfg.add_cross_attn_layer), shared by every layer, before
    each inter layer; the pair it updates is carried through the stack.
    `attn_bias_proj` is a parameter whose output no layer reads, as in the
    reference. No remat, as in the JAX package."""

    def __init__(self, cfg: ModelConfig, in_dim: int, hidden: int,
                 out_dim: int, n_layers: int, with_cross_attn: bool = False):
        super().__init__()
        self.cfg = cfg
        self.n_layers = n_layers
        self.with_cross_attn = with_cross_attn
        coord_max = cfg.normalize(10.0)
        self.linear_in = nn.Linear(in_dim, hidden)
        self.dropout = Dropout(cfg.dropout)
        if with_cross_attn:
            add_trio_encoder(self, cfg, hidden)
        for i in range(n_layers):
            self.add_module(f"gcl_{i}", EGCL(cfg, hidden, coord_max))
            self.add_module(f"att_{i}", BipartiteEGCL(cfg, hidden, coord_max))
        self.out_layer = EGCL(cfg, hidden, coord_max)
        self.dropout_out = Dropout(cfg.dropout)
        self.linear_out = nn.Linear(hidden, out_dim)

    def forward(self, h: Tensor, x: Tensor, gi: GraphInputs,
                pair_embed: Optional[Tensor], pair_mask: Optional[Tensor],
                intra_cutoff: float, inter_cutoff: float, ctx_k: int,
                p_p_dist_embed: Optional[Tensor] = None,
                c_c_dist_embed: Optional[Tensor] = None):
        cfg = self.cfg
        layout = gi.layout
        las_clamp = cfg.normalize(15.0)
        movable = layout.movable(x.device)[None, :, None]

        def maybe_fix(x_old, x_new):
            if cfg.fix_pocket:
                return torch.where(movable, x_new, x_old)
            return x_new

        h = self.dropout(self.linear_in(h))
        ctx = G.build_ctx_graph(x, layout, gi.lig_mask, gi.pkt_mask,
                                gi.bond_idx, gi.bond_mask, intra_cutoff, ctx_k)
        adj = G.build_inter_graph(x, layout, gi.lig_mask, gi.pkt_mask,
                                  inter_cutoff).adj
        for i in range(self.n_layers):
            h, x_new = self._modules[f"gcl_{i}"](h, x, ctx, gi)
            x = maybe_fix(x, x_new)
            if self.with_cross_attn:
                # the shared encoder's i-th call of the round
                h, pair_embed = trio_encoder(
                    self, h, gi, pair_embed, pair_mask, p_p_dist_embed,
                    c_c_dist_embed, call=i)
            h, x_new = self._modules[f"att_{i}"](h, x, adj, gi)
            x = maybe_fix(x, x_new)
            if not cfg.rm_LAS_constrained_optim and not cfg.only_last_LAS:
                x_l = las_projection_step(
                    x[:, layout.lig_slice], gi.las_ref, gi.las_adj,
                    cfg.geometry_reg_step_size, las_clamp,
                    steps=cfg.geom_reg_steps)
                x = layout.with_lig(x, x_l)

        h, x_new = self.out_layer(h, x, ctx, gi)
        x = maybe_fix(x, x_new)
        h = self.linear_out(self.dropout_out(h))
        return h, x, pair_embed
