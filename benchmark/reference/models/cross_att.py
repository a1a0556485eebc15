"""Cross attention over the ligand/protein pair embedding.

Counterpart of fabind_tpu/models/cross_att.py. Inputs are the "sides" of the
complex layout: the protein side [B, 1+Np, C] (glb_p + pocket), the compound
side [B, 1+Nc, C] (glb_c + ligand) and the pair embedding [B, 1+Np, 1+Nc, C].

A module called more than once in a recycle round (the stack-wide cross
attention of the no-attention ablation, called by every layer, and the
triangle block, applied to both orientations of the pair) passes the call's
index to its dropout draws.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from benchmark.reference.models.layers import (Attention, Dropout,
                                            InteractionModule, MLPBlock,
                                            Transition)

Tensor = torch.Tensor

INF = 1e9


class RowAttentionBlock(nn.Module):
    """Node_i attends to node_j with a gated pair-embedding bias."""

    def __init__(self, dim_i: int, dim_j: int, pair_dim: int,
                 attention_hidden_dim: int = 32, no_heads: int = 4,
                 dropout_rate: float = 0.1, rm_layernorm: bool = False):
        super().__init__()
        self.rm_layernorm = rm_layernorm
        if not rm_layernorm:
            self.layernorm_node_i = nn.LayerNorm(dim_i, eps=1e-5)
            self.layernorm_node_j = nn.LayerNorm(dim_j, eps=1e-5)
            self.layernorm_pair = nn.LayerNorm(pair_dim, eps=1e-5)
        self.linear = nn.Linear(pair_dim, no_heads)
        self.linear_g = nn.Linear(pair_dim, no_heads)
        self.mha = Attention(dim_i, dim_j, attention_hidden_dim, no_heads)
        self.dropout = Dropout(dropout_rate)

    def forward(self, node_i: Tensor, node_j: Tensor, pair_embed: Tensor,
                pair_mask: Tensor, node_mask_i: Tensor,
                call: int = 0) -> Tensor:
        # with layernorm on, the residual base is the NORMALIZED embedding,
        # as in the reference's reassignment
        if not self.rm_layernorm:
            node_i = self.layernorm_node_i(node_i)
            node_j = self.layernorm_node_j(node_j)
            pair_embed = self.layernorm_pair(pair_embed)
        mask_bias = (INF * (pair_mask.to(pair_embed.dtype) - 1.0))[..., None, :, :]
        pair_bias = (self.linear(pair_embed)
                     * torch.sigmoid(self.linear_g(pair_embed)))
        pair_bias = pair_bias.movedim(-1, -3)                 # (*, H, I, J)
        upd = self.dropout(self.mha(node_i, node_j,
                                    biases=[mask_bias, pair_bias]), call)
        return node_i + upd * node_mask_i[..., None].to(upd.dtype)


class RowTriangleAttentionBlock(nn.Module):
    """Triangle attention along the rows of the pair embedding [*, I, J, C],
    biased by a gated distance embedding [*, J, J, C_d] of the row's own
    nodes. With layernorm on, the residual base is the normalized pair."""

    def __init__(self, pair_dim: int, dist_dim: int,
                 attention_hidden_dim: int = 32, no_heads: int = 4,
                 dropout_rate: float = 0.1, rm_layernorm: bool = False):
        super().__init__()
        self.rm_layernorm = rm_layernorm
        if not rm_layernorm:
            self.layernorm = nn.LayerNorm(pair_dim, eps=1e-5)
        self.linear = nn.Linear(dist_dim, no_heads)
        self.linear_g = nn.Linear(dist_dim, no_heads)
        self.mha = Attention(pair_dim, pair_dim, attention_hidden_dim,
                             no_heads)
        self.dropout = Dropout(dropout_rate)

    def forward(self, pair_embed: Tensor, pair_mask: Tensor,
                dist_embed: Tensor, call: int = 0) -> Tensor:
        if not self.rm_layernorm:
            pair_embed = self.layernorm(pair_embed)
        mask_bias = (INF * (pair_mask.to(pair_embed.dtype) - 1.0)
                     )[..., :, None, None, :]                 # (*, I, 1, 1, J)
        dist_bias = (self.linear(dist_embed)
                     * torch.sigmoid(self.linear_g(dist_embed)))
        dist_bias = dist_bias.movedim(-1, -3)[..., None, :, :, :]
        upd = self.dropout(self.mha(pair_embed, pair_embed,
                                    biases=[mask_bias, dist_bias]), call)
        return pair_embed + upd * pair_mask[..., None].to(upd.dtype)


class CrossAttentionModule(nn.Module):
    """p<-c and c<-p row attention, transitions and the pair update. The
    compound side attends to the *updated* protein side; the pair transition
    is not residual. With keep_trig_attn one triangle block runs first over
    the pair's rows (distances between compound nodes) and then over its
    columns (between protein nodes); its dropout rate is the reference's
    fixed 0.1."""

    def __init__(self, dim: int, rm_layernorm: bool = False,
                 dropout_rate: float = 0.1, is_plus: bool = False,
                 mlp_hidden_scale: int = 1, use_ln_mlp: bool = False,
                 mha_heads: int = 4, keep_trig_attn: bool = False):
        super().__init__()
        self.keep_trig_attn = keep_trig_attn
        if keep_trig_attn:
            self.triangle_block_row = RowTriangleAttentionBlock(
                dim, dim, rm_layernorm=rm_layernorm)
        self.p_attention_block = RowAttentionBlock(
            dim, dim, dim, no_heads=mha_heads, dropout_rate=dropout_rate,
            rm_layernorm=rm_layernorm)
        self.c_attention_block = RowAttentionBlock(
            dim, dim, dim, no_heads=mha_heads, dropout_rate=dropout_rate,
            rm_layernorm=rm_layernorm)

        def transition():
            if is_plus:
                return MLPBlock(dim, mlp_hidden_scale * dim, dim, act="relu",
                                use_ln=use_ln_mlp, last_act=True,
                                dropout_rate=dropout_rate, dropout_pos="both")
            return Transition(dim, n=2, rm_layernorm=rm_layernorm)

        self.p_transition = transition()
        self.c_transition = transition()
        self.inter_layer = InteractionModule(dim, dim, 32, dim,
                                             rm_layernorm=rm_layernorm)
        self.pair_transition = transition()

    def forward(self, p_embed: Tensor, p_mask: Tensor, c_embed: Tensor,
                c_mask: Tensor, pair_embed: Tensor, pair_mask: Tensor,
                p_p_dist_embed: Optional[Tensor] = None,
                c_c_dist_embed: Optional[Tensor] = None, call: int = 0):
        """`call` is this call's index in the round (the dropout keys; the
        triangle block draws with 2 * call and 2 * call + 1)."""
        if self.keep_trig_attn:
            blk = self.triangle_block_row
            pair_embed = blk(pair_embed, pair_mask, c_c_dist_embed, 2 * call)
            pair_embed = blk(pair_embed.transpose(-2, -3),
                             pair_mask.transpose(-1, -2), p_p_dist_embed,
                             2 * call + 1).transpose(-2, -3)
        p_embed = self.p_attention_block(p_embed, c_embed, pair_embed,
                                         pair_mask, p_mask, call)
        c_embed = self.c_attention_block(c_embed, p_embed,
                                         pair_embed.transpose(-2, -3),
                                         pair_mask.transpose(-1, -2), c_mask,
                                         call)
        p_embed = p_embed + self._transition(self.p_transition, p_embed, call)
        c_embed = c_embed + self._transition(self.c_transition, c_embed, call)
        pair_embed = pair_embed + self.inter_layer(p_embed, c_embed, p_mask,
                                                   c_mask)[0]
        pair_embed = self._transition(self.pair_transition, pair_embed, call)
        pair_embed = pair_embed * pair_mask[..., None].to(pair_embed.dtype)
        return p_embed, c_embed, pair_embed

    @staticmethod
    def _transition(mod: nn.Module, x: Tensor, call: int) -> Tensor:
        # FABind+'s transitions are MLPBlocks with dropout; base's have none
        return mod(x, call) if isinstance(mod, MLPBlock) else mod(x)
