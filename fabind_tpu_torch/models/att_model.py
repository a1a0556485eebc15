"""Iterative refinement wrapper around the EGNN stack.

Counterpart of fabind_tpu/models/att_model.py: `n_iter` recycles, the first
n_iter - 1 without gradient and the last with it; only the movable nodes
(glb_c, ligand, glb_p) carry coordinate updates across rounds. A stochastic
forward (inside `layers.dropout_rng`: sampling passes and the training
forward) with cfg.random_n_iter runs a count drawn uniformly from 1..n_iter,
as the JAX package's non-deterministic forward does; its rounds without
gradient keep dropout on. The explicit pair embedding is built once per
forward from the entry node embeddings.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from fabind_tpu_torch.config import ModelConfig
from fabind_tpu_torch.models.egnn import GraphInputs, MCAttEGNN
from fabind_tpu_torch.models.layers import InteractionModule, active_host_rng

Tensor = torch.Tensor


class EfficientMCAttModel(nn.Module):

    def __init__(self, cfg: ModelConfig, embed_size: int, hidden_size: int,
                 n_layers: int, n_iter: int, ctx_k: int):
        super().__init__()
        if (cfg.ablation_no_attention or cfg.ablation_no_attention_with_cross_attn
                or cfg.keep_trig_attn or not cfg.explicit_pair_embed):
            raise NotImplementedError(
                "ablation stacks, triangle attention and the implicit pair "
                "embedding are ported with the ablation slice")
        self.cfg = cfg
        self.n_iter = n_iter
        self.ctx_k = ctx_k
        self.gnn = MCAttEGNN(cfg, embed_size, hidden_size, hidden_size,
                             n_layers)
        self.inter_layer = InteractionModule(
            embed_size, embed_size, hidden_size, hidden_size,
            rm_layernorm=cfg.rm_layernorm)

    def _step(self, h: Tensor, x: Tensor, gi: GraphInputs, pair_embed: Tensor,
              pair_mask: Tensor, ctx_k: int):
        cfg = self.cfg
        h_out, z, pair_out = self.gnn(
            h, x, gi, pair_embed, pair_mask, cfg.normalize(cfg.intra_cutoff),
            cfg.normalize(cfg.inter_cutoff), ctx_k)
        movable = gi.layout.movable(x.device)[None, :, None]
        return h_out, torch.where(movable, z, x), pair_out

    def forward(self, x: Tensor, h: Tensor, gi: GraphInputs,
                n_iter: Optional[int] = None, ctx_k: Optional[int] = None):
        """x: [B, N, 3] normalized complex coords; h: [B, N, embed_size].
        ctx_k overrides the ctx graph's K (a shape bucket's). Returns
        (x_out, h_out, pair_embed_out)."""
        host_rng = active_host_rng()
        if n_iter is None and self.cfg.random_n_iter and host_rng is not None:
            n_iter = int(torch.randint(1, self.n_iter + 1, (),
                                       generator=host_rng))
        n_iter = self.n_iter if n_iter is None else n_iter
        ctx_k = self.ctx_k if ctx_k is None else ctx_k
        layout = gi.layout
        p_mask_side, c_mask_side = gi.side_masks()
        pair_embed, pair_mask = self.inter_layer(
            h[:, layout.pside_slice], h[:, layout.cside_slice],
            p_mask_side, c_mask_side)
        pair_embed = pair_embed * pair_mask[..., None].to(pair_embed.dtype)

        x = x.detach()
        with torch.no_grad():
            for _ in range(n_iter - 1):
                _, x, _ = self._step(h, x, gi, pair_embed, pair_mask, ctx_k)
        h_out, x, pair_out = self._step(h, x.detach(), gi, pair_embed,
                                        pair_mask, ctx_k)
        return x, h_out, pair_out
