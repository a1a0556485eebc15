"""Iterative refinement wrapper around the EGNN stack.

Counterpart of fabind_tpu/models/att_model.py: `n_iter` recycles, the first
n_iter - 1 without gradient and the last with it; only the movable nodes
(glb_c, ligand, glb_p) carry coordinate updates across rounds, or with
`flexible` (FABFlex-style docking) every real node, so the pocket residues
move with the ligand; the ligand's padding rows then keep their input. A
stochastic forward (inside `layers.dropout_rng`: sampling passes and the
training forward) with cfg.random_n_iter runs a count drawn uniformly from
1..n_iter, as the JAX package's non-deterministic forward does; its rounds
without gradient keep dropout on. The explicit pair embedding is built
once per forward from the entry node embeddings.

The count is known on the host (`layers.recycle_count` of the pass's seed
and the loop's site), and a forward given it as an int runs exactly
count - 1 rounds without gradient in a Python loop. A traced program takes
it as an int64 tensor instead and runs the rounds as one
torch._higher_order_ops.while_loop, its body traced once: the work of the
drawn count, with the predicate, a tensor on the device, read by the host
each round. On the H100 the sampling pass is host-bound, so that sync
costs little; running all n_iter - 1 rounds kept by torch.where instead
(no sync, the deepest count's work every pass) halved best-of-8
throughput there (PERF.md §6).

Round i's dropout draws are keyed by i, the round with gradient by
n_iter - 1, so the loop draws the masks of the Python loop and gives its
result bit for bit.
"""
from __future__ import annotations

from typing import Optional, Union

import torch
from torch import nn

from fabind_tpu_torch.config import ModelConfig
from fabind_tpu_torch.models.egnn import GraphInputs, MCAttEGNN
from fabind_tpu_torch.models.layers import (InteractionModule,
                                            StochasticKeys, active_stochastic,
                                            enter_stochastic, recycle_count,
                                            recycle_round)

Tensor = torch.Tensor


class EfficientMCAttModel(nn.Module):

    def __init__(self, cfg: ModelConfig, embed_size: int, hidden_size: int,
                 n_layers: int, n_iter: int, ctx_k: int,
                 flexible: bool = False):
        super().__init__()
        if (cfg.ablation_no_attention or cfg.ablation_no_attention_with_cross_attn
                or cfg.keep_trig_attn or not cfg.explicit_pair_embed):
            raise NotImplementedError(
                "ablation stacks, triangle attention and the implicit pair "
                "embedding are ported with the ablation slice")
        self.cfg = cfg
        self.n_iter = n_iter
        self.ctx_k = ctx_k
        self.flexible = flexible
        self.site = 0           # the recycle count's draw (assign_sites)
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
        return h_out, self._carry(gi, z, x), pair_out

    def _carry(self, gi: GraphInputs, z: Tensor, x: Tensor) -> Tensor:
        """The coordinates a round hands on: the stack's update `z` on the
        nodes that move (every real node of each sample when flexible, else
        the layout's glb_c, ligand and glb_p slots), `x` elsewhere."""
        if self.flexible:
            movable = gi.node_mask()[..., None]
        else:
            movable = gi.layout.movable(x.device)[None, :, None]
        return torch.where(movable, z, x)

    def draw_count(self) -> int:
        """The recycle count of this loop in the current forward: drawn
        from the stochastic forward's seed with cfg.random_n_iter, else
        n_iter."""
        state = active_stochastic()
        if state is None or not self.cfg.random_n_iter:
            return self.n_iter
        if state.seed is None:
            raise ValueError("a traced stochastic forward takes its recycle "
                             "counts as inputs: pass count=")
        return recycle_count(state.seed, self.site, self.n_iter)

    def forward(self, x: Tensor, h: Tensor, gi: GraphInputs,
                ctx_k: Optional[int] = None,
                count: Union[int, Tensor, None] = None):
        """x: [B, N, 3] normalized complex coords; h: [B, N, embed_size].
        ctx_k overrides the ctx graph's K (a shape bucket's). `count` is the
        recycle count (an int, or an int64 0-d tensor on the device in a
        traced program; default `draw_count()`). Returns (x_out, h_out,
        pair_embed_out)."""
        if count is None:
            count = self.draw_count()
        ctx_k = self.ctx_k if ctx_k is None else ctx_k
        layout = gi.layout
        p_mask_side, c_mask_side = gi.side_masks()
        pair_embed, pair_mask = self.inter_layer(
            h[:, layout.pside_slice], h[:, layout.cside_slice],
            p_mask_side, c_mask_side)
        pair_embed = pair_embed * pair_mask[..., None].to(pair_embed.dtype)

        x = x.detach()
        with torch.no_grad():
            if not isinstance(count, Tensor):
                for i in range(count - 1):
                    with recycle_round(i):
                        x = self._step(h, x, gi, pair_embed, pair_mask,
                                       ctx_k)[1]
            elif self.n_iter > 1:
                x = self._while_rounds(x, count, h, gi, pair_embed,
                                       pair_mask, ctx_k)
        with recycle_round(self.n_iter - 1):
            h_out, x, pair_out = self._step(h, x.detach(), gi, pair_embed,
                                            pair_mask, ctx_k)
        return x, h_out, pair_out

    def _while_rounds(self, x: Tensor, count: Tensor, h: Tensor,
                      gi: GraphInputs, pair_embed: Tensor, pair_mask: Tensor,
                      ctx_k: int) -> Tensor:
        """The rounds without gradient as one while_loop over (round, x).
        The operator is called directly (the public `while_loop` compiles
        its body with dynamo): every tensor the body reads, the stack's
        weights included, is an explicit input, and the body keys its
        dropout draws by its own round tensor."""
        from torch._higher_order_ops.while_loop import while_loop_op
        from torch.func import functional_call

        state = active_stochastic()
        names = [n for n, _ in self.gnn.named_parameters()]
        seed = () if state is None else (state.seed_tensor(x.device),)
        n_seed = len(seed)
        extra = (count, h, pair_embed, pair_mask, *gi, *seed,
                 *(p for _, p in self.gnn.named_parameters()))
        cfg = self.cfg
        n_gi = len(gi)

        def cond(i, x, count, *rest):
            return i < count - 1

        def body(i, x, count, h, pair_embed, pair_mask, *rest):
            g = GraphInputs(*rest[:n_gi])
            seed, weights = rest[n_gi:n_gi + n_seed], rest[n_gi + n_seed:]
            keys = (None if state is None
                    else StochasticKeys(seed_tensor=seed[0], rnd=i,
                                        rows=state.rows))
            with enter_stochastic(keys):
                _, z, _ = functional_call(
                    self.gnn, dict(zip(names, weights)),
                    (h, x, g, pair_embed, pair_mask,
                     cfg.normalize(cfg.intra_cutoff),
                     cfg.normalize(cfg.inter_cutoff), ctx_k))
            return i + 1, self._carry(g, z, x)

        return while_loop_op(cond, body, (torch.zeros_like(count), x),
                             extra)[1]
