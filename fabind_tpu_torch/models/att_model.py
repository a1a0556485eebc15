"""Iterative refinement wrapper around the EGNN stack.

Counterpart of fabind_tpu/models/att_model.py: `n_iter` recycles, the first
n_iter - 1 without gradient and the last with it; only the movable nodes
(glb_c, ligand, glb_p) carry coordinate updates across rounds, or with
`flexible` (FABFlex-style docking) every real node, so the pocket residues
move with the ligand; the ligand's padding rows then keep their input. A
stochastic forward (inside `layers.dropout_rng`: sampling passes and the
training forward) with cfg.random_n_iter runs a count drawn uniformly from
1..n_iter, as the JAX package's non-deterministic forward does; its rounds
without gradient keep dropout on. The explicit pair embedding
(cfg.explicit_pair_embed) and the triangle attention's distance embeddings
(cfg.keep_trig_attn) are built once per forward from the entry node
embeddings and coordinates. The stack is MCAttEGNN, or with
cfg.ablation_no_attention* the no-attention MCnoAttEGNN; flag combinations
the JAX package cannot build raise ValueError (`unbuildable`).

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
import torch.nn.functional as F
from torch import nn

from fabind_tpu_torch.config import ModelConfig
from fabind_tpu_torch.models.egnn import GraphInputs, MCAttEGNN, MCnoAttEGNN
from fabind_tpu_torch.models.layers import (InteractionModule,
                                            RBFDistanceModule, StochasticKeys,
                                            active_stochastic,
                                            enter_stochastic, recycle_count,
                                            recycle_round)
from fabind_tpu_torch.utils import tracing

Tensor = torch.Tensor


def unbuildable(cfg: ModelConfig) -> Optional[str]:
    """Why the JAX package cannot build the EGNN stack of `cfg` (None when
    it can): a cross attention layer that reads a pair embedding nobody
    built, or a FABind+ distance-map head without a pair. The port refuses
    these flag combinations instead of inventing a behaviour."""
    cross_stack = (cfg.ablation_no_attention_with_cross_attn
                   and not cfg.ablation_no_attention)
    att_stack = not (cfg.ablation_no_attention
                     or cfg.ablation_no_attention_with_cross_attn)
    # the layers run a trio encoder, which makes (or updates) the pair
    trio = cross_stack or (att_stack and cfg.add_attn_pair_bias)
    if trio and cfg.add_cross_attn_layer and not cfg.explicit_pair_embed:
        stack = ("ablation_no_attention_with_cross_attn" if cross_stack
                 else "add_attn_pair_bias")
        return (f"explicit_pair_embed=False with add_cross_attn_layer and "
                f"{stack}: the cross attention reads a pair embedding that "
                f"nothing builds")
    if cfg.is_plus and not (trio or cfg.explicit_pair_embed):
        return ("FABind+ with explicit_pair_embed=False and no layer that "
                "builds a pair (ablation_no_attention, or add_attn_pair_bias "
                "off): its distance-map head reads the pair embedding")
    return None


def entry_dist_embeds(x: Tensor, gi: GraphInputs):
    """The triangle attention's distances at recycle entry, from detached
    coords: protein side [B, 1+Np, 1+Np] between valid nodes, compound side
    [B, 1+Nc, 1+Nc] over the LAS adjacency and the valid diagonal (the
    JAX package's choice: the reference passes no LAS mask there); other
    pairs are 1e6, outside every RBF's support."""
    layout = gi.layout
    xs = x.detach()
    p_mask_side, c_mask_side = gi.side_masks()

    def cdist(a):
        d2 = ((a[:, :, None, :] - a[:, None, :, :]) ** 2).sum(-1)
        return d2.clamp(min=1e-12).sqrt()

    pp = cdist(xs[:, layout.pside_slice])
    cc = cdist(xs[:, layout.cside_slice])
    pp_mask = p_mask_side[:, :, None] & p_mask_side[:, None, :]
    las_pad = F.pad(gi.las_adj, (1, 0, 1, 0)).bool()
    n = c_mask_side.shape[1]
    eye = torch.eye(n, dtype=torch.bool, device=x.device)
    cc_mask = las_pad | (eye[None] & c_mask_side[:, :, None])
    return (torch.where(pp_mask, pp, 1e6), torch.where(cc_mask, cc, 1e6))


class EfficientMCAttModel(nn.Module):

    def __init__(self, cfg: ModelConfig, embed_size: int, hidden_size: int,
                 n_layers: int, n_iter: int, ctx_k: int,
                 flexible: bool = False, stage: str = "dock"):
        super().__init__()
        why = unbuildable(cfg)
        if why is not None:
            raise ValueError(why)
        self.cfg = cfg
        self.n_iter = n_iter
        self.ctx_k = ctx_k
        self.flexible = flexible
        self.stage = stage      # "pocket" or "dock": the rounds' trace id
        self.site = 0           # the recycle count's draw (assign_sites)
        # the released checkpoints use MCAttEGNN; the ablations replace its
        # interfacial attention with EGCLs over the inter edges
        if cfg.ablation_no_attention or cfg.ablation_no_attention_with_cross_attn:
            self.gnn = MCnoAttEGNN(
                cfg, embed_size, hidden_size, hidden_size, n_layers,
                with_cross_attn=not cfg.ablation_no_attention)
        else:
            self.gnn = MCAttEGNN(cfg, embed_size, hidden_size, hidden_size,
                                 n_layers)
        if cfg.explicit_pair_embed:
            self.inter_layer = InteractionModule(
                embed_size, embed_size, hidden_size, hidden_size,
                rm_layernorm=cfg.rm_layernorm)
        if cfg.keep_trig_attn:
            self.p_p_dist_layer = RBFDistanceModule(
                cfg.normalize(32.0), hidden_size, num_gaussian=32,
                dropout_rate=cfg.dropout)
            self.c_c_dist_layer = RBFDistanceModule(
                cfg.normalize(16.0), hidden_size, num_gaussian=32,
                dropout_rate=cfg.dropout)

    def _step(self, h: Tensor, x: Tensor, gi: GraphInputs, pair: tuple,
              ctx_k: int):
        """One round of the stack; `pair` is (pair_embed, pair_mask,
        p_p_dist_embed, c_c_dist_embed), each None where the config has
        none."""
        cfg = self.cfg
        pair_embed, pair_mask, pp, cc = pair
        h_out, z, pair_out = self.gnn(
            h, x, gi, pair_embed, pair_mask, cfg.normalize(cfg.intra_cutoff),
            cfg.normalize(cfg.inter_cutoff), ctx_k, pp, cc)
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
        pair_embed = pair_mask = pp = cc = None
        if self.cfg.explicit_pair_embed:
            p_mask_side, c_mask_side = gi.side_masks()
            pair_embed, pair_mask = self.inter_layer(
                h[:, layout.pside_slice], h[:, layout.cside_slice],
                p_mask_side, c_mask_side)
            pair_embed = pair_embed * pair_mask[..., None].to(pair_embed.dtype)
        if self.cfg.keep_trig_attn:
            pp, cc = entry_dist_embeds(x, gi)
            pp = self.p_p_dist_layer(pp.to(h.dtype))
            cc = self.c_c_dist_layer(cc.to(h.dtype))
        pair = (pair_embed, pair_mask, pp, cc)

        x = x.detach()
        host_count = not isinstance(count, Tensor)
        with torch.no_grad():
            if host_count:
                for i in range(count - 1):
                    with recycle_round(i), tracing.span(
                            "model.round", stage=self.stage, round=i):
                        x = self._step(h, x, gi, pair, ctx_k)[1]
            elif self.n_iter > 1:
                x = self._while_rounds(x, count, h, gi, pair, ctx_k)
        last = {"round": count - 1} if host_count else {}
        with recycle_round(self.n_iter - 1), tracing.span(
                "model.round", stage=self.stage, **last):
            h_out, x, pair_out = self._step(h, x.detach(), gi, pair, ctx_k)
        return x, h_out, pair_out

    def _while_rounds(self, x: Tensor, count: Tensor, h: Tensor,
                      gi: GraphInputs, pair: tuple, ctx_k: int) -> Tensor:
        """The rounds without gradient as one while_loop over (round, x).
        The operator is called directly (the public `while_loop` compiles
        its body with dynamo): every tensor the body reads, the stack's
        weights included, is an explicit input (the `pair` tensors a config
        has; None cannot be an input), and the body keys its dropout draws
        by its own round tensor."""
        from torch._higher_order_ops.while_loop import while_loop_op
        from torch.func import functional_call

        state = active_stochastic()
        names = [n for n, _ in self.gnn.named_parameters()]
        seed = () if state is None else (state.seed_tensor(x.device),)
        n_seed = len(seed)
        present = [t is not None for t in pair]
        n_pair = sum(present)
        extra = (count, h, *(t for t in pair if t is not None), *gi, *seed,
                 *(p for _, p in self.gnn.named_parameters()))
        cfg = self.cfg
        n_gi = len(gi)

        def cond(i, x, count, *rest):
            return i < count - 1

        def body(i, x, count, h, *rest):
            it = iter(rest[:n_pair])
            pair_in = tuple(next(it) if p else None for p in present)
            rest = rest[n_pair:]
            g = GraphInputs(*rest[:n_gi])
            seed, weights = rest[n_gi:n_gi + n_seed], rest[n_gi + n_seed:]
            keys = (None if state is None
                    else StochasticKeys(seed_tensor=seed[0], rnd=i,
                                        rows=state.rows))
            pair_embed, pair_mask, pp, cc = pair_in
            with enter_stochastic(keys):
                _, z, _ = functional_call(
                    self.gnn, dict(zip(names, weights)),
                    (h, x, g, pair_embed, pair_mask,
                     cfg.normalize(cfg.intra_cutoff),
                     cfg.normalize(cfg.inter_cutoff), ctx_k, pp, cc))
            return i + 1, self._carry(g, z, x)

        return while_loop_op(cond, body, (torch.zeros_like(count), x),
                             extra)[1]
