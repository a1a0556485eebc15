"""Primitive neural blocks shared by FABind and FABind+.

Counterpart of fabind_tpu/models/layers.py. Module and parameter names are the
torch reference's state_dict names: the base Sequential MLPs keep their
children at indices 0 and 2, the FABind+ MLPs name them linear1/linear2.
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import (Callable, Iterator, NamedTuple, Optional, Sequence,
                    Tuple, Union)

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from fabind_tpu_torch.ops.dropout import dropout, host_u32, site_id
from fabind_tpu_torch.ops.edge_gate import phi_rank1_pair

Tensor = torch.Tensor

ACTS = {"silu": F.silu, "relu": F.relu}

# per thread: the stochastic forward in progress (a StochasticKeys), or None
# (the deterministic forward)
_STOCHASTIC = threading.local()
# int rounds (0..n_iter - 1; sites outside a recycle loop draw in round 0)
# index a device arange of this many slots
ROUND_SLOTS = 64
# the training stage coin's host draw
STAGE_COIN_SITE = site_id("stage_coin")


def upload_int64(values, device) -> Tensor:
    """int64 values as a tensor on `device`, without waiting for the
    device: on the card through pinned memory and a non-blocking copy."""
    t = torch.tensor(values, dtype=torch.int64)
    if torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def signed64(seed: int) -> int:
    """A 64-bit seed as the int64 a tensor holds (two's complement)."""
    seed &= 2**64 - 1
    return seed - 2**64 if seed >= 2**63 else seed


class RowMap(NamedTuple):
    """Where the rows of a forward's batch sit in the global batch that
    data parallelism splits: local row j is row j * mul + add of a global
    batch of `total` rows (a serving replica's contiguous block from row
    `start`: (1, start); a training rank's strided rows: (world, rank)).
    A stochastic forward then draws what the global batch draws at those
    rows: its dropout masks by their global element index (ops/dropout.py),
    the gumbel uniforms and the pocket noise at the global shape, sliced.
    `all_sum` sums a tensor over every part of the global batch (a
    collective across training ranks), for the one batch statistic the
    training forward takes (the stage gate's mean center error); None where
    no part needs another's rows. The default maps a batch onto itself."""

    mul: int = 1
    add: int = 0
    total: Optional[int] = None
    all_sum: Optional[Callable[[Tensor], Tensor]] = None

    def take(self, t: Tensor, n: int) -> Tensor:
        """The n local rows of `t` [total, ...] (t itself without a map)."""
        if self.total is None:
            return t
        return t[self.add:self.add + self.mul * (n - 1) + 1:self.mul]

    def mean(self, x: Tensor) -> Tensor:
        """The mean of x [n] over the rows of the global batch."""
        if self.all_sum is None:
            return x.mean()
        return self.all_sum(x.sum()) / self.total


class StochasticKeys:
    """One stochastic forward's keys: the seed (a host int, and per device
    a tensor the kernels read), the current recycle round (an int, or a
    tensor inside a traced loop), the generator of the training-only draws
    and the row map of a part of a data-parallel batch."""

    def __init__(self, seed: Optional[int] = None,
                 seed_tensor: Optional[Tensor] = None,
                 generator: Optional[torch.Generator] = None, rnd=0,
                 rows: RowMap = RowMap()):
        self.seed = seed
        self.generator = generator
        self.round = rnd
        self.rows = rows
        self._seeds = {} if seed_tensor is None else {
            seed_tensor.device: seed_tensor}
        self._rounds = {}

    def seed_tensor(self, device) -> Tensor:
        t = self._seeds.get(device)
        if t is None:
            t = self._seeds[device] = upload_int64(signed64(self.seed), device)
        return t

    def round_tensor(self, device) -> Tensor:
        if isinstance(self.round, Tensor):
            return self.round
        rounds = self._rounds.get(device)
        if rounds is None:
            rounds = self._rounds[device] = torch.arange(
                ROUND_SLOTS, dtype=torch.int64, device=device)
        return rounds[self.round]

    def rand(self, shape, device, dtype) -> Tensor:
        """torch.rand from the generator at the global batch's shape (the
        leading axis `rows.total`), this part's rows of it."""
        if self.generator is None:
            raise RuntimeError("the training-only draws need "
                               "layers.dropout_rng(generator)")
        n = shape[0]
        full = (n if self.rows.total is None else self.rows.total,
                *shape[1:])
        return self.rows.take(torch.rand(full, generator=self.generator,
                                         device=device, dtype=dtype), n)


@contextlib.contextmanager
def enter_stochastic(state: Optional[StochasticKeys]) -> Iterator[None]:
    """Make `state` the current thread's stochastic forward (None: the
    deterministic one) for the block."""
    prev = getattr(_STOCHASTIC, "state", None)
    _STOCHASTIC.state = state
    try:
        yield
    finally:
        _STOCHASTIC.state = prev


def active_stochastic() -> Optional[StochasticKeys]:
    """The current thread's stochastic forward, None in a deterministic
    one."""
    return getattr(_STOCHASTIC, "state", None)


@contextlib.contextmanager
def dropout_rng(generator: Optional[torch.Generator],
                rows: RowMap = RowMap()
                ) -> Iterator[Optional[torch.Generator]]:
    """Run the forwards of the block stochastically in the current thread,
    as the JAX package's `deterministic=False`: every Dropout draws its mask
    from the counter-based operator (ops/dropout.py) keyed by
    `generator.initial_seed()`, its site, its call and the recycle round;
    with cfg.random_n_iter each recycle loop's count is drawn on the host
    from the same seed and the loop's site (`recycle_count`). The generator
    itself gives only the training-only draws (the gumbel uniforms and the
    pocket-center noise). Other threads are unaffected, so concurrent calls
    on one shared module (the serving engine's) keep their deterministic
    forwards. None runs the block deterministically. `rows` is the row
    map of a part of a data-parallel batch (RowMap)."""
    state = (None if generator is None else
             StochasticKeys(generator.initial_seed(), generator=generator,
                            rows=rows))
    with enter_stochastic(state):
        yield generator


@contextlib.contextmanager
def dropout_seed(seed: Union[int, Tensor],
                 rows: RowMap = RowMap()) -> Iterator[None]:
    """dropout_rng from a seed alone: an int (the host knows it: the recycle
    counts can be drawn, and each device gets the seed as a tensor once), or
    an int64 tensor on the device (a traced program's input: the masks are
    drawn without the host, and the recycle counts must be passed to the
    loops). Without a generator, the training-only draws are not
    available. `rows` is the row map of a part of a data-parallel batch."""
    state = (StochasticKeys(seed_tensor=seed, rows=rows)
             if isinstance(seed, Tensor) else StochasticKeys(seed, rows=rows))
    with enter_stochastic(state):
        yield


@contextlib.contextmanager
def recycle_round(rnd) -> Iterator[None]:
    """Key the block's dropout draws with recycle round `rnd` (an int, or
    an int64 tensor on the device inside a traced loop)."""
    state = active_stochastic()
    if state is None:
        yield
        return
    prev, state.round = state.round, rnd
    try:
        yield
    finally:
        state.round = prev


def active_dropout_rng() -> Optional[torch.Generator]:
    """The current thread's dropout generator, None when dropout is off or
    the seed is a tensor."""
    state = active_stochastic()
    return None if state is None else state.generator


def recycle_count(seed: int, site: int, n_iter: int) -> int:
    """The recycle count, uniform in 1..n_iter, of the loop `site` in the
    stochastic forward of `seed` (cfg.random_n_iter), drawn on the host."""
    return 1 + ((host_u32(seed, site) * n_iter) >> 32)


def stage_coin(seed: int) -> float:
    """The training stage gate's uniform draw in [0, 1) for `seed`."""
    return host_u32(seed, STAGE_COIN_SITE) / 2.0**32


def assign_sites(root: nn.Module) -> None:
    """Give every Dropout and recycle loop under `root` the id of its
    qualified name (ops.dropout.site_id), so two sites never share a key
    and the ids are the same in every process."""
    for name, mod in root.named_modules():
        if isinstance(mod, Dropout) or hasattr(mod, "site"):
            mod.site = site_id(name)


class Dropout(nn.Module):
    """Inverted dropout, on exactly inside a `dropout_rng` (or
    `dropout_seed`) block: elements are kept with probability 1 - rate and
    scaled by 1 / (1 - rate), as flax's nn.Dropout, with masks from the
    counter-based operator. `call` tells apart the calls of one module in
    one recycle round. `.train()` alone does not turn it on: a module in
    training mode raises outside such a block, so a training forward never
    runs without its masks. `site` is set by `assign_sites` (0 for a module
    used on its own)."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate
        self.site = 0

    @property
    def active(self) -> bool:
        return self.rate > 0 and active_stochastic() is not None

    def forward(self, x: Tensor, call: int = 0) -> Tensor:
        if self.training and self.rate > 0 and not self.active:
            raise RuntimeError(
                "Dropout in training mode draws its masks from "
                "layers.dropout_rng(generator); run the forward inside one")
        if not self.active:
            return x
        state = active_stochastic()
        return dropout(x, state.seed_tensor(x.device),
                       state.round_tensor(x.device), self.site, call,
                       self.rate, state.rows.mul, state.rows.add)


class LnL1Parts(NamedTuple):
    """Per-node pieces of `linear1(layernorm([h_dst ++ h_src ++ r]))` over
    node features h [B, N, C] (see MLPBlock.ln_l1_parts)."""

    a: Tensor       # [B, N, H] the dst block, (gamma * W)_dst h
    w_src: Tensor   # [H, C] the gamma-scaled src block of linear1's weight
    w_r: Tensor     # [H] the gamma-scaled radial column
    u: Tensor       # [H] the gamma-scaled weight summed over the input
    c: Tensor       # [H] W beta + b
    t: Tensor       # [B, N] float32 sum of h over C
    q: Tensor       # [B, N] float32 sum of h^2 over C


class MLPBlock(nn.Module):
    """Two-linear MLP covering both variants' MLP families.

    Besides forward, exposes the decomposed pieces the EGNN layers use:
    `lin1` (first linear), `finish` (act -> dropout -> second linear ->
    ...), `finish_scalar`/`scalar_call` for out_dim == 1, and
    `finish_scalar_rank1_pair`, which evaluates the InterAttention gate of
    both attention directions over rank-1-structured pre-activations through
    the edge-gate kernel.
    """

    def __init__(self, in_dim: int, hidden_dim: int, out_dim: int,
                 act: str = "silu", use_ln: bool = False,
                 last_act: bool = False, bias_out: bool = True,
                 dropout_rate: float = 0.0, dropout_pos: str = "none",
                 sequential_names: bool = False):
        super().__init__()
        self.act = act
        self.use_ln = use_ln
        self.last_act = last_act
        self.bias_out = bias_out
        self.out_dim = out_dim
        self.dropout_rate = dropout_rate
        self.dropout_pos = dropout_pos
        if use_ln:
            self.layernorm = nn.LayerNorm(in_dim, eps=1e-5)
        self._names = ("0", "2") if sequential_names else ("linear1", "linear2")
        self.add_module(self._names[0], nn.Linear(in_dim, hidden_dim))
        self.add_module(self._names[1],
                        nn.Linear(hidden_dim, out_dim, bias=bias_out))
        inner = dropout_rate > 0 and dropout_pos in ("inner", "both")
        self.dropout1 = Dropout(dropout_rate if inner else 0.0)
        self.dropout2 = Dropout(dropout_rate if dropout_pos == "both" else 0.0)

    @property
    def lin1(self) -> nn.Linear:
        return self._modules[self._names[0]]

    @property
    def lin2(self) -> nn.Linear:
        return self._modules[self._names[1]]

    def finish(self, pre: Tensor, call: int = 0) -> Tensor:
        """Complete the MLP from the first-linear pre-activation. `call`
        tells apart the block's calls in one recycle round (their dropout
        draws)."""
        act = ACTS[self.act]
        x = self.lin2(self.dropout1(act(pre), call))
        if self.last_act:
            x = act(x)
        return self.dropout2(x, call)

    def forward(self, x: Tensor, call: int = 0) -> Tensor:
        if self.use_ln:
            x = self.layernorm(x)
        return self.finish(self.lin1(x), call)

    def finish_scalar(self, pre: Tensor, call: int = 0) -> Tensor:
        """finish() for out_dim == 1, returning [...] instead of [..., 1]."""
        assert self.out_dim == 1 and not self.last_act
        out = self.dropout1(ACTS[self.act](pre), call) @ self.lin2.weight[0]
        if self.bias_out:
            out = out + self.lin2.bias[0]
        return self.dropout2(out, call)

    def scalar_call(self, x: Tensor, call: int = 0) -> Tensor:
        if self.use_ln:
            x = self.layernorm(x)
        return self.finish_scalar(self.lin1(x), call)

    def ln_l1_parts(self, h: Tensor) -> LnL1Parts:
        """Per-node pieces of `linear1(layernorm(v))` for the edge input
        v = [h_dst ++ h_src ++ r] of width D = 2C + 1 (the released FABind+
        edge MLPs). LayerNorm's statistics are sums, so with per-node
        t = sum(h) and q = sum(h^2) each edge's mean and variance come back
        in O(1), and the normalize-then-project algebra folds into per-node
        products:

            linear1(LN(v)) = inv * (A h_dst + S h_src + r w_r - mu u) + c
            mu = (t_dst + t_src + r) / D
            inv = rsqrt((q_dst + q_src + r^2) / D - mu^2 + eps)
            A, S, w_r = the dst, src and radial blocks of gamma * W
            u = sum over the input of gamma * W,   c = W beta + b

        The src block stays a per-edge product ([E, C] @ [C, H], half the
        fused [E, 2C+1] @ [2C+1, H]): projecting per node would gather
        H-wide rows instead of C-wide ones. The statistics accumulate in
        float32 in bf16 too: q/D - mu^2 cancels badly in bf16."""
        assert self.use_ln
        C = h.shape[-1]
        W, b = self.lin1.weight, self.lin1.bias          # [H, D], [H]
        Wg = W * self.layernorm.weight                    # gamma per input
        hf = h.float()
        return LnL1Parts(
            a=F.linear(h, Wg[:, :C]), w_src=Wg[:, C:2 * C], w_r=Wg[:, 2 * C],
            u=Wg.sum(1), c=F.linear(self.layernorm.bias, W, b),
            t=hf.sum(-1), q=(hf * hf).sum(-1))

    def ln_l1_edges(self, parts: LnL1Parts, a_dst: Tensor, t_dst: Tensor,
                    q_dst: Tensor, h_src: Tensor, radial: Tensor,
                    s_src: Optional[Tensor] = None) -> Tensor:
        """linear1(layernorm([h_dst ++ h_src ++ radial])) per edge from the
        destinations' parts (a_dst [..., H], t_dst and q_dst [...], each
        indexed or broadcast to the edges), the gathered source features
        h_src [..., C] and the edges' radial [...]. `s_src` is the sources'
        projection h_src @ w_src.T when the caller has it per node (a dense
        bipartite edge set broadcasts it); else it is computed per edge."""
        hf = h_src.float()
        D = 2 * h_src.shape[-1] + 1
        rf = radial.float()
        mu = (t_dst + hf.sum(-1) + rf) / D
        var = (q_dst + (hf * hf).sum(-1) + rf * rf) / D - mu * mu
        inv = torch.rsqrt(var + 1e-5)
        dt = a_dst.dtype
        if s_src is None:
            s_src = F.linear(h_src, parts.w_src)
        pre = (a_dst + s_src
               + rf[..., None].to(dt) * parts.w_r
               - mu[..., None].to(dt) * parts.u)
        return inv[..., None].to(dt) * pre + parts.c

    def finish_scalar_rank1_pair(self, l1_a: Tensor, l1_b: Tensor, r: Tensor,
                                 u: Tensor) -> Tuple[Tensor, Tensor]:
        """finish_scalar over the rank-1-structured pre-activations of both
        InterAttention directions over one r [B, Na, Nb], without
        materializing them:

            ab[b,i,j] over l1_b[b,j,:] + r[b,i,j] * u   -> [B, Na, Nb]
            ba[b,j,i] over l1_a[b,i,:] + r[b,i,j] * u   -> [B, Nb, Na]

        One launch of the edge-gate kernel (ops/edge_gate.py) when dropout
        is off and act is silu or relu; else both are materialized."""
        assert self.out_dim == 1 and not self.last_act and not self.use_ln
        if self.dropout1.active or self.act not in ("silu", "relu"):
            return (self.finish_scalar(l1_b[:, None] + r[..., None] * u, 0),
                    self.finish_scalar(l1_a[:, None]
                                       + r.transpose(1, 2)[..., None] * u, 1))
        ab, ba = phi_rank1_pair(l1_a, l1_b, r.contiguous(), u,
                                self.lin2.weight[0], self.act)
        if self.bias_out:
            ab = ab + self.lin2.bias[0]
            ba = ba + self.lin2.bias[0]
        return ab, ba


class Transition(nn.Module):
    """LN -> Linear(n*h) -> relu -> Linear(h)."""

    def __init__(self, dim: int, n: int = 4, rm_layernorm: bool = False):
        super().__init__()
        if not rm_layernorm:
            self.layernorm = nn.LayerNorm(dim, eps=1e-5)
        self.rm_layernorm = rm_layernorm
        self.linear_1 = nn.Linear(dim, n * dim)
        self.linear_2 = nn.Linear(n * dim, dim)

    def forward(self, x: Tensor) -> Tensor:
        if not self.rm_layernorm:
            x = self.layernorm(x)
        return self.linear_2(F.relu(self.linear_1(x)))


class TransitionDiffOutDim(nn.Module):
    """FABind base pocket-cls head: LN -> Linear(n*h) -> relu -> Linear(out)."""

    def __init__(self, dim: int, out_dim: int = 1, n: int = 4):
        super().__init__()
        self.layernorm = nn.LayerNorm(dim, eps=1e-5)
        self.linear1 = nn.Linear(dim, n * dim)
        self.linear2 = nn.Linear(n * dim, out_dim)

    def forward(self, z: Tensor) -> Tensor:
        return self.linear2(F.relu(self.linear1(self.layernorm(z))))


class Attention(nn.Module):
    """Gated multi-head attention with an additive bias list. c_hidden is
    the per-head width. `distance` [*, Q, K, H] is FABind+'s distance-pair
    bias: added to the logits before the softmax (`dis_pair_type` "add") or
    multiplied into the weights after it ("mul")."""

    def __init__(self, q_dim: int, kv_dim: int, c_hidden: int, no_heads: int,
                 gating: bool = True):
        super().__init__()
        self.c_hidden = c_hidden
        self.no_heads = no_heads
        hd = c_hidden * no_heads
        self.linear_q = nn.Linear(q_dim, hd, bias=False)
        self.linear_k = nn.Linear(kv_dim, hd, bias=False)
        self.linear_v = nn.Linear(kv_dim, hd, bias=False)
        self.gating = gating
        if gating:
            self.linear_g = nn.Linear(q_dim, hd)
        self.linear_o = nn.Linear(hd, q_dim)

    def forward(self, q_x: Tensor, kv_x: Tensor,
                biases: Optional[Sequence[Tensor]] = None,
                distance: Optional[Tensor] = None,
                dis_pair_type: str = "none") -> Tensor:
        H, D = self.no_heads, self.c_hidden
        q = self.linear_q(q_x).unflatten(-1, (H, D)) / math.sqrt(D)
        k = self.linear_k(kv_x).unflatten(-1, (H, D))
        v = self.linear_v(kv_x).unflatten(-1, (H, D))
        a = torch.einsum("...qhd,...khd->...hqk", q, k)
        for b in biases or ():
            a = a + b
        if dis_pair_type == "add" and distance is not None:
            a = a + distance.movedim(-1, -3)
        a = torch.softmax(a, dim=-1)
        if dis_pair_type == "mul" and distance is not None:
            a = a * distance.movedim(-1, -3)
        o = torch.einsum("...hqk,...khd->...qhd", a, v)
        if self.gating:
            o = o * torch.sigmoid(self.linear_g(q_x)).unflatten(-1, (H, D))
        return self.linear_o(o.flatten(-2))


class InteractionModule(nn.Module):
    """Pair embedding from node embeddings: z_ij = Linear(p_i * c_j), or
    with `opm` the outer product z_ij = Linear(p_i (x) c_j) over the
    hidden_dim^2 products, p's channel major (the JAX package's
    einsum "...bc,...de->...bdce" flattened)."""

    def __init__(self, p_dim: int, c_dim: int, hidden_dim: int,
                 pair_dim: int, rm_layernorm: bool = False,
                 opm: bool = False):
        super().__init__()
        self.rm_layernorm = rm_layernorm
        self.opm = opm
        if not rm_layernorm:
            self.layer_norm_p = nn.LayerNorm(p_dim, eps=1e-5)
            self.layer_norm_c = nn.LayerNorm(c_dim, eps=1e-5)
        self.linear_p = nn.Linear(p_dim, hidden_dim)
        self.linear_c = nn.Linear(c_dim, hidden_dim)
        self.linear_out = nn.Linear(hidden_dim * hidden_dim if opm
                                    else hidden_dim, pair_dim)

    def forward(self, p_embed: Tensor, c_embed: Tensor, p_mask: Tensor,
                c_mask: Tensor):
        inter_mask = p_mask[..., :, None] & c_mask[..., None, :]
        if not self.rm_layernorm:
            p_embed = self.layer_norm_p(p_embed)
            c_embed = self.layer_norm_c(c_embed)
        p = self.linear_p(p_embed)
        c = self.linear_c(c_embed)
        if self.opm:
            z = self._outer_product_out(p, c)
        else:
            z = self.linear_out(torch.einsum("...ik,...jk->...ijk", p, c))
        return z * inter_mask[..., None].to(z.dtype), inter_mask

    def _outer_product_out(self, p: Tensor, c: Tensor) -> Tensor:
        """linear_out over the outer products without building them: the
        [*, I, J, C*C] tensor is 66 GB in fp32 at the docking bucket
        48:160:512, batch 8. linear_out's weight [O, C*C] is [O, C, C]
        (p's channel, then c's); c is contracted first (T [*, J, O, C],
        0.4 GB there), then p:
            z[i, j, o] = sum_a p[i, a] sum_e W[o, a, e] c[j, e] + b[o]."""
        C = p.shape[-1]
        w = self.linear_out.weight.unflatten(1, (C, C))      # [O, C, C]
        t = torch.einsum("...je,oae->...joa", c, w)
        return torch.einsum("...ia,...joa->...ijo", p, t) + self.linear_out.bias


class GaussianSmearing(nn.Module):
    """RBF expansion of distances over `num_gaussians` fixed centers in
    [start, stop]. The centers are computed, not kept in a buffer (the
    reference's `offset` buffer is the same linspace), uploaded once per
    device and dtype, so a forward copies nothing from the host and a CUDA
    graph can hold it (graphs.py); a traced program computes them."""

    def __init__(self, start: float = 0.0, stop: float = 5.0,
                 num_gaussians: int = 50):
        super().__init__()
        self.offset = np.linspace(start, stop, num_gaussians)
        self.coeff = -0.5 / float(self.offset[1] - self.offset[0]) ** 2
        self._centers = {}

    def centers(self, device, dtype) -> Tensor:
        if torch.compiler.is_compiling():
            return torch.as_tensor(self.offset, dtype=dtype, device=device)
        t = self._centers.get((device, dtype))
        if t is None:
            with torch.inference_mode(False):   # a tensor autograd may read
                t = self._centers[(device, dtype)] = torch.as_tensor(
                    self.offset, dtype=dtype, device=device)
        return t

    def forward(self, dist: Tensor) -> Tensor:
        d = dist[..., None] - self.centers(dist.device, dist.dtype)
        return torch.exp(self.coeff * d * d)


class GaussianLayer(nn.Module):
    """K gaussian pdfs with trainable means and stds, evaluated on a
    [..., 1] distance broadcast to K channels."""

    def __init__(self, K: int = 128):
        super().__init__()
        self.K = K
        self.means = nn.Parameter(torch.empty(1, K).uniform_(0, 3))
        self.stds = nn.Parameter(torch.empty(1, K).uniform_(0, 3))

    def forward(self, x: Tensor) -> Tensor:
        mean = self.means.reshape(-1)
        std = self.stds.reshape(-1).abs() + 1e-2
        z = (x.expand(*x.shape[:-1], self.K) - mean) / std
        pi = 3.14159
        return torch.exp(-0.5 * z * z) / (math.sqrt(2 * pi) * std)


class RBFDistanceModule(nn.Module):
    """RBF expansion + MLP distance embedding: Sequential(Linear, ReLU,
    Dropout, Linear) named `mlp` as in the reference (children 0 and 3
    carry the weights)."""

    def __init__(self, rbf_stop: float, hidden_dim: int,
                 num_gaussian: int = 32, dropout_rate: float = 0.1):
        super().__init__()
        self.rbf = GaussianSmearing(0.0, rbf_stop, num_gaussian)
        self.mlp = nn.Sequential(nn.Linear(num_gaussian, hidden_dim),
                                 nn.ReLU(), Dropout(dropout_rate),
                                 nn.Linear(hidden_dim, hidden_dim))

    def forward(self, distance: Tensor) -> Tensor:
        return self.mlp(self.rbf(distance))
