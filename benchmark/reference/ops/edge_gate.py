"""The InterAttention coordinate gate, plain version only.

    phi[b, d, n] = sum_h w2[h] * act(l1_v[b, n, h] + r[b, d, n] * u[h])

A frozen copy of the port's plain gate (fabind_tpu_torch/ops/edge_gate.py):
the [B, D, N, H] pre-activation is built in fp32; autograd gives the
backward.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

Tensor = torch.Tensor

_ACT_FNS = {"silu": F.silu, "relu": F.relu}


def phi_rank1_reference(l1_v: Tensor, r: Tensor, u: Tensor, w2: Tensor,
                        act: str = "silu") -> Tensor:
    """Plain version: [B,N,H], [B,D,N], [H], [H] -> [B,D,N] in r's dtype,
    fp32 arithmetic (the kernel's contract)."""
    f = torch.float32
    pre = l1_v.to(f)[:, None, :, :] + r.to(f)[..., None] * u.to(f)
    return torch.einsum("bdnh,h->bdn", _ACT_FNS[act](pre), w2.to(f)).to(r.dtype)


def phi_rank1_pair_reference(l1_a: Tensor, l1_b: Tensor, r: Tensor,
                             u: Tensor, w2: Tensor, act: str = "silu"
                             ) -> Tuple[Tensor, Tensor]:
    """Plain version of both directions: (phi_ab [B,Na,Nb], phi_ba
    [B,Nb,Na]) from l1_a [B,Na,H], l1_b [B,Nb,H], r [B,Na,Nb]."""
    return (phi_rank1_reference(l1_b, r, u, w2, act),
            phi_rank1_reference(l1_a, r.transpose(1, 2), u, w2, act))


phi_rank1_pair = phi_rank1_pair_reference
