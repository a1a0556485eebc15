"""The InterAttention coordinate gate and its CUDA kernel.

    phi[b, d, n] = sum_h w2[h] * act(l1_v[b, n, h] + r[b, d, n] * u[h])

l1_v = coord_mlp.linear1(v_node) is a per-node projection and (u, w2) are the
rank-1 radial correction and the output weights, so the [B, D, N, H]
pre-activation never has to exist (fabind_tpu/ops/pallas/edge_gate.py is the
TPU kernel this replaces). One InterAttention layer needs the gate in both
attention directions over the same r [B, Na, Nb], u and w2:

    phi_ab[b, i, j] = sum_h w2[h] * act(l1_b[b, j, h] + r[b, i, j] * u[h])
    phi_ba[b, j, i] = sum_h w2[h] * act(l1_a[b, i, h] + r[b, i, j] * u[h])

`phi_rank1_pair` computes both in one launch of the hand-written CUDA kernel
(csrc/edge_gate.cu) on CUDA tensors, reading r once and never transposing it;
on CPU tensors it takes its plain PyTorch version. Both are implementations
of one registered operator, `torch.ops.fabind_tpu_torch.edge_gate_pair`, so
torch.export can trace the model through it (aot.py). The backward
recomputes the plain version's VJP, as the TPU kernel's custom_vjp does.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch
import torch.nn.functional as F

from fabind_tpu_torch.ops.cuda_build import CudaKernel

Tensor = torch.Tensor

_ACT_FNS = {"silu": F.silu, "relu": F.relu}
_ACT_IDS = {"silu": 0, "relu": 1}
_DTYPE_IDS = {torch.float32: 0, torch.bfloat16: 1}
# csrc/edge_gate.cu: a tile is TI x TJ cells of r; H is staged whole in
# shared memory, which bounds it (227 KB a block)
TILE_I, TILE_J = 8, 16
MAX_H = 2048
_MAX_TILES = 2**31 - 1

KERNEL = CudaKernel("edge_gate.cu", {
    "fabind_edge_gate_pair": ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
                              + [ctypes.c_void_p], ctypes.c_int),
})


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


def phi_rank1_vjp(l1_v: Tensor, r: Tensor, u: Tensor, w2: Tensor, act: str,
                  grad_out: Tensor):
    """Gradients of one direction of the gate w.r.t. (l1_v, r, u, w2): the
    VJP of the plain version, recomputed from the saved inputs."""
    with torch.enable_grad():
        args = [t.detach().requires_grad_() for t in (l1_v, r, u, w2)]
        out = phi_rank1_reference(*args, act=act)
        return torch.autograd.grad(out, args, grad_out)


def phi_rank1_pair_vjp(l1_a: Tensor, l1_b: Tensor, r: Tensor, u: Tensor,
                       w2: Tensor, act: str, g_ab: Tensor, g_ba: Tensor):
    """Gradients of phi_rank1_pair w.r.t. (l1_a, l1_b, r, u, w2): the two
    plain VJPs, with r's and the shared weights' gradients summed."""
    gb, gr_ab, gu_ab, gw_ab = phi_rank1_vjp(l1_b, r, u, w2, act, g_ab)
    ga, gr_ba, gu_ba, gw_ba = phi_rank1_vjp(l1_a, r.transpose(1, 2), u, w2,
                                            act, g_ba)
    return (ga, gb, gr_ab + gr_ba.transpose(1, 2), gu_ab + gu_ba,
            gw_ab + gw_ba)


def check_inputs(l1_a: Tensor, l1_b: Tensor, r: Tensor, u: Tensor,
                 w2: Tensor) -> Tuple[int, int, int, int]:
    """What the kernel takes: one device, one dtype of fp32/bf16, contiguous
    l1_a [B,Na,H], l1_b [B,Nb,H], r [B,Na,Nb], u [H], w2 [H], H <= MAX_H
    and a tile count that fits the launch. Returns (B, Na, Nb, H); raises
    on anything else."""
    tensors = (l1_a, l1_b, r, u, w2)
    if any(t.device != r.device for t in tensors):
        raise ValueError("edge_gate: inputs on different devices")
    if r.dtype not in _DTYPE_IDS or any(t.dtype != r.dtype for t in tensors):
        raise TypeError(f"edge_gate: inputs must share one dtype of "
                        f"{list(_DTYPE_IDS)}, got {[t.dtype for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("edge_gate: inputs must be contiguous")
    if (l1_a.dim() != 3 or l1_b.dim() != 3 or r.dim() != 3 or u.dim() != 1
            or w2.dim() != 1):
        raise ValueError("edge_gate: expected l1_a [B,Na,H], l1_b [B,Nb,H], "
                         "r [B,Na,Nb], u [H], w2 [H]")
    B, Nb, H = l1_b.shape
    Na = r.shape[1]
    if (r.shape != (B, Na, Nb) or u.shape != (H,) or w2.shape != (H,)
            or l1_a.shape != (B, Na, H)):
        raise ValueError(
            f"edge_gate: shape mismatch l1_a {tuple(l1_a.shape)} l1_b "
            f"{tuple(l1_b.shape)} r {tuple(r.shape)} u {tuple(u.shape)} "
            f"w2 {tuple(w2.shape)}")
    if H > MAX_H:
        raise ValueError(f"edge_gate: H={H} exceeds {MAX_H} (shared memory)")
    if B * -(-Na // TILE_I) * -(-Nb // TILE_J) > _MAX_TILES:
        raise ValueError(f"edge_gate: B={B}, Na={Na}, Nb={Nb} exceed the "
                         f"launch grid")
    return B, Na, Nb, H


@torch.library.custom_op("fabind_tpu_torch::edge_gate_pair",
                         mutates_args=(), device_types="cpu")
def edge_gate_pair(l1_a: Tensor, l1_b: Tensor, r: Tensor, u: Tensor,
                   w2: Tensor, act: str) -> Tuple[Tensor, Tensor]:
    """The gate as a registered operator: its CPU implementation is the
    plain version, its CUDA one the kernel (below), so the device choice is
    the dispatcher's and a traced program (torch.export) records one call
    that dispatches on the device it runs on."""
    return phi_rank1_pair_reference(l1_a, l1_b, r, u, w2, act)


@edge_gate_pair.register_kernel("cuda")
def _launch(l1_a: Tensor, l1_b: Tensor, r: Tensor, u: Tensor, w2: Tensor,
            act: str) -> Tuple[Tensor, Tensor]:
    """One launch on the current stream: (phi_ab, phi_ba). Raises on bad
    input or a failed launch; counts the launch when it runs."""
    B, Na, Nb, H = check_inputs(l1_a, l1_b, r, u, w2)
    out_ab = torch.empty_like(r)
    out_ba = torch.empty((B, Nb, Na), dtype=r.dtype, device=r.device)
    if r.numel() == 0:
        return out_ab, out_ba
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        err = KERNEL.lib.fabind_edge_gate_pair(
            l1_a.data_ptr(), l1_b.data_ptr(), r.data_ptr(), u.data_ptr(),
            w2.data_ptr(), out_ab.data_ptr(), out_ba.data_ptr(), B, Na, Nb,
            H, _ACT_IDS[act], _DTYPE_IDS[r.dtype], stream)
    if err != 0:
        raise RuntimeError(f"edge_gate kernel launch failed: CUDA error {err}")
    KERNEL.count_launch()
    return out_ab, out_ba


@edge_gate_pair.register_fake
def _fake(l1_a, l1_b, r, u, w2, act):
    B, Na, Nb = r.shape
    return r.new_empty((B, Na, Nb)), r.new_empty((B, Nb, Na))


def _setup_context(ctx, inputs, output):
    *tensors, act = inputs
    ctx.save_for_backward(*tensors)
    ctx.act = act


def _backward(ctx, g_ab, g_ba):
    return (*phi_rank1_pair_vjp(*ctx.saved_tensors, ctx.act, g_ab, g_ba),
            None)


edge_gate_pair.register_autograd(_backward, setup_context=_setup_context)


def phi_rank1_pair(l1_a: Tensor, l1_b: Tensor, r: Tensor, u: Tensor,
                   w2: Tensor, act: str = "silu") -> Tuple[Tensor, Tensor]:
    """Both directions, (phi_ab [B,Na,Nb], phi_ba [B,Nb,Na]), through the
    registered operator: one launch of the CUDA kernel for CUDA tensors (it
    launches or raises), the plain version for CPU tensors."""
    if act not in _ACT_IDS:
        raise ValueError(f"edge_gate: act must be one of {list(_ACT_IDS)}")
    if r.device.type not in ("cpu", "cuda"):
        raise ValueError(f"edge_gate: unsupported device {r.device}")
    return edge_gate_pair(l1_a, l1_b, r, u, w2, act)
