"""The yardstick's table of peaks and the kernels' least times.

Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at the
700 W limit). The bounds are copied from chip_smoke.py, each with its line:
`gate_bound_ms` (:594), `sfu_floor_ms` (:607), the dropout bound (PERF.md's
kernel table: 2 x the bytes of x over HBM bandwidth) and `cuda_time_ms`
(:576); the GEMM bound is new.
"""
from __future__ import annotations

PEAK_BYTES_S = 3.35e12          # HBM3 bandwidth
PEAK_BF16_S = 989e12            # dense bf16 tensor-core FLOP/s
PEAK_FP32_S = 67e12             # fp32 outside the tensor cores (TF32 off)
# special-function-unit (MUFU) results per clock per SM, compute capability
# 9.0 (CUDA C Programming Guide, arithmetic instruction throughput), and
# MUFU operations per silu gate element (one exp, one reciprocal)
MUFU_PER_CLK_SM = 16
MUFU_PER_SILU = 2

ELEM_BYTES = {"bf16": 2, "fp32": 4}
PEAK_FLOPS = {"bf16": PEAK_BF16_S, "fp32": PEAK_FP32_S}


def gate_bound_ms(B, Na, Nb, H, elem_bytes=4) -> float:
    """Least time for one paired silu launch (chip_smoke.py:594): bytes
    moved (inputs read once, outputs written once, `elem_bytes` per element:
    l1_a [B,Na,H], l1_b [B,Nb,H], r [B,Na,Nb], u, w2 [H] in; phi_ab, phi_ba
    out) over HBM bandwidth vs the fp32 operations (per gate element:
    mul+add pre-activation, exp, add, divide, multiply for silu, mul+add
    accumulation = 8, over 2 x B x Na x Nb x H elements; the kernel computes
    in fp32 for bf16 inputs too) over the fp32 peak."""
    nbytes = elem_bytes * (B * (Na + Nb) * H + 3 * B * Na * Nb + 2 * H)
    ops = 8 * 2 * B * Na * Nb * H
    return max(nbytes / PEAK_BYTES_S, ops / PEAK_FP32_S) * 1e3


def sfu_floor_ms(B, Na, Nb, H, sms, clock_hz) -> float:
    """Least time for one paired silu launch on the special-function units
    (chip_smoke.py:607): two MUFU operations per gate element (2 x B x Na x
    Nb x H of them) at MUFU_PER_CLK_SM per SM per clock, every SM at its
    maximum clock."""
    elems = 2 * B * Na * Nb * H
    return elems * MUFU_PER_SILU / (MUFU_PER_CLK_SM * sms * clock_hz) * 1e3


def dropout_bound_ms(numel: int, elem_bytes: int) -> float:
    """Least time for one dropout launch: x read once and the output
    written once over HBM bandwidth (PERF.md's kernel table)."""
    return 2 * numel * elem_bytes / PEAK_BYTES_S * 1e3


def gemm_bound_ms(batch: int, M: int, N: int, K: int, dtype: str) -> float:
    """Least time for batch products [M,K] x [K,N]: 2MNK operations at the
    dtype's peak against (MK + KN + MN) elements moved once over HBM."""
    ops = 2.0 * batch * M * N * K
    nbytes = ELEM_BYTES[dtype] * batch * (M * K + K * N + M * N)
    return max(ops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES_S) * 1e3


def cuda_time_ms(fn, iters=20, warmup=3) -> float:
    """Device time per call (chip_smoke.py:576). A spin kernel holds the
    stream while the calls are queued behind it, so the events time the
    device, not the host's launch rate."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(50_000_000)      # ~25 ms at 2 GHz
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters
