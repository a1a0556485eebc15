"""Counter-based dropout: the masks are a pure function of their key.

    keep(i) = u32(i) >= floor(rate * 2**32)
    out     = where(keep, round_dtype(float32(x) * float32(1 / (1 - rate))), 0)

u32(i) is word i % 4 of Philox4x32-10 at counter i // 4 under a key that
Philox4x32-10 itself derives from (seed, site, call, round): the seed of a
stochastic forward (a sampling pass, a training step), a fixed id of the
dropout site (`site_id` of the module's qualified name), the call's index
within one recycle round (a module called more than once per round draws
once per call) and the round. Nothing depends on generator state, so

  - a traced program takes the seed and the round as tensors (torch.export
    holds no torch.Generator), and the exported sampling halves draw the
    masks of the live model (aot.py);
  - a layer recomputed in the backward (remat) draws the forward's masks;
  - the backward is the same function on the incoming gradient;
  - the CPU and the card draw the same masks, in fp32 and bf16.

Data parallelism splits a batch's rows (the leading axis) over replicas or
ranks, and each part must draw the masks of its rows in the whole batch. A
row map (row_mul, row_add) says where they sit: with R = numel / x.shape[0]
elements per row, local element i draws as global element
((i // R) * row_mul + row_add) * R + i % R. A serving replica's contiguous
block of rows from `start` maps with (1, start), a training rank's strided
rows r, r + N, ... with (N, r). The default (1, 0) is the identity and
keeps the unmapped code path: the kernel's 16-byte loop, one Philox counter
per 4 elements. A mapped tensor runs a second, simpler kernel, since groups
of 4 global elements straddle rows when R is not a multiple of 4.

`dropout` is the registered operator `torch.ops.fabind_tpu_torch.dropout`:
on CUDA tensors one launch of the hand-written kernel (csrc/dropout.cu,
counted in KERNEL.launches), on CPU tensors the plain version below, which
does Philox's 32 x 32 -> 64-bit products in int64 tensor arithmetic. The
scalar Philox (`philox4x32_10` on Python ints) also derives the host's draws:
the recycle counts and the training stage coin (`host_u32`). Inside
`writing_into(out)` the kernel writes `out` instead of a new tensor and
returns it (the docking graphs' eager calls, graphs.py).
"""
from __future__ import annotations

import contextlib
import ctypes
import math
import threading
import zlib
from typing import Iterator, Sequence, Tuple

import numpy as np
import torch

from fabind_tpu_torch.ops.cuda_build import CudaKernel

Tensor = torch.Tensor

MASK32 = 0xFFFFFFFF
PHILOX_M = (0xD2511F53, 0xCD9E8D57)
PHILOX_W = (0x9E3779B9, 0xBB67AE85)
_DTYPE_IDS = {torch.float32: 0, torch.bfloat16: 1}

_DROPOUT_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                 ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint32,
                 ctypes.c_uint32, ctypes.c_uint32, ctypes.c_float,
                 ctypes.c_int]
KERNEL = CudaKernel("dropout.cu", {
    "fabind_dropout": (_DROPOUT_ARGS + [ctypes.c_void_p], ctypes.c_int),
    # + row_len, row_mul, row_add before the stream
    "fabind_dropout_rows": (_DROPOUT_ARGS + [ctypes.c_longlong] * 3
                            + [ctypes.c_void_p], ctypes.c_int),
    "fabind_philox4x32": ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                           ctypes.c_void_p], ctypes.c_int),
})
# per thread: the tensor the next launch writes (writing_into), or None
_INTO = threading.local()


def site_id(name: str) -> int:
    """The stable 32-bit id of a dropout site (or a host draw) from its
    qualified module name: crc32, the same in every process."""
    return zlib.crc32(name.encode())


def _mulhilo(a: int, b):
    """(hi, lo) 32-bit words of a * b for a 32-bit constant a and b a
    32-bit int or int64 tensor: b is split into 16-bit halves so that no
    partial product leaves int64."""
    p_lo = a * (b & 0xFFFF)
    p_hi = a * (b >> 16)
    t = p_lo + ((p_hi & 0xFFFF) << 16)
    return (p_hi >> 16) + (t >> 32), t & MASK32


def philox4x32_10(ctr: Sequence, key: Sequence[int]) -> Tuple:
    """Philox4x32-10 (Random123) of counter words ctr[0..3] under key words
    key[0..1]. Counter words are Python ints or int64 tensors of 32-bit
    values; the output words are of the same kind."""
    c0, c1, c2, c3 = ctr
    k0, k1 = key
    for _ in range(10):
        hi0, lo0 = _mulhilo(PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + PHILOX_W[0]) & MASK32
        k1 = (k1 + PHILOX_W[1]) & MASK32
    return c0, c1, c2, c3


def derive_key(seed: int, site: int, call: int, rnd: int) -> Tuple[int, int]:
    """The Philox key of one draw: the first two words of Philox4x32-10 at
    counter (site, call, round) under the 64-bit seed."""
    seed &= 2**64 - 1
    rnd &= 2**64 - 1
    out = philox4x32_10((site & MASK32, call & MASK32, rnd & MASK32,
                         rnd >> 32), (seed & MASK32, seed >> 32))
    return out[0], out[1]


def host_u32(seed: int, site: int) -> int:
    """One 32-bit draw on the host, keyed by (seed, site): the recycle
    counts and the training stage coin."""
    return derive_key(seed, site, 0, 0)[0]


def threshold(rate: float) -> int:
    """An element is kept iff its 32-bit draw is >= floor(rate * 2**32)."""
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate {rate} not in [0, 1)")
    return int(math.floor(rate * 2.0**32))


def scale(rate: float) -> float:
    """float32(1 / (1 - rate)), the factor of a kept element."""
    return float(np.float32(1.0 / (1.0 - rate)))


def bits_reference(n: int, seed: int, site: int, call: int, rnd: int,
                   device, row_len: int = 1, row_mul: int = 1,
                   row_add: int = 0) -> Tensor:
    """The n 32-bit draws of one key as an int64 tensor on `device`; with a
    row map other than (1, 0), the draws of the global elements that rows
    of `row_len` elements map to (module docstring)."""
    k = derive_key(seed, site, call, rnd)
    if (row_mul, row_add) == (1, 0):
        c = torch.arange((n + 3) // 4, dtype=torch.int64, device=device)
        words = philox4x32_10((c & MASK32, c >> 32, 0, 0), k)
        return torch.stack(words, -1).reshape(-1)[:n]
    i = torch.arange(n, dtype=torch.int64, device=device)
    g = (i // row_len * row_mul + row_add) * row_len + i % row_len
    c = g >> 2
    words = torch.stack(philox4x32_10((c & MASK32, c >> 32, 0, 0), k), -1)
    return words.gather(1, (g & 3)[:, None])[:, 0]


def row_len(x: Tensor) -> int:
    """Elements per row of the leading axis (1 for a 0-d tensor)."""
    return x.numel() // x.shape[0] if x.dim() and x.shape[0] else 1


def dropout_reference(x: Tensor, seed: Tensor, rnd: Tensor, site: int,
                      call: int, rate: float, row_mul: int = 1,
                      row_add: int = 0) -> Tensor:
    """Plain version: the module docstring's function with int64 tensor
    arithmetic on x's device (it reads seed and round to the host)."""
    u = bits_reference(x.numel(), int(seed), site, call, int(rnd), x.device,
                       row_len(x), row_mul, row_add)
    keep = (u >= threshold(rate)).reshape(x.shape)
    s = torch.tensor(scale(rate), dtype=torch.float32, device=x.device)
    return torch.where(keep, (x.float() * s).to(x.dtype), 0.0)


def check_inputs(x: Tensor, seed: Tensor, rnd: Tensor, rate: float,
                 row_mul: int = 1, row_add: int = 0) -> None:
    """What the kernel takes: x fp32/bf16, seed and round one int64 each on
    x's device, 0 <= rate < 1, row_mul >= 1 and row_add >= 0. Raises on
    anything else."""
    if row_mul < 1 or row_add < 0:
        raise ValueError(f"dropout: row map ({row_mul}, {row_add}) needs "
                         f"row_mul >= 1 and row_add >= 0")
    if x.dtype not in _DTYPE_IDS:
        raise TypeError(f"dropout: x must be one of {list(_DTYPE_IDS)}, got "
                        f"{x.dtype}")
    for name, t in (("seed", seed), ("round", rnd)):
        if t.dtype != torch.int64 or t.numel() != 1 or t.device != x.device:
            raise ValueError(f"dropout: {name} must be one int64 on "
                             f"{x.device}, got {t.dtype} {tuple(t.shape)} "
                             f"on {t.device}")
    threshold(rate)


@torch.library.custom_op("fabind_tpu_torch::dropout", mutates_args=(),
                         device_types="cpu")
def dropout_op(x: Tensor, seed: Tensor, rnd: Tensor, site: int, call: int,
               rate: float, row_mul: int = 1, row_add: int = 0) -> Tensor:
    """Dropout as a registered operator: its CPU implementation is the
    plain version, its CUDA one the kernel (below), so a traced program
    records one call that dispatches on the device it runs on."""
    check_inputs(x, seed, rnd, rate, row_mul, row_add)
    return dropout_reference(x, seed, rnd, site, call, rate, row_mul,
                             row_add)


@dropout_op.register_kernel("cuda")
def _launch(x: Tensor, seed: Tensor, rnd: Tensor, site: int, call: int,
            rate: float, row_mul: int = 1, row_add: int = 0) -> Tensor:
    """One launch on the current stream: the unmapped kernel for the
    identity row map, the mapped one otherwise. Raises on bad input or a
    failed launch; counts the launch when it runs (a mapped one also under
    the variant "rows")."""
    check_inputs(x, seed, rnd, rate, row_mul, row_add)
    x = x.contiguous()
    out = getattr(_INTO, "out", None)
    if out is None or (out.shape, out.dtype, out.device) != (
            x.shape, x.dtype, x.device) or not out.is_contiguous():
        out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    mapped = (row_mul, row_add) != (1, 0)
    args = (x.data_ptr(), out.data_ptr(), x.numel(), seed.data_ptr(),
            rnd.data_ptr(), site & MASK32, call & MASK32, threshold(rate),
            scale(rate), _DTYPE_IDS[x.dtype])
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if mapped:
            err = KERNEL.lib.fabind_dropout_rows(
                *args, row_len(x), row_mul, row_add, stream)
        else:
            err = KERNEL.lib.fabind_dropout(*args, stream)
    if err != 0:
        raise RuntimeError(f"dropout kernel launch failed: CUDA error {err}")
    KERNEL.count_launch("rows" if mapped else None)
    return out


@contextlib.contextmanager
def writing_into(out: Tensor) -> Iterator[None]:
    """A launch on the card in this thread's block writes `out` and returns
    it, where x's shape, dtype and device are out's and out is contiguous
    (else a new tensor, as outside the block); the plain version always
    returns a new one."""
    prev, _INTO.out = getattr(_INTO, "out", None), out
    try:
        yield
    finally:
        _INTO.out = prev


@dropout_op.register_fake
def _fake(x, seed, rnd, site, call, rate, row_mul=1, row_add=0):
    return torch.empty_like(x, memory_format=torch.contiguous_format)


def _setup_context(ctx, inputs, output):
    _, seed, rnd, *key = inputs
    ctx.save_for_backward(seed, rnd)
    ctx.key = tuple(key)


def _backward(ctx, grad):
    # d out / d x = keep * scale: the same function of the gradient
    seed, rnd = ctx.saved_tensors
    return (dropout_op(grad.contiguous(), seed, rnd, *ctx.key),
            *(None,) * (2 + len(ctx.key)))


dropout_op.register_autograd(_backward, setup_context=_setup_context)


def dropout(x: Tensor, seed: Tensor, rnd: Tensor, site: int, call: int,
            rate: float, row_mul: int = 1, row_add: int = 0) -> Tensor:
    """Inverted dropout of x under the key (seed, site, call, round)
    through the registered operator: one launch of the CUDA kernel for a
    CUDA tensor (it launches or raises), the plain version for a CPU
    tensor. (row_mul, row_add) is the row map of a part of a batch split
    by data parallelism (module docstring)."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"dropout: unsupported device {x.device}")
    if (row_mul, row_add) == (1, 0):
        # the operator's defaults: a traced program records the call as
        # it did before row maps existed
        return dropout_op(x, seed, rnd, site, call, rate)
    return dropout_op(x, seed, rnd, site, call, rate, row_mul, row_add)


def philox_on_device(rows: np.ndarray) -> np.ndarray:
    """Test entry of the kernel's library: Philox4x32-10 of rows [m, 6]
    uint32 (counter words, key words) on the current CUDA device -> [m, 4]
    uint32."""
    rows = np.ascontiguousarray(rows, np.uint32)
    dev = torch.device("cuda", torch.cuda.current_device())
    inp = torch.from_numpy(rows.view(np.int32)).to(dev)
    out = torch.empty((rows.shape[0], 4), dtype=torch.int32, device=dev)
    err = KERNEL.lib.fabind_philox4x32(
        inp.data_ptr(), out.data_ptr(), rows.shape[0],
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"philox test kernel failed: CUDA error {err}")
    return out.cpu().numpy().view(np.uint32)
