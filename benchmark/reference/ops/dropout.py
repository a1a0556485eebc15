"""Counter-based dropout, plain version only.

A frozen copy of the port's masks (fabind_tpu_torch/ops/dropout.py): an
element is kept iff word i % 4 of Philox4x32-10 at counter i // 4, under a
key derived from (seed, site, call, round), is >= floor(rate * 2**32); a
kept element is scaled by float32(1 / (1 - rate)). Computed in int64 tensor
arithmetic on x's device, with no kernel.
"""
from __future__ import annotations

import math
import zlib
from typing import Sequence, Tuple

import numpy as np
import torch

Tensor = torch.Tensor

MASK32 = 0xFFFFFFFF
PHILOX_M = (0xD2511F53, 0xCD9E8D57)
PHILOX_W = (0x9E3779B9, 0xBB67AE85)


def site_id(name: str) -> int:
    """The stable 32-bit id of a dropout site (or a host draw) from its
    qualified module name: crc32, the same in every process."""
    return zlib.crc32(name.encode())


def _mulhilo(a: int, b):
    """(hi, lo) 32-bit words of a * b for a 32-bit constant a and b a
    32-bit int or int64 tensor. A tensor's int64 product wraps modulo
    2**64, which keeps both words: the high one is the product's bits
    32..63, whatever sign the wrap gives it (one multiply where the port's
    version splits b into 16-bit halves; the words are the same)."""
    p = a * b
    if isinstance(p, int):
        return p >> 32, p & MASK32
    return (p >> 32) & MASK32, p & MASK32


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


def dropout(x: Tensor, seed: Tensor, rnd: Tensor, site: int, call: int,
            rate: float, row_mul: int = 1, row_add: int = 0) -> Tensor:
    """Inverted dropout of x under the key (seed, site, call, round); the
    backward is the same mask on the gradient (torch.where's own)."""
    return dropout_reference(x, seed, rnd, site, call, rate, row_mul,
                             row_add)
