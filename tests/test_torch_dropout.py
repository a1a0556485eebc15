"""The counter-based dropout operator (fabind_tpu_torch/ops/dropout.py) on
the CPU: its Philox4x32-10 against Random123's known-answer vectors, the
keep rule's statistics, masks that depend on the key alone (the same in
fp32 and bf16, distinct across sites, calls, rounds and seeds), the
registered operator under torch.library.opcheck, its gradient, and the host
draws (recycle counts, stage coin) built on it. The CUDA kernel is held to
the same function in tests/test_torch_cuda.py and chip_smoke.py.
"""
from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from fabind_tpu_torch.models.layers import (Dropout, dropout_rng,
                                            dropout_seed, recycle_count,
                                            recycle_round, stage_coin)
from fabind_tpu_torch.ops import dropout as D

# Random123's kat_vectors for philox4x32_10: (counter, key) -> output
KAT = [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's torch work: the suite runs in
    parallel workers that would otherwise oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _drop(x, seed=3, site=11, call=0, rnd=0, rate=0.1):
    return D.dropout(x, torch.tensor(seed), torch.tensor(rnd), site, call,
                     rate)


@pytest.mark.parametrize("ctr,key,want", KAT)
def test_philox_known_answers(ctr, key, want):
    """The scalar Philox and the int64 tensor Philox of the plain version
    give Random123's outputs."""
    assert D.philox4x32_10(ctr, key) == want
    t = [torch.tensor([c, 0], dtype=torch.int64) for c in ctr]
    got = D.philox4x32_10(t, key)
    assert [int(w[0]) for w in got] == list(want)
    assert all(0 <= int(w.min()) and int(w.max()) <= D.MASK32 for w in got)


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_keep_share_within_binomial_bounds(rate):
    n = 200_000
    y = _drop(torch.ones(n), rate=rate)
    kept = int((y != 0).sum())
    sd = math.sqrt(n * rate * (1 - rate))
    assert abs(kept - n * (1 - rate)) < 5 * sd
    # kept elements are x times float32(1 / (1 - rate)), bit for bit
    s = np.float32(1 / (1 - rate))
    assert torch.equal(y[y != 0], torch.full((kept,), float(s)))
    assert D.threshold(rate) == math.floor(rate * 2**32)
    with pytest.raises(ValueError):
        D.threshold(1.0)


def test_fp32_and_bf16_draw_one_mask():
    """The mask depends on the key alone: fp32 and bf16 inputs keep the same
    elements, and each keeps round(float32(x) * scale) in its own dtype.
    A prefix of the elements draws the mask of the whole tensor's prefix
    (the counter is the flat index), so ragged lengths draw alike."""
    g = torch.Generator().manual_seed(0)
    x = torch.rand(4099, generator=g) + 0.5
    y32 = _drop(x)
    y16 = _drop(x.bfloat16())
    assert y16.dtype == torch.bfloat16
    assert torch.equal(y32 != 0, y16 != 0)
    s = torch.tensor(D.scale(0.1))
    keep = y32 != 0
    assert torch.equal(y32[keep], x[keep] * s)
    assert torch.equal(y16[keep], (x.bfloat16().float()[keep] * s).bfloat16())
    assert torch.equal(_drop(x[:4097]), y32[:4097])
    assert torch.equal(_drop(x.reshape(4099, 1)).reshape(-1), y32)


@pytest.mark.parametrize("field", ["seed", "site", "call", "rnd"])
def test_every_key_field_changes_the_mask(field):
    x = torch.ones(4096)
    base = _drop(x)
    other = _drop(x, **{field: {"seed": 4, "site": 12, "call": 1,
                                "rnd": 1}[field]})
    assert not torch.equal(base != 0, other != 0)
    # seeds beyond int64's range are taken as their two's complement
    assert torch.equal(_drop(x, seed=-1),
                       D.dropout_reference(x, torch.tensor(-1),
                                           torch.tensor(0), 11, 0, 0.1))


def test_opcheck_with_and_without_grad():
    op = torch.ops.fabind_tpu_torch.dropout.default
    x = torch.randn(3, 37, generator=torch.Generator().manual_seed(1))
    for dtype in (torch.float32, torch.bfloat16):
        args = (x.to(dtype), torch.tensor(5), torch.tensor(2), 7, 1, 0.25)
        torch.library.opcheck(op, args)
        torch.library.opcheck(op, (args[0].clone().requires_grad_(),
                                   *args[1:]))


def test_gradient_is_grad_times_mask_times_scale():
    x = torch.randn(513, generator=torch.Generator().manual_seed(2),
                    requires_grad=True)
    y = _drop(x, rate=0.5)
    g = torch.randn(513, generator=torch.Generator().manual_seed(3))
    (gx,) = torch.autograd.grad(y, x, g)
    keep = (y != 0).float()
    assert torch.equal(gx, g * keep * torch.tensor(D.scale(0.5)))


def test_module_keys_by_scope_round_and_call():
    """A Dropout draws under its site, the call index and the block's
    round; dropout_rng and dropout_seed of the same seed draw alike; the
    seed tensor and the int seed too."""
    drop = Dropout(0.5).eval()
    drop.site = D.site_id("some.site")
    x = torch.ones(1024)
    with dropout_rng(torch.Generator().manual_seed(9)):
        a = drop(x)
        b = drop(x, 1)
        with recycle_round(3):
            c = drop(x)
    with dropout_seed(9):
        assert torch.equal(drop(x), a)
    with dropout_seed(torch.tensor(9)):
        assert torch.equal(drop(x), a)
        with recycle_round(torch.tensor(3)):
            assert torch.equal(drop(x), c)
    assert not torch.equal(a, b) and not torch.equal(a, c)
    assert torch.equal(a, _drop(x, seed=9, site=drop.site, rate=0.5))


def test_host_draws():
    """Recycle counts are uniform over 1..n_iter per (seed, site) and the
    stage coin lies in [0, 1)."""
    counts = [recycle_count(s, D.site_id("complex_model"), 8)
              for s in range(4000)]
    assert set(counts) == set(range(1, 9))
    assert max(np.bincount(counts)[1:]) < 600          # 500 expected
    assert recycle_count(5, 1, 1) == 1
    assert counts != [recycle_count(s, D.site_id("pocket_pred_model"), 8)
                      for s in range(4000)]
    coins = [stage_coin(s) for s in range(2000)]
    assert 0 <= min(coins) and max(coins) < 1
    assert abs(np.mean(coins) - 0.5) < 0.05
