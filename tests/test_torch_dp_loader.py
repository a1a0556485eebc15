"""Data parallelism's host side against the JAX package, on the CPU, and
the row-mapped dropout masks: no process is spawned here.

- `Loader(host_shard=(rank, world))` yields the JAX Loader's batches per
  rank bit for bit, for 2 and 4 ranks with one bucket (the strided slice
  with count-stable substitution) and two (the global schedule), over
  tests/test_multihost_buckets.py's MixedSrc samples.
- The plain dropout's row map: a part of a batch, mapped with (1, start)
  (a serving replica's block) or (N, r) (a training rank's rows), draws the
  whole batch's masks at its rows bit for bit, also when the elements per
  row are not a multiple of 4.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from test_data import make_raw
from test_multihost_buckets import MixedSrc

from fabind_tpu.config import preset as jax_preset
from fabind_tpu.data.dataset import Loader as JaxLoader
from fabind_tpu.data.types import FABindBatch as JaxBatch

from fabind_tpu_torch.config import preset
from fabind_tpu_torch.data.dataset import Loader
from fabind_tpu_torch.models.layers import RowMap
from fabind_tpu_torch.ops import dropout as D
from fabind_tpu_torch.parallel.dp import (dp_devices, interleave_rows,
                                          strided_rows)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs():
    kw = dict(max_ligand=24, max_pocket=32, max_protein=64, ctx_k=8,
              ctx_k_whole=8, batch_size=2)
    return preset("fabind", **kw), jax_preset("fabind", **kw)


def _buckets(cfg, two: bool):
    if not two:
        return None
    small = dataclasses.replace(cfg.shapes, max_ligand=8, max_pocket=32,
                                max_protein=32)
    return [small, cfg.shapes]


class OversizeSrc(MixedSrc):
    """MixedSrc with sample 3 too large for every bucket."""

    def get(self, idx):
        r = super().get(idx)
        if idx == 3:
            r = dict(make_raw(n=40, nr=30, seed=3), pdb="x3")
        return r


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("two_buckets", [False, True])
def test_host_shard_equals_jax_loader(world, two_buckets):
    """Every rank's batches (arrays and meta), its len() and n_dropped
    equal the JAX Loader's; every rank yields the same number of batches
    in the same buckets; a resume (skip_batches=1) yields the tail."""
    cfg, jcfg = _cfgs()
    src = OversizeSrc()
    counts, dropped = [], 0
    for rank in range(world):
        mine = Loader(src, range(12), cfg, seed=5,
                      buckets=_buckets(cfg, two_buckets),
                      host_shard=(rank, world))
        ref = JaxLoader(src, range(12), jcfg, seed=5,
                        buckets=_buckets(jcfg, two_buckets),
                        host_shard=(rank, world))
        assert len(mine) == len(ref)
        got = list(mine.epoch(2, with_meta=True))
        want = list(ref.epoch(2, with_meta=True))
        assert len(got) == len(want) >= 2
        for (a, ma), (b, mb) in zip(got, want):
            assert ma["pdb"] == mb["pdb"] and ma["n_valid"] == mb["n_valid"]
            assert ma["cfg"].shapes.max_ligand == mb["cfg"].shapes.max_ligand
            for f in dataclasses.fields(JaxBatch):
                x, y = a[f.name], getattr(b, f.name)
                assert (x is None) == (y is None), f.name
                if x is not None:
                    np.testing.assert_array_equal(x, np.asarray(y),
                                                  err_msg=f.name)
        assert mine.n_dropped == ref.n_dropped
        dropped += mine.n_dropped
        counts.append([m["cfg"].shapes.max_ligand for _, m in got])
        tail = list(mine.epoch(2, with_meta=True, skip_batches=1))
        assert [m["pdb"] for _, m in tail] == [m["pdb"] for _, m in got[1:]]
    assert all(c == counts[0] for c in counts), counts
    # the oversize sample: dropped by every rank under the global schedule,
    # replaced on the one rank that drew it with one bucket
    assert dropped == (world if two_buckets else 1)


def test_strided_rows_and_interleave_invert():
    arrays = {"a": np.arange(24).reshape(8, 3), "b": None}
    parts = [strided_rows(arrays, r, 4) for r in range(4)]
    np.testing.assert_array_equal(parts[1]["a"], arrays["a"][1::4])
    back = interleave_rows(parts)
    np.testing.assert_array_equal(back["a"], arrays["a"])
    assert back["b"] is None


def test_dp_devices_on_the_cpu_and_without_cards(monkeypatch):
    assert dp_devices("cpu", 3) == [torch.device("cpu")] * 3
    assert dp_devices("cpu", 0) == [torch.device("cpu")]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dp_devices(None, 2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="needs 2 cards; 1 visible"):
        dp_devices("cuda", 2)


# ------------------------------------------------------------- dropout
@pytest.mark.parametrize("shape", [(8, 5, 3), (6, 1025), (4, 162, 7)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_row_mapped_dropout_equals_global_rows(shape, dtype):
    """(N, r) strided rows and (1, start) blocks draw the whole tensor's
    mask at their rows, bit for bit; R = elements per row is odd or not a
    multiple of 4 in every case, so groups of 4 draws straddle rows."""
    g = torch.Generator().manual_seed(0)
    x = (torch.rand(shape, generator=g) * 4 - 2).to(dtype)
    seed, rnd = torch.tensor(-(2 ** 61) + 7), torch.tensor(3)
    full = D.dropout(x, seed, rnd, 11, 2, 0.3)
    B = shape[0]
    for world in (2, 4):
        if B % world:
            continue
        for r in range(world):
            part = D.dropout(x[r::world].contiguous(), seed, rnd, 11, 2, 0.3,
                             world, r)
            assert torch.equal(part, full[r::world]), (world, r)
            k = B // world
            block = D.dropout(x[r * k:(r + 1) * k].contiguous(), seed, rnd,
                              11, 2, 0.3, 1, r * k)
            assert torch.equal(block, full[r * k:(r + 1) * k]), (world, r)
    # the identity map is the unmapped path
    assert torch.equal(D.dropout(x, seed, rnd, 11, 2, 0.3, 1, 0), full)
    # a part's own unmapped masks are other masks (the correlated-masks
    # trap the map removes)
    assert not torch.equal(D.dropout(x[1::2].contiguous(), seed, rnd, 11, 2,
                                     0.3), full[1::2])


def test_row_mapped_dropout_gradient_and_refusals():
    x = torch.randn(4, 9, requires_grad=True)
    seed, rnd = torch.tensor(5), torch.tensor(0)
    y = D.dropout(x, seed, rnd, 3, 0, 0.5, 2, 1)
    (gx,) = torch.autograd.grad(y.sum(), x)
    keep = D.dropout(torch.ones(4, 9), seed, rnd, 3, 0, 0.5, 2, 1) != 0
    assert torch.equal(gx, keep.float() * D.scale(0.5))
    with pytest.raises(ValueError, match="row map"):
        D.dropout(x, seed, rnd, 3, 0, 0.5, 0, 0)
    torch.library.opcheck(D.dropout_op, (x.detach(), seed, rnd, 3, 0, 0.5,
                                         2, 1))


def test_row_map_take_and_mean():
    rows = RowMap(2, 1, 6)
    t = torch.arange(6.0)
    assert rows.take(t, 3).tolist() == [1.0, 3.0, 5.0]
    assert RowMap(1, 2, 6).take(t, 2).tolist() == [2.0, 3.0]
    assert RowMap().take(t, 6) is t
    assert float(RowMap().mean(t)) == 2.5
    assert float(RowMap(2, 0, 6, lambda v: v * 2).mean(t[:3])) == 1.0
