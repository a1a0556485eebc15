"""Data-parallel serving and embedding on the CPU: replicas in threads
(parallel.dp.ReplicaSet), no process spawned.

- `DockingEngine(dp=2, device="cpu")`: dock_raw and dock_screen equal the
  one-replica engine's poses (1e-5 A: a block is a smaller product, so not
  bit for bit) and JAX's dp=2 engine's (the port-vs-JAX bound of
  test_torch_sample.py, 2e-4 A); dock_best_of with dropout on gives
  dp=1's winners (1e-5 A; the row map draws the whole batch's masks), and
  at dropout 0 JAX's dp=2 engine's. Each replica keeps its own
  protein-row cache; the refusals.
- `Esm2Model.embed_sequences(dp=2)` and `cli.preprocess esm --esm-dp 2`
  equal dp=1, in input order.
"""
from __future__ import annotations

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from common import TINY
from test_serve import make_raw

from fabind_tpu.config import preset as jax_preset
from fabind_tpu.data.types import FABindBatch as JaxBatch
from fabind_tpu.models.fabind import make_model as jax_make_model
from fabind_tpu.serve import DockingEngine as JaxEngine

from fabind_tpu_torch.cli import preprocess as cli_preprocess
from fabind_tpu_torch.config import preset
from fabind_tpu_torch.data.types import dummy_arrays
from fabind_tpu_torch.models.esm2 import Esm2Config, Esm2Model
from fabind_tpu_torch.parallel.dp import ReplicaSet
from fabind_tpu_torch.serve import DockingEngine
from fabind_tpu_torch.train.convert import state_dict_from_flax

ATOL_JAX = 2e-4
ATOL_DP = 1e-5
KW = dict(TINY, mean_layers=2)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flax_params(preset_name, kw, is_plus):
    jcfg = jax_preset(preset_name, **kw)
    arrays = dummy_arrays(preset(preset_name, **kw).shapes, batch_size=2,
                          seed=1, n_lig_valid=9, n_prot_valid=40)
    jbatch = JaxBatch(**{k: jnp.asarray(v) for k, v in arrays.items()})
    jmodel = jax_make_model(jcfg)
    k = jax.random.PRNGKey(0)
    params = jax.tree_util.tree_map(np.asarray, jax.jit(lambda: jmodel.init(
        {"params": k, "dropout": k, "sample": k}, jbatch, train=False,
        stage=2))()["params"])
    return params, state_dict_from_flax(params, is_plus=is_plus)


def _raws(n=6):
    return [make_raw(n=5 + (i % 3), nr=20 + 4 * i, seed=30 + i)
            for i in range(n)]


def _close(a_poses, b_poses, atol):
    assert len(a_poses) == len(b_poses)
    for a, b in zip(a_poses, b_poses):
        assert a.error is None and b.error is None
        np.testing.assert_allclose(a.coords, b.coords, atol=atol, rtol=0)
        assert abs(a.confidence - b.confidence) <= atol


@pytest.fixture(scope="module")
def base():
    params, sd = _flax_params("fabind", TINY, False)
    cfg, jcfg = preset("fabind", **TINY), jax_preset("fabind", **TINY)
    eng1 = DockingEngine(cfg, state_dict=sd, batch_size=4, bf16=False,
                         device="cpu")
    eng2 = DockingEngine(cfg, state_dict=sd, batch_size=4, bf16=False,
                         device="cpu", dp=2)
    jeng2 = JaxEngine(jcfg, params=params, batch_size=4, bf16=False, dp=2)
    return eng1, eng2, jeng2


def test_dock_raw_dp2_equals_dp1_and_jax_dp2(base):
    eng1, eng2, jeng2 = base
    raws = _raws()
    got = eng2.dock_raw(raws)
    _close(got, eng1.dock_raw(raws), ATOL_DP)
    _close(got, jeng2.dock_raw(raws), ATOL_JAX)
    # each replica caches the protein rows of its own block
    assert len(eng2.devices) == 2 and all(len(c) for c in eng2._prot_rows)
    _close(eng2.dock_raw(raws), got, 0.0)     # the caches warm: the same


def test_dock_screen_dp2_equals_dp1_and_jax_dp2(base):
    eng1, eng2, jeng2 = base
    raws = _raws(5)
    protein = {k: raws[0][k] for k in ("protein_xyz", "esm_feat")}
    ligs = [{k: r[k] for k in ("lig_coords", "lig_feats", "bond_edges",
                               "las_mask", "rdkit_coords")} for r in raws]
    got = eng2.dock_screen(protein, ligs)
    _close(got, eng1.dock_screen(protein, ligs), ATOL_DP)
    _close(got, jeng2.dock_screen(protein, ligs), ATOL_JAX)
    _close(got, eng2.dock_raw([dict(lig, **protein) for lig in ligs]), 0.0)


@pytest.fixture(scope="module")
def plus():
    kw0 = dict(KW, dropout=0.0, random_n_iter=False)
    params, sd = _flax_params("fabind_plus_sampling", kw0, True)
    return params, sd, kw0


def test_dock_best_of_dp2_with_dropout_equals_dp1(plus):
    """Dropout, drawn recycle counts and DBSCAN centers on: the replicas
    draw the whole batch's masks at their rows, and the host's cluster
    picks run over the whole batch, so the winners are dp=1's."""
    _, sd, _ = plus
    cfg = preset("fabind_plus_sampling", **KW)
    assert cfg.model.dropout > 0 and cfg.model.use_clustering
    raws = _raws(5)
    one = DockingEngine(cfg, state_dict=sd, batch_size=4, bf16=False,
                        device="cpu")
    two = DockingEngine(cfg, state_dict=sd, batch_size=4, bf16=False,
                        device="cpu", dp=2, post_optim_steps=0)
    got = two.dock_best_of(raws, sample_size=3, seed=6)
    _close(got, one.dock_best_of(raws, sample_size=3, seed=6), ATOL_DP)
    other = two.dock_best_of(raws, sample_size=3, seed=7)
    assert max(float(np.abs(a.coords - b.coords).max())
               for a, b in zip(got, other)) > 1e-4


def test_dock_best_of_dp2_dropout_off_equals_jax_dp2(plus):
    params, sd, kw0 = plus
    raws = _raws(4)
    jcfg, cfg = (jax_preset("fabind_plus_sampling", **kw0),
                 preset("fabind_plus_sampling", **kw0))
    want = JaxEngine(jcfg, params=params, batch_size=4, bf16=False,
                     dp=2).dock_best_of(raws, sample_size=2, seed=4)
    got = DockingEngine(cfg, state_dict=sd, batch_size=4, bf16=False,
                        device="cpu", dp=2).dock_best_of(raws, sample_size=2,
                                                         seed=4)
    _close(got, want, ATOL_JAX)


def test_dp_engine_refusals(monkeypatch):
    cfg = preset("fabind", **TINY)
    with pytest.raises(ValueError, match="not divisible by dp 2"):
        DockingEngine(cfg, batch_size=3, device="cpu", dp=2)
    with pytest.raises(ValueError, match="dp 3 with 2 devices"):
        DockingEngine(cfg, batch_size=6, device=["cpu", "cpu"], dp=3)
    eng = DockingEngine(cfg, batch_size=4, device=["cpu", "cpu"])
    assert len(eng.replicas) == 2 and eng.model is eng.replicas.modules[0]
    assert eng.replicas.modules[1] is not eng.model
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DockingEngine(cfg, batch_size=4, dp=2)


def test_replica_set_threads_order_and_modes():
    """map runs one call per replica in its own thread, under the caller's
    grad mode, and gathers in row order; an exception reaches the
    caller."""
    rs = ReplicaSet(torch.nn.Linear(2, 2), ["cpu"] * 3)
    seen = rs.map(lambda r, x: (threading.current_thread().name,
                                torch.is_grad_enabled(), x),
                  [10, 11, 12])
    assert [s[2] for s in seen] == [10, 11, 12]
    assert len({s[0] for s in seen}) == 3
    with torch.no_grad():
        assert not any(g for _, g, _ in rs.map(
            lambda r: (None, torch.is_grad_enabled(), None)))
    out = rs.gather([torch.full((2,), float(r)) for r in range(3)])
    assert out.tolist() == [0, 0, 1, 1, 2, 2]
    assert [s.start for s in rs.blocks(6)] == [0, 2, 4]
    with pytest.raises(ValueError, match="not divisible"):
        rs.blocks(4)

    def boom(r):
        raise KeyError(r)

    with pytest.raises(KeyError):
        rs.map(boom)
    rs.close()


# ----------------------------------------------------------------- ESM2
ESM_TOY = Esm2Config(hidden_size=40, num_layers=1, num_heads=20,
                     intermediate_size=16)
SEQS = ["MKTAYIAKQR", "GSHMLE" * 30, "ACDEFGHIKLMNPQRSTVWY", "MK",
        "W" * 130]


def _encoder():
    enc = Esm2Model(ESM_TOY)
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in enc.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.1)
    return enc.eval()


def test_embed_sequences_dp2_equals_dp1():
    enc = _encoder()
    want = enc.embed_sequences(SEQS, batch_size=2)
    got = enc.embed_sequences(SEQS, batch_size=2, dp=2)
    held = ReplicaSet(enc, ["cpu", "cpu"])
    again = enc.embed_sequences(SEQS, batch_size=1, dp=held)
    held.close()
    for w, g, a, s in zip(want, got, again, SEQS):
        assert g.shape == w.shape == (len(s), 40)
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=0)
        np.testing.assert_allclose(a, w, atol=1e-5, rtol=0)


def test_preprocess_esm_dp2_equals_dp1(tmp_path):
    sd = str(tmp_path / "esm.pt")
    torch.save(_encoder().state_dict(), sd)
    fasta = tmp_path / "seqs.fasta"
    fasta.write_text("".join(f">p{i}\n{s}\n" for i, s in enumerate(SEQS)))
    for dp in (1, 2):
        cli_preprocess.main(["esm", "--seqs", str(fasta), "--out",
                             str(tmp_path / f"dp{dp}"), "--esm-weights", sd,
                             "--esm-batch", "2", "--esm-dp", str(dp),
                             "--device", "cpu"])
    for i, s in enumerate(SEQS):
        a = np.load(tmp_path / "dp1" / f"p{i}.npy")
        b = np.load(tmp_path / "dp2" / f"p{i}.npy")
        assert a.shape == b.shape == (len(s), 40)
        np.testing.assert_allclose(b, a, atol=1e-5, rtol=0)
