"""The port's training loop against the JAX package, on the CPU: optimizer
steps (AdamW, the global-norm clip, the warmup schedule, gradient
accumulation) against make_train_step's parameters; the Loader's batches
against the JAX Loader's, bit for bit; torsion noise; MetricAccumulator;
and the port alone: TrainCheckpointer, and `cli.train` preempted by a
signal and resumed, in process.

Optimizer tolerance: parameters within 2e-6 (absolute) of JAX's after each
update. The first Adam updates are about lr * sign(gradient), lr = 5e-5 in
the warmup; the two packages' gradients agree to ~1e-6 relative, so the
updates agree to well under a step.
"""
from __future__ import annotations

import dataclasses
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from common import TINY_XS
from test_data import make_raw

import fabind_tpu.ops.gumbel as jax_gumbel
from fabind_tpu.config import preset as jax_preset
from fabind_tpu.data.dataset import Loader as JaxLoader
from fabind_tpu.data.dataset import NPZSource as JaxNPZSource
from fabind_tpu.data.torsion import randomize_torsions as jax_torsions
from fabind_tpu.data.types import FABindBatch as JaxBatch
from fabind_tpu.train.trainer import create_train_state, make_train_step
from fabind_tpu.utils.metrics import MetricAccumulator as JaxAccumulator

from fabind_tpu_torch.cli import train as cli_train
from fabind_tpu_torch.config import preset
from fabind_tpu_torch.data.dataset import Loader, NPZSource, open_source
from fabind_tpu_torch.data.torsion import randomize_torsions
from fabind_tpu_torch.data.types import FABindBatch, dummy_arrays
from fabind_tpu_torch.train.checkpoints import (TrainCheckpointer,
                                                load_params, save_params)
from fabind_tpu_torch.train.convert import state_dict_from_flax
from fabind_tpu_torch.train.trainer import Trainer
from fabind_tpu_torch.utils.metrics import MetricAccumulator

PARAM_ATOL = 2e-6
# deterministic: no dropout, all recycles, the precomputed pocket
KW = dict(TINY_XS, dropout=0.0, random_n_iter=False, stage_prob=0.0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's torch work: its tensors are
    toy-sized, and the suite runs in parallel workers that would otherwise
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------- optimizer
def _np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


@pytest.mark.parametrize("accumulate", [1, 2])
def test_optimizer_steps_match_make_train_step(accumulate):
    """Two AdamW updates (clip at 1.0, the 0.5 * lr warmup) from the same
    weights and batches give make_train_step's parameters; with
    gradient_accumulate_step 2, four micro-batches give its two updates
    (optax.MultiSteps' running mean)."""
    kw = dict(KW, gradient_accumulate_step=accumulate)
    cfg, jcfg = preset("fabind", **kw), jax_preset("fabind", **kw)
    arrays = [dummy_arrays(cfg.shapes, batch_size=2, seed=s, n_lig_valid=6,
                           n_prot_valid=24) for s in range(2)]
    jbatches = [JaxBatch(**{k: jnp.asarray(v) for k, v in a.items()})
                for a in arrays]
    u = np.random.RandomState(1).uniform(
        1e-6, 1.0, (2, cfg.shapes.max_protein, 2)).astype(np.float32)

    def gumbel_softmax(logits, key, tau=1.0, hard=False, axis=-1):
        g = -jnp.log(-jnp.log(jnp.asarray(u)))
        return jax.nn.softmax((logits + g) / tau, axis=axis)

    orig = jax_gumbel.gumbel_softmax
    jax_gumbel.gumbel_softmax = gumbel_softmax
    try:
        model, state = create_train_state(jcfg, jax.random.PRNGKey(0),
                                          jbatches[0])
        step = jax.jit(make_train_step(model, jcfg))
        sd0 = state_dict_from_flax(_np_tree(state.params), is_plus=False)
        trainer = Trainer(cfg, "cpu", state_dict=sd0)
        n_micro = 2 * accumulate
        for i in range(n_micro):
            state, jm = step(state, jbatches[i % 2])
            m = trainer.train_step(FABindBatch.from_numpy(arrays[i % 2],
                                                          "cpu"),
                                   gumbel_u=torch.from_numpy(u))
            assert abs(m["loss"] - float(jm["loss"])) <= 2e-4
            assert abs(m["grad_norm"] - float(jm["grad_norm"])) <= 1e-3
            assert m["grad_norm"] > 1.0          # the clip is active
        want = state_dict_from_flax(_np_tree(state.params), is_plus=False)
    finally:
        jax_gumbel.gumbel_softmax = orig
    assert trainer.optimizer.updates == 2 and trainer.step == n_micro
    moved = 0.0
    for n, p in trainer.model.named_parameters():
        d = float((p.detach() - want[n]).abs().max())
        assert d <= PARAM_ATOL, (n, d)
        moved = max(moved, float((p.detach() - sd0[n]).abs().max()))
    assert moved > 5e-5


# ------------------------------------------------------------------ data
@pytest.fixture(scope="module")
def npz_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("npz")
    for i in range(9):
        n, nr = (6, 26) if i % 3 else (14, 44)
        np.savez(d / f"c{i}.npz", **make_raw(n=n, nr=nr, seed=i))
    return str(d)


def _loader_cfgs(**kw):
    kw = dict(max_ligand=16, max_pocket=32, max_protein=48, ctx_k=8,
              ctx_k_whole=8, batch_size=2, train_ligand_torsion_noise=True,
              **kw)
    return preset("fabind", **kw), jax_preset("fabind", **kw)


@pytest.mark.parametrize("workers", [0, 2])
def test_loader_batches_equal_jax_loader(npz_dir, workers):
    """Same NPZ directory, seed and buckets (two, plus an oversize sample
    dropped): the same batches in the same order, array for array, bit for
    bit (train group: shuffle, noisy crop, torsion noise, rotation), and
    epoch(skip_batches=k) yields the full epoch's batches [k:]."""
    cfg, jcfg = _loader_cfgs()
    small = dataclasses.replace(cfg.shapes, max_ligand=8, max_pocket=24,
                                max_protein=32)
    jsmall = dataclasses.replace(jcfg.shapes, max_ligand=8, max_pocket=24,
                                 max_protein=32)
    src, names = open_source(npz_dir)
    assert names == JaxNPZSource(npz_dir).names
    oversize = make_raw(n=30, nr=20, seed=99)

    class Src(NPZSource):
        def get(self, name):
            return oversize if name == "big" else super().get(name)

    class JSrc(JaxNPZSource):
        def get(self, name):
            return oversize if name == "big" else super().get(name)

    idx = names + ["big"]
    mine = Loader(Src(npz_dir), idx, cfg, seed=4, workers=workers,
                  buckets=[small, cfg.shapes])
    ref = JaxLoader(JSrc(npz_dir), idx, jcfg, seed=4, workers=workers,
                    buckets=[jsmall, jcfg.shapes])
    for epoch in (0, 1):
        got = list(mine.epoch(epoch, with_meta=True))
        want = list(ref.epoch(epoch, with_meta=True))
        assert len(got) == len(want) >= 4
        for (a, ma), (b, mb) in zip(got, want):
            assert ma["pdb"] == mb["pdb"] and ma["n_valid"] == mb["n_valid"]
            assert ma["cfg"].shapes.max_ligand == mb["cfg"].shapes.max_ligand
            for f in dataclasses.fields(JaxBatch):
                x, y = a[f.name], getattr(b, f.name)
                assert (x is None) == (y is None), f.name
                if x is not None:
                    np.testing.assert_array_equal(x, np.asarray(y),
                                                  err_msg=f.name)
    assert mine.n_dropped == ref.n_dropped == 2
    tail = list(mine.epoch(1, with_meta=True, skip_batches=2))
    assert [m["pdb"] for _, m in tail] == [m["pdb"] for _, m in got[2:]]
    for (a, _), (b, _) in zip(tail, got[2:]):
        np.testing.assert_array_equal(a["lig_coords_init"],
                                      b["lig_coords_init"])


def test_prefetch_loader_equals_inline(npz_dir):
    cfg, _ = _loader_cfgs()
    src, names = open_source(npz_dir)
    a = list(Loader(src, names, cfg, seed=1, workers=2).epoch(0))
    b = list(Loader(src, names, cfg, seed=1, workers=2,
                    prefetch_depth=2).epoch(0))
    assert len(a) == len(b) == 5
    for x, y in zip(a, b):
        for k in x:
            if x[k] is not None:
                np.testing.assert_array_equal(x[k], y[k])


def test_torsion_noise_equals_jax():
    raw = make_raw(n=12, nr=30, seed=3)
    got = randomize_torsions(raw["rdkit_coords"], raw["bond_edges"],
                             np.random.RandomState(8))
    want = jax_torsions(raw["rdkit_coords"], raw["bond_edges"],
                        np.random.RandomState(8))
    np.testing.assert_array_equal(got, want)
    # the torsions moved: some distance beyond the bonded ones changed
    d0 = np.linalg.norm(raw["rdkit_coords"][0] - raw["rdkit_coords"][-1])
    assert abs(np.linalg.norm(got[0] - got[-1]) - d0) > 1e-3


def test_metric_accumulator_matches_jax():
    rng = np.random.RandomState(0)
    B, Nc, Nr = 3, 7, 11

    class Obj:
        def __init__(self, **kw):
            self.__dict__.update(kw)

    got, want = MetricAccumulator(symmetric=True), JaxAccumulator(
        symmetric=True)
    for i in range(2):
        lig_mask = np.arange(Nc)[None] < np.array([[7], [5], [6]])
        out = Obj(coords=rng.randn(B, Nc, 3).astype(np.float32),
                  lig_mask=lig_mask,
                  pred_pocket_center=rng.randn(B, 3).astype(np.float32),
                  pocket_cls_logits=rng.randn(B, Nr).astype(np.float32),
                  pocket_cls_label=(rng.rand(B, Nr) > 0.5).astype(np.float32),
                  prot_mask=np.arange(Nr)[None] < np.array([[11], [9], [4]]),
                  pocket_overflow=np.array([0, 2, 1 - i]))
        iso = np.tile(np.arange(Nc), (B, 2, 1))
        iso[:, 1, :5] = np.arange(5)[::-1]
        batch = Obj(lig_coords=rng.randn(B, Nc, 3).astype(np.float32),
                    coords_center=rng.randn(B, 3).astype(np.float32),
                    sample_valid=np.array([True, True, i == 0]),
                    isomorphisms=iso, iso_mask=np.ones((B, 2), bool))
        want.update(out, batch)
        tout = Obj(**{k: torch.from_numpy(np.asarray(v))
                      for k, v in out.__dict__.items()})
        tbatch = Obj(**{k: torch.from_numpy(np.asarray(v))
                        for k, v in batch.__dict__.items()})
        got.update(tout, tbatch)
    g, w = got.summarize(), want.summarize()
    assert set(g) == set(w) and g["n"] == 5
    for k in w:
        np.testing.assert_allclose(g[k], w[k], rtol=1e-12, err_msg=k)


# ----------------------------------------------------------- checkpoints
def test_checkpointer_retention_meta_restore(tmp_path):
    cfg = preset("fabind", **TINY_XS)
    arrays = dummy_arrays(cfg.shapes, batch_size=2, seed=0, n_lig_valid=6,
                          n_prot_valid=24)
    tr = Trainer(cfg, "cpu")
    tr.train_step(FABindBatch.from_numpy(arrays, "cpu"))
    ck = TrainCheckpointer(str(tmp_path / "ck"), max_to_keep=2)
    assert ck.latest_step() is None and ck.restore() is None
    for s in (1, 2, 3):
        ck.save(tr.state_dict(), meta={"epoch": 0, "batch_in_epoch": s},
                step=s)
    ck.wait()
    assert sorted(int(d) for d in os.listdir(tmp_path / "ck")) == [2, 3]
    assert ck.latest_step() == 3
    state, meta = ck.restore()
    assert meta == {"epoch": 0, "batch_in_epoch": 3}
    fresh = Trainer(cfg, "cpu")
    fresh.load_state_dict(state)
    assert fresh.step == 1 and fresh.optimizer.updates == 1
    for k, v in tr.model.state_dict().items():
        assert torch.equal(v, fresh.model.state_dict()[k])
    assert ck.restore(step=2)[1]["batch_in_epoch"] == 2
    ck.close()
    path = save_params(str(tmp_path / "p.pt"), tr.model.state_dict())
    for sd in (load_params(path), load_params(str(tmp_path / "ck"))):
        assert all(torch.equal(v, sd[k])
                   for k, v in tr.model.state_dict().items())


# ------------------------------------------------------------------- CLI
CLI_SETS = ["max_ligand=16", "max_pocket=32", "max_protein=48", "ctx_k=8",
            "ctx_k_whole=8", "hidden_size=16", "pocket_pred_hidden_size=16",
            "mean_layers=1", "n_iter=2", "steps_per_epoch=4",
            "warmup_epochs=1"]


def _cli(npz_dir, out, epochs, *extra, on_step=None):
    argv = ["--data", npz_dir, "--output", str(out), "--epochs", str(epochs),
            "--batch-size", "2", "--workers", "0", "--prefetch", "0",
            "--buckets", "auto:2", "--save-every-steps", "2",
            "--device", "cpu", *extra]
    for s in CLI_SETS:
        argv += ["--set", s]
    return cli_train.main(argv, on_step=on_step)


def test_cli_train_preempted_then_resumed(npz_dir, tmp_path):
    """SIGTERM during step 3: the run finishes the step, checkpoints with
    the data-order position and returns 0; --resume continues from it, and
    every later step equals the unbroken run's step."""
    full = {}
    assert _cli(npz_dir, tmp_path / "full", 2,
                on_step=lambda s, m, c: full.__setitem__(s, m)) == 0
    assert len(full) >= 8
    log = (tmp_path / "full" / "log.txt").read_text()
    assert "valid_stage1" in log and "valid_stage2" in log

    def stop_at_3(step, metrics, meta):
        if step == 3:
            os.kill(os.getpid(), signal.SIGTERM)

    out = tmp_path / "run"
    assert _cli(npz_dir, out, 2, on_step=stop_at_3) == 0
    ck = TrainCheckpointer(str(out / "ckpt"))
    assert ck.latest_step() == 3
    assert ck.restore()[1] == {"epoch": 0, "batch_in_epoch": 3}
    resumed = {}
    assert _cli(npz_dir, out, 2, "--resume",
                on_step=lambda s, m, c: resumed.__setitem__(s, m)) == 0
    assert "resumed at step 3 (epoch 0, batch 3)" in (out / "log.txt"
                                                      ).read_text()
    assert sorted(resumed) == [s for s in sorted(full) if s > 3]
    for s, m in resumed.items():
        assert m == full[s], s
    assert all(m["skipped_nan"] == 0.0 for m in full.values())
    # the SIGTERM handler is gone again
    assert signal.getsignal(signal.SIGTERM) is signal.SIG_DFL
