"""The port's best-of-N sampling (fabind_tpu_torch.sample, DockingEngine
.dock_best_of) against the JAX package, on the CPU at toy width.

DBSCAN is held to scikit-learn's labels through the JAX package's
`dbscan_clusters`; `sample_poses` at dropout 0 (deterministic passes) to
the JAX package's in both pocket modes with clustering on. With dropout on
the draws cannot equal JAX's, so they are held to their contract instead:
the same seed gives the same poses, other passes and seeds other ones, and
dropout stays in the sampling thread.
"""
from __future__ import annotations

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from sklearn.cluster import DBSCAN

from common import TINY
from test_serve import make_raw
from test_torch_serve import POSE_SLACK_A

from fabind_tpu.cli import sample as jax_sample
from fabind_tpu.config import preset as jax_preset
from fabind_tpu.data.types import FABindBatch as JaxBatch
from fabind_tpu.models.fabind import make_model as jax_make_model
from fabind_tpu.serve import DockingEngine as JaxEngine

from fabind_tpu_torch import sample
from fabind_tpu_torch.config import preset
from fabind_tpu_torch.data.types import FABindBatch, dummy_arrays
from fabind_tpu_torch.models.fabind import make_model
from fabind_tpu_torch.models.layers import Dropout, dropout_rng
from fabind_tpu_torch.serve import DockingEngine
from fabind_tpu_torch.train.convert import state_dict_from_flax

ATOL = 2e-4
KW = dict(TINY, mean_layers=2)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's torch work: its tensors are
    toy-sized, and the suite runs in parallel workers that would otherwise
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------------- DBSCAN
def _sklearn_labels(pts, eps, min_samples):
    return DBSCAN(eps=eps, min_samples=min_samples).fit(pts).labels_


def test_dbscan_labels_border_points_and_boundary():
    """A border point within eps of two clusters keeps the cluster that
    reaches it first in index order, eps is inclusive (distances of
    exactly 1.5 below), and isolated points are noise."""
    a = [0.0, 0.5, 1.0, 1.5]
    b = [4.5, 5.0, 5.5, 6.0]
    for xs in (a + [3.0] + b, b + [3.0] + a, [3.0] + b + a + [20.0],
               [20.0, 40.0, 60.0]):
        pts = np.stack([np.asarray(xs), np.zeros(len(xs)),
                        np.zeros(len(xs))], 1).astype(np.float32)
        got = sample.dbscan_labels(pts, 1.5, 4)
        np.testing.assert_array_equal(got, _sklearn_labels(pts, 1.5, 4))
    assert set(sample.dbscan_labels(pts, 1.5, 4)) == {-1}


@settings(max_examples=40, deadline=None, database=None)
@given(seed=st.integers(0, 2 ** 31 - 1), n=st.integers(1, 60),
       eps=st.sampled_from([0.5, 1.0, 2.5, 9.0]),
       min_samples=st.integers(1, 6))
def test_dbscan_labels_match_sklearn(seed, n, eps, min_samples):
    rng = np.random.RandomState(seed)
    pts = (rng.randn(n, 3) * rng.choice([1.0, 3.0, 10.0])).astype(
        np.float32)
    np.testing.assert_array_equal(sample.dbscan_labels(pts, eps, min_samples),
                                  _sklearn_labels(pts, eps, min_samples))


def test_dbscan_clusters_match_jax():
    """Rows with many positives (two blobs and a bridge point), with fewer
    than 50 positives (the top-50 fallback), with fewer than 50 valid
    residues, and a row of far-apart residues (all noise)."""
    rng = np.random.RandomState(0)
    B, Nr = 4, 120
    coords = rng.randn(B, Nr, 3).astype(np.float32)
    coords[0, :60] += 30.0
    coords[0, 60] = 15.0
    coords[3] *= 1000.0
    probs = rng.rand(B, Nr).astype(np.float32)
    probs[0] = 0.9
    probs[1] = np.where(np.arange(Nr) < 20, 0.9, probs[1] * 0.5)
    mask = np.ones((B, Nr), bool)
    mask[2, 30:] = False
    for eps, ms in ((9.0, 2), (1.0, 3)):
        got = sample.dbscan_clusters(probs, coords, mask, eps, ms)
        want = jax_sample.dbscan_clusters(probs, coords, mask, eps, ms)
        assert [len(c) for c in got] == [len(c) for c in want]
        for g, w in zip(got, want):
            for gc, wc in zip(g, w):
                np.testing.assert_array_equal(gc, wc)
    assert len(got[0]) >= 1 and got[3] == []


def test_pick_cluster_centers_match_jax():
    clusters = [[np.ones(3, np.float32) * k for k in range(1, 4)], [],
                [np.full(3, 7.0, np.float32)]]
    default = np.zeros((3, 3), np.float32)
    r1, r2 = np.random.RandomState(5), np.random.RandomState(5)
    for _ in range(6):
        np.testing.assert_array_equal(
            sample.pick_cluster_centers(clusters, 0.5, default, r1),
            jax_sample.pick_cluster_centers(clusters, 0.5, default, r2))
    assert r1.rand() == r2.rand()


# ------------------------------------------------------------------ dropout
def test_dropout_only_inside_its_thread():
    """Dropout is the identity without a generator, drops close to its
    rate (kept values scaled by 1 / (1 - rate)) inside dropout_rng, draws
    the same mask from the same seed, and stays off in another thread; in
    training mode it raises without a generator."""
    drop = Dropout(0.1).eval()
    x = torch.ones(200_000)
    assert drop(x) is x
    seen = {}

    def other():
        seen["other"] = drop(x)

    with dropout_rng(torch.Generator().manual_seed(3)):
        y = drop(x)
        t = threading.Thread(target=other)
        t.start()
        t.join(timeout=30)
    assert not t.is_alive() and seen["other"] is x
    zero = float((y == 0).float().mean())
    assert abs(zero - 0.1) < 0.005
    np.testing.assert_allclose(y[y != 0].numpy(), 1 / 0.9, rtol=1e-6)
    with dropout_rng(torch.Generator().manual_seed(3)):
        assert torch.equal(drop(x), y)
    assert drop(x) is x
    # a module in training mode draws its masks only inside dropout_rng
    drop.train()
    with pytest.raises(RuntimeError, match="dropout_rng"):
        drop(x)
    with dropout_rng(torch.Generator().manual_seed(3)):
        assert torch.equal(drop(x), y)


# ----------------------------------------------------------- sample_poses
@pytest.fixture(scope="module")
def models():
    """Flax init of preset fabind_plus_sampling at toy width: the JAX cfg
    and model with deterministic passes, their preset keywords `kw0`, the
    port model with deterministic passes, a toy batch, and a port cfg and
    model with the preset's stochastic passes and the same weights."""
    # deterministic passes: no dropout and the full recycle count
    kw0 = dict(KW, dropout=0.0, random_n_iter=False)
    cfg0, jcfg0 = (preset("fabind_plus_sampling", **kw0),
                   jax_preset("fabind_plus_sampling", **kw0))
    arrays = dummy_arrays(cfg0.shapes, batch_size=2, seed=1, n_lig_valid=9,
                          n_prot_valid=40)
    jbatch = JaxBatch(**{k: jnp.asarray(v) for k, v in arrays.items()})
    jmodel = jax_make_model(jcfg0)
    k = jax.random.PRNGKey(0)
    params = jax.tree_util.tree_map(np.asarray, jax.jit(lambda: jmodel.init(
        {"params": k, "dropout": k, "sample": k}, jbatch, train=False,
        stage=2))()["params"])
    sd = state_dict_from_flax(params, is_plus=True)
    model0 = make_model(cfg0)
    model0.load_state_dict(sd, strict=True)
    cfg = preset("fabind_plus_sampling", **KW)
    model = make_model(cfg)
    model.load_state_dict(sd, strict=True)
    return dict(jcfg0=jcfg0, jmodel=jmodel, params=params, jbatch=jbatch,
                kw0=kw0, model0=model0.eval(), cfg=cfg, model=model.eval(),
                sd=sd, batch=FABindBatch.from_numpy(arrays, "cpu"))


@pytest.mark.parametrize("mode", ["stochastic", "fixed"])
def test_sample_poses_dropout_off_matches_jax(models, mode):
    m = models
    want_c, want_s = jax_sample.sample_poses(
        m["jmodel"], m["params"], m["jbatch"], m["jcfg0"], 3, seed=2,
        batch_idx=1, pocket_mode=mode)
    cfg = preset("fabind_plus_sampling", **m["kw0"],
                 sampling_pocket_mode=mode)
    got_c, got_s = sample.sample_poses(m["model0"], m["batch"], cfg, 3,
                                       seed=2, batch_idx=1)
    assert got_c.shape == want_c.shape and got_s.shape == want_s.shape
    np.testing.assert_allclose(got_c.numpy(), want_c, atol=ATOL, rtol=0)
    np.testing.assert_allclose(got_s.numpy(), want_s, atol=ATOL, rtol=0)
    # clustering moved some pass's center: the passes are not all equal
    assert float(np.abs(want_c - want_c[:1]).max()) > 1e-3


def test_sample_poses_seeded_and_pass_distinct(models):
    m = models
    args = (m["model"], m["batch"],
            preset("fabind_plus_sampling", **KW, use_clustering=False), 3)
    c1, s1 = sample.sample_poses(*args, seed=4)
    c2, s2 = sample.sample_poses(*args, seed=4)
    c3, _ = sample.sample_poses(*args, seed=5)
    assert torch.equal(c1, c2) and torch.equal(s1, s2)
    for a, b in ((0, 1), (0, 2), (1, 2)):
        assert float((c1[a] - c1[b]).abs().max()) > 1e-4
    assert float((c1 - c3).abs().max()) > 1e-4
    # deterministic passes (no dropout, all recycles): every pass is equal
    c0, s0 = sample.sample_poses(
        m["model0"], m["batch"],
        preset("fabind_plus_sampling", **m["kw0"], use_clustering=False), 3,
        seed=4)
    assert torch.equal(c0, c0[:1].expand_as(c0))
    assert torch.equal(s0, s0[:1].expand_as(s0))


def test_stochastic_forward_draws_recycle_counts(models, monkeypatch):
    """Inside dropout_rng (and only there) the docking stack runs a recycle
    count drawn from 1..n_iter, reproducible from the generator's seed, as
    the JAX package's non-deterministic forward with random_n_iter."""
    from fabind_tpu_torch.models.att_model import EfficientMCAttModel
    # one docking layer: the count is drawn once per forward, whatever
    # the depth
    cfg = preset("fabind_plus", **dict(TINY, n_iter=8, dropout=0.0))
    model = make_model(cfg).eval()
    counts = []
    step = EfficientMCAttModel._step

    def spy(self, *a):
        if self is model.complex_model:
            counts[-1] += 1
        return step(self, *a)

    monkeypatch.setattr(EfficientMCAttModel, "_step", spy)

    def run(seed=None):
        counts.append(0)
        with torch.inference_mode():
            if seed is None:
                model.inference(models["batch"])
            else:
                with dropout_rng(torch.Generator().manual_seed(seed)):
                    model.inference(models["batch"])
        return counts[-1]

    assert run() == 8
    drawn = [run(seed) for seed in range(12)]
    assert all(1 <= n <= 8 for n in drawn) and len(set(drawn)) > 2
    assert [run(seed) for seed in range(12)] == drawn


# ------------------------------------------------------------------ engine
@pytest.fixture(scope="module")
def engine(models):
    return DockingEngine(models["cfg"], state_dict=models["sd"], batch_size=2,
                         bf16=False, device="cpu")


def _requests():
    return [make_raw(n=5, nr=20, seed=1), make_raw(n=12, nr=40, seed=2),
            make_raw(n=7, nr=30, seed=4)]


def test_dock_best_of_picks_the_most_confident(engine):
    raws = _requests()
    poses = engine.dock_best_of(raws, sample_size=3, seed=6)
    again = engine.dock_best_of(raws, sample_size=3, seed=6)
    other = engine.dock_best_of(raws, sample_size=3, seed=7)
    batches = list(engine.batches(raws, [None] * len(raws)))
    assert len(batches) == 2
    for bi, (chunk, cfg_b, batch, n_real) in enumerate(batches):
        coords, scores = sample.sample_poses(engine.model, batch, cfg_b, 3,
                                             seed=6, batch_idx=bi)
        for b in range(n_real):
            pos, s = chunk[b]
            best = int(scores[:, b].argmax())
            n = s["lig_feat"].shape[0]
            assert poses[pos].confidence == float(scores[best, b])
            assert poses[pos].confidence == float(scores[:, b].max())
            np.testing.assert_array_equal(
                poses[pos].coords,
                coords[best, b, :n].numpy() + s["coord_offset"])
    for p, a, o in zip(poses, again, other):
        assert p.error is None and p.coords.dtype == np.float32
        np.testing.assert_array_equal(p.coords, a.coords)
        assert float(np.abs(p.coords - o.coords).max()) > 1e-4


def test_dock_best_of_post_optimizes_the_winner(models, engine):
    """With post_optim_steps the winning pose (and only it) is refined:
    the same confidences as without, the winner moved to the LAS
    post-optimization of the unrefined winner."""
    from fabind_tpu_torch.postopt import post_optimize_batch
    raws = _requests()[:2]
    plain = engine.dock_best_of(raws, sample_size=2, seed=6)
    eng = DockingEngine(models["cfg"], state_dict=models["sd"], batch_size=2,
                        bf16=False, device="cpu", post_optim_steps=5)
    got = eng.dock_best_of(raws, sample_size=2, seed=6)
    (chunk, cfg_b, batch, _), = list(eng.batches(raws, [None] * 2))
    win = engine._best_of_batch(batch, cfg_b, 2, 6, 0)[0]   # unrefined
    want, _ = post_optimize_batch(win, batch.lig_rdkit_coords,
                                  batch.las_adj, batch.lig_mask, steps=5)
    for b, (g, p) in enumerate(zip(got, plain)):
        assert g.confidence == p.confidence
        assert float(np.abs(g.coords - p.coords).max()) > 1e-4
        s = chunk[b][1]
        np.testing.assert_allclose(
            g.coords, want[b, :len(g.coords)].numpy() + s["coord_offset"],
            atol=1e-4, rtol=0)


def test_dock_best_of_bf16_post_optimized_matches_jax(models):
    """bf16 engines with deterministic passes and no clustering, the winner
    post-optimized: the port refines the winner in float32, as the JAX
    package does (a bf16 coordinate of the requests' poses, some hundred A
    from the protein's mean, moves in steps of 2 or 4 A, so lr-0.1 Adam
    updates would round away). The refined poses are the float32
    refinement of the unrefined winners, and stay within the bf16 bound of
    tests/test_torch_serve.py (2x the JAX package's own bf16-vs-fp32 mean
    per-atom distance + POSE_SLACK_A) of the JAX bf16 engine's."""
    from fabind_tpu_torch.postopt import post_optimize_batch
    kw = dict(models["kw0"], use_clustering=False)
    jcfg, cfg = (jax_preset("fabind_plus_sampling", **kw),
                 preset("fabind_plus_sampling", **kw))
    raws, steps = _requests(), 100
    want32, want = (JaxEngine(jcfg, params=models["params"], batch_size=2,
                              bf16=bf16, post_optim_steps=steps)
                    .dock_best_of(raws, sample_size=2, seed=3)
                    for bf16 in (False, True))
    eng, plain = (DockingEngine(cfg, state_dict=models["sd"], batch_size=2,
                                bf16=True, device="cpu", post_optim_steps=n)
                  for n in (steps, 0))
    got = eng.dock_best_of(raws, sample_size=2, seed=3)
    for bi, (chunk, cfg_b, batch, n_real) in enumerate(
            plain.batches(raws, [None] * len(raws))):
        win = plain._best_of_batch(batch, cfg_b, 2, 3, bi)[0]
        assert win.dtype == torch.float32
        ref, _ = post_optimize_batch(win, batch.lig_rdkit_coords,
                                     batch.las_adj, batch.lig_mask,
                                     steps=steps)
        for b in range(n_real):
            pos, s = chunk[b]
            n = s["lig_feat"].shape[0]
            np.testing.assert_allclose(
                got[pos].coords, ref[b, :n].numpy() + s["coord_offset"],
                atol=1e-4, rtol=0)
    d_port, d_jax = [], []
    for g, w, w32 in zip(got, want, want32):
        assert g.error is None and g.coords.shape == w.coords.shape
        assert g.coords.dtype == np.float32
        d_port.append(np.linalg.norm(g.coords - w.coords, axis=-1))
        d_jax.append(np.linalg.norm(w.coords - w32.coords, axis=-1))
    d_port, d_jax = np.concatenate(d_port), np.concatenate(d_jax)
    assert d_jax.mean() > 0
    assert d_port.mean() <= 2 * d_jax.mean() + POSE_SLACK_A, \
        (d_port.mean(), d_jax.mean())


def test_dock_raw_deterministic_beside_dock_best_of(engine):
    """dock_raw gives the same poses bit for bit before, during (another
    thread runs dock_best_of on the same engine) and after sampling."""
    raws = _requests()
    before = engine.dock_raw(raws)
    during = []

    def sampler():
        engine.dock_best_of(raws, sample_size=8, seed=1)

    t = threading.Thread(target=sampler)
    t.start()
    while True:
        during.append(engine.dock_raw(raws))
        if not t.is_alive() or len(during) == 3:
            break
    t.join(timeout=300)
    assert not t.is_alive()
    after = engine.dock_raw(raws)
    for poses in during + [after]:
        for p, q in zip(poses, before):
            np.testing.assert_array_equal(p.coords, q.coords)
            assert p.confidence == q.confidence


def test_dock_best_of_needs_a_confidence_head():
    cfg = preset("fabind_plus", **KW)
    eng = DockingEngine(cfg, batch_size=2, device="cpu")
    with pytest.raises(ValueError, match="confidence"):
        eng.dock_best_of(_requests()[:1], sample_size=2)
