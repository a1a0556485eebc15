"""The port's FABind+ confidence training against the JAX package, on the
CPU, in fp32 at toy width with dropout 0 and the full recycle count: the
ranking loss and its gradient; the copies' random inputs from one numpy
seed; two inference-source train steps (loss, metrics, the head after each
Adam step; the trunk bit for bit unchanged); the teacher-source loss and
metrics; the evaluation function and best-of-N pick; and the port's
`cli.train_confidence` in process.

Gradient parity runs on the inference source: without dropout every
teacher copy is the same pose, all RMSDs tie and the head's gradient sums
to zero. The teacher source is held on its loss and metrics; FABind+ docks
teacher-forced into the precomputed pocket, so the gumbel draw of the
predicted center reaches neither.

Tolerances: atol 2e-4 for losses, metrics and RMSDs; the head within 2e-6
of JAX's after each update (Adam's first steps are ~lr = 5e-5 each) where
its gradient is real. The ranking loss sees score differences only, so the
gradient of the score's bias, and of a hidden bias under a unit active in
every copy, cancels to 0 up to rounding; Adam's normalized step turns that
rounding into a step of up to lr in either package. Elements whose gradient
is below 1e-4 of the largest are held to that bound instead.
"""
from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fabind_tpu.config import preset as jax_preset
from fabind_tpu.data.types import FABindBatch as JaxBatch
from fabind_tpu.models.fabind import make_model as jax_make_model
from fabind_tpu.train import confidence as jax_conf
from fabind_tpu.train.losses import confidence_ranking_loss as jax_rank_loss

from fabind_tpu_torch.cli import train as cli_train
from fabind_tpu_torch.cli import train_confidence as cli_conf
from fabind_tpu_torch.config import preset
from fabind_tpu_torch.data.types import FABindBatch, dummy_arrays
from fabind_tpu_torch.models.fabind import init_params, make_model
from fabind_tpu_torch.train import confidence as conf
from fabind_tpu_torch.train.checkpoints import (HEAD_PREFIXES, load_into,
                                                load_weights)
from fabind_tpu_torch.train.convert import state_dict_from_flax
from fabind_tpu_torch.train.losses import confidence_ranking_loss

ATOL = 2e-4
HEAD_ATOL = 2e-6
REAL_GRAD = 1e-4
# the score MLP's output bias: a pure ranking loss never moves it
SCORE_BIAS = "ranking_score_mlp.linear2.bias"
C = 3
KW = dict(max_ligand=16, max_pocket=32, max_protein=48, ctx_k=8,
          ctx_k_whole=8, hidden_size=16, pocket_pred_hidden_size=16,
          mean_layers=1, n_iter=2, dropout=0.0, random_n_iter=False,
          confidence_training=True, num_copies=C, batch_size=2)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's torch work: its tensors are
    toy-sized, and the suite runs in parallel workers that would otherwise
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------- the loss
@pytest.mark.parametrize("loss_type", ["logsigmoid", "dynamic_hinge"])
@pytest.mark.parametrize("scope", ["within", "global"])
@pytest.mark.parametrize("keep_cls_2a", [False, True])
def test_ranking_loss_and_gradient_match_jax(loss_type, scope, keep_cls_2a):
    """Three copies of four complexes, flattened copy-major as the step
    does; ties within a complex (and across), two padded entries."""
    rng = np.random.RandomState(4)
    n_c, n_b = 3, 4
    scores = rng.randn(n_c * n_b).astype(np.float32)
    rmsds = rng.choice([0.5, 1.5, 1.5, 3.0, 4.0], n_c * n_b).astype(
        np.float32)
    rmsds[[1, 5]] = 2.5                          # a tie within complex 1
    valid = np.ones(n_c * n_b, bool)
    valid[[3, 11]] = False
    groups = (np.tile(np.arange(n_b), n_c) if scope == "within" else None)
    kw = dict(loss_type=loss_type, keep_cls_2a=keep_cls_2a)

    def jl(s):
        return jax_rank_loss(s, jnp.asarray(rmsds), jnp.asarray(valid),
                             groups=None if groups is None
                             else jnp.asarray(groups), **kw)

    want, want_g = jax.jit(jax.value_and_grad(jl))(jnp.asarray(scores))
    s = torch.from_numpy(scores).requires_grad_()
    got = confidence_ranking_loss(
        s, torch.from_numpy(rmsds), torch.from_numpy(valid),
        groups=None if groups is None else torch.from_numpy(groups), **kw)
    got.backward()
    assert abs(float(got) - float(want)) <= 1e-6
    np.testing.assert_allclose(s.grad.numpy(), np.asarray(want_g),
                               atol=1e-6, rtol=1e-5)
    # padding entries take no part
    assert not s.grad[~torch.from_numpy(valid)].any()


# ------------------------------------------------------- copies and steps
@pytest.fixture(scope="module")
def plus():
    """JAX FABind+ with a confidence head at toy width: the model, its
    seeded params, the port's state dict of them, and one batch of two
    complexes whose second row is a padding duplicate."""
    jcfg = jax_preset("fabind_plus", **KW)
    cfg = preset("fabind_plus", **KW)
    arrays = dummy_arrays(cfg.shapes, batch_size=2, seed=7, n_lig_valid=8,
                          n_prot_valid=30)
    arrays["sample_valid"] = np.array([True, False])
    jb = JaxBatch(**{k: jnp.asarray(v) for k, v in arrays.items()})
    jmodel = jax_make_model(jcfg)
    k = jax.random.PRNGKey(0)
    params = jax.tree_util.tree_map(np.asarray, jax.jit(lambda b: jmodel.init(
        {"params": k, "dropout": k, "sample": k}, b, train=True))(jb)[
        "params"])
    sd = state_dict_from_flax(params, is_plus=True)
    return jcfg, cfg, jmodel, params, sd, arrays, jb


def _port_model(cfg, sd):
    model = make_model(cfg)
    model.load_state_dict(sd, strict=True)
    return model


def test_copy_inputs_match_jax(plus):
    """randomized_init_copies alone, then sample_copy_inputs with DBSCAN
    centers, from one RandomState seed on each side: the same starts and
    centers, and the same draws consumed."""
    jcfg, cfg, jmodel, params, sd, arrays, jb = plus
    batch = FABindBatch.from_numpy(arrays, "cpu")
    r1, r2 = np.random.RandomState(3), np.random.RandomState(3)
    got = conf.randomized_init_copies(batch, C, r1)
    want = jax_conf.randomized_init_copies(jb, C, r2)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert got.shape == (C, 2, cfg.shapes.max_ligand, 3)
    # the torsions moved: copies differ
    assert np.abs(got[0] - got[1]).max() > 1e-2
    model = _port_model(cfg, sd)
    g_init, g_cent = conf.sample_copy_inputs(model, batch, cfg, C, r1)
    w_init, w_cent = jax_conf.sample_copy_inputs(jmodel, params, jb, jcfg, C,
                                                 r2)
    np.testing.assert_allclose(g_init, w_init, atol=1e-5, rtol=0)
    np.testing.assert_allclose(g_cent, np.asarray(w_cent), atol=ATOL, rtol=0)
    assert r1.rand() == r2.rand()


def _head_and_trunk(model):
    sd = model.state_dict()
    head = {k: v for k, v in sd.items() if k.startswith(HEAD_PREFIXES)}
    return head, {k: v for k, v in sd.items() if k not in head}


def test_inference_source_steps_match_jax(plus):
    """Two inference-source steps from the same copy inputs: JAX's loss and
    metrics, and its head after each Adam step; the trunk bit for bit as
    loaded, with no gradient anywhere in it."""
    jcfg, cfg, jmodel, params, sd, arrays, jb = plus
    batch = FABindBatch.from_numpy(arrays, "cpu")
    model = _port_model(cfg, sd)
    rng = np.random.RandomState(11)
    inputs = [conf.sample_copy_inputs(model, batch, cfg, C, rng)
              for _ in range(2)]
    tx = jax_conf.build_confidence_optimizer(jcfg, params)
    opt_state = tx.init(params)
    jstep = jax_conf.make_confidence_train_step(jmodel, jcfg, tx,
                                                pose_source="inference")
    opt = conf.build_confidence_optimizer(cfg, model)
    step = conf.make_confidence_train_step(model, cfg, opt,
                                           pose_source="inference")
    gen = torch.Generator().manual_seed(0)
    jp = params
    for i, (init, cent) in enumerate(inputs):
        jp, opt_state, jm = jstep(jp, opt_state, jb, jax.random.PRNGKey(i),
                                  jnp.asarray(init), jnp.asarray(cent))
        m = step(batch, gen, init, cent)
        assert set(m) == set(jm) == set(conf.METRIC_KEYS)
        for k, v in jm.items():
            assert abs(m[k] - float(v)) <= ATOL, (i, k, m[k], float(v))
        want = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, jp),
                                    is_plus=True)
        head, trunk = _head_and_trunk(model)
        grads = {n: p.grad for n, p in model.named_parameters()
                 if p.grad is not None}
        gmax = max(float(g.abs().max()) for g in grads.values())
        moved, n_held = 0.0, 0
        for k, v in head.items():
            d = (v - want[k]).abs()
            real = grads[k].abs() > REAL_GRAD * gmax
            assert float((d * real).max()) <= HEAD_ATOL, (i, k)
            assert float(d.max()) <= 2 * cfg.train.lr * (i + 1) + HEAD_ATOL
            n_held += int(real.sum())
            moved = max(moved, float((v - sd[k]).abs().max()))
        assert moved > 1e-5 and n_held > 20
        assert all(torch.equal(v, sd[k]) for k, v in trunk.items())
    for n, p in model.named_parameters():
        assert p.requires_grad == n.startswith(HEAD_PREFIXES)
        assert p.grad is None or n.startswith(HEAD_PREFIXES), n


def test_teacher_source_loss_and_metrics_match_jax(plus):
    jcfg, cfg, jmodel, params, sd, arrays, jb = plus
    batch = FABindBatch.from_numpy(arrays, "cpu")
    model = _port_model(cfg, sd)
    tx = jax_conf.build_confidence_optimizer(jcfg, params)
    _, _, jm = jax_conf.make_confidence_train_step(
        jmodel, jcfg, tx, pose_source="teacher")(
        params, tx.init(params), jb, jax.random.PRNGKey(0))
    step = conf.make_confidence_train_step(
        model, cfg, conf.build_confidence_optimizer(cfg, model))
    m = step(batch, torch.Generator().manual_seed(0))
    for k, v in jm.items():
        assert abs(m[k] - float(v)) <= ATOL, (k, m[k], float(v))
    # every copy the same pose: the tie loss log 2, nothing ranked
    assert abs(m["confidence_loss"] - np.log(2.0)) <= 1e-5
    assert m["ranking_accuracy"] == m["hit_rate"] == 0.0


def test_eval_fn_and_pick_best_match_jax(plus):
    jcfg, cfg, jmodel, params, sd, arrays, jb = plus
    batch = FABindBatch.from_numpy(arrays, "cpu")
    model = _port_model(cfg, sd)
    init, cent = conf.sample_copy_inputs(model, batch, cfg, C,
                                         np.random.RandomState(2))
    ws, wr = jax_conf.make_confidence_eval_fn(jmodel, jcfg)(
        params, jb, jax.random.PRNGKey(0), jnp.asarray(init),
        jnp.asarray(cent))
    gs, gr = conf.make_confidence_eval_fn(model, cfg)(
        batch, torch.Generator().manual_seed(0), init, cent)
    assert gs.shape == gr.shape == (C, 2)
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), atol=ATOL, rtol=0)
    np.testing.assert_allclose(gr.numpy(), np.asarray(wr), atol=ATOL, rtol=0)
    assert all(p.grad is None for p in model.parameters())
    rng = np.random.RandomState(0)
    coords = rng.randn(4, 3, 5, 3).astype(np.float32)
    scores = rng.randn(4, 3).astype(np.float32)
    scores[2, 1] = scores[0, 1] = scores[:, 1].max() + 1   # a tie: the first
    want = jax_conf.pick_best_by_confidence(jnp.asarray(coords),
                                            jnp.asarray(scores))
    got = conf.pick_best_by_confidence(torch.from_numpy(coords),
                                       torch.from_numpy(scores))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# -------------------------------------------------------- checkpoints, CLI
def test_load_into_keeps_only_a_missing_head_fresh():
    cfg = preset("fabind_plus", **KW)
    model = make_model(cfg)
    init_params(model, torch.Generator().manual_seed(1))
    fresh = {k: v.clone() for k, v in model.state_dict().items()}
    reg = {k: v + 1.0 for k, v in fresh.items()
           if not k.startswith(HEAD_PREFIXES)}
    missing = load_into(model, reg)
    assert missing and all(k.startswith(HEAD_PREFIXES) for k in missing)
    for k, v in model.state_dict().items():
        assert torch.equal(v, fresh[k] if k in missing else reg[k])
    bad = dict(reg)
    bad.pop(next(iter(bad)))
    with pytest.raises(ValueError, match="missing keys outside"):
        load_into(model, bad)
    with pytest.raises(ValueError, match="unused"):
        load_into(model, dict(reg, extra=torch.zeros(1)))
    k0 = next(iter(reg))
    with pytest.raises(RuntimeError):
        load_into(model, dict(reg, **{k0: torch.zeros(3, 3, 3)}))


CLI_SETS = ["max_ligand=16", "max_pocket=32", "max_protein=48", "ctx_k=8",
            "ctx_k_whole=8", "hidden_size=16", "pocket_pred_hidden_size=16",
            "mean_layers=1", "n_iter=2"]


def _toy():
    return {k: int(v) for k, v in (s.split("=") for s in CLI_SETS)}


def _sets():
    out = []
    for s in CLI_SETS:
        out += ["--set", s]
    return out


@pytest.fixture(scope="module")
def reg_run(tmp_path_factory):
    """An NPZ directory of four complexes and a one-epoch fabind_plus
    cli.train run on it (dropout on, so teacher copies differ)."""
    from test_data import make_raw
    root = tmp_path_factory.mktemp("conf")
    (root / "npz").mkdir()
    for i in range(4):
        np.savez(root / "npz" / f"c{i}.npz",
                 **make_raw(n=6 + i, nr=24 + 2 * i, seed=30 + i))
    run = root / "reg"
    assert cli_train.main(["--preset", "fabind_plus", "--data",
                           str(root / "npz"), "--output", str(run),
                           "--epochs", "1", "--batch-size", "2",
                           "--workers", "0", "--buckets", "none",
                           "--eval-every", "0", "--device", "cpu"]
                          + _sets()) == 0
    return root, str(root / "npz"), str(run)


def _check_conf_run(out, start, epochs, seed):
    """One params file per epoch; only ranking_* moved from where the run
    started (trunk = `start`, the head = its seeded init; the score's bias
    has a zero gradient, see the module docstring); the log has the JAX
    step's metric keys, finite."""
    files = sorted(p.name for p in (out / "ckpt").iterdir())
    assert files == [f"params_epoch{e}" for e in range(epochs)]
    final = load_weights(str(out / "ckpt" / files[-1]))
    fresh = make_model(preset("fabind_plus", confidence_training=True,
                              **_toy()))
    init_params(fresh, torch.Generator().manual_seed(seed))
    init = fresh.state_dict()
    assert set(final) == set(init)
    for k, v in final.items():
        if not k.startswith("ranking"):
            assert torch.equal(v, start[k]), k
        elif k != SCORE_BIAS:
            assert not torch.equal(v, init[k]), k
    with open(out / "metrics.jsonl") as f:
        recs = [json.loads(line) for line in f]
    ep = [r for r in recs if r["phase"] == "epoch"]
    assert len(ep) == epochs
    for r in ep:
        assert set(conf.METRIC_KEYS) <= set(r)
        assert all(np.isfinite(r[k]) for k in conf.METRIC_KEYS)


@pytest.mark.parametrize("source", ["inference", "teacher"])
def test_cli_train_confidence_from_a_run(reg_run, tmp_path, source):
    root, data, run = reg_run
    out = tmp_path / "conf"
    assert cli_conf.main(["--data", data, "--output", str(out),
                          "--init-ckpt", run, "--epochs", "2",
                          "--batch-size", "2", "--num-copies", "2",
                          "--pose-source", source, "--device", "cpu"]
                         + _sets()) == 0
    _check_conf_run(out, load_weights(run), 2,
                    preset("fabind_plus").train.seed)


def test_cli_train_confidence_from_a_bin(reg_run, tmp_path):
    """--torch-ckpt: a released-format .bin (DDP prefix) of the regression
    weights; a base checkpoint does not fit and raises."""
    root, data, run = reg_run
    sd = load_weights(run)
    path = tmp_path / "reg.bin"
    torch.save({f"module.{k}": v for k, v in sd.items()}, path)
    out = tmp_path / "conf"
    assert cli_conf.main(["--data", data, "--output", str(out),
                          "--torch-ckpt", str(path), "--epochs", "1",
                          "--batch-size", "2", "--num-copies", "2",
                          "--seed", "5", "--device", "cpu"] + _sets()) == 0
    _check_conf_run(out, sd, 1, 5)
    base = make_model(preset("fabind", **_toy()))
    torch.save(base.state_dict(), tmp_path / "base.bin")
    with pytest.raises(ValueError, match="does not fit"):
        cli_conf.main(["--data", data, "--output", str(tmp_path / "x"),
                       "--torch-ckpt", str(tmp_path / "base.bin"),
                       "--device", "cpu"] + _sets())
