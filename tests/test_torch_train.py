"""The port's training forward, losses and gradients against the JAX
package, on the CPU; and the port's train step on its own (NaN skip,
recomputation, seeds, bf16).

Same inputs (numpy, seeded) and the same weights (flax init carried across
by state_dict_from_flax) go through both packages at TINY_XS in fp32, with
dropout 0 and the full recycle count (the port cannot reproduce JAX's
threefry draws), and the gumbel-softmax uniforms given to both: the port
takes them as `gumbel_u`; the JAX side patches fabind_tpu.ops.gumbel's
gumbel_softmax in this process only. Each JAX function compiles once per
module fixture.

Tolerances: every metric within 2e-4 (absolute); each gradient tensor
within 1e-5 + 1e-5 * max|JAX gradient| (absolute): the two packages sum in
other orders, and the largest gradients reach ~1e4.
"""
from __future__ import annotations

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from common import TINY_XS

import fabind_tpu.ops.gumbel as jax_gumbel
from fabind_tpu.config import preset as jax_preset
from fabind_tpu.data.types import FABindBatch as JaxBatch
from fabind_tpu.models.fabind import make_model as jax_make_model
from fabind_tpu.train.losses import fabind_losses as jax_losses
from fabind_tpu.train.schedule import build_schedule as jax_build_schedule

from fabind_tpu_torch.config import preset
from fabind_tpu_torch.data.types import FABindBatch, dummy_arrays
from fabind_tpu_torch.models.fabind import make_model
from fabind_tpu_torch.models.layers import dropout_rng
from fabind_tpu_torch.train.convert import state_dict_from_flax
from fabind_tpu_torch.train.losses import fabind_losses
from fabind_tpu_torch.train.schedule import build_schedule
from fabind_tpu_torch.train.trainer import Trainer, step_generator

METRIC_ATOL = 2e-4
GRAD_ATOL, GRAD_RTOL_OF_MAX = 1e-5, 1e-5
# deterministic draws: no dropout, all recycles; stage_prob 1 leaves the
# base gate to the center error, so one compiled JAX function runs both
# branches (a batch whose coords_center is far from the predicted center
# docks into the precomputed pocket, one at it into the predicted pocket)
KW = dict(TINY_XS, dropout=0.0, random_n_iter=False, stage_prob=1.0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's torch work: its tensors are
    toy-sized, and the suite runs in parallel workers that would otherwise
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Uniforms:
    """The JAX side's gumbel uniforms, traced as an argument of the jitted
    function; `gumbel_softmax` with the key ignored."""
    u = None

    @classmethod
    def gumbel_softmax(cls, logits, key, tau=1.0, hard=False, axis=-1):
        g = -jnp.log(-jnp.log(cls.u))
        y = jax.nn.softmax((logits + g) / tau, axis=axis)
        assert not hard
        return y


def _arrays(cfg, seed=0, plus=False):
    a = dummy_arrays(cfg.shapes, batch_size=2, seed=seed, n_lig_valid=6,
                     n_prot_valid=24)
    # the second row is a padding duplicate: zero weight everywhere
    a["sample_valid"] = np.array([True, False])
    if plus:
        Nc = cfg.shapes.max_ligand
        iso = np.tile(np.arange(Nc, dtype=np.int32), (2, 8, 1))
        iso[:, 1, :6] = np.arange(6)[::-1]       # the chain reversed
        a["isomorphisms"] = iso
        a["iso_mask"] = np.zeros((2, 8), bool)
        a["iso_mask"][:, :2] = True
    return a


def _setup(name, plus=False):
    cfg, jcfg = preset(name, **KW), jax_preset(name, **KW)
    arrays = _arrays(cfg, plus=plus)
    jmodel = jax_make_model(jcfg)
    k = jax.random.PRNGKey(0)
    jb = JaxBatch(**{k_: jnp.asarray(v) for k_, v in arrays.items()})
    params = jax.tree_util.tree_map(np.asarray, jax.jit(lambda: jmodel.init(
        {"params": k, "dropout": k, "sample": k}, jb,
        train=True))()["params"])

    def loss_fn(p, b, u):
        _Uniforms.u = u
        out = jmodel.apply({"params": p}, b, train=True,
                           rngs={"dropout": k, "sample": k})
        loss, metrics = jax_losses(out, b, jcfg.model, jcfg.train)
        return loss, (metrics, out.pred_pocket_center)

    orig = jax_gumbel.gumbel_softmax
    jax_gumbel.gumbel_softmax = _Uniforms.gumbel_softmax
    try:
        vg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
        u = np.random.RandomState(5).uniform(
            1e-6, 1.0, (2, cfg.shapes.max_protein, 2)).astype(np.float32)
        runs = {}
        if plus:
            runs["plus"] = arrays
        else:
            # stage 1: the true center 1000 A away; stage 2: the true center
            # at the predicted one
            far = dict(arrays, coords_center=arrays["coords_center"] + 1e3)
            runs["stage1"] = far
            (_, (_, center)), _ = vg(params, JaxBatch(**{
                k_: jnp.asarray(v) for k_, v in far.items()}), u)
            runs["stage2"] = dict(arrays,
                                  coords_center=np.asarray(center))
        want = {}
        for key, a in runs.items():
            (loss, (metrics, _)), grads = vg(params, JaxBatch(**{
                k_: jnp.asarray(v) for k_, v in a.items()}), u)
            want[key] = (a, {m: float(v) for m, v in metrics.items()},
                         state_dict_from_flax(
                             jax.tree_util.tree_map(np.asarray, grads),
                             is_plus=cfg.model.is_plus))
    finally:
        jax_gumbel.gumbel_softmax = orig
    sd = state_dict_from_flax(params, is_plus=cfg.model.is_plus)
    return cfg, sd, u, want


@pytest.fixture(scope="module")
def base():
    return _setup("fabind")


@pytest.fixture(scope="module")
def plus():
    return _setup("fabind_plus", plus=True)


def _port_step(cfg, sd, u, arrays):
    model = make_model(cfg)
    model.load_state_dict(sd, strict=True)
    model.train()
    batch = FABindBatch.from_numpy(arrays, "cpu")
    with dropout_rng(torch.Generator().manual_seed(0)):
        out = model(batch, gumbel_u=torch.from_numpy(u))
    loss, metrics = fabind_losses(out, batch, cfg.model, cfg.train)
    loss.backward()
    grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
             for n, p in model.named_parameters()}
    return out, {k: float(v.detach()) for k, v in metrics.items()}, grads


def _check(got_metrics, got_grads, want_metrics, want_grads):
    assert set(got_metrics) == set(want_metrics)
    for k, v in want_metrics.items():
        assert abs(got_metrics[k] - v) <= METRIC_ATOL, (k, got_metrics[k], v)
    assert set(got_grads) == set(want_grads)
    for n, g in want_grads.items():
        tol = GRAD_ATOL + GRAD_RTOL_OF_MAX * float(g.abs().max())
        d = float((got_grads[n] - g).abs().max())
        assert d <= tol, (n, d, tol)


@pytest.mark.parametrize("branch", ["stage1", "stage2"])
def test_base_train_forward_losses_grads_match_jax(base, branch):
    cfg, sd, u, want = base
    arrays, want_metrics, want_grads = want[branch]
    out, metrics, grads = _port_step(cfg, sd, u, arrays)
    assert out.use_stage2 == (branch == "stage2")
    assert want_metrics["use_stage2"] == float(branch == "stage2")
    _check(metrics, grads, want_metrics, want_grads)
    # the padding duplicate weighs nothing: the grads are non-trivial
    assert metrics["loss"] > 0 and max(
        float(g.abs().max()) for g in grads.values()) > 0


def test_plus_train_forward_losses_grads_match_jax(plus):
    """FABind+ (teacher-forced, radius head, permutation loss over
    [identity, chain reversed])."""
    cfg, sd, u, want = plus
    arrays, want_metrics, want_grads = want["plus"]
    out, metrics, grads = _port_step(cfg, sd, u, arrays)
    assert out.use_stage2 is False
    assert metrics["pocket_radius_loss"] > 0
    _check(metrics, grads, want_metrics, want_grads)


def test_dismap_choices_and_bce_modes(base):
    """wodm zeroes the contact and distill terms; npair trains as ori; the
    legacy padded BCE sums over the bucket's padded grid."""
    cfg, sd, u, want = base
    arrays = want["stage1"][0]
    model = make_model(cfg)
    model.load_state_dict(sd, strict=True)
    model.train()
    batch = FABindBatch.from_numpy(arrays, "cpu")
    with torch.no_grad(), dropout_rng(torch.Generator().manual_seed(0)):
        out = model(batch, gumbel_u=torch.from_numpy(u))
    res = {}
    for choice in ("ori", "npair", "wodm"):
        for legacy in (True, False):
            tcfg = dataclasses.replace(cfg.train, dismap_choice=choice,
                                       legacy_padded_bce=legacy)
            _, m = fabind_losses(out, batch, cfg.model, tcfg)
            res[choice, legacy] = {k: float(v) for k, v in m.items()}
    assert res["ori", True] == res["npair", True]
    w = res["wodm", True]
    assert w["contact_loss"] == 0 and w["contact_distill_loss"] == 0
    assert w["contact_by_pred_loss"] == res["ori", True]["contact_by_pred_loss"]
    # padded rows score bce(0, 0) = log 2 each; the masked mean drops them
    assert res["ori", True]["pocket_cls_loss"] > res["ori", False][
        "pocket_cls_loss"]


@pytest.mark.parametrize("name", ["constant", "poly_decay", "cosine_decay",
                                  "cosine_decay_restart", "exp_decay"])
def test_schedules_match_optax(name):
    cfg = preset("fabind", **TINY_XS, lr_scheduler=name).train
    jcfg = jax_preset("fabind", **TINY_XS, lr_scheduler=name).train
    got, want = build_schedule(cfg), jax_build_schedule(jcfg)
    w = cfg.warmup_epochs * cfg.steps_per_epoch
    total = cfg.total_epochs * cfg.steps_per_epoch
    for t in sorted({0, 1, w - 1, w, w + 1, w + 7, w + 10, total - 1, total,
                     total + 5}):
        np.testing.assert_allclose(got(t), float(want(t)), rtol=2e-6,
                                   atol=0)
    assert got(0) == 0.5 * cfg.lr


# --------------------------------------------------------- the port's step
@pytest.fixture(scope="module")
def step_batch():
    cfg = preset("fabind", **TINY_XS)     # dropout 0.1, random recycles
    arrays = dummy_arrays(cfg.shapes, batch_size=2, seed=0, n_lig_valid=6,
                          n_prot_valid=24)
    return cfg, arrays, FABindBatch.from_numpy(arrays, "cpu")


def test_nan_batch_leaves_state_untouched(step_batch):
    cfg, arrays, batch = step_batch
    tr = Trainer(cfg, "cpu")
    tr.train_step(batch)
    before = copy.deepcopy(tr.state_dict())
    bad = dict(arrays, lig_coords=arrays["lig_coords"].copy())
    bad["lig_coords"][0, 0, 0] = np.nan
    m = tr.train_step(FABindBatch.from_numpy(bad, "cpu"))
    assert m["skipped_nan"] == 1.0
    assert all(v == 0.0 for k, v in m.items() if k != "skipped_nan")
    after = tr.state_dict()
    assert after["step"] == before["step"] + 1
    for k, v in before["model"].items():
        assert torch.equal(v, after["model"][k]), k
    ob, oa = before["optimizer"], after["optimizer"]
    assert ob["updates"] == oa["updates"] == 1
    for i, st in ob["opt"]["state"].items():
        for k, v in st.items():
            assert torch.equal(v, oa["opt"]["state"][i][k]), (i, k)
    # the next finite step goes on
    assert tr.train_step(batch)["skipped_nan"] == 0.0


def _loss_and_grads(cfg, batch, seed, step):
    tr = Trainer(cfg, "cpu")
    metrics = tr._forward_loss(batch, cfg, step_generator(seed, step, "cpu"),
                               None)
    return (float(metrics["loss"]),
            {n: p.grad.clone() for n, p in tr.model.named_parameters()
             if p.grad is not None})


def test_remat_same_loss_and_grads_with_dropout_on(step_batch):
    """cfg.remat recomputes each EGNN layer in the backward: each layer
    rebuilds its dropout generator from its seed, so the loss and the
    gradients are those without remat (dropout 0.1, recycle draws on)."""
    cfg, _, batch = step_batch
    l0, g0 = _loss_and_grads(cfg, batch, 7, 3)
    l1, g1 = _loss_and_grads(dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, remat=True)), batch, 7, 3)
    assert l0 == l1
    assert set(g0) == set(g1)
    for n in g0:
        torch.testing.assert_close(g0[n], g1[n], atol=1e-6, rtol=1e-6)
    # the dropout is really on: another seed gives another loss
    assert _loss_and_grads(cfg, batch, 8, 3)[0] != l0


def test_same_seed_bit_identical_steps(step_batch):
    cfg, _, batch = step_batch

    def run(seed):
        c = dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, seed=seed))
        tr = Trainer(c, "cpu")
        ms = [tr.train_step(batch) for _ in range(2)]
        return ms, tr.state_dict()["model"]

    (m1, p1), (m2, p2), (m3, p3) = run(11), run(11), run(12)
    assert m1 == m2
    assert all(torch.equal(p1[k], p2[k]) for k in p1)
    assert m1 != m3
    assert any(not torch.equal(p1[k], p3[k]) for k in p1)


def test_bf16_step_close_to_fp32(step_batch):
    """bf16 mixed precision computes in bf16 (another loss than fp32),
    within 10% of it, with float32 master weights and gradients."""
    cfg, _, batch = step_batch
    cfg16 = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train,
                                                               bf16=True))
    t16, t32 = Trainer(cfg16, "cpu"), Trainer(cfg, "cpu")
    m16, m32 = t16.train_step(batch), t32.train_step(batch)
    assert m16["skipped_nan"] == m32["skipped_nan"] == 0.0
    assert m16["loss"] != m32["loss"]
    assert abs(m16["loss"] - m32["loss"]) / abs(m32["loss"]) < 0.1
    assert all(p.dtype == torch.float32 for p in t16.model.parameters())
    assert all(p.dtype == torch.bfloat16 for p in t16.model16.parameters())
    # the master weights moved by the update
    moved = max(float((a - b).abs().max()) for a, b in zip(
        t16.model.parameters(), Trainer(cfg16, "cpu").model.parameters()))
    assert moved > 0


def test_training_forward_needs_a_generator(step_batch):
    cfg, _, batch = step_batch
    model = make_model(cfg).train()
    with pytest.raises(RuntimeError, match="dropout_rng"):
        model(batch)
    # eval mode stays deterministic without one
    with torch.inference_mode():
        a, b = model.eval()(batch), model(batch)
    assert torch.equal(a.coords, b.coords)
