"""One training step of the port per EGNN stack type of the ablation
configurations against the JAX package on the CPU: the training forward,
fabind_losses and every gradient against JAX's value_and_grad.

Same inputs (numpy, seeded) and the same weights (the JAX package's init,
carried across by state_dict_from_flax) in fp32 at hidden 16, one docking
layer, 2 recycles, dropout 0 and the gumbel-softmax uniforms given to both sides
(the JAX side patches fabind_tpu.ops.gumbel's gumbel_softmax in this
test only); each JAX side is one jitted function (init, then
value_and_grad). The loss within 1e-5 relative, each gradient tensor within
1e-4 of its largest JAX value (plus 1e-7).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from common import TINY_XS
from test_torch_ablation import FLAGS, _np_tree

import fabind_tpu.ops.gumbel as jax_gumbel
from fabind_tpu.config import preset as jax_preset
from fabind_tpu.data.types import FABindBatch as JaxBatch
from fabind_tpu.models.fabind import make_model as jax_make_model
from fabind_tpu.train.losses import fabind_losses as jax_losses

from fabind_tpu_torch.config import preset
from fabind_tpu_torch.data.types import FABindBatch, dummy_arrays
from fabind_tpu_torch.models.fabind import make_model
from fabind_tpu_torch.models.layers import dropout_rng
from fabind_tpu_torch.train.convert import state_dict_from_flax
from fabind_tpu_torch.train.losses import fabind_losses

LOSS_RTOL = 1e-5
GRAD_RTOL_OF_MAX, GRAD_ATOL = 1e-4, 1e-7
# deterministic draws: no dropout, all recycles; stage_prob 1 leaves the
# base gate to the center error (a center 1000 A away: stage 1)
TRAIN_KW = dict(TINY_XS, dropout=0.0, random_n_iter=False, stage_prob=1.0)
# one configuration per EGNN stack type. The triangle block's dropout is
# fixed at 0.1 (as the reference's), so a dropout-0 training comparison of
# the attention stack takes the outer-product configuration
TRAIN_STACKS = {"attention_opm": FLAGS["opm"],
                "no_attention": FLAGS["ablation_no_attention"],
                "no_attention_with_cross_attn":
                    FLAGS["ablation_no_attention_with_cross_attn"]}



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
        assert not hard
        g = -jnp.log(-jnp.log(cls.u))
        return jax.nn.softmax((logits + g) / tau, axis=axis)


@pytest.mark.parametrize("stack", list(TRAIN_STACKS))
def test_train_step_matches_jax(stack, monkeypatch):
    """The training forward, fabind_losses and every gradient of one step
    against JAX's value_and_grad, per stack type."""
    kw = dict(TRAIN_KW, **TRAIN_STACKS[stack])
    cfg, jcfg = preset("fabind", **kw), jax_preset("fabind", **kw)
    arrays = dummy_arrays(cfg.shapes, batch_size=2, seed=0, n_lig_valid=6,
                          n_prot_valid=24)
    arrays["coords_center"] = arrays["coords_center"] + 1e3
    jb = JaxBatch(**{k: jnp.asarray(v) for k, v in arrays.items()})
    u = np.random.RandomState(5).uniform(
        1e-6, 1.0, (2, cfg.shapes.max_protein, 2)).astype(np.float32)
    jm = jax_make_model(jcfg)
    monkeypatch.setattr(jax_gumbel, "gumbel_softmax",
                        _Uniforms.gumbel_softmax)

    def loss_fn(p, u):
        k = jax.random.PRNGKey(0)
        out = jm.apply({"params": p}, jb, train=True,
                       rngs={"dropout": k, "sample": k})
        return jax_losses(out, jb, jcfg.model, jcfg.train)

    def run(u):
        _Uniforms.u = u
        k = jax.random.PRNGKey(0)
        p = jm.init({"params": k, "dropout": k, "sample": k}, jb,
                    train=True)["params"]
        return p, jax.value_and_grad(loss_fn, has_aux=True)(p, u)

    params, ((loss, metrics), grads) = jax.jit(run)(u)
    model = make_model(cfg)
    model.load_state_dict(state_dict_from_flax(_np_tree(params),
                                               is_plus=False), strict=True)
    model.train()
    batch = FABindBatch.from_numpy(arrays, "cpu")
    with dropout_rng(torch.Generator().manual_seed(0)):
        out = model(batch, gumbel_u=torch.from_numpy(u))
    got_loss, got_metrics = fabind_losses(out, batch, cfg.model, cfg.train)
    got_loss.backward()
    assert not out.use_stage2
    assert abs(float(got_loss.detach()) - float(loss)) <= LOSS_RTOL * abs(float(loss))
    assert set(got_metrics) == set(metrics)
    want = state_dict_from_flax(_np_tree(grads), is_plus=False)
    got = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
           for n, p in model.named_parameters()}
    assert set(got) == set(want)
    for n, g in want.items():
        tol = GRAD_ATOL + GRAD_RTOL_OF_MAX * float(g.abs().max())
        d = float((got[n] - g).abs().max())
        assert d <= tol, (n, d, tol)
