"""The port's LAS post-optimization against fabind_tpu.postopt, on the CPU,
in fp32: the configuration loss and its gradient conventions, the Adam
update, and 50 steps of the batched optimizer."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from fabind_tpu.postopt import configuration_loss as jax_loss
from fabind_tpu.postopt import post_optimize_batch_jit as jax_postopt

from fabind_tpu_torch.ops.geometry import pairwise_dist
from fabind_tpu_torch.postopt import configuration_loss, post_optimize_batch

# 50 Adam steps of lr 0.1 from the same start: fp32 sums in another order
# move the two trajectories apart by rounding only
ATOL_A = 1e-4


def _poses(seed, B=3, Nc=9, n_valid=(9, 7, 5)):
    """Predicted poses, rdkit conformers, LAS masks (1- and 2-hop chain
    neighbours) and atom masks; the first pose has two atoms on top of each
    other, where the distance's gradient is taken as 0."""
    rng = np.random.RandomState(seed)
    ref = rng.randn(B, Nc, 3).astype(np.float32) * 2.0
    pred = (ref + rng.randn(B, Nc, 3) * 1.5).astype(np.float32)
    pred[0, 1] = pred[0, 0]
    mask = np.arange(Nc)[None] < np.asarray(n_valid)[:, None]
    gap = np.abs(np.arange(Nc)[:, None] - np.arange(Nc)[None])
    las = ((gap >= 1) & (gap <= 2))[None] & mask[:, :, None] & mask[:, None]
    return pred, ref, las, mask


def test_configuration_loss_and_gradient_match_jax():
    pred, ref, las, mask = _poses(0)
    ref_dis = np.asarray(jnp.sqrt(((ref[:, :, None] - ref[:, None]) ** 2)
                                  .sum(-1)))

    def jtotal(x):
        return jnp.sum(jax_loss(x, jnp.asarray(ref_dis), jnp.asarray(las),
                                jnp.asarray(mask)))

    want = np.asarray(jax_loss(*map(jnp.asarray, (pred, ref_dis, las, mask))))
    want_g = np.asarray(jax.grad(jtotal)(jnp.asarray(pred)))
    x = torch.from_numpy(pred).requires_grad_()
    got = configuration_loss(x, torch.from_numpy(ref_dis),
                             torch.from_numpy(las), torch.from_numpy(mask))
    got.sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                               atol=1e-4)
    # the coincident atoms: finite gradient, as the JAX package's
    assert np.isfinite(x.grad.numpy()).all()
    np.testing.assert_allclose(x.grad.numpy(), want_g, rtol=1e-5, atol=1e-4)
    # the diagonal counts 2 * 1.22 per valid atom, as the reference's
    zero = configuration_loss(torch.zeros(1, 2, 3), torch.zeros(1, 2, 2),
                              torch.zeros(1, 2, 2, dtype=torch.bool),
                              torch.tensor([[True, False]]))
    np.testing.assert_allclose(zero.numpy(), [2 * 1.22], rtol=1e-6)


def test_adam_update_is_optax_adam():
    """torch.optim.Adam(lr 0.1, betas (0.9, 0.999), eps 1e-8) applies the
    update of optax.adam with the same settings (both bias-corrected)."""
    rng = np.random.RandomState(1)
    x0 = rng.randn(4, 3).astype(np.float32)
    grads = rng.randn(20, 4, 3).astype(np.float32)
    opt = optax.adam(0.1, b1=0.9, b2=0.999, eps=1e-8)
    jx, state = jnp.asarray(x0), opt.init(jnp.asarray(x0))
    tx = torch.from_numpy(x0.copy()).requires_grad_()
    topt = torch.optim.Adam([tx], lr=0.1, betas=(0.9, 0.999), eps=1e-8)
    for g in grads:
        upd, state = opt.update(jnp.asarray(g), state, jx)
        jx = optax.apply_updates(jx, upd)
        tx.grad = torch.from_numpy(g)
        topt.step()
    # the same formula with its fp32 roundings in another order (torch
    # divides sqrt(v) by sqrt(1 - b2^t) and folds 1 - b1^t into the step,
    # optax corrects m and v first): 20 steps of 0.1 agree to ~1e-5
    np.testing.assert_allclose(tx.detach().numpy(), np.asarray(jx),
                               rtol=0, atol=2e-5)


def test_post_optimize_batch_matches_jax():
    pred, ref, las, mask = _poses(2)
    want_x, want_loss = jax_postopt(*map(jnp.asarray, (pred, ref, las, mask)),
                                    steps=50)
    # under inference_mode, as the engine calls it
    with torch.inference_mode():
        x, loss = post_optimize_batch(*map(torch.from_numpy,
                                           (pred, ref, las, mask)), steps=50)
    np.testing.assert_allclose(x.numpy(), np.asarray(want_x), rtol=0,
                               atol=ATOL_A)
    np.testing.assert_allclose(loss.numpy(), np.asarray(want_loss),
                               rtol=1e-4, atol=1e-3)
    start = configuration_loss(
        torch.from_numpy(pred),
        pairwise_dist(torch.from_numpy(ref), torch.from_numpy(ref)),
        torch.from_numpy(las), torch.from_numpy(mask))
    assert (loss < start).all()
    assert not x.requires_grad
