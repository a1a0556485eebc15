"""The PyTorch port's model against the JAX package, on the CPU.

Same inputs (made with numpy from a seed) and the same weights (flax init,
carried across by fabind_tpu_torch.train.convert.state_dict_from_flax and
loaded with strict=True) go through both packages. fp32; atol 2e-4 after two
recycles of a two-layer stack, the golden-parity convention of
tests/test_golden_torch.py.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from common import TINY
from test_serve import make_raw

from fabind_tpu.config import preset as jax_preset
from fabind_tpu.data.types import FABindBatch as JaxBatch
from fabind_tpu.models.cross_att import CrossAttentionModule as JaxCross
from fabind_tpu.models.egnn import GraphInputs as JaxGI
from fabind_tpu.models.egnn import InterAttention as JaxInterAttention
from fabind_tpu.models.fabind import make_model as jax_make_model
from fabind_tpu.serve import DockingEngine as JaxEngine

from fabind_tpu_torch.config import preset
from fabind_tpu_torch.data.types import FABindBatch, dummy_arrays
from fabind_tpu_torch.models.cross_att import CrossAttentionModule
from fabind_tpu_torch.models.egnn import GraphInputs, InterAttention
from fabind_tpu_torch.models.fabind import make_model
from fabind_tpu_torch.ops import edge_gate
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


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _port(module, flax_params):
    module.load_state_dict(state_dict_from_flax(_np_tree(flax_params),
                                                is_plus=False), strict=True)
    return module.eval()


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=0)


@pytest.fixture(scope="module")
def base():
    cfg = preset("fabind", **KW)
    jcfg = jax_preset("fabind", **KW)
    arrays = dummy_arrays(cfg.shapes, batch_size=2, seed=0, n_lig_valid=9,
                          n_prot_valid=40)
    jbatch = JaxBatch(**{k: jnp.asarray(v) for k, v in arrays.items()})
    jmodel = jax_make_model(jcfg)
    k = jax.random.PRNGKey(0)
    params = jax.jit(lambda: jmodel.init(
        {"params": k, "dropout": k, "sample": k}, jbatch, train=False,
        stage=2))()["params"]
    model = _port(make_model(cfg), params)
    batch = FABindBatch.from_numpy(arrays, "cpu")
    return cfg, jcfg, jmodel, params, model, jbatch, batch


@pytest.mark.parametrize("stage", [1, 2])
def test_fabind_forward_matches_jax(base, stage):
    _, _, jmodel, params, model, jbatch, batch = base
    want = jax.jit(lambda p, b: jmodel.apply({"params": p}, b, train=False,
                                             stage=stage))(params, jbatch)
    with torch.inference_mode():
        got = model(batch, stage=stage)
    for f in ("pocket_cls_logits", "pred_pocket_center", "coords", "y_pred",
              "y_pred_by_coord", "dis_map_target"):
        _close(getattr(got, f), getattr(want, f))
    np.testing.assert_array_equal(got.pkt_mask.numpy(),
                                  np.asarray(want.pkt_mask))
    m = got.pkt_mask.numpy()
    np.testing.assert_array_equal(got.pkt_idx.numpy()[m],
                                  np.asarray(want.pkt_idx)[m])
    for f in ("keep_less_5", "pocket_overflow", "ctx_overflow"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)))


def test_fabind_inference_matches_jax(base):
    _, _, jmodel, params, model, jbatch, batch = base
    want, _ = jax.jit(lambda p, b: jmodel.apply(
        {"params": p}, b, method="inference"))(params, jbatch)
    with torch.inference_mode():
        got, conf = model.inference(batch)
    _close(got, want)
    assert float(conf.abs().max()) == 0.0


def test_dock_raw_matches_jax(base):
    """The slice as a whole: DockingEngine.dock_raw on both sides, Pose for
    Pose, including a request that exceeds the bucket."""
    cfg, jcfg, _, params, _, _, _ = base
    raws = [make_raw(n=5, nr=20, seed=1), make_raw(n=12, nr=40, seed=2),
            make_raw(n=40, nr=40, seed=3), make_raw(n=7, nr=30, seed=4)]
    want = JaxEngine(jcfg, params=params, batch_size=2,
                     bf16=False).dock_raw(raws)
    eng = DockingEngine(cfg, state_dict=state_dict_from_flax(
        _np_tree(params), is_plus=False), batch_size=2, bf16=False,
        device="cpu")
    got = eng.dock_raw(raws)
    assert len(got) == len(want) == len(raws)
    for g, w in zip(got, want):
        assert (g.error is None) == (w.error is None)
        if w.error is not None:
            assert "exceeds" in g.error and "exceeds" in w.error
            continue
        assert g.coords.shape == w.coords.shape
        _close(g.coords, w.coords)
        assert g.pocket_truncated == w.pocket_truncated


def _side_inputs(rng, B, Nc, Np, C):
    f32 = np.float32
    lig_mask = np.arange(Nc)[None] < np.array([[Nc], [Nc - 2]])
    pkt_mask = np.arange(Np)[None] < np.array([[Np - 1], [Np - 3]])
    h = rng.randn(B, Nc + Np + 2, C).astype(f32)
    ones = np.ones((B, 1), bool)
    pm = np.concatenate([ones, pkt_mask], 1)
    cm = np.concatenate([ones, lig_mask], 1)
    pair_mask = pm[:, :, None] & cm[:, None, :]
    pair = (rng.randn(B, Np + 1, Nc + 1, C) * pair_mask[..., None]).astype(f32)
    return lig_mask, pkt_mask, h, pm, cm, pair, pair_mask


def test_cross_attention_matches_jax():
    rng = np.random.RandomState(0)
    B, Nc, Np, C = 2, 6, 9, 16
    _, _, h, pm, cm, pair, pair_mask = _side_inputs(rng, B, Nc, Np, C)
    p_side, c_side = h[:, Nc + 1:], h[:, :Nc + 1]
    jmod = JaxCross(rm_layernorm=True, dropout_rate=0.1)
    args = (p_side, pm, c_side, cm, pair, pair_mask)
    params = jmod.init(jax.random.PRNGKey(1), *args)["params"]
    want = jmod.apply({"params": params}, *args)
    mod = _port(CrossAttentionModule(C, rm_layernorm=True), params)
    with torch.inference_mode():
        got = mod(*(torch.from_numpy(a) for a in args))
    for g, w in zip(got, want):
        _close(g, w, atol=1e-5)


def test_inter_attention_matches_jax():
    """The module that holds the edge-gate kernel: InterAttention (cross
    attention, both attention directions with the rank-1 coordinate gate)."""
    rng = np.random.RandomState(1)
    cfg = preset("fabind", hidden_size=16).model
    jcfg = jax_preset("fabind", hidden_size=16).model
    B, Nc, Np, C = 2, 6, 9, 16
    lig_mask, pkt_mask, h, _, _, pair, pair_mask = _side_inputs(
        rng, B, Nc, Np, C)
    x = (rng.randn(B, Nc + Np + 2, 3) * 0.8).astype(np.float32)
    d2 = ((x[:, 1:Nc + 1, None] - x[:, None, Nc + 2:]) ** 2).sum(-1)
    adj = (d2 < 2.0) & lig_mask[:, :, None] & pkt_mask[:, None, :]
    Kb = 6
    bond_idx = np.zeros((B, Nc, Kb), np.int32)
    bond_mask = np.zeros((B, Nc, Kb), bool)
    las_adj = np.zeros((B, Nc, Nc), bool)
    las_ref = np.zeros((B, Nc, 3), np.float32)
    gi_np = (lig_mask, pkt_mask, bond_idx, bond_mask, las_adj, las_ref)

    jmod = JaxInterAttention(jcfg, C, jcfg.normalize(10.0))
    jgi = JaxGI(*(jnp.asarray(a) for a in gi_np))
    jargs = (jnp.asarray(h), jnp.asarray(x), jnp.asarray(adj), jgi,
             jnp.asarray(pair), jnp.asarray(pair_mask))
    params = jmod.init(jax.random.PRNGKey(2), *jargs)["params"]
    # the released coord_mlp output init (gain 1e-3) would hide the gate in
    # the coordinate update: give it unit scale
    params = jax.tree_util.tree_map(np.asarray, params)
    params["coord_mlp"]["linear2"]["kernel"] = rng.randn(C, 1).astype(
        np.float32)
    want = jmod.apply({"params": params}, *jargs)

    mod = _port(InterAttention(cfg, C, cfg.normalize(10.0)), params)
    gi = GraphInputs(*(torch.from_numpy(a) for a in gi_np))
    before = edge_gate.KERNEL.launches
    with torch.inference_mode():
        got = mod(torch.from_numpy(h), torch.from_numpy(x),
                  torch.from_numpy(adj), gi, torch.from_numpy(pair),
                  torch.from_numpy(pair_mask))
    # CPU tensors take the plain version: no kernel launch is counted
    assert edge_gate.KERNEL.launches == before
    assert float(np.abs(np.asarray(want[1]) - x).max()) > 1e-3
    for g, w in zip(got, want):
        _close(g, w, atol=1e-5)
