"""The port's FABind+ forward against the JAX package, on the CPU.

Same inputs (numpy, from a seed) and the same weights (flax init, carried
across by state_dict_from_flax(..., is_plus=True) and loaded with
strict=True) go through both packages at toy width (tests/common.py TINY,
two docking layers): the LayerNorm edge-MLP decomposition, EGCL,
InterAttention and CrossAttentionModule with is_plus, the eval forward at
stages 1 and 2, inference with the confidence head, and DockingEngine
.dock_raw in fp32 and bf16. fp32 atol 2e-4, as tests/test_torch_model.py.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from common import TINY
from test_serve import make_raw
from test_torch_model import _side_inputs
from test_torch_serve import POSE_SLACK_A, _small

from fabind_tpu.config import preset as jax_preset
from fabind_tpu.data.types import FABindBatch as JaxBatch
from fabind_tpu.models.cross_att import CrossAttentionModule as JaxCross
from fabind_tpu.models.egnn import EGCL as JaxEGCL
from fabind_tpu.models.egnn import GraphInputs as JaxGI
from fabind_tpu.models.egnn import InterAttention as JaxInterAttention
from fabind_tpu.models.fabind import make_model as jax_make_model
from fabind_tpu.ops import graph as JG
from fabind_tpu.serve import DockingEngine as JaxEngine

from fabind_tpu_torch.config import preset
from fabind_tpu_torch.data.types import FABindBatch, dummy_arrays
from fabind_tpu_torch.models.cross_att import CrossAttentionModule
from fabind_tpu_torch.models.egnn import EGCL, GraphInputs, InterAttention
from fabind_tpu_torch.models.fabind import make_model
from fabind_tpu_torch.models.layers import MLPBlock
from fabind_tpu_torch.ops import edge_gate
from fabind_tpu_torch.ops import graph as G
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
                                                is_plus=True), strict=True)
    return module.eval()


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=0)


def _model_fixture(name):
    """(cfg, jcfg, jmodel, flax params, port model, jax batch, port batch)
    for preset `name` at toy width; the batch's proteins (40 of 48 rows)
    overflow the 24 pocket slots of a 20 A crop, as served batches do."""
    cfg, jcfg = preset(name, **KW), jax_preset(name, **KW)
    arrays = dummy_arrays(cfg.shapes, batch_size=2, seed=0, n_lig_valid=9,
                          n_prot_valid=40)
    jbatch = JaxBatch(**{k: jnp.asarray(v) for k, v in arrays.items()})
    jmodel = jax_make_model(jcfg)
    k = jax.random.PRNGKey(0)
    params = _np_tree(jax.jit(lambda: jmodel.init(
        {"params": k, "dropout": k, "sample": k}, jbatch, train=False,
        stage=2))()["params"])
    model = _port(make_model(cfg), params)
    return (cfg, jcfg, jmodel, params, model, jbatch,
            FABindBatch.from_numpy(arrays, "cpu"))


@pytest.fixture(scope="module")
def plus():
    return _model_fixture("fabind_plus")


@pytest.fixture(scope="module")
def plus_sampling():
    return _model_fixture("fabind_plus_sampling")


# ------------------------------------------------------------------ modules
def test_ln_edge_messages_match_undecomposed_mlp():
    """MLPBlock.ln_l1_parts + ln_l1_edges (the EGCL's per-node LayerNorm
    decomposition) against the edge MLP over the concatenated edge input,
    with a non-trivial LayerNorm affine."""
    g = torch.Generator().manual_seed(0)
    B, N, K, C, H = 2, 7, 5, 12, 12
    mlp = MLPBlock(2 * C + 1, H, H, act="relu", use_ln=True, last_act=True,
                   dropout_rate=0.1, dropout_pos="both").eval()
    with torch.no_grad():
        for p in mlp.parameters():
            p.copy_(torch.randn(p.shape, generator=g))
    h = torch.randn(B, N, C, generator=g) * 3 + 1
    idx = torch.randint(0, N, (B, N, K), generator=g)
    radial = torch.rand(B, N, K, generator=g) * 4
    h_src = G.gather_nodes(h, idx)                           # [B, N, K, C]
    with torch.no_grad():
        parts = mlp.ln_l1_parts(h)
        pre = mlp.ln_l1_edges(parts, parts.a[:, :, None], parts.t[..., None],
                              parts.q[..., None], h_src, radial)
        v = torch.cat([h[:, :, None].expand(-1, -1, K, -1), h_src,
                       radial[..., None]], dim=-1)
        want = mlp.lin1(mlp.layernorm(v))
        np.testing.assert_allclose(pre.numpy(), want.numpy(), atol=1e-4,
                                   rtol=0)
        np.testing.assert_allclose(mlp.finish(pre).numpy(),
                                   mlp(v).numpy(), atol=1e-4, rtol=0)


def _graph_case(rng, B=2, Nc=6, Np=9, C=16):
    lig_mask, pkt_mask, h, _, _, pair, pair_mask = _side_inputs(
        rng, B, Nc, Np, C)
    x = (rng.randn(B, Nc + Np + 2, 3) * 0.8).astype(np.float32)
    gi_np = (lig_mask, pkt_mask, np.zeros((B, Nc, 6), np.int32),
             np.zeros((B, Nc, 6), bool), np.zeros((B, Nc, Nc), bool),
             np.zeros((B, Nc, 3), np.float32))
    gi_np[2][:, :, 0] = np.maximum(np.arange(Nc) - 1, 0)
    gi_np[3][:, 1:, 0] = lig_mask[:, 1:]
    return h, x, pair, pair_mask, gi_np


def _gis(gi_np):
    return (JaxGI(*(jnp.asarray(a) for a in gi_np)),
            GraphInputs(*(torch.from_numpy(a) for a in gi_np)))


def test_egcl_plus_matches_jax():
    """EGCL with the released FABind+ edge MLPs (LayerNorm, relu, hidden
    scale 1) over a ctx graph with bonds, radius edges and both global
    tokens."""
    rng = np.random.RandomState(0)
    cfg = preset("fabind_plus", hidden_size=16).model
    jcfg = jax_preset("fabind_plus", hidden_size=16).model
    h, x, _, _, gi_np = _graph_case(rng)
    jgi, gi = _gis(gi_np)
    layout = JG.ComplexLayout(6, 9)
    jctx = JG.build_ctx_graph(jnp.asarray(x), layout, *jgi[:4], 1.2, 4)
    ctx = G.CtxGraph(*(torch.from_numpy(np.array(a)).long()
                       if np.asarray(a).dtype.kind in "iu"
                       else torch.from_numpy(np.array(a)) for a in jctx))
    assert int(np.asarray(jctx.nbr_mask).sum()) > 20
    jmod = JaxEGCL(jcfg, 16, jcfg.normalize(10.0))
    jargs = (jnp.asarray(h), jnp.asarray(x), jctx, jgi)
    params = _np_tree(jax.jit(jmod.init)(jax.random.PRNGKey(1),
                                         *jargs)["params"])
    # unit-scale coord_mlp output and a non-trivial LayerNorm affine
    params["coord_mlp"]["linear2"]["kernel"] = rng.randn(16, 1).astype(
        np.float32)
    ln = params["edge_mlp"]["layernorm"]
    ln["scale"] = (1 + 0.3 * rng.randn(*ln["scale"].shape)).astype(np.float32)
    ln["bias"] = (0.3 * rng.randn(*ln["bias"].shape)).astype(np.float32)
    want = jax.jit(jmod.apply)({"params": params}, *jargs)
    mod = _port(EGCL(cfg, 16, cfg.normalize(10.0)), params)
    with torch.inference_mode():
        got = mod(torch.from_numpy(h), torch.from_numpy(x), ctx, gi)
    assert float(np.abs(np.asarray(want[1]) - x).max()) > 1e-3
    for g, w in zip(got, want):
        _close(g, w, atol=1e-5)


def test_inter_attention_plus_matches_jax():
    """InterAttention with is_plus: the undecomposed LayerNorm coord MLP
    over every edge value (no edge-gate launch), the cross attention's
    MLPBlock transitions and the pair it returns, and
    inter_additional_mlp."""
    rng = np.random.RandomState(1)
    kw = dict(hidden_size=16, inter_additional_mlp=True)
    cfg, jcfg = preset("fabind_plus", **kw).model, \
        jax_preset("fabind_plus", **kw).model
    h, x, pair, pair_mask, gi_np = _graph_case(rng)
    jgi, gi = _gis(gi_np)
    d2 = ((x[:, 1:7, None] - x[:, None, 8:]) ** 2).sum(-1)
    adj = (d2 < 2.0) & gi_np[0][:, :, None] & gi_np[1][:, None, :]
    jmod = JaxInterAttention(jcfg, 16, jcfg.normalize(10.0))
    jargs = [jnp.asarray(a) for a in (h, x, adj)] + [jgi] + [
        jnp.asarray(a) for a in (pair, pair_mask)]
    params = _np_tree(jax.jit(jmod.init)(jax.random.PRNGKey(2),
                                         *jargs)["params"])
    params["coord_mlp"]["linear2"]["kernel"] = rng.randn(16, 1).astype(
        np.float32)
    want = jax.jit(jmod.apply)({"params": params}, *jargs)
    mod = _port(InterAttention(cfg, 16, cfg.normalize(10.0)), params)
    before = edge_gate.KERNEL.launches
    with torch.inference_mode():
        got = mod(torch.from_numpy(h), torch.from_numpy(x),
                  torch.from_numpy(adj), gi, torch.from_numpy(pair),
                  torch.from_numpy(pair_mask))
    assert edge_gate.KERNEL.launches == before
    assert float(np.abs(np.asarray(want[1]) - x).max()) > 1e-3
    for g, w in zip(got, want):
        _close(g, w, atol=1e-5)


def test_cross_attention_plus_matches_jax():
    rng = np.random.RandomState(0)
    B, Nc, Np, C = 2, 6, 9, 16
    _, _, h, pm, cm, pair, pair_mask = _side_inputs(rng, B, Nc, Np, C)
    p_side, c_side = h[:, Nc + 1:], h[:, :Nc + 1]
    jmod = JaxCross(rm_layernorm=True, dropout_rate=0.1, is_plus=True,
                    mlp_hidden_scale=1, use_ln_mlp=True)
    args = (p_side, pm, c_side, cm, pair, pair_mask)
    params = jmod.init(jax.random.PRNGKey(1), *args)["params"]
    want = jmod.apply({"params": params}, *args)
    mod = _port(CrossAttentionModule(C, rm_layernorm=True, is_plus=True,
                                     mlp_hidden_scale=1, use_ln_mlp=True),
                params)
    with torch.inference_mode():
        got = mod(*(torch.from_numpy(a) for a in args))
    for g, w in zip(got, want):
        _close(g, w, atol=1e-5)


# ------------------------------------------------------------------- model
@pytest.mark.parametrize("stage", [1, 2])
def test_plus_forward_matches_jax(plus, stage):
    _, _, jmodel, params, model, jbatch, batch = plus
    want = jax.jit(lambda p, b: jmodel.apply({"params": p}, b, train=False,
                                             stage=stage))(params, jbatch)
    with torch.inference_mode():
        got = model(batch, stage=stage)
    for f in ("pocket_cls_logits", "pocket_radius_pred", "pred_pocket_center",
              "coords", "y_pred", "y_pred_by_coord", "dis_map_target"):
        _close(getattr(got, f), getattr(want, f))
    np.testing.assert_array_equal(got.pkt_mask.numpy(),
                                  np.asarray(want.pkt_mask))
    m = got.pkt_mask.numpy()
    np.testing.assert_array_equal(got.pkt_idx.numpy()[m],
                                  np.asarray(want.pkt_idx)[m])
    for f in ("keep_less_5", "pocket_overflow", "ctx_overflow"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)))
    assert float(np.abs(np.asarray(want.confidence)).max()) == 0.0
    assert float(got.confidence.abs().max()) == 0.0
    if stage == 2:
        # the predicted radius sets the crop: the crop is not the fixed one
        assert float(got.pocket_radius_pred.max()) > 0
        assert int(got.pocket_overflow.max()) > 0


def test_plus_inference_with_confidence_matches_jax(plus_sampling):
    _, _, jmodel, params, model, jbatch, batch = plus_sampling
    want, wconf = jax.jit(lambda p, b: jmodel.apply(
        {"params": p}, b, method="inference"))(params, jbatch)
    with torch.inference_mode():
        got, conf = model.inference(batch)
    _close(got, want)
    _close(conf, wconf)
    assert float(np.abs(np.asarray(wconf)).min()) > 0


# ------------------------------------------------------------------ serving
def test_plus_dock_raw_matches_jax(plus):
    """DockingEngine.dock_raw for FABind+ on both sides over two buckets:
    fp32 Pose for Pose within ATOL, bf16 within the bound of
    tests/test_torch_serve.py (2x the JAX package's own bf16-vs-fp32 mean
    per-atom distance + POSE_SLACK_A)."""
    cfg, jcfg, _, params, _, _, _ = plus
    raws = [make_raw(n=5, nr=20, seed=1), make_raw(n=12, nr=40, seed=2),
            make_raw(n=40, nr=40, seed=3), make_raw(n=7, nr=30, seed=4)]
    buckets = [_small(cfg.shapes), cfg.shapes]
    jbuckets = [_small(jcfg.shapes), jcfg.shapes]
    sd = state_dict_from_flax(params, is_plus=True)
    d_port, d_jax = [], []
    want32 = JaxEngine(jcfg, params=params, buckets=jbuckets, batch_size=2,
                       bf16=False).dock_raw(raws)
    for bf16 in (False, True):
        want = want32 if not bf16 else JaxEngine(
            jcfg, params=params, buckets=jbuckets, batch_size=2,
            bf16=True).dock_raw(raws)
        got = DockingEngine(cfg, state_dict=sd, buckets=buckets,
                            batch_size=2, bf16=bf16,
                            device="cpu").dock_raw(raws)
        for g, w, w32 in zip(got, want, want32):
            assert (g.error is None) == (w.error is None)
            if w.error is not None:
                assert "exceeds" in g.error and "exceeds" in w.error
                continue
            assert g.coords.shape == w.coords.shape
            assert g.coords.dtype == np.float32
            assert g.pocket_truncated == w.pocket_truncated
            if not bf16:
                _close(g.coords, w.coords)
                assert g.confidence == w.confidence == 0.0
            else:
                d_port.append(np.linalg.norm(g.coords - w.coords, axis=-1))
                d_jax.append(np.linalg.norm(w.coords - w32.coords, axis=-1))
    d_port, d_jax = np.concatenate(d_port), np.concatenate(d_jax)
    assert d_jax.mean() > 0
    assert d_port.mean() <= 2 * d_jax.mean() + POSE_SLACK_A, \
        (d_port.mean(), d_jax.mean())
