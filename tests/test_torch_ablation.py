"""The ablation and extra model configurations of the port against the JAX
package on the CPU: the attention distance-pair bias, GaussianLayer, the
outer-product InteractionModule, EfficientMCAttModel for each flag
(triangle attention, the no-attention stacks, the implicit pair embedding,
InterAttention without the pair bias or without the cross attention layer,
`opm`), the flag combinations the JAX package cannot build, the
reference's dead checkpoint keys, and the dropout keys.
(test_torch_ablation_model.py runs the whole inference and a training
step.)

Same inputs (numpy, seeded) and the same weights (the JAX package's init,
carried across by state_dict_from_flax) in fp32 at hidden 16, 2 layers, 2
recycles, dropout 0. Every JAX call runs under jax.jit; the module tests
run JAX's init, the coordinate heads' rescale and the forward in one
jitted function. Tolerances as tests/test_ablation.py holds the JAX
package to the reference: coordinates 2e-4, h 2e-3 (keep_trig_attn 5e-4 /
5e-3).
"""
from __future__ import annotations

import hashlib
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fabind_tpu.config import preset as jax_preset
from fabind_tpu.data.types import FABindBatch as JaxBatch
from fabind_tpu.models.att_model import EfficientMCAttModel as JaxEMC
from fabind_tpu.models.egnn import GraphInputs as JaxGI
from fabind_tpu.models.fabind import make_model as jax_make_model
from fabind_tpu.models.layers import Attention as JaxAttention
from fabind_tpu.models.layers import GaussianLayer as JaxGaussianLayer
from fabind_tpu.models.layers import InteractionModule as JaxInteraction

from fabind_tpu_torch.config import preset
from fabind_tpu_torch.data.types import FABindBatch, dummy_arrays
from fabind_tpu_torch.models.att_model import EfficientMCAttModel
from fabind_tpu_torch.models.egnn import GraphInputs
from fabind_tpu_torch.models.fabind import init_params, make_model
from fabind_tpu_torch.models import layers
from fabind_tpu_torch.models.layers import (Attention, GaussianLayer,
                                            InteractionModule, dropout_rng)
from fabind_tpu_torch.ops import dropout as D
from fabind_tpu_torch.ops.edge_gate import phi_rank1_pair
from fabind_tpu_torch.train.checkpoints import load_into
from fabind_tpu_torch.train.convert import (load_torch_checkpoint,
                                            state_dict_from_flax)

HID = 16
X_ATOL, H_ATOL = 2e-4, 2e-3
TRIG_X_ATOL, TRIG_H_ATOL = 5e-4, 5e-3
# the flags of the ablation and extra configurations (each on top of the
# preset)
FLAGS = {
    "keep_trig_attn": dict(keep_trig_attn=True),
    "ablation_no_attention": dict(ablation_no_attention=True),
    "ablation_no_attention_with_cross_attn":
        dict(ablation_no_attention_with_cross_attn=True),
    "implicit_pair": dict(explicit_pair_embed=False,
                          add_cross_attn_layer=False),
    "no_cross_attn_layer": dict(add_cross_attn_layer=False),
    "no_attn_pair_bias": dict(add_attn_pair_bias=False),
    "opm": dict(add_cross_attn_layer=False, opm=True),
}
# configurations that launch the edge gate in a deterministic forward
GATE_FREE = ("ablation_no_attention", "ablation_no_attention_with_cross_attn")
# the whole model: one docking layer (the module tests run two), 2 recycles
TINY_FULL = dict(max_ligand=8, max_pocket=12, max_protein=24, ctx_k=6,
                 ctx_k_whole=6, hidden_size=HID, pocket_pred_hidden_size=HID,
                 mean_layers=1, n_iter=2, dropout=0.0, random_n_iter=False)


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


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=0)


def _unit_coord_heads(params):
    """The coordinate heads' output layers at unit scale (their 1e-3 init
    would keep the coordinate update near the tolerance)."""
    def scale(path, leaf):
        names = [getattr(k, "key", str(k)) for k in path]
        if names[-3:] == ["coord_mlp", "linear2", "kernel"]:
            return leaf * 1e3
        return leaf
    return jax.tree_util.tree_map_with_path(scale, params)


def _complex(seed, B=2, Nc=6, Np=10, C=HID):
    """A seeded complex in the dense layout [glb_c, ligand, glb_p, pocket],
    normalized coordinates: (x, h, GraphInputs arrays)."""
    rng = np.random.RandomState(seed)
    f32 = np.float32
    lig_mask = np.arange(Nc)[None] < np.array([[Nc], [Nc - 2]])
    pkt_mask = np.arange(Np)[None] < np.array([[Np], [Np - 3]])
    x = np.zeros((B, Nc + Np + 2, 3), f32)
    x[:, 1:Nc + 1] = rng.randn(B, Nc, 3) * 0.5 * lig_mask[..., None]
    x[:, Nc + 2:] = rng.randn(B, Np, 3) * 1.2 * pkt_mask[..., None]
    h = rng.randn(B, Nc + Np + 2, C).astype(f32)
    idx = np.arange(Nc)
    bond_idx = np.zeros((B, Nc, 6), np.int32)
    bond_idx[:, :, 0] = np.maximum(idx - 1, 0)
    bond_idx[:, :, 1] = np.minimum(idx + 1, Nc - 1)
    bond_mask = np.zeros((B, Nc, 6), bool)
    bond_mask[:, :, 0] = idx > 0
    bond_mask[:, :, 1] = idx + 1 < Nc
    bond_mask &= lig_mask[:, :, None]
    bond_mask[:, :, 1] &= np.roll(lig_mask, -1, axis=1)
    las = np.abs(idx[:, None] - idx[None, :])
    las = ((las == 1) | (las == 2))[None] & lig_mask[:, :, None] \
        & lig_mask[:, None, :]
    las_ref = (x[:, 1:Nc + 1] + 0.1 * rng.randn(B, Nc, 3)).astype(f32)
    gi = (lig_mask, pkt_mask, bond_idx, bond_mask, las, las_ref)
    return x, h, gi


@pytest.mark.parametrize("flag", list(FLAGS))
def test_efficient_mcatt_matches_jax(flag):
    """EfficientMCAttModel (2 layers, 2 recycles) for each flag: the new
    stacks and layers, and the edge gate where the stack keeps
    InterAttention. (FABind+'s form of the no-attention stack, with the
    cross attention, runs in test_torch_ablation_plus.py.)"""
    kw = dict(hidden_size=HID, pocket_pred_hidden_size=HID, dropout=0.0,
              **FLAGS[flag])
    cfg, jcfg = preset("fabind", **kw).model, jax_preset("fabind", **kw).model
    x, h, gi_np = _complex(0)
    jm = JaxEMC(jcfg, HID, HID, n_layers=2, n_iter=2, ctx_k=8)
    jgi = JaxGI(*(jnp.asarray(a) for a in gi_np))

    def run():
        k = jax.random.PRNGKey(0)
        p = jm.init({"params": k, "dropout": k, "sample": k}, x, h, jgi,
                    deterministic=True)["params"]
        p = _unit_coord_heads(p)
        return p, jm.apply({"params": p}, x, h, jgi, deterministic=True)

    params, (x_want, h_want, _) = jax.jit(run)()
    model = EfficientMCAttModel(cfg, HID, HID, n_layers=2, n_iter=2,
                                ctx_k=8)
    model.load_state_dict(state_dict_from_flax(
        _np_tree(params), is_plus=cfg.is_plus), strict=True)
    gi = GraphInputs(*(torch.from_numpy(a) for a in gi_np))
    calls = []

    def counted(*args):
        calls.append(1)
        return phi_rank1_pair(*args)

    with torch.inference_mode(), mock.patch.object(layers, "phi_rank1_pair",
                                                   counted):
        x_got, h_got, _ = model.eval()(torch.from_numpy(x),
                                       torch.from_numpy(h), gi)
    trig = flag == "keep_trig_attn"
    _close(x_got, x_want, TRIG_X_ATOL if trig else X_ATOL)
    _close(h_got, h_want, TRIG_H_ATOL if trig else H_ATOL)
    # the coordinate update is not a no-op at these weights
    assert float(np.abs(np.asarray(x_want) - x).max()) > 50 * X_ATOL
    # the paired gate once per InterAttention layer and round; none in the
    # no-attention stacks
    assert len(calls) == (0 if flag in GATE_FREE else 2 * 2)


def test_attention_distance_pair_bias_matches_jax():
    """Attention's distance bias, added before the softmax ("add") or
    multiplied after it ("mul")."""
    rng = np.random.RandomState(0)
    B, Q, K, H, D = 2, 4, 6, 2, 8
    qx = rng.randn(B, Q, 16).astype(np.float32)
    kx = rng.randn(B, K, 16).astype(np.float32)
    dist = rng.randn(B, Q, K, H).astype(np.float32)
    jm = JaxAttention(c_hidden=D, no_heads=H)

    def run():
        p = jm.init(jax.random.PRNGKey(0), qx, kx)
        return p, [jm.apply(p, qx, kx, distance=dist, dis_pair_type=t)
                   for t in ("none", "add", "mul")]

    params, want = jax.jit(run)()
    mod = Attention(16, 16, D, H)
    mod.load_state_dict(state_dict_from_flax(_np_tree(params["params"]),
                                             is_plus=True), strict=True)
    with torch.inference_mode():
        got = [mod(torch.from_numpy(qx), torch.from_numpy(kx),
                   distance=torch.from_numpy(dist), dis_pair_type=t)
               for t in ("none", "add", "mul")]
    for g, w in zip(got, want):
        _close(g, w, 1e-5)
    assert float((got[1] - got[0]).abs().max()) > 1e-3
    assert float((got[2] - got[0]).abs().max()) > 1e-3


def test_gaussian_layer_matches_jax():
    rng = np.random.RandomState(1)
    x = rng.uniform(0, 5, (3, 4, 5, 1)).astype(np.float32)
    jm = JaxGaussianLayer(K=16)
    params, want = jax.jit(lambda: (lambda p: (p, jm.apply(p, x)))(
        jm.init(jax.random.PRNGKey(0), x)))()
    mod = GaussianLayer(K=16)
    mod.load_state_dict(state_dict_from_flax(_np_tree(params["params"]),
                                             is_plus=True), strict=True)
    got = mod(torch.from_numpy(x))
    assert got.shape == (3, 4, 5, 16)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-30)


@pytest.mark.parametrize("opm", [False, True])
def test_interaction_module_matches_jax(opm):
    """The pair embedding, and with opm its outer product contracted
    without building [*, I, J, C*C]."""
    rng = np.random.RandomState(2)
    B, I, J, C, Hd = 2, 7, 5, 12, 6
    p = rng.randn(B, I, C).astype(np.float32)
    c = rng.randn(B, J, C).astype(np.float32)
    pm = np.arange(I)[None] < np.array([[I], [I - 2]])
    cm = np.arange(J)[None] < np.array([[J], [J - 1]])
    jm = JaxInteraction(Hd, C, opm=opm, rm_layernorm=False)
    params, (want, _) = jax.jit(lambda: (lambda v: (v, jm.apply(
        v, p, c, pm, cm)))(jm.init(jax.random.PRNGKey(3), p, c, pm, cm)))()
    mod = InteractionModule(C, C, Hd, C, opm=opm)
    mod.load_state_dict(state_dict_from_flax(_np_tree(params["params"]),
                                             is_plus=True), strict=True)
    with torch.inference_mode():
        got, mask = mod(*(torch.from_numpy(a) for a in (p, c, pm, cm)))
    _close(got, want, 1e-5)
    np.testing.assert_array_equal(mask.numpy(), pm[:, :, None] & cm[:, None])


# flag combinations the JAX package cannot build: a cross attention that
# reads a pair nobody built, or FABind+'s distance-map head without a pair
UNBUILDABLE = [
    ("fabind", dict(explicit_pair_embed=False)),
    ("fabind", dict(explicit_pair_embed=False, keep_trig_attn=True)),
    ("fabind", dict(explicit_pair_embed=False,
                    ablation_no_attention_with_cross_attn=True)),
    ("fabind_plus", dict(explicit_pair_embed=False,
                         ablation_no_attention=True)),
]


@pytest.mark.parametrize("variant,flags", UNBUILDABLE)
def test_unbuildable_combinations_raise_like_jax(variant, flags):
    kw = dict(TINY_FULL, **flags)
    with pytest.raises(ValueError, match="explicit_pair_embed=False"):
        make_model(preset(variant, **kw))
    jcfg = jax_preset(variant, **kw)
    jb = JaxBatch(**{k: jnp.asarray(v) for k, v in dummy_arrays(
        jcfg.shapes, batch_size=1, seed=0).items()})
    k = jax.random.PRNGKey(0)
    # the JAX package fails while it traces its init
    with pytest.raises((TypeError, AttributeError)):
        jax.eval_shape(lambda: jax_make_model(jcfg).init(
            {"params": k, "dropout": k, "sample": k}, jb,
            method="inference_diag"))


def test_rel_dis_pair_bias_is_read_by_no_module():
    """As in the JAX package, the flag builds and changes nothing."""
    kw = dict(TINY_FULL, hidden_size=8, pocket_pred_hidden_size=8)
    a, b = make_model(preset("fabind_plus", **kw)), make_model(
        preset("fabind_plus", rel_dis_pair_bias="add", **kw))
    init_params(a, torch.Generator().manual_seed(0))
    b.load_state_dict(a.state_dict(), strict=True)
    arrays = dummy_arrays(a.shapes, batch_size=1, seed=2)
    batch = FABindBatch.from_numpy(arrays, "cpu")
    with torch.inference_mode():
        torch.testing.assert_close(a.eval().inference_diag(batch)[0],
                                   b.eval().inference_diag(batch)[0],
                                   rtol=0, atol=0)


def test_checkpoint_skips_exactly_the_reference_dead_keys(tmp_path):
    """A reference checkpoint of an ablation holds keys its forward never
    runs; load_torch_checkpoint(path, model) drops those the model lacks
    and keeps everything else, so a strict load still refuses a key that
    does not belong."""
    cfg = preset("fabind", keep_trig_attn=True,
                 ablation_no_attention_with_cross_attn=True,
                 **dict(TINY_FULL, hidden_size=8, pocket_pred_hidden_size=8))
    model = make_model(cfg)
    sd = {"module." + k: v for k, v in model.state_dict().items()}
    dead = ["complex_model.gnn.att_0.inter_layer.linear_p.weight",
            "complex_model.gnn.inter_layer.linear_out.bias",
            "complex_model.gnn.cross_attn_module.triangle_block_column."
            "mha.linear_q.weight",
            "complex_model.p_p_dist_layer.rbf.offset"]
    for k in dead:
        sd["module." + k] = torch.zeros(2)
    path = tmp_path / "ablation.bin"
    torch.save(sd, path)
    got = load_torch_checkpoint(str(path), model)
    assert set(got) == set(model.state_dict())
    model.load_state_dict(got, strict=True)
    # the CLIs' loader (a released .bin through load_weights) drops them too
    assert load_into(model, load_torch_checkpoint(str(path))) == []
    assert set(load_torch_checkpoint(str(path))) == set(
        model.state_dict()) | set(dead)
    # a live key of the same pattern is kept, an unknown key stays
    sd["module.complex_model.gnn.att_9.weight"] = torch.zeros(1)
    torch.save(sd, path)
    got = load_torch_checkpoint(str(path), model)
    assert "complex_model.gnn.att_9.weight" in got
    assert "complex_model.inter_layer.linear_p.weight" in got
    with pytest.raises(RuntimeError, match="Unexpected"):
        model.load_state_dict(got, strict=True)


# a `fabind` training forward's dropout keys (site, call, round, rate,
# shape), the same on the tree before the ablation modules were added:
# every mask is a function of its key and the seed alone
FABIND_DROPOUT_CALLS = 146
FABIND_DROPOUT_KEYS = "d854760fd9c7c073"


def _dropout_keys(cfg, seeds=(3, 4)):
    keys = []
    orig = D.dropout_reference

    def record(x, seed, rnd, site, call, rate, *rows):
        keys.append((site, call, int(rnd), rate, tuple(x.shape)))
        return orig(x, seed, rnd, site, call, rate, *rows)

    model = make_model(cfg)
    init_params(model, torch.Generator().manual_seed(0))
    model.train()
    batch = FABindBatch.from_numpy(dummy_arrays(
        cfg.shapes, batch_size=2, seed=0, n_lig_valid=6, n_prot_valid=24,
        prot_feat_dim=cfg.model.protein_feat_dim), "cpu")
    D.dropout_reference = record
    try:
        for seed in seeds:
            with dropout_rng(torch.Generator().manual_seed(seed)):
                model(batch)
    finally:
        D.dropout_reference = orig
    return keys


def test_fabind_training_draws_the_same_dropout_masks():
    cfg = preset("fabind", max_ligand=8, max_pocket=16, max_protein=32,
                 ctx_k=6, ctx_k_whole=6, hidden_size=16,
                 pocket_pred_hidden_size=16, mean_layers=2, n_iter=3,
                 dropout=0.1)
    keys = _dropout_keys(cfg)
    assert len(keys) == FABIND_DROPOUT_CALLS
    assert hashlib.sha256(repr(keys).encode()).hexdigest()[:16] \
        == FABIND_DROPOUT_KEYS


@pytest.mark.parametrize("flag", list(FLAGS))
def test_new_dropout_sites_draw_distinct_keys(flag):
    """In a training forward of each configuration no (site, call, round)
    key is drawn twice: modules called more than once in a round (the
    triangle block, the shared cross attention, the bipartite EGCL's two
    directions) pass call indices."""
    cfg = preset("fabind", **dict(TINY_FULL, dropout=0.1, n_iter=3,
                                  random_n_iter=True, **FLAGS[flag]))
    keys = [k[:3] for k in _dropout_keys(cfg, seeds=(5,))]
    assert len(keys) == len(set(keys))
