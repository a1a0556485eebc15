"""The port's graph and geometry ops against the JAX package, on the CPU,
on dummy-batch coordinates (numpy, from a seed)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fabind_tpu.ops import graph as JG
from fabind_tpu.ops.geometry import las_projection_step as jax_las
from fabind_tpu.ops.gumbel import pocket_center_rounded as jax_center

from fabind_tpu_torch.config import preset
from fabind_tpu_torch.data.types import dummy_arrays
from fabind_tpu_torch.ops import graph as G
from fabind_tpu_torch.ops.geometry import las_projection_step
from fabind_tpu_torch.ops.gumbel import pocket_center_rounded

SHAPES = preset("fabind", max_ligand=12, max_pocket=20, max_protein=40,
                ctx_k=6).shapes


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's torch work: its tensors are
    toy-sized, and the suite runs in parallel workers that would otherwise
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def complex_inputs():
    """A docking complex assembled from a dummy batch: normalized coords
    [B, N, 3] in the [glb_c|lig|glb_p|pkt] layout and its masks."""
    a = dummy_arrays(SHAPES, batch_size=3, seed=0, n_lig_valid=9,
                     n_prot_valid=30)
    pkt = np.take_along_axis(a["prot_xyz"],
                             a["pocket_idx"][..., None].astype(np.int64), 1)
    z = np.zeros((3, 1, 3), np.float32)
    x = np.concatenate([z, a["lig_coords_init"], z, pkt], 1) / 5.0
    a["pocket_mask"][1, 15:] = False
    return x.astype(np.float32), a


def _t(a):
    return torch.from_numpy(np.asarray(a))


def test_ctx_graph_neighbour_sets_match_jax(complex_inputs):
    x, a = complex_inputs
    layout = G.ComplexLayout(SHAPES.max_ligand, SHAPES.max_pocket)
    args = (a["lig_mask"], a["pocket_mask"], a["bond_idx"], a["bond_mask"])
    want = JG.build_ctx_graph(jnp.asarray(x), JG.ComplexLayout(*layout),
                              *map(jnp.asarray, args), 1.6, SHAPES.ctx_k)
    got = G.build_ctx_graph(_t(x), layout, *map(_t, args), 1.6, SHAPES.ctx_k)
    assert got.nbr_idx.shape == want.nbr_idx.shape
    w_idx, w_mask = np.asarray(want.nbr_idx), np.asarray(want.nbr_mask)
    g_idx, g_mask = got.nbr_idx.numpy(), got.nbr_mask.numpy()
    n_truncated = 0
    # top_k and torch.topk may order ties differently: compare sets per row
    for b in range(x.shape[0]):
        for i in range(layout.n_nodes):
            assert (set(g_idx[b, i][g_mask[b, i]])
                    == set(w_idx[b, i][w_mask[b, i]]))
            n_truncated += g_mask[b, i].sum() == 1 + SHAPES.ctx_k
    assert n_truncated > 0       # some rows hit the top-K limit
    for f in ("glbc_src", "glbc_src_mask", "glbp_src", "glbp_src_mask"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)))
    np.testing.assert_array_equal(
        G.ctx_overflow_count(_t(x), layout, _t(a["pocket_mask"]), 1.6,
                             SHAPES.ctx_k).numpy(),
        np.asarray(JG.ctx_overflow_count(jnp.asarray(x), JG.ComplexLayout(
            *layout), jnp.asarray(a["pocket_mask"]), 1.6, SHAPES.ctx_k)))


def test_inter_graph_and_gather_match_jax(complex_inputs):
    x, a = complex_inputs
    layout = G.ComplexLayout(SHAPES.max_ligand, SHAPES.max_pocket)
    masks = (a["lig_mask"], a["pocket_mask"])
    want = JG.build_inter_graph(jnp.asarray(x), JG.ComplexLayout(*layout),
                                *map(jnp.asarray, masks), 2.0).adj
    got = G.build_inter_graph(_t(x), layout, *map(_t, masks), 2.0).adj
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 0 < got.sum() < got.numel()
    idx = np.random.RandomState(0).randint(0, x.shape[1], (3, 7, 4))
    np.testing.assert_array_equal(
        G.gather_nodes(_t(x), _t(idx).long()).numpy(),
        np.asarray(JG.gather_nodes(jnp.asarray(x), jnp.asarray(idx))))


@pytest.mark.parametrize("n_slots", [5, 12, 40])
def test_compact_keep_mask_matches_jax(n_slots):
    keep = np.random.RandomState(n_slots).rand(4, 30) < 0.3
    keep[2] = False
    want = JG.compact_keep_mask(jnp.asarray(keep), n_slots)
    got = G.compact_keep_mask(_t(keep), n_slots)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_las_projection_matches_jax(complex_inputs):
    x, a = complex_inputs
    lig = x[:, 1:1 + SHAPES.max_ligand] * 1.3
    ref = a["lig_rdkit_coords"] / 5.0
    want = jax_las(jnp.asarray(lig), jnp.asarray(ref),
                   jnp.asarray(a["las_adj"]), 0.01, 3.0, steps=2)
    got = las_projection_step(_t(lig), _t(ref), _t(a["las_adj"]), 0.01, 3.0,
                              steps=2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    assert np.abs(got.numpy() - lig).max() > 1e-4


def test_pocket_center_rounded_matches_jax(complex_inputs):
    _, a = complex_inputs
    rng = np.random.RandomState(1)
    logits = rng.randn(3, SHAPES.max_protein).astype(np.float32)
    logits[2] = -np.abs(logits[2]) - 0.1   # no positive residue: fallback
    logits *= a["prot_mask"]
    args = (logits, a["prot_xyz"], a["prot_mask"])
    want = jax_center(*map(jnp.asarray, args), 1.0, False)
    got = pocket_center_rounded(*map(_t, args), 1.0, False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
