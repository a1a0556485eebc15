"""The port's serving layer against the JAX package, on the CPU: shape
buckets, the bf16 cast of the modules that hold the edge gate, bf16
`DockingEngine.dock_raw` over two buckets, the device protein-row cache,
`dock_screen`, `warmup` and concurrent calls.

Same requests (numpy, from a seed) and the same weights (flax init, carried
across in fp32 by state_dict_from_flax; the bf16 cast rounds to nearest even
on both sides, so the bf16 weights are equal bit for bit) go through both
packages, at the toy widths of tests/common.py TINY.
"""
from __future__ import annotations

import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from common import TINY
from test_serve import make_raw
from test_torch_model import _side_inputs

from fabind_tpu.config import preset as jax_preset
from fabind_tpu.data import buckets as JB
from fabind_tpu.data.batching import build_sample as jax_build_sample
from fabind_tpu.models.egnn import GraphInputs as JaxGI
from fabind_tpu.models.egnn import InterAttention as JaxInterAttention
from fabind_tpu.models.layers import MLPBlock as JaxMLPBlock
from fabind_tpu.ops import graph as JG
from fabind_tpu.ops.pallas.edge_gate import phi_rank1_pallas
from fabind_tpu.serve import DockingEngine as JaxEngine
from fabind_tpu.utils.precision import cast_tree_bf16

from fabind_tpu_torch.config import preset
from fabind_tpu_torch.data import buckets as B
from fabind_tpu_torch.data.batching import build_sample
from fabind_tpu_torch.models.egnn import GraphInputs, InterAttention
from fabind_tpu_torch.models.layers import MLPBlock
from fabind_tpu_torch.ops import graph as G
from fabind_tpu_torch.ops.gumbel import pocket_center_rounded
from fabind_tpu_torch.serve import DockingEngine
from fabind_tpu_torch.train.convert import state_dict_from_flax
from fabind_tpu_torch.utils.precision import cast_module_bf16

BF = torch.bfloat16
# bf16 modules against the JAX package's bf16 modules: both round every
# activation to bf16 (8 significant bits, a relative step of 2^-8), but at
# other places (XLA fuses and rounds its own way; the port's gate sums in
# fp32 and rounds once), so outputs of magnitude ~10 agree to a few bf16
# steps, not bit for bit
BF16_ATOL, BF16_RTOL = 0.1, 2e-2
# the pose bound of the issue's criterion: mean per-atom distance to the JAX
# bf16 pose at most 2x the JAX bf16-vs-fp32 mean distance, plus this
POSE_SLACK_A = 1e-3


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


def _shape_tuples(shapes):
    return [dataclasses.astuple(s) for s in shapes]


def _small(shapes):
    return dataclasses.replace(shapes, max_ligand=8, max_pocket=16,
                               max_protein=32)


class _Source:
    def __init__(self, raws):
        self.raws = raws

    def get(self, i):
        return self.raws[i]


def _raws():
    """Requests for both TINY buckets (8:16:32 and 16:24:48), one too large
    for either, in mixed order."""
    return [make_raw(n=5, nr=20, seed=1), make_raw(n=12, nr=40, seed=2),
            make_raw(n=40, nr=40, seed=3), make_raw(n=6, nr=20, seed=4),
            make_raw(n=7, nr=30, seed=5), make_raw(n=14, nr=44, seed=6)]


# ------------------------------------------------------------------ buckets
def test_bucket_functions_match_jax():
    cfg, jcfg = preset("fabind", **TINY), jax_preset("fabind", **TINY)
    rng = np.random.RandomState(0)
    sizes = np.stack([rng.randint(4, 20, 40), rng.randint(4, 30, 40),
                      rng.randint(10, 56, 40)], 1)
    for k in (1, 2, 3):
        got = B.suggest_buckets(sizes, cfg, k=k)
        want = JB.suggest_buckets(sizes, jcfg, k=k)
        assert _shape_tuples(got) == _shape_tuples(want)
    assert len(B.suggest_buckets(sizes, cfg, k=3)) > 1
    assert B._cost(sizes, (8, 16, 32), 0.05) == JB._cost(sizes, (8, 16, 32),
                                                        0.05)

    raws = _raws()
    src = _Source(raws)
    for spec in (None, "none", "8:16:32,16:24:48", "auto:2", "auto"):
        got = B.resolve_buckets(spec, cfg, src, range(len(raws)))
        want = JB.resolve_buckets(spec, jcfg, src, range(len(raws)))
        assert (got is None) == (want is None)
        if got is not None:
            assert _shape_tuples(got) == _shape_tuples(want)
    np.testing.assert_array_equal(
        B.measure_sizes(src, range(len(raws)), cfg, limit=4),
        JB.measure_sizes(src, range(len(raws)), jcfg, limit=4))

    buckets = B.resolve_buckets("8:16:32,16:24:48", cfg)
    got_cfgs = B.sort_bucket_cfgs(cfg, buckets[::-1])
    want_cfgs = JB.sort_bucket_cfgs(
        jcfg, JB.resolve_buckets("16:24:48,8:16:32", jcfg))
    assert (_shape_tuples(c.shapes for c in got_cfgs)
            == _shape_tuples(c.shapes for c in want_cfgs))
    for raw in raws:
        got = B.route_sample(build_sample(raw, cfg, group="test"), got_cfgs)
        want = JB.route_sample(jax_build_sample(raw, jcfg, group="test"),
                               want_cfgs)
        assert ((None if got is None else got_cfgs.index(got))
                == (None if want is None else want_cfgs.index(want)))
    with pytest.raises(ValueError, match="cover"):
        B.sort_bucket_cfgs(cfg, buckets[:1])


# ------------------------------------------------------- bf16 modules
def test_mlpblock_rank1_pair_bf16_matches_jax():
    """The gate's entry in bf16 against the JAX MLPBlock under
    cast_tree_bf16 (its materialized jnp path, both directions), and the
    port's plain gate against the Pallas kernel in interpret mode on the
    same bf16 inputs (both compute in fp32 and round once: within one bf16
    step)."""
    rng = np.random.RandomState(3)
    Bn, Na, Nb, H = 2, 6, 10, 24
    l1_a, l1_b, r = (rng.randn(*s).astype(np.float32)
                     for s in ((Bn, Na, H), (Bn, Nb, H), (Bn, Na, Nb)))
    u = rng.randn(H).astype(np.float32)
    jmod = JaxMLPBlock(hidden_dim=H, out_dim=1, act="silu", bias_out=True)
    params = jmod.init(jax.random.PRNGKey(0), jnp.zeros((1, H)))["params"]
    mod = MLPBlock(H, H, 1, act="silu", bias_out=True).eval()
    with torch.no_grad():
        mod.lin1.weight.copy_(torch.from_numpy(
            np.asarray(params["linear1"]["kernel"]).T))
        mod.lin1.bias.copy_(torch.from_numpy(
            np.asarray(params["linear1"]["bias"])))
        mod.lin2.weight.copy_(torch.from_numpy(
            np.asarray(params["linear2"]["kernel"]).T))
        mod.lin2.bias.copy_(torch.from_numpy(
            np.asarray(params["linear2"]["bias"])))
    cast_module_bf16(mod)
    assert all(p.dtype == BF for p in mod.parameters())
    jp = cast_tree_bf16(params)
    bf = [jnp.asarray(a, jnp.bfloat16) for a in (l1_a, l1_b, r, u)]

    def jgate(l1, rr):
        return jmod.apply({"params": jp}, l1, rr, bf[3],
                          method="finish_scalar_rank1")

    want = (jgate(bf[1], bf[2]), jgate(bf[0], bf[2].transpose(0, 2, 1)))
    with torch.no_grad():
        got = mod.finish_scalar_rank1_pair(
            *(torch.from_numpy(a).to(BF) for a in (l1_a, l1_b, r, u)))
    w2 = jp["linear2"]["kernel"][:, 0]
    pallas = [phi_rank1_pallas(l1, rr, bf[3], w2, act="silu", block_d=4,
                               interpret=True) + jp["linear2"]["bias"][0]
              for l1, rr in ((bf[1], bf[2]),
                             (bf[0], bf[2].transpose(0, 2, 1)))]
    for g, w, p in zip(got, want, pallas):
        assert g.dtype == BF and w.dtype == jnp.bfloat16
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w, np.float32),
                                   atol=BF16_ATOL, rtol=BF16_RTOL)
        # the bias add rounds once more on each side: two bf16 steps
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(p, np.float32),
                                   atol=0, rtol=2 * 2.0 ** -8)


def test_inter_attention_bf16_matches_jax():
    """InterAttention (cross attention, both directions, the gate) in bf16
    against the JAX module under cast_tree_bf16."""
    rng = np.random.RandomState(1)
    cfg = preset("fabind", hidden_size=16).model
    jcfg = jax_preset("fabind", hidden_size=16).model
    Bn, Nc, Np, C = 2, 6, 9, 16
    lig_mask, pkt_mask, h, _, _, pair, pair_mask = _side_inputs(
        rng, Bn, Nc, Np, C)
    x = (rng.randn(Bn, Nc + Np + 2, 3) * 0.8).astype(np.float32)
    d2 = ((x[:, 1:Nc + 1, None] - x[:, None, Nc + 2:]) ** 2).sum(-1)
    adj = (d2 < 2.0) & lig_mask[:, :, None] & pkt_mask[:, None, :]
    gi_np = (lig_mask, pkt_mask, np.zeros((Bn, Nc, 6), np.int32),
             np.zeros((Bn, Nc, 6), bool), np.zeros((Bn, Nc, Nc), bool),
             np.zeros((Bn, Nc, 3), np.float32))
    jmod = JaxInterAttention(jcfg, C, jcfg.normalize(10.0))
    jgi = JaxGI(*(jnp.asarray(a) for a in gi_np))
    jargs = [jnp.asarray(a) for a in (h, x, adj)] + [jgi] + [
        jnp.asarray(a) for a in (pair, pair_mask)]
    params = _np_tree(jax.jit(jmod.init)(jax.random.PRNGKey(2),
                                         *jargs)["params"])
    # unit-scale coord_mlp output, so the gate shows in the coordinates
    params["coord_mlp"]["linear2"]["kernel"] = rng.randn(C, 1).astype(
        np.float32)
    jb = [cast_tree_bf16(a) for a in jargs]
    want = jax.jit(jmod.apply)({"params": cast_tree_bf16(params)}, *jb)

    mod = InterAttention(cfg, C, cfg.normalize(10.0))
    mod.load_state_dict(state_dict_from_flax(params, is_plus=False),
                        strict=True)
    cast_module_bf16(mod.eval())
    gi = GraphInputs(*(torch.from_numpy(a) for a in gi_np[:5]),
                     torch.from_numpy(gi_np[5]).to(BF))
    with torch.inference_mode():
        got = mod(torch.from_numpy(h).to(BF), torch.from_numpy(x).to(BF),
                  torch.from_numpy(adj), gi, torch.from_numpy(pair).to(BF),
                  torch.from_numpy(pair_mask))
    assert float(np.abs(np.asarray(want[1], np.float32) - x).max()) > 1e-2
    for g, w in zip(got, want):
        assert g.dtype == BF
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w, np.float32),
                                   atol=BF16_ATOL, rtol=BF16_RTOL)


# ------------------------------------------------------- engine fixture
@pytest.fixture(scope="module")
def served():
    """fp32 flax weights at TINY, the JAX engine's own init (its serving
    tests compile the same programs), and both packages' engines over the
    two TINY buckets."""
    cfg, jcfg = preset("fabind", **TINY), jax_preset("fabind", **TINY)
    buckets = [_small(cfg.shapes), cfg.shapes]
    jbuckets = [_small(jcfg.shapes), jcfg.shapes]
    j32 = JaxEngine(jcfg, buckets=jbuckets, batch_size=2, bf16=False)
    sd = state_dict_from_flax(_np_tree(j32.params), is_plus=False)
    j16 = JaxEngine(jcfg, params=_np_tree(j32.params), buckets=jbuckets,
                    batch_size=2, bf16=True)
    eng = DockingEngine(cfg, state_dict=sd, buckets=buckets, batch_size=2,
                        device="cpu")
    return cfg, buckets, sd, j32, j16, eng


def _dist(a, b):
    return np.linalg.norm(np.asarray(a, np.float64) - b, axis=-1)


def test_engine_defaults_and_shared_weights(served):
    cfg, buckets, sd, _, _, eng = served
    assert eng.bf16 and eng.dtype == BF
    assert all(p.dtype == BF for p in eng.model.parameters())
    assert [c.shapes for c in eng.bucket_cfgs] == buckets
    # one copy of the weights serves both buckets: every parameter tensor
    # is the engine's one module's, and their count is one model's
    n_model = sum(t.numel() for t in sd.values())
    assert sum(p.numel() for p in eng.model.parameters()) == n_model
    ptrs = {p.data_ptr() for p in eng.model.parameters()}
    assert len(ptrs) == len(list(eng.model.parameters()))


def test_dock_raw_bf16_matches_jax_bf16(served):
    """bf16 dock_raw over two buckets against the JAX engine's bf16
    dock_raw on the same weights and requests: the same errors, the same
    predicted pocket crops and whole-protein neighbour tables, and a mean
    per-atom pose difference within 2x the JAX package's own bf16-vs-fp32
    difference (+ POSE_SLACK_A)."""
    cfg, _, _, j32, j16, eng = served
    raws = _raws()
    got, want, want32 = eng.dock_raw(raws), j16.dock_raw(raws), \
        j32.dock_raw(raws)
    d_port, d_jax = [], []
    for g, w, w32 in zip(got, want, want32):
        assert (g.error is None) == (w.error is None)
        if w.error is not None:
            assert "exceeds every bucket" in g.error
            continue
        assert g.coords.dtype == np.float32
        assert g.coords.shape == w.coords.shape
        assert g.pocket_truncated == w.pocket_truncated
        d_port.append(_dist(g.coords, w.coords))
        d_jax.append(_dist(w.coords, w32.coords))
    d_port, d_jax = np.concatenate(d_port), np.concatenate(d_jax)
    assert d_jax.mean() > 0
    assert d_port.mean() <= 2 * d_jax.mean() + POSE_SLACK_A, \
        (d_port.mean(), d_jax.mean())

    # the crop and the neighbour table on the same bf16 batches
    jres, res = [None] * len(raws), [None] * len(raws)
    jbatches = list(j16._routed_batches(raws, jres))
    batches = list(eng.batches(raws, res))
    assert len(batches) == len(jbatches) == 3
    for (chunk, cfg_b, batch, _), (jchunk, jcfg_b, jbatch, _) in zip(
            batches, jbatches):
        assert [p for p, _ in chunk] == [p for p, _ in jchunk]
        assert cfg_b.shapes.max_protein == jcfg_b.shapes.max_protein
        for f in ("prot_xyz", "lig_coords_init", "prot_feat"):
            np.testing.assert_array_equal(
                getattr(batch, f).float().numpy(),
                np.asarray(getattr(jbatch, f), np.float32))
        jmodel = j16._models[id(jcfg_b)]
        _, _, jidx, jmask, _ = jax.jit(lambda p, b: jmodel.apply(
            {"params": p}, b, method="inference_flexible"))(j16.params,
                                                            jbatch)
        with torch.inference_mode():
            _, _, cls, _ = eng.model._pocket_pred(batch, cfg_b.shapes)
            center = pocket_center_rounded(cls, batch.prot_xyz,
                                           batch.prot_mask, cfg.model.gs_tau,
                                           cfg.model.gs_hard)
            idx, mask, _, _ = eng.model._predicted_crop(center, batch,
                                                        cfg_b.shapes)
        np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
        m = mask.numpy()
        np.testing.assert_array_equal(idx.numpy()[m], np.asarray(jidx)[m])

        # the whole-protein ctx graph over the served bf16 coordinates
        lig = batch.lig_coords_init.float().numpy()
        z = np.zeros_like(lig[:, :1])
        x = np.concatenate([z, lig, z, batch.prot_xyz.float().numpy()],
                           1) / 5.0
        layout = G.ComplexLayout(batch.lig_mask.shape[1],
                                 batch.prot_mask.shape[1])
        args = [getattr(batch, f).numpy() for f in
                ("lig_mask", "prot_mask", "bond_idx", "bond_mask")]
        k = cfg_b.shapes.ctx_k_whole
        jg = JG.build_ctx_graph(jnp.asarray(x, jnp.bfloat16),
                                JG.ComplexLayout(*layout),
                                *map(jnp.asarray, args), 1.6, k)
        tg = G.build_ctx_graph(torch.from_numpy(x).to(BF), layout,
                               *map(torch.from_numpy, args), 1.6, k)
        gi, gm = tg.nbr_idx.numpy(), tg.nbr_mask.numpy()
        wi, wm = np.asarray(jg.nbr_idx), np.asarray(jg.nbr_mask)
        # rows whose K-th and (K+1)-th nearest candidates sit at the same
        # bf16 squared distance: top_k and torch.topk may keep either
        pkt = jnp.asarray(x[:, layout.pkt_slice], jnp.bfloat16)
        d2 = np.asarray(((pkt[:, :, None] - pkt[:, None]) ** 2).sum(-1),
                        np.float32)
        pm = args[1][:, :, None] & args[1][:, None, :]
        d2 = np.where(pm & ~np.eye(pm.shape[1], dtype=bool)
                      & (d2 <= 1.6 ** 2), d2, np.inf)
        d2 = np.sort(d2, -1)
        tie = np.isfinite(d2[..., k]) & (d2[..., k - 1] == d2[..., k])
        n_checked = 0
        for b in range(gi.shape[0]):
            for i in range(gi.shape[1]):
                j = i - layout.pkt_slice.start
                if j >= 0 and tie[b, j]:
                    continue
                n_checked += 1
                assert set(gi[b, i][gm[b, i]]) == set(wi[b, i][wm[b, i]])
        assert n_checked > gi.shape[0] * gi.shape[1] // 2


def test_protein_cache_screen_and_warmup(served, monkeypatch):
    """The device protein-row cache is bit-identical to uploading every
    batch, dock_screen equals dock_raw on the same pairs, and warmup runs
    one batch in every bucket."""
    cfg, buckets, sd, _, _, eng = served
    raws = _raws()
    cold = eng.dock_raw(raws)
    assert len(eng._dev_prot_rows) == 5          # five distinct proteins
    warm = eng.dock_raw(raws)                    # every row a hit
    off = DockingEngine(cfg, state_dict=sd, buckets=buckets, batch_size=2,
                        device="cpu", dev_prot_cache=0).dock_raw(raws)
    for c, w, o in zip(cold, warm, off):
        assert c.error == w.error == o.error
        np.testing.assert_array_equal(c.coords, w.coords)
        np.testing.assert_array_equal(c.coords, o.coords)
    lru = DockingEngine(cfg, state_dict=sd, buckets=buckets, batch_size=2,
                        device="cpu", dev_prot_cache=2)
    lru.dock_raw(raws)
    assert len(lru._dev_prot_rows) == 2

    protein = {k: raws[1][k] for k in ("protein_xyz", "esm_feat")}
    ligs = [{k: r[k] for k in ("lig_coords", "lig_feats", "bond_edges",
                               "las_mask", "rdkit_coords")}
            for r in (raws[0], raws[1], raws[3], raws[5], raws[2])]
    screened = eng.dock_screen(protein, ligs)
    direct = eng.dock_raw([dict(lig, **protein) for lig in ligs])
    assert [p.error is None for p in screened] == [True] * 4 + [False]
    for a, b in zip(screened, direct):
        assert a.error == b.error
        np.testing.assert_array_equal(a.coords, b.coords)

    seen = []
    run = eng.run_batch

    def spy(batch, cfg_b):
        seen.append((cfg_b.shapes.max_pocket, batch.pocket_mask.shape[1],
                     batch.prot_feat.dtype))
        return run(batch, cfg_b)

    monkeypatch.setattr(eng, "run_batch", spy)
    assert eng.warmup() > 0
    assert seen == [(16, 16, BF), (24, 24, BF)]


def test_concurrent_dock_raw_matches_serial(served):
    """dock_raw from 4 threads at once (mixed buckets, shared protein
    cache) gives the serial poses, bit for bit."""
    cfg, buckets, sd, _, _, _ = served
    eng = DockingEngine(cfg, state_dict=sd, buckets=buckets, batch_size=2,
                        device="cpu", dev_prot_cache=3)
    work = [_raws()[i:i + 3] for i in range(4)]
    serial = [eng.dock_raw(w) for w in work]
    out = [None] * len(work)

    def call(i):
        out[i] = eng.dock_raw(work[i])

    threads = [threading.Thread(target=call, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    for got, want in zip(out, serial):
        for g, w in zip(got, want):
            assert g.error == w.error
            np.testing.assert_array_equal(g.coords, w.coords)
    assert len(eng._dev_prot_rows) <= 3
