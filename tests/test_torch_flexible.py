"""The port's flexible docking (preset "fabflex": the pocket residues move
with the ligand across recycles) against the JAX package, on the CPU in
fp32 at tests/common.py's TINY: the stage-2 forward and
`inference_flexible_diag`, the flex pocket loss and its gradient, fp32 and
bf16 `DockingEngine.dock_raw`, the daemon's pocket fields, the exported
artifact, `cli.inference`'s pocket sidecar and `cli.selftest`.

Every case takes its inputs from numpy with a seed and its weights from the
JAX engine's fp32 init, carried across by state_dict_from_flax and loaded
with strict=True: fabflex has base FABind's parameter tree. Parity is
atol 2e-4 after two recycles (tests/test_golden_torch.py's convention);
the loss is compared with dropout 0, every recycle and the gumbel uniforms
given to both sides (tests/test_torch_train.py's conventions); bf16 poses
and pockets under tests/test_torch_serve.py's pose rule.
"""
from __future__ import annotations

import csv
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from common import TINY
from test_serve import make_raw
from test_torch_serve import POSE_SLACK_A
from test_torch_serve_http import _npz, _post
from test_torch_train import _Uniforms

import fabind_tpu.ops.gumbel as jax_gumbel
from fabind_tpu.aot import _OUTPUTS_FLEX as JAX_OUTPUTS_FLEX
from fabind_tpu.cli import inference as jax_inference
from fabind_tpu.config import preset as jax_preset
from fabind_tpu.data.types import FABindBatch as JaxBatch
from fabind_tpu.models.fabind import make_model as jax_make_model
from fabind_tpu.serve import DockingEngine as JaxEngine
from fabind_tpu.serve import Pose as JaxPose
from fabind_tpu.train.losses import fabind_losses as jax_losses

from fabind_tpu_torch import serve as port_serve
from fabind_tpu_torch.aot import export_inference
from fabind_tpu_torch.cli import inference as cli_inference
from fabind_tpu_torch.cli import selftest as cli_selftest
from fabind_tpu_torch.config import preset
from fabind_tpu_torch.data.types import FABindBatch, dummy_arrays
from fabind_tpu_torch.models.fabind import make_model
from fabind_tpu_torch.models.layers import dropout_rng
from fabind_tpu_torch.serve import DockingEngine, Pose
from fabind_tpu_torch.serve_http import make_server
from fabind_tpu_torch.train.convert import state_dict_from_flax
from fabind_tpu_torch.train.losses import fabind_losses

ATOL = 2e-4
LOSS_RTOL = 1e-4
# float32 steps of a world-frame coordinate allowed beyond ATOL
F32_STEPS = 4
# each gradient tensor within 1e-5 + 1e-5 * max|JAX gradient| (the two
# packages sum in other orders; tests/test_torch_train.py's rule)
GRAD_ATOL, GRAD_RTOL_OF_MAX = 1e-5, 1e-5
_GATE_OP = torch.ops.fabind_tpu_torch.edge_gate_pair.default


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's torch work: its tensors are
    toy-sized, and the suite runs in parallel workers that would otherwise
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _raws():
    """Requests of the TINY bucket, one too large for it."""
    return [make_raw(n=5, nr=20, seed=1), make_raw(n=12, nr=40, seed=2),
            make_raw(n=40, nr=40, seed=3), make_raw(n=7, nr=30, seed=5),
            make_raw(n=14, nr=44, seed=6)]


@pytest.fixture(scope="module")
def flex():
    """The JAX fabflex engine's fp32 init, its fp32 and bf16 engines, the
    port's fp32 and bf16 engines and model on the same weights, and one
    seeded batch on both sides."""
    cfg, jcfg = preset("fabflex", **TINY), jax_preset("fabflex", **TINY)
    assert cfg.model.flexible_docking and jcfg.model.flexible_docking
    j32 = JaxEngine(jcfg, batch_size=2, bf16=False)
    params = jax.tree_util.tree_map(np.asarray, j32.params)
    j16 = JaxEngine(jcfg, params=params, batch_size=2, bf16=True)
    sd = state_dict_from_flax(params, is_plus=False)
    model = make_model(cfg)
    model.load_state_dict(sd, strict=True)
    # 20 residues for the 24 pocket slots: the crop has padding rows
    arrays = dummy_arrays(cfg.shapes, batch_size=2, seed=0, n_lig_valid=9,
                          n_prot_valid=20)
    return dict(
        cfg=cfg, jcfg=jcfg, params=params, sd=sd, model=model.eval(),
        jmodel=jax_make_model(jcfg), arrays=arrays,
        batch=FABindBatch.from_numpy(arrays, "cpu"),
        jbatch=JaxBatch(**{k: jnp.asarray(v) for k, v in arrays.items()}),
        j32=j32, j16=j16,
        eng32=DockingEngine(cfg, state_dict=sd, batch_size=2, bf16=False,
                            device="cpu"),
        eng16=DockingEngine(cfg, state_dict=sd, batch_size=2, device="cpu"))


def _close(got, want, atol=ATOL, rtol=0.0):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=rtol)


def _scaled_coord_heads(params, scale):
    """A copy of flax params with the docking stack's coordinate heads'
    output kernels times `scale`: the init's 1e-3 gain moves the pocket by
    ~1e-3 A, where the flex loss (0.5 d^2) is a difference of float32
    coordinates cancelling to ~1e-7."""
    params = jax.tree_util.tree_map(np.array, params)
    for layer in params["complex_model"]["gnn"].values():
        if "coord_mlp" in layer:
            layer["coord_mlp"]["linear2"]["kernel"] *= scale
    return params


def _input_crop(batch, pkt_idx, pkt_mask):
    """The pocket residues' input coordinates [B, Np, 3], padding 0."""
    xyz = batch.prot_xyz.numpy()
    idx, mask = pkt_idx.numpy(), pkt_mask.numpy()
    return np.stack([xyz[b][idx[b]] for b in range(len(idx))]) \
        * mask[..., None]


# -------------------------------------------------------------- the model
def test_forward_matches_jax_and_moves_the_pocket(flex):
    f = flex
    jmodel = f["jmodel"]
    want = jax.jit(lambda p, b: jmodel.apply({"params": p}, b, train=False,
                                             stage=2))(f["params"],
                                                       f["jbatch"])
    with torch.inference_mode():
        got = f["model"](f["batch"], stage=2)
    _close(got.coords, want.coords)
    _close(got.pocket_coords, want.pocket_coords)
    np.testing.assert_array_equal(got.pkt_mask.numpy(),
                                  np.asarray(want.pkt_mask))
    pocket, mask = got.pocket_coords.numpy(), got.pkt_mask.numpy()
    crop = _input_crop(f["batch"], got.pkt_idx, got.pkt_mask)
    assert np.isfinite(pocket).all() and (~mask).any()
    assert np.abs(pocket - crop)[mask].max() > 1e-4      # the pocket moved
    assert np.abs(pocket[~mask]).max() == 0.0            # padding rows 0

    # the rigid preset docks the input crop, on the same weights
    rigid = make_model(preset("fabind", **TINY))
    rigid.load_state_dict(f["sd"], strict=True)
    with torch.inference_mode():
        r = rigid.eval()(f["batch"], stage=2)
    np.testing.assert_allclose(
        r.pocket_coords.numpy(), _input_crop(f["batch"], r.pkt_idx,
                                             r.pkt_mask), atol=1e-5)


def test_the_flag_reaches_the_recycle_carry(flex):
    """One recycle: the ligand does not see the moved pocket, so fabflex
    docks fabind's ligand and only the pocket differs. Two: the second
    round docks into the moved pocket. A tensor recycle count (the traced
    while loop) carries the same pocket as the int count."""
    f = flex
    out = {}
    for n_iter in (1, 2):
        for name in ("fabflex", "fabind"):
            m = make_model(preset(name, **dict(TINY, n_iter=n_iter)))
            m.load_state_dict(f["sd"], strict=True)
            with torch.inference_mode():
                out[name, n_iter] = [t.numpy() for t in
                                     m.eval().inference_flexible(f["batch"])]
    (lf, pf, _, mf, _), (lr, pr, _, mr, _) = out["fabflex", 1], \
        out["fabind", 1]
    np.testing.assert_array_equal(mf, mr)
    np.testing.assert_array_equal(lf, lr)
    assert np.abs(pf - pr)[mf].max() > 1e-4
    assert np.abs(out["fabflex", 2][0] - out["fabind", 2][0]).max() > 0

    with torch.inference_mode():
        by_int = f["model"].inference_flexible_diag(f["batch"], count=2)
        by_tensor = f["model"].inference_flexible_diag(
            f["batch"], count=torch.tensor(2))
    for a, b in zip(by_int, by_tensor):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    _close(by_int[0], out["fabflex", 2][0], atol=0)
    _close(by_int[1], out["fabflex", 2][1], atol=0)


def test_inference_flexible_diag_matches_jax(flex):
    f = flex
    jmodel = f["jmodel"]
    want = jax.jit(lambda p, b: jmodel.apply(
        {"params": p}, b, method="inference_flexible_diag"))(f["params"],
                                                             f["jbatch"])
    with torch.inference_mode():
        got = f["model"].inference_flexible_diag(f["batch"])
    assert len(got) == len(want) == 6
    lig, pkt, idx, mask, conf, overflow = got
    jlig, jpkt, jidx, jmask, jconf, joverflow = (np.asarray(t) for t in want)
    np.testing.assert_array_equal(mask.numpy(), jmask)
    np.testing.assert_array_equal(idx.numpy()[jmask], jidx[jmask])
    np.testing.assert_array_equal(overflow.numpy(), joverflow)
    _close(lig, jlig)
    _close(pkt, jpkt)
    _close(conf, jconf)
    assert lig.shape == (2, TINY["max_ligand"], 3)
    assert pkt.shape == (2, TINY["max_pocket"], 3)
    with torch.inference_mode():
        five = f["model"].inference_flexible(f["batch"])
    for a, b in zip(five, (lig, pkt, idx, mask, conf)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


# -------------------------------------------------------------- the loss
def test_flex_loss_and_gradient_match_jax(flex):
    """The training forward at dropout 0, every recycle and the stage gate
    left to the center error, with the gumbel uniforms given to both sides:
    a batch whose true center is 1000 A off docks the precomputed pocket
    (stage 1), one at the predicted center the predicted pocket (stage
    2). The flex term and the total loss within LOSS_RTOL, every gradient
    tensor by test_torch_train's rule; the rigid config reports 0. The
    coordinate heads are scaled to unit gain (_scaled_coord_heads), so the
    pocket moves by ~0.1-1 A and the term is not a cancellation."""
    f = flex
    params = _scaled_coord_heads(f["params"], 1e3)
    sd = state_dict_from_flax(params, is_plus=False)
    kw = dict(TINY, dropout=0.0, random_n_iter=False, stage_prob=1.0)
    cfg, jcfg = preset("fabflex", **kw), jax_preset("fabflex", **kw)
    jmodel = jax_make_model(jcfg)
    arrays = dummy_arrays(cfg.shapes, batch_size=2, seed=0, n_lig_valid=6,
                          n_prot_valid=24)
    arrays["sample_valid"] = np.array([True, False])
    u = np.random.RandomState(5).uniform(
        1e-6, 1.0, (2, cfg.shapes.max_protein, 2)).astype(np.float32)
    k = jax.random.PRNGKey(0)

    def loss_fn(p, b, u):
        _Uniforms.u = u
        out = jmodel.apply({"params": p}, b, train=True,
                           rngs={"dropout": k, "sample": k})
        loss, metrics = jax_losses(out, b, jcfg.model, jcfg.train)
        return loss, (metrics, out.pred_pocket_center)

    def jbatch(a):
        return JaxBatch(**{k_: jnp.asarray(v) for k_, v in a.items()})

    orig = jax_gumbel.gumbel_softmax
    jax_gumbel.gumbel_softmax = _Uniforms.gumbel_softmax
    try:
        vg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
        far = dict(arrays, coords_center=arrays["coords_center"] + 1e3)
        (_, (_, center)), _ = vg(params, jbatch(far), u)
        runs = {"stage1": far,
                "stage2": dict(arrays, coords_center=np.asarray(center))}
        want = {key: vg(params, jbatch(a), u) for key, a in runs.items()}
    finally:
        jax_gumbel.gumbel_softmax = orig

    for key, a in runs.items():
        (jloss, (jm, _)), jgrads = want[key]
        jgrads = state_dict_from_flax(
            jax.tree_util.tree_map(np.asarray, jgrads), is_plus=False)
        model = make_model(cfg)
        model.load_state_dict(sd, strict=True)
        model.train()
        batch = FABindBatch.from_numpy(a, "cpu")
        with dropout_rng(torch.Generator().manual_seed(0)):
            out = model(batch, gumbel_u=torch.from_numpy(u))
        loss, metrics = fabind_losses(out, batch, cfg.model, cfg.train)
        loss.backward()
        assert out.use_stage2 == (key == "stage2")
        flex_loss = float(metrics["flex_pocket_coord_loss"].detach())
        assert flex_loss > 1e-3
        np.testing.assert_allclose(flex_loss,
                                   float(jm["flex_pocket_coord_loss"]),
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(float(loss.detach()), float(jloss),
                                   rtol=LOSS_RTOL)
        gmax = 0.0
        for n, p in model.named_parameters():
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            assert torch.isfinite(g).all(), n
            gmax = max(gmax, float(g.abs().max()))
            tol = GRAD_ATOL + GRAD_RTOL_OF_MAX * float(jgrads[n].abs().max())
            assert float((g - jgrads[n]).abs().max()) <= tol, n
        assert gmax > 0

    rigid = make_model(preset("fabind", **TINY))
    rigid.load_state_dict(f["sd"], strict=True)
    with torch.inference_mode():
        out = rigid.eval()(f["batch"], stage=2)
    rcfg = preset("fabind", **TINY)
    _, m = fabind_losses(out, f["batch"], rcfg.model, rcfg.train)
    assert float(m["flex_pocket_coord_loss"]) == 0.0


# ------------------------------------------------------------ the engine
def _dist(a, b):
    return np.linalg.norm(np.asarray(a, np.float64) - b, axis=-1)


def test_dock_raw_fp32_matches_jax(flex):
    """Poses and pockets in the world frame, within ATOL plus F32_STEPS
    float32 steps of the coordinate: make_raw's far residues put
    coordinates near 1000 A (the model's protein-mean frame near 750 A),
    where one float32 step is 6.1e-5 A and ATOL is 3 of them."""
    raws = _raws()
    got, want = flex["eng32"].dock_raw(raws), flex["j32"].dock_raw(raws)
    assert [g.error is None for g in got] == [w.error is None for w in want]
    assert sum(g.error is None for g in got) == 4
    for g, w in zip(got, want):
        if w.error is not None:
            assert "exceeds every bucket" in g.error
            continue
        assert g.pocket_coords.dtype == np.float32
        assert g.pocket_truncated == w.pocket_truncated
        np.testing.assert_array_equal(g.pocket_residues, w.pocket_residues)
        _close(g.coords, w.coords, rtol=F32_STEPS * 2.0 ** -23)
        _close(g.pocket_coords, w.pocket_coords, rtol=F32_STEPS * 2.0 ** -23)
        assert len(g.pocket_coords) == len(g.pocket_residues) > 0


def test_dock_raw_bf16_matches_jax_bf16(flex):
    """The pose rule of test_torch_serve.test_dock_raw_bf16_matches_jax_bf16
    on ligand and pocket alike: the mean per-atom (per-residue) distance to
    the JAX bf16 engine's at most 2x the JAX bf16-vs-fp32 mean, plus
    POSE_SLACK_A; the same crops."""
    raws = _raws()
    got, want, want32 = (e.dock_raw(raws) for e in
                         (flex["eng16"], flex["j16"], flex["j32"]))
    d_port = {"coords": [], "pocket_coords": []}
    d_jax = {"coords": [], "pocket_coords": []}
    for g, w, w32 in zip(got, want, want32):
        assert (g.error is None) == (w.error is None)
        if w.error is not None:
            continue
        np.testing.assert_array_equal(g.pocket_residues, w.pocket_residues)
        np.testing.assert_array_equal(w.pocket_residues, w32.pocket_residues)
        for k in d_port:
            d_port[k].append(_dist(getattr(g, k), getattr(w, k)))
            d_jax[k].append(_dist(getattr(w, k), getattr(w32, k)))
    for k in d_port:
        dp, dj = np.concatenate(d_port[k]), np.concatenate(d_jax[k])
        assert dj.mean() > 0
        assert dp.mean() <= 2 * dj.mean() + POSE_SLACK_A, (k, dp.mean(),
                                                           dj.mean())


def test_dock_screen_and_best_of_refusal(flex):
    """dock_screen gives dock_raw's pockets; dock_best_of needs a
    confidence head, which fabflex lacks."""
    eng = flex["eng32"]
    raws = [r for r in _raws() if len(r["lig_coords"]) <= TINY["max_ligand"]]
    protein = {k: raws[1][k] for k in ("protein_xyz", "esm_feat")}
    ligs = [{k: v for k, v in r.items() if k not in protein} for r in raws]
    screened = eng.dock_screen(protein, ligs)
    direct = eng.dock_raw([dict(lig, **protein) for lig in ligs])
    for a, b in zip(screened, direct):
        np.testing.assert_array_equal(a.coords, b.coords)
        np.testing.assert_array_equal(a.pocket_coords, b.pocket_coords)
        np.testing.assert_array_equal(a.pocket_residues, b.pocket_residues)
    with pytest.raises(ValueError, match="confidence head"):
        eng.dock_best_of(raws[:1], sample_size=2)


def test_http_pocket_fields_and_truncation(flex):
    """JAX test_serve_http.test_http_flexible_pocket_fields_and_truncation's
    scenario on the port's daemon: one tight blob of 30 residues, all
    within the 20 A radius, so the Np=24 bucket truncates exactly 6; the
    JSON pocket fields equal the engine's Pose fields."""
    eng = flex["eng32"]
    srv = make_server(eng, "127.0.0.1", 0)
    port = srv.server_address[1]
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        rng = np.random.RandomState(5)
        raw = make_raw(n=9, nr=30, seed=5)
        raw["protein_xyz"] = (rng.randn(30, 3) * 2).astype(np.float32)
        raw["lig_coords"] = (raw["protein_xyz"][:3].mean(0)
                             + rng.randn(9, 3)).astype(np.float32)
        raw["rdkit_coords"] = raw["lig_coords"].copy()
        small = make_raw(n=5, nr=20, seed=6)
        entries = {f"r{i}_{k}": v for i, r in enumerate([raw, small])
                   for k, v in r.items()}
        status, poses = _post(f"http://127.0.0.1:{port}/dock_raw",
                              _npz(entries))
    finally:
        srv.shutdown()
        srv.server_close()
        t.join(timeout=60)
    assert status == 200 and len(poses) == 2
    assert poses[0]["error"] is None
    assert poses[0]["pocket_truncated"] == 6
    assert "pocket_truncated" not in poses[1]
    for p, w in zip(poses, eng.dock_raw([raw, small])):
        pc = np.asarray(p["pocket_coords"], np.float32)
        pr = np.asarray(p["pocket_residues"])
        assert pc.ndim == 2 and pc.shape[0] == pr.shape[0] > 0
        assert np.isfinite(pc).all()
        np.testing.assert_array_equal(pc, w.pocket_coords)
        np.testing.assert_array_equal(pr, w.pocket_residues)


# -------------------------------------------------------------- export
def test_export_round_trip(flex, tmp_path):
    """An fp32 artifact of the TINY bucket on the CPU: the manifest is
    flexible with JAX's outputs, the program calls the gate operator once
    per launch of the live forward (1 pocket layer + 1 layer x 2
    recycles), its poses and pockets equal the live engine's bit for bit;
    a sampling export is refused (no confidence head)."""
    f = flex
    out = str(tmp_path / "art")
    m = export_inference(f["cfg"], f["sd"], out, batch_size=2, bf16=False,
                         device="cpu")
    assert m["flexible"] is True
    assert m["outputs"] == list(JAX_OUTPUTS_FLEX)
    exported = DockingEngine.from_exported(out, device="cpu")
    assert exported._exported.flexible and exported.model is None
    (prog,) = exported._exported._programs.values()
    assert sum(n.target is _GATE_OP for n in prog.graph.nodes) == 3
    raws = _raws()
    got, want = exported.dock_raw(raws), f["eng32"].dock_raw(raws)
    for g, w in zip(got, want):
        assert g.error == w.error
        if w.error is not None:
            continue
        for k in ("coords", "pocket_coords", "pocket_residues"):
            np.testing.assert_array_equal(getattr(g, k), getattr(w, k))
        assert g.pocket_truncated == w.pocket_truncated
    with pytest.raises(AssertionError, match="confidence head"):
        export_inference(f["cfg"], f["sd"], str(tmp_path / "s"),
                         batch_size=2, bf16=False, device="cpu",
                         sampling=True)


# ---------------------------------------------------------------- CLIs
def _stub_engine(pose_cls):
    """An engine whose dock_sdf returns one pose per request, with a docked
    pocket, and an error for a ligand file that does not exist."""
    class _Engine:
        def __init__(self, *a, **k):
            pass

        def dock_sdf(self, requests):
            out = []
            for i, (lig, _) in enumerate(requests):
                if not os.path.exists(lig):
                    out.append(pose_cls(coords=np.zeros((0, 3)),
                                        confidence=0.0,
                                        error="FileNotFoundError"))
                    continue
                coords = np.full((2, 3), float(i), np.float32)
                out.append(pose_cls(
                    coords=coords, confidence=0.0,
                    pocket_coords=np.full((4, 3), 2.0 + i, np.float32),
                    pocket_residues=np.arange(4) + i,
                    sdf_meta={"symbols": ["C", "O"], "bonds": [(0, 1, 1)],
                              "charges": [0, 0]}))
            return out
    return _Engine


def test_cli_inference_writes_the_pocket_sidecar(tmp_path, monkeypatch):
    """Both CLIs with --preset fabflex on the same stub poses: the same
    index rows with the `pocket` column, and each row's
    NAME_pocket.npz holding the pose's pocket coordinates and residues."""
    lig_dir = tmp_path / "ligs"
    lig_dir.mkdir()
    for k in range(2):
        (lig_dir / f"l{k}.sdf").write_text("stub\n")
    idx = tmp_path / "index.csv"
    with open(idx, "w", newline="") as fh:
        w = csv.DictWriter(fh, fieldnames=["pdb", "ligand_id", "smiles"])
        w.writeheader()
        w.writerows([{"pdb": "p0", "ligand_id": "l0", "smiles": "CCO"},
                     {"pdb": "p1", "ligand_id": "nothere", "smiles": ""},
                     {"pdb": "p1", "ligand_id": "l1", "smiles": ""}])
    common = ["--preset", "fabflex", "--ckpt", "unused.bin", "--index",
              str(idx), "--pdb-dir", str(tmp_path), "--ligand-sdf-dir",
              str(lig_dir)]
    monkeypatch.setattr("fabind_tpu.serve.DockingEngine",
                        _stub_engine(JaxPose))
    jax_inference.main(common + ["--output", str(tmp_path / "jax")])
    monkeypatch.setattr(port_serve, "DockingEngine", _stub_engine(Pose))
    monkeypatch.setattr("fabind_tpu_torch.models.esm2.load_esm2",
                        lambda path: None)
    monkeypatch.setattr("fabind_tpu_torch.train.checkpoints.load_weights",
                        lambda path: None)
    cli_inference.main(common + ["--esm-weights", "unused", "--device",
                                 "cpu", "--output", str(tmp_path / "port")])

    def read_index(d):
        with open(d / "index.csv") as fh:
            return [{k: os.path.relpath(v, d) if k in ("sdf", "pocket")
                     else v for k, v in r.items()}
                    for r in csv.DictReader(fh)]

    jrows, prows = read_index(tmp_path / "jax"), read_index(tmp_path / "port")
    assert prows == jrows and len(prows) == 2
    for i, r in enumerate(prows):
        assert r["pocket"].endswith("_pocket.npz")
        got = np.load(tmp_path / "port" / r["pocket"])
        want = np.load(tmp_path / "jax" / r["pocket"])
        assert sorted(got.files) == ["coords", "residues"]
        for k in got.files:
            np.testing.assert_array_equal(got[k], want[k])
    np.testing.assert_array_equal(
        np.load(tmp_path / "port" / prows[1]["pocket"])["residues"],
        np.arange(4) + 2)


def test_cli_selftest_fabflex_train(capsys):
    assert cli_selftest.main(["--preset", "fabflex", "--train", "--device",
                              "cpu"]) == 0
    out = capsys.readouterr().out
    assert '"check": "train_step"' in out and '"selftest": "ok"' in out
    assert cli_selftest.gate_launches_per_forward(preset("fabflex")) == 33

