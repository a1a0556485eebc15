"""The port's evaluation path against the JAX package, on the CPU, in fp32
at toy width: the evaluation step (a bf16 Trainer evaluates its float32
weights on the float32 batch, as the JAX eval step does) with the docked
pocket's coordinates; the distance-map docking (its loss, one Adam
trajectory from a given start, restarts from given starts); `cli.evaluate`
against `fabind_tpu.cli.evaluate` on one `.bin` and one NPZ directory; and
`cli.serve --buckets auto --data` against JAX's buckets.

Tolerance: atol 2e-4 for tensors and RMSD metrics; the distance-map
restarts' kept poses within 1e-3 A (5000-step trajectories are cut to 600
here, past the step-500 phase-in of the configuration term; the restarts
that lose are not held: a restart stuck beside a kink of the loss drifts
apart in the two packages by rounding).
"""
from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_data import make_raw

from fabind_tpu import postopt as jax_postopt
from fabind_tpu.cli import evaluate as jax_evaluate
from fabind_tpu.cli import serve as jax_serve_cli
from fabind_tpu.config import parse_overrides as jax_parse_overrides
from fabind_tpu.config import preset as jax_preset
from fabind_tpu.data.types import FABindBatch as JaxBatch
from fabind_tpu.data.types import dummy_batch as jax_dummy_batch
from fabind_tpu.models.fabind import make_model as jax_make_model
from fabind_tpu.train.trainer import make_eval_step

from fabind_tpu_torch.cli import evaluate, serve as serve_cli
from fabind_tpu_torch.cli import train as cli_train
from fabind_tpu_torch.config import parse_overrides, preset
from fabind_tpu_torch.data.types import FABindBatch, dummy_arrays
from fabind_tpu_torch.postopt import (distance_dock_best_of,
                                      distance_map_loss,
                                      distance_optimize_batch)
from fabind_tpu_torch.train.convert import state_dict_from_flax
from fabind_tpu_torch.train.trainer import Trainer

ATOL = 2e-4
DISTMAP_ATOL_A = 1e-3
# the CLIs' toy configuration (--set)
CLI_SETS = ["max_ligand=16", "max_pocket=32", "max_protein=48", "ctx_k=8",
            "ctx_k_whole=8", "hidden_size=16", "pocket_pred_hidden_size=16",
            "mean_layers=1", "n_iter=2"]
OUT_FIELDS = ("coords", "y_pred", "y_pred_by_coord", "dis_map_target",
              "pocket_cls_logits", "pred_pocket_center", "pocket_coords",
              "pkt_mask", "confidence")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's torch work: its tensors are
    toy-sized, and the suite runs in parallel workers that would otherwise
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sets():
    out = []
    for s in CLI_SETS:
        out += ["--set", s]
    return out


@pytest.fixture(scope="module")
def base(tmp_path_factory):
    """Seeded flax weights of preset fabind at the CLIs' toy widths (made
    as fabind_tpu.cli.evaluate makes its template, so its own init is one
    compile, not two) and the same weights as a torch .bin, which both
    packages read."""
    jcfg = jax_preset("fabind", **jax_parse_overrides(CLI_SETS))
    model = jax_make_model(jcfg)
    k = jax.random.PRNGKey(0)
    tmpl = jax_dummy_batch(jcfg.shapes, batch_size=1,
                           feat_dim=jcfg.model.compound_feat_dim,
                           prot_feat_dim=jcfg.model.protein_feat_dim)
    params = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda b: model.init({"params": k, "dropout": k, "sample": k}, b,
                             train=False, stage=2))(tmpl)["params"])
    sd = state_dict_from_flax(params, is_plus=False)
    path = tmp_path_factory.mktemp("ckpt") / "fabind.bin"
    torch.save(sd, path)
    return model, params, sd, str(path)


# ------------------------------------------------------- the evaluation step
@pytest.mark.parametrize("stage", [1, 2])
def test_bf16_trainer_evaluates_float32_like_jax(base, stage):
    """A bf16 Trainer's eval_step equals JAX's make_eval_step on the
    float32 params and batch, field for field, pocket_coords (the docked
    crop) included. (Before the repair it ran the bfloat16 copy on a
    bfloat16 batch, ~1e-2 away.)"""
    jmodel, params, sd, _ = base
    cfg = preset("fabind", bf16=True, **parse_overrides(CLI_SETS))
    arrays = dummy_arrays(cfg.shapes, batch_size=2, seed=3, n_lig_valid=6,
                          n_prot_valid=24)
    jb = JaxBatch(**{k: jnp.asarray(v) for k, v in arrays.items()})
    tr = Trainer(cfg, "cpu", state_dict=sd)
    assert tr.model16 is not None
    batch = FABindBatch.from_numpy(arrays, "cpu")
    want = make_eval_step(jmodel, stage)(params, jb)
    got = tr.eval_step(batch, stage)
    assert got.use_stage2 == bool(want.use_stage2) == (stage == 2)
    for f in OUT_FIELDS:
        g, w = getattr(got, f), np.asarray(getattr(want, f))
        assert g.dtype in (torch.float32, torch.bool), f
        np.testing.assert_allclose(g.numpy(), w, atol=ATOL, rtol=0,
                                   err_msg=f)
    # the crop's coordinates: its residues, masked, in the protein-mean
    # frame
    for b in range(2):
        pk = batch.prot_xyz[b][got.pkt_idx[b]] * got.pkt_mask[b][:, None]
        torch.testing.assert_close(got.pocket_coords[b], pk, atol=1e-5,
                                   rtol=0)


def _npz_dir(root, n=6, iso=True):
    """n complexes named c0.. that fit the CLIs' toy shapes; with `iso`,
    the chain ligands carry their automorphisms [identity, reversed]."""
    root.mkdir()
    for i in range(n):
        raw = make_raw(n=6 + i, nr=24 + 2 * i, seed=10 + i)
        if iso:
            k = raw["lig_coords"].shape[0]
            raw["isomorphisms"] = np.stack(
                [np.arange(k), np.arange(k)[::-1]]).astype(np.int32)
        np.savez(root / f"c{i}.npz", **raw)
    return str(root)


def test_cli_train_validation_ignores_transfer_dtype(tmp_path):
    """--transfer-dtype bf16 rounds the training batches' ESM rows only:
    with lr 0 (the weights stay as seeded) the validation metrics equal an
    fp32-transfer run's."""
    data = _npz_dir(tmp_path / "npz", n=4, iso=False)
    logs = {}
    for dt in ("fp32", "bf16"):
        argv = ["--data", data, "--output", str(tmp_path / dt), "--epochs",
                "1", "--batch-size", "2", "--workers", "0", "--buckets",
                "none", "--device", "cpu", "--transfer-dtype", dt, "--set",
                "lr=0.0"] + _sets()
        assert cli_train.main(argv) == 0
        with open(tmp_path / dt / "metrics.jsonl") as f:
            logs[dt] = [json.loads(line) for line in f
                        if "valid_stage" in line]
    assert len(logs["fp32"]) == 2
    for a, b in zip(logs["fp32"], logs["bf16"]):
        a, b = dict(a), dict(b)
        a.pop("ts"), b.pop("ts")
        assert a == b


# ------------------------------------------------------ distance-map docking
def _distmap_inputs(seed=0, B=3, Np=10, Nc=7):
    """A distance map predicted perfectly from a hidden pose (clamped at
    10 A), the pocket residues, an rdkit conformer near the pose, LAS masks,
    ragged atom and residue masks, and a start 2 A (rms) off the pose."""
    rng = np.random.RandomState(seed)
    prot = rng.randn(B, Np, 3).astype(np.float32) * 4.0
    pose = rng.randn(B, Nc, 3).astype(np.float32) * 1.5
    ref = pose + 0.05 * rng.randn(B, Nc, 3).astype(np.float32)
    y = np.minimum(np.linalg.norm(prot[:, :, None] - pose[:, None], axis=-1),
                   10.0).astype(np.float32)
    am = np.arange(Nc)[None] < np.array([[7], [5], [6]])
    pm = np.arange(Np)[None] < np.array([[10], [8], [6]])
    gap = np.abs(np.arange(Nc)[:, None] - np.arange(Nc)[None])
    las = ((gap >= 1) & (gap <= 2))[None] & am[:, :, None] & am[:, None]
    x = (pose + rng.randn(B, Nc, 3) * 2.0).astype(np.float32)
    return y, prot, ref, las, am, pm, x


@pytest.mark.parametrize("mode", [0, 1, 2])
@pytest.mark.parametrize("epoch", [100.0, 700.0])
def test_distance_map_loss_and_gradient_match_jax(mode, epoch):
    y, prot, ref, las, am, pm, x = _distmap_inputs(1)
    ref_dis = np.array(jax_postopt._pair_dist(jnp.asarray(ref)))

    def jtotal(xx):
        per = jax_postopt.distance_map_loss(
            jnp.float32(epoch), xx, *map(jnp.asarray, (y, prot, ref_dis, las,
                                                      am, pm)),
            dis_thres=10.0, mode=mode)
        return jnp.sum(per), per

    (_, want), want_g = jax.jit(jax.value_and_grad(jtotal, has_aux=True))(
        jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    got = distance_map_loss(epoch, xt, *map(torch.from_numpy, (
        y, prot, ref_dis, las, am, pm)), dis_thres=10.0, mode=mode)
    got.sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=ATOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_g),
                               rtol=1e-5, atol=ATOL)


@pytest.mark.parametrize("mode,steps", [(1, 600), (0, 50)])
def test_distance_optimize_batch_matches_jax(mode, steps):
    """Adam steps from the same start; the final loss at epoch = steps.
    600 steps pass the step-500 phase-in of the configuration term. The
    L1 mode's kinks make Adam amplify rounding: the two packages' poses
    drift apart ~exponentially (2e-5 A after 20 steps, 0.05 A after 600
    on this input), so its trajectory is held for 50 steps; the smooth L2
    mode for 600 (2e-6 A apart)."""
    y, prot, ref, las, am, pm, x0 = _distmap_inputs(2)
    want_x, want_l = jax.jit(
        lambda *a: jax_postopt.distance_optimize_batch(
            *a[:6], jax.random.PRNGKey(0), steps=steps, mode=mode,
            x0=a[6]))(*map(jnp.asarray, (y, prot, ref, las, am, pm, x0)))
    # under inference_mode, as cli.evaluate calls it
    with torch.inference_mode():
        got_x, got_l = distance_optimize_batch(
            *map(torch.from_numpy, (y, prot, ref, las, am, pm)), steps=steps,
            mode=mode, x0=torch.from_numpy(x0))
    m = am[..., None]
    np.testing.assert_allclose(got_x.numpy() * m, np.asarray(want_x) * m,
                               atol=ATOL, rtol=0)
    # the loss sums ~70 pair terms: relative tolerance
    np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l), rtol=1e-4,
                               atol=0)


def test_distance_dock_best_of_matches_jax():
    """Three restarts of 600 steps (the smooth L2 mode, see above): the
    port given JAX's random starts (reproduced from its keys) keeps the
    same restart per complex, within 1e-3 A."""
    y, prot, ref, las, am, pm, _ = _distmap_inputs(3)
    key, R, steps = jax.random.PRNGKey(7), 3, 600
    want_best, want_all, want_l = jax.jit(
        lambda *a: jax_postopt.distance_dock_best_of(
            *a, key, n_repeat=R, steps=steps, mode=1))(
        *map(jnp.asarray, (y, prot, ref, las, am, pm)))
    pc = ((prot * pm[..., None]).sum(1, keepdims=True)
          / np.maximum(pm.sum(1), 1)[:, None, None])
    x0s = np.stack([pc + 5.0 * (2.0 * np.asarray(jax.random.uniform(
        k, ref.shape, jnp.float32)) - 1.0) for k in jax.random.split(key, R)])
    best, xs, losses = distance_dock_best_of(
        *map(torch.from_numpy, (y, prot, ref, las, am, pm)), n_repeat=R,
        steps=steps, mode=1, x0s=torch.from_numpy(x0s.astype(np.float32)))
    assert xs.shape == (R,) + ref.shape and losses.shape == (R, 3)
    np.testing.assert_array_equal(losses.argmin(0).numpy(),
                                  np.asarray(want_l).argmin(0))
    assert len(set(np.asarray(want_l).argmin(0).tolist())) > 1
    m = am[..., None]
    np.testing.assert_allclose(best.numpy() * m, np.asarray(want_best) * m,
                               atol=DISTMAP_ATOL_A, rtol=0)
    assert want_all.shape == xs.shape
    # a generator draws the starts one restart after the other: the same
    # seed, the same poses
    runs = [distance_dock_best_of(
        *map(torch.from_numpy, (y, prot, ref, las, am, pm)),
        torch.Generator().manual_seed(5), n_repeat=2, steps=20)[0]
        for _ in range(2)]
    assert torch.equal(runs[0], runs[1])


# ------------------------------------------------------------ cli.evaluate
def test_cli_evaluate_matches_jax(base, tmp_path):
    """The same .bin and NPZ directory through both CLIs, with
    --unseen-index, --post-optim (50 steps), --symmetric-rmsd, --save-rmsd
    and --write-coords-dir: the metrics JSON (but the rate), the per-pdb
    RMSD lines and the pose files agree."""
    data = _npz_dir(tmp_path / "npz")
    (tmp_path / "unseen.txt").write_text("c0\nc2\nc3\nc5\nabsent\n")
    ckpt = base[3]
    res = {}
    for tag, main in (("jax", jax_evaluate.main), ("torch", evaluate.main)):
        argv = ["--data", data, "--ckpt", ckpt, "--batch-size", "2",
                "--unseen-index", str(tmp_path / "unseen.txt"),
                "--post-optim", "--post-optim-steps", "50",
                "--symmetric-rmsd", "--workers", "0", "--prefetch", "0",
                "--save-rmsd", str(tmp_path / f"{tag}.txt"),
                "--write-coords-dir", str(tmp_path / f"{tag}_coords"),
                "--out", str(tmp_path / f"{tag}.json")] + _sets()
        if tag == "torch":
            argv += ["--device", "cpu"]
        main(argv)
        with open(tmp_path / f"{tag}.json") as f:
            res[tag] = json.load(f)
    got, want = res["torch"], res["jax"]
    assert set(got) == set(want)
    assert got["n"] == want["n"] == 4 and got["n_dropped_oversize"] == 0
    for k, v in want.items():
        if k != "complexes_per_sec":
            assert abs(got[k] - v) <= ATOL, (k, got[k], v)
    rows = {t: [line.split() for line in
                (tmp_path / f"{t}.txt").read_text().splitlines()]
            for t in res}
    assert [r[0] for r in rows["torch"]] == [r[0] for r in rows["jax"]] \
        == ["c0", "c2", "c3", "c5"]
    for a, b in zip(rows["torch"], rows["jax"]):
        assert abs(float(a[1]) - float(b[1])) <= ATOL
    for pdb in ("c0", "c2", "c3", "c5"):
        g = np.load(tmp_path / "torch_coords" / f"{pdb}.npz")["pred_coords"]
        w = np.load(tmp_path / "jax_coords" / f"{pdb}.npz")["pred_coords"]
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=0, err_msg=pdb)


def test_cli_evaluate_distmap_dock_seeded(base, tmp_path):
    """--distmap-dock with two restarts: finite, and the same run twice
    gives the same metrics (each batch's starts come from a generator
    seeded by the running complex count); it replaces the coordinate
    head's poses; a bad --unseen-index refuses."""
    data = _npz_dir(tmp_path / "npz", n=4, iso=False)
    ckpt = base[3]
    base = ["--data", data, "--ckpt", ckpt, "--batch-size", "2",
            "--workers", "0", "--device", "cpu"] + _sets()
    plain = evaluate.main(base)
    dock = ["--distmap-dock", "--distmap-steps", "30", "--distmap-repeats",
            "2"]
    a, b = evaluate.main(base + dock), evaluate.main(base + dock)
    for m in (a, b):
        m.pop("complexes_per_sec")
    assert a == b and np.isfinite(a["rmsd_mean"])
    assert a["rmsd_mean"] != plain["rmsd_mean"]
    (tmp_path / "none.txt").write_text("zzzz\n")
    with pytest.raises(SystemExit, match="no ids"):
        evaluate.main(base + ["--unseen-index", str(tmp_path / "none.txt")])


# ---------------------------------------------------------------- cli.serve
def test_cli_serve_buckets_auto_from_data(tmp_path, monkeypatch):
    """cli.serve --buckets auto:2 --data DIR measures the directory and
    serves JAX's buckets (both engines and servers stubbed)."""
    import fabind_tpu.serve as jax_serve
    import fabind_tpu.serve_http as jax_http
    import fabind_tpu_torch.serve as torch_serve
    import fabind_tpu_torch.serve_http as torch_http

    data = _npz_dir(tmp_path / "npz", n=8, iso=False)
    got = {}

    def fake_engine(tag):
        def make(cfg, **kw):
            got[tag] = [(s.max_ligand, s.max_pocket, s.max_protein)
                        for s in kw["buckets"]]
            return object()
        return make

    monkeypatch.setattr(jax_serve, "DockingEngine", fake_engine("jax"))
    monkeypatch.setattr(torch_serve, "DockingEngine", fake_engine("torch"))
    for mod in (jax_http, torch_http):
        monkeypatch.setattr(mod, "serve_forever", lambda *a, **k: None)
    argv = ["--buckets", "auto:2", "--data", data] + _sets()
    jax_serve_cli.main(argv)
    serve_cli.main(argv + ["--device", "cpu"])
    assert got["torch"] == got["jax"] and len(got["jax"]) >= 2
