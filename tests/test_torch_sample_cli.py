"""The port's sampling CLI (fabind_tpu_torch.cli.sample) against
fabind_tpu.cli.sample, on the CPU in fp32 at toy width: `aggregate_topn`;
`main` at dropout 0 with the full recycle count and no clustering (every
pass deterministic, so both packages' passes agree) over one NPZ directory
and one .bin with a confidence head (the port's seeded weights; the JAX
CLI converts them on load, and the tests below reuse the params it
loaded), with --save-rmsd-dir and --symmetric-rmsd; the port's seeded
stochastic runs and refusals; and the FABind+ evaluation step's
docked-pocket coordinates (recentered frame) against JAX's at stages 1
and 2.

Tolerance: atol 2e-4 for RMSDs, centroid distances, confidences and
tensors.
"""
from __future__ import annotations

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_data import make_raw

from fabind_tpu.cli import sample as jax_sample
from fabind_tpu.config import parse_overrides as jax_parse_overrides
from fabind_tpu.config import preset as jax_preset
from fabind_tpu.data.types import FABindBatch as JaxBatch
from fabind_tpu.models.fabind import make_model as jax_make_model
from fabind_tpu.train import checkpoints as jax_checkpoints
from fabind_tpu.train.trainer import make_eval_step

from fabind_tpu_torch.cli import sample
from fabind_tpu_torch.config import parse_overrides, preset
from fabind_tpu_torch.data.types import FABindBatch, dummy_arrays
from fabind_tpu_torch.models.fabind import init_params, make_model

ATOL = 2e-4
CLI_SETS = ["max_ligand=16", "max_pocket=32", "max_protein=48", "ctx_k=8",
            "ctx_k_whole=8", "hidden_size=16", "pocket_pred_hidden_size=16",
            "mean_layers=1", "n_iter=2"]
# deterministic passes
DET_SETS = ["dropout=0.0", "random_n_iter=false", "use_clustering=false"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's torch work: its tensors are
    toy-sized, and the suite runs in parallel workers that would otherwise
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sets(sets):
    out = []
    for s in sets:
        out += ["--set", s]
    return out


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """Five complexes whose ligands carry their automorphisms; seeded
    weights of fabind_plus_sampling (confidence head included) at the toy
    widths as a .bin; and fabind_tpu.cli.sample run once over them with
    deterministic passes, --symmetric-rmsd and --save-rmsd-dir, keeping the
    flax params it loaded from the .bin."""
    root = tmp_path_factory.mktemp("sample")
    (root / "npz").mkdir()
    for i in range(5):
        raw = make_raw(n=6 + i, nr=26 + 2 * i, seed=50 + i)
        k = raw["lig_coords"].shape[0]
        raw["isomorphisms"] = np.stack(
            [np.arange(k), np.arange(k)[::-1]]).astype(np.int32)
        np.savez(root / "npz" / f"c{i}.npz", **raw)
    cfg = preset("fabind_plus_sampling", **parse_overrides(CLI_SETS))
    model = make_model(cfg)
    init_params(model, torch.Generator().manual_seed(0))
    sd = model.state_dict()
    assert any(n.startswith("ranking") for n in sd)
    ckpt = str(root / "plus.bin")
    torch.save(sd, ckpt)
    loaded = {}
    orig = jax_checkpoints.load_params

    def load_params(*a, **kw):
        out = orig(*a, **kw)
        loaded["params"] = out[0]
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_checkpoints, "load_params", load_params)
        jax_sample.main(_sample_argv(ckpt, str(root / "npz"), root / "jax"))
    with open(root / "jax.json") as f:
        want = json.load(f)
    jcfg = jax_preset("fabind_plus_sampling",
                      **jax_parse_overrides(CLI_SETS))
    return (root, str(root / "npz"), ckpt, jax_make_model(jcfg),
            loaded["params"], sd, want)


def _sample_argv(ckpt, data, out):
    """Deterministic passes with --symmetric-rmsd, into `out` (the
    --save-rmsd-dir) and `out`.json."""
    return (["--ckpt", ckpt, "--data", data, "--sample-size", "2",
             "--batch-size", "2", "--symmetric-rmsd", "--topn", "1",
             "--save-rmsd-dir", str(out), "--out", f"{out}.json"]
            + _sets(CLI_SETS + DET_SETS))


@pytest.mark.parametrize("topn", [1, 3])
def test_aggregate_topn_matches_jax(topn):
    rng = np.random.RandomState(topn)
    rmsds, cents, confs = (rng.rand(5, 7) * 6 for _ in range(3))
    confs[:, 2] = 0.5                                  # all tied
    for g, w in zip(sample.aggregate_topn(rmsds, cents, confs, topn),
                    jax_sample.aggregate_topn(rmsds, cents, confs, topn)):
        np.testing.assert_array_equal(g, w)


def test_cli_sample_matches_jax(setup, tmp_path):
    """Deterministic passes through both CLIs: the metrics JSON and the
    per-pass 'pdb rmsd centroid confidence' files agree, symmetric RMSD
    over the automorphisms."""
    root, data, ckpt, _, _, _, want = setup
    got = sample.main(_sample_argv(ckpt, data, tmp_path / "torch")
                      + ["--device", "cpu"])
    with open(tmp_path / "torch.json") as f:
        assert json.load(f) == got
    assert set(got) == set(want)
    assert got["n"] == want["n"] == 5 and got["sample_size"] == 2
    for k, v in want.items():
        assert abs(got[k] - v) <= ATOL, (k, got[k], v)
    for s in range(2):
        rows = {t: [line.split() for line in (d / (
            f"epoch{s}_confidence.txt")).read_text().splitlines()]
            for t, d in (("torch", tmp_path / "torch"),
                         ("jax", root / "jax"))}
        assert [r[0] for r in rows["torch"]] == [r[0] for r in rows["jax"]]
        assert len(rows["torch"]) == 5
        for a, b in zip(rows["torch"], rows["jax"]):
            for x, y in zip(a[1:], b[1:]):
                assert abs(float(x) - float(y)) <= ATOL, (s, a, b)


def test_cli_sample_seeded_and_refusals(setup, tmp_path, monkeypatch):
    """With dropout, recycle draws and DBSCAN centers on, the same seed
    gives the same metrics (and the fixed pocket mode runs); --dp 2 (two
    CPU replicas) gives dp=1's metrics; a batch size --dp does not divide
    and a missing CUDA device refuse."""
    root, data, ckpt, _, _, _, _ = setup
    argv = ["--ckpt", ckpt, "--data", data, "--sample-size", "2",
            "--batch-size", "2"] + _sets(CLI_SETS) + ["--device", "cpu"]
    a, b = sample.main(argv), sample.main(argv)
    assert a == b and a["n"] == 5 and a["sample_size"] == 2
    c = sample.main(argv + ["--seed", "1", "--pocket-mode", "fixed"])
    assert set(c) == set(a) and np.isfinite(c["rmsd_mean"])
    d = sample.main(argv + ["--dp", "2"])
    assert set(d) == set(a) and d["n"] == a["n"]
    for k, v in a.items():
        assert abs(d[k] - v) <= 1e-5, (k, d[k], v)
    with pytest.raises(SystemExit, match="not divisible by --dp 3"):
        sample.main(argv + ["--dp", "3"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        sample.main(argv[:-2])


@pytest.mark.parametrize("stage", [1, 2])
def test_plus_eval_step_pocket_coords_match_jax(setup, stage):
    """FABind+ docks in the pocket's frame: the evaluation forward's
    pocket_coords (the crop with the recentering bias added back), coords
    and confidence against JAX's make_eval_step."""
    _, _, _, jmodel, params, sd, _ = setup
    cfg = preset("fabind_plus_sampling", **parse_overrides(CLI_SETS))
    arrays = dummy_arrays(cfg.shapes, batch_size=2, seed=9, n_lig_valid=7,
                          n_prot_valid=30)
    jb = JaxBatch(**{k: jnp.asarray(v) for k, v in arrays.items()})
    want = make_eval_step(jmodel, stage)(params, jb)
    model = make_model(cfg)
    model.load_state_dict(sd, strict=True)
    model.eval()
    batch = FABindBatch.from_numpy(arrays, "cpu")
    with torch.inference_mode():
        got = model(batch, stage=stage, train=False)
    for f in ("pocket_coords", "coords", "confidence", "pkt_mask",
              "y_pred"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), atol=ATOL,
                                   rtol=0, err_msg=f)
    # recentered and back: the crop's own coordinates
    for b in range(2):
        pk = batch.prot_xyz[b][got.pkt_idx[b]] * got.pkt_mask[b][:, None]
        torch.testing.assert_close(got.pocket_coords[b], pk, atol=1e-5,
                                   rtol=0)
