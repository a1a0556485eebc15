"""The port's exported best-of-N sampling (aot.export_inference(...,
sampling=True), ExportedInference.sampling_halves, from_exported's
dock_best_of, cli.export --sampling, cli.serve --exported's /dock_best_of)
on the CPU at toy width, in both pocket modes.

- With dropout on, the artifact's dock_best_of equals the live engine's bit
  for bit: the programs draw their masks from the seed input through the
  counter-based operator, and take the recycle counts the host draws from
  the seed.
- At dropout 0 (the operator's CPU kernel made the identity) with the full
  recycle count passed in (JAX at random_n_iter=False, as it draws the
  count from its key) the exported halves equal the JAX package's sampling
  halves (`_pocket_stoch_impl`/`_dock_from_impl`, `_pocket_half_impl`/
  `_dock_half_impl`) on the same weights within 2e-4 A
  (tests/test_torch_model.py's ATOL).

Two artifacts (one per mode) serve every test: an export and its load take
most of the module's time.
"""
from __future__ import annotations

import json
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from common import TINY
from test_serve import make_raw
from test_torch_serve_http import _coords, _npz, _post

from fabind_tpu.cli import sample as jax_sample
from fabind_tpu.config import preset as jax_preset
from fabind_tpu.data.types import FABindBatch as JaxBatch
from fabind_tpu.models.fabind import make_model as jax_make_model

from fabind_tpu_torch import sample
from fabind_tpu_torch.config import preset
from fabind_tpu_torch.data.types import FABindBatch, dummy_arrays
from fabind_tpu_torch.models import layers
from fabind_tpu_torch.ops import dropout as D
from fabind_tpu_torch.serve import DockingEngine
from fabind_tpu_torch.train.convert import state_dict_from_flax

ATOL = 2e-4
# one docking layer and two recycles: the traced rounds stay few
KW = dict(TINY, mean_layers=1, n_iter=2)
_KW_SET = [f"--set={k}={v}" for k, v in KW.items()]
_DROP_OP = torch.ops.fabind_tpu_torch.dropout.default


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's torch work: its tensors are
    toy-sized, and the suite runs in parallel workers that would otherwise
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _requests():
    return [make_raw(n=5, nr=20, seed=1), make_raw(n=12, nr=40, seed=2),
            make_raw(n=7, nr=30, seed=4)]


@pytest.fixture(scope="module")
def weights():
    """Flax init of preset fabind_plus_sampling at toy width, its port
    state dict, and a toy batch."""
    jcfg = jax_preset("fabind_plus_sampling", **KW)
    arrays = dummy_arrays(preset("fabind_plus_sampling", **KW).shapes,
                          batch_size=2, seed=1, n_lig_valid=9,
                          n_prot_valid=40)
    jbatch = JaxBatch(**{k: jnp.asarray(v) for k, v in arrays.items()})
    k = jax.random.PRNGKey(0)
    params = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda: jax_make_model(jcfg).init(
            {"params": k, "dropout": k, "sample": k}, jbatch, train=False,
            stage=2))()["params"])
    return dict(params=params, sd=state_dict_from_flax(params, is_plus=True),
                arrays=arrays, jbatch=jbatch)


@pytest.fixture(scope="module", params=["stochastic", "fixed"])
def artifact(request, weights, tmp_path_factory):
    """Per pocket mode: a fp32 sampling artifact with dropout on, made by
    cli.export --sampling, loaded by an engine, and the live engine on the
    same weights."""
    from fabind_tpu_torch.cli import export as cli_export

    mode = request.param
    cfg = preset("fabind_plus_sampling", **KW, sampling_pocket_mode=mode)
    root = tmp_path_factory.mktemp(f"sampling_{mode}")
    torch.save(weights["sd"], root / "sd.pt")
    out = str(root / "art")
    cli_export.main(["--preset", "fabind_plus_sampling", "--ckpt",
                     str(root / "sd.pt"), "--output", out, "--device", "cpu",
                     "--batch-size", "2", "--no-bf16", "--sampling",
                     f"--set=sampling_pocket_mode={mode}", *_KW_SET])
    live = DockingEngine(cfg, state_dict=weights["sd"], batch_size=2,
                         bf16=False, device="cpu")
    return dict(mode=mode, cfg=cfg, out=out, live=live,
                exported=DockingEngine.from_exported(out, device="cpu"))


def test_manifest_records_the_halves(artifact):
    with open(os.path.join(artifact["out"], "manifest.json")) as f:
        m = json.load(f)
    assert m["sampling"] is True and m["format_version"] == 1
    assert m["sampling_pocket_mode"] == artifact["mode"]
    e, = m["buckets"]
    for kind in ("pocket", "sample"):
        assert os.path.getsize(os.path.join(artifact["out"],
                                            e[f"{kind}_file"])) > 1000
    keys = {"stochastic": ["seed", "count"],
            "fixed": ["seed", "pocket_count", "count"]}[artifact["mode"]]
    specs = e["sample_inputs"][-len(keys):]
    assert [i["name"] for i in specs] == keys
    assert all(i["dtype"] == "int64" and i["shape"] == [] for i in specs)


def test_dock_best_of_artifact_equals_live(artifact):
    """Same seed, same poses and confidences bit for bit; another seed,
    other poses; the artifact's dock halves run without docking graphs,
    each counted under serve.graph_eager."""
    from fabind_tpu_torch.utils import tracing

    def eager():
        return sum(tracing.snapshot()["counters"].get(
            "serve.graph_eager", {}).values())

    raws = _requests()
    want = artifact["live"].dock_best_of(raws, sample_size=3, seed=5)
    before = eager()
    got = artifact["exported"].dock_best_of(raws, sample_size=3, seed=5)
    assert eager() - before == 3 * 2            # 3 passes x 2 batches
    other = artifact["exported"].dock_best_of(raws, sample_size=3, seed=6)
    for g, w in zip(got, want):
        assert g.error is None
        np.testing.assert_array_equal(g.coords, w.coords)
        assert g.confidence == w.confidence
    assert max(float(np.abs(g.coords - o.coords).max())
               for g, o in zip(got, other)) > 1e-4


def _round_key(node):
    """The round a dropout call's key holds: the index of the select of
    the rounds' arange (`layers.StochasticKeys.round_tensor`), or the
    while loop body's round input."""
    if node.op == "placeholder":
        return "loop round"
    assert node.target is torch.ops.aten.select.int, node.target
    return node.args[2]


def test_programs_call_dropout_once_per_site_and_round(artifact,
                                                       monkeypatch):
    """The dock program (its graph and a while loop's body) holds one
    dropout operator call per call of the live forward at the deepest
    recycle count, n_iter = 2 (one round without gradient, in the loop
    body or unrolled, and the round with it), and each call is keyed by a
    distinct (site, call, round). A while body leaves out the sites whose
    output the loop discards: the last EGCL's node update and the stack's
    output dropout only feed h, and a round without gradient keeps x."""
    ex = artifact["exported"]._exported
    cfg_b = ex.bucket_cfgs[0]
    program = ex._halves[id(cfg_b), "sample"]
    keys = [(n.args[3], n.args[4], _round_key(n.args[2]))
            for g in program.modules() if isinstance(g, torch.fx.GraphModule)
            for n in g.graph.nodes if n.target is _DROP_OP]
    assert len(keys) == len(set(keys)) > 0
    calls = []
    real = layers.dropout
    monkeypatch.setattr(layers, "dropout", lambda *a: calls.append(
        (a[3], layers.active_stochastic().round)) or real(*a))
    m = artifact["cfg"].model
    batch = FABindBatch.from_numpy(dummy_arrays(
        cfg_b.shapes, batch_size=2, seed=1, n_lig_valid=9, n_prot_valid=40),
        "cpu")
    model = artifact["live"].model
    with torch.inference_mode():
        if artifact["mode"] == "stochastic":
            pocket = model._pocket_pred(batch, cfg_b.shapes)
            sample.stochastic_dock(model, batch, cfg_b.shapes, pocket,
                                   torch.zeros(2, 3), 0, m.n_iter)
        else:
            sample.stochastic_inference(model, batch, cfg_b.shapes,
                                        torch.zeros(2, 3), 0,
                                        m.pocket_pred_n_iter, m.n_iter)
    discarded = {D.site_id(n) for n, _ in model.named_modules()
                 if n.startswith(("complex_model.gnn.out_layer.node_mlp.",
                                  "complex_model.gnn.dropout_out"))}
    assert len(keys) == len(calls) - sum(
        1 for site, rnd in calls if site in discarded and rnd < m.n_iter - 1)


def test_halves_reject_a_wrong_batch(artifact):
    ex = artifact["exported"]._exported
    cfg_b = ex.bucket_cfgs[0]
    pocket_fn, dock_fn = ex.sampling_halves(cfg_b)
    arrays = dummy_arrays(cfg_b.shapes, batch_size=3)
    batch = FABindBatch.from_numpy(arrays, "cpu")
    with pytest.raises(ValueError, match="calling convention"):
        if artifact["mode"] == "stochastic":
            pocket_fn(batch, 0)
        else:
            dock_fn(batch, torch.zeros(3, 3), 0)


def test_cli_serve_exported_answers_dock_best_of(artifact, monkeypatch):
    """cli.serve --exported of a sampling artifact: /dock_best_of over a
    socket gives the engine's poses."""
    import fabind_tpu_torch.serve_http as sh
    from fabind_tpu_torch.cli import serve as cs

    captured = {}
    monkeypatch.setattr(sh, "serve_forever",
                        lambda engine, host, port, pdb_root=None:
                        captured.update(engine=engine))
    # the artifact as the fixture loaded it (loading takes most of the time)
    monkeypatch.setattr(DockingEngine, "from_exported",
                        lambda path, device, esm: captured.update(path=path)
                        or artifact["exported"])
    cs.main(["--exported", artifact["out"], "--device", "cpu"])
    assert captured["path"] == artifact["out"]
    eng = captured["engine"]
    srv = sh.make_server(eng, "127.0.0.1", 0)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    raws = _requests()
    body = _npz({f"r{i}_{k}": v for i, raw in enumerate(raws)
                 for k, v in raw.items()})
    try:
        status, poses = _post(f"http://127.0.0.1:{srv.server_address[1]}"
                              f"/dock_best_of?sample_size=2&seed=3", body)
    finally:
        srv.shutdown()
        srv.server_close()
        t.join(timeout=30)
    want = artifact["live"].dock_best_of(raws, sample_size=2, seed=3)
    assert status == 200
    for p, w, c in zip(poses, want, _coords(poses)):
        assert p["error"] is None
        np.testing.assert_array_equal(c, w.coords)
        assert p["confidence"] == np.float32(w.confidence)


def test_exported_halves_match_jax_at_dropout_zero(artifact, weights,
                                                   monkeypatch):
    """The artifact's halves with dropout off (the operator's CPU kernel
    made the identity) and the full recycle count passed in, against the
    JAX package's jitted halves at dropout 0 without count draws, fed the
    same pocket outputs and center."""
    monkeypatch.setattr(D, "dropout_reference", lambda x, *a: x.clone())
    mode = artifact["mode"]
    jcfg = jax_preset("fabind_plus_sampling", **KW, dropout=0.0,
                      random_n_iter=False, sampling_pocket_mode=mode)
    jpocket_fn, jdock_fn = jax_sample._halves(
        jax_make_model(jcfg), stochastic_pocket=mode == "stochastic")
    ex = artifact["exported"]._exported
    cfg_b = ex.bucket_cfgs[0]
    pocket_prog, sample_prog = (ex._runner(cfg_b, k)
                                for k in ("pocket", "sample"))
    m = artifact["cfg"].model
    seed, pc, dc = (torch.tensor(v) for v in (7, m.pocket_pred_n_iter,
                                              m.n_iter))
    params, jbatch = weights["params"], weights["jbatch"]
    batch = FABindBatch.from_numpy(weights["arrays"], "cpu")
    key = jax_sample.sampling_prng_key(0)
    with torch.inference_mode():
        if mode == "stochastic":
            want_pocket, want_center = jpocket_fn(params, jbatch, key)
            *pocket, center = pocket_prog(batch, seed, pc)
            np.testing.assert_allclose(center.numpy(), want_center,
                                       atol=ATOL, rtol=0)
            jpocket = [torch.from_numpy(np.array(p)) for p in want_pocket]
            want = jdock_fn(params, jbatch, want_pocket, want_center, key)
            got = sample_prog(batch, *jpocket,
                              torch.from_numpy(np.array(want_center)), seed,
                              dc)
        else:
            want_pocket = jpocket_fn(params, jbatch)
            pocket = pocket_prog(batch)
            center = np.array(jnp.mean(jbatch.prot_xyz[:, :5], axis=1))
            want = jdock_fn(params, jbatch, center, key)
            got = sample_prog(batch, torch.from_numpy(center), seed, pc, dc)
    for g, w in zip([*pocket, *got], [*want_pocket, *want]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL,
                                   rtol=0)


def test_tensor_count_equals_the_python_loop():
    """A recycle count given as a tensor (the while loop a traced program
    holds) docks as the Python loop over the int count does, bit for bit,
    dropout on."""
    from fabind_tpu_torch.models.fabind import init_params, make_model

    cfg = preset("fabind_plus_sampling", **dict(KW, n_iter=4))
    model = make_model(cfg).eval()
    init_params(model, torch.Generator().manual_seed(0))
    batch = FABindBatch.from_numpy(dummy_arrays(
        cfg.shapes, batch_size=2, seed=1, n_lig_valid=9, n_prot_valid=40),
        "cpu")
    with torch.inference_mode():
        pocket = model._pocket_pred(batch, cfg.shapes)
        center = torch.zeros(2, 3)
        for count in range(1, 5):
            want = sample.stochastic_dock(model, batch, cfg.shapes, pocket,
                                          center, 3, count)
            got = sample.stochastic_dock(model, batch, cfg.shapes, pocket,
                                         center, torch.tensor(3),
                                         torch.tensor(count))
            assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_dock_raw_runs_while_exported_best_of_is_in_flight(artifact,
                                                           monkeypatch):
    """An exported best-of-N holds the artifact's lock per program call,
    not for the whole pass: a dock_raw on the same engine finishes while a
    best-of-N waits in the host clustering between its halves, and both
    give the poses of serial calls."""
    engine = artifact["exported"]
    raws = _requests()
    want_best = engine.dock_best_of(raws, sample_size=2, seed=3)
    want_raw = engine.dock_raw(raws)
    clustering, release = threading.Event(), threading.Event()
    real = sample.dbscan_clusters

    def held_dbscan(*a, **kw):
        clustering.set()
        release.wait(timeout=120)
        return real(*a, **kw)

    monkeypatch.setattr(sample, "dbscan_clusters", held_dbscan)
    out = {}
    best = threading.Thread(target=lambda: out.update(
        best=engine.dock_best_of(raws, sample_size=2, seed=3)))
    best.start()
    try:
        assert clustering.wait(timeout=120)
        raw = threading.Thread(target=lambda: out.update(
            raw=engine.dock_raw(raws)))
        raw.start()
        raw.join(timeout=120)
        finished_first = not raw.is_alive()
    finally:
        release.set()
        best.join(timeout=120)
    raw.join(timeout=120)
    assert finished_first, "dock_raw waited for the whole best-of-N"
    assert not best.is_alive() and not raw.is_alive()
    for got, want in ((out["best"], want_best), (out["raw"], want_raw)):
        for g, w in zip(got, want):
            assert g.error is None
            np.testing.assert_array_equal(g.coords, w.coords)
            assert g.confidence == w.confidence
