"""The port's HTTP daemon (fabind_tpu_torch.serve_http) over a real socket,
and its command line (fabind_tpu_torch.cli.serve) with serve_forever
stubbed, on the CPU at toy width. The request grouping and the JSON encoding
are held to the JAX package's (fabind_tpu.serve_http)."""
from __future__ import annotations

import dataclasses
import gc
import io
import json
import threading
import urllib.error
import urllib.request
import weakref

import numpy as np
import pytest
import torch

from common import TINY
from test_serve import make_raw

from fabind_tpu.serve import Pose as JaxPose
from fabind_tpu.serve_http import _group_npz as jax_group_npz
from fabind_tpu.serve_http import _poses_json as jax_poses_json

from fabind_tpu_torch.config import preset
from fabind_tpu_torch.serve import DockingEngine, Pose
from fabind_tpu_torch.serve_http import _group_npz, _poses_json, make_server

_TINY_SET = [f"--set={k}={v}" for k, v in TINY.items()]
_LIG_KEYS = ("lig_coords", "lig_feats", "bond_edges", "las_mask",
             "rdkit_coords")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's torch work: its tensors are
    toy-sized, and the suite runs in parallel workers that would otherwise
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _npz(entries) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, **entries)
    return buf.getvalue()


def _post(url, body):
    req = urllib.request.Request(url, data=body, method="POST",
                                 headers={"Content-Type":
                                          "application/octet-stream"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.status, json.loads(r.read())


def _status(url, body):
    try:
        return _post(url, body)[0]
    except urllib.error.HTTPError as e:
        return e.code


@pytest.fixture(scope="module")
def server():
    cfg = preset("fabind", **TINY)
    small = dataclasses.replace(cfg.shapes, max_ligand=8, max_pocket=16,
                                max_protein=32)
    eng = DockingEngine(cfg, buckets=[small, cfg.shapes], batch_size=2,
                        device="cpu")
    srv = make_server(eng, "127.0.0.1", 0)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield eng, f"http://127.0.0.1:{srv.server_address[1]}"
    srv.shutdown()
    srv.server_close()
    t.join(timeout=30)


def _coords(poses):
    return [None if p["coords"] == [] else np.asarray(p["coords"], np.float32)
            for p in poses]


def test_http_health_dock_raw_and_screen(server):
    eng, base = server
    with urllib.request.urlopen(base + "/health", timeout=30) as r:
        health = json.loads(r.read())
    counters = health.pop("counters")
    assert health == {"status": "ok", "batch_size": 2, "bf16": True,
                      "buckets": [[8, 16, 32], [16, 24, 48]]}
    assert set(counters) == {"serve.requests", "serve.requests_failed",
                             "serve.batches", "serve.padding_rows",
                             "serve.cells_real", "serve.cells_padded",
                             "serve.prot_rows_hit", "serve.prot_rows_miss"}

    raws = [make_raw(n=5, nr=20, seed=1), make_raw(n=12, nr=40, seed=2),
            make_raw(n=40, nr=40, seed=3)]
    entries = {f"r{i}_{k}": v for i, raw in enumerate(raws)
               for k, v in raw.items()}
    status, poses = _post(base + "/dock_raw", _npz(entries))
    want = eng.dock_raw(raws)
    assert status == 200 and len(poses) == 3
    for p, w, c in zip(poses, want, _coords(poses)):
        assert p["error"] == w.error
        if w.error is None:
            assert c.shape == w.coords.shape
            np.testing.assert_array_equal(c, w.coords)
            assert p["confidence"] == w.confidence

    protein = {k: raws[1][k] for k in ("protein_xyz", "esm_feat")}
    entries = dict(protein, **{f"r{i}_{k}": raws[i][k] for i in range(2)
                               for k in _LIG_KEYS})
    status, poses = _post(base + "/screen", _npz(entries))
    want = eng.dock_screen(protein, [{k: raws[i][k] for k in _LIG_KEYS}
                                     for i in range(2)])
    assert status == 200 and len(poses) == 2
    for p, w, c in zip(poses, want, _coords(poses)):
        assert p["error"] is None and w.error is None
        np.testing.assert_array_equal(c, w.coords)


def test_http_health_counts_requests(server):
    """GET /health's counters move by what a /dock_raw call did: its
    requests, the one that fits no bucket, a batch with one padding row in
    each bucket, the requests' cells against the batches', and per batch a
    protein-row miss and a hit (the padding row repeats it)."""
    _, base = server

    def counters():
        with urllib.request.urlopen(base + "/health", timeout=30) as r:
            return json.loads(r.read())["counters"]

    before = counters()
    raws = [make_raw(n=5, nr=20, seed=21), make_raw(n=12, nr=40, seed=22),
            make_raw(n=40, nr=40, seed=23)]
    entries = {f"r{i}_{k}": v for i, raw in enumerate(raws)
               for k, v in raw.items()}
    status, poses = _post(base + "/dock_raw", _npz(entries))
    assert status == 200 and [p["error"] is None for p in poses] == [
        True, True, False]
    after = counters()
    moved = {k: after[k] - before[k] for k in after
             if not isinstance(after[k], dict)}
    assert moved == {"serve.requests": 3, "serve.requests_failed": 1,
                     "serve.cells_real": 5 * 20 + 12 * 40,
                     "serve.cells_padded": 2 * 8 * 32 + 2 * 16 * 48,
                     "serve.prot_rows_hit": 2, "serve.prot_rows_miss": 2}
    for key in ("serve.batches", "serve.padding_rows"):
        for bucket in ("8x16x32", "16x24x48"):
            assert (after[key].get(bucket, 0)
                    - before[key].get(bucket, 0)) == 1


def test_http_refusals(server):
    eng, base = server
    # a body over the limit is refused before it is read
    small = make_server(eng, "127.0.0.1", 0, max_body_bytes=1024)
    t = threading.Thread(target=small.serve_forever, daemon=True)
    t.start()
    try:
        url = f"http://127.0.0.1:{small.server_address[1]}/dock_raw"
        try:
            _post(url, b"x" * 2048)
            raise AssertionError("expected 413")
        except urllib.error.HTTPError as e:
            assert e.code == 413
            assert "exceeds limit" in json.loads(e.read())["error"]
    finally:
        small.shutdown()
        small.server_close()
        t.join(timeout=30)
    # the JAX daemon's SMILES route (RDKit), and unknown ones
    for path in ("/dock", "/nope"):
        assert _status(base + path, b"{}") == 404
    # best-of-N on an engine without a confidence head
    lig = make_raw(n=5, nr=20, seed=4)
    body = _npz({f"r0_{k}": v for k, v in lig.items()})
    try:
        _post(base + "/dock_best_of?sample_size=2", body)
        raise AssertionError("expected 500")
    except urllib.error.HTTPError as e:
        assert e.code == 500
        assert "confidence" in json.loads(e.read())["error"]
    # /screen without a protein
    assert _status(base + "/screen",
                   _npz({f"r0_{k}": lig[k] for k in _LIG_KEYS})) == 400
    # a body that is no npz is a 500 for that request only
    assert _status(base + "/dock_raw", b"not an npz") == 500
    with urllib.request.urlopen(base + "/health", timeout=30) as r:
        assert r.status == 200


def test_http_dock_best_of(monkeypatch):
    """POST /dock_best_of?sample_size=N&seed=K on a FABind+ sampling engine:
    the poses of engine.dock_best_of with the same arguments, bit for bit;
    without a query the engine's defaults (40 passes, seed 0)."""
    cfg = preset("fabind_plus_sampling", **TINY)
    eng = DockingEngine(cfg, batch_size=2, device="cpu")
    srv = make_server(eng, "127.0.0.1", 0)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    raws = [make_raw(n=5, nr=20, seed=1), make_raw(n=12, nr=40, seed=2),
            make_raw(n=40, nr=40, seed=3)]
    body = _npz({f"r{i}_{k}": v for i, raw in enumerate(raws)
                 for k, v in raw.items()})
    try:
        status, poses = _post(base + "/dock_best_of?sample_size=3&seed=5",
                              body)
        calls = []
        best_of = eng.dock_best_of
        monkeypatch.setattr(eng, "dock_best_of",
                            lambda r, **kw: calls.append(kw) or best_of(
                                r, sample_size=2))
        assert _post(base + "/dock_best_of", body)[0] == 200
    finally:
        srv.shutdown()
        srv.server_close()
        t.join(timeout=30)
    assert calls == [{}]
    want = best_of(raws, sample_size=3, seed=5)
    assert status == 200 and len(poses) == 3
    for p, w, c in zip(poses, want, _coords(poses)):
        assert p["error"] == w.error
        if w.error is None:
            np.testing.assert_array_equal(c, w.coords)
            assert p["confidence"] == np.float32(w.confidence)
            assert w.confidence != 0.0


def test_closed_server_releases_its_engine():
    """After a request, shutdown and close, dropping the server and the
    engine frees the engine's model at once: nothing of the daemon holds
    it in a reference cycle that waits for Python's cyclic collector (on
    the card that kept a closed daemon's weights on the device)."""
    eng = DockingEngine(preset("fabind", **TINY), batch_size=2, device="cpu")
    model = weakref.ref(eng.model)
    srv = make_server(eng, "127.0.0.1", 0)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    lig = make_raw(n=5, nr=20, seed=1)
    gc.disable()
    try:
        with urllib.request.urlopen(base + "/health", timeout=30) as r:
            assert r.status == 200
        assert _post(base + "/dock_raw", _npz(
            {f"r0_{k}": v for k, v in lig.items()}))[0] == 200
        srv.shutdown()
        srv.server_close()
        t.join(timeout=30)
        del srv, eng, t
        assert model() is None
    finally:
        gc.enable()


def test_group_npz_and_poses_json_match_jax():
    body = _npz({"r4000000000_lig_coords": np.zeros((3, 3)),
                 "r2_lig_coords": np.ones((2, 3)), "esm_feat": np.ones(4)})
    got, want = _group_npz(body), jax_group_npz(body)
    assert len(got) == len(want) == 2   # no gap filling up to 4e9
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            np.testing.assert_array_equal(g[k], w[k])
    assert _group_npz(_npz({})) == jax_group_npz(_npz({})) == []

    coords = np.array([[1.0, np.nan, 3.0], [np.inf, 0.5, 2.0]], np.float32)
    kw = [dict(coords=coords, confidence=float("nan")),
          dict(coords=coords[:1] * 0, confidence=0.5, pocket_truncated=3),
          dict(coords=np.zeros((0, 3), np.float32), confidence=0.0,
               error="SampleTooLarge: x")]
    got = _poses_json([Pose(**k) for k in kw])
    assert got == jax_poses_json([JaxPose(**k) for k in kw])
    assert b"NaN" not in got and b"Infinity" not in got
    out = json.loads(got)
    assert out[0]["coords"][0][1] is None and out[0]["confidence"] is None
    assert out[1]["pocket_truncated"] == 3


def _capture_serve(monkeypatch):
    import fabind_tpu_torch.serve_http as sh
    captured = {}

    def fake(engine, host="127.0.0.1", port=8400, pdb_root=None):
        captured["engine"], captured["hp"] = engine, (host, port)
        captured["pdb_root"] = pdb_root

    monkeypatch.setattr(sh, "serve_forever", fake)
    return captured


def test_cli_serve_flags(tmp_path, monkeypatch):
    from fabind_tpu_torch.cli import serve as cs

    captured = _capture_serve(monkeypatch)
    cs.main(["--buckets", "8:16:32,16:24:48", "--no-bf16", "--batch-size",
             "4", "--host", "0.0.0.0", "--port", "8123", "--device", "cpu",
             "--post-optim-steps", "3"] + _TINY_SET)
    eng = captured["engine"]
    assert captured["hp"] == ("0.0.0.0", 8123)
    assert eng.bf16 is False and eng.batch_size == 4
    assert eng.post_optim_steps == 3 and eng.device.type == "cpu"
    assert eng.cfg.model.hidden_size == TINY["hidden_size"]
    assert [(c.shapes.max_ligand, c.shapes.max_pocket, c.shapes.max_protein)
            for c in eng.bucket_cfgs] == [(8, 16, 32), (16, 24, 48)]

    # --ckpt goes through load_torch_checkpoint (DDP prefix stripped)
    ckpt = tmp_path / "model.bin"
    sd = {f"module.{k}": v * 0 + 0.5
          for k, v in eng.model.state_dict().items()}
    torch.save(sd, ckpt)
    cs.main(["--ckpt", str(ckpt), "--device", "cpu", "--warmup"]
            + _TINY_SET)
    eng = captured["engine"]
    assert eng.bf16 is True and len(eng.bucket_cfgs) == 1
    assert all(float(p.min()) == float(p.max()) == 0.5
               for p in eng.model.state_dict().values())


def test_cli_serve_fabind_plus_sampling(monkeypatch):
    from fabind_tpu_torch.cli import serve as cs

    captured = _capture_serve(monkeypatch)
    cs.main(["--preset", "fabind_plus_sampling", "--device", "cpu",
             "--buckets", "8:16:32,16:24:48"] + _TINY_SET)
    eng = captured["engine"]
    m = eng.cfg.model
    assert m.is_plus and m.confidence_training and m.use_clustering
    assert eng.bf16 and m.hidden_size == TINY["hidden_size"]
    poses = eng.dock_best_of([make_raw(n=5, nr=20, seed=1)], sample_size=2)
    assert poses[0].error is None and np.isfinite(poses[0].coords).all()


def test_cli_serve_refuses_what_is_not_ported(monkeypatch):
    from fabind_tpu_torch.cli import serve as cs

    captured = _capture_serve(monkeypatch)
    with pytest.raises(SystemExit, match="requires --data"):
        cs.main(["--buckets", "auto", "--device", "cpu"] + _TINY_SET)
    # fabflex is served: a flexible engine whose poses carry the pocket
    cs.main(["--preset", "fabflex", "--device", "cpu"] + _TINY_SET)
    eng = captured["engine"]
    assert eng.cfg.model.flexible_docking and eng.bf16
    (pose,) = eng.dock_raw([make_raw(n=5, nr=20, seed=1)])
    assert pose.error is None
    assert len(pose.pocket_coords) == len(pose.pocket_residues) > 0
    # --dp 2 serves one engine over two CPU replicas, as dp=1 does
    cs.main(["--dp", "2", "--no-bf16", "--device", "cpu"] + _TINY_SET)
    eng2 = captured["engine"]
    cs.main(["--no-bf16", "--device", "cpu"] + _TINY_SET)
    raws = [make_raw(n=5 + i, nr=20, seed=i) for i in range(3)]
    assert len(eng2.devices) == 2
    for a, b in zip(eng2.dock_raw(raws), captured["engine"].dock_raw(raws)):
        assert a.error is None and b.error is None
        np.testing.assert_allclose(a.coords, b.coords, atol=1e-5, rtol=0)
    # an artifact serves on one device: --dp is refused with --exported,
    # and so is a model flag
    for flag in (["--exported", "x", "--dp", "2"], ["--exported", "x"]):
        with pytest.raises(SystemExit, match="--exported bakes"):
            cs.main(flag + ["--device", "cpu"]
                    + (_TINY_SET if flag[-1] == "x" else []))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cs.main(_TINY_SET)
