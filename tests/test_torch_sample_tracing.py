"""The spans and counters of best-of-N sampling (fabind_tpu_torch/sample.py)
on the CPU at toy width: the halves hold the model's spans, a pass holds
its read-back, clustering and dock half, the counters add up to the passes
and rows run, nothing records with tracing off, GET /health reports the
counters, and a dock_raw beside a dock_best_of records what it records
alone."""
from __future__ import annotations

import dataclasses
import threading

import pytest
import torch

from common import TINY
from test_serve import make_raw

from fabind_tpu_torch import graphs
from fabind_tpu_torch.config import preset
from fabind_tpu_torch.sample import pass_seed, recycle_counts
from fabind_tpu_torch.serve import DockingEngine
from fabind_tpu_torch.utils import tracing

N = 3
SMALL, LARGE = "8x16x32", "16x24x48"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's toy-sized torch work (the
    suite runs in parallel workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def traced():
    """Tracing on and empty for the test, off and empty after it."""
    tracing.reset()
    tracing.enable()
    yield
    tracing.disable()
    tracing.reset()


def _engine(mode="stochastic", **flags):
    cfg = preset("fabind_plus_sampling", **dict(TINY, n_iter=3),
                 sampling_pocket_mode=mode, **flags)
    small = dataclasses.replace(cfg.shapes, max_ligand=8, max_pocket=16,
                                max_protein=32)
    return DockingEngine(cfg, buckets=[small, cfg.shapes], batch_size=2,
                         device="cpu", seed=0)


def _raws():
    """Two requests in the small bucket, one in the large one (three
    batches of two rows: one padding row) and one that fits neither."""
    return [make_raw(n=5, nr=20, seed=31), make_raw(n=12, nr=40, seed=32),
            make_raw(n=6, nr=20, seed=33), make_raw(n=40, nr=40, seed=34)]


def _by_name(snap):
    out = {}
    for s in snap["spans"]:
        out.setdefault(s.name, []).append(s)
    return out


@pytest.mark.parametrize("mode", ["stochastic", "fixed"])
def test_sample_spans_nest(mode, traced):
    """Per batch: N dock halves and N passes (ids: pass, bucket, the
    recycle counts drawn from the pass's seed) under the batch's
    serve.run_batch; the pocket halves (N, or one deterministic stage in
    the fixed mode) under it too; each pass holds its dock half, its
    clustering and, in the stochastic mode, its read-back; model.pocket,
    model.crop and model.dock under the halves, and as many docking rounds
    as the pass's drawn count."""
    eng = _engine(mode)
    m = eng.cfg.model
    eng.dock_best_of(_raws(), sample_size=N, seed=4)
    snap = tracing.snapshot()
    by = _by_name(snap)
    sid = {s.sid: s for s in snap["spans"]}
    runs = {s.ids["batch"]: s for s in by["serve.run_batch"]}
    assert sorted((b, r.ids["bucket"]) for b, r in runs.items()) == [
        (0, SMALL), (1, LARGE)]
    for s in snap["spans"]:
        if s.parent is not None:
            up = sid[s.parent]
            assert up.thread == s.thread == threading.get_ident()
            assert up.start_ns <= s.start_ns <= s.end_ns <= up.end_ns
    for name in ("sample.pass", "sample.dock_half"):
        got = sorted((s.ids["batch"], s.ids["pass"]) for s in by[name])
        assert got == [(b, p) for b in range(2) for p in range(N)]
    halves = N if mode == "stochastic" else 1
    assert len(by["sample.pocket_half"]) == 2 * halves
    for s in by["sample.pocket_half"] + by["sample.pass"]:
        assert sid[s.parent] is runs[s.ids["batch"]]
        assert s.ids["bucket"] == runs[s.ids["batch"]].ids["bucket"]
    for p in by["sample.pass"]:
        pc, dc = recycle_counts(m, pass_seed(4, p.ids["batch"],
                                             p.ids["pass"]))
        assert (p.ids["pocket"], p.ids["dock"]) == (pc, dc)
        kids = [s for s in snap["spans"] if s.parent == p.sid]
        want = ["sample.cluster", "sample.dock_half"]
        if mode == "stochastic":
            want.insert(0, "sample.readback")
        assert [s.name for s in sorted(kids, key=lambda s: s.start_ns)] \
            == want
        (dock,) = [s for s in kids if s.name == "sample.dock_half"]
        below = [s for s in snap["spans"] if s.parent == dock.sid]
        names = {s.name for s in below}
        assert {"model.crop", "model.dock"} <= names
        assert ("model.pocket" in names) == (mode == "fixed")
        (model_dock,) = [s for s in below if s.name == "model.dock"]
        rounds = [s for s in snap["spans"]
                  if s.name == "model.round" and s.parent == model_dock.sid]
        assert len(rounds) == dc
    for s in by["model.pocket"]:
        assert sid[s.parent].name in ("sample.pocket_half",
                                      "sample.dock_half")
    # the fixed mode clusters once per batch, before its passes
    if mode == "fixed":
        assert sum(sid[s.parent].name == "serve.run_batch"
                   for s in by["sample.cluster"]) == 2
        assert sum(sid[s.parent].name == "serve.run_batch"
                   for s in by["sample.readback"]) == 2


@pytest.mark.parametrize("clustering", [True, False])
def test_sample_counters(clustering, traced):
    """sample.passes counts batches x N by bucket; sample.centers counts
    each pass's rows (padding rows too) by where their center came from,
    all from the default without clustering."""
    eng = _engine(use_clustering=clustering)
    eng.dock_best_of(_raws(), sample_size=N, seed=4)
    c = tracing.snapshot()["counters"]
    assert c["sample.passes"] == {SMALL: N, LARGE: N}
    centers = c["sample.centers"]
    assert sum(centers.values()) == 2 * 2 * N
    if clustering:
        assert set(centers) == {"cluster", "default"}
    else:
        assert centers == {"default": 2 * 2 * N}


def test_off_records_nothing():
    """With tracing off a dock_best_of records no span; its counters are
    kept."""
    tracing.disable()
    tracing.reset()
    _engine().dock_best_of(_raws()[:1], sample_size=N, seed=4)
    snap = tracing.snapshot()
    assert snap["spans"] == [] and snap["spans_dropped"] == 0
    assert snap["counters"]["sample.passes"] == {SMALL: N}
    tracing.reset()


def test_dock_raw_unchanged_beside_dock_best_of(monkeypatch, traced):
    """A dock_raw after a dock_best_of on the same engine records the
    spans and moves the counters (graph replays included, with the CPU
    stand-in for graph capture) that it does before it, and no sample
    span or counter."""
    monkeypatch.setattr(graphs, "backend_for", lambda device: graphs.Rerun)
    eng = _engine()
    raws = _raws()

    def dock_raw():
        tracing.reset()
        eng.dock_raw(raws)
        snap = tracing.snapshot()
        return (sorted((s.name, tuple(sorted((k, v) for k, v in s.ids.items()
                                             if k != "call")))
                       for s in snap["spans"]), snap["counters"])

    eng.dock_raw(raws)          # captures each bucket's graphs
    before = dock_raw()
    eng.dock_best_of(raws, sample_size=N, seed=4)
    after = dock_raw()
    assert after == before
    spans, counters = after
    assert counters["serve.graph_replays"] == {SMALL: 1, LARGE: 1}
    assert not any(name.startswith("sample.") for name, _ in spans)
    assert not any(k.startswith("sample.") for k in counters)


def test_health_reports_sample_counters():
    """GET /health's sample counters move by a /dock_best_of call's passes
    and rows."""
    import io
    import json
    import urllib.request

    import numpy as np

    from fabind_tpu_torch.serve_http import make_server

    eng = _engine()
    srv = make_server(eng, "127.0.0.1", 0)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"

    def counters():
        with urllib.request.urlopen(base + "/health", timeout=30) as r:
            return json.loads(r.read())["counters"]

    raws = _raws()[:2]
    buf = io.BytesIO()
    np.savez(buf, **{f"r{i}_{k}": v for i, raw in enumerate(raws)
                     for k, v in raw.items()})
    try:
        before = counters()
        req = urllib.request.Request(
            base + f"/dock_best_of?sample_size={N}&seed=4",
            data=buf.getvalue(), method="POST")
        with urllib.request.urlopen(req, timeout=120) as r:
            assert r.status == 200
        after = counters()
    finally:
        srv.shutdown()
        srv.server_close()
        t.join(timeout=30)
    assert not t.is_alive()
    moved = {k: after["sample.passes"].get(k, 0)
             - before["sample.passes"].get(k, 0) for k in (SMALL, LARGE)}
    assert moved == {SMALL: N, LARGE: N}
    assert sum(after["sample.centers"].values()) - sum(
        before["sample.centers"].values()) == 2 * 2 * N
