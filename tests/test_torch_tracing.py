"""The port's spans and counters (fabind_tpu_torch/utils/tracing.py) on the
CPU at toy width: off records nothing; spans nest per thread, the Loader's
worker threads included; a dock_raw counts exactly what it served; a
training step opens each of its stage spans once; and poses, losses and an
exported program are the same bit for bit with tracing on."""
from __future__ import annotations

import dataclasses
import threading

import numpy as np
import pytest
import torch

from common import TINY, TINY_XS
from test_serve import make_raw

from fabind_tpu_torch.aot import _BucketProgram, batch_leaves, normalize_batch
from fabind_tpu_torch.config import preset
from fabind_tpu_torch.data.batching import build_sample
from fabind_tpu_torch.data.dataset import Loader
from fabind_tpu_torch.data.types import FABindBatch, dummy_arrays
from fabind_tpu_torch.serve import DockingEngine
from fabind_tpu_torch.train.trainer import Trainer
from fabind_tpu_torch.utils import tracing


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


@pytest.fixture(scope="module")
def engine():
    cfg = preset("fabind", **TINY)
    small = dataclasses.replace(cfg.shapes, max_ligand=8, max_pocket=16,
                                max_protein=32)
    return DockingEngine(cfg, buckets=[small, cfg.shapes], batch_size=2,
                         device="cpu")


def _raws():
    # request 3 repeats request 0's protein (a protein-row cache hit); the
    # last fits no bucket
    raws = [make_raw(n=5, nr=20, seed=31), make_raw(n=12, nr=40, seed=32),
            make_raw(n=6, nr=20, seed=33), make_raw(n=40, nr=40, seed=34)]
    raws.insert(3, dict(make_raw(n=7, nr=20, seed=35),
                        protein_xyz=raws[0]["protein_xyz"],
                        esm_feat=raws[0]["esm_feat"]))
    return raws


def _by_name(snap):
    out = {}
    for s in snap["spans"]:
        out.setdefault(s.name, []).append(s)
    return out


def test_off_records_nothing(engine):
    tracing.disable()
    tracing.reset()
    assert tracing.span("serve.call", call=0) is tracing.span("model.pocket")
    engine.dock_raw([make_raw(n=5, nr=20, seed=50)] * 2)
    snap = tracing.snapshot()
    assert snap["spans"] == [] and snap["spans_dropped"] == 0
    # counters are kept with tracing off
    assert snap["counters"]["serve.requests"] == 2


def test_a_profiler_records_spans_with_tracing_off(engine):
    """While a torch.profiler records, spans record and appear in its
    profile as ranges of their names, with tracing off; not after it."""
    tracing.disable()
    tracing.reset()
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])
    with prof:
        engine.dock_raw([make_raw(n=5, nr=20, seed=51)])
    names = {e.name for e in prof.events()}
    spans = tracing.snapshot()["spans"]
    assert {"serve.call", "serve.run_batch", "model.pocket",
            "model.round"} <= {s.name for s in spans}
    assert all(s.profiled for s in spans)
    assert {s.name for s in spans} <= names
    tracing.reset()
    engine.dock_raw([make_raw(n=5, nr=20, seed=51)])
    assert tracing.snapshot()["spans"] == []


def test_nesting_and_threads(traced):
    """Parents are the innermost open span of the same thread, ids are
    inherited, and the Loader's worker and prefetch threads keep stacks of
    their own."""
    cfg = preset("fabind", **TINY)
    raws = [make_raw(n=5 + i, nr=20, seed=40 + i) for i in range(5)]

    class Source:
        def get(self, i):
            return raws[i]

    loader = Loader(Source(), range(len(raws)), cfg, group="test",
                    batch_size=2, workers=2, prefetch_depth=2)
    with tracing.span("train.step", step=7):
        with tracing.span("train.forward"):
            pass
        batches = list(loader.epoch(0))
    assert len(batches) == 3
    snap = tracing.snapshot()
    sid = {s.sid: s for s in snap["spans"]}
    by = _by_name(snap)
    main = threading.get_ident()
    (step,) = by["train.step"]
    assert step.parent is None and step.thread == main
    (fwd,) = by["train.forward"]
    assert fwd.parent == step.sid and fwd.ids == {"step": 7}
    assert len(by["loader.build"]) == 5 and len(by["loader.collate"]) == 3
    for s in by["loader.build"] + by["loader.collate"]:
        assert s.thread != main and s.parent is None and s.ids == {}
    assert len({s.thread for s in by["loader.build"]}) <= 2
    # the consumer waits on the calling thread, inside the open step
    assert len(by["loader.wait"]) == 4      # three batches and the end
    for s in by["loader.wait"]:
        assert s.thread == main and s.parent == step.sid
        assert s.ids == {"step": 7}
    for s in snap["spans"]:
        if s.parent is not None:
            up = sid[s.parent]
            assert up.thread == s.thread
            assert up.start_ns <= s.start_ns <= s.end_ns <= up.end_ns


def test_dock_raw_counters_and_spans(engine, traced):
    """Exact counts of a dock_raw: requests and the failure, batches and
    padding rows by bucket, real and padded cells as the benchmark sums
    them, and the repeated protein as a cache hit; the spans of each batch
    carry its call, index and bucket, one model.round span per recycle
    round run, and a batch run after the call carries no batch ids."""
    raws = _raws()
    poses = engine.dock_raw(raws)
    assert [p.error is None for p in poses] == [True] * 4 + [False]
    snap = tracing.snapshot()
    c = snap["counters"]
    cfgs = engine.bucket_cfgs
    samples = [build_sample(r, engine.cfg, group="test") for r in raws[:4]]
    # requests 0, 2, 3 in the small bucket (one full batch, one with a
    # padding row), request 1 in the large one
    small, large = ("8x16x32", "16x24x48")
    assert c["serve.requests"] == 5 and c["serve.requests_failed"] == 1
    assert c["serve.batches"] == {small: 2, large: 1}
    assert c["serve.padding_rows"] == {small: 1, large: 1}
    real = sum(s["lig_feat"].shape[0] * s["prot_xyz"].shape[0]
               for s in samples)
    padded = sum(2 * k.shapes.max_ligand * k.shapes.max_protein
                 for k in (cfgs[0], cfgs[0], cfgs[1]))
    assert c["serve.cells_real"] == real
    assert c["serve.cells_padded"] == padded
    # rows: [0, 2], [3, 3 (padding)], [1, 1 (padding)]; request 3 has
    # request 0's protein
    assert c["serve.prot_rows_miss"] == 3 and c["serve.prot_rows_hit"] == 3
    # on the CPU every batch docks eagerly (graphs.py)
    assert c["serve.graph_eager"] == {small: 2, large: 1}
    assert "serve.graph_replays" not in c
    m = engine.cfg.model

    by = _by_name(snap)
    (call,) = by["serve.call"]
    assert len(by["serve.featurize"]) == 1
    for name in ("serve.collate", "serve.upload", "serve.run_batch"):
        assert sorted((s.ids["batch"], s.ids["bucket"]) for s in by[name]) \
            == [(0, small), (1, small), (2, large)]
        assert all(s.ids["call"] == call.ids["call"] for s in by[name])
    assert len(by["data.upload"]) == 3 and len(by["serve.collect"]) == 1
    for name in ("model.pocket", "model.center", "model.crop", "model.dock"):
        assert len(by[name]) == 3
    rounds = by["model.round"]
    assert sorted((s.ids["stage"], s.ids["round"], s.ids["batch"])
                  for s in rounds) == sorted(
        [("pocket", i, b) for b in range(3)
         for i in range(m.pocket_pred_n_iter)]
        + [("dock", i, b) for b in range(3) for i in range(m.n_iter)])

    # the call's batch ids end with it
    results = [None]
    ((_, cfg_b, batch, _),) = engine.batches(raws[:1], results)
    tracing.reset()
    engine.run_batch(batch, cfg_b)
    (run,) = _by_name(tracing.snapshot())["serve.run_batch"]
    assert run.ids == {}


def test_mol_requests_dock_through_dock_raw(engine, traced):
    """dock_sdf's featurized requests go through the engine's dock_raw
    attribute (a wrapper set on the instance sees them), the featurization
    errors come back in place, and the inner call nests in the outer."""
    raw = make_raw(n=5, nr=20, seed=60)
    captured = []
    engine.dock_raw = lambda rs: captured.append(rs) or type(
        engine).dock_raw(engine, rs)
    try:
        with tracing.span("serve.call", call=-1):
            poses = engine._finish_mol_requests(
                [dict(raw, _sdf_meta={}), {"_error": "ValueError: bad"}])
    finally:
        del engine.dock_raw
    assert len(captured) == 1 and len(captured[0]) == 1
    assert "_sdf_meta" not in captured[0][0]
    assert poses[0].error is None and poses[1].error == "ValueError: bad"
    outer, inner = sorted(_by_name(tracing.snapshot())["serve.call"],
                          key=lambda s: s.start_ns)
    assert inner.parent == outer.sid and inner.ids["call"] != -1


def test_poses_equal_with_tracing_on(engine):
    raws = _raws()
    tracing.disable()
    off = engine.dock_raw(raws)
    tracing.enable()
    try:
        on = engine.dock_raw(raws)
    finally:
        tracing.disable()
        tracing.reset()
    for a, b in zip(off, on):
        assert a.error == b.error
        if a.error is None:
            np.testing.assert_array_equal(a.coords, b.coords)
            assert a.confidence == b.confidence


def _train_batch(cfg):
    return FABindBatch.from_numpy(
        dummy_arrays(cfg.shapes, batch_size=2, seed=3, n_lig_valid=6,
                     n_prot_valid=24), "cpu")


def test_train_step_spans_and_same_losses():
    """One step opens each stage span once, inside train.step; with
    tracing off and on, two fresh trainers take the same step."""
    cfg = preset("fabind", **TINY_XS)
    batch = _train_batch(cfg)
    tracing.disable()
    off = Trainer(cfg, "cpu").train_step(batch)
    tracing.reset()
    tracing.enable()
    try:
        trainer = Trainer(cfg, "cpu")
        on = trainer.train_step(batch)
        snap = tracing.snapshot()
    finally:
        tracing.disable()
        tracing.reset()
    assert on == off
    by = _by_name(snap)
    (step,) = by["train.step"]
    assert step.ids == {"step": 0}
    for name in ("train.forward", "train.loss", "train.backward",
                 "train.optimizer", "train.readback"):
        (s,) = by[name]
        assert s.parent == step.sid and s.ids == {"step": 0}
    (fwd,) = by["train.forward"]
    for s in by.get("train.gate_sync", []):
        assert s.parent == fwd.sid


def test_export_unchanged_with_tracing_on():
    """A bucket's exported program is the same graph with tracing on (no
    span or count runs while torch exports)."""
    cfg = preset("fabind", **TINY_XS)
    model = Trainer(cfg, "cpu").model.eval()
    batch = normalize_batch(_train_batch(cfg), 2)
    prog = _BucketProgram(model, cfg.shapes)

    def export():
        with torch.no_grad():
            ep = torch.export.export(prog, batch_leaves(batch), strict=False)
        return ep.graph_module.code

    tracing.disable()
    off = export()
    tracing.enable()
    try:
        on = export()
        snap = tracing.snapshot()
    finally:
        tracing.disable()
        tracing.reset()
    assert on == off
    assert snap["spans"] == []
