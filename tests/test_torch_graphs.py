"""The serving engine's graphs of the docking stage (fabind_tpu_torch/
graphs.py) on the CPU, with `graphs.Rerun` standing in for CUDA graph
capture: each segment records the ATen operations it runs and replays
them on the same tensors, so a replay reads only what was copied into the
captured inputs, as a CUDA graph does.

- The split: a chain has one segment more than the gate calls it
  captured, and at replay the gate's operator runs between segments; a
  replay records every matrix product and gate call of the eager docking
  stage, in order and at its shapes.
- The engine: graphed poses equal eager poses bit for bit (base in fp32
  and bf16, FABind+, fabflex's docked pocket, the triangle-attention
  stack); batches of one bucket launched before any is read back keep
  their own outputs; threads on one bucket give the poses of serial calls.
- Best-of-N: a pass's dock half replays its bucket's stochastic chain,
  captured once for every drawn recycle count, bit for bit the eager dock
  half at every count and seed (the pass's seed is an input, not part of
  the capture); eight passes in flight keep their own outputs.
- Eager fallback, counted under serve.graph_eager: the CPU, two replicas,
  best-of-N there and in the fixed pocket mode, a thread in a stochastic
  forward, a bucket whose capture failed (tried once) and a recycle count
  given as a tensor.
- A segment refuses what a graph cannot hold (a read-back to the host).
"""
from __future__ import annotations

import dataclasses
import threading

import numpy as np
import pytest
import torch

from common import TINY
from test_torch_cuda import _raw

from fabind_tpu_torch import graphs
from fabind_tpu_torch.config import preset
from fabind_tpu_torch.models.layers import RowMap, dropout_seed
from fabind_tpu_torch.ops import edge_gate
from fabind_tpu_torch.sample import (live_halves, recycle_counts,
                                     sample_poses, stochastic_dock,
                                     stochastic_pocket)
from fabind_tpu_torch.serve import DockingEngine, _bucket_label
from fabind_tpu_torch.utils import tracing

# 2 docking layers x 2 recycles: 4 gate calls in the docking stage
KW = dict(TINY, mean_layers=2)
SMALL, LARGE = "8x16x32", "16x24x48"
COUNTERS = ("serve.graph_captures", "serve.graph_replays", "serve.graph_eager")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's toy-sized torch work (the
    suite runs in parallel workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def rerun(monkeypatch):
    """Engines built in the test capture their docking stage with the
    stand-in, on the CPU."""
    monkeypatch.setattr(graphs, "backend_for", lambda device: graphs.Rerun)


def _engine(name="fabind", eager=False, flags=None, **kw):
    cfg = preset(name, **dict(KW, **(flags or {})))
    small = dataclasses.replace(cfg.shapes, max_ligand=8, max_pocket=16,
                                max_protein=32)
    kw.setdefault("device", "cpu")
    eng = DockingEngine(cfg, buckets=[small, cfg.shapes], batch_size=2,
                        seed=0, **kw)
    if eager:
        eng._graphs = None
    return eng


def _requests():
    """Requests for both buckets (several batches of each) and one that
    fits neither."""
    return [_raw(5, 12, 1), _raw(12, 40, 2), _raw(30, 40, 3), _raw(6, 14, 4),
            _raw(14, 44, 5), _raw(7, 20, 6), _raw(4, 10, 7), _raw(8, 30, 8),
            _raw(10, 36, 9), _raw(3, 9, 10)]


def _batches(eng, raws):
    """{bucket label: batches} of a dock_raw of `raws`."""
    out = {}
    for _, cfg_b, _, _ in eng.batches(raws, [None] * len(raws)):
        label = _bucket_label(cfg_b.shapes)
        out[label] = out.get(label, 0) + 1
    return out


def _counts():
    c = tracing.snapshot()["counters"]
    return {k: dict(c.get(k, {})) for k in COUNTERS}


def _moved(before, after):
    return {k: {b: n - before[k].get(b, 0) for b, n in after[k].items()
                if n != before[k].get(b, 0)} for k in COUNTERS}


def _assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.error == w.error
        if w.error is None:
            np.testing.assert_array_equal(g.coords, w.coords)
            assert g.confidence == w.confidence
            assert g.pocket_truncated == w.pocket_truncated
            if w.pocket_coords is not None:
                np.testing.assert_array_equal(g.pocket_coords,
                                              w.pocket_coords)
                np.testing.assert_array_equal(g.pocket_residues,
                                              w.pocket_residues)


# ---------------------------------------------------------------- the split
def test_segments_split_at_gate_calls(monkeypatch):
    """A function with k gate calls is k + 1 segments; a replay runs them
    in order with the gate's operator between each two, on the inputs the
    segment before left, and equals the function run eagerly on the new
    inputs."""
    g = torch.Generator().manual_seed(0)
    B, Na, Nb, H = 2, 3, 5, 4
    w = [torch.randn(s, generator=g) for s in ((B, Na, H), (B, Nb, H),
                                              (H,), (H,))]

    def fn(x):
        l1_a, l1_b, u, w2 = w
        r = x * 2.0
        out = r
        for _ in range(3):
            ab, ba = edge_gate.phi_rank1_pair(l1_a, l1_b, r, u, w2)
            r = (ab + ba.transpose(1, 2)).tanh()
            out = out + r
        return out * 0.5

    log = []
    seg_replay = graphs._Recorder.replay
    plain = edge_gate.phi_rank1_pair_reference

    def segment(self):
        log.append("segment")
        seg_replay(self)

    def gate(*args, **kw):
        log.append("gate")
        return plain(*args, **kw)

    monkeypatch.setattr(graphs._Recorder, "replay", segment)
    monkeypatch.setattr(edge_gate, "phi_rank1_pair_reference", gate)
    x = torch.randn(B, Na, Nb, generator=g)
    static = x.clone()
    chain = graphs.SegmentChain(graphs.Rerun(), fn, static)
    assert len(chain.segments) == 4 and len(chain.gates) == 3
    assert log == []                  # a capture launches no gate
    y = torch.randn(B, Na, Nb, generator=g)
    static.copy_(y)
    chain.replay()
    assert log == ["segment", "gate"] * 3 + ["segment"]
    monkeypatch.undo()
    torch.testing.assert_close(chain.outputs, fn(y), rtol=0, atol=0)


def test_a_segment_refuses_a_host_read():
    """What a CUDA graph cannot hold raises inside a segment: a value read
    back to the host, a shape that depends on the data."""
    x = torch.arange(6.0)
    for bad in (lambda: float(x.sum()), lambda: x[x > 2]):
        with pytest.raises(RuntimeError, match="graph segment"):
            graphs.SegmentChain(graphs.Rerun(), bad)
    assert torch._C._len_torch_dispatch_stack() == 0


# ---------------------------------------------------------------- the engine
@pytest.mark.parametrize("name,bf16,flags", [
    ("fabind", False, {}), ("fabind", True, {}), ("fabind_plus", True, {}),
    ("fabflex", True, {}), ("fabind", False, {"keep_trig_attn": True})])
def test_graphed_dock_raw_equals_eager(rerun, name, bf16, flags):
    """Graphed poses equal the eager engine's bit for bit in every bucket,
    the first call (captured, then replayed) and the second (replays);
    each bucket is captured once, at its first batch, and every batch is a
    replay; the chain holds one recycle round, which a replay runs twice,
    and splits at every matrix product and, in the base model, at the 2
    docking gates of its round (FABind+ has none)."""
    want = _engine(name, True, flags, bf16=bf16).dock_raw(_requests())
    eng = _engine(name, False, flags, bf16=bf16)
    n = _batches(eng, _requests())
    assert n[SMALL] >= 2 and n[LARGE] >= 2
    before = _counts()
    first = eng.dock_raw(_requests())
    second = eng.dock_raw(_requests())
    _assert_same(first, want)
    _assert_same(second, want)
    assert _moved(before, _counts()) == {
        "serve.graph_captures": {SMALL: 1, LARGE: 1},
        "serve.graph_replays": {k: 2 * v for k, v in n.items()},
        "serve.graph_eager": {}}
    n_gates = 0 if name == "fabind_plus" else 2
    between = set(graphs._PRODUCTS) | {graphs._gate_op()}
    for b in eng._graphs._buckets.values():
        assert len(b.chain.gates) == n_gates
        assert len(b.chain.calls) > n_gates            # the products
        assert set(b.chain.calls) <= between
        assert 0 < len(b.chain.segments) <= len(b.chain.calls) + 1


RECORDED = ("aten::mm", "aten::addmm", "aten::bmm", "aten::baddbmm",
            "fabind_tpu_torch::edge_gate_pair")


def _recorded(eng, raws):
    """(name, shapes of the operands) of every product and gate call a
    dock_raw records under the profiler, in order (an out= overload also
    records its output, which is left out)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as p:
        eng.dock_raw(raws)
    n = {"aten::mm": 2, "aten::bmm": 2, "aten::addmm": 3, "aten::baddbmm": 3}
    return [(e.name, [list(s) for s in e.input_shapes[:n.get(e.name, 5)]])
            for e in p.events() if e.name in RECORDED]


@pytest.mark.parametrize("name,bf16", [("fabind", False),
                                       ("fabind_plus", True)])
def test_replay_records_the_eager_products(rerun, name, bf16):
    """A replay launches every matrix product and gate call of the eager
    docking stage as an operator call of its own, in the same order and at
    the same shapes, so what reads operator records (a roofline of the
    products, of the gate) reads the same work: composite operations
    (linear, matmul, einsum) pick the same products as eager dispatch."""
    raws = _requests()[:2]
    eager = _engine(name, True, bf16=bf16)
    eng = _engine(name, bf16=bf16)
    eng.dock_raw(raws)                        # captures
    want, got = _recorded(eager, raws), _recorded(eng, raws)
    assert sum(r[0] == "aten::addmm" for r in want) > 0
    assert got == want


def test_inflight_batches_keep_their_outputs(rerun):
    """dock_raw launches every batch before reading any back: three
    batches of one bucket, replayed in a row, return three different
    results, each its own eager one."""
    eng = _engine()
    raws = [r for r in (_raw(3 + i % 5, 8 + i, 40 + i) for i in range(12))
            if _batches(eng, [r]) == {SMALL: 1}][:6]
    assert len(raws) == 6
    eng.dock_raw(raws[:1])                      # captures the small bucket
    got = eng.dock_raw(raws)
    want = _engine(eager=True).dock_raw(raws)
    _assert_same(got, want)
    assert len({g.coords.tobytes() for g in got}) == 6


def test_threads_on_one_bucket_equal_serial(rerun):
    """Four threads replaying one bucket's graphs at once give the poses
    of serial calls."""
    eng = _engine()
    work = [[_raw(5 + i, 14, 10 + i), _raw(6, 12, 20 + i)]
            for i in range(4)]
    serial = [eng.dock_raw(w) for w in work]
    out = [None] * 4

    def call(i):
        out[i] = eng.dock_raw(work[i])

    before = _counts()
    threads = [threading.Thread(target=call, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    assert _moved(before, _counts())["serve.graph_replays"] == {SMALL: 4}
    for got, want in zip(out, serial):
        _assert_same(got, want)


def test_replay_span(rerun):
    """A replay runs under a model.dock span with id graph="replay"."""
    eng = _engine()
    raws = _requests()[:1]
    eng.dock_raw(raws)
    tracing.reset()
    tracing.enable()
    try:
        eng.dock_raw(raws)
        spans = tracing.snapshot()["spans"]
    finally:
        tracing.disable()
        tracing.reset()
    docks = [s for s in spans if s.name == "model.dock"]
    assert len(docks) == 1 and docks[0].ids["graph"] == "replay"
    assert docks[0].ids["bucket"] == SMALL
    assert not any(s.name == "model.round" and s.ids["stage"] == "dock"
                   for s in spans)


def test_a_failed_capture_serves_eager_once(rerun, monkeypatch):
    """A bucket whose capture raises still serves its first batch's eager
    result, warns once and docks eagerly from then on without capturing
    again. A captured bucket replays another recycle count than its
    first batch's (the count is an input of the replay) and docks a count
    given as a tensor eagerly."""
    raws = [_raw(5, 12, 1), _raw(6, 14, 2)]
    want = _engine(eager=True).dock_raw(raws)
    tries = []

    class Broken(graphs.Rerun):
        def begin(self):
            tries.append(1)
            raise RuntimeError("no capture here")

    monkeypatch.setattr(graphs, "backend_for", lambda device: Broken)
    eng = _engine()
    before = _counts()
    with pytest.warns(UserWarning, match="docks eagerly"):
        first = eng.dock_raw(raws)
    second = eng.dock_raw(raws)
    _assert_same(first, want)
    _assert_same(second, want)
    assert len(tries) == 1 and eng._graphs.captured == 0
    assert _moved(before, _counts()) == {
        "serve.graph_captures": {}, "serve.graph_replays": {},
        "serve.graph_eager": {SMALL: 2}}

    monkeypatch.setattr(graphs, "backend_for", lambda device: graphs.Rerun)
    eng = _engine()
    eng.dock_raw(raws)                                    # captures
    (_, cfg_b, batch, _), = list(eng.batches(raws, [None] * len(raws)))
    bucket = eng._graph_dock(batch, cfg_b)
    model = eng.model
    assert bucket.consts == (True, cfg_b.shapes.ctx_k)
    for count, moved in ((1, "serve.graph_replays"),
                         (torch.tensor(1), "serve.graph_eager")):
        before = _counts()
        with torch.inference_mode():
            a = model.inference_diag(batch, shapes=cfg_b.shapes, count=count,
                                     dock=bucket)
            b = model.inference_diag(batch, shapes=cfg_b.shapes, count=1)
        torch.testing.assert_close(a, b, rtol=0, atol=0)
        assert _moved(before, _counts()) == dict(
            {k: {} for k in COUNTERS}, **{moved: {SMALL: 1}})


# ---------------------------------------------------------------- best-of-N
def _sampler_batch():
    """A best-of-N stand-in engine at 1 layer x 3 recycles, one
    small-bucket batch of it and the bucket's stochastic docking chain."""
    eng = _engine("fabind_plus_sampling", flags={"n_iter": 3,
                                                 "mean_layers": 1})
    raws = [_raw(5, 12, 1), _raw(6, 14, 2)]
    (_, cfg_b, batch, _), = list(eng.batches(raws, [None] * len(raws)))
    return eng, cfg_b, batch, eng._graph_dock_half(batch, cfg_b, 1)


def test_graphed_dock_half_equals_eager_at_every_count(rerun):
    """A pass's dock half replayed from its bucket's stochastic chain
    equals the eager dock half bit for bit at every recycle count and
    under two seeds, from the same pocket half: the chain is captured once
    for all of them, and a second seed through it gives other outputs, its
    own eager ones (a seed kept from the capture would repeat the
    first's)."""
    eng, cfg_b, batch, bucket = _sampler_batch()
    model, m, shapes = eng.model, cfg_b.model, cfg_b.shapes
    before = _counts()
    got = {}
    with torch.inference_mode():
        pocket, center = stochastic_pocket(model, batch, shapes, 11,
                                           recycle_counts(m, 11)[0])
        for seed in (11, 12):
            for count in range(1, m.n_iter + 1):
                want = stochastic_dock(model, batch, shapes, pocket, center,
                                       seed, count)
                got[seed, count] = stochastic_dock(
                    model, batch, shapes, pocket, center, seed, count,
                    RowMap(), bucket)
                torch.testing.assert_close(got[seed, count], want, rtol=0,
                                           atol=0)
    n = 2 * m.n_iter
    assert _moved(before, _counts()) == {
        "serve.graph_captures": {SMALL: 1}, "serve.graph_replays": {SMALL: n},
        "serve.graph_eager": {}}
    for count in range(1, m.n_iter + 1):
        assert not all(torch.equal(a, b) for a, b in zip(got[11, count],
                                                         got[12, count]))


def test_inflight_best_of_passes_keep_their_outputs(rerun):
    """Eight passes of a batch, every dock half launched before any output
    is read, each replaying the bucket's chain, keep their own outputs:
    each pass equals the eager pass bit for bit, and the passes differ."""
    eng, cfg_b, batch, bucket = _sampler_batch()
    got = sample_poses(eng.model, batch, cfg_b, 8, seed=5,
                       halves=live_halves(eng.model, cfg_b, dock=bucket))
    want = sample_poses(eng.model, batch, cfg_b, 8, seed=5)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert len({got[1][s].float().numpy().tobytes() for s in range(8)}) == 8


# ---------------------------------------------------------- eager fallback
def test_eager_on_cpu_with_two_replicas_and_best_of(rerun, monkeypatch):
    """No graph, every batch counted under serve.graph_eager: an engine on
    the CPU (without the stand-in), two replicas, and a dock_raw inside a
    stochastic forward of its thread; best-of-N's dock halves, each counted
    once, dock eagerly there and in the fixed pocket mode, and replay on
    the one-replica engine with the stand-in."""
    raws = _requests()[:2]
    halves = {SMALL: 2, LARGE: 2}           # 2 passes in each bucket
    one = {"mean_layers": 1}
    eager = {"serve.graph_captures": {}, "serve.graph_replays": {},
             "serve.graph_eager": halves}
    monkeypatch.undo()
    plain = _engine()
    assert plain._graphs is None
    before = _counts()
    plain.dock_raw(raws)
    assert _moved(before, _counts()) == {
        "serve.graph_captures": {}, "serve.graph_replays": {},
        "serve.graph_eager": {SMALL: 1, LARGE: 1}}
    before = _counts()
    _engine("fabind_plus_sampling", flags=one).dock_best_of(
        raws, sample_size=2, seed=3)
    assert _moved(before, _counts()) == eager

    monkeypatch.setattr(graphs, "backend_for", lambda device: graphs.Rerun)
    two = _engine(device=["cpu", "cpu"])
    assert two._graphs is None
    before = _counts()
    two.dock_raw(raws)
    assert _moved(before, _counts())["serve.graph_eager"] == {SMALL: 1,
                                                              LARGE: 1}
    for kw in (dict(device=["cpu", "cpu"], flags=one),
               dict(flags=dict(one, sampling_pocket_mode="fixed"))):
        before = _counts()
        _engine("fabind_plus_sampling", **kw).dock_best_of(raws,
                                                           sample_size=2,
                                                           seed=3)
        assert _moved(before, _counts()) == eager, kw

    sampler = _engine("fabind_plus_sampling", flags=one)
    assert sampler._graphs is not None
    before = _counts()
    sampler.dock_best_of(raws, sample_size=2, seed=3)
    assert _moved(before, _counts()) == {
        "serve.graph_captures": {SMALL: 1, LARGE: 1},
        "serve.graph_replays": halves, "serve.graph_eager": {}}

    eng = _engine()
    before = _counts()
    with dropout_seed(5):
        eng.dock_raw(raws)
    assert _moved(before, _counts())["serve.graph_eager"] == {SMALL: 1,
                                                              LARGE: 1}
    assert eng._graphs.captured == 0
