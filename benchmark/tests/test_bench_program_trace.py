"""program_trace.reduce on a synthetic profile (the attribution of idle
gaps and launches to the calling thread's innermost span, the sums, the
refusal of a device event named like a program span), the same join of a
traced toy run's profile on the CPU, and the readers of the program's spans
after a traced toy run, and with a program that has no tracing."""
from __future__ import annotations

import importlib
import json
import sys
import time
from collections import namedtuple
from pathlib import Path

import pytest
import torch

from benchmark import harness, program_trace
from benchmark.configs_io import BenchConfig

ROOT = Path(__file__).resolve().parents[1]
TOY = json.loads((ROOT / "tests" / "data" / "toy.json").read_text())
OFF = 5000.0      # profile microseconds - span microseconds

Range = namedtuple("Range", "start end")
Event = namedtuple("Event", "name time_range device_type is_user_annotation")
Span = namedtuple("Span", "name start_ns end_ns thread sid parent ids "
                          "profiled")


def _cpu(name, a, b):
    return Event(name, Range(a, b), "DeviceType.CPU", False)


def _dev(name, a, b, annotation=False):
    return Event(name, Range(a, b), "DeviceType.CUDA", annotation)


def _span(name, a, b, thread=1, profiled=False, **ids):
    return Span(name, int(a * 1e3), int(b * 1e3), thread, 0, None, ids,
                profiled)


def _case():
    """Window [0, 1000] us of span time. The calling thread (1) is in
    serve.call throughout, in serve.collate over [100, 200] and in a
    docking round over [300, 600]; a worker (2) builds over the whole
    window. The device runs [210, 290], [400, 450] and [700, 800]; the
    host launches at 120, 350, 360 and 900."""
    spans = [_span("serve.call", -50, 1050, call=3),
             _span("serve.collate", 100, 200, profiled=True, batch=0),
             _span("model.round", 300, 600, profiled=True, stage="dock",
                   round=0),
             _span("loader.build", 0, 1000, thread=2)]
    events = [_cpu("bench.window", OFF, OFF + 1000),
              # the profiled ranges enclose their spans by 1 us
              _cpu("serve.collate", OFF + 99, OFF + 201),
              _cpu("model.round", OFF + 299, OFF + 601),
              _dev("serve.collate", OFF + 210, OFF + 290, annotation=True),
              _dev("k1", OFF + 210, OFF + 290),
              _dev("k2", OFF + 400, OFF + 450),
              _dev("k3", OFF + 700, OFF + 800)]
    events += [_cpu("cudaLaunchKernel", OFF + t, OFF + t + 2)
               for t in (120, 350, 360, 900)]
    return events, {"spans": spans, "counters": {}, "spans_dropped": 0}


def test_gaps_and_launches_go_to_the_calling_threads_innermost_span():
    events, snap = _case()
    out = program_trace.reduce(events, snap)
    assert out["clock_us"] == pytest.approx(2.0)
    assert out["idle_ms_by_span"] == pytest.approx(
        {"serve.collate": 0.210, "model.round": 0.360, "serve.call": 0.200})
    assert out["idle_ms_by_round"] == pytest.approx({"dock.0": 0.360})
    assert out["idle_ms_under"]["serve.call"] == pytest.approx(0.770)
    assert "loader.build" not in out["idle_ms_under"]
    assert out["launches_by_span"] == {"serve.collate": 1, "model.round": 2,
                                       "serve.call": 1}
    assert out["launches_by_round"] == {"dock.0": 2}
    assert out["in_window"] == {"serve.collate": 1, "model.round": 1,
                                "model.round.dock": 1, "serve.call": 1}


def test_attributions_sum_to_the_totals():
    events, snap = _case()
    # a gap before any span opens is "none"
    snap["spans"][0] = _span("serve.call", 50, 1050, call=3)
    events.append(_dev("k0", OFF + 20, OFF + 60))
    out = program_trace.reduce(events, snap)
    assert out["idle_ms"] == pytest.approx(0.730)
    assert out["idle_ms_by_span"]["none"] == pytest.approx(0.020)
    assert sum(out["idle_ms_by_span"].values()) == pytest.approx(
        out["idle_ms"])
    assert sum(out["launches_by_span"].values()) == out["launches"] == 4


def test_a_device_event_named_like_a_span_must_be_an_annotation():
    events, snap = _case()
    events.append(_dev("model.round", OFF + 300, OFF + 600))
    with pytest.raises(RuntimeError, match="not a user annotation"):
        program_trace.reduce(events, snap)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the toy runs: the suite runs in parallel
    workers, and torch's threads on a loaded host slow a toy step many
    times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _toy_run(mix, seconds=0.5, **mix_keys):
    m = dict(TOY["traffic"][mix], **mix_keys)
    name = "toy_fabind_fp32" if m["driver"] == "train" else "toy_fabind"
    data = dict(TOY["configs"]["toy_fabind"])
    if m["driver"] == "train":
        data["serve_dtype"] = "fp32"
    ctx = harness.Context(
        mix, {"chips": 1}, {"per_layer": [], "end_to_end": []},
        BenchConfig(name, data), m, 2**31 + 5, seconds, True,
        time.perf_counter(), device="cpu")
    importlib.import_module(f"benchmark.drivers.{m['driver']}").run(ctx)
    return ctx


READERS = {"toy_batch": ("collate_upload_ms.dock",),
           "toy_train": ("upload_ms.train",)}
# the dock reader reads the batches after the first, so the toy run
# profiles two
MORE = {"toy_batch": {"trace_batches": 2}, "toy_train": {}}


@pytest.mark.parametrize("mix", sorted(READERS))
def test_readers_after_a_traced_toy_run(mix):
    """Every reader finds its number in the spans the program recorded
    while the profiler ran, with its tracing off; it is still off after
    the run. The window holds a few toy steps or calls even on a loaded
    host: the run profiles its second."""
    from fabind_tpu_torch.utils import tracing
    tracing.disable()
    ctx = _toy_run(mix, seconds=3.0, **MORE[mix])
    assert tracing.span("serve.call") is tracing.span("train.step")
    spans = program_trace.profiled_spans(ctx)
    assert spans and all(s.profiled for s in spans)
    for name in READERS[mix]:
        v = harness.read_metric(name, ctx)
        assert v is not None and v >= 0, name


@pytest.mark.parametrize("mix", sorted(READERS))
def test_joined_toy_profile_sums_to_the_totals(mix):
    """With the program's tracing on through the run, the join of the
    profile gives every idle gap and launch to a span or "none", summing
    to the profile's idle time and launch count (on the CPU the profile
    has no device work: the window is all idle)."""
    from fabind_tpu_torch.utils import tracing
    tracing.reset()
    tracing.enable()
    try:
        with program_trace.joining(tracing) as joins:
            _toy_run(mix, seconds=3.0, **MORE[mix])
    finally:
        tracing.disable()
        tracing.reset()
    (prof,) = joins
    assert prof["idle_ms"] == pytest.approx(prof["window_ms"])
    assert sum(prof["idle_ms_by_span"].values()) == pytest.approx(
        prof["idle_ms"])
    assert sum(prof["launches_by_span"].values()) == prof["launches"]
    assert prof["in_window"].get("serve.run_batch" if mix == "toy_batch"
                                 else "train.step")


@pytest.mark.parametrize("mix", sorted(READERS))
def test_readers_find_nothing_without_program_tracing(mix, monkeypatch):
    """A program without a tracing module (the parent of the change that
    added it): the traced run finishes and every reader returns None."""
    ctx = _toy_run(mix, **MORE[mix])
    monkeypatch.setitem(sys.modules, "fabind_tpu_torch.utils.tracing", None)
    assert program_trace.profiled_spans(ctx) is None
    for name in READERS[mix]:
        assert harness.read_metric(name, ctx) is None, name
