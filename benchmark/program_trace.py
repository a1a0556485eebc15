"""The program's own spans (fabind_tpu_torch/utils/tracing.py) in a traced
run, and their join with a profile.

While a torch.profiler records, the program records its spans (on its own
clock, `time.perf_counter_ns`) and opens a `record_function` range of each,
so the traced run's profiled part holds them with no switch of its own.
`profiled_spans(ctx)` gives the spans the program recorded in the profiled
part of the window, for the per-layer readers; None when the program has no
tracing module, as before it had one: every reader then returns None.

`reduce(events, snapshot)` puts the program's spans on the profile's clock
(each span's `record_function` range starts before the span's own start and
ends after its end, which bounds the offset between the two clocks from
both sides). It then attributes, within `bench.window`,
- every idle gap of the device (the complement of the union of its
  activity, as benchmark/trace.py counts busy time) to the innermost
  program span open at the gap's midpoint on a calling thread (one that
  opened serve.call or train.step), "none" when no span is open there;
- every runtime launch call, from whichever thread, to the innermost
  calling-thread span open at its time (so the backward's launches from
  autograd's thread count under train.backward).
Spans of other threads (the Loader's workers, its prefetch thread) never
name a gap. Each sum is kept by innermost span ("by_span"), by every span
on the open stack ("under": a span with its children) and, for recycle
rounds, by "<stage>.<round>". The attributed idle sums to the window's
idle time and the attributed launches to its launch count. The drivers
discard each profile once benchmark/trace.py has reduced it, so no
per-layer reader makes this join: tools/torch_program_trace.py makes it
inside `joining()`.
"""
from __future__ import annotations

import bisect
import contextlib
import statistics
from collections import defaultdict
from typing import (Dict, Iterable, Iterator, List, Optional, Sequence,
                    Tuple)

from benchmark.trace import (LAUNCH_NAMES, WINDOW, _is_annotation,
                             _is_device, union_us)

PREFIXES = ("serve.", "model.", "train.", "data.", "loader.")
CALLERS = ("serve.call", "train.step")
ROUND = "model.round"


def is_program_span(name: str) -> bool:
    return name.startswith(PREFIXES)


def _label(s) -> Optional[str]:
    """A recycle round's "<stage>.<round>" key."""
    if s.name != ROUND:
        return None
    return f"{s.ids.get('stage')}.{s.ids.get('round', 'last')}"


def clock_offset(events: List, spans: List) -> Tuple[float, float]:
    """(profile microseconds - span microseconds, the width of the interval
    the bounds leave) from the spans that also ran as profiled ranges,
    paired by name in start order (names whose counts differ, such as a
    worker's span the profiler stopped inside, are left out)."""
    ranges = defaultdict(list)
    for e in events:
        if not _is_device(e) and is_program_span(e.name):
            ranges[e.name].append((e.time_range.start, e.time_range.end))
    mine = defaultdict(list)
    for s in spans:
        if s.profiled:
            mine[s.name].append((s.start_ns * 1e-3, s.end_ns * 1e-3))
    lo, hi = [], []
    for name, rs in ranges.items():
        ss = mine.get(name, [])
        if len(ss) != len(rs):
            continue
        for (a, b), (s0, s1) in zip(sorted(rs), sorted(ss)):
            lo.append(a - s0)
            hi.append(b - s1)
    if not lo:
        raise RuntimeError("no program span ran as a profiled range: the "
                           "spans cannot be put on the profile's clock")
    if max(lo) <= min(hi):
        return (max(lo) + min(hi)) / 2, min(hi) - max(lo)
    return statistics.median(lo + hi), min(hi) - max(lo)


class _Timeline:
    """The open spans of one thread through time: `at(t)` is the stack of
    spans open at t, outermost first (spans of one thread nest)."""

    def __init__(self, spans: List):
        self.edges: List[float] = []
        self.stacks: List[Tuple] = []
        stack: List = []
        for iv in sorted(spans, key=lambda x: (x[0], -x[1])):
            while stack and stack[-1][1] <= iv[0]:
                self._close(stack)
            stack.append(iv)
            self.edges.append(iv[0])
            self.stacks.append(tuple(x[2] for x in stack))
        while stack:
            self._close(stack)

    def _close(self, stack: List) -> None:
        end = stack.pop()[1]
        self.edges.append(end)
        self.stacks.append(tuple(x[2] for x in stack))

    def at(self, t: float) -> Tuple:
        i = bisect.bisect_right(self.edges, t) - 1
        return self.stacks[i] if i >= 0 else ()


def reduce(events: Iterable, snap: Dict) -> Optional[Dict]:
    """One profile's events joined with the program's snapshot (module
    docstring): window, idle and launches with their attributions (ms and
    counts), the number of calling-thread spans of each name (recycle
    rounds by stage) whose midpoint lies in the window, and the clock
    offset's uncertainty. None when the snapshot holds no span. Raises when
    a device event is named like a program span and is not a mirrored
    annotation: benchmark/trace.py would count it as busy time."""
    spans = snap["spans"]
    if not spans:
        return None
    events = list(events)
    for e in events:
        if (_is_device(e) and is_program_span(e.name)
                and not getattr(e, "is_user_annotation", False)):
            raise RuntimeError(
                f"device event {e.name!r} is named like a program span and "
                f"is not a user annotation: it would count as busy time")
    win = [e for e in events if e.name == WINDOW and not _is_device(e)]
    if not win:
        raise RuntimeError("the profile holds no bench.window range")
    w0, w1 = win[0].time_range.start, win[0].time_range.end
    dev, launches = [], []
    for e in events:
        a, b = e.time_range.start, e.time_range.end
        if _is_device(e):
            if not _is_annotation(e):
                a, b = max(a, w0), min(b, w1)
                if b > a:
                    dev.append((a, b))
        elif e.name in LAUNCH_NAMES and w0 <= a <= w1:
            launches.append(a)
    busy, merged = union_us(dev)
    edges = [w0] + [x for iv in merged for x in iv] + [w1]
    gaps = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]

    off, width = clock_offset(events, spans)
    callers = {s.thread for s in spans if s.name in CALLERS}
    by_thread = defaultdict(list)
    in_window: Dict[str, int] = defaultdict(int)
    for s in spans:
        if s.thread not in callers:
            continue
        a, b = s.start_ns * 1e-3 + off, s.end_ns * 1e-3 + off
        if b < w0 or a > w1:
            continue
        by_thread[s.thread].append((a, b, s))
        if w0 <= (a + b) / 2 <= w1:
            in_window[s.name] += 1
            if s.name == ROUND:
                in_window[f"{ROUND}.{s.ids.get('stage')}"] += 1
    timelines = [_Timeline(v) for v in by_thread.values()]

    def stack_at(t: float) -> Tuple:
        return max((tl.at(t) for tl in timelines), key=len, default=())

    out = {"window_ms": (w1 - w0) * 1e-3, "idle_ms": (w1 - w0 - busy) * 1e-3,
           "launches": len(launches), "clock_us": width,
           "in_window": dict(in_window)}
    for kind, items in (("idle_ms", [((a + b) / 2, (b - a) * 1e-3)
                                      for a, b in gaps]),
                        ("launches", [(t, 1) for t in launches])):
        by_span: Dict[str, float] = defaultdict(float)
        under: Dict[str, float] = defaultdict(float)
        by_round: Dict[str, float] = defaultdict(float)
        for t, v in items:
            stack = stack_at(t)
            by_span[stack[-1].name if stack else "none"] += v
            for name in {s.name for s in stack}:
                under[name] += v
            if stack and _label(stack[-1]):
                by_round[_label(stack[-1])] += v
        out[f"{kind}_by_span"] = dict(by_span)
        out[f"{kind}_under"] = dict(under)
        out[f"{kind}_by_round"] = dict(by_round)
    return out


@contextlib.contextmanager
def joining(tracing) -> Iterator[List[Optional[Dict]]]:
    """Within the block, each profile that benchmark/trace.py reduces is
    also joined with the program's snapshot of that moment (`reduce`);
    yields the list of the joins, in order."""
    from benchmark import trace as tr
    joins: List[Optional[Dict]] = []
    inner = tr.reduce

    def both(prof):
        joins.append(reduce(prof.events(), tracing.snapshot()))
        return inner(prof)

    tr.reduce = both
    try:
        yield joins
    finally:
        tr.reduce = inner


# ------------------------------------------------------------- the readers
def profiled_spans(ctx) -> Optional[List]:
    """The spans the program recorded in the profiled part of the window
    (harness.in_profile, by each span's start), None when the program has
    no tracing module."""
    import importlib

    from benchmark.harness import in_profile
    try:
        tracing = importlib.import_module("fabind_tpu_torch.utils.tracing")
    except ImportError:
        return None
    return [s for s in tracing.snapshot()["spans"]
            if s.profiled and in_profile(ctx, s.start_ns * 1e-9)]


def mean_ms(spans: Optional[List], name: str) -> Optional[float]:
    """Mean host milliseconds of the spans named `name`, None without
    one."""
    d = [s.end_ns - s.start_ns for s in spans or () if s.name == name]
    return 1e-6 * sum(d) / len(d) if d else None


def ms_per(spans: Optional[List], names: Sequence[str],
           per: str) -> Optional[float]:
    """Host milliseconds of the spans named `names` per span named `per`,
    None without a span `per`."""
    n = sum(s.name == per for s in spans or ())
    if not n:
        return None
    return 1e-6 * sum(s.end_ns - s.start_ns for s in spans
                      if s.name in names) / n
