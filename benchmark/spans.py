"""The benchmark's own spans, kept in memory.

Spans sit around calls into the port's layers on the instances the
benchmark builds (never inside the program). Each is recorded on the host
clock and, while a profiler runs, as a `record_function` range of the same
name, so a reading of the trace can say which span was open during an idle
gap of the device.
"""
from __future__ import annotations

import contextlib
import threading
import time
from collections import defaultdict
from typing import Dict, Iterator, List, Tuple


class Spans:
    """Named host-clock intervals, thread-safe."""

    def __init__(self):
        self.intervals: Dict[str, List[Tuple[float, float]]] = defaultdict(list)
        self.profiling = False
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def span(self, name: str) -> Iterator[None]:
        rf = None
        if self.profiling:
            import torch
            rf = torch.profiler.record_function(f"bench.{name}")
            rf.__enter__()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            t1 = time.perf_counter()
            if rf is not None:
                rf.__exit__(None, None, None)
            with self._lock:
                self.intervals[name].append((t0, t1))



def wrap_generator(spans: Spans, name: str, gen) -> Iterator:
    """Yield from `gen`, each `next()` that yields an item inside the span
    `name` (the last, which ends the generator, is not a span)."""
    it = iter(gen)
    while True:
        rf = None
        if spans.profiling:
            import torch
            rf = torch.profiler.record_function(f"bench.{name}")
            rf.__enter__()
        t0 = time.perf_counter()
        try:
            item = next(it)
        except StopIteration:
            return
        finally:
            t1 = time.perf_counter()
            if rf is not None:
                rf.__exit__(None, None, None)
        with spans._lock:
            spans.intervals[name].append((t0, t1))
        yield item
