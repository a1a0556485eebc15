"""Spans and counters of the port's layers, kept in memory.

A span is a named interval of host work on one thread: serving's call,
featurization, collate, upload, batch and collect; the model's pocket
stage, center, crop, docking stage and each recycle round; the training
step's forward, losses, backward, optimizer and read-backs; the loader's
wait, per-sample build and collate. Each records its name, its start and
end (`time.perf_counter_ns`), its thread, its parent (the innermost span
open on the same thread, by `sid`) and its ids (the call, batch index,
bucket, train step, recycle stage and round), a span inheriting its
parent's ids so the spans of one batch share them.

- A span records while tracing is on (`enable()` / `disable()`, for the
  process) or a torch.profiler records; otherwise `span()` returns one
  shared null context after a flag check and a query of the profiler, and
  records nothing. `snapshot()` returns what was recorded and `reset()`
  clears it. Spans are kept in a bounded list: those past MAX_SPANS are
  counted in `spans_dropped`, not kept.
- While a torch.profiler records, a span also opens a `record_function`
  range of its name, so the profile holds it on the profiler's clock beside
  the kernels (`cli.train --profile-dir` / `cli.evaluate --profile-dir`
  traces show it, and the benchmark's traced runs read the spans of their
  profiled part). Its perf_counter times lie inside that range.
- Nothing is recorded while torch compiles or exports (an exported program
  is the same with tracing on) or while the current CUDA stream captures a
  graph: a span there would run once at capture, not at replay.
- `spanned(name, ids)` runs a whole function inside a span, so a span
  around a function body needs no block of its own.
- Counters are plain integers (or {key: integer} by bucket), always kept,
  in one registry. They count host work of serving, outside any compiled
  or captured region; `GET /health` reports them.

A span must not enclose a `yield`: a generator resumed elsewhere would
close it out of order.
"""
from __future__ import annotations

import contextlib
import functools
import itertools
import threading
import time
from typing import Callable, Dict, List, NamedTuple, Optional

import torch

MAX_SPANS = 1 << 18


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    thread: int              # threading.get_ident() of the span's thread
    sid: int
    parent: Optional[int]    # sid of the enclosing span of the same thread
    ids: Dict
    profiled: bool           # also a record_function range of a profiler


_enabled = False
_NULL = contextlib.nullcontext()
_local = threading.local()
_lock = threading.Lock()
_spans: List[Span] = []
_dropped = 0
_sid = itertools.count()
_counters: Dict[str, object] = {}


def _live() -> bool:
    """Whether a span records now: tracing is on or a profiler records."""
    return _enabled or torch.autograd._profiler_enabled()


def _skip() -> bool:
    """Whether work here is traced into a program rather than run: torch
    compiles or exports, or a CUDA graph captures."""
    return torch.compiler.is_compiling() or (
        torch.cuda.is_initialized() and
        torch.cuda.is_current_stream_capturing())


class _Open:
    __slots__ = ("name", "ids", "start", "sid", "parent", "rf", "stack")

    def __init__(self, name: str, ids: Dict):
        self.name, self.ids, self.stack = name, ids, None

    def __enter__(self):
        if _skip():
            return self
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        up = stack[-1] if stack else None
        self.parent = None if up is None else up.sid
        if up is not None and up.ids:
            self.ids = {**up.ids, **self.ids}
        self.sid = next(_sid)
        self.rf = None
        if torch.autograd._profiler_enabled():
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        stack.append(self)
        self.stack = stack
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        global _dropped
        if self.stack is None:
            return False
        end = time.perf_counter_ns()
        if self.stack and self.stack[-1] is self:
            self.stack.pop()
        else:
            self.stack.remove(self)
        if self.rf is not None:
            self.rf.__exit__(None, None, None)
        rec = Span(self.name, self.start, end, threading.get_ident(),
                   self.sid, self.parent, self.ids, self.rf is not None)
        with _lock:
            if len(_spans) < MAX_SPANS:
                _spans.append(rec)
            else:
                _dropped += 1
        return False


def span(name: str, **ids):
    """A context manager that records the block as span `name` with `ids`
    (the shared null context while nothing records, `_live`)."""
    if not _live():
        return _NULL
    return _Open(name, ids)


def spanned(name: str, ids: Optional[Callable[..., Dict]] = None):
    """Decorate a function to run inside span `name`; `ids(*args)` gives
    the span's ids from the call's positional arguments."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            if not _live():
                return fn(*args, **kwargs)
            with _Open(name, {} if ids is None else ids(*args)):
                return fn(*args, **kwargs)
        return inner
    return wrap


def count(name: str, n: int = 1, key: Optional[str] = None) -> None:
    """Add n to counter `name` (to its entry `key`, when given)."""
    with _lock:
        if key is None:
            _counters[name] = _counters.get(name, 0) + n
        else:
            by = _counters.setdefault(name, {})
            by[key] = by.get(key, 0) + n


def enable() -> None:
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def snapshot() -> Dict:
    """{"spans": [Span...] in the order they ended, "spans_dropped": the
    spans past MAX_SPANS, "counters": {name: int or {key: int}}}."""
    with _lock:
        return {"spans": list(_spans), "spans_dropped": _dropped,
                "counters": {k: dict(v) if isinstance(v, dict) else v
                             for k, v in _counters.items()}}


def reset() -> None:
    """Forget the recorded spans and zero the counters."""
    global _dropped
    with _lock:
        _spans.clear()
        _dropped = 0
        _counters.clear()
