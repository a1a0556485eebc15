"""Helpers the per-layer readers share (not a metric: no reader is named
with a leading underscore)."""
from __future__ import annotations

from typing import Dict, List, Optional


def trace(ctx) -> Optional[Dict]:
    return ctx.record.get("trace")


def profiled_batches(ctx) -> List[Dict]:
    """The batch records of the profiled part of the window."""
    from benchmark.harness import in_profile
    return [b for b in ctx.record.get("batches", [])
            if in_profile(ctx, b["t"])]


def elem_bytes(ctx) -> int:
    from benchmark.peaks import ELEM_BYTES
    return ELEM_BYTES[ctx.config.serve_dtype]


def share(bound_ms: float, time_ms: float) -> Optional[float]:
    """100 x bound / time, None when nothing ran."""
    if time_ms <= 0 or bound_ms <= 0:
        return None
    return 100.0 * bound_ms / time_ms
