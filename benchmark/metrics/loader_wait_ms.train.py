"""Milliseconds per step the training loop waits for its next batch from
the host `Loader` (the span around each `next()`), over the window's
unprofiled steps."""
from benchmark.harness import in_profile


def read(ctx):
    d = [b - a for a, b in ctx.spans.intervals.get("loader_wait", [])
         if not in_profile(ctx, a)]
    return 1e3 * sum(d) / len(d) if d else None
