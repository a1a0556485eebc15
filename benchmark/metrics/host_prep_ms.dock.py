"""Host milliseconds per batch of serve.DockingEngine's preparation
(featurize, route, collate, upload): the span around each `next()` of the
engine's `batches` generator, over the window's unprofiled calls."""
from benchmark.harness import in_profile


def read(ctx):
    d = [b - a for a, b in ctx.spans.intervals.get("prep", [])
         if not in_profile(ctx, a)]
    return 1e3 * sum(d) / len(d) if d else None
