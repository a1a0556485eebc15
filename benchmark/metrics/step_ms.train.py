"""Host milliseconds per training step: `Trainer.train_step` (forward,
losses, backward, the metrics read back, AdamW), over the window's
unprofiled steps."""
from benchmark.harness import in_profile


def read(ctx):
    d = [b - a for a, b in ctx.spans.intervals.get("step", [])
         if not in_profile(ctx, a)]
    return 1e3 * sum(d) / len(d) if d else None
