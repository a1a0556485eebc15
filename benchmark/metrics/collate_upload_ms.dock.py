"""Host milliseconds per batch of the engine's collate and upload (the
protein-row cache's keys and lookup, the copies to the device, the bf16
cast): the mean of the program's serve.collate spans plus that of its
serve.upload spans, over the profiled batches (the first batch's are
before the profiler starts)."""
from benchmark import program_trace as pt


def read(ctx):
    spans = pt.profiled_spans(ctx)
    parts = [pt.mean_ms(spans, n) for n in ("serve.collate", "serve.upload")]
    return None if None in parts else sum(parts)
