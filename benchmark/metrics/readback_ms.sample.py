"""Host milliseconds per best-of-N pass that the host waits for the copies
of a pass's pocket logits and default center (the program's
sample.readback spans, fabind_tpu_torch/sample.py) per sample.pass span,
over the profiled passes."""
from benchmark import program_trace as pt


def read(ctx):
    return pt.ms_per(pt.profiled_spans(ctx), ("sample.readback",),
                     "sample.pass")
