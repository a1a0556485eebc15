"""Host milliseconds per best-of-N pass of the program's host clustering:
the program's sample.cluster spans (DBSCAN over the residues a pass's
pocket stage predicts positive, and the pass's cluster picks,
fabind_tpu_torch/sample.py) per sample.pass span, over the profiled
passes."""
from benchmark import program_trace as pt


def read(ctx):
    return pt.ms_per(pt.profiled_spans(ctx), ("sample.cluster",),
                     "sample.pass")
