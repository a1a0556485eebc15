"""Host milliseconds per training step of the batch's upload
(`FABindBatch.from_numpy`: the program's data.upload span), over the
profiled steps."""
from benchmark import program_trace as pt


def read(ctx):
    return pt.ms_per(pt.profiled_spans(ctx), ("data.upload",), "train.step")
