"""Host kernel launches per model batch: the runtime launch calls in the
profiled calls' trace over their batches."""
from benchmark.metrics import _common as common


def read(ctx):
    tr = common.trace(ctx)
    n = len(common.profiled_batches(ctx))
    if tr is None or not n or not tr["launches"]:
        return None
    return tr["launches"] / n
