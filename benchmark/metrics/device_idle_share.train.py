"""Device idle share of the profiled training steps, in %: 1 - (union of device
activity intervals) / the profiled window."""
from benchmark.metrics import _common as common


def read(ctx):
    tr = common.trace(ctx)
    if tr is None or tr["window_s"] <= 0 or tr["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
