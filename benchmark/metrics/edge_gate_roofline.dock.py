"""The edge-gate kernel's share of its roofline, in %: the sum over its
launches of gate_bound_ms at each launch's recorded shapes (peaks.py) over
the kernel's summed device time."""
from benchmark.metrics import _common as common
from benchmark.peaks import gate_bound_ms
from benchmark.trace import GATE_KERNEL, GATE_OP, kernel_us, op_calls


def read(ctx):
    tr = common.trace(ctx)
    if tr is None:
        return None
    calls = op_calls(tr, GATE_OP)
    eb = common.elem_bytes(ctx)
    bound = 0.0
    for shapes, _ in calls:
        (B, Na, H), (_, Nb, _) = shapes[0], shapes[1]
        bound += gate_bound_ms(B, Na, Nb, H, eb)
    if tr["kernel_counts"].get(GATE_KERNEL, 0) != len(calls):
        return None      # a launch whose shapes were not recorded
    return common.share(bound, kernel_us(tr, (GATE_KERNEL,)) * 1e-3)
