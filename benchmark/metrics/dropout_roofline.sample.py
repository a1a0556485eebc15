"""The dropout kernel's share of its roofline, in %: the sum over its
profiled launches of peaks.dropout_bound_ms at each launch's recorded shape
(its input x) and dtype, over the kernel's summed device time. The dtype is
the kernel's template argument in its name (`dropout_kernel<true>` runs on
bfloat16, `<false>` on float32); a profile that holds both, or a launch
whose shape was not recorded, reads nothing."""
import math

from benchmark.metrics import _common as common
from benchmark.peaks import dropout_bound_ms
from benchmark.trace import (DROPOUT_KERNELS, DROPOUT_OP, base_name,
                             kernel_us, op_calls)


def read(ctx):
    tr = common.trace(ctx)
    if tr is None:
        return None
    calls = op_calls(tr, DROPOUT_OP)
    bf16 = {"<true>" in n for n in tr["device_us_by_kernel"]
            if base_name(n) in DROPOUT_KERNELS}
    launches = sum(tr["kernel_counts"].get(k, 0) for k in DROPOUT_KERNELS)
    if not calls or len(bf16) != 1 or launches != len(calls):
        return None
    eb = 2 if bf16.pop() else 4
    bound = sum(dropout_bound_ms(math.prod(shapes[0]), eb)
                for shapes, _ in calls)
    return common.share(bound, kernel_us(tr, DROPOUT_KERNELS) * 1e-3)
