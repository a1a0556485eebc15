"""The training step's matrix products' share of their roofline, in %
(float32 with TF32 off: 4 bytes, 67 TFLOP/s): the sum over the
profiled aten::mm / addmm / bmm / baddbmm calls of max(2MNK / peak FLOP/s,
(MK + KN + MN) x element bytes / HBM bandwidth) at their recorded shapes,
over the device time of their kernels (peaks.gemm_bound_ms)."""
from benchmark.metrics import _common as common
from benchmark.peaks import gemm_bound_ms
from benchmark.trace import MATMUL_OPS, op_calls


def mnk(name, shapes):
    """(batch, M, N, K) of one product from its input shapes."""
    if name in ("aten::addmm", "aten::baddbmm"):
        shapes = shapes[1:]
    a, b = shapes[0], shapes[1]
    if len(a) == 3:
        return a[0], a[1], b[2], a[2]
    return 1, a[0], b[1], a[1]


def read(ctx):
    tr = common.trace(ctx)
    if tr is None:
        return None
    bound = t_us = 0.0
    for name in MATMUL_OPS:
        for shapes, us in op_calls(tr, name):
            if us <= 0:
                continue
            bound += gemm_bound_ms(*mnk(name, shapes), "fp32")
            t_us += us
    return common.share(bound, t_us * 1e-3)
