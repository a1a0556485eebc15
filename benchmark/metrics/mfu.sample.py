"""The whole step's share of the chip's peak, in %: the model FLOPs of the
profiled best-of-N passes over the profiled window times the serving
dtype's peak (peaks.py). Each pass counts once, at the recycle counts it
drew (the `pocket` and `dock` ids of the program's sample.pass span), over
the requests of its batch (the profiled batch of the span's `batch` id) at
their real sizes (flops.request_flops with the configuration's
coefficients)."""
from benchmark import program_trace as pt
from benchmark.flops import pocket_size, request_flops
from benchmark.metrics import _common as common
from benchmark.peaks import PEAK_FLOPS


def read(ctx):
    tr = common.trace(ctx)
    passes = [s for s in pt.profiled_spans(ctx) or ()
              if s.name == "sample.pass"]
    batches = {b["bi"]: b for b in common.profiled_batches(ctx)}
    if tr is None or tr["window_s"] <= 0 or not passes or not batches:
        return None
    cfg = ctx.config.ref_cfg
    coef = ctx.config.data.get("flops")
    shapes = {(c.shapes.max_ligand, c.shapes.max_pocket,
               c.shapes.max_protein): c.shapes
              for c in ctx.config.ref_bucket_cfgs()}
    total = 0
    for s in passes:
        b = batches.get(s.ids.get("batch"))
        if b is None:
            return None
        sh = shapes[tuple(b["bucket"])]
        for n_lig, n_pkt, n_prot in b["sizes"]:
            total += request_flops(cfg, coef, n_lig, pocket_size(n_pkt, sh),
                                   n_prot, s.ids["pocket"], s.ids["dock"])
    return 100.0 * total / (tr["window_s"] * PEAK_FLOPS[ctx.config.serve_dtype])
