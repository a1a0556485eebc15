"""The whole step's share of the chip's peak, in %: the model FLOPs of the
profiled calls' requests (flops.py, at their real sizes and the recycle
counts run) over the profiled window times the serving dtype's peak
(peaks.py)."""
from benchmark.metrics import _common as common
from benchmark.flops import pocket_size, request_flops
from benchmark.peaks import PEAK_FLOPS


def read(ctx):
    tr = common.trace(ctx)
    bs = common.profiled_batches(ctx)
    if tr is None or not bs or tr["window_s"] <= 0:
        return None
    cfg = ctx.config.ref_cfg
    coef = ctx.config.data.get("flops")
    m = cfg.model
    total = 0
    for b in bs:
        shapes = [c for c in ctx.config.ref_bucket_cfgs()
                  if (c.shapes.max_ligand, c.shapes.max_pocket,
                      c.shapes.max_protein) == tuple(b["bucket"])][0].shapes
        for n_lig, n_pkt, n_prot in b["sizes"]:
            total += request_flops(cfg, coef, n_lig,
                                   pocket_size(n_pkt, shapes), n_prot,
                                   m.pocket_pred_n_iter, m.n_iter)
    return 100.0 * total / (tr["window_s"] * PEAK_FLOPS[ctx.config.serve_dtype])
