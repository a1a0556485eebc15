"""The training step's share of the chip's float32 peak, in %: 3 x the
forward's model FLOPs (flops.py) of the profiled steps' real samples, at
their sizes (ligand atoms, the batch's pocket crop, residues) and the
recycle counts each step drew, over the profiled window times 67 TFLOP/s
(TF32 off)."""
from benchmark.flops import pocket_size, request_flops
from benchmark.metrics import _common as common
from benchmark.peaks import PEAK_FP32_S


def counts(ctx, step):
    """(pocket, docking) recycle counts of training step `step`."""
    from benchmark.drivers.train import train_seed
    from benchmark.reference.models.layers import recycle_count
    from benchmark.reference.ops.dropout import site_id
    from benchmark.reference.train import step_generator

    m = ctx.config.ref_cfg.model
    if not m.random_n_iter:
        return m.pocket_pred_n_iter, m.n_iter
    s = step_generator(train_seed(ctx), step, "cpu").initial_seed()
    return (recycle_count(s, site_id("pocket_pred_model"),
                          m.pocket_pred_n_iter),
            recycle_count(s, site_id("complex_model"), m.n_iter))


def read(ctx):
    from benchmark.harness import in_profile
    tr = common.trace(ctx)
    steps = [s for s in ctx.record.get("steps", [])
             if in_profile(ctx, s["t"])]
    if tr is None or not steps or tr["window_s"] <= 0:
        return None
    cfg = ctx.config.ref_cfg
    coef = ctx.config.data.get("flops")
    total = 0
    for s in steps:
        pc, dc = counts(ctx, s["step"])
        shapes = [c for c in ctx.config.ref_bucket_cfgs()
                  if (c.shapes.max_ligand, c.shapes.max_pocket,
                      c.shapes.max_protein) == tuple(s["bucket"])][0].shapes
        for n_lig, n_pkt, n_prot in s["sizes"]:
            total += 3 * request_flops(cfg, coef, n_lig,
                                       pocket_size(n_pkt, shapes), n_prot,
                                       pc, dc)
    return 100.0 * total / (tr["window_s"] * PEAK_FP32_S)
