"""Best-of-N sampling and training-step times of one checkout of the port at
equal work, to compare two checkouts on one card in one call.

    python tools/torch_sampling_ab.py [--root DIR] [--label NAME]

It imports `fabind_tpu_torch` and `chip_smoke.py` from the checkout at
--root (default: the one holding this file), so two checkouts run the same
workload with their own code: chip_smoke's seeded requests, buckets,
widths and timers. Every stochastic forward runs all n_iter recycles
(random_n_iter=False), so the work does not depend on the checkout's random
stream:

  - best-of-8 `dock_best_of` (fabind_plus_sampling, bf16, stochastic pocket
    mode) over chip_smoke's 16 best-of-N requests: complexes/s over three
    calls after a warm one; then chip_smoke's pocket/dock half split of one
    large-bucket batch (its own printed line);
  - train steps on the first large-bucket training batch of the requests:
    base `fabind` fp32 and bf16 and FABind+ bf16, dropout on, stage coin
    off (stage_prob 0), the same step seeds each time: median ms of five
    after two warm ones.

With --recycle-forms it times instead, in this checkout only, the two forms
a traced program could run the rounds of a tensor recycle count in: the
while loop the port keeps (models/att_model.py) and all n_iter - 1 rounds
each kept by torch.where (defined here; the port does not hold it), beside
the Python loop over the int count: chip_smoke's live sampling halves of
its 8 small-bucket requests at the drawn counts (phase 12's timer).

Prints one line per measurement with the card's name and power limit, then
one JSON line of the medians. Needs CUDA.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time
from pathlib import Path

STEPS = 5
WARM_STEPS = 2
BEST_OF_CALLS = 3


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]),
                    help="checkout whose fabind_tpu_torch and chip_smoke.py "
                         "run")
    ap.add_argument("--label", default=None, help="name printed with each "
                    "line (default: --root)")
    ap.add_argument("--recycle-forms", action="store_true",
                    help="time the recycle-loop forms instead (module "
                         "docstring)")
    args = ap.parse_args(argv)
    root = Path(args.root).resolve()
    label = args.label or str(root)
    os.chdir(root)
    sys.path.insert(0, str(root))

    import torch
    if not torch.cuda.is_available():
        print("torch_sampling_ab: CUDA is not available", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from fabind_tpu_torch.config import preset
    from fabind_tpu_torch.data.buckets import resolve_buckets
    from fabind_tpu_torch.serve import DockingEngine
    from fabind_tpu_torch.train.trainer import Trainer

    card_line, _ = cs.card()
    if args.recycle_forms:
        return recycle_forms(cs, card_line)
    shapes = cs.SMOKE_SHAPES
    buckets = resolve_buckets(cs.BUCKETS, preset("fabind", **shapes))
    large = cs.bucket_label(buckets[-1])
    raws = cs.make_requests(cs.N_REQUESTS, cs.REQUEST_SEED)
    out = {"label": label, "card": card_line}

    # best-of-8 at the full recycle count
    engine = DockingEngine(preset("fabind_plus_sampling", random_n_iter=False,
                                  **shapes),
                           buckets=buckets, batch_size=cs.BATCH, seed=0)
    engine.warmup()
    rs = raws[:cs.N_BEST_OF]
    engine.dock_best_of(rs, sample_size=cs.SAMPLES, seed=cs.SAMPLE_SEED)
    secs = []
    for _ in range(BEST_OF_CALLS):
        t0 = time.perf_counter()
        engine.dock_best_of(rs, sample_size=cs.SAMPLES, seed=cs.SAMPLE_SEED)
        secs.append(time.perf_counter() - t0)
    rate = len(rs) / statistics.median(secs)
    out["best_of_8_complexes_per_s"] = rate
    print(f"[{label}] best-of-{cs.SAMPLES} dock_best_of {len(rs)} requests, "
          f"bf16, all recycles: {rate:.2f} complexes/s (s per call "
          f"{[round(x, 3) for x in secs]}) [{card_line}]")
    batch_raws = cs.route(engine, raws)[large][:cs.BATCH]
    (_, cfg_b, batch), = cs.first_batches(engine, {"large": batch_raws})
    print(f"[{label}] ", end="")
    cs.time_sampling_pass(engine, batch, cfg_b, card_line)
    del engine, batch
    torch.cuda.empty_cache()

    # train steps at the full recycle count, the same seeds every step
    data = cs.write_npz_dir(raws, Path("build/torch_sampling_ab_data"))
    for name, preset_name, kw in (("fabind fp32", "fabind", {}),
                                  ("fabind bf16", "fabind", {"bf16": True}),
                                  ("fabind_plus bf16", "fabind_plus",
                                   {"bf16": True})):
        cfg = preset(preset_name, random_n_iter=False, stage_prob=0.0, **kw,
                     **shapes)
        batch, cfg_b = cs.first_batch(data, cfg,
                                      resolve_buckets(cs.BUCKETS, cfg), large)
        tr = Trainer(cfg, "cuda")
        ms = []
        for _ in range(WARM_STEPS + STEPS):
            tr.step = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tr.train_step(batch, cfg_b)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        ms = ms[WARM_STEPS:]
        out[f"train_step_ms {name}"] = statistics.median(ms)
        print(f"[{label}] train step {name} bucket {large}, dropout "
              f"{cfg.model.dropout}, all recycles: median "
              f"{statistics.median(ms):.2f} ms of {[round(x, 1) for x in ms]} "
              f"[{card_line}]")
        del tr, batch
        torch.cuda.empty_cache()
    print(json.dumps(out))
    return 0


def recycle_forms(cs, card_line) -> int:
    """Live dock-half ms of the small bucket's sampling passes with the
    count as an int, as a tensor in the while loop, and as a tensor with
    every round kept by torch.where."""
    import torch
    from fabind_tpu_torch.config import preset
    from fabind_tpu_torch.data.buckets import resolve_buckets
    from fabind_tpu_torch.models.att_model import EfficientMCAttModel
    from fabind_tpu_torch.models.layers import recycle_round
    from fabind_tpu_torch.sample import live_halves
    from fabind_tpu_torch.serve import DockingEngine

    def where_rounds(self, x, count, h, gi, pair, ctx_k):
        for i in range(self.n_iter - 1):
            with recycle_round(i):
                x = torch.where(i < count - 1,
                                self._step(h, x, gi, pair, ctx_k)[1], x)
        return x

    shapes = cs.SMOKE_SHAPES
    cfg = preset("fabind_plus_sampling", **shapes)
    buckets = resolve_buckets(cs.BUCKETS, preset("fabind", **shapes))
    label = cs.bucket_label(buckets[0])
    live = DockingEngine(cfg, buckets=buckets, batch_size=cs.BATCH, seed=0)
    live.warmup()
    rs = cs.route(live, cs.make_requests(cs.N_REQUESTS,
                                         cs.REQUEST_SEED))[label]
    (_, cfg_b, batch, _), = list(live.batches(rs, [None] * len(rs)))
    out = {"card": card_line}
    out["int"] = cs.time_halves(live_halves(live.model, cfg_b), batch, label,
                                "live (int counts: the drawn rounds)",
                                card_line)
    out["while"] = cs.time_halves(cs.tensor_halves(live.model, cfg_b), batch,
                                  label, "live, tensor counts, while loop",
                                  card_line)
    kept = EfficientMCAttModel._while_rounds
    EfficientMCAttModel._while_rounds = where_rounds
    try:
        out["where"] = cs.time_halves(
            cs.tensor_halves(live.model, cfg_b), batch, label,
            "live, tensor counts, every round kept by torch.where",
            card_line)
    finally:
        EfficientMCAttModel._while_rounds = kept
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
