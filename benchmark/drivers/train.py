"""Training: the port's `Trainer.train_step` fed by its host `Loader`
(worker threads and prefetch as the mix gives them) over an in-memory
source of the mix's seeded complexes with their true poses.

Set-up builds the one trainer, takes its first steps through the same
loader and call as the window (at least `setup_steps` and `check_steps`,
and until every bucket has run once or `max_setup_steps` are taken, so
the window starts at the same step for every seed), and records what the
check compares: the first
steps' losses, the first gradient as the optimizer took it (from AdamW's
first moment) and the parameters' change after `check_steps`. The window
goes on stepping the same trainer. The traced run profiles steps 1 ..
`trace_steps` of the window.

What a step draws (its recycle count, dropout masks and stage coin) comes
from the mix's `step_seed` where the mix fixes one: the draws are a
function of (that seed, step) alone, so every --seed runs the same
recycle counts step by step, on its own complexes, weights and shuffle,
and a seed does not change the amount of work.
"""
from __future__ import annotations

import dataclasses
import gc
import time
from typing import Dict, List

import numpy as np

from benchmark import gen
from benchmark.harness import Context, mark, port_config
from benchmark.reference.train import BETA1


class PoolSource:
    """The Loader's source: the pool's raw complexes by index."""

    def __init__(self, pool: List[Dict]):
        self.pool = pool

    def __len__(self):
        return len(self.pool)

    def get(self, idx):
        return self.pool[idx]


def train_seed(ctx: Context) -> int:
    """The run's loader seed (its shuffle and each sample's draws):
    --seed cut to what numpy's RandomState takes."""
    return ctx.seed % (2 ** 31)


def step_seed(ctx: Context) -> int:
    """The seed of every step's draws (cfg.train.seed): the mix's
    `step_seed` where it fixes one, else the run's."""
    return int(ctx.mix.get("step_seed", train_seed(ctx)))


def _stream(loader):
    epoch = 0
    while True:
        yield from loader.epoch(epoch, with_meta=True)
        epoch += 1


def _norms(trainer, start) -> Dict[str, Dict[str, float]]:
    state = trainer.optimizer.opt.state
    out = {}
    for k, p in trainer.model.named_parameters():
        out[k] = float(state[p]["exp_avg"].norm()) / (1 - BETA1) \
            if p in state else 0.0
    return out


def run(ctx: Context) -> Dict:
    import torch

    from benchmark import trace as tr
    from benchmark.weights import seeded_state_dict
    from fabind_tpu_torch.data.dataset import Loader
    from fabind_tpu_torch.data.types import FABindBatch
    from fabind_tpu_torch.train.trainer import Trainer

    mix, rec, spans = ctx.mix, ctx.record, ctx.spans
    mark(ctx, "imports")
    seed = train_seed(ctx)
    cfg, buckets = port_config(ctx.config, seed=step_seed(ctx))
    pool = gen.make_pool(mix, ctx.seed)
    mark(ctx, "traffic")
    sd = seeded_state_dict(ctx.config.ref_cfg, ctx.seed, ctx.device,
                           ctx.config.coord_scale)
    start = {k: v.detach().clone() for k, v in sd.items()}
    mark(ctx, "weights")
    trainer = Trainer(cfg, ctx.device, state_dict=sd)
    del sd
    mark(ctx, "trainer")
    if ctx.engine_hook is not None:
        ctx.engine_hook(trainer)
    loader = Loader(PoolSource(pool), range(len(pool)), cfg, group="train",
                    batch_size=ctx.config.batch_size, seed=seed,
                    buckets=buckets, workers=mix["workers"],
                    prefetch_depth=mix["prefetch"])
    stream = _stream(loader)

    def step(log: List):
        with spans.span("loader_wait"):
            arrays, meta = next(stream)
        batch = FABindBatch.from_numpy(arrays, ctx.device)
        with spans.span("step"):
            m = trainer.train_step(batch, meta["cfg"])
        sh = meta["cfg"].shapes
        log.append({"t": time.perf_counter(), "step": trainer.step - 1,
                    "n": int(meta["n_valid"]), "metrics": m,
                    "bucket": (sh.max_ligand, sh.max_pocket, sh.max_protein),
                    "sizes": [(int(a), int(b), int(c)) for a, b, c in zip(
                        arrays["lig_mask"].sum(1), arrays["pocket_mask"].sum(1),
                        arrays["prot_mask"].sum(1))][:meta["n_valid"]]})

    first: List = []
    seen = set()
    n_check = mix["check_steps"]
    n_setup = max(n_check, mix.get("setup_steps", 0))
    while len(first) < n_setup or (len(seen) < len(buckets) and
                                   len(first) < mix["max_setup_steps"]):
        step(first)
        seen.add(first[-1]["bucket"])
        if len(first) == 1:
            rec["grad1"] = _norms(trainer, start)
        if len(first) == n_check:
            rec["change"] = {
                k: float((p.detach() - start[k].to(p.device)).norm())
                for k, p in trainer.model.named_parameters()}
    mark(ctx, f"{len(first)} set-up steps")
    rec["losses"] = [s["metrics"]["loss"] for s in first[:n_check]]
    rec["skipped"] = sum(s["metrics"]["skipped_nan"] for s in first[:n_check])
    if ctx.device != "cpu":
        torch.cuda.synchronize(ctx.device)
    rec["setup_s"] = time.perf_counter() - ctx.t_start
    rec["setup_steps"] = len(first)
    spans.intervals.clear()

    log: List = []
    profiles = []
    n_trace = mix.get("trace_steps", 2)
    t0 = time.perf_counter()
    k = 0
    while time.perf_counter() - t0 < ctx.seconds:
        if ctx.trace and k == 1:
            tp0 = time.perf_counter()
            with tr.profiled(spans) as box:
                for _ in range(n_trace):
                    step(log)
                    k += 1
            profiles.append(box[0])
            rec["profiled"] = [(tp0, time.perf_counter())]
            continue
        step(log)
        k += 1
    t_end = log[-1]["t"] if log else time.perf_counter()
    rec["steps"] = log
    rec["window"] = (t0, t_end)
    rec["attempted"] = sum(s["n"] for s in log)
    rec["failed"] = int(sum(s["n"] * s["metrics"]["skipped_nan"]
                            for s in log))
    rec["train_samples_per_s"] = (sum(s["n"] for s in log
                                      if not s["metrics"]["skipped_nan"])
                                  / (t_end - t0)) if log else 0.0
    t_reduce = time.perf_counter()
    rec["trace"] = tr.merge([tr.reduce(p) for p in profiles])
    rec["reduce_s"] = time.perf_counter() - t_reduce
    if ctx.device != "cpu":
        torch.cuda.synchronize(ctx.device)
        rec["memory_peak_bytes"] = torch.cuda.max_memory_allocated(ctx.device)
    rec["pool"] = pool
    del trainer, loader, stream, profiles
    gc.collect()
    if ctx.device != "cpu":
        torch.cuda.empty_cache()
    return {"train_samples_per_s": rec["train_samples_per_s"]}


def prepare_control(ctx: Context) -> None:
    ctx.record["pool"] = gen.make_pool(ctx.mix, ctx.seed)


def _leaf_gap(got: Dict[str, float], want: Dict[str, float],
              leaves: List[str]) -> float:
    """The worst leaf's gap between two norms, against the reference's norm
    of that leaf or of the median leaf, whichever is larger."""
    med = float(np.median([want[k] for k in leaves]))
    return max(abs(got.get(k, 0.0) - want[k]) / max(want[k], med)
               for k in leaves)


def check(ctx: Context, control: bool = False) -> Dict[str, float]:
    """The first `check_steps` steps against the reference's: each step's
    loss (relative gap, the worst step), the first gradient as the
    optimizer took it and the parameters' change after the steps (per
    leaf, the worst). Leaves whose reference gradient is under a
    thousandth of the median leaf's move by round-off alone under Adam and
    are left out of the change. With `control`, the reference with TF32
    products stands in for the program."""
    import torch

    from benchmark.reference import dock as ref_dock
    from benchmark.reference import train as ref
    from benchmark.weights import seeded_state_dict

    mix, rec, cfg = ctx.mix, ctx.record, ctx.config
    seed = train_seed(ctx)
    rcfg = ctx.config.ref_cfg.replace(train=dataclasses.replace(
        ctx.config.ref_cfg.train, seed=step_seed(ctx)))
    bucket_cfgs = [c.replace(train=rcfg.train) for c in cfg.ref_bucket_cfgs()]
    batches = ref.loader_batches(rec["pool"], rcfg, bucket_cfgs,
                                 cfg.batch_size, seed, mix["check_steps"])

    def steps(tf32: bool):
        ref_dock.full_precision()
        torch.backends.cuda.matmul.allow_tf32 = tf32
        try:
            sd = seeded_state_dict(cfg.ref_cfg, ctx.seed, ctx.device,
                                   cfg.coord_scale)
            return ref.train_steps(rcfg, sd, batches, ctx.device)
        finally:
            ref_dock.full_precision()

    want = steps(False)
    got = steps(True) if control else {
        "losses": rec["losses"], "grad1": rec["grad1"],
        "change": rec["change"]}
    g = want["grad1"]
    med = float(np.median(list(g.values())))
    moved = [k for k in g if g[k] >= 1e-3 * med]
    rec["check_rows"] = {"losses": [got["losses"], want["losses"]],
                         "left_out": sorted(set(g) - set(moved))}
    loss_gap = max(abs(a - b) / abs(b)
                   for a, b in zip(got["losses"], want["losses"]))
    return {"loss_gap_max": float(loss_gap),
            "grad_leaf_gap_max": _leaf_gap(got["grad1"], g, list(g)),
            "change_leaf_gap_max": _leaf_gap(got["change"], want["change"],
                                             moved)}
