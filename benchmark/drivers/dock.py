"""Closed-loop batch docking: one caller calls the engine's `dock_raw` on
the mix's `requests_per_call` requests at a time, call after call, for the
window.

The mix's pool of distinct requests is cycled call by call; it holds more
proteins than the engine's protein-row cache, so every row misses it. The
traced run profiles the first `trace_batches` model batches of call 1 of
the window (call 0 runs unprofiled first): from the call's start to the
end of those batches.
"""
from __future__ import annotations

import contextlib
import gc
import time
from typing import Dict, List

import numpy as np

from benchmark import compare as cmp
from benchmark import gen
from benchmark.harness import (Context, build_engine, instrument, mark,
                               warm_requests)


def _entry(ctx: Context, engine):
    if ctx.mix["entry"] != "dock_raw":
        raise ValueError(f"unknown entry {ctx.mix['entry']!r}")
    return engine.dock_raw


# what dock_raw's check compares. The widest pose gap is not compared (it
# swings by seed up to over a third of the float8 control's smallest
# reading, PERF.md); the count of poses off by more than the mix's
# `check_gap_A` catches a fault in a minority of the requests, such as a
# half of every batch, that leaves the medians on sound poses.
DOCK_NUMBERS = ("pose_median_A", "shape_median_A", "poses_over_gap",
                "pocket_prob_err_mean", "center_err_max_A", "crop_mismatches")


def calls_of(mix: Dict, pool: List[Dict]) -> List[List[Dict]]:
    n = mix["requests_per_call"]
    return [pool[i:i + n] for i in range(0, len(pool) - n + 1, n)]


def run(ctx: Context) -> Dict:
    """Set-up, the window and its records; returns the end-to-end metrics
    and what the check reads (the record's "served")."""
    import torch

    from benchmark import trace as tr
    from benchmark.weights import seeded_state_dict

    mix, rec = ctx.mix, ctx.record
    mark(ctx, "imports")
    pool = gen.make_pool(mix, ctx.seed)
    calls = calls_of(mix, pool)
    mark(ctx, "traffic")
    sd = seeded_state_dict(ctx.config.ref_cfg, ctx.seed, ctx.device,
                           ctx.config.coord_scale)
    mark(ctx, "weights")
    engine = build_engine(ctx, sd)
    del sd
    mark(ctx, "engine")
    if ctx.engine_hook is not None:
        ctx.engine_hook(engine)
    entry = _entry(ctx, engine)
    entry(warm_requests(ctx, pool))
    if ctx.device != "cpu":
        torch.cuda.synchronize(ctx.device)
    mark(ctx, "warm call")
    instrument(ctx, engine)
    rec["setup_s"] = time.perf_counter() - ctx.t_start

    served: Dict[int, Dict] = {}      # call slot -> its last poses
    trace = _BatchTrace(ctx, engine)
    log = []
    t0 = time.perf_counter()
    k = 0
    while time.perf_counter() - t0 < ctx.seconds:
        slot = k % len(calls)
        ts = time.perf_counter()
        trace.arm(ctx.trace and k == 1)
        with record_pockets(engine) as picks:
            poses = entry(calls[slot])
        trace.stop()
        te = time.perf_counter()
        if trace.ended is not None and not rec.get("profiled"):
            rec["profiled"] = [(ts, trace.ended)]
        ok = sum(p.error is None for p in poses)
        log.append({"k": k, "slot": slot, "t0": ts, "t1": te, "ok": ok,
                    "n": len(poses)})
        served[slot] = {"poses": poses, "k": k, "picks": picks}
        k += 1
    t_end = log[-1]["t1"] if log else time.perf_counter()
    rec["calls"] = log
    rec["window"] = (t0, t_end)
    rec["attempted"] = sum(c["n"] for c in log)
    rec["failed"] = sum(c["n"] - c["ok"] for c in log)
    rec["complexes_per_s"] = (sum(c["ok"] for c in log) / (t_end - t0)
                              if log else 0.0)
    t_reduce = time.perf_counter()
    rec["trace"] = tr.merge([tr.reduce(p) for p in trace.profiles])
    rec["reduce_s"] = time.perf_counter() - t_reduce
    if ctx.device != "cpu":
        torch.cuda.synchronize(ctx.device)
        rec["memory_peak_bytes"] = torch.cuda.max_memory_allocated(ctx.device)
    rec["served"] = served
    rec["pool_calls"] = calls
    del engine, entry, trace
    gc.collect()
    if ctx.device != "cpu":
        torch.cuda.empty_cache()
    return {"complexes_per_s": rec["complexes_per_s"]}


class _BatchTrace:
    """Profiles the first `trace_batches` model batches of an armed call:
    wraps the engine's run_batch, starts the profiler at the first and
    stops it after the last (or when the call ends)."""

    def __init__(self, ctx: Context, engine):
        from benchmark import trace as tr
        self.tr, self.spans = tr, ctx.spans
        self.limit = ctx.mix.get("trace_batches", 1)
        self.profiles: List = []
        self.ended = None
        self._armed, self._cm, self._n = False, None, 0
        inner = engine.run_batch

        def traced(*args, **kw):
            if self._armed and self._cm is None and self._n == 0:
                self._cm = self.tr.profiled(self.spans)
                self._box = self._cm.__enter__()
            try:
                return inner(*args, **kw)
            finally:
                if self._cm is not None:
                    self._n += 1
                    if self._n >= self.limit:
                        self.stop()
        engine.run_batch = traced

    def arm(self, on: bool) -> None:
        self._armed, self._n = on, 0

    def stop(self) -> None:
        if self._cm is not None:
            self._cm.__exit__(None, None, None)
            self.profiles.append(self._box[0])
            self.ended = time.perf_counter()
            self._cm = None
        self._armed = False


@contextlib.contextmanager
def record_pockets(engine):
    """The pocket stage's logits and centers (`pocket_center_rounded` of
    the program's model module) and the crops (the engine model's
    `_predicted_crop`) of the block: {"centers": [...], "crops": [...]}.
    The check follows the program's pocket decisions through these two
    names of the program (PERF.md)."""
    import fabind_tpu_torch.models.fabind as program_model

    from benchmark.reference.dock import recording_centers, recording_crops
    with recording_centers(program_model) as centers, \
            recording_crops(engine.model) as crops:
        yield {"centers": centers, "crops": crops}


def prepare_control(ctx: Context) -> None:
    """The records the control's check reads: the pool's calls, each as
    if served."""
    calls = calls_of(ctx.mix, gen.make_pool(ctx.mix, ctx.seed))
    ctx.record["pool_calls"] = calls
    ctx.record["served"] = {s: None for s in range(len(calls))}


def check(ctx: Context, control: bool = False) -> Dict[str, float]:
    """The numbers that decide `correct`: the served poses of a sample of
    the window's requests, the largest among them (`check_requests` of
    the mix), against the reference's (float32, TF32 off), by
    `check_forced`. With `control`, the reference computed with float8
    storage stands in for the served poses."""
    mix, rec = ctx.mix, ctx.record
    model, bucket_cfgs = reference_model(ctx)
    rng = np.random.default_rng([ctx.seed, 2])
    calls, served = rec["pool_calls"], rec["served"]
    items = [(s, i) for s in sorted(served) for i in range(len(calls[s]))]
    chosen = [items[j] for j in cmp.sample(
        [cmp.size_of(calls[s][i]) for s, i in items],
        mix["check_requests"], rng)]
    raws = [calls[s][i] for s, i in chosen]
    got = None if control else [
        _coords(served[s]["poses"][i]) for s, i in chosen]
    logs = [] if control else [served[s]["picks"] for s in sorted(served)]
    out = check_forced(ctx, model, bucket_cfgs, raws, got, logs)
    return {k: out[k] for k in DOCK_NUMBERS}


def check_forced(ctx: Context, model, bucket_cfgs, raws, got, logs
                 ) -> Dict[str, float]:
    """dock_raw following the program's pocket decisions: the reference docks
    each request at the center and with the pocket crop the program docked
    it with (found by the request's residue coordinates among the recorded
    batches), and the served poses are held to those poses. Apart from
    that, the pocket stage (the program's residue probabilities against
    the reference's), the center (the reference's function on the
    program's logits and coordinates, in the program's dtype, against the
    program's center) and the crop (the reference's around the program's
    center, in the program's dtype, against the program's: the requests
    whose crops differ). With `got` None, the reference with float8
    storage is the program: its own centers, crops, logits and poses."""
    import torch

    from benchmark.reference import dock as ref

    cfg = ctx.config
    low = None
    if got is None:
        with ref.fp8_storage(model):
            low = ref.dock_raw_forced(model, raws, bucket_cfgs,
                                      cfg.batch_size, ctx.device)
        got = [x["coords"] for x in low]
        program = low
    else:
        program = _program_centers(ctx, raws, bucket_cfgs, logs)
    want = ref.dock_raw_forced(
        model, raws, bucket_cfgs, cfg.batch_size, ctx.device,
        {i: p["center"] for i, p in enumerate(program)},
        {i: p["crop"] for i, p in enumerate(program)})
    rows = [cmp.distances(g, w["coords"]) for g, w in zip(got, want)]
    prob_err, center_err, crop_diff = [], [], 0
    m = cfg.ref_cfg.model
    dtype = torch.bfloat16 if low is None and cfg.serve_dtype == "bf16" \
        else torch.float32
    for p, w in zip(program, want):
        sig = lambda x: 1.0 / (1.0 + np.exp(-np.asarray(x, np.float64)))
        prob_err.append(float(np.abs(sig(p["logits"])
                                     - sig(w["logits"])).mean()))
        again = ref.rounded_center(p["logits"], p["xyz"], m, dtype)
        center_err.append(float(np.linalg.norm(again - p["center"])))
        crop = ref.crop_of(p["center"], p["xyz"], model,
                           bucket_cfgs[-1].shapes.max_pocket, dtype)
        crop_diff += crop[:len(p["crop"])] != p["crop"]
    ctx.record["check_rows"] = rows
    out = cmp.summary(rows)
    out["poses_over_gap"] = float(sum(r["pose"] > ctx.mix["check_gap_A"]
                                      for r in rows))
    out.update(pocket_prob_err_mean=float(np.mean(prob_err)),
               center_err_max_A=max(center_err),
               crop_mismatches=float(crop_diff))
    return out


def _program_centers(ctx: Context, raws, bucket_cfgs, logs) -> List[Dict]:
    """Per request, the program's pocket logits, residue coordinates,
    center and crop, from the recorded batches (`record_pockets`): the row
    whose first residues sit where the request's do, as the program holds
    them (rounded to its serving dtype)."""
    import torch

    from benchmark.reference.batching import build_sample

    def key(xyz):
        return np.asarray(xyz[:3], np.float32).tobytes()

    found: Dict[bytes, Dict] = {}
    crops: Dict[bytes, List[int]] = {}
    for log in logs:
        for logits, xyz, mask, center in log["centers"]:
            logits, xyz = logits.float().cpu().numpy(), xyz.float().cpu()
            center, mask = center.float().cpu().numpy(), mask.cpu().numpy()
            for b in range(len(center)):
                n = int(mask[b].sum())
                found[key(xyz[b].numpy())] = {
                    "logits": logits[b, :n], "xyz": xyz[b, :n].numpy(),
                    "center": center[b]}
        for xyz, idx, mask in log["crops"]:
            xyz, idx, mask = (xyz.float().cpu().numpy(), idx.cpu().numpy(),
                              mask.cpu().numpy())
            for b in range(len(idx)):
                crops[key(xyz[b])] = idx[b][mask[b]].tolist()
    out = []
    for raw in raws:
        xyz = torch.from_numpy(build_sample(raw, bucket_cfgs[-1],
                                            group="test")["prot_xyz"])
        if ctx.config.serve_dtype == "bf16":
            xyz = xyz.bfloat16()
        k = key(xyz.float().numpy())
        if k not in found or k not in crops:
            raise RuntimeError(
                "the program's pocket center or crop of a served request was "
                "not recorded: the check follows them through "
                "fabind_tpu_torch.models.fabind.pocket_center_rounded and "
                "the engine model's _predicted_crop, called from Python per "
                "batch (PERF.md)")
        out.append(dict(found[k], crop=crops[k]))
    return out


def _coords(pose):
    return pose.coords if pose is not None and pose.error is None else None


def reference_model(ctx: Context):
    """The reference model with the run's weights, and its buckets."""
    from benchmark.reference import dock as ref
    from benchmark.weights import seeded_state_dict

    cfg = ctx.config
    ref.full_precision()
    model = ref.build(cfg.ref_cfg, seeded_state_dict(
        cfg.ref_cfg, ctx.seed, ctx.device, cfg.coord_scale), ctx.device)
    return model, cfg.ref_bucket_cfgs()
