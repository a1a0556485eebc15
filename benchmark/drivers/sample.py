"""Closed-loop best-of-N sampling: one caller calls the engine's
`dock_best_of` on one call of the mix's pool at a time, call after call,
for the window.

Traffic. Each call holds exactly `per_bucket` requests for every bucket of
the configuration, bucket after bucket, so every call fills one full batch
in each bucket and its batches run in bucket order. A bucket's requests
take the same multiset of sizes for every seed: of a block of `size_block`
(residues, ligand atoms) pairs drawn as `gen.block_sizes` draws batch64's,
the pairs whose sizes fit the bucket and not the one below, `per_bucket` of
them evenly spread by cells. A request's contents (gen.make_request) are
redrawn from the next stream until the reference's routing sends it to its
bucket, since the pocket crop also routes. The passes run under the mix's
`sample_seed`, so every --seed runs the same pass seeds in the same
buckets: the same dropout masks, recycle counts and pick draws. The pool
is `pool_calls` calls of distinct proteins, more than the engine's
protein-row cache holds, so every row misses it; the warm call is the
pool's last call, and the window cycles the pool from its first.

The traced run profiles the first `trace_batches` batches of call 1 (one
per bucket). Call 0 is recorded for the check: each pass's pocket logits
and default center (`sample.stochastic_pocket`), the center it docked at,
its crop, its pose and its confidence (`sample.stochastic_dock` and the
engine model's `_predicted_crop`), wrapped from here for that call only.

The check (`reference/sample.py`, float32, TF32 off) docks every pass of
the recorded call at the program's center and crop and compares every pass,
not only the winners, since in bfloat16 two close confidences may swap the
winner: the poses (`compare.distances`), the confidences, the pocket
probabilities, the default centers (the reference's rounded center of the
program's logits, in the program's dtype), the crops (the reference's
around the program's center at the radius the reference's pocket stage
predicts), the picks (the reference's own DBSCAN and picks on the
program's probabilities, residues and default centers, against the centers
the program docked at) and the winners: the served pose has to be the pass
of highest confidence among the program's own passes, and that pass may
not fall below the reference's most confident pass by more than the
confidence limit.
"""
from __future__ import annotations

import contextlib
import gc
import sys
import time
import types
from typing import Dict, List, Optional

import numpy as np

from benchmark import compare as cmp
from benchmark import gen
from benchmark.drivers.dock import _BatchTrace, reference_model
from benchmark.harness import Context, build_engine, instrument, limits, mark

NUMBERS = ("pose_median_A", "shape_median_A", "shape_max_A",
           "confidence_err_max", "pocket_prob_err_mean", "center_err_max_A",
           "crop_mismatches", "pick_mismatches", "served_not_argmax",
           "winners_off")
# a recorded center equal to the reference's pick, and a served pose equal
# to a recorded pass: both are the same float32 numbers on both sides
SAME_A = 1e-4


def bucket_sizes(ctx: Context) -> List[np.ndarray]:
    """Per bucket, small to large, [per_bucket, 2] (residues, ligand
    atoms): the same for every seed (module docstring)."""
    mix = ctx.mix
    shapes = [c.shapes for c in ctx.config.ref_bucket_cfgs()]
    n = mix["size_block"]
    block = gen.block_sizes(dict(mix, requests_per_call=n, pool_requests=n))
    home = np.array([next(k for k, sh in enumerate(shapes)
                          if na <= sh.max_ligand and nr <= sh.max_protein)
                     for nr, na in block])
    n = mix["per_bucket"]
    out = []
    for k in range(len(shapes)):
        own = block[home == k]
        if len(own) < n:
            raise ValueError(f"bucket {k} gets {len(own)} of the block's "
                             f"sizes, fewer than {n}")
        order = np.argsort(own[:, 0] * own[:, 1], kind="stable")
        out.append(own[[order[int((i + 0.5) * len(own) / n)]
                        for i in range(n)]])
    return out


def make_calls(ctx: Context) -> List[List[Dict]]:
    """The pool's calls for the run's seed: call c lists bucket 0's
    requests, then bucket 1's, ..., each bucket's in an order drawn from
    the seed."""
    from benchmark.reference.batching import build_sample
    from benchmark.reference.buckets import route_sample

    mix, seed = ctx.mix, ctx.seed
    cfgs = ctx.config.ref_bucket_cfgs()
    per_bucket = bucket_sizes(ctx)
    calls, i = [], 0
    for c in range(mix["pool_calls"]):
        call = []
        for k, sizes in enumerate(per_bucket):
            order = np.random.default_rng([seed, 0, c, k]).permutation(
                len(sizes))
            for nr, na in sizes[order]:
                for t in range(mix["max_draws"]):
                    raw = gen.make_request(
                        np.random.default_rng([seed, 1, i, t]), int(nr),
                        int(na))
                    got = route_sample(build_sample(raw, cfgs[-1],
                                                    group="test"), cfgs)
                    if got is cfgs[k]:
                        break
                else:
                    raise RuntimeError(
                        f"request {i} ({nr} residues, {na} atoms) never "
                        f"routed to bucket {k} in {mix['max_draws']} draws")
                call.append(raw)
                i += 1
        calls.append(call)
    return calls


def run(ctx: Context) -> Dict:
    """Set-up, the window and its records; returns the end-to-end metrics
    and records what the check reads (the record's "recorded")."""
    import torch

    from benchmark import trace as tr
    from benchmark.weights import seeded_state_dict

    mix, rec = ctx.mix, ctx.record
    mark(ctx, "imports")
    calls = make_calls(ctx)
    mark(ctx, "traffic")
    sd = seeded_state_dict(ctx.config.ref_cfg, ctx.seed, ctx.device,
                           ctx.config.coord_scale)
    mark(ctx, "weights")
    engine = build_engine(ctx, sd)
    del sd
    mark(ctx, "engine")
    if ctx.engine_hook is not None:
        ctx.engine_hook(engine)
    size, seed = ctx.config.data["sample_size"], mix["sample_seed"]

    def entry(raws):
        return engine.dock_best_of(raws, sample_size=size, seed=seed)

    # one pass a batch runs every kernel and shape of the window: its
    # passes only repeat the shapes at other seeds
    engine.dock_best_of(calls[-1], sample_size=1, seed=seed)
    if ctx.device != "cpu":
        torch.cuda.synchronize(ctx.device)
    mark(ctx, "warm call")
    instrument(ctx, engine)
    # the profiler brackets the engine's best-of batches (dock.py's
    # _BatchTrace wraps a `run_batch` attribute)
    batches = types.SimpleNamespace(run_batch=engine._best_of_batch)
    trace = _BatchTrace(ctx, batches)
    engine._best_of_batch = batches.run_batch
    rec["setup_s"] = time.perf_counter() - ctx.t_start

    log = []
    t0 = time.perf_counter()
    k = 0
    while time.perf_counter() - t0 < ctx.seconds:
        slot = k % len(calls)
        ts = time.perf_counter()
        trace.arm(ctx.trace and k == 1)
        n_before = len(rec["batches"]) if "batches" in rec else 0
        with (recording(engine) if k == 0 else
              contextlib.nullcontext()) as passes:
            poses = entry(calls[slot])
        trace.stop()
        te = time.perf_counter()
        if trace.ended is not None and not rec.get("profiled"):
            rec["profiled"] = [(ts, trace.ended)]
        if k == 0:
            rec["recorded"] = {"passes": passes, "poses": poses}
            rec["check_raws"] = calls[slot]
        ok = sum(p.error is None for p in poses)
        log.append({"k": k, "slot": slot, "t0": ts, "t1": te, "ok": ok,
                    "n": len(poses), "batches": [
                        len(b["sizes"])
                        for b in rec.get("batches", [])[n_before:]]})
        k += 1
    t_end = log[-1]["t1"] if log else time.perf_counter()
    rec["calls"] = log
    rec["window"] = (t0, t_end)
    rec["attempted"] = sum(c["n"] for c in log)
    rec["failed"] = sum(c["n"] - c["ok"] for c in log)
    rec["complexes_per_s"] = (sum(c["ok"] for c in log) / (t_end - t0)
                              if log else 0.0)
    print(f"benchmark: {len(log)} calls, batches of each "
          f"{sorted({tuple(c['batches']) for c in log})}", file=sys.stderr)
    _print_centers()
    t_reduce = time.perf_counter()
    rec["trace"] = tr.merge([tr.reduce(p) for p in trace.profiles])
    rec["reduce_s"] = time.perf_counter() - t_reduce
    if ctx.device != "cpu":
        torch.cuda.synchronize(ctx.device)
        rec["memory_peak_bytes"] = torch.cuda.max_memory_allocated(ctx.device)
    del engine, entry, trace, batches
    gc.collect()
    if ctx.device != "cpu":
        torch.cuda.empty_cache()
    return {"complexes_per_s": rec["complexes_per_s"]}


def _print_centers() -> None:
    """The program's sample.centers counter (rows docked at a cluster's
    center or at the default one) since the process started, where the
    program counts it."""
    import importlib
    try:
        tracing = importlib.import_module("fabind_tpu_torch.utils.tracing")
    except ImportError:
        return
    centers = tracing.snapshot()["counters"].get("sample.centers")
    if centers is not None:
        print(f"benchmark: sample.centers {centers}", file=sys.stderr)


@contextlib.contextmanager
def recording(engine):
    """The passes of one dock_best_of call, per batch in call order:
    {"rows": the call's request index of each batch row, "n_real",
    "pockets": {pass seed: (logits, default center)}, "docks": {pass seed:
    (center, (crop idx, crop mask), coords, confidence)}, "xyz": (prot_xyz,
    prot_mask)}, as copies on the device (the stochastic mode's halves)."""
    import fabind_tpu_torch.sample as program

    from benchmark.reference.dock import recording_crops

    log: List[Dict] = []
    batches = engine.batches
    pocket_fn, dock_fn = program.stochastic_pocket, program.stochastic_dock

    def logged_batches(raws, results):
        for item in batches(raws, results):
            chunk, _, _, n_real = item
            log.append({"rows": [chunk[min(b, n_real - 1)][0]
                                 for b in range(engine.batch_size)],
                        "n_real": n_real, "pockets": {}, "docks": {}})
            yield item

    def pocket(model, batch, shapes, seed, *rest):
        out = pocket_fn(model, batch, shapes, seed, *rest)
        cur = log[-1]
        cur.setdefault("xyz", (batch.prot_xyz.clone(),
                               batch.prot_mask.clone()))
        cur["pockets"][seed] = (out[0][2].clone(), out[1].clone())
        return out

    def dock(model, batch, shapes, pocket_out, center, seed, *rest):
        n = len(crops)
        out = dock_fn(model, batch, shapes, pocket_out, center, seed, *rest)
        log[-1]["docks"][seed] = (center.clone(), crops[n][1:],
                                  out[0].clone(), out[1].clone())
        return out

    with recording_crops(engine.model) as crops:
        engine.batches = logged_batches
        program.stochastic_pocket, program.stochastic_dock = pocket, dock
        try:
            yield log
        finally:
            engine.batches = batches
            program.stochastic_pocket = pocket_fn
            program.stochastic_dock = dock_fn


def prepare_control(ctx: Context) -> None:
    """The records the control's check reads: the pool's first call."""
    ctx.record["check_raws"] = make_calls(ctx)[0]


def _host(t) -> np.ndarray:
    return t.float().cpu().numpy() if t.is_floating_point() \
        else t.cpu().numpy()


def _program_batches(ctx: Context, log: List[Dict]) -> Optional[List[Dict]]:
    """The recorded call in reference/sample.py's layout (best_of's
    batches), None when a pass the protocol runs was not recorded."""
    from benchmark.reference import sample as ref

    size, seed = ctx.config.data["sample_size"], ctx.mix["sample_seed"]
    out = []
    for bi, b in enumerate(log):
        passes = []
        for s in range(size):
            sd = ref.pass_seed(seed, bi, s)
            if sd not in b["pockets"] or sd not in b["docks"]:
                return None
            logits, default = b["pockets"][sd]
            center, crop, coords, conf = b["docks"][sd]
            passes.append({"seed": sd, "logits": _host(logits),
                           "default": _host(default),
                           "center": _host(center),
                           "crop": tuple(_host(t) for t in crop),
                           "coords": _host(coords), "conf": _host(conf)})
        out.append({"rows": b["rows"], "n_real": b["n_real"],
                    "xyz": _host(b["xyz"][0]), "mask": _host(b["xyz"][1]),
                    "passes": passes})
    return out


def check(ctx: Context, control: bool = False) -> Dict[str, float]:
    """The numbers that decide `correct` (module docstring), from the
    recorded call. With `control`, the reference computed with float8
    storage, its own decisions included, stands in for the program."""
    from benchmark.reference import dock as ref_dock
    from benchmark.reference import sample as ref

    import torch

    rec = ctx.record
    model, bucket_cfgs = reference_model(ctx)
    raws = rec["check_raws"]
    args = (raws, bucket_cfgs, ctx.config.batch_size,
            ctx.config.data["sample_size"], ctx.mix["sample_seed"],
            ctx.device)
    if control:
        with ref_dock.fp8_storage(model):
            program = ref.best_of(model, *args)
        req = ref.requests(program, raws, bucket_cfgs)
        served = {i: r["coords"][r["winner"]] for i, r in req.items()}
    else:
        program = _program_batches(ctx, rec["recorded"]["passes"])
        served = {i: p.coords for i, p in enumerate(rec["recorded"]["poses"])
                  if p.error is None}
    if program is None:
        return {k: float("inf") for k in NUMBERS}
    want = ref.best_of(model, *args, follow=program)
    lim = limits(ctx) or {}
    dtype = torch.bfloat16 if not control and \
        ctx.config.serve_dtype == "bf16" else torch.float32
    return compare(ctx, model, raws, bucket_cfgs, program, want, served,
                   lim.get("confidence_err_max", 0.0), dtype)


def compare(ctx: Context, model, raws, bucket_cfgs, program: List[Dict],
            want: List[Dict], served: Dict[int, np.ndarray],
            conf_limit: float, dtype) -> Dict[str, float]:
    """The check's numbers from the program's batches and the reference's
    docked at the program's decisions (both best_of's layout), and the
    served poses by request index. `dtype` is the program's: its pocket
    stage's logits, residue coordinates and radius are held in it, its
    centers in float32."""
    import torch

    from benchmark.reference import dock as ref_dock
    from benchmark.reference import sample as ref

    if [b["rows"] for b in program] != [b["rows"] for b in want] or \
            len(served) != len(raws):
        return {k: float("inf") for k in NUMBERS}
    m = bucket_cfgs[-1].model
    seed = ctx.mix["sample_seed"]
    prob_err, center_err, picks_off, crops_off = [], [], 0, 0
    for bi, (got, ref_b) in enumerate(zip(program, want)):
        rng = ref.batch_rng(seed, bi)
        n = got["n_real"]
        for p, w in zip(got["passes"], ref_b["passes"]):
            probs = ref.probabilities(p["logits"])
            pick = ref.picks(ref.clusters(probs, got["xyz"], got["mask"],
                                          m.dbscan_eps, m.dbscan_min_samples),
                             m.choose_cluster_prob, p["default"], rng)
            picks_off += int((np.abs(pick - p["center"]).max(-1)
                              > SAME_A)[:n].sum())
            idx, mask = p["crop"]
            for r in range(n):
                valid = got["mask"][r]
                prob_err.append(float(np.abs(
                    probs[r][valid]
                    - ref.probabilities(w["logits"][r][valid])).mean()))
                xyz = got["xyz"][r][valid]
                again = ref_dock.rounded_center(p["logits"][r][valid], xyz, m,
                                                dtype)
                center_err.append(float(np.linalg.norm(again
                                                       - p["default"][r])))
                radius = model._crop_radius(torch.as_tensor(
                    w["radius"][r:r + 1]).to(dtype))
                crop = ref_dock.crop_of(
                    p["center"][r], xyz, model, ref_b["max_pocket"],
                    radius=None if radius is None else radius.float())
                crops_off += crop != idx[r][mask[r]].tolist()
    got_req = ref.requests(program, raws, bucket_cfgs)
    want_req = ref.requests(want, raws, bucket_cfgs)
    rows, conf_err, not_argmax, winners_off = [], [], 0, 0
    for i in sorted(want_req):
        g, w = got_req[i], want_req[i]
        rows += [cmp.distances(a, b) for a, b in zip(g["coords"],
                                                     w["coords"])]
        conf_err.append(float(np.abs(g["conf"] - w["conf"]).max()))
        gap = [float(np.abs(served[i] - c).max()) if c.shape ==
               served[i].shape else float("inf") for c in g["coords"]]
        a = int(np.argmin(gap))
        if gap[a] > SAME_A or g["conf"][a] < g["conf"].max():
            not_argmax += 1
        if w["conf"][a] < w["conf"].max() - conf_limit:
            winners_off += 1
    ctx.record["check_rows"] = rows
    out = cmp.summary(rows)
    return {"pose_median_A": out["pose_median_A"],
            "shape_median_A": out["shape_median_A"],
            "shape_max_A": out["shape_max_A"],
            "confidence_err_max": max(conf_err),
            "pocket_prob_err_mean": float(np.mean(prob_err)),
            "center_err_max_A": max(center_err),
            "crop_mismatches": float(crops_off),
            "pick_mismatches": float(picks_off),
            "served_not_argmax": float(not_argmax),
            "winners_off": float(winners_off)}
