"""Run one benchmark cell's driver and write what the port's own tracing
(fabind_tpu_torch/utils/tracing.py) saw, or what it costs.

    python tools/torch_program_trace.py --workload CELL --seed N \\
        --seconds S --trace 1 --out trace.json
    python tools/torch_program_trace.py --workload CELL --seed N \\
        --seconds S --trace 0 --tracing 0|1|alternate \\
        --out cost.json

--trace 1 runs the benchmark's traced run (the profiler over a part of the
window) with the program's spans on through the whole run, and writes the
cell's per-layer metrics, the profiles joined with the spans
(benchmark/program_trace.py: idle and launches by innermost span, by span
with its children and by recycle round), the program's counters and the
mean host milliseconds of each span name over the window's unprofiled part.
--trace 0 --tracing 1 turns the program's tracing on for the whole run, with no
profiler: its end-to-end metric against --tracing 0 on the same seed is
tracing's cost. --tracing alternate turns it on and off call by call
(each of the batch cell's calls runs with it on and off in turn across
the pool's cycles) or step by step, in one process, and writes each
side's rate; it also times one span and one count on the host while the
device has a queue of work (a count or span that waited on the device
would drain it). Needs a CUDA device; runs no correctness check.
"""
from __future__ import annotations

import argparse
import importlib
import json
import os
import sys
import time
from collections import defaultdict

T0 = time.perf_counter()
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def host_ms(ctx, spans) -> dict:
    """{span name: mean host ms} of the spans that started in the window
    and outside its profiled part."""
    from benchmark.harness import in_profile
    from benchmark.program_trace import mean_ms
    w0, w1 = ctx.record["window"]
    spans = [s for s in spans if w0 <= s.start_ns * 1e-9 <= w1
             and not in_profile(ctx, s.start_ns * 1e-9)]
    return {n: mean_ms(spans, n) for n in sorted({s.name for s in spans})}


def merge(joins: list) -> dict:
    """The profiles' joins summed into one (the clock's play: the
    smallest)."""
    out: dict = {}
    for p in (j for j in joins if j is not None):
        for k, v in p.items():
            if isinstance(v, dict):
                d = out.setdefault(k, defaultdict(float))
                for n, x in v.items():
                    d[n] += x
            elif k == "clock_us":
                out[k] = min(out.get(k, v), v)
            else:
                out[k] = out.get(k, 0) + v
    return {k: dict(v) if isinstance(v, dict) else v for k, v in out.items()}


def alternate(ctx, tracing, log: list):
    """The hook that turns tracing on and off call by call (each pool
    slot alternating across its visits, the slots staggered) or step by
    step, logging (on, seconds, complexes or samples, key)."""
    import torch

    def plant(obj):
        if ctx.mix["driver"] == "dock":
            inner, visits = obj.dock_raw, {}

            def toggled(raws):
                n = visits.setdefault(id(raws), [len(visits), 0])
                on = (n[0] + n[1]) % 2 == 0
                n[1] += 1
                (tracing.enable if on else tracing.disable)()
                t0 = time.perf_counter()
                poses = inner(raws)
                log.append((on, t0, time.perf_counter() - t0,
                            sum(p.error is None for p in poses), n[0]))
                tracing.reset()
                return poses
            obj.dock_raw = toggled
        else:
            inner = obj.train_step

            def toggled(batch, cfg_b=None, gumbel_u=None):
                on = obj.step % 2 == 0
                (tracing.enable if on else tracing.disable)()
                t0 = time.perf_counter()
                m = inner(batch, cfg_b, gumbel_u)
                torch.cuda.synchronize()
                sh = cfg_b.shapes
                log.append((on, t0, time.perf_counter() - t0,
                            batch.batch_size, sh.max_protein))
                tracing.reset()
                return m
            obj.train_step = toggled
    return plant


def summarize_alternate(ctx, log: list) -> dict:
    """Each side's rate over the window's calls or steps, and per key
    (pool slot or bucket) each side's mean seconds."""
    w0 = ctx.record["window"][0]
    out = {}
    for on in (True, False):
        rows = [r for r in log if r[0] == on and r[1] >= w0]
        keys = defaultdict(list)
        for r in rows:
            keys[r[4]].append(r[2])
        out["on" if on else "off"] = {
            "n": len(rows), "rate": sum(r[3] for r in rows)
            / max(sum(r[2] for r in rows), 1e-9),
            "mean_s_by_key": {k: sum(v) / len(v) for k, v in keys.items()}}
    return out


def host_cost(tracing) -> dict:
    """Microseconds per span (tracing on) and per count on the host, each
    timed over 2,000 calls behind a queue of device work, and whether the
    queue was still running after them (it would have drained had a call
    waited on the device)."""
    import torch
    x = torch.randn(4096, 4096, device="cuda")
    out = {}
    for name in ("span", "count"):
        torch.cuda.synchronize()
        for _ in range(40):
            x @ x
        tracing.enable()
        t0 = time.perf_counter()
        for _ in range(2000):
            if name == "span":
                with tracing.span("probe"):
                    pass
            else:
                tracing.count("probe")
        dt = time.perf_counter() - t0
        out[name] = {"us": dt / 2000 * 1e6,
                     "queue_busy_after": not torch.cuda.current_stream()
                     .query()}
        tracing.disable()
        tracing.reset()
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=1)
    p.add_argument("--tracing", choices=("0", "1", "alternate"),
                   default="0")
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)

    from benchmark import harness, program_trace
    from benchmark.run import cache_dirs
    cache_dirs()
    import torch
    if not torch.cuda.is_available():
        print("a CUDA device is needed", file=sys.stderr)
        return 2
    from fabind_tpu_torch.utils import tracing
    ctx = harness.load_context(args.workload, args.seed, args.seconds,
                               bool(args.trace), T0)
    driver = importlib.import_module(f"benchmark.drivers.{ctx.mix['driver']}")
    log: list = []
    if args.tracing == "alternate":
        ctx.engine_hook = alternate(ctx, tracing, log)
    elif args.tracing == "1" or args.trace:
        tracing.reset()
        tracing.enable()
    with program_trace.joining(tracing) as joins:
        e2e = driver.run(ctx)
    tracing.disable()
    rec = ctx.record
    out = {"workload": args.workload, "seed": args.seed,
           "trace": args.trace, "tracing": args.tracing,
           "device": torch.cuda.get_device_name(0),
           "metrics": dict(e2e, setup_s=rec["setup_s"]),
           "attempted": rec["attempted"], "failed": rec["failed"]}
    if args.tracing == "alternate":
        out["alternate"] = summarize_alternate(ctx, log)
        out["host_cost"] = host_cost(tracing)
    if args.trace:
        out["per_layer"] = {n: harness.read_metric(n, ctx)
                            for n in ctx.per_layer_names()}
        out["breakdown"] = rec["trace"]["breakdown"]
        snap = tracing.snapshot()
        out["joined"] = merge(joins)
        out["counters"] = snap["counters"]
        out["spans_dropped"] = snap["spans_dropped"]
        out["host_ms"] = host_ms(ctx, snap["spans"])
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1, default=str)
    print(json.dumps({k: out[k] for k in ("workload", "seed", "trace",
                                          "tracing", "metrics", "alternate",
                                          "host_cost") if k in out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
