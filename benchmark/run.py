"""The benchmark of fabind_tpu_torch on one H100.

    python -m benchmark.run --workload CELL --seed N --seconds S --trace 0|1

Runs one cell of BENCHMARK.json: builds the port's engine (or trainer) of
the cell's configuration with weights drawn from the seed, warms up every
shape the cell's traffic uses, drives the cell's traffic for S seconds, then
checks what the timed path produced against the plain reference and prints
one JSON line: `correct`, `attempted`, `failed`, `metrics` (the cell's
end-to-end metrics, or with --trace 1 its per-layer ones), `device`, with
--trace 1 `breakdown`, and last `checks`, each number compared beside its
limit (also the last lines of standard error).

Each cell names a configuration (configs/<name>.json), a traffic mix
(traffic/<name>.json, whose "driver" names the general driver under
drivers/) and, through BENCHMARK.json, its per-layer metrics (each read by
metrics/<name>.py). Exits non-zero, printing no result, without enough CUDA
devices, when the check cannot run, or when JAX, flax or the JAX package
was loaded.

`--control 1` replaces the window by the lower-precision control (the
reference one precision down in the program's place) and judges its
numbers against the cell's limits as a run's are: it prints
{"correct": ..., "control": true, "checks": ...}, where `correct` has to
come out false. The benchmark's own runs never pass it.
"""
from __future__ import annotations

import time

T_IMPORT = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parents[1]


def cache_dirs() -> None:
    """Every build and kernel cache at a fixed path inside the checkout
    (the port builds its kernels into build/kernels/ by itself)."""
    build = CHECKOUT / "build"
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = str(build / sub)
    os.environ["USE_FLAX"] = "0"


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def device_info(chips: int) -> dict:
    import torch
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips}


def checks(rows) -> dict:
    return {name: {"value": v, "limit": lim} for name, v, lim in rows}


def print_checks(rows) -> None:
    for name, v, lim in rows:
        print(f"check {name} {v!r} limit {lim!r}", file=sys.stderr)


def main(argv=None) -> int:
    args = parse(argv)
    cache_dirs()
    from benchmark import harness
    t_start = min(harness.process_start(), T_IMPORT)
    ctx = harness.load_context(args.workload, args.seed, args.seconds,
                               bool(args.trace), t_start)
    import torch
    chips = int(ctx.cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: {chips} CUDA device(s) needed, "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              f" available", file=sys.stderr)
        return 2
    torch.cuda.reset_peak_memory_stats()
    driver = importlib.import_module(f"benchmark.drivers.{ctx.mix['driver']}")
    if args.control:
        driver.prepare_control(ctx)
        correct, rows = harness.judge(driver.check(ctx, control=True),
                                      harness.limits(ctx))
        print_checks(rows)
        print(json.dumps({"correct": bool(correct), "control": True,
                          "checks": checks(rows)}))
        return 0
    e2e = driver.run(ctx)
    rec = ctx.record
    t_check = time.perf_counter()
    numbers = driver.check(ctx)
    print(f"benchmark: set-up {rec.get('setup_parts')}, window "
          f"{args.seconds} s, check {time.perf_counter() - t_check:.1f} s",
          file=sys.stderr)
    correct, rows = harness.judge(numbers, harness.limits(ctx))
    if args.trace:
        metrics, units = {}, {m["name"]: m["unit"]
                              for m in ctx.bench["per_layer"]}
        t_read = time.perf_counter()
        for name in ctx.per_layer_names():
            v = harness.read_metric(name, ctx)
            if v is not None:
                metrics[name] = {"value": v, "unit": units[name]}
        print(f"benchmark: trace reduced in {rec.get('reduce_s', 0):.1f} s, "
              f"per-layer readers {time.perf_counter() - t_read:.1f} s",
              file=sys.stderr)
    else:
        units = {m["name"]: m["unit"] for m in ctx.bench["end_to_end"]}
        values = dict(e2e, setup_s=rec["setup_s"])
        metrics = {n: {"value": values[n], "unit": units[n]}
                   for n in ctx.end_to_end_names()}
    device = dict(device_info(chips),
                  memory_peak_bytes=int(rec.get("memory_peak_bytes", 0)))
    out = {"correct": bool(correct), "attempted": int(rec["attempted"]),
           "failed": int(rec["failed"]), "metrics": metrics,
           "device": device}
    if args.trace:
        tr = rec.get("trace")
        if tr is None:
            print("benchmark: the traced run profiled nothing",
                  file=sys.stderr)
            return 3
        device.update(busy_s=tr["busy_s"], window_s=tr["window_s"])
        out["breakdown"] = tr["breakdown"]
    out["checks"] = checks(rows)
    bad = harness.forbidden_modules()
    if bad:
        print(f"benchmark: forbidden modules loaded: {bad}", file=sys.stderr)
        return 4
    print_checks(rows)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
