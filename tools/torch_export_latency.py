"""Batch latency of an exported program against the live forward on one
CUDA card, and what Python's cyclic garbage collector costs each.

    python3 tools/torch_export_latency.py [--bucket 48:160:512] [--reps 12]

Exports preset `fabind` at chip_smoke.py's widths with its seeded weights
(bf16, batch 8) in one bucket on the card (aot.export_inference), loads it
with DockingEngine.from_exported beside a live engine of the same weights,
and times one batch of chip_smoke.py's requests through each in turns (live,
exported, exported, live), host clock around work that ends in synchronize.
Each timed batch also records the milliseconds the cyclic collector spent
inside it (gc.callbacks) and its collections by generation. The same runs
again after gc.freeze(), which moves every object then alive (the loaded
program's graph among them) out of the collector's reach. Then dock_raw of
the bucket's requests through each engine, and one torch.profiler pass over
one batch of each: its operator calls, their host (self CPU) time, device
busy time, and the operators whose host time grows most in the exported
program.
"""
from __future__ import annotations

import argparse
import gc
import statistics
import sys
import tempfile
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as C  # noqa: E402
from fabind_tpu_torch.aot import export_inference  # noqa: E402
from fabind_tpu_torch.config import preset  # noqa: E402
from fabind_tpu_torch.data.buckets import resolve_buckets  # noqa: E402
from fabind_tpu_torch.models.fabind import (init_params,  # noqa: E402
                                             make_model)
from fabind_tpu_torch.serve import DockingEngine  # noqa: E402


class CollectorTimer:
    """Milliseconds and collections by generation of the cyclic collector
    since the last `take`."""

    def __init__(self):
        self.ms, self.counts, self._t0 = 0.0, [0, 0, 0], None
        gc.callbacks.append(self._callback)

    def _callback(self, phase, info):
        if phase == "start":
            self._t0 = time.perf_counter()
        elif self._t0 is not None:
            self.ms += (time.perf_counter() - self._t0) * 1e3
            self.counts[info["generation"]] += 1
            self._t0 = None

    def take(self):
        out = (self.ms, list(self.counts))
        self.ms, self.counts = 0.0, [0, 0, 0]
        return out

    def close(self):
        gc.callbacks.remove(self._callback)


def timed_batch(engine, batch, cfg_b, timer):
    timer.take()
    t0 = time.perf_counter()
    engine.run_batch(batch, cfg_b)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    gc_ms, counts = timer.take()
    return ms, gc_ms, counts


def report(what, runs, card_line):
    ms = [r[0] for r in runs]
    gc_ms = [r[1] for r in runs]
    gens = [sum(r[2][g] for r in runs) for g in range(3)]
    print(f"time {what}: median batch {statistics.median(ms):.2f} ms of "
          f"{[round(x, 2) for x in ms]}; collector in batch median "
          f"{statistics.median(gc_ms):.2f} ms, max {max(gc_ms):.2f} ms, "
          f"collections by generation {gens} over {len(runs)} batches "
          f"[{card_line}]")


def profile_batch(engine, batch, cfg_b):
    """{operator: (calls, self CPU us)} and device busy ms of one batch."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        engine.run_batch(batch, cfg_b)
        torch.cuda.synchronize()
    events = prof.key_averages()
    ops = {e.key: (e.count, e.self_cpu_time_total) for e in events
           if e.device_type == DeviceType.CPU}
    busy = sum(e.self_device_time_total for e in events
               if e.device_type == DeviceType.CUDA) / 1e3
    return ops, busy


def report_profiles(profiles, card_line):
    for name, (ops, busy) in profiles.items():
        aten = {k: v for k, v in ops.items() if k.startswith("aten::")}
        calls = sum(c for c, _ in aten.values())
        aten_ms = sum(t for _, t in aten.values()) / 1e3
        all_ms = sum(t for _, t in ops.values()) / 1e3
        print(f"profile {name} batch: {calls} aten calls, {aten_ms:.2f} ms "
              f"self CPU in them, {all_ms:.2f} ms self CPU in all, device "
              f"busy {busy:.2f} ms [{card_line}]")
    (live, _), (exp, _) = profiles["live"], profiles["exported"]
    grow = sorted(set(live) | set(exp), key=lambda k: exp.get(k, (0, 0))[1]
                  - live.get(k, (0, 0))[1], reverse=True)
    for k in grow[:10]:
        (lc, lt), (ec, et) = live.get(k, (0, 0)), exp.get(k, (0, 0))
        print(f"profile host time grown in the exported batch: {k}: calls "
              f"{lc} -> {ec}, self CPU {lt / 1e3:.2f} -> {et / 1e3:.2f} ms")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--bucket", default="48:160:512")
    ap.add_argument("--reps", type=int, default=12)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_export_latency: no CUDA device", file=sys.stderr)
        return 1
    card_line, _ = C.card()
    print(card_line)
    C.build_all([C.edge_gate.KERNEL])
    cfg = preset("fabind", **C.SMOKE_SHAPES)
    shapes, = resolve_buckets(args.bucket, cfg)
    cfg = cfg.replace(shapes=shapes)
    model = make_model(cfg)
    init_params(model, torch.Generator().manual_seed(0))
    live = DockingEngine(cfg, batch_size=C.BATCH, seed=0)
    build = Path(__file__).resolve().parents[1] / "build"
    build.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as out:
        t0 = time.perf_counter()
        export_inference(cfg, model.state_dict(), out, batch_size=C.BATCH)
        export_s = time.perf_counter() - t0
        gc.collect()
        before = len(gc.get_objects())
        t0 = time.perf_counter()
        exported = DockingEngine.from_exported(out)
        load_s = time.perf_counter() - t0
    gc.collect()
    after = len(gc.get_objects())
    print(f"time export bucket {args.bucket}: {export_s:.1f} s, load "
          f"{load_s:.1f} s; objects tracked by the collector {before} "
          f"before the load, {after} after [{card_line}]")

    raws = C.make_requests(C.N_REQUESTS, seed=C.REQUEST_SEED)
    (_, cfg_l, batch_l), = C.first_batches(live, {"b": raws[:C.BATCH]})
    (_, cfg_e, batch_e), = C.first_batches(exported, {"b": raws[:C.BATCH]})
    pair = (("live", live, batch_l, cfg_l),
            ("exported", exported, batch_e, cfg_e))
    for _, eng, batch, cfg_b in pair:
        eng.run_batch(batch, cfg_b)
    torch.cuda.synchronize()
    timer = CollectorTimer()
    try:
        for mode in ("collector on", "after gc.freeze()"):
            if mode != "collector on":
                gc.collect()
                gc.freeze()
            runs = {"live": [], "exported": []}
            for _ in range(args.reps // 2):
                for name, eng, batch, cfg_b in pair + pair[::-1]:
                    runs[name].append(timed_batch(eng, batch, cfg_b, timer))
            for name in runs:
                report(f"{name} bf16 batch bucket {args.bucket}, {mode}",
                       runs[name], card_line)
            for name, eng, _, _ in pair:
                secs = []
                for _ in range(3):
                    t0 = time.perf_counter()
                    eng.dock_raw(raws)
                    secs.append(time.perf_counter() - t0)
                print(f"time {name} dock_raw {len(raws)} requests in one "
                      f"bucket, {mode}: median "
                      f"{statistics.median(secs):.3f} s, "
                      f"{len(raws) / statistics.median(secs):.2f} "
                      f"complexes/s [{card_line}]")
        report_profiles({name: profile_batch(eng, batch, cfg_b)
                         for name, eng, batch, cfg_b in pair}, card_line)
    finally:
        timer.close()
        gc.unfreeze()
    return 0


if __name__ == "__main__":
    sys.exit(main())
