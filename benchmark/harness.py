"""What every driver shares: the run's context, the port's engine built
from a configuration file, the engine's spans, the per-layer readers, the
comparison against the limits, and the result line.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

from benchmark import gen
from benchmark.configs_io import BenchConfig, load_config
from benchmark.spans import Spans, wrap_generator

ROOT = Path(__file__).resolve().parent
CHECKOUT = ROOT.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "fabind_tpu")


def process_start() -> float:
    """perf_counter() at this process's start (from /proc), or now."""
    now = time.perf_counter()
    try:
        ticks = os.sysconf("SC_CLK_TCK")
        start = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1]
                    .split()[19]) / ticks
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return now - max(0.0, uptime - start)
    except (OSError, ValueError, IndexError):
        return now


@dataclasses.dataclass
class Context:
    """One run: its cell and what the cell names, the arguments, and the
    run's spans and records."""

    workload: str
    cell: Dict
    bench: Dict
    config: BenchConfig
    mix: Dict
    seed: int
    seconds: float
    trace: bool
    t_start: float
    device: str = "cuda"
    engine_hook: Optional[Callable] = None   # tests plant faults with it
    spans: Spans = dataclasses.field(default_factory=Spans)
    record: Dict = dataclasses.field(default_factory=dict)

    def per_layer_names(self) -> List[str]:
        return [m["name"] for m in self.bench["per_layer"]
                if self.workload in m.get("workloads", [self.workload])]

    def end_to_end_names(self) -> List[str]:
        return [m["name"] for m in self.bench["end_to_end"]
                if self.workload in m.get("workloads", [self.workload])]


def load_context(workload: str, seed: int, seconds: float, trace: bool,
                 t_start: float, bench_path: Path = CHECKOUT /
                 "BENCHMARK.json", **kw) -> Context:
    bench = json.loads(Path(bench_path).read_text())
    cells = {c["name"]: c for c in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}")
    cell = cells[workload]
    return Context(workload, cell, bench, load_config(cell["config"]),
                   gen.load_mix(cell["traffic"]), seed, seconds, trace,
                   t_start, **kw)


# ------------------------------------------------------------------ engine
def port_config(cfg: BenchConfig, **extra):
    """The port's FABindConfig (with `extra` overrides) and bucket list of
    a configuration file."""
    import dataclasses as dc

    from fabind_tpu_torch.config import preset
    c = preset(cfg.preset, **cfg.overrides, **extra)
    return c, [dc.replace(c.shapes, max_ligand=a, max_pocket=b,
                          max_protein=r) for a, b, r in cfg.buckets]


def build_engine(ctx: Context, state_dict):
    """The port's DockingEngine for the cell's configuration, in its
    serving dtype, with the seeded weights."""
    from fabind_tpu_torch.serve import DockingEngine
    cfg, buckets = port_config(ctx.config)
    return DockingEngine(cfg, state_dict=state_dict, buckets=buckets,
                         batch_size=ctx.config.batch_size,
                         bf16=ctx.config.serve_dtype == "bf16",
                         device=ctx.device)


def instrument(ctx: Context, engine) -> None:
    """Spans around the engine's host preparation of each batch (each
    `next()` of its `batches` generator) and each `run_batch`, and the
    padding of every batch (real ligand atoms x real residues against the
    bucket's rows x Nc x Nr), its index in the call and its requests'
    sizes (atoms, pocket crop, residues) under the record's "batches"."""
    spans = ctx.spans
    batches = engine.batches
    run_batch = engine.run_batch
    log = ctx.record.setdefault("batches", [])

    def counted(raws, results):
        for bi, item in enumerate(wrap_generator(spans, "prep",
                                                 batches(raws, results))):
            chunk, cfg_b, _, n_real = item
            sh = cfg_b.shapes
            real = sum(s["lig_feat"].shape[0] * s["prot_xyz"].shape[0]
                       for _, s in chunk[:n_real])
            log.append({"t": time.perf_counter(), "bi": bi, "real": real,
                        "padded": engine.batch_size * sh.max_ligand
                        * sh.max_protein,
                        "bucket": (sh.max_ligand, sh.max_pocket,
                                   sh.max_protein),
                        "sizes": [(s["lig_feat"].shape[0],
                                   len(s["pocket_idx"]),
                                   s["prot_xyz"].shape[0])
                                  for _, s in chunk[:n_real]]})
            yield item

    def timed(batch, cfg_b):
        with spans.span("run_batch"):
            return run_batch(batch, cfg_b)

    engine.batches = counted
    engine.run_batch = timed


def warm_requests(ctx: Context, pool: List[Dict]) -> List[Dict]:
    """One request of the pool per bucket it reaches (the reference's
    routing), in bucket order: a warm-up call that runs every bucket."""
    from benchmark.reference.batching import build_sample
    from benchmark.reference.buckets import route_sample
    cfgs = ctx.config.ref_bucket_cfgs()
    seen: Dict[int, Dict] = {}
    for raw in pool:
        c = route_sample(build_sample(raw, cfgs[-1], group="test"), cfgs)
        if c is not None:
            seen.setdefault(cfgs.index(c), raw)
        if len(seen) == len(cfgs):
            break
    return [seen[k] for k in sorted(seen)]


# ------------------------------------------------------------------ checks
def limits(ctx: Context) -> Optional[Dict[str, float]]:
    """{number: limit} of the cell (limits/<workload>.json), None when the
    cell has none yet."""
    p = ROOT / "limits" / f"{ctx.workload}.json"
    if not p.exists():
        return None
    return {k: float(v["limit"]) for k, v in
            json.loads(p.read_text())["checks"].items()}


def judge(numbers: Dict[str, float], lim: Optional[Dict[str, float]]):
    """(correct, [[name, number, limit]]): every number at most its limit;
    a number that is not finite fails; no limits: not correct."""
    import math
    rows, ok = [], lim is not None
    for name, v in numbers.items():
        limit = None if lim is None else lim.get(name)
        rows.append([name, v, limit])
        if limit is not None and not (math.isfinite(v) and v <= limit):
            ok = False
    if lim is not None and set(lim) - set(numbers):
        ok = False
    return ok, rows


# ----------------------------------------------------------------- readers
def read_metric(name: str, ctx: Context) -> Optional[float]:
    """The per-layer metric `name` from its reader metrics/<name>.py
    (`read(ctx)`), None when the reader finds nothing to read."""
    path = ROOT / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(ctx)


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's, flax's or the JAX
    package's, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def in_profile(ctx: Context, t: float) -> bool:
    """Whether host time t fell in a profiled part of the window."""
    return any(a <= t <= b for a, b in ctx.record.get("profiled", []))


def mark(ctx: Context, stage: str) -> None:
    """Record that set-up stage `stage` ended now (seconds since the
    process started), for the set-up's parts."""
    ctx.record.setdefault("setup_parts", []).append(
        (stage, round(time.perf_counter() - ctx.t_start, 3)))
