"""The traced run: `torch.profiler` over a steady part of the window,
reduced in memory to what the per-layer readers need.

Nothing is written but the summary the run prints. The profiled part is
wrapped in a `bench.window` range; the device is busy where any device
activity (kernels, copies, sets) runs, as the union of their intervals
within that range; the host's kernel launches are its runtime launch calls;
each matrix product, edge-gate and dropout call is kept with its recorded
input shapes and the device time of the kernels it launched.
"""
from __future__ import annotations

import contextlib
import re
from collections import defaultdict
from typing import Dict, Iterator, List, Optional, Tuple

WINDOW = "bench.window"
LAUNCH_NAMES = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC",
                "cuLaunchKernelEx", "cudaLaunchCooperativeKernel")
MATMUL_OPS = ("aten::mm", "aten::addmm", "aten::bmm", "aten::baddbmm")
GATE_OP = "fabind_tpu_torch::edge_gate_pair"
GATE_KERNEL = "edge_gate_kernel"
DROPOUT_OP = "fabind_tpu_torch::dropout"
DROPOUT_KERNELS = ("dropout_kernel", "dropout_rows_kernel")
# a kernel's base name in its demangled signature ("void (anonymous
# namespace)::dropout_kernel<true>(...)")
_BASE = re.compile(r"(?:^|[\s:])(\w+)(?:<[^(]*)?\(")
TOP = 10
NAME_CHARS = 96


@contextlib.contextmanager
def profiled(spans) -> Iterator[list]:
    """Profile the block (CPU and CUDA, shapes recorded) inside one
    `bench.window` range; yields a list that holds the profiler after the
    block ends."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    box: list = []
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                   record_shapes=True)
    prof.__enter__()
    spans.profiling = True
    try:
        with record_function(WINDOW):
            yield box
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    finally:
        spans.profiling = False
        prof.__exit__(None, None, None)
        box.append(prof)


def _device_us(e) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(e, attr, None)
        if v is not None:
            return float(v)
    return 0.0


def _is_device(e) -> bool:
    return str(getattr(e, "device_type", "")).endswith("CUDA")


def _is_annotation(e) -> bool:
    """A record_function range mirrored onto the device's timeline (not
    device work)."""
    return bool(getattr(e, "is_user_annotation", False)) or \
        e.name.startswith(("bench.", "ProfilerStep"))


def base_name(kernel: str) -> str:
    """The kernel's function name without its namespace, template
    arguments and parameters."""
    m = _BASE.search(kernel)
    return m.group(1) if m else kernel


def union_us(intervals: List[Tuple[float, float]]) -> Tuple[float, list]:
    """(total length, merged intervals) of the union of [a, b) intervals."""
    merged: List[List[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return sum(b - a for a, b in merged), merged


def reduce(prof) -> Dict:
    """The summary of one profile: window and busy seconds, launches,
    device time by kernel name, the calls of the tracked operators with
    their shapes and device microseconds, the idle gaps named by the open
    span, and the benchmark spans (profiler microseconds)."""
    events = list(prof.events())
    win = [e for e in events if e.name == WINDOW and not _is_device(e)]
    if not win:
        raise RuntimeError("the profile holds no bench.window range")
    w0, w1 = win[0].time_range.start, win[0].time_range.end
    dev: List[Tuple[float, float]] = []
    by_kernel: Dict[str, float] = defaultdict(float)
    kernels: Dict[str, List[float]] = defaultdict(list)
    launches = 0
    ops: Dict[str, List[Tuple[list, float]]] = defaultdict(list)
    span_iv: List[Tuple[float, float, str]] = []
    for e in events:
        a, b = e.time_range.start, e.time_range.end
        if _is_device(e):
            if _is_annotation(e):
                continue
            a, b = max(a, w0), min(b, w1)
            if b > a:
                dev.append((a, b))
                by_kernel[e.name] += b - a
                base = base_name(e.name)
                if base in (GATE_KERNEL,) + DROPOUT_KERNELS:
                    kernels[base].append(e.time_range.start)
            continue
        if not w0 <= a <= w1:
            continue
        if e.name in LAUNCH_NAMES:
            launches += 1
        elif e.name in MATMUL_OPS or e.name in (GATE_OP, DROPOUT_OP):
            ops[e.name].append((list(e.input_shapes or []), _device_us(e)))
        elif e.name.startswith("bench.") and e.name != WINDOW:
            span_iv.append((a, b, e.name[len("bench."):]))
    busy, merged = union_us(dev)
    gaps = []
    edges = [w0] + [x for iv in merged for x in iv] + [w1]
    for a, b in zip(edges[::2], edges[1::2]):
        if b > a:
            gaps.append((b - a, a, b))
    gaps.sort(reverse=True)
    named = []
    for length, a, b in gaps[:TOP]:
        mid = (a + b) / 2
        open_ = [s for s in span_iv if s[0] <= mid <= s[1]]
        # the innermost (shortest) open span names the gap
        name = min(open_, key=lambda s: s[1] - s[0])[2] if open_ else "none"
        named.append([name, length * 1e-6])
    top_ops = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:TOP]
    # kernel names are C++ templates: the first NAME_CHARS name each
    return {
        "window_s": (w1 - w0) * 1e-6,
        "busy_s": busy * 1e-6,
        "launches": launches,
        "device_us_by_kernel": dict(by_kernel),
        "kernel_counts": {k: len(v) for k, v in kernels.items()},
        "ops": dict(ops),
        "breakdown": {"device_ops": [[n[:NAME_CHARS], us * 1e-6]
                                     for n, us in top_ops],
                      "idle_gaps": named},
    }


def kernel_us(summary: Dict, names) -> float:
    """Device microseconds of the kernels whose base names are in
    `names`."""
    return sum(us for n, us in summary["device_us_by_kernel"].items()
               if base_name(n) in tuple(names))


def op_calls(summary: Dict, name: str) -> List[Tuple[list, float]]:
    return summary["ops"].get(name, [])


def merge(summaries: List[Dict]) -> Optional[Dict]:
    """One summary of several profiled windows (sums; gaps and top
    operations re-ranked)."""
    if not summaries:
        return None
    if len(summaries) == 1:
        return summaries[0]
    out = {"window_s": 0.0, "busy_s": 0.0, "launches": 0,
           "device_us_by_kernel": defaultdict(float),
           "kernel_counts": defaultdict(int), "ops": defaultdict(list)}
    gaps, ops_t = [], defaultdict(float)
    for s in summaries:
        for k in ("window_s", "busy_s", "launches"):
            out[k] += s[k]
        for n, v in s["device_us_by_kernel"].items():
            out["device_us_by_kernel"][n] += v
        for n, v in s["kernel_counts"].items():
            out["kernel_counts"][n] += v
        for n, v in s["ops"].items():
            out["ops"][n].extend(v)
        gaps.extend(s["breakdown"]["idle_gaps"])
        for n, v in s["breakdown"]["device_ops"]:
            ops_t[n] += v
    out["breakdown"] = {
        "device_ops": sorted(([n, v] for n, v in ops_t.items()),
                             key=lambda x: -x[1])[:TOP],
        "idle_gaps": sorted(gaps, key=lambda x: -x[1])[:TOP]}
    return {k: dict(v) if isinstance(v, defaultdict) else v
            for k, v in out.items()}
