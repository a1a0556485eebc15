"""Drive the PyTorch port (fabind_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--profile PATH]

Phases, each of which raises on failure (non-zero exit):
  1. card and build: the card's name and power limit; every CUDA kernel of
     the port is compiled from the sources in this checkout (nvcc, sm_90a);
  2. each kernel against its plain PyTorch version on the card: the edge
     gate's paired launch (both attention directions) at the shapes the main
     path launches it with, a ragged pair, H = 100 and pre-activations up to
     +-100 (with w2 unscaled, held to float64 no worse than the plain fp32
     version); its one-direction launch at the four one-direction shapes of the
     gate and a ragged one; both activations, fp32 and bf16, and both
     gradients at a small shape;
  3. the main path: `DockingEngine.dock_raw` at preset `fabind` full width on
     16 seeded synthetic requests (seeded random weights); one finite pose per
     request, every kernel launched (the gate 33 times per batch), and the
     first batch docked again with the kernels replaced by their plain
     versions;
  4. times (CUDA events after warm-up): each kernel and its plain version
     beside its fp32 bound and its special-function-unit floor, the gate's
     device time per batch, and dock_raw's batch latency and complexes/s.
The second-to-last line is a JSON object describing each kernel; the last is
{"ok": true, "device": {...}}. With --profile PATH, a torch.profiler table of
one docking batch (device time by kernel) is written to PATH.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from fabind_tpu_torch.config import preset
from fabind_tpu_torch.models import layers
from fabind_tpu_torch.ops import edge_gate
from fabind_tpu_torch.ops.cuda_build import build_all, find_nvcc
from fabind_tpu_torch.serve import DockingEngine

# published H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, fp32 FLOP/s
# outside the tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_FP32_S = 67e12
# special-function-unit (MUFU) results per clock per SM, compute capability
# 9.0 (CUDA C Programming Guide, arithmetic instruction throughput), and
# MUFU operations per silu gate element (one exp, one reciprocal)
MUFU_PER_CLK_SM = 16
MUFU_PER_SILU = 2

SMOKE_SHAPES = dict(max_ligand=48, max_pocket=160, max_protein=512)
BATCH = 8
N_REQUESTS = 16
# (name, B, Na, Nb, H, launches per batch): the edge gate's main-path
# launches at SMOKE_SHAPES, both directions of a layer in one launch
# (1 pocket layer x 1 recycle, 4 docking layers x 8 recycles)
PAIR_SHAPES = [
    ("pocket lig-prot", BATCH, 48, 512, 128, 1),
    ("dock lig-pkt", BATCH, 48, 160, 512, 32),
]
PAIR_EXTRA = [("ragged", 2, 7, 11, 48, 0), ("H=100", 2, 13, 21, 100, 0)]
GATE_LAUNCHES_PER_BATCH = sum(s[-1] for s in PAIR_SHAPES)
# (name, B, D, N, H, launches per batch of the first port, one per
# direction): the one-direction launch, phi_rank1
SINGLE_SHAPES = [
    ("pocket lig<-prot", BATCH, 48, 512, 128, 1),
    ("pocket prot<-lig", BATCH, 512, 48, 128, 1),
    ("dock lig<-pkt", BATCH, 48, 160, 512, 32),
    ("dock pkt<-lig", BATCH, 160, 48, 512, 32),
]
RAGGED = ("ragged", 2, 7, 11, 48, 0)
# the large-argument case: l1 uniform in [-100, 100]
WIDE = 100.0
# kernel vs plain: the sum over H runs in another order (fp32); bf16 output
# is one rounding of the same fp32 sum, so within ~1 bf16 ulp
TOL = {torch.float32: (1e-4, 1e-5), torch.bfloat16: (1e-2, 1e-2)}
# pre-activations up to +-WIDE with w2 unscaled: terms reach ~100, where two
# fp32 sums over H in different orders differ by more than TOL; the kernel's
# error against float64 may be at most this multiple of the plain fp32
# version's
WIDE_ERR_RATIO = 1.5
# dock_raw with the kernel vs with the plain gate: max coordinate difference
# in Angstrom after 8 recycles x 4 layers
POSE_TOL_A = 1e-2
# aten ops that run the model's matrix products (profile summary)
MATMUL_OPS = ("aten::addmm", "aten::mm", "aten::bmm", "aten::baddbmm")


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def card():
    """The card's name and power limit as `nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader` prints them, and its maximum SM
    clock in Hz, from one nvidia-smi call."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    name, power, clock = (f.strip() for f in
                          out.stdout.strip().splitlines()[0].split(","))
    return f"{name}, {power}", float(clock.split()[0]) * 1e6


def gate_inputs(B, D, N, H, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    return tuple(torch.randn(*s, generator=g).to("cuda", dtype)
                 for s in ((B, N, H), (B, D, N), (H,), (H,)))


def pair_inputs(B, Na, Nb, H, dtype, seed=0, wide=False, w_scale=1.0):
    """(l1_a, l1_b, r, u, w2 * w_scale); with `wide`, l1 uniform in
    [-WIDE, WIDE], so the pre-activations reach +-100."""
    g = torch.Generator().manual_seed(seed)
    l1 = [torch.randn(B, n, H, generator=g) for n in (Na, Nb)]
    if wide:
        l1 = [(torch.rand(t.shape, generator=g) * 2 - 1) * WIDE for t in l1]
    r, u, w2 = (torch.randn(*s, generator=g) for s in ((B, Na, Nb), (H,),
                                                       (H,)))
    return tuple(t.to("cuda", dtype) for t in l1 + [r, u, w2 * w_scale])


def cuda_time_ms(fn, iters=20, warmup=3) -> float:
    """Device time per call. A spin kernel holds the stream while the
    calls are queued behind it, so the events time the device, not the
    host's launch rate."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(50_000_000)      # ~25 ms at 2 GHz
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def gate_bound_ms(B, Na, Nb, H, pair=False) -> float:
    """Least time for one fp32 silu launch: bytes moved (inputs read once,
    outputs written once) over HBM bandwidth vs the fp32 operations (per
    gate element: mul+add pre-activation, exp, add, divide, multiply for
    silu, mul+add accumulation = 8) over the fp32 peak. One direction:
    l1 [B,Nb,H], r [B,Na,Nb] -> [B,Na,Nb]; the pair adds l1_a [B,Na,H] and
    the second output, and doubles the gate elements."""
    dirs = 2 if pair else 1
    nbytes = 4 * (B * Nb * H + (pair and B * Na * H)
                  + (1 + dirs) * B * Na * Nb + 2 * H)
    ops = 8 * dirs * B * Na * Nb * H
    return max(nbytes / PEAK_BYTES_S, ops / PEAK_FP32_S) * 1e3


def sfu_floor_ms(B, Na, Nb, H, sms, clock_hz, pair=False) -> float:
    """Least time for one silu launch on the special-function units: two
    MUFU operations per gate element at MUFU_PER_CLK_SM per SM per clock,
    every SM at its maximum clock."""
    elems = (2 if pair else 1) * B * Na * Nb * H
    return elems * MUFU_PER_SILU / (MUFU_PER_CLK_SM * sms * clock_hz) * 1e3


def compare(got, want, dtype, what) -> float:
    """Hold a kernel output to its plain version; returns the max abs
    error."""
    check(got.dtype == dtype and got.shape == want.shape,
          f"{what} output dtype/shape")
    check(bool(torch.isfinite(got).all()), f"{what} finite")
    err = (got.float() - want.float()).abs()
    rel = (err / want.float().abs().clamp(min=1e-6)).max().item()
    atol, rtol = TOL[dtype]
    print(f"{what}: max_abs_err {err.max().item():.3e} max_rel_err "
          f"{rel:.3e} (atol {atol}, rtol {rtol})")
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)
    return err.max().item()


def check_kernels() -> float:
    """Phase 2: the edge-gate kernel against its plain version on the card.
    Returns the largest fp32 absolute error of the paired launch over the
    main-path shapes."""
    dtypes = (torch.float32, torch.bfloat16)
    cases = [(shape, dtype, act, False) for shape in PAIR_SHAPES + PAIR_EXTRA
             for dtype in dtypes for act in ("silu", "relu")]
    cases += [(shape, dtype, "silu", True) for shape in (PAIR_SHAPES[1],
                                                        PAIR_EXTRA[0])
              for dtype in dtypes]
    max_err_fp32 = 0.0
    for (name, B, Na, Nb, H, per_batch), dtype, act, wide in cases:
        # the wide case scales w2 by 1 / WIDE, so each term w2[h] * act(x)
        # and the outputs keep the main path's magnitude, which the fp32
        # tolerance is stated for
        args = pair_inputs(B, Na, Nb, H, dtype, wide=wide,
                           w_scale=1 / WIDE if wide else 1.0)
        got = edge_gate.phi_rank1_pair(*args, act=act)
        torch.cuda.synchronize()
        want = edge_gate.phi_rank1_pair_reference(*args, act=act)
        for d, g, w in zip(("ab", "ba"), got, want):
            err = compare(g, w, dtype,
                          f"edge_gate pair {name} [{B},{Na},{Nb},{H}] {d} "
                          f"{act} {str(dtype)[6:]}"
                          f"{' pre-activation +-100' if wide else ''}")
            if dtype == torch.float32 and per_batch and not wide:
                max_err_fp32 = max(max_err_fp32, err)
    # the same wide case with w2 unscaled: the kernel and the plain version
    # against a float64 evaluation
    l1_a, l1_b, r, u, w2 = pair_inputs(*PAIR_SHAPES[1][1:5], torch.float32,
                                       wide=True)
    got = edge_gate.phi_rank1_pair(l1_a, l1_b, r, u, w2)
    plain = edge_gate.phi_rank1_pair_reference(l1_a, l1_b, r, u, w2)
    l1_a, l1_b, r, u, w2 = (t.double() for t in (l1_a, l1_b, r, u, w2))
    exact = [torch.einsum("bdnh,h->bdn", torch.nn.functional.silu(
        l1[:, None] + rr[..., None] * u), w2)
        for l1, rr in ((l1_b, r), (l1_a, r.transpose(1, 2)))]
    check(all(bool(torch.isfinite(x).all()) for x in got),
          "edge_gate pair +-100 w2 unscaled: finite")
    errs = [max((a.double() - e).abs().max().item() for a, e in zip(x, exact))
            for x in (got, plain)]
    print(f"edge_gate pair {PAIR_SHAPES[1][0]} silu fp32 pre-activation "
          f"+-100, w2 unscaled, against float64: kernel max_abs_err "
          f"{errs[0]:.3e}, plain fp32 max_abs_err {errs[1]:.3e} (limit "
          f"{WIDE_ERR_RATIO} x plain)")
    check(errs[0] <= WIDE_ERR_RATIO * errs[1],
          f"edge_gate pair +-100 w2 unscaled: kernel error {errs[0]:.3e} vs "
          f"float64 above {WIDE_ERR_RATIO} x plain fp32's {errs[1]:.3e}")
    for name, B, D, N, H, _ in SINGLE_SHAPES + [RAGGED]:
        for dtype in dtypes:
            for act in ("silu", "relu"):
                args = gate_inputs(B, D, N, H, dtype)
                got = edge_gate.phi_rank1(*args, act=act)
                torch.cuda.synchronize()
                compare(got, edge_gate.phi_rank1_reference(*args, act=act),
                        dtype, f"edge_gate {name} [{B},{D},{N},{H}] {act} "
                        f"{str(dtype)[6:]}")
    # gradients: the autograd.Functions' backward vs autograd through the
    # plain versions
    args = [t.requires_grad_() for t in gate_inputs(2, 7, 11, 48,
                                                    torch.float32, seed=1)]
    g = torch.randn(2, 7, 11, device="cuda")
    got = torch.autograd.grad(edge_gate.phi_rank1(*args), args, g)
    want = torch.autograd.grad(edge_gate.phi_rank1_reference(*args), args, g)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-5)
    args = [t.requires_grad_() for t in pair_inputs(2, 7, 11, 48,
                                                    torch.float32, seed=1)]
    gs = (torch.randn(2, 7, 11, device="cuda"),
          torch.randn(2, 11, 7, device="cuda"))

    def pair_grad(fn):
        ab, ba = fn(*args)
        return torch.autograd.grad((ab * gs[0]).sum() + (ba * gs[1]).sum(),
                                   args)

    for a, b in zip(pair_grad(edge_gate.phi_rank1_pair),
                    pair_grad(edge_gate.phi_rank1_pair_reference)):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-5)
    print("edge_gate backward (one direction and pair) matches autograd "
          "through the plain version")
    return max_err_fp32


def make_requests(n: int, seed: int):
    """Synthetic raw requests: globular proteins of 200-500 residues (CA
    positions uniform in a ball of the size a real protein of that length
    has) with ESM-shaped features, and chain-like ligands of 20-48 atoms
    (1.5 A bonds) placed inside the protein, with LAS masks over 1- and
    2-hop neighbours."""
    rng = np.random.RandomState(seed)
    raws = []
    for _ in range(n):
        nr = int(rng.randint(200, 501))
        na = int(rng.randint(20, 49))
        radius = 2.2 * nr ** 0.38 * (5 / 3) ** 0.5
        v = rng.randn(nr, 3)
        v *= (radius * rng.rand(nr, 1) ** (1 / 3)) / np.linalg.norm(
            v, axis=1, keepdims=True)
        prot = (v + rng.randn(3) * 30).astype(np.float32)
        site = prot.mean(0) + rng.randn(3) * 0.3 * radius
        steps = rng.randn(na, 3)
        steps *= 1.5 / np.linalg.norm(steps, axis=1, keepdims=True)
        lig = np.cumsum(steps, axis=0)
        lig = (lig - lig.mean(0) + site).astype(np.float32)
        bonds = [(i, i + 1) for i in range(na - 1)]
        bonds += [(j, i) for i, j in bonds]
        las = np.abs(np.arange(na)[:, None] - np.arange(na)[None]) <= 2
        np.fill_diagonal(las, False)
        raws.append(dict(
            protein_xyz=prot,
            esm_feat=rng.randn(nr, 1280).astype(np.float32),
            lig_coords=lig, rdkit_coords=lig,
            lig_feats=rng.randn(na, 56).astype(np.float32),
            bond_edges=np.asarray(bonds), las_mask=las))
    return raws


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--profile", metavar="PATH",
                    help="write a torch.profiler table of one batch here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1

    # ---- 1. card and build
    card_line, clock_hz = card()
    print(card_line)
    kind = torch.cuda.get_device_name(0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}; {sms} SMs, max SM clock "
          f"{clock_hz / 1e6:.0f} MHz")
    t0 = time.perf_counter()
    build_all([edge_gate.KERNEL])
    print(f"kernel build: {time.perf_counter() - t0:.2f} s")
    for line in edge_gate.KERNEL.build_log.splitlines():
        if any(k in line for k in ("entry function", "registers", "spill")):
            print("ptxas:", line.strip())
    print_sass_mufu(edge_gate.KERNEL.lib_path)

    # ---- 2. kernels against their plain versions
    max_err = check_kernels()

    # ---- 3. the main path
    cfg = preset("fabind", **SMOKE_SHAPES)
    engine = DockingEngine(cfg, batch_size=BATCH, seed=0)
    raws = make_requests(N_REQUESTS, seed=0)
    n_batches = -(-N_REQUESTS // BATCH)
    edge_gate.KERNEL.launches = 0
    t0 = time.perf_counter()
    poses = engine.dock_raw(raws)
    first_s = time.perf_counter() - t0
    launches = edge_gate.KERNEL.launches
    print(f"dock_raw: {len(poses)} poses, first call {first_s:.3f} s, "
          f"edge_gate launches {launches}")
    check(len(poses) == N_REQUESTS, "one pose per request")
    for p, raw in zip(poses, raws):
        check(p.error is None, f"pose error {p.error}")
        check(p.coords.shape == raw["lig_coords"].shape, "pose shape")
        check(bool(np.isfinite(p.coords).all()), "finite pose")
    check(launches == GATE_LAUNCHES_PER_BATCH * n_batches,
          f"edge_gate launched {launches} times on the main path, expected "
          f"{GATE_LAUNCHES_PER_BATCH} per batch")
    print("pocket_truncated per request:", [p.pocket_truncated for p in poses])

    results = [None] * BATCH
    (chunk, batch, n_real), = list(engine.batches(raws[:BATCH], results))
    kernel_coords = engine.run_batch(batch)[0]
    # the same batch with the gate's plain version in place of the kernel
    orig = layers.phi_rank1_pair
    layers.phi_rank1_pair = edge_gate.phi_rank1_pair_reference
    try:
        plain_coords = engine.run_batch(batch)[0]
    finally:
        layers.phi_rank1_pair = orig
    diff = (kernel_coords - plain_coords).abs().max().item()
    print(f"dock batch, kernel vs plain gate: max coordinate difference "
          f"{diff:.3e} A (tolerance {POSE_TOL_A} A)")
    check(diff <= POSE_TOL_A, f"kernel vs plain pose difference {diff}")

    # ---- 4. times
    rows = []
    for name, B, Na, Nb, H, per_batch in PAIR_SHAPES:
        a = pair_inputs(B, Na, Nb, H, torch.float32)
        k_ms = cuda_time_ms(lambda: edge_gate.phi_rank1_pair(*a))
        p_ms = cuda_time_ms(lambda: edge_gate.phi_rank1_pair_reference(*a))
        b_ms = gate_bound_ms(B, Na, Nb, H, pair=True)
        f_ms = sfu_floor_ms(B, Na, Nb, H, sms, clock_hz, pair=True)
        rows.append((per_batch, k_ms, p_ms, b_ms, f_ms))
        print(f"time edge_gate pair {name} [{B},{Na},{Nb},{H}] fp32 silu: "
              f"kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, fp32 bound "
              f"{b_ms:.4f} ms, MUFU floor {f_ms:.4f} ms [{card_line}]")
    n = sum(r[0] for r in rows)
    k_ms, p_ms, b_ms, f_ms = (sum(r[0] * r[i] for r in rows) / n
                              for i in (1, 2, 3, 4))
    print(f"time edge_gate per main-path launch (mean over {n} launches of a "
          f"batch): kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, fp32 bound "
          f"{b_ms:.4f} ms, MUFU floor {f_ms:.4f} ms [{card_line}]")
    print(f"time edge_gate device time per batch ({n} launches): kernel "
          f"{k_ms * n:.4f} ms, MUFU floor {f_ms * n:.4f} ms [{card_line}]")
    for name, B, D, N, H, _ in SINGLE_SHAPES:
        a = gate_inputs(B, D, N, H, torch.float32)
        t_ms = cuda_time_ms(lambda: edge_gate.phi_rank1(*a))
        print(f"time edge_gate one direction {name} [{B},{D},{N},{H}] fp32 "
              f"silu: kernel {t_ms:.4f} ms, fp32 bound "
              f"{gate_bound_ms(B, D, N, H):.4f} ms, MUFU floor "
              f"{sfu_floor_ms(B, D, N, H, sms, clock_hz):.4f} ms "
              f"[{card_line}]")

    def sync_batch():
        engine.run_batch(batch)
        torch.cuda.synchronize()

    batch_s = []
    for _ in range(5):
        t0 = time.perf_counter()
        sync_batch()
        batch_s.append(time.perf_counter() - t0)
    e2e_s = []
    for _ in range(3):
        t0 = time.perf_counter()
        engine.dock_raw(raws)
        e2e_s.append(time.perf_counter() - t0)
    lat = statistics.median(batch_s)
    e2e = statistics.median(e2e_s)
    print(f"time model batch ({BATCH} complexes, device path): median "
          f"{lat * 1e3:.2f} ms of {[round(s * 1e3, 2) for s in batch_s]} "
          f"[{card_line}]")
    print(f"time dock_raw {N_REQUESTS} requests (featurize + collate + "
          f"model + unpack): median {e2e:.3f} s, "
          f"{N_REQUESTS / e2e:.2f} complexes/s [{card_line}]")
    print(f"peak device memory: "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    if args.profile:
        profile_batch(sync_batch, args.profile, lat * 1e3, card_line)

    print(json.dumps({"kernels": [{
        "name": "edge_gate", "route": "cuda",
        "source": "fabind_tpu_torch/csrc/edge_gate.cu",
        "replaces": "fabind_tpu/ops/pallas/edge_gate.py:63",
        "launches": launches, "max_abs_err": max_err,
        "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
        "bound_by": "operations", "library_ms": None}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


def print_sass_mufu(lib_path) -> None:
    """Special-function-unit instructions in each compiled variant of the
    kernel, counted in its SASS (cuobjdump -sass): the loop body of the
    silu pair variant evaluates 32 gate elements (4 h x 4 cells x 2
    directions), so 2 MUFU per element shows as 32 MUFU.EX2 and 32
    MUFU.RCP per copy of that body."""
    tool = Path(find_nvcc()).with_name("cuobjdump")
    out = subprocess.run([str(tool), "-sass", str(lib_path)],
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout
    fn = None
    counts = {}
    for line in out.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            counts[fn] = {}
        elif fn and "MUFU." in line:
            op = line.split("MUFU.")[1].split()[0].rstrip(";")
            counts[fn][op] = counts[fn].get(op, 0) + 1
    check(bool(counts), "cuobjdump found no kernel in the library")
    for fn, c in counts.items():
        print(f"sass {fn}: MUFU {dict(sorted(c.items())) or 'none'}")


def profile_batch(sync_batch, path: str, batch_ms: float,
                  card_line: str) -> None:
    """Device time by kernel over one docking batch, written to `path`, and
    a summary line: device busy time against the (unprofiled) median batch
    time, and the matrix products' share, FLOPs and rate."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 with_flops=True) as prof:
        sync_batch()
    events = prof.key_averages()
    table = events.table(sort_by="cuda_time_total", row_limit=40)
    out = Path(path)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(table)
    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and not e.is_user_annotation]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    gate_ms = sum(e.self_device_time_total for e in kernels
                  if "edge_gate_kernel" in e.key) / 1e3
    mm = [e for e in events if e.key in MATMUL_OPS]
    mm_ms = sum(e.self_device_time_total for e in mm) / 1e3
    mm_flop = sum(e.flops for e in mm)
    check(busy_ms > 0, "the profiler recorded no device time")
    print(f"profile one batch: device busy {busy_ms:.2f} ms of a "
          f"{batch_ms:.2f} ms batch (idle share "
          f"{max(0.0, 1 - busy_ms / batch_ms):.3f}); matmuls {mm_ms:.2f} ms "
          f"({mm_ms / busy_ms:.3f} of busy), {mm_flop / 1e12:.3f} TFLOP, "
          f"{mm_flop / mm_ms / 1e9:.1f} TFLOP/s; edge_gate {gate_ms:.2f} ms "
          f"({gate_ms / busy_ms:.3f} of busy) [{card_line}]")


if __name__ == "__main__":
    sys.exit(main())
