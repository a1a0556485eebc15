"""Drive the PyTorch port (fabind_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--profile PATH]

Phases, each of which raises on failure (non-zero exit):
  1. card and build: the card's name and power limit; every CUDA kernel of
     the port is compiled from the sources in this checkout (nvcc, sm_90a);
  2. each kernel against its plain PyTorch version on the card: the edge
     gate's paired launch (both attention directions) at every shape the two
     served buckets launch it with, in fp32 and bf16, a ragged pair, H = 100
     and pre-activations up to +-100 (with w2 unscaled, held to float64 no
     worse than the plain fp32 version); its one-direction launch at the
     four one-direction shapes and a ragged one; both activations and both
     gradients at a small shape;
  3. the main path as it is deployed: `DockingEngine.dock_raw` at preset
     `fabind` full width, bf16, over two shape buckets, on 32 seeded
     synthetic requests (seeded random weights): one finite pose per request,
     at least 8 requests in each bucket, the gate launched 33 times per batch
     in each bucket; each bucket's first batch docked again with the plain
     gate; the same requests through an fp32 engine (bf16 vs fp32 per-atom
     difference; fp32 kernel vs plain gate); dock_screen against dock_raw,
     a second dock_raw with the protein cache warm, post-optimization, and an
     HTTP round trip through the serving daemon;
  4. times (CUDA events after warm-up): each kernel and its plain version
     beside its bound and its special-function-unit floor, the gate's device
     time per batch, and for the bf16 and the fp32 engine: warmup seconds,
     batch latency per bucket, dock_raw complexes/s and peak device memory;
  5. FABind+ (preset `fabind_plus`, released width: 5 layers, LayerNorm edge
     MLPs) served as base is, bf16 over the same buckets and requests: one
     finite pose per request and no edge-gate launch (the LayerNorm coord
     MLP never reaches the gate); its times, peak memory and warmup, and
     the distance to an fp32 FABind+ engine's poses, with and without the
     fp32 pocket center given to the bf16 engine (printed, not gated);
  6. best-of-N sampling (preset `fabind_plus_sampling`, bf16, stochastic
     pocket mode): `dock_best_of` of 16 requests at 8 passes returns each
     request's most confident pose, the same seed the same poses bit for
     bit and another seed other ones; without dropout, recycle draws and
     clustering every pass of a batch is the same pose; the post-optimized
     winner is float32 and finite, its configuration loss no higher than
     the unrefined winner's. Times: best-of-8
     complexes/s (and in the fixed pocket mode), ms per pass of the pocket
     and docking halves, host DBSCAN ms per pass, one best-of-40 batch.
The second-to-last line is a JSON object describing each kernel; the last is
{"ok": true, "device": {...}}. With --profile PATH, a torch.profiler table of
one bf16 docking batch of each bucket (device time by kernel) is written
beside PATH, the bucket in its name, for base and for FABind+.
"""
from __future__ import annotations

import argparse
import io
import json
import statistics
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np
import torch

from fabind_tpu_torch.config import preset
from fabind_tpu_torch.data.batching import build_sample
from fabind_tpu_torch.data.buckets import resolve_buckets, route_sample
from fabind_tpu_torch.models import layers
from fabind_tpu_torch.models.layers import dropout_rng
from fabind_tpu_torch.ops import edge_gate
from fabind_tpu_torch.ops.cuda_build import build_all, find_nvcc
from fabind_tpu_torch.ops.geometry import pairwise_dist
from fabind_tpu_torch.ops.gumbel import pocket_center_rounded
from fabind_tpu_torch.postopt import configuration_loss
from fabind_tpu_torch.sample import (dbscan_clusters, pass_generator,
                                     sample_poses)
from fabind_tpu_torch.serve import DockingEngine
from fabind_tpu_torch.serve_http import make_server

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
# the deployed configuration: two shape buckets (lig:pocket:protein), the
# larger equal to SMOKE_SHAPES; with REQUEST_SEED, 8 of the 32 requests go
# to the smaller one
BUCKETS = "32:128:384,48:160:512"
BATCH = 8
N_REQUESTS = 32
REQUEST_SEED = 22
MIN_PER_BUCKET = 8
N_SCREEN = 16
POSTOPT_STEPS = 20
DTYPES = (torch.bfloat16, torch.float32)
PAIR_EXTRA = [("ragged", 2, 7, 11, 48, 0), ("H=100", 2, 13, 21, 100, 0)]
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
# fp32 dock_raw with the kernel vs with the plain gate: max coordinate
# difference in Angstrom after 8 recycles x 4 layers
POSE_TOL_A = 1e-2
# bf16: the kernel and the plain gate round the same fp32 sum to bf16 and may
# land one step apart, which 32 layers carry on; mean per-atom distance
BF16_POSE_MEAN_TOL_A = 0.05
# bf16 vs fp32 engine, mean per-atom distance: the JAX package's own bound
# for its bf16 deployment (tests/test_golden_flagship.py)
BF16_VS_FP32_MEAN_TOL_A = 0.75
# aten ops that run the model's matrix products (profile summary)
MATMUL_OPS = ("aten::addmm", "aten::mm", "aten::bmm", "aten::baddbmm")
# best-of-N: passes and requests of the checked sampling path, the seed, and
# the passes of the one timed large batch
N_BEST_OF = 16
SAMPLES = 8
SAMPLE_SEED = 3
SAMPLES_LARGE = 40


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


def bucket_label(shapes) -> str:
    return f"{shapes.max_ligand}:{shapes.max_pocket}:{shapes.max_protein}"


def served_pair_shapes(cfg_b):
    """(name, B, Na, Nb, H, launches per batch) of the gate's paired
    launches in one batch of bucket cfg_b: the pocket stage over the whole
    protein, and every docking layer of every recycle over the pocket."""
    m, s = cfg_b.model, cfg_b.shapes
    return [("pocket lig-prot", BATCH, s.max_ligand, s.max_protein,
             m.pocket_pred_hidden_size,
             m.pocket_pred_layers * m.pocket_pred_n_iter),
            ("dock lig-pkt", BATCH, s.max_ligand, s.max_pocket,
             m.hidden_size, m.mean_layers * m.n_iter)]


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


def gate_bound_ms(B, Na, Nb, H, pair=False, elem_bytes=4) -> float:
    """Least time for one silu launch: bytes moved (inputs read once,
    outputs written once, `elem_bytes` per element) over HBM bandwidth vs
    the fp32 operations (per gate element: mul+add pre-activation, exp,
    add, divide, multiply for silu, mul+add accumulation = 8; the kernel
    computes in fp32 for bf16 inputs too) over the fp32 peak. One
    direction: l1 [B,Nb,H], r [B,Na,Nb] -> [B,Na,Nb]; the pair adds l1_a
    [B,Na,H] and the second output, and doubles the gate elements."""
    dirs = 2 if pair else 1
    nbytes = elem_bytes * (B * Nb * H + (pair and B * Na * H)
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


def check_kernels(served) -> dict:
    """Phase 2: the edge-gate kernel against its plain version on the card.
    `served` maps a bucket label to its served pair shapes. Returns the
    largest absolute error of the paired silu launch at each bucket's
    shapes, by (dtype, bucket label)."""
    max_err = {}
    cases = [(label, shape, dtype, act, False)
             for label, shapes in served.items() for shape in shapes
             for dtype in DTYPES for act in ("silu", "relu")]
    cases += [(None, shape, dtype, act, False) for shape in PAIR_EXTRA
              for dtype in DTYPES for act in ("silu", "relu")]
    dock = list(served.values())[-1][1]   # the largest docking shape
    cases += [(None, shape, dtype, "silu", True)
              for shape in (dock, PAIR_EXTRA[0]) for dtype in DTYPES]
    for label, (name, B, Na, Nb, H, _), dtype, act, wide in cases:
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
            if label is not None and act == "silu":
                key = (dtype, label)
                max_err[key] = max(max_err.get(key, 0.0), err)
    # the wide case with w2 unscaled: the kernel and the plain version
    # against a float64 evaluation
    l1_a, l1_b, r, u, w2 = pair_inputs(*dock[1:5], torch.float32, wide=True)
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
    print(f"edge_gate pair {dock[0]} silu fp32 pre-activation +-100, w2 "
          f"unscaled, against float64: kernel max_abs_err {errs[0]:.3e}, "
          f"plain fp32 max_abs_err {errs[1]:.3e} (limit {WIDE_ERR_RATIO} x "
          f"plain)")
    check(errs[0] <= WIDE_ERR_RATIO * errs[1],
          f"edge_gate pair +-100 w2 unscaled: kernel error {errs[0]:.3e} vs "
          f"float64 above {WIDE_ERR_RATIO} x plain fp32's {errs[1]:.3e}")
    for name, B, D, N, H, _ in SINGLE_SHAPES + [RAGGED]:
        for dtype in DTYPES:
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
    return max_err


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


class BucketLaunches:
    """Gate launches and batches per bucket while an engine serves: wraps
    the engine's run_batch and attributes the change of the kernel's own
    launch count across each call (the launches are made on the host inside
    the call) to the batch's bucket."""

    def __init__(self, engine):
        self.launches, self.batches = {}, {}
        run = engine.run_batch

        def counted(batch, cfg_b):
            before = edge_gate.KERNEL.launches
            out = run(batch, cfg_b)
            label = bucket_label(cfg_b.shapes)
            self.launches[label] = (self.launches.get(label, 0)
                                    + edge_gate.KERNEL.launches - before)
            self.batches[label] = self.batches.get(label, 0) + 1
            return out

        engine.run_batch = counted


def check_poses(poses, raws, what):
    check(len(poses) == len(raws), f"{what}: one pose per request")
    for p, raw in zip(poses, raws):
        check(p.error is None, f"{what}: pose error {p.error}")
        check(p.coords.shape == raw["lig_coords"].shape, f"{what}: shape")
        check(p.coords.dtype == np.float32, f"{what}: float32 coords")
        check(bool(np.isfinite(p.coords).all()), f"{what}: finite pose")


def pose_dist(a_poses, b_poses) -> np.ndarray:
    """Per-atom distances between two pose lists of the same requests."""
    return np.concatenate([np.linalg.norm(a.coords - b.coords, axis=-1)
                           for a, b in zip(a_poses, b_poses)])


def batch_dist(a, b, batch) -> np.ndarray:
    """Per-atom distances between two [B, Nc, 3] batch outputs over the
    batch's real atoms."""
    m = batch.lig_mask & batch.sample_valid[:, None]
    return (a.float() - b.float()).norm(dim=-1)[m].cpu().numpy()


def first_batches(engine, by_bucket):
    """One device batch per bucket: (label, cfg_b, batch), built from that
    bucket's first BATCH requests."""
    out = []
    for label, raws in by_bucket.items():
        (_, cfg_b, batch, _), = list(engine.batches(raws[:BATCH],
                                                    [None] * BATCH))
        out.append((label, cfg_b, batch))
    return out


def run_plain_gate(engine, batch, cfg_b):
    """One batch with the gate's plain version in place of the kernel."""
    orig = layers.phi_rank1_pair
    layers.phi_rank1_pair = edge_gate.phi_rank1_pair_reference
    try:
        return engine.run_batch(batch, cfg_b)
    finally:
        layers.phi_rank1_pair = orig


def serve_main_path(engine, raws, what, per_batch=None):
    """dock_raw of every request with the counts set to 0 just before and
    read just after: (poses, BucketLaunches, total launches, seconds).
    `per_batch` is the gate launches a batch must make (default: the base
    model's, one per attention layer of each stage and recycle)."""
    counter = BucketLaunches(engine)
    edge_gate.KERNEL.launches = 0
    t0 = time.perf_counter()
    poses = engine.dock_raw(raws)
    first_s = time.perf_counter() - t0
    launches = edge_gate.KERNEL.launches
    print(f"{what} dock_raw: {len(poses)} poses, first call {first_s:.3f} s, "
          f"edge_gate launches {launches}, by bucket "
          f"{counter.launches} in batches {counter.batches}")
    check_poses(poses, raws, what)
    check(sum(counter.launches.values()) == launches,
          f"{what}: launches outside the batches")
    if per_batch is None:
        per_batch = sum(s[-1] for s in served_pair_shapes(engine.cfg))
    for label, n in counter.launches.items():
        check(n == per_batch * counter.batches[label],
              f"{what}: bucket {label} launched the gate {n} times in "
              f"{counter.batches[label]} batches, expected {per_batch} per "
              f"batch")
    del engine.run_batch             # back to the class's method
    return poses, counter, launches, first_s


def time_engine(engine, batches, raws, what, card_line):
    """Batch latency per bucket (host clock around work that ends in
    synchronize) and dock_raw complexes/s; returns {label: median ms} and
    one sync_batch callable per label."""
    lat, syncs = {}, {}
    for label, cfg_b, batch in batches:
        def sync_batch(batch=batch, cfg_b=cfg_b):
            engine.run_batch(batch, cfg_b)
            torch.cuda.synchronize()

        sync_batch()
        batch_s = []
        for _ in range(5):
            t0 = time.perf_counter()
            sync_batch()
            batch_s.append(time.perf_counter() - t0)
        lat[label], syncs[label] = statistics.median(batch_s) * 1e3, \
            sync_batch
        print(f"time {what} model batch bucket {label} ({BATCH} complexes, "
              f"device path): median {lat[label]:.2f} ms of "
              f"{[round(s * 1e3, 2) for s in batch_s]} [{card_line}]")
    e2e_s = []
    for _ in range(3):
        t0 = time.perf_counter()
        engine.dock_raw(raws)
        e2e_s.append(time.perf_counter() - t0)
    e2e = statistics.median(e2e_s)
    print(f"time {what} dock_raw {len(raws)} requests (featurize + collate "
          f"+ model + unpack, protein cache warm): median {e2e:.3f} s, "
          f"{len(raws) / e2e:.2f} complexes/s [{card_line}]")
    return lat, syncs


def http_round_trip(engine, raws):
    """The serving daemon on 127.0.0.1 in a thread: /health, then /dock_raw
    with the npz of `raws`; its poses must equal engine.dock_raw's."""
    srv = make_server(engine, "127.0.0.1", 0)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        with urllib.request.urlopen(base + "/health", timeout=60) as r:
            health = json.loads(r.read())
        check(health["status"] == "ok" and health["bf16"] is True,
              f"/health {health}")
        buf = io.BytesIO()
        np.savez(buf, **{f"r{i}_{k}": v for i, raw in enumerate(raws)
                         for k, v in raw.items()})
        req = urllib.request.Request(
            base + "/dock_raw", data=buf.getvalue(), method="POST",
            headers={"Content-Type": "application/octet-stream"})
        with urllib.request.urlopen(req, timeout=300) as r:
            got = json.loads(r.read())
    finally:
        srv.shutdown()
        srv.server_close()
        t.join(timeout=60)
    check(not t.is_alive(), "HTTP server thread stopped")
    want = engine.dock_raw(raws)
    check(len(got) == len(want), "HTTP: one pose per request")
    for g, w in zip(got, want):
        check(g["error"] is None and w.error is None, "HTTP pose error")
        check(np.array_equal(np.asarray(g["coords"], np.float32), w.coords),
              "HTTP poses equal engine.dock_raw's")
    print(f"http: /health {health}; /dock_raw {len(got)} poses equal "
          f"engine.dock_raw's")


def pocket_center(engine, batch, cfg_b):
    """The served pocket center of each sample of a batch: the rounded
    sigmoid center of the pocket stage's logits."""
    m = engine.cfg.model
    with torch.inference_mode():
        _, _, cls, _ = engine.model._pocket_pred(batch, cfg_b.shapes)
        return pocket_center_rounded(cls, batch.prot_xyz, batch.prot_mask,
                                     m.gs_tau, m.gs_hard)


def explain_bf16_gap(engine16, engine32, b16, b32, cfg_b, label, what=""):
    """Where the bf16-vs-fp32 pose difference comes from, on one batch:
    the distance between the two engines' pocket centers, and the per-atom
    pose distance with each engine's own center and with the bf16 engine
    given the fp32 engine's center."""
    c16, c32 = (pocket_center(e, b, cfg_b)
                for e, b in ((engine16, b16), (engine32, b32)))
    x32 = engine32.run_batch(b32, cfg_b)[0]
    x16 = engine16.run_batch(b16, cfg_b)[0]
    with torch.inference_mode():
        x16c = engine16.model.inference_diag(
            b16, center_override=c32.to(torch.bfloat16),
            shapes=cfg_b.shapes)[0]
    dc = (c16.float() - c32).norm(dim=-1)[b32.sample_valid].cpu().numpy()
    own, held = (batch_dist(x, x32, b32) for x in (x16, x16c))
    print(f"{what}bf16 vs fp32 batch bucket {label}: pocket centers apart "
          f"mean {dc.mean():.3f} A, max {dc.max():.3f} A; per-atom pose "
          f"distance mean {own.mean():.3f} A with the bf16 center, "
          f"{held.mean():.3f} A with the fp32 center")


def check_postopt(engine, batch, run, what="post-optimization"):
    """post_optim_steps on one batch, whose poses `run()` gives: finite
    poses, and the configuration loss (fp32, over the real samples) not
    higher than without it. Returns the post-optimized poses."""
    coords0 = run()
    engine.post_optim_steps = POSTOPT_STEPS
    try:
        coords1 = run()
    finally:
        engine.post_optim_steps = 0
    check(bool(torch.isfinite(coords1).all()), f"{what}: poses finite")
    ref = batch.lig_rdkit_coords.float()
    valid = batch.sample_valid
    loss0, loss1 = (configuration_loss(c.float(), pairwise_dist(ref, ref),
                                       batch.las_adj, batch.lig_mask)[valid]
                    .sum().item() for c in (coords0, coords1))
    print(f"{what} ({POSTOPT_STEPS} Adam steps, "
          f"{str(coords1.dtype)[6:]}): configuration loss {loss0:.2f} -> "
          f"{loss1:.2f}")
    check(loss1 <= loss0, f"{what} raised the loss {loss0} -> {loss1}")
    return coords1


def route(engine, raws):
    """{bucket label: the requests that route there} for `engine`."""
    out = {bucket_label(c.shapes): [] for c in engine.bucket_cfgs}
    for raw in raws:
        c = route_sample(build_sample(raw, engine.cfg, group="test"),
                         engine.bucket_cfgs)
        out[bucket_label(c.shapes)].append(raw)
    return out


def profile_engine(syncs, lat, profile, what, card_line):
    """profile_batch for each bucket's batch, the bucket and `what` in the
    table's file name."""
    for label, sync in syncs.items():
        out = Path(profile)
        out = out.with_name(f"{out.stem}{what}_{label.replace(':', '-')}"
                            f"{out.suffix}")
        profile_batch(sync, str(out), lat[label],
                      f"{what.strip('_')} bucket {label}".strip(), card_line)


def plus_phase(raws, buckets, card_line, profile):
    """FABind+ served as deployed (bf16, the base phase's buckets and
    requests), no edge-gate launch on its path, its times; then an fp32
    FABind+ engine on the same requests."""
    cfg = preset("fabind_plus", **SMOKE_SHAPES)
    engine = DockingEngine(cfg, buckets=buckets, batch_size=BATCH, seed=0)
    warm = engine.warmup()
    print(f"time fabind_plus bf16 warmup ({len(buckets)} buckets): "
          f"{warm:.3f} s [{card_line}]")
    by_bucket = route(engine, raws)
    print("fabind_plus requests per bucket:",
          {k: len(v) for k, v in by_bucket.items()})
    # the counts go to 0 just before the FABind+ path and are read just
    # after: its LayerNorm coord MLP must never reach the edge gate
    poses, counter, launches, _ = serve_main_path(engine, raws,
                                                  "fabind_plus bf16",
                                                  per_batch=0)
    check(launches == 0, f"fabind_plus launched the edge gate {launches} "
                         f"times")
    check(all(counter.batches.get(k, 0) > 0 for k in by_bucket),
          f"fabind_plus served every bucket: {counter.batches}")
    print("fabind_plus pocket_truncated per request:",
          [p.pocket_truncated for p in poses])
    print("fabind_plus confidence per request (no confidence head):",
          sorted({p.confidence for p in poses}))
    batches = first_batches(engine, {k: v for k, v in by_bucket.items()
                                     if v})
    torch.cuda.reset_peak_memory_stats()
    lat, syncs = time_engine(engine, batches, raws, "fabind_plus bf16",
                             card_line)
    print(f"peak device memory fabind_plus bf16 engine (timed batches and "
          f"dock_raw): {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
          f"[{card_line}]")
    if profile:
        profile_engine(syncs, lat, profile, "_plus", card_line)
    del syncs

    engine32 = DockingEngine(cfg, buckets=buckets, batch_size=BATCH,
                             bf16=False, seed=0)
    poses32 = engine32.dock_raw(raws)
    check_poses(poses32, raws, "fabind_plus fp32")
    d = pose_dist(poses, poses32)
    print(f"fabind_plus bf16 vs fp32 engine, {len(d)} atoms: per-atom "
          f"distance mean {d.mean():.3f} A, max {d.max():.3f} A (not gated)")
    batches32 = first_batches(engine32, {label: by_bucket[label]
                                         for label, _, _ in batches})
    for (label, cfg_b, b16), (_, _, b32) in zip(batches, batches32):
        explain_bf16_gap(engine, engine32, b16, b32, cfg_b, label,
                         "fabind_plus ")


def time_best_of(engine, raws, samples, what, card_line, calls=1):
    """dock_best_of of `raws` at `samples` passes, `calls` times; returns
    the poses of the first call."""
    secs, first = [], None
    for _ in range(calls):
        t0 = time.perf_counter()
        poses = engine.dock_best_of(raws, sample_size=samples,
                                    seed=SAMPLE_SEED)
        secs.append(time.perf_counter() - t0)
        first = first or poses
    sec = statistics.median(secs)
    print(f"time {what} best-of-{samples} dock_best_of {len(raws)} requests "
          f"(featurize + collate + sampling + unpack): median {sec:.3f} s of "
          f"{[round(x, 3) for x in secs]}, {len(raws) / sec:.2f} complexes/s "
          f"[{card_line}]")
    return first


def time_sampling_pass(engine, batch, cfg_b, card_line):
    """Host-clock ms of the pocket half and the docking half of SAMPLES
    stochastic passes over one batch (each ends in synchronize), and of the
    host DBSCAN over each pass's pocket logits."""
    m, shapes = engine.cfg.model, cfg_b.shapes
    xyz = batch.prot_xyz.float().cpu().numpy()
    mask = batch.prot_mask.cpu().numpy()
    pocket_ms, dock_ms, dbscan_ms, n_clusters = [], [], [], []
    for s in range(SAMPLES):
        g = pass_generator(SAMPLE_SEED, 0, s, "cuda")
        with torch.inference_mode():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with dropout_rng(g):
                pocket = engine.model._pocket_pred(batch, shapes)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            probs = 1.0 / (1.0 + np.exp(-pocket[2].float().cpu().numpy()))
            t2 = time.perf_counter()
            clusters = dbscan_clusters(probs, xyz, mask, m.dbscan_eps,
                                       m.dbscan_min_samples)
            t3 = time.perf_counter()
            torch.cuda.synchronize()
            t4 = time.perf_counter()
            with dropout_rng(g):
                engine.model.inference_diag(batch, shapes=shapes,
                                            pocket=pocket)
            torch.cuda.synchronize()
            t5 = time.perf_counter()
        pocket_ms.append((t1 - t0) * 1e3)
        dbscan_ms.append((t3 - t2) * 1e3)
        dock_ms.append((t5 - t4) * 1e3)
        n_clusters.append(sum(len(c) for c in clusters))
    print(f"time best-of-N pass, batch of {BATCH} bucket "
          f"{bucket_label(shapes)} ({SAMPLES} passes): pocket half median "
          f"{statistics.median(pocket_ms):.2f} ms, docking half median "
          f"{statistics.median(dock_ms):.2f} ms (of "
          f"{[round(x, 1) for x in dock_ms]}: recycle counts are drawn per "
          f"pass), host DBSCAN median {statistics.median(dbscan_ms):.2f} ms "
          f"(clusters per batch {n_clusters}) [{card_line}]")


def best_of_phase(raws, buckets, card_line):
    """Best-of-N sampling as deployed (bf16, stochastic pocket mode, DBSCAN
    centers): checks, then times."""
    cfg = preset("fabind_plus_sampling", **SMOKE_SHAPES)
    engine = DockingEngine(cfg, buckets=buckets, batch_size=BATCH, seed=0)
    engine.warmup()
    rs = raws[:N_BEST_OF]
    edge_gate.KERNEL.launches = 0
    poses = time_best_of(engine, rs, SAMPLES, "bf16 stochastic", card_line)
    check(edge_gate.KERNEL.launches == 0,
          f"best-of-N launched the edge gate {edge_gate.KERNEL.launches} "
          f"times")
    check_poses(poses, rs, "best-of-N")
    # each request's confidence is the largest of its passes' scores
    n_checked = 0
    for bi, (chunk, cfg_b, batch, n_real) in enumerate(
            engine.batches(rs, [None] * len(rs))):
        _, scores = sample_poses(engine.model, batch, cfg_b, SAMPLES,
                                 seed=SAMPLE_SEED, batch_idx=bi)
        best = scores.float().max(0).values.cpu()
        for b in range(n_real):
            pos, _ = chunk[b]
            check(poses[pos].confidence == float(best[b]),
                  f"best-of-N confidence {poses[pos].confidence} is not the "
                  f"largest of its {SAMPLES} scores {float(best[b])}")
            n_checked += 1
    check(n_checked == len(rs), "best-of-N: every request checked")
    again = time_best_of(engine, rs, SAMPLES, "bf16 stochastic", card_line,
                         calls=2)
    d = pose_dist(again, poses)
    check(d.max() == 0.0, f"best-of-N same seed: max distance {d.max()}")
    other = engine.dock_best_of(rs, sample_size=SAMPLES,
                                seed=SAMPLE_SEED + 1)
    d_other = pose_dist(other, poses)
    check(d_other.max() > 0.0, "best-of-N another seed: other poses")
    print(f"best-of-{SAMPLES}, {len(rs)} requests: confidence = max of the "
          f"passes' scores for all {n_checked}; same seed bit-identical; "
          f"another seed per-atom distance mean {d_other.mean():.3f} A")
    # one full batch of the large bucket for the per-pass split and the
    # best-of-40 batch
    large = route(engine, raws)[bucket_label(buckets[-1])][:BATCH]
    check(len(large) == BATCH, "a full batch for best-of-40")
    (_, cfg_b, batch), = first_batches(engine, {"large": large})
    time_sampling_pass(engine, batch, cfg_b, card_line)
    # the winner is refined in float32 whatever the model's dtype
    win = check_postopt(engine, batch, lambda: engine._best_of_batch(
        batch, cfg_b, SAMPLES, SAMPLE_SEED, 0)[0],
        f"best-of-{SAMPLES} winner post-optimization")
    check(win.dtype == torch.float32,
          f"best-of-N winner post-optimized in {win.dtype}")
    time_best_of(engine, large, SAMPLES_LARGE, "bf16 stochastic", card_line)
    del engine
    torch.cuda.empty_cache()

    fixed = DockingEngine(preset("fabind_plus_sampling",
                                 sampling_pocket_mode="fixed",
                                 **SMOKE_SHAPES),
                          buckets=buckets, batch_size=BATCH, seed=0)
    fixed.warmup()
    poses_fixed = time_best_of(fixed, rs, SAMPLES, "bf16 fixed", card_line,
                               calls=2)
    check_poses(poses_fixed, rs, "best-of-N fixed pocket mode")
    del fixed

    # deterministic passes: no dropout, the full recycle count, no DBSCAN
    det = DockingEngine(preset("fabind_plus_sampling", dropout=0.0,
                               random_n_iter=False, use_clustering=False,
                               **SMOKE_SHAPES),
                        buckets=buckets, batch_size=BATCH, seed=0)
    (_, cfg_b, batch), = first_batches(det, {"large": large})
    coords, scores = sample_poses(det.model, batch, cfg_b, SAMPLES,
                                  seed=SAMPLE_SEED)
    check(torch.equal(coords, coords[:1].expand_as(coords))
          and torch.equal(scores, scores[:1].expand_as(scores)),
          "best-of-N without dropout, recycle draws and clustering: every "
          "pass the same pose")
    print(f"best-of-{SAMPLES} without dropout, recycle draws and "
          f"clustering: all passes of a batch equal bit for bit")
    del det
    torch.cuda.empty_cache()


def time_kernel_rows(served, max_err, launches, sms, clock_hz, card_line):
    """Kernel and plain times at each bucket's shapes, in each dtype: one
    JSON row per (dtype, bucket), means per launch weighted by the launches
    per batch, with this run's launch counts."""
    rows = []
    for dtype in DTYPES:
        tag = str(dtype)[6:]
        for label, shapes in served.items():
            per = []
            for name, B, Na, Nb, H, per_batch in shapes:
                a = pair_inputs(B, Na, Nb, H, dtype)
                k_ms = cuda_time_ms(lambda: edge_gate.phi_rank1_pair(*a))
                p_ms = cuda_time_ms(
                    lambda: edge_gate.phi_rank1_pair_reference(*a))
                b_ms = gate_bound_ms(B, Na, Nb, H, pair=True,
                                     elem_bytes=dtype.itemsize)
                f_ms = sfu_floor_ms(B, Na, Nb, H, sms, clock_hz, pair=True)
                per.append((per_batch, k_ms, p_ms, b_ms, f_ms))
                print(f"time edge_gate pair {name} [{B},{Na},{Nb},{H}] "
                      f"{tag} silu (bucket {label}): kernel {k_ms:.4f} ms, "
                      f"plain {p_ms:.4f} ms, bound {b_ms:.4f} ms, MUFU "
                      f"floor {f_ms:.4f} ms [{card_line}]")
            n = sum(r[0] for r in per)
            k_ms, p_ms, b_ms, f_ms = (sum(r[0] * r[i] for r in per) / n
                                      for i in (1, 2, 3, 4))
            print(f"time edge_gate {tag} bucket {label} per main-path launch "
                  f"(mean over {n} launches of a batch): kernel "
                  f"{k_ms:.4f} ms, plain {p_ms:.4f} ms, bound {b_ms:.4f} ms, "
                  f"MUFU floor {f_ms:.4f} ms; device time per batch "
                  f"{k_ms * n:.4f} ms [{card_line}]")
            rows.append({
                "name": f"edge_gate {tag} bucket {label}", "route": "cuda",
                "source": "fabind_tpu_torch/csrc/edge_gate.cu",
                "replaces": "fabind_tpu/ops/pallas/edge_gate.py:63",
                "launches": launches[dtype].get(label, 0),
                "max_abs_err": max_err[(dtype, label)],
                "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
                "bound_by": "operations", "library_ms": None})
    for name, B, D, N, H, _ in SINGLE_SHAPES:
        a = gate_inputs(B, D, N, H, torch.float32)
        t_ms = cuda_time_ms(lambda: edge_gate.phi_rank1(*a))
        print(f"time edge_gate one direction {name} [{B},{D},{N},{H}] fp32 "
              f"silu: kernel {t_ms:.4f} ms, fp32 bound "
              f"{gate_bound_ms(B, D, N, H):.4f} ms, MUFU floor "
              f"{sfu_floor_ms(B, D, N, H, sms, clock_hz):.4f} ms "
              f"[{card_line}]")
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--profile", metavar="PATH",
                    help="write a torch.profiler table of one bf16 batch "
                         "of each bucket beside PATH")
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

    # ---- 2. kernels against their plain versions, at every served shape
    cfg = preset("fabind", **SMOKE_SHAPES)
    buckets = resolve_buckets(BUCKETS, cfg)
    served = {bucket_label(s): served_pair_shapes(cfg.replace(shapes=s))
              for s in buckets}
    max_err = check_kernels(served)

    # ---- 3. the main path as deployed: bf16, two buckets
    raws = make_requests(N_REQUESTS, seed=REQUEST_SEED)
    engine = DockingEngine(cfg, buckets=buckets, batch_size=BATCH, seed=0)
    warm = {"bf16": engine.warmup()}
    print(f"time bf16 warmup ({len(buckets)} buckets): {warm['bf16']:.3f} s "
          f"[{card_line}]")
    by_bucket = route(engine, raws)
    print("requests per bucket:", {k: len(v) for k, v in by_bucket.items()})
    for label, rs in by_bucket.items():
        check(len(rs) >= MIN_PER_BUCKET,
              f"bucket {label} serves {len(rs)} < {MIN_PER_BUCKET} requests")
    poses, counter, launches, _ = serve_main_path(engine, raws, "bf16")
    main_launches = {torch.bfloat16: counter.launches}
    print("pocket_truncated per request:", [p.pocket_truncated for p in poses])

    batches = first_batches(engine, by_bucket)
    for label, cfg_b, batch in batches:
        kernel = engine.run_batch(batch, cfg_b)[0]
        plain = run_plain_gate(engine, batch, cfg_b)[0]
        d = batch_dist(kernel, plain, batch)
        print(f"bf16 batch bucket {label}, kernel vs plain gate: per-atom "
              f"distance mean {d.mean():.3e} A, max {d.max():.3e} A "
              f"(mean limit {BF16_POSE_MEAN_TOL_A} A)")
        check(d.mean() <= BF16_POSE_MEAN_TOL_A,
              f"bf16 kernel vs plain gate mean {d.mean()} A")

    # dock_screen: one protein, N_SCREEN ligands, against dock_raw
    protein = {k: raws[0][k] for k in ("protein_xyz", "esm_feat")}
    ligs = [{k: v for k, v in r.items() if k not in protein}
            for r in raws[:N_SCREEN]]
    screened = engine.dock_screen(protein, ligs)
    direct = engine.dock_raw([dict(lig, **protein) for lig in ligs])
    check_poses(screened, ligs, "dock_screen")
    d = pose_dist(screened, direct)
    print(f"dock_screen {N_SCREEN} ligands vs dock_raw: max per-atom "
          f"distance {d.max():.3e} A")
    check(d.max() == 0.0, "dock_screen equals dock_raw")

    # the protein cache: a second call, every protein row a hit
    again = engine.dock_raw(raws)
    d = pose_dist(again, poses)
    print(f"dock_raw again (protein cache warm, {len(engine._dev_prot_rows)} "
          f"rows): max per-atom distance to the first call {d.max():.3e} A")
    check(d.max() == 0.0, "protein cache bit-identical")

    _, cfg_b, batch = batches[-1]
    check_postopt(engine, batch, lambda: engine.run_batch(batch, cfg_b)[0])
    http_round_trip(engine, raws[:BATCH])

    # ---- 4a. times, bf16 engine
    torch.cuda.reset_peak_memory_stats()
    lat16, syncs = time_engine(engine, batches, raws, "bf16", card_line)
    print(f"peak device memory bf16 engine (timed batches and dock_raw): "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
          f"[{card_line}]")
    if args.profile:
        profile_engine(syncs, lat16, args.profile, "", card_line)
    del syncs

    # ---- 3b. the same requests through an fp32 engine
    engine32 = DockingEngine(cfg, buckets=buckets, batch_size=BATCH,
                             bf16=False, seed=0)
    warm["fp32"] = engine32.warmup()
    print(f"time fp32 warmup ({len(buckets)} buckets): {warm['fp32']:.3f} s "
          f"[{card_line}]")
    poses32, counter, _, _ = serve_main_path(engine32, raws, "fp32")
    main_launches[torch.float32] = counter.launches
    d = pose_dist(poses, poses32)
    print(f"bf16 vs fp32 engine, {len(d)} atoms: per-atom distance mean "
          f"{d.mean():.3f} A, max {d.max():.3f} A (mean limit "
          f"{BF16_VS_FP32_MEAN_TOL_A} A)")
    check(d.mean() < BF16_VS_FP32_MEAN_TOL_A, f"bf16 vs fp32 mean {d.mean()}")
    batches32 = first_batches(engine32, by_bucket)
    for (label, cfg_b, b16), (_, _, b32) in zip(batches, batches32):
        explain_bf16_gap(engine, engine32, b16, b32, cfg_b, label)
    del engine, batches
    torch.cuda.empty_cache()
    engine, batches = engine32, batches32
    label, cfg_b, batch = batches[-1]
    diff = (engine.run_batch(batch, cfg_b)[0]
            - run_plain_gate(engine, batch, cfg_b)[0]).abs().max().item()
    print(f"fp32 batch bucket {label}, kernel vs plain gate: max coordinate "
          f"difference {diff:.3e} A (tolerance {POSE_TOL_A} A)")
    check(diff <= POSE_TOL_A, f"kernel vs plain pose difference {diff}")
    torch.cuda.reset_peak_memory_stats()
    time_engine(engine, batches, raws, "fp32", card_line)
    print(f"peak device memory fp32 engine (timed batches and dock_raw): "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
          f"[{card_line}]")
    del engine, batches
    torch.cuda.empty_cache()

    # ---- 5. FABind+ and 6. best-of-N sampling
    plus_phase(raws, buckets, card_line, args.profile)
    torch.cuda.empty_cache()
    best_of_phase(raws, buckets, card_line)

    # ---- 4b. kernel times
    rows = time_kernel_rows(served, max_err, main_launches, sms, clock_hz,
                            card_line)
    print(json.dumps({"kernels": rows}))
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


def profile_batch(sync_batch, path: str, batch_ms: float, what: str,
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
    print(f"profile one batch {what}: device busy {busy_ms:.2f} ms of a "
          f"{batch_ms:.2f} ms batch (idle share "
          f"{max(0.0, 1 - busy_ms / batch_ms):.3f}); matmuls {mm_ms:.2f} ms "
          f"({mm_ms / busy_ms:.3f} of busy), {mm_flop / 1e12:.3f} TFLOP, "
          f"{mm_flop / mm_ms / 1e9:.1f} TFLOP/s; edge_gate {gate_ms:.2f} ms "
          f"({gate_ms / busy_ms:.3f} of busy) [{card_line}]")


if __name__ == "__main__":
    sys.exit(main())
