"""Drive the PyTorch port (fabind_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--profile PATH]

Phases, each of which raises on failure (non-zero exit):
  1. card and build: the card's name and power limit; every CUDA kernel of
     the port is compiled from the sources in this checkout (nvcc, sm_90a);
  2. each kernel against its plain PyTorch version on the card: the edge
     gate's paired launch (both attention directions) at every shape the two
     served buckets launch it with, in fp32 and bf16, a ragged pair, H = 100
     and pre-activations up to +-100 (with w2 unscaled, held to float64 no
     worse than the plain fp32 version); both activations and the
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
     and docking halves, host DBSCAN ms per pass, one best-of-40 batch;
  7. training through `cli.train.main` (preset `fabind` at released width,
     dropout 0.1, recycle counts drawn, batch 8, the same buckets; the 32
     requests written as an NPZ directory): two epochs with evaluation at
     stages 1 and 2 and checkpoints, a SIGTERM at step 3 and a resume whose
     steps equal the unbroken run's, bf16 and bf16 with remat runs, and a
     short `fabind_plus` run whose requests carry isomorphisms. Checks:
     finite losses and no skipped step, parameters moved, the gate launched
     once per attention layer of each forward (and again for each layer a
     remat backward recomputes; 33 per evaluation batch and stage, 0 for
     FABind+); and with the Trainer directly, a dropout-0 fp32 step with the
     kernel against one with the plain gate, a NaN batch leaving the
     parameters and the optimizer bit for bit, remat on and off with dropout
     on, bf16 within 10% of fp32. Times: train step ms per bucket (fp32,
     bf16, bf16 with remat), samples/s over an epoch, peak device memory,
     the phase's wall time;
  8. evaluation and confidence training, from phase 7's NPZ directory and
     runs: `cli.evaluate.main` of the fp32 base run over all 32 complexes at
     stages 2 and 1 (JAX's JSON keys, finite RMSDs, n = complexes less
     dropped, 33 gate launches per batch and stage), again with the plain
     gate (per-pdb RMSD within 0.01 A), with `--post-optim` (configuration
     loss not raised) and with `--distmap-dock` (5000 steps, 2 restarts, on
     one large-bucket batch: finite, the lowest-loss restart kept, the same
     seed bit-identical); a bf16 Trainer's evaluation bit-equal to the fp32
     model's forward on the fp32 batch; `cli.train_confidence.main` from the
     FABind+ run with each pose source (5 copies, one epoch of 16
     complexes: finite loss, the trunk bit-equal to the checkpoint, every
     ranking tensor but the score's bias moved, no trunk gradient, JAX's
     metric keys, no gate launch); `cli.sample.main` with the trained head
     (16 complexes x 8 passes: the JSON's n and sample_size, one file per
     pass with a line per complex, the same seed the same JSON). Times:
     evaluation complexes/s, ms per batch of --post-optim and
     --distmap-dock, confidence step ms and peak memory per pose source,
     cli.sample complexes/s, the phase's wall time.
The second-to-last line is a JSON object describing each kernel; the last is
{"ok": true, "device": {...}}. With --profile PATH, a torch.profiler table of
one bf16 docking batch of each bucket (device time by kernel) is written
beside PATH, the bucket in its name, for base and for FABind+, and one of a
training step (large bucket, fp32 and bf16).
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import io
import json
import os
import shutil
import signal
import statistics
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np
import torch

from fabind_tpu_torch.cli import evaluate as cli_evaluate
from fabind_tpu_torch.cli import sample as cli_sample
from fabind_tpu_torch.cli import train as cli_train
from fabind_tpu_torch.cli import train_confidence as cli_train_confidence
from fabind_tpu_torch.config import preset
from fabind_tpu_torch.data.batching import build_sample
from fabind_tpu_torch.data.buckets import (resolve_buckets, route_sample,
                                           sort_bucket_cfgs)
from fabind_tpu_torch.data.dataset import Loader, open_source
from fabind_tpu_torch.data.types import FABindBatch
from fabind_tpu_torch.models import layers
from fabind_tpu_torch.models.att_model import EfficientMCAttModel
from fabind_tpu_torch.models.fabind import init_params, make_model
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
from fabind_tpu_torch.train.checkpoints import (HEAD_PREFIXES,
                                                TrainCheckpointer,
                                                load_weights)
from fabind_tpu_torch.train.confidence import METRIC_KEYS
from fabind_tpu_torch.train.trainer import (Trainer, eval_forward,
                                            step_generator)

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
# training: epochs of each run, the step a SIGTERM arrives in, and where the
# NPZ directories and runs go (git-ignored)
TRAIN_EPOCHS = 2
STOP_AT_STEP = 3
TRAIN_ROOT = Path("build/chip_smoke_train")
# a dropout-0 fp32 step with the kernel vs with the plain gate: relative
# loss difference, and each gradient tensor's max difference over its max
# (floored, see grad_rel_err). On the H100 the loss came out bit-equal and
# the gradients 3.0e-6 apart; the gradient limit sits ~30x above that
TRAIN_LOSS_RTOL = 1e-5
TRAIN_GRAD_RTOL = 1e-4
# remat on vs off (dropout on): the forward is the same computation; the
# backward's scatter-adds may sum in another order
REMAT_LOSS_RTOL = 1e-6
REMAT_GRAD_RTOL = 1e-4
# the step after a resume vs the unbroken run's: the card's atomics make
# the two runs' parameters drift apart in the last bits
RESUME_LOSS_RTOL = 1e-3
# bf16 vs fp32 first-step loss (tests/test_train.py's bound)
BF16_LOSS_RTOL = 0.1
# evaluation and confidence (phase 8): the JAX evaluation CLI's JSON keys
# (pocket_truncated_residues_max only when a crop was truncated); the
# distance-map restarts (on one large-bucket batch); copies per complex in
# confidence training; complexes and passes of cli.sample
EVAL_KEYS = ({f"{p}_{s}" for p in ("rmsd", "centroid")
              for s in ("mean", "25", "50", "75", "lt2", "lt5")}
             | {"pocket_cls_accuracy", "pocket_center_avg_dist",
                "pocket_center_mae", "pocket_center_rmse",
                "pocket_center_dcc_lt4", "n", "pocket_truncated_samples",
                "complexes_per_sec", "n_dropped_oversize"})
DISTMAP_REPEATS = 2
CONF_COPIES = 5
N_SAMPLE = 16
SAMPLE_PASSES = 8
# the confidence score's output bias: a pure ranking loss sees score
# differences only, so its gradient is 0 and it need not move
SCORE_BIAS = "ranking_score_mlp.linear2.bias"


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def reset_peak() -> tuple:
    """Start a phase's peak-memory reading: run Python's cyclic collector
    (a deleted engine or trainer can sit in a reference cycle until it
    runs, and when it runs moves with every import), then zero the peak
    counter. Returns (bytes allocated now, which the peak includes; bytes
    the collection freed)."""
    before = torch.cuda.memory_allocated()
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    return held, before - held


def print_peak(what: str, held: tuple, card_line: str) -> None:
    print(f"peak device memory {what}: "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, of which "
          f"{held[0] / 2**30:.2f} GiB allocated when it began (after a "
          f"cyclic collection that freed {held[1] / 2**30:.2f} GiB) "
          f"[{card_line}]")


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


def gate_bound_ms(B, Na, Nb, H, elem_bytes=4) -> float:
    """Least time for one paired silu launch: bytes moved (inputs read
    once, outputs written once, `elem_bytes` per element: l1_a [B,Na,H],
    l1_b [B,Nb,H], r [B,Na,Nb], u, w2 [H] in; phi_ab, phi_ba out) over HBM
    bandwidth vs the fp32 operations (per gate element: mul+add
    pre-activation, exp, add, divide, multiply for silu, mul+add
    accumulation = 8, over 2 x B x Na x Nb x H elements; the kernel computes
    in fp32 for bf16 inputs too) over the fp32 peak."""
    nbytes = elem_bytes * (B * (Na + Nb) * H + 3 * B * Na * Nb + 2 * H)
    ops = 8 * 2 * B * Na * Nb * H
    return max(nbytes / PEAK_BYTES_S, ops / PEAK_FP32_S) * 1e3


def sfu_floor_ms(B, Na, Nb, H, sms, clock_hz) -> float:
    """Least time for one paired silu launch on the special-function units:
    two MUFU operations per gate element (2 x B x Na x Nb x H of them) at
    MUFU_PER_CLK_SM per SM per clock, every SM at its maximum clock."""
    elems = 2 * B * Na * Nb * H
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
    # gradients: the autograd.Function's backward vs autograd through the
    # plain version
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
    print("edge_gate pair backward matches autograd through the plain "
          "version")
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
    held = reset_peak()
    lat, syncs = time_engine(engine, batches, raws, "fabind_plus bf16",
                             card_line)
    print_peak("fabind_plus bf16 engine (timed batches and dock_raw)", held,
               card_line)
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


def write_npz_dir(raws, root: Path, isomorphisms: bool = False) -> str:
    """The requests as an NPZ training directory (r00.npz, ...); with
    `isomorphisms` each carries [identity, chain reversed], the automorphisms
    of its chain ligand."""
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    for i, raw in enumerate(raws):
        extra = {}
        if isomorphisms:
            n = raw["lig_coords"].shape[0]
            extra["isomorphisms"] = np.stack(
                [np.arange(n), np.arange(n)[::-1]]).astype(np.int32)
        np.savez(root / f"r{i:02d}.npz", **raw, **extra)
    return str(root)


class TrainProbe:
    """While open, records each Trainer.train_step (bucket, host seconds
    from a synchronized start to the metrics read back, gate launches, the
    launches its forward and backward should make, its recycle rounds) and
    each eval_step (stage, bucket, launches). The gate launches once per
    attention layer of every recycle round of the base model (the coord
    MLP has no dropout, so the JAX package's rule keeps the gate on in
    training), and once more per layer of a round that remat recomputes in
    the backward."""

    def __init__(self):
        self.steps, self.evals = [], []

    def __enter__(self):
        probe = self
        self.orig = (Trainer.train_step, Trainer.eval_step,
                     EfficientMCAttModel._step)

        def round_spy(model, *a, **kw):
            probe.rounds.append((model.gnn.n_layers, torch.is_grad_enabled(),
                                 model.n_iter))
            return probe.orig[2](model, *a, **kw)

        def train_step(tr, batch, bucket_cfg=None, **kw):
            probe.rounds = []
            torch.cuda.synchronize()
            before = edge_gate.KERNEL.launches
            t0 = time.perf_counter()
            m = probe.orig[0](tr, batch, bucket_cfg, **kw)
            sec = time.perf_counter() - t0
            mcfg = tr.cfg.model
            expected = 0 if mcfg.is_plus else sum(
                n * (1 + (mcfg.remat and grad)) for n, grad, _ in probe.rounds)
            probe.steps.append(dict(
                label=bucket_label(bucket_cfg.shapes), s=sec, metrics=m,
                launches=edge_gate.KERNEL.launches - before,
                expected=expected,
                recycles=sum(1 for _, _, n in probe.rounds
                             if n == mcfg.n_iter)))
            return m

        def eval_step(tr, batch, stage=2, bucket_cfg=None):
            before = edge_gate.KERNEL.launches
            out = probe.orig[1](tr, batch, stage, bucket_cfg)
            probe.evals.append(dict(stage=stage,
                                    label=bucket_label(bucket_cfg.shapes),
                                    launches=edge_gate.KERNEL.launches
                                    - before))
            return out

        Trainer.train_step, Trainer.eval_step = train_step, eval_step
        EfficientMCAttModel._step = round_spy
        return self

    def __exit__(self, *exc):
        (Trainer.train_step, Trainer.eval_step,
         EfficientMCAttModel._step) = self.orig

    def launches_by_bucket(self):
        out = {}
        for r in self.steps + self.evals:
            out[r["label"]] = out.get(r["label"], 0) + r["launches"]
        return out


def train_cli(data, out, *extra, preset_name="fabind", epochs=TRAIN_EPOCHS,
              on_step=None):
    """cli.train.main over `data` into `out` at released width and the
    phase-3 buckets, batch 8; must return 0."""
    argv = ["--preset", preset_name, "--data", data, "--output", str(out),
            "--epochs", str(epochs), "--batch-size", str(BATCH),
            "--buckets", BUCKETS, "--workers", "4", "--prefetch", "2",
            "--keep", "1", *extra]
    for k, v in SMOKE_SHAPES.items():
        argv += ["--set", f"{k}={v}"]
    rc = cli_train.main(argv, on_step=on_step)
    check(rc == 0, f"cli.train {' '.join(argv)} returned {rc}")


def check_steps(probe, what, eval_launches=33):
    """Every step finite and not skipped, its gate launches as expected,
    `eval_launches` per evaluation batch and stage."""
    check(bool(probe.steps), f"{what}: no train step ran")
    for i, r in enumerate(probe.steps):
        m = r["metrics"]
        check(m["skipped_nan"] == 0.0, f"{what} step {i}: skipped")
        check(all(np.isfinite(v) for v in m.values()),
              f"{what} step {i}: a metric is not finite: {m}")
        check(r["launches"] == r["expected"],
              f"{what} step {i}: {r['launches']} gate launches, expected "
              f"{r['expected']} ({r['recycles']} docking recycles)")
    for r in probe.evals:
        check(r["launches"] == eval_launches,
              f"{what} eval stage {r['stage']} bucket {r['label']}: "
              f"{r['launches']} gate launches, expected {eval_launches}")


def epoch_records(out):
    """The cli's per-epoch records (seconds, samples, samples_per_s)."""
    with open(Path(out) / "metrics.jsonl") as f:
        recs = [json.loads(line) for line in f]
    return [r for r in recs if r["phase"] == "epoch"]


def report_run(probe, out, what, card_line, serve_ms=None):
    """Step ms per bucket (median and range; recycle counts are drawn, so
    the range is wide) against the served batch of the same bucket, and
    the samples/s of each epoch."""
    for label in sorted({r["label"] for r in probe.steps}):
        rs = [r for r in probe.steps if r["label"] == label]
        ms = [r["s"] * 1e3 for r in rs]
        vs = ("" if not serve_ms or label not in serve_ms else
              f"; served bf16 batch of the bucket {serve_ms[label]:.2f} ms")
        print(f"time train step {what} bucket {label} ({len(ms)} steps of "
              f"{BATCH}): median {statistics.median(ms):.2f} ms, range "
              f"{min(ms):.2f}-{max(ms):.2f} ms, docking recycles "
              f"{[r['recycles'] for r in rs]}{vs} [{card_line}]")
    for r in epoch_records(out):
        print(f"time train epoch {what} {int(r['epoch'])}: {r['samples']} "
              f"samples in {r['seconds']:.3f} s, {r['samples_per_s']:.2f} "
              f"samples/s [{card_line}]")


def first_batch(data, cfg, buckets, label=None):
    """(batch on the card, bucket cfg) of the first training batch (of
    bucket `label`) of `data`."""
    src, names = open_source(data)
    loader = Loader(src, names, cfg, seed=cfg.train.seed, buckets=buckets)
    for arrays, meta in loader.epoch(0, with_meta=True):
        if label is None or bucket_label(meta["cfg"].shapes) == label:
            return FABindBatch.from_numpy(arrays, "cuda"), meta["cfg"]
    raise RuntimeError(f"no batch in bucket {label}")


def grads_of(trainer):
    return {n: p.grad.detach().clone()
            for n, p in trainer.model.named_parameters() if p.grad is not None}


def grad_rel_err(a, b):
    """(largest relative error, its tensor's name): over the gradient
    tensors, max|a - b| over the larger of max|b| and 1e-3 of the largest
    gradient anywhere (a tensor whose gradient is ~0 is held to the
    model's scale, not to its own rounding noise)."""
    check(set(a) == set(b), "the same gradient tensors")
    floor = 1e-3 * max(float(g.abs().max()) for g in b.values())
    errs = {n: float((a[n] - b[n]).abs().max())
            / max(float(b[n].abs().max()), floor) for n in b}
    name = max(errs, key=errs.get)
    return errs[name], name


def trainer_checks(data, buckets, card_line):
    """With the Trainer directly at released width: the kernel against the
    plain gate in a dropout-0 fp32 step; a NaN batch; remat on and off with
    dropout on."""
    cfg0 = preset("fabind", dropout=0.0, random_n_iter=False, stage_prob=0.0,
                  **SMOKE_SHAPES)
    model = make_model(cfg0)
    init_params(model, torch.Generator().manual_seed(0))
    sd = model.state_dict()
    batch, cfg_b = first_batch(data, cfg0, buckets,
                               bucket_label(buckets[-1]))
    tr = Trainer(cfg0, "cuda", state_dict=sd)
    edge_gate.KERNEL.launches = 0
    loss_k = float(tr._forward_loss(batch, cfg_b, step_generator(0, 0, "cuda"),
                                    None)["loss"].detach())
    torch.cuda.synchronize()
    launches = edge_gate.KERNEL.launches
    g_k = grads_of(tr)
    orig = layers.phi_rank1_pair
    layers.phi_rank1_pair = edge_gate.phi_rank1_pair_reference
    try:
        loss_p = float(tr._forward_loss(batch, cfg_b,
                                        step_generator(0, 0, "cuda"),
                                        None)["loss"].detach())
    finally:
        layers.phi_rank1_pair = orig
    err, worst = grad_rel_err(g_k, grads_of(tr))
    dl = abs(loss_k - loss_p) / abs(loss_p)
    print(f"train dropout-0 fp32 step bucket {bucket_label(cfg_b.shapes)}, "
          f"kernel vs plain gate: loss {loss_k:.6f} vs {loss_p:.6f} (rel "
          f"{dl:.3e}, limit {TRAIN_LOSS_RTOL}), gradients max rel err "
          f"{err:.3e} ({worst}; limit {TRAIN_GRAD_RTOL}); kernel launches "
          f"{launches} (forward; the backward is the plain VJP)")
    check(launches == 33, f"dropout-0 step launched the gate {launches} times")
    check(dl <= TRAIN_LOSS_RTOL and err <= TRAIN_GRAD_RTOL,
          "dropout-0 step: kernel vs plain gate")

    # a NaN batch changes nothing, on the card
    cfg = preset("fabind", **SMOKE_SHAPES)
    tr = Trainer(cfg, "cuda", state_dict=sd)
    check(tr.train_step(batch, cfg_b)["skipped_nan"] == 0.0, "a good step")
    before = tr.state_dict()
    bad = dataclasses.replace(batch, lig_coords=batch.lig_coords.clone())
    bad.lig_coords[0, 0, 0] = float("nan")
    m = tr.train_step(bad, cfg_b)
    after = tr.state_dict()
    same = (all(torch.equal(v, after["model"][k])
                for k, v in before["model"].items())
            and before["optimizer"]["updates"] == after["optimizer"]["updates"]
            and all(torch.equal(v, after["optimizer"]["opt"]["state"][i][k])
                    for i, st in before["optimizer"]["opt"]["state"].items()
                    for k, v in st.items()))
    print(f"train NaN batch: skipped_nan {m['skipped_nan']}, loss "
          f"{m['loss']}, parameters and optimizer state bit-identical {same}")
    check(m["skipped_nan"] == 1.0 and same, "NaN batch left the state as is")

    # remat on and off, dropout on, the same seeds
    res = {}
    for remat in (False, True):
        c = preset("fabind", remat=remat, **SMOKE_SHAPES)
        t = Trainer(c, "cuda", state_dict=sd)
        loss = float(t._forward_loss(batch, cfg_b,
                                     step_generator(5, 0, "cuda"),
                                     None)["loss"].detach())
        res[remat] = (loss, grads_of(t))
    dl = abs(res[True][0] - res[False][0]) / abs(res[False][0])
    err, worst = grad_rel_err(res[True][1], res[False][1])
    print(f"train remat on vs off (dropout 0.1, same seeds): loss "
          f"{res[True][0]:.6f} vs {res[False][0]:.6f} (rel {dl:.3e}, limit "
          f"{REMAT_LOSS_RTOL}), gradients max rel err {err:.3e} ({worst}; "
          f"limit {REMAT_GRAD_RTOL})")
    check(dl <= REMAT_LOSS_RTOL and err <= REMAT_GRAD_RTOL,
          "remat on vs off")


def profile_train(data, buckets, profile, card_line):
    """--profile: a torch.profiler table of one training step of the large
    bucket (dropout on), fp32 and bf16, beside PATH, against the median of
    three unprofiled runs of the same step (the same seeds, so the same
    recycle count)."""
    for what, kw in (("fp32", {}), ("bf16", {"bf16": True})):
        cfg = preset("fabind", **kw, **SMOKE_SHAPES)
        batch, cfg_b = first_batch(data, cfg, buckets,
                                   bucket_label(buckets[-1]))
        tr = Trainer(cfg, "cuda")

        def step():
            tr.step = 0
            tr.train_step(batch, cfg_b)

        with TrainProbe() as probe:
            for _ in range(4):
                step()
        ms = statistics.median(r["s"] * 1e3 for r in probe.steps[1:])
        out = Path(profile)
        out = out.with_name(f"{out.stem}_train_{what}{out.suffix}")
        profile_batch(step, str(out), ms,
                      f"train step {what} bucket {bucket_label(buckets[-1])} "
                      f"({probe.steps[0]['recycles']} docking recycles)",
                      card_line)


def params_moved(out, cfg) -> float:
    """Largest change of a weight between the seeded init and the run's
    latest checkpoint."""
    model = make_model(cfg)
    init_params(model, torch.Generator().manual_seed(cfg.train.seed))
    state, _ = TrainCheckpointer(str(Path(out) / "ckpt")).restore()
    return max(float((state["model"][k] - v).abs().max())
               for k, v in model.state_dict().items())


def train_phase(raws, card_line, serve_ms, profile=None):
    """Phase 7: training on the card through cli.train. Returns the gate
    launches by bucket of the fp32 and the bf16 run, by dtype."""
    t_phase = time.perf_counter()
    data = write_npz_dir(raws, TRAIN_ROOT / "data")
    cfg = preset("fabind", **SMOKE_SHAPES)
    buckets = resolve_buckets(BUCKETS, cfg)
    trainer_checks(data, buckets, card_line)
    if profile:
        profile_train(data, buckets, profile, card_line)

    # the main path: fp32, two epochs, evaluation at stages 1 and 2 after
    # each, checkpoints; the counts set to 0 just before, read just after
    out = TRAIN_ROOT / "fp32"
    shutil.rmtree(out, ignore_errors=True)
    held = reset_peak()
    with TrainProbe() as full:
        edge_gate.KERNEL.launches = 0
        train_cli(data, out)
        launches = edge_gate.KERNEL.launches
    peak = {"fp32": (torch.cuda.max_memory_allocated(), held)}
    check_steps(full, "fp32")
    check(launches == sum(full.launches_by_bucket().values()) > 0,
          f"fp32 training: gate launches {launches} outside the steps")
    moved = params_moved(out, cfg)
    check(moved > 0, "training moved the parameters")
    evals = {(r["stage"], r["label"]) for r in full.evals}
    check({s for s, _ in evals} == {1, 2}, "evaluation at stages 1 and 2")
    print(f"train fp32 {len(full.steps)} steps: gate launches {launches} "
          f"(train steps {sum(r['launches'] for r in full.steps)}, eval "
          f"{sum(r['launches'] for r in full.evals)} in {len(full.evals)} "
          f"batches), parameters moved up to {moved:.3e}; losses "
          f"{[round(r['metrics']['loss'], 3) for r in full.steps]}")
    report_run(full, out, "fp32", card_line)
    with open(out / "metrics.jsonl") as f:
        valid = [json.loads(line) for line in f]
    for r in valid:
        if r["phase"].startswith("valid_stage"):
            print(f"train eval {r['phase']} step {r['step']}: rmsd_mean "
                  f"{r['rmsd_mean']:.3f}, pocket_center_avg_dist "
                  f"{r['pocket_center_avg_dist']:.3f}, n {r['n']}")

    # preempted by SIGTERM in step 3, then resumed: the later steps are the
    # unbroken run's (same batches; losses within RESUME_LOSS_RTOL)
    out = TRAIN_ROOT / "resume"
    shutil.rmtree(out, ignore_errors=True)

    def stop(step, metrics, meta):
        if step == STOP_AT_STEP:
            os.kill(os.getpid(), signal.SIGTERM)

    train_cli(data, out, on_step=stop)
    ck = TrainCheckpointer(str(out / "ckpt"))
    check(ck.latest_step() == STOP_AT_STEP,
          f"preemption checkpoint at step {ck.latest_step()}")
    stop_meta = ck.restore()[1]
    resumed = {}
    train_cli(data, out, "--resume",
              on_step=lambda s, m, meta: resumed.setdefault(
                  s, (m, meta["pdb"])))
    unbroken = {i + 1: r["metrics"] for i, r in enumerate(full.steps)}
    check(sorted(resumed) == [s for s in sorted(unbroken)
                              if s > STOP_AT_STEP],
          f"resumed steps {sorted(resumed)}")
    worst = max(abs(m["loss"] - unbroken[s]["loss"]) / abs(unbroken[s]["loss"])
                for s, (m, _) in resumed.items())
    print(f"train SIGTERM at step {STOP_AT_STEP}, checkpoint meta "
          f"{stop_meta}, resumed steps {sorted(resumed)}: loss max rel "
          f"diff to the unbroken run {worst:.3e} (limit {RESUME_LOSS_RTOL})")
    check(worst <= RESUME_LOSS_RTOL, "resumed steps equal the unbroken run's")

    # bf16, and bf16 with remat: times and peak memory
    runs = {}
    for what, extra in (("bf16", ["--bf16"]),
                        ("bf16 remat", ["--bf16", "--remat"])):
        out = TRAIN_ROOT / what.replace(" ", "_")
        shutil.rmtree(out, ignore_errors=True)
        torch.cuda.empty_cache()
        held = reset_peak()
        with TrainProbe() as probe:
            edge_gate.KERNEL.launches = 0
            train_cli(data, out, "--eval-every", "0", *extra)
        peak[what] = (torch.cuda.max_memory_allocated(), held)
        check_steps(probe, what)
        report_run(probe, out, what, card_line, serve_ms)
        runs[what] = probe
    l16, l32 = (runs["bf16"].steps[0]["metrics"]["loss"],
                full.steps[0]["metrics"]["loss"])
    print(f"train bf16 vs fp32 first step loss {l16:.4f} vs {l32:.4f} (rel "
          f"{abs(l16 - l32) / abs(l32):.3e}, limit {BF16_LOSS_RTOL})")
    check(abs(l16 - l32) <= BF16_LOSS_RTOL * abs(l32), "bf16 loss vs fp32")
    for what, (top, held) in peak.items():
        print(f"peak device memory train {what} (two epochs, batch {BATCH}): "
              f"{top / 2**30:.2f} GiB, of which {held[0] / 2**30:.2f} GiB "
              f"allocated when it began (after a cyclic collection that "
              f"freed {held[1] / 2**30:.2f} GiB) [{card_line}]")

    # FABind+: a short bf16 run over requests with isomorphisms
    data_plus = write_npz_dir(raws, TRAIN_ROOT / "data_plus",
                              isomorphisms=True)
    out = TRAIN_ROOT / "plus"
    shutil.rmtree(out, ignore_errors=True)
    with TrainProbe() as probe:
        edge_gate.KERNEL.launches = 0
        train_cli(data_plus, out, "--bf16", preset_name="fabind_plus",
                  epochs=1)
    check_steps(probe, "fabind_plus", eval_launches=0)
    check(edge_gate.KERNEL.launches == 0, "fabind_plus launched the gate")
    moved = params_moved(out, preset("fabind_plus", **SMOKE_SHAPES))
    check(moved > 0, "fabind_plus training moved the parameters")
    print(f"train fabind_plus bf16 {len(probe.steps)} steps: losses "
          f"{[round(r['metrics']['loss'], 3) for r in probe.steps]}, gate "
          f"launches 0, parameters moved up to {moved:.3e}")
    report_run(probe, out, "fabind_plus bf16", card_line)
    print(f"time phase 7 (training) wall: {time.perf_counter() - t_phase:.1f} "
          f"s [{card_line}]")
    return {torch.float32: full.launches_by_bucket(),
            torch.bfloat16: runs["bf16"].launches_by_bucket()}


class EvalProbe:
    """While open, records cli.evaluate's calls: each evaluation forward
    (stage, bucket, gate launches, poses), each post-optimization (host ms
    from a synchronized start, the configuration loss of the batch before
    and after) and each distance-map docking (host ms, the kept poses,
    every restart's poses and final losses)."""

    def __init__(self):
        self.forwards, self.postopt, self.distmap = [], [], []

    def __enter__(self):
        probe = self
        self.orig = (cli_evaluate.eval_forward,
                     cli_evaluate.post_optimize_batch,
                     cli_evaluate.distance_dock_best_of)

        def forward(model, batch, stage, shapes):
            before = edge_gate.KERNEL.launches
            out = probe.orig[0](model, batch, stage, shapes)
            probe.forwards.append(dict(
                stage=stage, label=bucket_label(shapes),
                launches=edge_gate.KERNEL.launches - before,
                coords=(out.coords * batch.lig_mask[..., None]).cpu()))
            return out

        def postopt(coords, ref, las, mask, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            x, final = probe.orig[1](coords, ref, las, mask, **kw)
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
            ref_dis = pairwise_dist(ref, ref)
            before = configuration_loss(coords, ref_dis, las, mask).sum()
            probe.postopt.append(dict(s=sec, before=float(before),
                                      after=float(final.sum()),
                                      finite=bool(torch.isfinite(x).all())))
            return x, final

        def distmap(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            best, xs, losses = probe.orig[2](*a, **kw)
            torch.cuda.synchronize()
            probe.distmap.append(dict(s=time.perf_counter() - t0,
                                      best=best.cpu(), xs=xs.cpu(),
                                      losses=losses.cpu(), mask=a[4].cpu()))
            return best, xs, losses

        (cli_evaluate.eval_forward, cli_evaluate.post_optimize_batch,
         cli_evaluate.distance_dock_best_of) = forward, postopt, distmap
        return self

    def __exit__(self, *exc):
        (cli_evaluate.eval_forward, cli_evaluate.post_optimize_batch,
         cli_evaluate.distance_dock_best_of) = self.orig

    def launches_by_bucket(self):
        out = {}
        for r in self.forwards:
            out[r["label"]] = out.get(r["label"], 0) + r["launches"]
        return out


def evaluate_cli(ckpt, data, out, *extra):
    """cli.evaluate.main at released width over the phase-3 buckets, batch
    8; returns its metrics, checked for JAX's keys and finite RMSDs. The
    per-pdb RMSDs go to `out`.txt."""
    argv = ["--data", data, "--ckpt", ckpt, "--batch-size", str(BATCH),
            "--buckets", BUCKETS, "--workers", "4", "--prefetch", "2",
            "--save-rmsd", f"{out}.txt", "--out", f"{out}.json", *extra]
    for k, v in SMOKE_SHAPES.items():
        argv += ["--set", f"{k}={v}"]
    m = cli_evaluate.main(argv)
    keys = set(m)
    check(EVAL_KEYS <= keys <= EVAL_KEYS | {"pocket_truncated_residues_max"},
          f"cli.evaluate keys {sorted(keys ^ EVAL_KEYS)}")
    check(all(np.isfinite(r) for r in per_pdb(out).values()),
          "cli.evaluate: finite RMSDs")
    return m


def per_pdb(out) -> dict:
    """{pdb: rmsd} of a --save-rmsd file."""
    with open(f"{out}.txt") as f:
        return {p: float(r) for p, r in (line.split() for line in f)}


def large_bucket_names(raws, n):
    """The NPZ names (r00, ...) of the first n requests that route to the
    large bucket."""
    cfg = preset("fabind", **SMOKE_SHAPES)
    cfgs = sort_bucket_cfgs(cfg, resolve_buckets(BUCKETS, cfg))
    names = [f"r{i:02d}" for i, raw in enumerate(raws)
             if route_sample(build_sample(raw, cfg, group="test"), cfgs)
             is cfgs[-1]]
    check(len(names) >= n, f"{n} requests in the large bucket")
    return names[:n]


def eval_checks(raws, card_line):
    """Phase 8, evaluation: cli.evaluate of phase 7's fp32 base run at
    stages 2 and 1 (33 gate launches per batch and stage), against the same
    evaluation with the plain gate, with --post-optim and with
    --distmap-dock; the fault-1 repair. Returns the gate launches by bucket
    of the two evaluations with the kernel."""
    data = str(TRAIN_ROOT / "data")
    ckpt = str(TRAIN_ROOT / "fp32")
    out = TRAIN_ROOT / "eval"
    out.mkdir(exist_ok=True)
    # the main path: stage 2 then stage 1, the counts set to 0 just before
    # and read just after
    with EvalProbe() as probe:
        edge_gate.KERNEL.launches = 0
        m2 = evaluate_cli(ckpt, data, out / "stage2")
        m1 = evaluate_cli(ckpt, data, out / "stage1", "--stage", "1")
        launches = edge_gate.KERNEL.launches
    by_bucket = probe.launches_by_bucket()
    check(launches == sum(by_bucket.values()) > 0,
          f"evaluation: {launches} gate launches outside the forwards")
    for r in probe.forwards:
        check(r["launches"] == 33,
              f"evaluation stage {r['stage']} bucket {r['label']}: "
              f"{r['launches']} gate launches, expected 33")
    for m in (m2, m1):
        check(m["n"] == len(raws) - m["n_dropped_oversize"],
              f"evaluation n {m['n']} of {len(raws)} less "
              f"{m['n_dropped_oversize']} dropped")
    print(f"eval fp32 stage 2: rmsd_mean {m2['rmsd_mean']:.3f}, "
          f"pocket_center_avg_dist {m2['pocket_center_avg_dist']:.3f}, n "
          f"{m2['n']}; stage 1: rmsd_mean {m1['rmsd_mean']:.3f}; gate "
          f"launches {launches} in {len(probe.forwards)} forwards, by bucket "
          f"{by_bucket}")
    print(f"time eval fp32 stage 2 cli.evaluate {m2['n']} complexes (load + "
          f"featurize + model + metrics): {m2['complexes_per_sec']:.2f} "
          f"complexes/s; stage 1 {m1['complexes_per_sec']:.2f} complexes/s "
          f"[{card_line}]")

    # kernel against plain gate, per pdb (RMSDs as cli.evaluate writes them,
    # to 1e-6 A) and per atom
    kernel_poses = [r["coords"] for r in probe.forwards if r["stage"] == 2]
    orig = layers.phi_rank1_pair
    layers.phi_rank1_pair = edge_gate.phi_rank1_pair_reference
    try:
        with EvalProbe() as plain_probe:
            evaluate_cli(ckpt, data, out / "plain")
    finally:
        layers.phi_rank1_pair = orig
    check(all(r["launches"] == 0 for r in plain_probe.forwards),
          "the plain-gate evaluation launched the kernel")
    kern, plain = per_pdb(out / "stage2"), per_pdb(out / "plain")
    check(set(kern) == set(plain), "the same pdbs with the plain gate")
    diff = max(abs(kern[p] - plain[p]) for p in kern)
    d_atom = max(float((a - r["coords"]).abs().max())
                 for a, r in zip(kernel_poses, plain_probe.forwards))
    print(f"eval fp32 stage 2, kernel vs plain gate: per-pdb RMSD max "
          f"difference {diff:.3e} A (limit {POSE_TOL_A} A), max coordinate "
          f"difference {d_atom:.3e} A")
    check(diff <= POSE_TOL_A, f"evaluation kernel vs plain gate {diff} A")

    # --post-optim: not worse in configuration loss, batch by batch
    with EvalProbe() as probe:
        mp = evaluate_cli(ckpt, data, out / "postopt", "--post-optim")
    for r in probe.postopt:
        check(r["finite"] and r["after"] <= r["before"],
              f"--post-optim raised the configuration loss {r}")
    losses = [(round(r["before"], 1), round(r["after"], 1))
              for r in probe.postopt]
    print(f"eval --post-optim (1000 steps): configuration loss per batch "
          f"{losses}, rmsd_mean {m2['rmsd_mean']:.3f} -> "
          f"{mp['rmsd_mean']:.3f}")
    print(f"time eval --post-optim 1000 steps per batch of {BATCH}: median "
          f"{statistics.median(r['s'] for r in probe.postopt) * 1e3:.2f} ms "
          f"[{card_line}]")

    # --distmap-dock on one large-bucket batch, twice with the same seed
    index = out / "distmap_ids.txt"
    index.write_text("\n".join(large_bucket_names(raws, BATCH)) + "\n")
    runs = []
    for _ in range(2):
        with EvalProbe() as probe:
            md = evaluate_cli(ckpt, data, out / "distmap", "--distmap-dock",
                              "--distmap-repeats", str(DISTMAP_REPEATS),
                              "--unseen-index", str(index))
        runs.append(probe.distmap)
    for r in runs[0]:
        m = r["mask"][..., None]
        check(bool(torch.isfinite(r["best"] * m).all()),
              "--distmap-dock: finite poses")
        kept = r["xs"][r["losses"].argmin(0), torch.arange(BATCH)]
        check(torch.equal(kept, r["best"]),
              "--distmap-dock keeps each complex's lowest-loss restart")
    same = all(torch.equal(a["best"], b["best"])
               for a, b in zip(*runs)) and len(runs[0]) == len(runs[1])
    check(same, "--distmap-dock: the same seed, the same poses")
    final = runs[0][0]["losses"].numpy().round(2).tolist()
    print(f"eval --distmap-dock (5000 steps, {DISTMAP_REPEATS} restarts) on "
          f"{md['n']} complexes: rmsd_mean {md['rmsd_mean']:.3f}; final "
          f"losses per restart {final}; kept the lowest, the same seed "
          f"bit-identical")
    print(f"time eval --distmap-dock 5000 steps x {DISTMAP_REPEATS} restarts "
          f"per batch of {BATCH}: "
          f"{[round(r['s'] * 1e3, 2) for rs in runs for r in rs]} ms "
          f"[{card_line}]")

    # the fault-1 repair: a bf16 Trainer evaluates its float32 weights on
    # the float32 batch
    cfg = preset("fabind", **SMOKE_SHAPES)
    buckets = resolve_buckets(BUCKETS, cfg)
    sd = load_weights(ckpt)
    tr = Trainer(preset("fabind", bf16=True, **SMOKE_SHAPES), "cuda",
                 state_dict=sd)
    batch, cfg_b = first_batch(data, cfg, buckets, bucket_label(buckets[-1]))
    got = tr.eval_step(batch, 2, cfg_b)
    model = make_model(cfg)
    model.load_state_dict(sd)
    want = eval_forward(model.cuda(), batch, 2, cfg_b.shapes)
    equal = all(torch.equal(getattr(got, f), getattr(want, f))
                for f in ("coords", "y_pred", "pocket_coords"))
    model16, b16 = tr._compute(batch)
    old = eval_forward(model16, b16, 2, cfg_b.shapes)
    d_old = batch_dist(old.coords, want.coords, batch)
    print(f"eval bf16 Trainer.eval_step vs the fp32 model's forward on the "
          f"fp32 batch: bit-equal {equal} (the bfloat16 copy on the bf16 "
          f"batch, the path before the repair: per-atom mean "
          f"{d_old.mean():.3f} A)")
    check(equal and got.coords.dtype == torch.float32,
          "bf16 Trainer evaluates its float32 weights")
    del tr, model, model16
    return by_bucket


def confidence_checks(raws, card_line):
    """Phase 8, confidence training and sampling: cli.train_confidence from
    phase 7's FABind+ run with each pose source, then cli.sample with the
    trained head."""
    data = write_npz_dir(raws[:N_SAMPLE], TRAIN_ROOT / "data_conf",
                         isomorphisms=True)
    start = load_weights(str(TRAIN_ROOT / "plus"))
    cfg = preset("fabind_plus", confidence_training=True, **SMOKE_SHAPES)
    fresh = make_model(cfg)
    init_params(fresh, torch.Generator().manual_seed(cfg.train.seed))
    init = fresh.state_dict()
    for source in ("teacher", "inference"):
        out = TRAIN_ROOT / f"conf_{source}"
        shutil.rmtree(out, ignore_errors=True)
        seen, step_s = {}, []
        orig = (cli_train_confidence.build_confidence_optimizer,
                cli_train_confidence.make_confidence_train_step)

        def build(c, model):
            seen["model"] = model
            return orig[0](c, model)

        def make_step(*a, **kw):
            step = orig[1](*a, **kw)

            def timed(*sa, **skw):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                m = step(*sa, **skw)
                step_s.append(time.perf_counter() - t0)
                return m
            return timed

        (cli_train_confidence.build_confidence_optimizer,
         cli_train_confidence.make_confidence_train_step) = build, make_step
        torch.cuda.empty_cache()
        held = reset_peak()
        try:
            edge_gate.KERNEL.launches = 0
            argv = ["--data", data, "--output", str(out), "--init-ckpt",
                    str(TRAIN_ROOT / "plus"), "--epochs", "1", "--batch-size",
                    str(BATCH), "--num-copies", str(CONF_COPIES),
                    "--pose-source", source]
            for k, v in SMOKE_SHAPES.items():
                argv += ["--set", f"{k}={v}"]
            rc = cli_train_confidence.main(argv)
            launches = edge_gate.KERNEL.launches
        finally:
            (cli_train_confidence.build_confidence_optimizer,
             cli_train_confidence.make_confidence_train_step) = orig
        peak = torch.cuda.max_memory_allocated()
        check(rc == 0, f"cli.train_confidence {source} returned {rc}")
        check(launches == 0, f"confidence training launched the gate "
                             f"{launches} times")
        final = load_weights(str(out / "ckpt" / "params_epoch0"))
        trunk_same = all(torch.equal(v, start[k]) for k, v in final.items()
                         if not k.startswith(HEAD_PREFIXES))
        head_moved = all(not torch.equal(v, init[k])
                         for k, v in final.items()
                         if k.startswith(HEAD_PREFIXES) and k != SCORE_BIAS)
        no_grad = all(p.grad is None for n, p in
                      seen["model"].named_parameters()
                      if not n.startswith(HEAD_PREFIXES))
        check(trunk_same and head_moved and no_grad,
              f"confidence {source}: trunk as loaded {trunk_same}, head "
              f"moved {head_moved}, no trunk gradient {no_grad}")
        rec = [r for r in epoch_records(out)][-1]
        check(set(METRIC_KEYS) <= set(rec)
              and np.isfinite(rec["confidence_loss"]),
              f"confidence {source} log {rec}")
        print(f"confidence {source} ({len(step_s)} steps of {BATCH} x "
              f"{CONF_COPIES} copies): " + ", ".join(
                  f"{k} {rec[k]:.4f}" for k in METRIC_KEYS)
              + "; trunk bit-equal to the checkpoint, every ranking tensor "
              "but the score bias moved, no trunk gradient, gate launches 0")
        print(f"time confidence step {source} (batch {BATCH}, "
              f"{CONF_COPIES} copies): "
              f"{[round(x * 1e3, 2) for x in step_s]} ms; peak device memory "
              f"{peak / 2**30:.2f} GiB, of which {held[0] / 2**30:.2f} GiB "
              f"allocated when it began [{card_line}]")
        seen.clear()

    # cli.sample with the inference-source head, twice with one seed
    ckpt = str(TRAIN_ROOT / "conf_inference" / "ckpt" / "params_epoch0")
    res = []
    for i in range(2):
        rdir = TRAIN_ROOT / f"sample_{i}"
        shutil.rmtree(rdir, ignore_errors=True)
        argv = ["--ckpt", ckpt, "--data", data, "--sample-size",
                str(SAMPLE_PASSES), "--batch-size", str(BATCH), "--seed",
                str(SAMPLE_SEED), "--save-rmsd-dir", str(rdir)]
        for k, v in SMOKE_SHAPES.items():
            argv += ["--set", f"{k}={v}"]
        t0 = time.perf_counter()
        res.append((cli_sample.main(argv), time.perf_counter() - t0))
        files = sorted(os.listdir(rdir))
        check(files == sorted(f"epoch{s}_confidence.txt"
                              for s in range(SAMPLE_PASSES)),
              f"cli.sample files {files}")
        for f in files:
            check(len((rdir / f).read_text().splitlines()) == N_SAMPLE,
                  f"cli.sample {f}: one line per complex")
    (a, sa), (b, sb) = res
    check(a["n"] == N_SAMPLE and a["sample_size"] == SAMPLE_PASSES,
          f"cli.sample n {a['n']}, sample_size {a['sample_size']}")
    check(a == b, "cli.sample: the same seed, the same metrics")
    print(f"sample {N_SAMPLE} complexes x {SAMPLE_PASSES} passes: "
          f"rmsd_mean {a['rmsd_mean']:.3f}, rmsd_lt2 {a['rmsd_lt2']:.3f}; "
          f"the same seed the same JSON")
    print(f"time sample cli.sample {N_SAMPLE} complexes x {SAMPLE_PASSES} "
          f"passes (load + sampling + metrics): {N_SAMPLE / sa:.2f}, "
          f"{N_SAMPLE / sb:.2f} complexes/s [{card_line}]")


def eval_phase(raws, card_line):
    """Phase 8: evaluation and confidence training on the card, from phase
    7's NPZ directory and runs. Returns the evaluation's gate launches by
    bucket (fp32)."""
    t_phase = time.perf_counter()
    by_bucket = eval_checks(raws, card_line)
    confidence_checks(raws, card_line)
    shutil.rmtree(TRAIN_ROOT, ignore_errors=True)
    print(f"time phase 8 (evaluation, confidence) wall: "
          f"{time.perf_counter() - t_phase:.1f} s [{card_line}]")
    return {torch.float32: by_bucket}


def time_kernel_rows(served, max_err, launches, train_launches,
                     eval_launches, sms, clock_hz, card_line):
    """Kernel and plain times at each bucket's shapes, in each dtype: one
    JSON row per (dtype, bucket), means per launch weighted by the launches
    per batch, with the serving path's launch counts; and one per (dtype,
    bucket) of the training path and of the evaluation path (fp32 only;
    their batches have the served shapes), with their launch counts."""
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
                b_ms = gate_bound_ms(B, Na, Nb, H, elem_bytes=dtype.itemsize)
                f_ms = sfu_floor_ms(B, Na, Nb, H, sms, clock_hz)
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
            for path, counts in (("", launches), ("train ", train_launches),
                                 ("evaluate ", eval_launches)):
                if dtype not in counts:
                    continue
                rows.append({
                    "name": f"edge_gate {path}{tag} bucket {label}",
                    "route": "cuda",
                    "source": "fabind_tpu_torch/csrc/edge_gate.cu",
                    "replaces": "fabind_tpu/ops/pallas/edge_gate.py:63",
                    "launches": counts[dtype].get(label, 0),
                    "max_abs_err": max_err[(dtype, label)],
                    "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
                    "bound_by": "operations", "library_ms": None})
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--profile", metavar="PATH",
                    help="write a torch.profiler table of one bf16 batch "
                         "of each bucket, and of one training step in fp32 "
                         "and bf16, beside PATH")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    t_start = time.perf_counter()

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
    held = reset_peak()
    lat16, syncs = time_engine(engine, batches, raws, "bf16", card_line)
    print_peak("bf16 engine (timed batches and dock_raw)", held, card_line)
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
    held = reset_peak()
    time_engine(engine, batches, raws, "fp32", card_line)
    print_peak("fp32 engine (timed batches and dock_raw)", held, card_line)
    del engine, batches
    torch.cuda.empty_cache()

    # ---- 5. FABind+ and 6. best-of-N sampling
    plus_phase(raws, buckets, card_line, args.profile)
    torch.cuda.empty_cache()
    best_of_phase(raws, buckets, card_line)

    # ---- 7. training
    torch.cuda.empty_cache()
    train_launches = train_phase(raws, card_line, lat16, args.profile)

    # ---- 8. evaluation and confidence training, from phase 7's runs
    torch.cuda.empty_cache()
    eval_launches = eval_phase(raws, card_line)

    # ---- 4b. kernel times
    rows = time_kernel_rows(served, max_err, main_launches, train_launches,
                            eval_launches, sms, clock_hz, card_line)
    print(f"time chip_smoke total wall: {time.perf_counter() - t_start:.1f} s "
          f"[{card_line}]")
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
    """Device time by kernel over one batch (or training step), written to
    `path`, and a summary line: device busy time against the (unprofiled)
    median time, and the matrix products' share, FLOPs and rate."""
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
