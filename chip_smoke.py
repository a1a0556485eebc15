"""Drive the PyTorch port (fabind_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--profile PATH]

Phases, each of which raises on failure (non-zero exit):
  1. card and build: the card's name and power limit; every CUDA kernel of
     the port (edge_gate.cu, dropout.cu) is compiled from the sources in
     this checkout (nvcc, sm_90a, one process per source, in parallel),
     then the host batch packer (collate.cc, the host C++ compiler);
  2. each kernel against its plain PyTorch version on the card: the edge
     gate's paired launch (both attention directions) at every shape the two
     served buckets launch it with, in fp32 and bf16, a ragged pair, H = 100
     and pre-activations up to +-100 (with w2 unscaled, held to float64 no
     worse than the plain fp32 version); both activations and the
     gradients at a small shape. The dropout kernel bit for bit (mask and
     values) at the largest dropout shape of each bucket's FABind+
     sampling pass and a ragged one, fp32 and bf16, rates 0.1 and 0.5; the
     plain version on the CPU on a copy draws the same; Random123's
     Philox4x32-10 known answers through the library's test entry; the
     backward equal to grad x mask x scale;
  3. the main path as it is deployed: `DockingEngine.dock_raw` at preset
     `fabind` full width, bf16, over two shape buckets, on 32 seeded
     synthetic requests (seeded random weights): one finite pose per request,
     at least 8 requests in each bucket, the gate launched 33 times per batch
     in each bucket, every batch after warm-up a replay of its bucket's
     docking graphs (fabind_tpu_torch/graphs.py) and the same requests
     docked eagerly equal to the graphed poses bit for bit (bf16 and fp32);
     each bucket's first batch docked again (eagerly) with the plain
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
     bit and another seed other ones; after a warm call of one pass a
     batch every dock half replays its bucket's stochastic docking graphs
     (no capture, none eager) and equals the eager dock halves' poses bit
     for bit; without dropout, recycle draws and
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
     bf16, bf16 with remat), dropout launches per step, samples/s over an
     epoch, peak device memory, the phase's wall time;
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
     cli.sample complexes/s, the phase's wall time;
  9. structure files: phase 3's 32 requests written as PDB files (a seeded
     sequence, N/CA/C/O per residue) and V2000 SDF files (C/N/O/S heavy
     atoms, one or two rings, explicit H); the ESM2 t33 encoder at full
     width (650M parameters, seeded random weights) embeds their sequences
     on the card in fp32 (finite [len, 1280]; two sequences against the
     same weights on the CPU; one alone against it in a batch);
     `DockingEngine.dock_sdf` (bf16, phase 3's buckets) on the 32 pairs:
     one finite pose per request, 33 gate launches per batch, poses equal
     to dock_raw on the raws it built, a second call without an ESM2
     forward, randomize_init seeded, kernel vs plain gate within phase 3's
     bound; `/dock_sdf` through the daemon (its sdf field parsed back
     within 1e-4 A of the pose, a ligand path refused); `cli.inference
     --ligand-sdf-dir` and `cli.preprocess` esm and inference in process
     with an encoder cut to 2 layers (full width) saved as a state dict:
     the SDFs and index against an in-process engine, the .npy files equal
     to embed_sequences, the NPZ directory read back and docked. Times:
     ESM2 ms per batch of 4 per padded length and TFLOP/s, sequences/s,
     dock_sdf complexes/s cold (ESM2 included) and warm, peak memory, the
     phase's wall time;
 10. exported serving: phase 3's seeded weights written as a state dict
     and exported through `cli.export.main` in process on the card (bf16,
     phase 3's two buckets), while two processes of their own export the
     small bucket on the CPU and FABind+ (phase 5's weights, small bucket)
     on the card; `DockingEngine.from_exported` (no model built) serves
     the 32 requests: poses, confidence and pocket_truncated equal to
     phase 3's live bf16 dock_raw bit for bit, the gate launched 33 times
     per batch by the programs, the protein cache warm and dock_screen
     equal to dock_raw, dock_best_of refused; the exported FABind+ equal
     to phase 5's poses with no launch; the CPU-exported artifact served
     on the card by a `cli.serve --exported` daemon process, its
     /dock_raw equal to the card-exported engine's; `cli.selftest --bf16
     --train --prod` returns 0. Times: export seconds and bytes per
     bucket, load seconds, warmup, batch latency and dock_raw complexes/s
     of a live and of the exported engine, peak memory, the phase's wall
     time. Every process it starts is stopped before it returns;
 11. the processed PDBbind store: the 32 requests written in the
     reference's layout by the port's own writers (protein, compound and
     ESM2 LMDB stores through the pure-Python codec, compound_rdkit_coords.pt,
     data.pt through save_frame: 24 train, 4 valid and 4 test rows and three
     rows the split filters drop; three all-carbon ligands, two chains and a
     tert-butyl, have non-trivial automorphism groups; an unseen-id file).
     Checks: `splits` of both presets; base `cli.train.main` from data.pt
     (fp32, one epoch with evaluation: finite, no skipped step, the gate
     launches TrainProbe expects); `cli.evaluate.main --split test
     --unseen-index` at stages 2 and 1 (33 launches per batch and stage);
     `cli.preprocess inject-iso` (data_new.pt: identity first, every
     automorphism maps labels and bonds onto themselves); `cli.preprocess
     pdbbind --isomorphisms` and a FABind+ Loader epoch over the store
     bit-equal to one over the NPZ directory (seed 0, workers 4); a bf16
     FABind+ epoch from data_new.pt (iso_mask rows with more than one true
     entry, no gate launch); `cli.preprocess esm --lmdb` with an encoder of
     phase 9's CLIs (2 layers at full width, seeded; each row equal to
     embed_sequences). Times: the store's
     write, ms per source.get against ms per NPZ load, Loader samples/s
     over both, inject-iso ms per complex, train step ms and samples/s,
     evaluation complexes/s, the phase's wall time;
 12. exported best-of-N sampling: phase 6's seeded weights exported by
     `cli.export --sampling` (bf16, stochastic pocket mode, the small
     bucket; the large one is cut for time) on the card, in a process of
     its own started before phase 7 so that it runs beside phases 7-11.
     `from_exported` serves phase 3's 8 small-bucket requests at best-of-8,
     seed 3: poses and confidences equal to the live bf16 engine's
     dock_best_of bit for bit; another seed other poses; dropout launches
     equal to what the site list and the drawn recycle counts predict
     (exported and live), 0 gate launches; the largest tensor a pass drops
     out has phase 2's shape; `/dock_best_of` of a `cli.serve --exported`
     daemon process equals the engine (phase 10 checks that an artifact
     without --sampling still refuses). Times: export seconds and bytes,
     load seconds, ms per pocket and dock half (live with int counts, live
     with tensor counts and exported), best-of-8 complexes/s live and
     exported, the dropout kernel's ms per launch beside its bound, its
     plain version and torch.rand + torch.where, the phase's wall time;
 13. flexible docking (preset `fabflex`: the pocket residues move with the
     ligand across recycles) on phase 3's seeded weights (the same
     parameter tree), bf16 and fp32 over phase 3's buckets and 32
     requests: one finite pose and one finite docked pocket per request
     (a residue index per coordinate row), the gate launched 33 times per
     batch in each bucket, the fp32 pocket moved from its input crop, at
     n_iter=1 the rigid engine's ligand within 1e-5 A (fp32),
     dock_screen equal to dock_raw, a `/dock_raw` round trip through the
     daemon with the same pocket fields and 33 launches per batch. The
     small bucket exported by `cli.export --preset fabflex` on the card in
     a process of its own started before phase 7; `from_exported` serves
     its 8 requests equal to live bit for bit, pockets included, with 33
     launches per batch; `cli.selftest --preset fabflex --bf16 --train
     --prod`. Times: batch latency per bucket and complexes/s in turns
     with a base engine of the same weights, the gate's ms per batch,
     bf16 vs fp32 ligand and pocket distances (printed, not gated),
     export and load seconds, peak memory, the phase's wall time;
 14. data parallelism, with two parts sharing the one card (cuda:0 twice:
     the dp logic with the real kernels, not a dp speed, and no NCCL):
     the row-mapped dropout kernel at each bucket's sampling shape (odd
     elements per row) bit-equal to the unmapped global mask's rows and
     to its plain version; cli.train's rank worker in two gloo ranks
     (parallel.dp.launch; fabind fp32, TF32 off, global batch 8, two steps
     at dropout 0 and two at 0.1) against one Trainer on the interleaved
     rank batches: the ranks' metrics equal, losses within 1e-4, the
     parameters after two updates within 2e-6 at the median and 2 x the
     two updates' lr everywhere, gate launches per rank step 1 + 4 x the
     drawn count, dropout launches per rank step the one-process step's
     (all row-mapped); a two-replica DockingEngine (device=(cuda:0,
     cuda:0)) over the 32 requests in bf16 and fp32, 33 gate launches per
     replica block, fp32 poses within 1e-3 A of phase 3's (bf16 printed),
     each replica's protein cache filled; best-of-8 with two replicas
     over the small bucket's 8 requests (winners equal to one replica's
     printed; replica 0's launches unmapped, replica 1's row-mapped); two
     ESM2 replicas (2 of 33 layers) against one within 1e-3. Times: the
     mapped kernel at the half batch beside the unmapped one, its plain
     version, torch.rand + torch.where and its bound; one against two
     replicas in turns (batch ms, dock_raw complexes/s), best-of-8
     complexes/s, the ranks' launch seconds, the phase's wall time;
 15. the ablation and extra configurations of preset `fabind` at released
     width (ABLATION_CONFIGS: keep_trig_attn, both no-attention stacks,
     the implicit pair embedding without the cross attention layer, no
     pair bias, opm, use_esm2_feat=False and esm2_concat_raw, the last two
     on the 32 requests with seeded N/C/O around each CA), each served by
     a bf16 and an fp32 engine of seeded weights over the 32 requests:
     one finite pose per request, the gate launched 33 times per batch (0
     for the no-attention stacks), each bucket's first batch again with
     the plain gate (phase 3's bounds); one fp32 Trainer step per EGNN
     stack type at dropout 0.1 (keep_trig_attn, ablation_no_attention,
     ablation_no_attention_with_cross_attn): finite, not skipped, gate and
     dropout launches as the modules predict (DropoutDraws); the
     keep_trig_attn and ablation_no_attention artifacts, exported through
     `cli.export --set` (bf16, small bucket, on the card) by processes of
     their own started before phase 7, served by `from_exported` on the
     small bucket's 8 requests: poses bit-equal to the live bf16 engine's,
     the gate launched 33 and 0 times per batch. Printed: batch ms per
     bucket, bf16 vs fp32 distance, peak memory, export and load seconds,
     the phase's wall time;
 16. host collation: the native batch packer (csrc/collate.cc, built in
     phase 1 with the host C++ compiler) against the python collator,
     field by field (bond_idx as per-row sets under the mask, bond_mask by
     row sums), on every batch of 8 of phase 3's 32 requests as the engine
     routes them and of the requests as NPZ training samples (group train,
     no isomorphisms); host ms per batch of 8 of both collators, per bucket
     and source (median and range of 20 repeats); one batch per bucket
     that collate_native built, served by a bf16 engine of phase 3's
     seeded weights: poses bit-equal to the collate batch's, the gate
     launched 33 times. Printed: the phase's wall time.
The second-to-last line is a JSON object describing each kernel; the last is
{"ok": true, "device": {...}}. With --profile PATH, a torch.profiler table of
one bf16 docking batch of each bucket (device time by kernel) is written
beside PATH, the bucket in its name, for base and for FABind+, one of a
training step (large bucket, fp32 and bf16), and one of an ESM2 forward
(batch 4 x 512).
"""
from __future__ import annotations

import argparse
import contextlib
import csv
import dataclasses
import gc
import io
import json
import os
import pickle
import shutil
import signal
import socket
import statistics
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
import zlib
from pathlib import Path

import numpy as np
import torch

from fabind_tpu_torch.cli import evaluate as cli_evaluate
from fabind_tpu_torch.cli import export as cli_export
from fabind_tpu_torch.cli import inference as cli_inference
from fabind_tpu_torch.cli import preprocess as cli_preprocess
from fabind_tpu_torch.cli import sample as cli_sample
from fabind_tpu_torch.cli import selftest as cli_selftest
from fabind_tpu_torch.cli import train as cli_train
from fabind_tpu_torch.cli import train_confidence as cli_train_confidence
from fabind_tpu_torch.config import ShapeConfig, preset
from fabind_tpu_torch.data.batching import build_sample, collate
from fabind_tpu_torch.data.buckets import (resolve_buckets, route_sample,
                                           sort_bucket_cfgs)
from fabind_tpu_torch.data.dataset import (Loader, NPZSource,
                                           PDBBindLMDBSource, open_source)
from fabind_tpu_torch.data.frame import load_frame, save_frame
from fabind_tpu_torch.data.isomorphism import iso_labels_from_arrays
from fabind_tpu_torch.data.kv import open_kv, write_kv
from fabind_tpu_torch.data.native import build_library, collate_native
from fabind_tpu_torch.data.featurize import (THREE_TO_ONE,
                                             extract_protein_structure,
                                             featurize_sdf, parse_sdf,
                                             parse_sdf_text, write_sdf)
from fabind_tpu_torch.data.types import FABindBatch
from fabind_tpu_torch.models import layers
from fabind_tpu_torch.models.att_model import EfficientMCAttModel
from fabind_tpu_torch.models.egnn import MCAttEGNN
from fabind_tpu_torch.models.esm2 import (PAD_ID, Esm2Config, Esm2Model,
                                         load_esm2, tokenize)
from fabind_tpu_torch.models.fabind import init_params, make_model
from fabind_tpu_torch.ops import dropout, edge_gate
from fabind_tpu_torch.ops.cuda_build import build_all, find_nvcc
from fabind_tpu_torch.ops.geometry import pairwise_dist
from fabind_tpu_torch.ops.gumbel import pocket_center_rounded
from fabind_tpu_torch.parallel import dp
from fabind_tpu_torch.parallel import steps as dp_steps
from fabind_tpu_torch.postopt import configuration_loss
from fabind_tpu_torch.sample import (dbscan_clusters, live_halves,
                                     pass_seed, recycle_counts, sample_poses,
                                     stochastic_dock, stochastic_pocket)
from fabind_tpu_torch.serve import DockingEngine, _bucket_label
from fabind_tpu_torch.serve_http import make_server
from fabind_tpu_torch.train.checkpoints import (HEAD_PREFIXES,
                                                TrainCheckpointer,
                                                load_weights)
from fabind_tpu_torch.train.confidence import METRIC_KEYS
from fabind_tpu_torch.train.schedule import build_schedule
from fabind_tpu_torch.train.trainer import (Trainer, eval_forward,
                                            step_generator)
from fabind_tpu_torch.utils import tracing

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
# structure files (phase 9): where the PDB/SDF files and the CLIs' outputs
# go (git-ignored); the encoder's seed and rows per forward; the CLIs'
# encoder, full width cut to this many layers (the full one's state dict
# would be 2.6 GB); the randomize_init seed
SDF_ROOT = Path("build/chip_smoke_sdf")
ESM_SEED = 9
ESM_BATCH = 4
ESM_CLI_LAYERS = 2
SDF_SEED = 5
# the fp32 encoder on the card (TF32 off) vs the CPU, and one sequence alone
# vs inside a batch: the same arithmetic summed in other orders over 33
# layers, outputs O(1) after the final LayerNorm
ESM_CPU_ATOL = 1e-3
ESM_BATCH_ATOL = 1e-3
# synthetic structure files: backbone atoms around each CA, valences of the
# ligands' heavy atoms, residue letters to names
BACKBONE_OFFSETS = {"N": (-1.2, 0.6, 0.0), "CA": (0.0, 0.0, 0.0),
                    "C": (1.2, 0.6, 0.0), "O": (1.4, 1.8, 0.0)}
VALENCE = {"C": 4, "N": 3, "O": 2, "S": 2}
ONE_TO_THREE = {v: k for k, v in THREE_TO_ONE.items()}
# exported serving (phase 10): where the state dicts, artifacts and logs are
# written; the limits of one export process and of the daemon's start
EXPORT_ROOT = Path("build/chip_smoke_export")
EXPORT_TIMEOUT_S = 600
DAEMON_START_S = 300
# the processed PDBbind store (phase 11): where it is written, its groups
# (train, test, valid rows of the 32 requests, in request order: the test
# rows hold request 27, which routes to the small bucket), the rows that
# carry a symmetric ligand (all-carbon: a chain, whose reversal is its one
# automorphism, and a chain ending in a tert-butyl, 3! permutations), the
# three rows the split filters must drop, the unseen test ids (both
# buckets)
STORE_ROOT = Path("build/chip_smoke_store")
STORE_GROUPS = (("train", 24), ("test", 4), ("valid", 4))
STORE_SYMMETRIC = {0: "chain", 1: "tert-butyl", 28: "chain"}
STORE_FILTERED = (("xxlig", dict(c_length=120)),
                  ("xxcon", dict(native_num_contact=3)),
                  ("xxcom", dict(use_compound_com=False)))
STORE_UNSEEN = ("r25", "r26", "r27")
STORE_SEQ_SEED = 11
# the dropout kernel (phase 2): rates, a ragged length (not a multiple of
# 4), Random123's known answers for Philox4x32-10 (counter words, key words
# -> output words), the small shape of the gradient check
DROPOUT_RATES = (0.1, 0.5)
DROPOUT_RAGGED = (3, 1001)
PHILOX_KAT = (
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)))
DROPOUT_GRAD_SHAPE = (8, 1000)
# exported sampling (phase 12): where the state dict, the artifact (small
# bucket) and logs go
SAMPLING_ROOT = Path("build/chip_smoke_sampling")
# the JSON line's "replaces" of the dropout kernel: the JAX package's
# dropout, flax's, which XLA fuses (no TPU kernel)
# flexible docking (phase 13): where the state dict, the artifact (small
# bucket) and the export log are written
FLEX_ROOT = Path("build/chip_smoke_flex")
DROPOUT_REPLACES = ("fabind_tpu/models/layers.py:82 (flax nn.Dropout; no "
                    "TPU kernel)")
# phase 14 (data parallelism): two ranks or two replicas share cuda:0 (the
# machine has one card), so these check the dp logic with the real kernels
# and measure no dp speed
DP_ROOT = Path("build/chip_smoke_dp")
DP_DEVICES = ("cuda:0", "cuda:0")
DP_RATES = (0.0, 0.1)           # the two cli.train runs' dropout
DP_GROUP_TIMEOUT_S = 300
DP_JOIN_S = 600
# two ranks vs one process after two AdamW updates (fp32, TF32 off): the
# median parameter within the CPU tests' 2e-6; every parameter within
# twice the two updates' learning rates (an Adam update moves an element
# by at most ~lr, and an element whose gradient is near 0 may take the
# other sign when the ranks' sums round otherwise)
DP_PARAM_MEDIAN_ATOL = 2e-6
DP_LOSS_RTOL = 1e-4
# fp32 poses of two replicas vs one: a block of 4 rows is another product
# shape than the batch of 8, so not bit for bit
DP_POSE_MAX_A = 1e-3
# best-of winners counted as the one-replica engine's (bf16, printed)
DP_SAME_WINNER_A = 0.05
# ablation and extra configurations (phase 15): each on top of preset
# fabind at released width; the no-attention stacks never reach the gate
ABLATION_CONFIGS = (
    ("keep_trig_attn", dict(keep_trig_attn=True)),
    ("ablation_no_attention", dict(ablation_no_attention=True)),
    ("ablation_no_attention_with_cross_attn",
     dict(ablation_no_attention_with_cross_attn=True)),
    ("implicit_pair", dict(explicit_pair_embed=False,
                           add_cross_attn_layer=False)),
    ("no_attn_pair_bias", dict(add_attn_pair_bias=False)),
    ("opm", dict(add_cross_attn_layer=False, opm=True)),
    ("gvp", dict(use_esm2_feat=False)),
    ("esm2_concat_raw", dict(esm2_concat_raw=True)),
)
ABLATION_GATE_FREE = ("ablation_no_attention",
                      "ablation_no_attention_with_cross_attn")
# one fp32 training step per EGNN stack type, dropout on
ABLATION_TRAIN = ("keep_trig_attn", "ablation_no_attention",
                  "ablation_no_attention_with_cross_attn")
ABLATION_DROPOUT = 0.1
ABLATION_ROOT = Path("build/chip_smoke_ablation")
# the configurations exported on the card (bf16, small bucket) beside
# phases 7-11, one of each EGNN stack that phase 15 serves, and where
ABLATION_EXPORTS = ("keep_trig_attn", "ablation_no_attention")
ABLATION_EXPORT_ROOT = Path("build/chip_smoke_ablation_export")
# host collation (phase 16): repeats of each collator per batch, and where
# the NPZ training samples are written
COLLATE_REPEATS = 20
COLLATE_ROOT = Path("build/chip_smoke_collate")
# seeded N/C/O around each CA of the requests (the GVP configurations)
BACKBONE_SEED = 15
BACKBONE_JITTER_A = 0.2


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


def dropout_shape(cfg_b) -> tuple:
    """The largest tensor a FABind+ sampling pass of bucket cfg_b drops
    out: the docking EGCL's edge-MLP hidden layer [B, N, K, s (2C + 1)]
    over the complex's N = 2 + Nc + Np nodes and the ctx table's
    K = 1 + max(min(ctx_k, Np - 1), bond_k) slots per node (ops/graph.py;
    phase 12 checks it against the shapes a pass gives the kernel)."""
    sh, m = cfg_b.shapes, cfg_b.model
    k = 1 + max(min(sh.ctx_k, sh.max_pocket - 1), sh.bond_k)
    return (BATCH, 2 + sh.max_ligand + sh.max_pocket, k,
            m.mlp_hidden_scale * (2 * m.hidden_size + 1))


def dropout_inputs(shape, dtype, seed=0):
    """x uniform in [-2, 2) on the card, with a seed and a round tensor."""
    g = torch.Generator().manual_seed(seed)
    x = (torch.rand(shape, generator=g) * 4 - 2).to(dtype).cuda()
    return (x, torch.tensor(-(2**62) + seed, device="cuda"),
            torch.tensor(5, device="cuda"))


def check_dropout(sampling_buckets) -> dict:
    """Phase 2: the dropout kernel against its plain version, bit for bit
    (mask and values) on the card, at the largest dropout shape of each
    served bucket (`sampling_buckets` maps a bucket label to its FABind+
    config) and a ragged one, in fp32 and bf16, at rates 0.1 and 0.5; the
    plain version on the CPU on a copy of the input draws the same; its
    Philox gives Random123's answers; its gradient is grad x mask x scale.
    Returns the max abs error (0.0: equal) by (dtype, bucket label)."""
    rows = np.array([[*c, *k] for c, k, _ in PHILOX_KAT], np.uint32)
    got = dropout.philox_on_device(rows)
    check(np.array_equal(got, np.array([w for _, _, w in PHILOX_KAT],
                                       np.uint32)),
          f"dropout Philox4x32-10 known answers: {got}")
    print("dropout kernel Philox4x32-10: Random123's 3 known-answer vectors")
    max_err = {}
    cases = [(label, dropout_shape(c)) for label, c in
             sampling_buckets.items()] + [(None, DROPOUT_RAGGED)]
    for label, shape in cases:
        for dtype in DTYPES:
            for rate in DROPOUT_RATES:
                x, seed, rnd = dropout_inputs(shape, dtype)
                got = dropout.dropout(x, seed, rnd, 7, 1, rate)
                torch.cuda.synchronize()
                want = dropout.dropout_reference(x, seed, rnd, 7, 1, rate)
                check(torch.equal(got, want), f"dropout {shape} {dtype} "
                      f"rate {rate}: kernel != plain version")
                # x is never 0 (uniform in [-2, 2) has no exact 0 here)
                keep = float((got != 0).float().mean())
                sd = (rate * (1 - rate) / x.numel()) ** 0.5
                check(abs(keep - (1 - rate)) < 5 * sd,
                      f"dropout {shape} rate {rate}: kept {keep}, 5 sd "
                      f"{5 * sd}")
                host = None
                if label is None or (dtype == torch.bfloat16 and rate == 0.1):
                    host = dropout.dropout(x.cpu(), seed.cpu(), rnd.cpu(), 7,
                                           1, rate)
                    check(torch.equal(host, got.cpu()),
                          f"dropout {shape} {dtype} rate {rate}: the CPU's "
                          f"plain version draws another mask")
                print(f"dropout {list(shape)} {str(dtype)[6:]} rate {rate}: "
                      f"kernel == plain on the card bit for bit"
                      f"{' and on the CPU' if host is not None else ''}, "
                      f"kept {keep:.4f}")
                if label is not None:
                    max_err[(dtype, label)] = 0.0
                del x, got, want, host
    for dtype in DTYPES:
        x, seed, rnd = dropout_inputs(DROPOUT_GRAD_SHAPE, dtype, seed=1)
        x.requires_grad_()
        g = torch.randn(DROPOUT_GRAD_SHAPE, device="cuda").to(dtype)
        y = dropout.dropout(x, seed, rnd, 3, 0, 0.1)
        (gx,) = torch.autograd.grad(y, x, g)
        keep = dropout.dropout(torch.ones_like(x), seed, rnd, 3, 0, 0.1) != 0
        s = torch.tensor(dropout.scale(0.1), device="cuda")
        # the product in fp32, rounded once (bf16 x a 0-d fp32 tensor
        # would round the scale to bf16 first)
        check(torch.equal(gx, (g.float() * keep * s).to(dtype)),
              f"dropout backward {dtype}: grad x mask x scale")
    print("dropout backward: grad x mask x scale bit for bit (fp32, bf16)")
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


@contextlib.contextmanager
def eager_docking(engine):
    """The engine docks eagerly in the block, its docking graphs
    (fabind_tpu_torch/graphs.py) set aside: a gate patched in the block
    then runs, where a replay would launch the captured operator."""
    held, engine._graphs = engine._graphs, None
    try:
        yield
    finally:
        engine._graphs = held


def run_plain_gate(engine, batch, cfg_b):
    """One batch with the gate's plain version in place of the kernel
    (docked eagerly)."""
    orig = layers.phi_rank1_pair
    layers.phi_rank1_pair = edge_gate.phi_rank1_pair_reference
    try:
        with eager_docking(engine):
            return engine.run_batch(batch, cfg_b)
    finally:
        layers.phi_rank1_pair = orig


def graph_counts():
    """The serving counters of the docking graphs, by bucket."""
    c = tracing.snapshot()["counters"]
    return {k: dict(c.get(k, {})) for k in (
        "serve.graph_captures", "serve.graph_replays", "serve.graph_eager")}


def check_graphed(engine, raws, poses, counter, before, what):
    """After warm-up every batch of a dock_raw (`counter`, the
    BucketLaunches of the call that gave `poses`; `before`, graph_counts()
    just before it) replayed its bucket's graphs, and the same requests
    docked eagerly give the same poses bit for bit."""
    after = graph_counts()
    moved = {k: {b: n - before[k].get(b, 0) for b, n in after[k].items()
                 if n != before[k].get(b, 0)} for k in after}
    # the engine's counters key a bucket "LxPxR", bucket_label "L:P:R"
    batches = {k.replace(":", "x"): n for k, n in counter.batches.items()}
    print(f"{what} dock_raw after warm-up: graph replays by bucket "
          f"{moved['serve.graph_replays']}, batches {batches}, "
          f"captures {moved['serve.graph_captures']}, eager "
          f"{moved['serve.graph_eager']}")
    check(moved["serve.graph_replays"] == batches
          and not moved["serve.graph_captures"]
          and not moved["serve.graph_eager"],
          f"{what}: replays {moved} for batches {batches}")
    with eager_docking(engine):
        eager = engine.dock_raw(raws)
    d = pose_dist(eager, poses)
    print(f"{what} dock_raw graphed vs eager docking, {len(d)} atoms: max "
          f"per-atom distance {d.max():.3e} A")
    check(d.max() == 0.0, f"{what}: graphed vs eager poses differ")


def check_graphed_best_of(engine, raws, poses, before):
    """After a warm call every dock half of a dock_best_of at SAMPLES
    passes (`poses`; `before`, graph_counts() just before it) replayed its
    bucket's stochastic docking graphs, nothing was captured or docked
    eagerly, and the same call with the graphs set aside gives the same
    poses and confidences bit for bit."""
    after = graph_counts()
    moved = {k: {b: n - before[k].get(b, 0) for b, n in after[k].items()
                 if n != before[k].get(b, 0)} for k in after}
    halves = {}
    for _, cfg_b, _, _ in engine.batches(raws, [None] * len(raws)):
        label = _bucket_label(cfg_b.shapes)
        halves[label] = halves.get(label, 0) + SAMPLES
    print(f"best-of-{SAMPLES} after its warm call: graph replays by bucket "
          f"{moved['serve.graph_replays']}, dock halves {halves}, captures "
          f"{moved['serve.graph_captures']}, eager "
          f"{moved['serve.graph_eager']}")
    check(moved["serve.graph_replays"] == halves
          and not moved["serve.graph_captures"]
          and not moved["serve.graph_eager"],
          f"best-of-N: replays {moved} for dock halves {halves}")
    with eager_docking(engine):
        eager = engine.dock_best_of(raws, sample_size=SAMPLES,
                                    seed=SAMPLE_SEED)
    d = pose_dist(eager, poses)
    print(f"best-of-{SAMPLES} graphed vs eager dock halves, {len(d)} atoms: "
          f"max per-atom distance {d.max():.3e} A")
    check(d.max() == 0.0 and all(
        p.confidence == e.confidence for p, e in zip(poses, eager)),
        "best-of-N: graphed vs eager poses differ")


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


def post_dock_raw(base: str, raws, path: str = "/dock_raw"):
    """POST `path` (/dock_raw or /dock_best_of?...) with the npz of `raws`:
    the daemon's JSON poses."""
    buf = io.BytesIO()
    np.savez(buf, **{f"r{i}_{k}": v for i, raw in enumerate(raws)
                     for k, v in raw.items()})
    req = urllib.request.Request(
        base + path, data=buf.getvalue(), method="POST",
        headers={"Content-Type": "application/octet-stream"})
    with urllib.request.urlopen(req, timeout=300) as r:
        return json.loads(r.read())


def http_round_trip(engine, raws):
    """The serving daemon on 127.0.0.1 in a thread: /health, then /dock_raw
    with the npz of `raws`; its poses (and a flexible engine's pocket
    fields) must equal engine.dock_raw's. Returns the gate launches of the
    /dock_raw request."""
    srv = make_server(engine, "127.0.0.1", 0)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        with urllib.request.urlopen(base + "/health", timeout=60) as r:
            health = json.loads(r.read())
        check(health["status"] == "ok" and health["bf16"] is True,
              f"/health {health}")
        before = edge_gate.KERNEL.launches
        got = post_dock_raw(base, raws)
        launches = edge_gate.KERNEL.launches - before
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
        check(("pocket_coords" in g) == (w.pocket_coords is not None),
              "HTTP pocket fields exactly for a flexible engine")
        if w.pocket_coords is not None:
            check(np.array_equal(np.asarray(g["pocket_coords"], np.float32),
                                 w.pocket_coords)
                  and g["pocket_residues"] == w.pocket_residues.tolist(),
                  "HTTP pocket fields equal engine.dock_raw's")
    pockets = " with their pockets" if w.pocket_coords is not None else ""
    print(f"http: /health {health}; /dock_raw {len(got)} poses{pockets} "
          f"equal engine.dock_raw's; edge_gate launches {launches}")
    return launches


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
    FABind+ engine on the same requests. Returns the bf16 poses."""
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
    return poses


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
    pocket_fn, dock_fn = live_halves(
        engine.model, cfg_b, dock=engine._graph_dock_half(batch, cfg_b,
                                                          SAMPLES))
    pocket_ms, dock_ms, dbscan_ms, n_clusters = [], [], [], []
    for s in range(SAMPLES):
        seed = pass_seed(SAMPLE_SEED, 0, s)
        with torch.inference_mode():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pocket, center = pocket_fn(batch, seed)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            probs = 1.0 / (1.0 + np.exp(-pocket[2].float().cpu().numpy()))
            t2 = time.perf_counter()
            clusters = dbscan_clusters(probs, xyz, mask, m.dbscan_eps,
                                       m.dbscan_min_samples)
            t3 = time.perf_counter()
            torch.cuda.synchronize()
            t4 = time.perf_counter()
            dock_fn(batch, pocket, center, seed)
            torch.cuda.synchronize()
            t5 = time.perf_counter()
        pocket_ms.append((t1 - t0) * 1e3)
        dbscan_ms.append((t3 - t2) * 1e3)
        dock_ms.append((t5 - t4) * 1e3)
        n_clusters.append(sum(len(c) for c in clusters))
    print(f"time best-of-N pass, batch of {BATCH} bucket "
          f"{bucket_label(shapes)} ({SAMPLES} passes): pocket half median "
          f"{statistics.median(pocket_ms):.2f} ms, docking half (graphs) "
          f"median "
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
    # one pass a batch captures each bucket's stochastic docking graphs
    t0 = time.perf_counter()
    engine.dock_best_of(rs, sample_size=1, seed=SAMPLE_SEED)
    torch.cuda.synchronize()
    print(f"best-of-N warm call, one pass a batch (captures the docking "
          f"graphs of its buckets): {time.perf_counter() - t0:.3f} s "
          f"[{card_line}]")
    edge_gate.KERNEL.launches = 0
    before = graph_counts()
    poses = time_best_of(engine, rs, SAMPLES, "bf16 stochastic", card_line)
    check_graphed_best_of(engine, rs, poses, before)
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
    again = time_best_of(engine, rs, SAMPLES, "bf16 stochastic", card_line)
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
    poses_fixed = time_best_of(fixed, rs, SAMPLES, "bf16 fixed", card_line)
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
    launches its forward and backward should make, its recycle rounds, the
    true entries of each row's iso_mask) and
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
            before_drop = dropout.KERNEL.launches
            t0 = time.perf_counter()
            m = probe.orig[0](tr, batch, bucket_cfg, **kw)
            sec = time.perf_counter() - t0
            mcfg = tr.cfg.model
            expected = 0 if mcfg.is_plus else sum(
                n * (1 + (mcfg.remat and grad)) for n, grad, _ in probe.rounds)
            probe.steps.append(dict(
                label=bucket_label(bucket_cfg.shapes), s=sec, metrics=m,
                iso=(None if batch.iso_mask is None
                     else batch.iso_mask.sum(-1).tolist()),
                launches=edge_gate.KERNEL.launches - before,
                dropout=dropout.KERNEL.launches - before_drop,
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
              f"{[r['recycles'] for r in rs]}, dropout launches "
              f"{[r['dropout'] for r in rs]}{vs} [{card_line}]")
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


# ------------------------------------------------- 9. structure files
def pdb_line(serial, name, resname, chain, resseq, xyz, occ=1.0, alt=" ",
             icode=" ", rec="ATOM  ") -> str:
    """One fixed-column PDB atom record."""
    return (f"{rec}{serial:5d} {name:<4s}{alt}{resname:3s} {chain}"
            f"{resseq:4d}{icode}   {xyz[0]:8.3f}{xyz[1]:8.3f}{xyz[2]:8.3f}"
            f"{occ:6.2f}{0.0:6.2f}          {name[0]:>2s}\n")


def pdb_text(seq: str, ca) -> str:
    """A one-chain PDB file: N, CA, C and O of every residue of `seq`, the
    backbone atoms at fixed offsets from the given CA positions."""
    lines, serial = [], 1
    for i, (aa, xyz) in enumerate(zip(seq, np.asarray(ca, np.float64))):
        for name, off in BACKBONE_OFFSETS.items():
            lines.append(pdb_line(serial, name, ONE_TO_THREE[aa], "A", i + 1,
                                  xyz + off))
            serial += 1
    return "".join(lines) + "END\n"


def ligand_with_hydrogens(rng, xyz, n_rings: int):
    """(symbols, coords, bonds) of a ligand whose heavy atoms sit at `xyz`
    (a chain in that order): chain bonds, `n_rings` six-ring closures
    (i, i + 5), C/N/O/S heavy atoms (ring and branch atoms carbon, so no
    valence is exceeded), and explicit hydrogens at 1.0 A filling every
    heavy atom's valence."""
    n = len(xyz)
    bonds = [(i, i + 1, 1.0) for i in range(n - 1)]
    for s in rng.choice(n - 5, n_rings, replace=False):
        bonds.append((int(s), int(s) + 5, 1.0))
    degree = np.zeros(n, int)
    for i, j, _ in bonds:
        degree[i] += 1
        degree[j] += 1
    symbols = ["C" if d > 2 else str(rng.choice(["C", "C", "C", "N", "O",
                                                 "S"]))
               for d in degree]
    coords = [np.asarray(x, np.float64) for x in xyz]
    for a in range(n):
        for _ in range(VALENCE[symbols[a]] - degree[a]):
            v = rng.randn(3)
            coords.append(coords[a] + v / np.linalg.norm(v))
            bonds.append((a, len(symbols), 1.0))
            symbols.append("H")
    return symbols, np.asarray(coords, np.float32), bonds


def write_structures(raws, root: Path, seed: int):
    """Each request as files: its protein as p{i}.pdb (a seeded sequence of
    standard residues, backbone atoms around its CA positions) and its
    ligand as l{i}.sdf (V2000, its atoms as the heavy atoms, one or two
    rings, explicit H). Returns [(sdf path, pdb path, sequence)]."""
    rng = np.random.RandomState(seed)
    root.mkdir(parents=True, exist_ok=True)
    out = []
    for i, raw in enumerate(raws):
        seq = "".join(rng.choice(list(ONE_TO_THREE), len(raw["protein_xyz"])))
        pdb = root / f"p{i}.pdb"
        pdb.write_text(pdb_text(seq, raw["protein_xyz"]))
        symbols, coords, bonds = ligand_with_hydrogens(
            rng, raw["lig_coords"], n_rings=1 + i % 2)
        sdf = root / f"l{i}.sdf"
        write_sdf(str(sdf), symbols, coords, bonds, name=f"l{i}")
        out.append((str(sdf), str(pdb), seq))
    return out


def seeded_encoder(cfg: Esm2Config, seed: int, device) -> Esm2Model:
    """Esm2Model(cfg) on `device` with seeded random weights drawn there:
    Linear weights N(0, 0.02) and biases 0, LayerNorms at identity
    (HuggingFace's init), word embeddings N(0, 1) (a trained checkpoint's
    residual stream is O(1); at 0.02 the final LayerNorm would amplify
    rounding ~50x)."""
    with torch.device("meta"):
        model = Esm2Model(cfg)
    model = model.to_empty(device=device)
    g = torch.Generator(device=device).manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "LayerNorm" in name or "layer_norm" in name:
                p.fill_(1.0 if name.endswith("weight") else 0.0)
            elif name.endswith("bias"):
                p.zero_()
            else:
                p.normal_(0.0, 1.0 if "word_embeddings" in name else 0.02,
                          generator=g)
    return model.eval()


def esm_flop(cfg: Esm2Config, B: int, L: int) -> float:
    """Operations of one encoder forward over B x L tokens: the dense
    products (q, k, v, output, two feed-forward) and the two attention
    products, 2 per multiply-add."""
    C, Fi = cfg.hidden_size, cfg.intermediate_size
    dense = 2 * (4 * C * C + 2 * C * Fi) * B * L
    return cfg.num_layers * (dense + 4 * B * L * L * C)


def esm_checks(seqs, card_line, profile=None):
    """The full-width encoder on the card: finite [len, 1280] embeddings of
    every sequence, two sequences against the same weights on the CPU, one
    alone against it in a batch, and its times (with `profile`, a profiler
    table of one forward of the longest padded length). Returns the
    encoder."""
    cfg = Esm2Config()
    held = reset_peak()
    t0 = time.perf_counter()
    esm = seeded_encoder(cfg, ESM_SEED, "cuda")
    n_params = sum(p.numel() for p in esm.parameters())
    print(f"sdf encoder: ESM2 t33 at full width ({cfg.num_layers} layers, "
          f"hidden {cfg.hidden_size}, {cfg.num_heads} heads, FFN "
          f"{cfg.intermediate_size}), {n_params / 1e6:.1f}M parameters, "
          f"fp32, seeded random weights (seed {ESM_SEED}), built in "
          f"{time.perf_counter() - t0:.2f} s")
    runs = []
    for _ in range(2):                # cold (first launch), then warm
        t0 = time.perf_counter()
        embs = esm.embed_sequences(seqs, batch_size=ESM_BATCH)
        runs.append(time.perf_counter() - t0)
    for s, e in zip(seqs, embs):
        check(e.shape == (len(s), cfg.hidden_size) and e.dtype == np.float32,
              f"embedding shape {e.shape} for {len(s)} residues")
        check(bool(np.isfinite(e).all()), "finite embedding")
    print(f"time sdf embed_sequences {len(seqs)} sequences of "
          f"{min(map(len, seqs))}-{max(map(len, seqs))} residues, batch "
          f"{ESM_BATCH}, fp32: cold {runs[0]:.3f} s, warm {runs[1]:.3f} s, "
          f"{len(seqs) / runs[1]:.2f} sequences/s [{card_line}]")
    print_peak("ESM2 encoder (weights and embed_sequences)", held, card_line)

    pads = {}
    for s in seqs:
        pads.setdefault(-(-(len(s) + 2) // 128) * 128, []).append(s)
    for pad, group in sorted(pads.items()):
        rows = (group * ESM_BATCH)[:ESM_BATCH]
        ids = torch.from_numpy(np.stack([tokenize(s, pad_to=pad)
                                         for s in rows]).astype(np.int64)
                               ).cuda()
        mask = (ids != PAD_ID).to(torch.int32)
        with torch.inference_mode():
            ms = cuda_time_ms(lambda: esm(ids, mask), iters=5, warmup=1)
        flop = esm_flop(cfg, ESM_BATCH, pad)
        print(f"time sdf ESM2 forward batch {ESM_BATCH} x padded length "
              f"{pad} ({len(group)} of the sequences): {ms:.2f} ms, "
              f"{flop / 1e12:.3f} TFLOP, {flop / ms / 1e9:.1f} TFLOP/s "
              f"(fp32 peak {PEAK_FP32_S / 1e12:.0f}) [{card_line}]")
    if profile:
        def sync_forward():
            with torch.inference_mode():
                esm(ids, mask)
            torch.cuda.synchronize()

        out = Path(profile)
        profile_batch(sync_forward, str(out.with_name(
            f"{out.stem}_esm2_{ESM_BATCH}x{pad}{out.suffix}")), ms,
            f"ESM2 forward {ESM_BATCH} x {pad}", card_line)

    two = sorted(range(len(seqs)), key=lambda i: len(seqs[i]))[:2]
    with torch.device("meta"):
        host = Esm2Model(cfg)
    host = host.to_empty(device="cpu")
    host.load_state_dict(esm.state_dict())
    want = host.eval().embed_sequences([seqs[i] for i in two])
    got = esm.embed_sequences([seqs[i] for i in two])
    del host
    err = max(float(np.abs(g - w).max()) for g, w in zip(got, want))
    print(f"sdf encoder on the card vs the CPU, {[len(seqs[i]) for i in two]}"
          f" residues, fp32: max abs difference {err:.3e} (limit "
          f"{ESM_CPU_ATOL})")
    check(err <= ESM_CPU_ATOL, f"encoder card vs CPU {err}")
    alone = esm.embed_sequences([seqs[two[0]]])[0]
    err = float(np.abs(alone - embs[two[0]]).max())
    print(f"sdf encoder: a sequence alone vs inside a batch of {ESM_BATCH}: "
          f"max abs difference {err:.3e} (limit {ESM_BATCH_ATOL})")
    check(err <= ESM_BATCH_ATOL, f"encoder alone vs batched {err}")
    return esm


def dock_sdf_counted(engine, pairs, what, **kw):
    """dock_sdf with the gate's counts set to 0 just before and read just
    after: (poses, launches by bucket, seconds); every batch of a bucket
    must launch the gate 33 times."""
    counter = BucketLaunches(engine)
    edge_gate.KERNEL.launches = 0
    t0 = time.perf_counter()
    poses = engine.dock_sdf(pairs, **kw)
    secs = time.perf_counter() - t0
    launches = edge_gate.KERNEL.launches
    del engine.run_batch
    print(f"{what}: {len(poses)} poses in {secs:.3f} s, edge_gate launches "
          f"{launches}, by bucket {counter.launches} in batches "
          f"{counter.batches}")
    check(sum(counter.launches.values()) == launches,
          f"{what}: launches outside the batches")
    per_batch = sum(s[-1] for s in served_pair_shapes(engine.cfg))
    for label, n in counter.launches.items():
        check(n == per_batch * counter.batches[label],
              f"{what}: bucket {label} launched the gate {n} times in "
              f"{counter.batches[label]} batches")
    return poses, counter.launches, secs


def same_poses(a, b) -> bool:
    return all(x.error is None and y.error is None
               and np.array_equal(x.coords, y.coords) for x, y in zip(a, b))


def sdf_http_round_trip(engine, pairs, root):
    """/dock_sdf through the daemon (ligands inline, proteins under
    --pdb-root): each pose's `sdf` field, parsed back, holds the engine's
    pose to 1e-4 A; a bare ligand path answers 400."""
    srv = make_server(engine, "127.0.0.1", 0, pdb_root=str(root))
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    body = [{"sdf": Path(s).read_text(), "pdb": Path(p).name}
            for s, p in pairs]

    def post(entries):
        req = urllib.request.Request(
            base + "/dock_sdf", data=json.dumps(entries).encode(),
            method="POST", headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=300) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())

    try:
        status, got = post(body)
        bad, _ = post([{"sdf": pairs[0][0], "pdb": Path(pairs[0][1]).name}])
    finally:
        srv.shutdown()
        srv.server_close()
        t.join(timeout=60)
    check(not t.is_alive(), "HTTP server thread stopped")
    check(status == 200 and len(got) == len(pairs), f"/dock_sdf {status}")
    check(bad == 400, f"/dock_sdf with a ligand path answered {bad}")
    want = engine.dock_sdf([(b["sdf"], p) for b, (_, p) in zip(body, pairs)])
    err = 0.0
    for g, w in zip(got, want):
        check(g["error"] is None and w.error is None, "/dock_sdf pose error")
        check(np.array_equal(np.asarray(g["coords"], np.float32), w.coords),
              "/dock_sdf coords equal engine.dock_sdf's")
        parsed = parse_sdf_text(g["sdf"])
        check(parsed["symbols"] == w.sdf_meta["symbols"], "sdf symbols")
        err = max(err, float(np.abs(parsed["coords"] - w.coords).max()))
    print(f"http: /dock_sdf {len(got)} poses equal engine.dock_sdf's; the "
          f"sdf field parsed back within {err:.2e} A of the pose (limit "
          f"1e-4); a ligand path answered 400")
    check(err <= 1e-4, f"/dock_sdf sdf field {err} A from the pose")


def sdf_cli_checks(engine, files, card_line):
    """cli.inference --ligand-sdf-dir, cli.preprocess esm and inference in
    process, on an encoder cut to ESM_CLI_LAYERS layers (full width) saved
    as a state dict, and the engine's seeded fp32 weights saved as a .pt."""
    root = SDF_ROOT / "cli"
    root.mkdir(parents=True, exist_ok=True)
    inputs = Path(files[0][0]).parent
    esm_cfg = Esm2Config(num_layers=ESM_CLI_LAYERS)
    small = seeded_encoder(esm_cfg, ESM_SEED, "cuda")
    torch.save(small.state_dict(), root / "esm.pt")
    cfg = engine.cfg
    model = make_model(cfg)
    init_params(model, torch.Generator().manual_seed(0))
    sd = model.state_dict()
    torch.save(sd, root / "fabind.pt")
    print(f"sdf CLIs: encoder cut to {ESM_CLI_LAYERS} of 33 layers at full "
          f"width ({(root / 'esm.pt').stat().st_size / 2**20:.0f} MiB state "
          f"dict; the full encoder's would be 2.6 GB), docking weights "
          f"seeded fp32")
    n = len(files)
    with open(root / "index.csv", "w") as f:
        f.write("pdb_file,ligand_id,smiles\n")
        f.writelines(f"p{i},l{i},\n" for i in range(n))
    sets = [a for k, v in SMOKE_SHAPES.items() for a in ("--set", f"{k}={v}")]
    out = root / "docked"
    edge_gate.KERNEL.launches = 0
    t0 = time.perf_counter()
    cli_inference.main(["--ckpt", str(root / "fabind.pt"), "--esm-weights",
                        str(root / "esm.pt"), "--index",
                        str(root / "index.csv"), "--pdb-dir", str(inputs),
                        "--ligand-sdf-dir", str(inputs), "--output",
                        str(out), "--batch-size", str(BATCH)] + sets)
    secs = time.perf_counter() - t0
    launches = edge_gate.KERNEL.launches
    with open(out / "index.csv") as f:
        rows = list(csv.DictReader(f))
    check(len(rows) == n, f"cli.inference wrote {len(rows)} of {n} poses")
    per_batch = sum(sh[-1] for sh in served_pair_shapes(cfg))
    check(launches == per_batch * (-(-n // BATCH)),
          f"cli.inference launched the gate {launches} times")
    ref = DockingEngine(cfg, state_dict=sd, batch_size=BATCH, bf16=False,
                        seed=0, esm=load_esm2(str(root / "esm.pt")))
    want = ref.dock_sdf([(s, p) for s, p, _ in files])
    del ref
    err = 0.0
    for i, (row, w) in enumerate(zip(rows, want)):
        check(row["pdb"] == f"p{i}" and Path(row["sdf"]).name ==
              f"p{i}_{zlib.crc32(f'l{i}'.encode()):08x}.sdf",
              f"cli.inference index row {row}")
        got = parse_sdf(row["sdf"])
        check(got["symbols"] == w.sdf_meta["symbols"]
              and got["bonds"] == [(i0, j0, 4 if o == 1.5 else int(o))
                                   for i0, j0, o in w.sdf_meta["bonds"]],
              f"cli.inference SDF {row['sdf']} atoms and bonds")
        err = max(err, float(np.abs(got["coords"] - w.coords).max()))
    print(f"cli.inference --ligand-sdf-dir: {len(rows)} SDFs and index.csv "
          f"in {secs:.2f} s (fp32, engine and encoder load included), "
          f"{launches} gate launches; each SDF within {err:.2e} A of an "
          f"in-process engine's pose (limit 1e-4) [{card_line}]")
    check(err <= 1e-4, f"cli.inference SDF {err} A from the engine's pose")

    fasta = root / "seqs.fasta"
    fasta.write_text("".join(f">p{i}\n{q}\n" for i, (_, _, q)
                             in enumerate(files)))
    cli_preprocess.main(["esm", "--seqs", str(fasta), "--out",
                         str(root / "esm"), "--esm-weights",
                         str(root / "esm.pt"), "--esm-batch",
                         str(ESM_BATCH)])
    want = small.embed_sequences([q for _, _, q in files],
                                 batch_size=ESM_BATCH)
    for i, w in enumerate(want):
        check(np.array_equal(np.load(root / "esm" / f"p{i}.npy"), w),
              f"cli.preprocess esm p{i}.npy equals embed_sequences")
    del small
    with open(root / "pairs.csv", "w") as f:
        f.write("name,sdf,pdb_file\n")
        f.writelines(f"c{i},{s},{p}\n" for i, (s, p, _) in enumerate(files))
    cli_preprocess.main(["inference", "--index", str(root / "pairs.csv"),
                         "--out", str(root / "npz"), "--esm-weights",
                         str(root / "esm.pt")])
    src, names = open_source(str(root / "npz"))
    check(len(names) == n, f"cli.preprocess inference wrote {len(names)}")
    raws = [src.get(k) for k in names]
    poses, _, _, _ = serve_main_path(engine, raws, "sdf NPZ directory")
    print(f"cli.preprocess: esm {n} .npy equal to embed_sequences; "
          f"inference {len(names)} NPZ files read back by NPZSource and "
          f"docked ({len(poses)} finite poses)")


def sdf_phase(raws, buckets, card_line, profile=None):
    """Phase 9: the structure-file path on the card. Returns dock_sdf's
    gate launches by bucket (bf16)."""
    t_phase = time.perf_counter()
    shutil.rmtree(SDF_ROOT, ignore_errors=True)
    files = write_structures(raws, SDF_ROOT / "inputs", REQUEST_SEED)
    pairs = [(s, p) for s, p, _ in files]
    t0 = time.perf_counter()
    for sdf, pdb in pairs:
        extract_protein_structure(pdb)
        featurize_sdf(sdf)
    host_s = time.perf_counter() - t0
    print(f"time sdf host parse and featurize {len(pairs)} PDB + SDF pairs: "
          f"{host_s * 1e3 / len(pairs):.2f} ms per pair [{card_line}]")
    esm = esm_checks([q for _, _, q in files], card_line, profile)

    held = reset_peak()
    engine = DockingEngine(preset("fabind", **SMOKE_SHAPES), buckets=buckets,
                           batch_size=BATCH, seed=0, esm=esm)
    engine.warmup()
    embeds, captured = [], []
    embed, dock_raw = esm.embed_sequences, engine.dock_raw
    esm.embed_sequences = lambda *a, **k: embeds.append(a[0]) or embed(
        *a, **k)
    engine.dock_raw = lambda rs: captured.append(rs) or dock_raw(rs)
    poses, launches, cold_s = dock_sdf_counted(engine, pairs,
                                               "dock_sdf (cold)")
    del engine.dock_raw
    check_poses(poses, raws, "dock_sdf")
    check(len(embeds) == len(files), f"{len(embeds)} ESM2 forwards for "
          f"{len(files)} proteins")
    check(same_poses(engine.dock_raw(captured[0]), poses),
          "dock_sdf equals dock_raw on the raws it built")
    warm, _, warm_s = dock_sdf_counted(engine, pairs, "dock_sdf (warm)")
    check(len(embeds) == len(files), "the warm call ran an ESM2 forward")
    check(same_poses(warm, poses), "warm dock_sdf equals the cold call")
    engine._protein_cache.clear()
    _, _, cold2_s = dock_sdf_counted(engine, pairs, "dock_sdf (cold again)")
    print(f"time dock_sdf {len(pairs)} complexes bf16: cold (parse, ESM2 "
          f"fp32 and docking) {len(pairs) / cold2_s:.2f} complexes/s "
          f"({len(pairs) / cold_s:.2f} at the first call), warm (proteins "
          f"cached) {len(pairs) / warm_s:.2f} complexes/s [{card_line}]")
    print_peak("dock_sdf engine with the encoder", held, card_line)

    r1, r2, r3 = (engine.dock_sdf(pairs, randomize_init=True, seed=k)
                  for k in (SDF_SEED, SDF_SEED, SDF_SEED + 1))
    check_poses(r1, raws, "dock_sdf randomize_init")
    check(same_poses(r1, r2), "randomize_init: the same seed, other poses")
    check(not same_poses(r1, r3), "randomize_init: another seed, same poses")
    orig = layers.phi_rank1_pair
    layers.phi_rank1_pair = edge_gate.phi_rank1_pair_reference
    try:
        with eager_docking(engine):
            plain = engine.dock_sdf(pairs)
    finally:
        layers.phi_rank1_pair = orig
    d = pose_dist(poses, plain)
    print(f"dock_sdf bf16 kernel vs plain gate: per-atom distance mean "
          f"{d.mean():.3e} A, max {d.max():.3e} A (mean limit "
          f"{BF16_POSE_MEAN_TOL_A} A); randomize_init seeded bit for bit")
    check(d.mean() <= BF16_POSE_MEAN_TOL_A, f"dock_sdf kernel vs plain {d}")
    sdf_http_round_trip(engine, pairs[:BATCH], SDF_ROOT / "inputs")
    del esm.embed_sequences
    sdf_cli_checks(engine, files, card_line)
    del engine, esm
    shutil.rmtree(SDF_ROOT, ignore_errors=True)
    print(f"time phase 9 (structure files) wall: "
          f"{time.perf_counter() - t_phase:.1f} s [{card_line}]")
    return {torch.bfloat16: launches}


def write_seeded_state_dict(preset_name: str, path: Path, **flags) -> str:
    """The seeded fp32 weights every engine of phases 3-5 draws (seed 0) as
    a state-dict file, the checkpoint cli.export reads; `flags` configure
    the preset as phase 15's configurations do."""
    model = make_model(preset(preset_name, **SMOKE_SHAPES, **flags))
    init_params(model, torch.Generator().manual_seed(0))
    torch.save(model.state_dict(), path)
    return str(path)


def export_args(preset_name, ckpt, out, device, shapes=None):
    """cli.export's arguments at released width, bf16, batch 8; the preset's
    shapes cut to SMOKE_SHAPES, or to `shapes` (one bucket) when given."""
    sets = dict(SMOKE_SHAPES)
    if shapes is not None:
        sets.update(max_ligand=shapes.max_ligand,
                    max_pocket=shapes.max_pocket,
                    max_protein=shapes.max_protein)
    return (["--preset", preset_name, "--ckpt", ckpt, "--output", str(out),
             "--batch-size", str(BATCH), "--device", device]
            + [f"--set={k}={v}" for k, v in sets.items()])


def start_process(module: str, args, log: Path,
                  background: bool = False) -> subprocess.Popen:
    """`python -m module args` from this checkout, its output in `log`.
    A `background` process (an export needed phases later) runs at a lower
    CPU priority with one OpenMP thread, so that it takes the host's idle
    cycles and not the phases' that run beside it."""
    env = dict(os.environ, OMP_NUM_THREADS="1") if background else None
    with open(log, "w") as f:
        return subprocess.Popen(
            [sys.executable, "-m", module, *args], stdout=f,
            stderr=subprocess.STDOUT, env=env,
            preexec_fn=(lambda: os.nice(10)) if background else None)


def finish_export(proc: subprocess.Popen, log: Path, what: str,
                  card_line: str) -> dict:
    """Wait for a cli.export process; its JSON line, printed with the
    export's seconds and bytes."""
    rc = proc.wait(timeout=EXPORT_TIMEOUT_S)
    out = log.read_text()
    check(rc == 0, f"{what}: cli.export exited {rc}:\n{out[-4000:]}")
    rec = json.loads(out.strip().splitlines()[-1])
    print_export(rec, what, card_line)
    return rec


def print_export(rec: dict, what: str, card_line: str) -> None:
    with open(Path(rec["output"]) / "manifest.json") as f:
        manifest = json.load(f)
    for e in manifest["buckets"]:
        size = os.path.getsize(Path(rec["output"]) / e["file"])
        label = bucket_label(ShapeConfig(**e["shapes"]))
        print(f"time export {what} bucket {label}: {e['seconds']:.1f} s, "
              f"artifact {size} bytes [{card_line}]")
    print(f"export {what}: {rec}")


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def wait_daemon(base: str, proc: subprocess.Popen, log: Path) -> dict:
    """/health of a daemon process once it answers."""
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < DAEMON_START_S:
        check(proc.poll() is None,
              f"daemon exited {proc.returncode}:\n{log.read_text()[-4000:]}")
        try:
            with urllib.request.urlopen(base + "/health", timeout=10) as r:
                return json.loads(r.read())
        except (urllib.error.URLError, ConnectionError):
            time.sleep(1.0)
    raise RuntimeError(f"chip_smoke check failed: the daemon did not answer "
                       f"within {DAEMON_START_S} s")


def load_exported(path: Path, what: str, card_line: str) -> DockingEngine:
    t0 = time.perf_counter()
    engine = DockingEngine.from_exported(str(path))
    print(f"time load {what} ({len(engine.bucket_cfgs)} buckets): "
          f"{time.perf_counter() - t0:.1f} s [{card_line}]")
    check(engine.model is None, f"{what}: from_exported built a model")
    return engine


def export_phase(raws, buckets, base_poses, plus_poses, card_line):
    """Phase 10: phase 3's and phase 5's seeded weights exported through
    cli.export and served by DockingEngine.from_exported; returns the gate
    launches of the exported bf16 path by bucket."""
    t_phase = time.perf_counter()
    shutil.rmtree(EXPORT_ROOT, ignore_errors=True)
    EXPORT_ROOT.mkdir(parents=True)
    sd = write_seeded_state_dict("fabind", EXPORT_ROOT / "fabind.pt")
    sd_plus = write_seeded_state_dict("fabind_plus",
                                      EXPORT_ROOT / "fabind_plus.pt")
    small = buckets[0]
    small_label = bucket_label(small)
    procs = []
    try:
        # the small bucket exported on the CPU, and FABind+ on the card, in
        # processes of their own while this one exports the base model
        cpu_log, plus_log = (EXPORT_ROOT / "cpu_small.log",
                             EXPORT_ROOT / "plus_small.log")
        procs.append(start_process(
            "fabind_tpu_torch.cli.export",
            export_args("fabind", sd, EXPORT_ROOT / "cpu_small", "cpu",
                        small), cpu_log))
        procs.append(start_process(
            "fabind_tpu_torch.cli.export",
            export_args("fabind_plus", sd_plus, EXPORT_ROOT / "plus_small",
                        "cuda", small), plus_log))
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            cli_export.main(export_args("fabind", sd, EXPORT_ROOT / "base",
                                        "cuda") + ["--buckets", BUCKETS])
        rec = json.loads(buf.getvalue().strip().splitlines()[-1])
        print_export(rec, "fabind bf16 (cuda, in process)", card_line)
        check(rec["artifacts"] == len(buckets), f"artifacts {rec}")

        # the CPU-exported small bucket, served on the card by the daemon
        # while this process loads
        finish_export(procs[0], cpu_log, "fabind bf16 small bucket (cpu, "
                      "own process)", card_line)
        port = free_port()
        daemon_log = EXPORT_ROOT / "daemon.log"
        procs.append(start_process(
            "fabind_tpu_torch.cli.serve",
            ["--exported", str(EXPORT_ROOT / "cpu_small"), "--port",
             str(port), "--device", "cuda", "--warmup"], daemon_log))

        engine = load_exported(EXPORT_ROOT / "base", "fabind bf16",
                               card_line)
        warm = engine.warmup()
        print(f"time exported bf16 warmup ({len(buckets)} buckets): "
              f"{warm:.3f} s [{card_line}]")
        poses, counter, _, _ = serve_main_path(engine, raws, "exported bf16")
        d = pose_dist(poses, base_poses)
        print(f"exported vs live bf16 dock_raw (phase 3), {len(d)} atoms: "
              f"max per-atom distance {d.max():.3e} A")
        check(d.max() == 0.0, "exported poses equal the live engine's")
        check(all(p.confidence == q.confidence
                  and p.pocket_truncated == q.pocket_truncated
                  for p, q in zip(poses, base_poses)),
              "exported confidence and pocket_truncated equal the live ones")
        again = engine.dock_raw(raws)
        check(len(engine._dev_prot_rows) > 0
              and pose_dist(again, poses).max() == 0.0,
              "exported engine, protein cache warm: the same poses")
        protein = {k: raws[0][k] for k in ("protein_xyz", "esm_feat")}
        ligs = [{k: v for k, v in r.items() if k not in protein}
                for r in raws[:N_SCREEN]]
        screened = engine.dock_screen(protein, ligs)
        direct = engine.dock_raw([dict(lig, **protein) for lig in ligs])
        check_poses(screened, ligs, "exported dock_screen")
        check(pose_dist(screened, direct).max() == 0.0,
              "exported dock_screen equals dock_raw")
        rows = len(engine._dev_prot_rows)
        print(f"exported bf16: protein cache warm ({rows} rows) and "
              f"dock_screen of {N_SCREEN} ligands equal dock_raw")
        try:
            engine.dock_best_of(raws[:1], sample_size=2)
            refused = ""
        except ValueError as e:
            refused = str(e)
        check("re-export" in refused, "the exported engine refuses "
              "dock_best_of with a re-export hint")

        # times: a live engine of the same weights, then the exported one
        by_bucket = route(engine, raws)
        live = DockingEngine(preset("fabind", **SMOKE_SHAPES),
                             buckets=buckets, batch_size=BATCH, seed=0)
        live.warmup()
        held = reset_peak()
        time_engine(live, first_batches(live, by_bucket), raws,
                    "live bf16 (phase 10)", card_line)
        print_peak("live bf16 engine (phase 10)", held, card_line)
        del live
        held = reset_peak()
        time_engine(engine, first_batches(engine, by_bucket), raws,
                    "exported bf16", card_line)
        print_peak("exported bf16 engine (timed batches and dock_raw)", held,
                   card_line)

        # FABind+ exported on the card in its own process: phase 5's poses
        finish_export(procs[1], plus_log, "fabind_plus bf16 small bucket "
                      "(cuda, own process)", card_line)
        plus = load_exported(EXPORT_ROOT / "plus_small", "fabind_plus bf16",
                             card_line)
        idx = [i for i, r in enumerate(raws)
               if any(r is q for q in by_bucket[small_label])]
        rs = [raws[i] for i in idx]
        plus_got, _, plus_launches, _ = serve_main_path(
            plus, rs, "exported fabind_plus bf16", per_batch=0)
        check(plus_launches == 0, "exported fabind_plus launched the gate")
        d = pose_dist(plus_got, [plus_poses[i] for i in idx])
        print(f"exported vs live fabind_plus bf16 (phase 5), {len(rs)} "
              f"requests of bucket {small_label}: max per-atom distance "
              f"{d.max():.3e} A")
        check(d.max() == 0.0, "exported FABind+ poses equal the live ones")
        del plus

        # /dock_raw through cli.serve --exported (the CPU artifact, on the
        # card) against the card-exported engine
        base_url = f"http://127.0.0.1:{port}"
        health = wait_daemon(base_url, procs[2], daemon_log)
        check(health["buckets"] == [[small.max_ligand, small.max_pocket,
                                     small.max_protein]],
              f"daemon /health {health}")
        got = post_dock_raw(base_url, rs)
        want = engine.dock_raw(rs)
        check(len(got) == len(want), "daemon: one pose per request")
        for g, w in zip(got, want):
            check(g["error"] is None and w.error is None,
                  "daemon pose error")
            check(np.array_equal(np.asarray(g["coords"], np.float32),
                                 w.coords),
                  "the CPU-exported artifact on the card (daemon) equals "
                  "the card-exported one")
        print(f"cli.serve --exported (CPU-exported bucket {small_label}, "
              f"own process): /health {health}; /dock_raw {len(got)} poses "
              f"equal the card-exported engine's")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.terminate()
                try:
                    proc.wait(timeout=60)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait()

    t0 = time.perf_counter()
    rc = cli_selftest.main(["--bf16", "--train", "--prod", "--device",
                            "cuda"])
    check(rc == 0, f"cli.selftest returned {rc}")
    print(f"time cli.selftest --bf16 --train --prod: "
          f"{time.perf_counter() - t0:.1f} s [{card_line}]")
    print(f"time phase 10 (exported serving) wall: "
          f"{time.perf_counter() - t_phase:.1f} s [{card_line}]")
    return {torch.bfloat16: counter.launches}


def store_ligand(raw, i: int, rng):
    """(feats, directed edge list [E, 3] with torchdrug relation ids) of
    request i's ligand in the store: a symmetric row is all carbon (a
    torchdrug one-hot of C and its degree), single bonds, its chain ending
    in a tert-butyl where STORE_SYMMETRIC says so; any other row keeps its
    features and chain and draws a relation id per bond."""
    n = raw["lig_coords"].shape[0]
    kind = STORE_SYMMETRIC.get(i)
    if kind is None:
        bonds = [tuple(e) for e in raw["bond_edges"].tolist() if e[0] < e[1]]
        rel = rng.randint(0, 4, len(bonds))
        feats = raw["lig_feats"]
    else:
        bonds = [(a, a + 1) for a in range(n - 1)]
        if kind == "tert-butyl":
            bonds = bonds[:n - 3] + [(n - 4, n - 2), (n - 4, n - 1)]
        rel = np.zeros(len(bonds), np.int64)
        degree = np.bincount(np.asarray(bonds).reshape(-1), minlength=n)
        feats = np.zeros((n, 56), np.float32)
        feats[:, 2] = 1.0
        feats[np.arange(n), 18 + degree] = 1.0
    edges = sorted([(a, b, int(r)) for (a, b), r in zip(bonds, rel)]
                   + [(b, a, int(r)) for (a, b), r in zip(bonds, rel)])
    return feats, np.asarray(edges, np.int64)


def write_store(raws, root: Path) -> dict:
    """The requests as a processed store in the reference's layout, with
    the port's writers: protein_1d_3d.lmdb (xyz, int-coded sequence),
    compound_LAS_edge_index.lmdb (the torchdrug 6-tuple: coords, features,
    edge list with relation ids, edge_attr, pair distances, LAS edge
    index), esm2_t33_650M_UR50D.lmdb, compound_rdkit_coords.pt, data.pt
    (save_frame: STORE_GROUPS of the requests, then the STORE_FILTERED
    rows) and split_pdb_id/unseen_test_index. Returns {pdb: sequence}."""
    shutil.rmtree(root, ignore_errors=True)
    proc = root / "dataset" / "processed"
    proc.mkdir(parents=True)
    rng = np.random.RandomState(STORE_SEQ_SEED)
    groups = [g for g, k in STORE_GROUPS for _ in range(k)]
    rows = [(f"r{i:02d}", groups[i], raws[i], i, {})
            for i in range(len(groups))]
    rows += [(name, "train", raws[2 + k], 2 + k, kw)
             for k, (name, kw) in enumerate(STORE_FILTERED)]
    protein, compound, esm, rdkit, seqs = {}, {}, {}, {}, {}
    cols = {k: [] for k in ("pdb", "group", "protein_name", "compound_name",
                            "c_length", "native_num_contact",
                            "use_compound_com", "pocket_com")}
    for name, group, raw, i, kw in rows:
        key = name.encode()
        seq = rng.randint(0, 20, len(raw["protein_xyz"]))
        seqs[name] = "".join(cli_preprocess._NUM_TO_LETTER[a] for a in seq)
        protein[key] = pickle.dumps((torch.from_numpy(raw["protein_xyz"]),
                                     torch.from_numpy(seq)))
        esm[key] = pickle.dumps(torch.from_numpy(raw["esm_feat"]))
        feats, edges = store_ligand(raw, i, rng)
        n = len(feats)
        compound[key] = pickle.dumps((
            torch.from_numpy(raw["lig_coords"]), torch.from_numpy(feats),
            torch.from_numpy(edges), torch.zeros(len(edges), 1),
            torch.zeros(n, n, 16),
            torch.from_numpy(np.stack(np.nonzero(raw["las_mask"]))
                             .astype(np.int64))))
        rdkit[name] = torch.from_numpy(raw["rdkit_coords"])
        row = dict(pdb=name, group=group, protein_name=name,
                   compound_name=name, c_length=n, native_num_contact=12,
                   use_compound_com=True,
                   pocket_com=raw["lig_coords"].mean(0, keepdims=True)
                   .astype(np.float64))
        row.update(kw)
        for k, v in row.items():
            cols[k].append(v)
    save_frame(str(proc / "data.pt"),
               {k: (np.asarray(v) if k in ("c_length", "native_num_contact",
                                           "use_compound_com") else v)
                for k, v in cols.items()})
    torch.save(rdkit, proc / "compound_rdkit_coords.pt")
    for name, items in (("protein_1d_3d.lmdb", protein),
                        ("compound_LAS_edge_index.lmdb", compound),
                        ("esm2_t33_650M_UR50D.lmdb", esm)):
        write_kv(str(proc / name), items)
    (root / "split_pdb_id").mkdir()
    (root / "split_pdb_id" / "unseen_test_index").write_text(
        "\n".join(STORE_UNSEEN) + "\n")
    return seqs


def store_split_checks(root: Path, n_req: int):
    """The split filters: base keeps the train requests, FABind+ also the
    120-atom row (its length cut keeps every protein here); valid and test
    are the requests of their groups; the filtered rows are dropped."""
    src = PDBBindLMDBSource(str(root))
    bounds, start = {}, 0
    for g, k in STORE_GROUPS:
        bounds[g] = list(range(start, start + k))
        start += k
    xxlig = n_req + 0
    want = {"fabind": dict(bounds),
            "fabind_plus": dict(bounds, train=bounds["train"] + [xxlig])}
    for variant, w in want.items():
        got = src.splits(variant)
        check(got == w, f"store splits({variant}) {got}")
    print(f"store splits (rows per train, test, valid): fabind "
          f"{[len(v) for v in want['fabind'].values()]}, fabind_plus "
          f"{[len(v) for v in want['fabind_plus'].values()]} of {len(src)} "
          f"rows; the c_length 120 row "
          f"kept by FABind+ only, the contact and use_compound_com rows by "
          f"neither")


def inject_iso_checks(root: Path, card_line: str):
    """cli.preprocess inject-iso: data_new.pt holds a group per row, []
    where use_compound_com is False; identity first; every automorphism
    maps the row's labels and bonds onto themselves; the symmetric rows'
    groups have their size."""
    t0 = time.perf_counter()
    cli_preprocess.main(["inject-iso", "--data", str(root)])
    secs = time.perf_counter() - t0
    proc = root / "dataset" / "processed"
    frame = load_frame(str(proc / "data_new.pt"))
    src = PDBBindLMDBSource(str(root), use_esm2_feat=False)
    sizes = {}
    for i in range(len(src)):
        isos = frame["isomorphics"][i]
        if not frame["use_compound_com"][i]:
            check(isos == [], f"inject-iso row {i}: {isos}")
            continue
        raw = src.get(i)
        labels = iso_labels_from_arrays(raw["lig_feats"], raw["bond_edges"],
                                        raw["bond_orders"])
        bonds = {tuple(e) for e in raw["bond_edges"].tolist()}
        check(np.array_equal(isos[0], np.arange(len(labels))),
              f"inject-iso row {i}: identity first")
        for p in isos:
            check(np.array_equal(labels[p], labels)
                  and {(int(p[a]), int(p[b])) for a, b in bonds} == bonds,
                  f"inject-iso row {i}: {p} is no automorphism")
        sizes[raw["pdb"]] = len(isos)
    for i, kind in STORE_SYMMETRIC.items():
        want = 6 if kind == "tert-butyl" else 2
        check(sizes[f"r{i:02d}"] == want,
              f"inject-iso r{i:02d} ({kind}): {sizes[f'r{i:02d}']} "
              f"automorphisms, expected {want}")
    n = len(frame)
    print(f"time inject-iso: {n} complexes in {secs:.3f} s, "
          f"{secs / n * 1e3:.2f} ms per complex; groups "
          f"{ {k: v for k, v in sizes.items() if v > 1} } non-trivial, "
          f"every automorphism maps labels and bonds onto themselves "
          f"[{card_line}]")


def loader_epoch(source, indices, cfg, buckets):
    """One timed train epoch of the Loader (seed 0, workers 4, batch 8):
    the batches and the seconds."""
    loader = Loader(source, indices, cfg, batch_size=BATCH, seed=0,
                    workers=4, buckets=buckets)
    t0 = time.perf_counter()
    out = list(loader.epoch(0, with_meta=True))
    return out, time.perf_counter() - t0


def store_npz_checks(root: Path, buckets, card_line: str):
    """cli.preprocess pdbbind --isomorphisms writes an NPZ directory; a
    FABind+ Loader epoch over the store's train split equals one over the
    same rows of that directory, batch for batch, bit for bit. Times: ms
    per source.get against ms per NPZ load, and the two Loaders'
    samples/s."""
    npz = root / "npz"
    shutil.rmtree(npz, ignore_errors=True)
    cli_preprocess.main(["pdbbind", "--data", str(root), "--out", str(npz),
                         "--isomorphisms"])
    src = PDBBindLMDBSource(str(root))
    npz_src = NPZSource(str(npz))
    names = [src.index["pdb"][i] for i in range(len(src))]
    check(npz_src.names == sorted(names),
          f"cli.preprocess pdbbind wrote {len(npz_src.names)} files")
    times = {}
    for what, get, keys in (("store", src.get, range(len(src))),
                            ("npz", npz_src.get, names)):
        t0 = time.perf_counter()
        for k in keys:
            get(k)
        times[what] = (time.perf_counter() - t0) / len(names) * 1e3
    print(f"time source.get ({len(names)} rows, pure-Python LMDB codec): "
          f"{times['store']:.3f} ms per row; NPZSource.get "
          f"{times['npz']:.3f} ms per file [{card_line}]")
    cfg = preset("fabind_plus", **SMOKE_SHAPES)
    idx = src.splits("fabind_plus")["train"]
    got, t_store = loader_epoch(src, idx, cfg, buckets)
    want, t_npz = loader_epoch(npz_src, [names[i] for i in idx], cfg,
                               buckets)
    check(len(got) == len(want) > 0, "Loader epochs of equal length")
    for (a, ma), (b, mb) in zip(got, want):
        check(ma["pdb"] == mb["pdb"] and ma["n_valid"] == mb["n_valid"],
              f"Loader meta {ma['pdb']} vs {mb['pdb']}")
        for k, v in a.items():
            check((v is None) == (b[k] is None)
                  and (v is None or np.array_equal(v, b[k])),
                  f"Loader batch field {k}: store vs NPZ directory")
    print(f"Loader (fabind_plus, seed 0, workers 4): {len(got)} batches of "
          f"the store's train split bit-equal to the NPZ directory's")
    print(f"time Loader epoch ({len(idx)} samples, workers 4): store "
          f"{len(idx) / t_store:.1f} samples/s, NPZ directory "
          f"{len(idx) / t_npz:.1f} samples/s [{card_line}]")


def esm_lmdb_checks(root: Path, seqs: dict, card_line: str):
    """cli.preprocess esm --lmdb with an encoder of phase 9's CLIs
    (ESM_CLI_LAYERS layers at full width, seed ESM_SEED) saved as a state
    dict: one row per protein, each equal to embed_sequences of its
    decoded sequence in the CLI's chunks (key order, ESM_BATCH * 4 rows)."""
    model = seeded_encoder(Esm2Config(num_layers=ESM_CLI_LAYERS), ESM_SEED,
                           "cuda")
    weights = STORE_ROOT / "esm.pt"
    torch.save(model.state_dict(), weights)
    t0 = time.perf_counter()
    cli_preprocess.main(["esm", "--lmdb", str(root), "--esm-weights",
                         str(weights), "--esm-batch", str(ESM_BATCH)])
    secs = time.perf_counter() - t0
    env = open_kv(str(root / "dataset" / "processed"
                      / "esm2_t33_650M_UR50D.lmdb"))
    with env.begin() as txn:
        rows = {bytes(k).decode(): pickle.loads(v) for k, v in txn.cursor()}
    env.close()
    check(sorted(rows) == sorted(seqs), f"esm --lmdb rows {sorted(rows)}")
    keys = sorted(seqs)
    chunk = ESM_BATCH * 4
    for c0 in range(0, len(keys), chunk):
        part = keys[c0:c0 + chunk]
        want = model.embed_sequences([seqs[k] for k in part],
                                     batch_size=ESM_BATCH)
        for k, w in zip(part, want):
            check(rows[k].dtype == np.float32
                  and np.array_equal(rows[k], w),
                  f"esm --lmdb row {k} equals embed_sequences")
    del model
    print(f"time cli.preprocess esm --lmdb: {len(rows)} proteins in "
          f"{secs:.2f} s (encoder load and the store's rewrite included), "
          f"each row equal to embed_sequences [{card_line}]")


def store_phase(raws, buckets, card_line):
    """Phase 11: training and evaluation from the processed store. Returns
    the gate launches of base cli.train and of cli.evaluate on the store,
    by dtype and bucket (both fp32)."""
    t_phase = time.perf_counter()
    root = STORE_ROOT / "pdbbind"
    t0 = time.perf_counter()
    seqs = write_store(raws, root)
    print(f"time store write ({len(seqs)} rows, pure-Python LMDB writer): "
          f"{time.perf_counter() - t0:.2f} s [{card_line}]")
    store_split_checks(root, sum(k for _, k in STORE_GROUPS))
    data = str(root)

    # base training from data.pt, evaluation of the valid split after the
    # epoch; the counts set to 0 just before, read just after
    out = STORE_ROOT / "fabind"
    shutil.rmtree(out, ignore_errors=True)
    with TrainProbe() as base:
        edge_gate.KERNEL.launches = 0
        train_cli(data, out, epochs=1)
        launches = edge_gate.KERNEL.launches
    check_steps(base, "store fabind")
    check(launches == sum(base.launches_by_bucket().values()) > 0,
          f"store training: gate launches {launches} outside the steps")
    check(len(base.evals) > 0, "store training evaluated its valid split")
    print(f"train store fabind fp32 {len(base.steps)} steps from data.pt: "
          f"gate launches {launches} (train steps "
          f"{sum(r['launches'] for r in base.steps)}, eval "
          f"{sum(r['launches'] for r in base.evals)} in {len(base.evals)} "
          f"batches)")
    report_run(base, out, "store fabind fp32", card_line)

    # cli.evaluate on the test split, restricted to the unseen ids
    evals = {}
    for stage in (2, 1):
        with EvalProbe() as probe:
            m = evaluate_cli(str(out), data, STORE_ROOT / f"eval_s{stage}",
                             "--split", "test", "--stage", str(stage),
                             "--unseen-index", str(root / "split_pdb_id"
                                                   / "unseen_test_index"))
        check(m["n"] == len(STORE_UNSEEN), f"cli.evaluate n {m['n']}")
        check(sorted(per_pdb(STORE_ROOT / f"eval_s{stage}"))
              == list(STORE_UNSEEN), "cli.evaluate scored the unseen ids")
        for r in probe.forwards:
            check(r["launches"] == 33,
                  f"cli.evaluate stage {stage} bucket {r['label']}: "
                  f"{r['launches']} gate launches")
        check(len(probe.launches_by_bucket()) == len(buckets),
              f"cli.evaluate on the unseen ids ran buckets "
              f"{sorted(probe.launches_by_bucket())}")
        for label, n in probe.launches_by_bucket().items():
            evals[label] = evals.get(label, 0) + n
        print(f"eval store stage {stage} (test split, unseen ids): n "
              f"{m['n']}, rmsd_mean {m['rmsd_mean']:.3f}, "
              f"{len(probe.forwards)} batches of 33 gate launches, "
              f"{m['complexes_per_sec']:.2f} complexes/s [{card_line}]")

    # FABind+: automorphisms into data_new.pt, the store against its NPZ
    # conversion, a bf16 epoch from data_new.pt
    inject_iso_checks(root, card_line)
    store_npz_checks(root, buckets, card_line)
    out = STORE_ROOT / "fabind_plus"
    shutil.rmtree(out, ignore_errors=True)
    with TrainProbe() as plus:
        edge_gate.KERNEL.launches = 0
        train_cli(data, out, "--bf16", "--eval-every", "0",
                  preset_name="fabind_plus", epochs=1)
        plus_launches = edge_gate.KERNEL.launches
    check_steps(plus, "store fabind_plus", eval_launches=0)
    check(plus_launches == 0, "store fabind_plus launched the gate")
    iso = [n for r in plus.steps for n in r["iso"]]
    check(sum(n > 1 for n in iso) >= 2,
          f"store fabind_plus: iso_mask rows with more than one true entry "
          f"{iso}")
    print(f"train store fabind_plus bf16 {len(plus.steps)} steps from "
          f"data_new.pt: gate launches 0; iso_mask true entries per row "
          f"{sorted(iso, reverse=True)[:6]}...")
    report_run(plus, out, "store fabind_plus bf16", card_line)

    esm_lmdb_checks(root, seqs, card_line)
    print(f"time phase 11 (processed store) wall: "
          f"{time.perf_counter() - t_phase:.1f} s [{card_line}]")
    return ({torch.float32: base.launches_by_bucket()},
            {torch.float32: evals})


def dropout_calls_per_round(gnn, loop_body: bool = False) -> int:
    """Dropout launches of one recycle round of a FABind+ EGNN stack, from
    its site list: every Dropout with a rate, times its calls per round
    (the edge MLP and the EGCL's coord MLP once per edge group, the
    InterAttention's coord MLP once per attention direction, every other
    site once; FABind+'s EGCL applies no dropout of its own). A traced
    while loop's body (`loop_body`) leaves out the sites whose output the
    loop discards: the output EGCL's node update and the output dropout
    feed only h, and a round without gradient keeps x."""
    n = 0
    for name, mod in gnn.named_modules():
        if not isinstance(mod, layers.Dropout) or mod.rate <= 0:
            continue
        layer, _, rest = name.partition(".")
        if loop_body and (layer == "dropout_out" or (
                layer == "out_layer" and rest.startswith("node_mlp."))):
            continue
        if rest.startswith("edge_mlp."):
            n += 3
        elif rest.startswith("coord_mlp."):
            n += 2 if layer.startswith("att_") else 3
        elif rest != "dropout" or layer.startswith("att_"):
            n += 1
    return n


def pass_dropout_launches(model, pocket_rounds: int, dock_rounds: int,
                          while_loop: bool = False):
    """(pocket half, dock half) dropout launches of one sampling pass that
    runs the given recycle rounds: each loop's calls per round times its
    rounds (with `while_loop`, the rounds without gradient run a traced
    loop body), and each head's sites once."""
    def heads(names):
        return sum(1 for n in names if getattr(model, n, None) is not None
                   for _, d in getattr(model, n).named_modules()
                   if isinstance(d, layers.Dropout) and d.rate > 0)

    def loop(gnn, rounds):
        return (dropout_calls_per_round(gnn)
                + dropout_calls_per_round(gnn, while_loop) * (rounds - 1))

    return (loop(model.pocket_pred_model.gnn, pocket_rounds)
            + heads(("protein_to_pocket", "pocket_radius_head")),
            loop(model.complex_model.gnn, dock_rounds)
            + heads(("distmap_mlp", "ranking_mlp_pre", "ranking_score_mlp")))


def start_sampling_export(buckets) -> subprocess.Popen:
    """Phase 12's export, started before phase 7 so that it runs beside
    phases 7-11: phase 6's seeded fabind_plus_sampling weights through
    cli.export --sampling (bf16, stochastic pocket mode, the small bucket,
    on the card) in a process of its own."""
    shutil.rmtree(SAMPLING_ROOT, ignore_errors=True)
    SAMPLING_ROOT.mkdir(parents=True)
    sd = write_seeded_state_dict("fabind_plus_sampling",
                                 SAMPLING_ROOT / "fabind_plus_sampling.pt")
    return start_process(
        "fabind_tpu_torch.cli.export",
        export_args("fabind_plus_sampling", sd, SAMPLING_ROOT / "artifact",
                    "cuda", buckets[0]) + ["--sampling"],
        SAMPLING_ROOT / "export.log", background=True)


def stop_processes(procs) -> None:
    for proc in procs:
        if proc.poll() is None:
            proc.terminate()
            try:
                proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()


def tensor_halves(model, cfg_b):
    """The live model's stochastic sampling halves with the seed and the
    recycle counts as tensors on the card, as the exported programs take
    them: the loops without gradient run as a while loop."""
    m, shapes = cfg_b.model, cfg_b.shapes

    def keys(seed, batch):
        return layers.upload_int64([layers.signed64(seed),
                                    *recycle_counts(m, seed)],
                                   batch.prot_xyz.device).unbind()

    def pocket_fn(batch, seed):
        s, pc, _ = keys(seed, batch)
        return stochastic_pocket(model, batch, shapes, s, pc)

    def dock_fn(batch, pocket, center, seed):
        s, _, dc = keys(seed, batch)
        return stochastic_dock(model, batch, shapes, pocket, center, s, dc)

    return pocket_fn, dock_fn


def time_halves(halves, batch, label, what, card_line):
    """Host-clock ms of the pocket half and the dock half of SAMPLES
    stochastic passes (seeds of batch 0), each ending in synchronize, after
    one untimed pass. Returns the two medians."""
    pocket_fn, dock_fn = halves
    seeds = [pass_seed(SAMPLE_SEED, 0, s) for s in range(SAMPLES)]
    pocket_ms, dock_ms = [], []
    with torch.inference_mode():
        dock_fn(batch, *pocket_fn(batch, seeds[0]), seeds[0])
        for seed in seeds:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pocket, center = pocket_fn(batch, seed)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            dock_fn(batch, pocket, center, seed)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            pocket_ms.append((t1 - t0) * 1e3)
            dock_ms.append((t2 - t1) * 1e3)
    med = statistics.median(pocket_ms), statistics.median(dock_ms)
    print(f"time sampling halves {what}, batch of {BATCH} bucket {label} "
          f"({SAMPLES} passes): pocket half median {med[0]:.2f} ms, dock "
          f"half median {med[1]:.2f} ms (of "
          f"{[round(x, 1) for x in dock_ms]}) [{card_line}]")
    return med


def time_dropout(sampling_buckets, card_line) -> dict:
    """The dropout kernel at the largest dropout shape of each bucket, in
    each dtype (rate 0.1): kernel, plain version and yardstick ms (the
    yardstick is the port's former dropout: torch.rand with a generator,
    then torch.where) beside the bound, 2 x the bytes of x over HBM
    bandwidth. Returns {(dtype, label): (ms, plain, bound, yardstick)}."""
    out = {}
    for label, c in sampling_buckets.items():
        shape = dropout_shape(c)
        for dtype in DTYPES:
            x, seed, rnd = dropout_inputs(shape, dtype)
            g = torch.Generator("cuda").manual_seed(0)
            k_ms = cuda_time_ms(lambda: dropout.dropout(x, seed, rnd, 7, 1,
                                                        0.1))
            p_ms = cuda_time_ms(lambda: dropout.dropout_reference(
                x, seed, rnd, 7, 1, 0.1), iters=5, warmup=1)
            y_ms = cuda_time_ms(lambda: torch.where(
                torch.rand(x.shape, generator=g, device=x.device) >= 0.1,
                x / 0.9, 0.0))
            b_ms = 2 * x.numel() * x.element_size() / PEAK_BYTES_S * 1e3
            out[(dtype, label)] = (k_ms, p_ms, b_ms, y_ms)
            print(f"time dropout {list(shape)} {str(dtype)[6:]} (bucket "
                  f"{label}): kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, "
                  f"bound {b_ms:.4f} ms, torch.rand + torch.where "
                  f"{y_ms:.4f} ms [{card_line}]")
            del x
    return out


def sampling_phase(raws, buckets, proc, card_line):
    """Phase 12: the exported best-of-N sampling programs of phase 6's
    weights (small bucket, bf16, stochastic mode; exported by
    `start_sampling_export` in a process of its own) served by
    DockingEngine.from_exported, against the live engine. Returns the
    dropout and gate launches of its main path (the exported dock_best_of)
    and of the live one, each {dtype: {bucket: launches}}."""
    t_phase = time.perf_counter()
    small = buckets[0]
    label = bucket_label(small)
    cfg = preset("fabind_plus_sampling", **SMOKE_SHAPES)
    m = cfg.model
    art = SAMPLING_ROOT / "artifact"
    daemon_log = SAMPLING_ROOT / "daemon.log"
    daemon = None
    try:
        finish_export(proc, SAMPLING_ROOT / "export.log",
                      "fabind_plus_sampling bf16 --sampling (cuda, own "
                      "process)", card_line)
        with open(art / "manifest.json") as f:
            man = json.load(f)
        check(man["sampling"] and man["sampling_pocket_mode"] == "stochastic",
              "sampling manifest")
        size = sum(os.path.getsize(art / e[k]) for e in man["buckets"]
                   for k in ("file", "pocket_file", "sample_file"))
        print(f"export sampling artifact: {man['buckets'][0]['seconds']:.1f} "
              f"s for 3 programs, {size} bytes [{card_line}]")
        port = free_port()
        daemon = start_process(
            "fabind_tpu_torch.cli.serve",
            ["--exported", str(art), "--port", str(port), "--device", "cuda"],
            daemon_log)
        engine = load_exported(art, "fabind_plus_sampling bf16", card_line)
        live = DockingEngine(cfg, buckets=buckets, batch_size=BATCH, seed=0)
        rs = route(live, raws)[label]
        check(len(rs) == BATCH, f"{len(rs)} requests in bucket {label}")
        engine.warmup()
        live.warmup()

        # the main path: the exported engine's dock_best_of
        dropout.KERNEL.launches = 0
        edge_gate.KERNEL.launches = 0
        poses = engine.dock_best_of(rs, sample_size=SAMPLES,
                                    seed=SAMPLE_SEED)
        drop_launches = dropout.KERNEL.launches
        gate_launches = edge_gate.KERNEL.launches
        check_poses(poses, rs, "exported best-of-N")
        check(gate_launches == 0,
              f"exported sampling launched the gate {gate_launches} times")
        seeds = [pass_seed(SAMPLE_SEED, 0, s) for s in range(SAMPLES)]
        drawn = [recycle_counts(m, sd) for sd in seeds]
        per_pass = [pass_dropout_launches(live.model, *c, while_loop=True)
                    for c in drawn]
        want = sum(sum(p) for p in per_pass)
        print(f"exported best-of-{SAMPLES} of {len(rs)} requests: dropout "
              f"launches {drop_launches} (predicted from the site list "
              f"{want}: per pass (pocket, dock) {per_pass[0]}), gate "
              f"launches {gate_launches}; drawn recycle counts (pocket, "
              f"dock) {drawn}")
        check(drop_launches == want, f"exported sampling: {drop_launches} "
              f"dropout launches, the site list predicts {want}")

        # the live engine: the same poses bit for bit, the drawn rounds
        dropout.KERNEL.launches = 0
        live_poses = live.dock_best_of(rs, sample_size=SAMPLES,
                                       seed=SAMPLE_SEED)
        live_launches = dropout.KERNEL.launches
        want_live = sum(sum(pass_dropout_launches(live.model, *c))
                        for c in drawn)
        check(live_launches == want_live, f"live sampling: {live_launches} "
              f"dropout launches, the site list predicts {want_live}")
        d = pose_dist(poses, live_poses)
        check(d.max() == 0.0 and all(p.confidence == q.confidence
                                     for p, q in zip(poses, live_poses)),
              f"exported best-of-N vs live: max distance {d.max()}")
        other = engine.dock_best_of(rs, sample_size=SAMPLES,
                                    seed=SAMPLE_SEED + 1)
        d_other = pose_dist(other, poses)
        check(d_other.max() > 0.0, "exported best-of-N another seed")
        print(f"exported best-of-{SAMPLES} equals the live engine's bit for "
              f"bit (poses and confidences; live dropout launches "
              f"{live_launches}, predicted {want_live}); another seed "
              f"per-atom distance mean {d_other.mean():.3f} A")

        # the largest tensor a pass drops out is the one phase 2 checked
        shapes_seen = []
        real = layers.dropout
        layers.dropout = (lambda x, *a: shapes_seen.append(tuple(x.shape))
                          or real(x, *a))
        try:
            (_, cfg_b, batch, _), = list(live.batches(rs, [None] * len(rs)))
            with torch.inference_mode():
                pocket_fn, dock_fn = live_halves(live.model, cfg_b)
                dock_fn(batch, *pocket_fn(batch, seeds[0]), seeds[0])
        finally:
            layers.dropout = real
        big = max(shapes_seen, key=lambda t: int(np.prod(t)))
        check(big == dropout_shape(cfg_b),
              f"largest dropout shape {big} vs {dropout_shape(cfg_b)}")

        # /dock_best_of through cli.serve --exported
        base_url = f"http://127.0.0.1:{port}"
        health = wait_daemon(base_url, daemon, daemon_log)
        got = post_dock_raw(base_url, rs, f"/dock_best_of?sample_size="
                            f"{SAMPLES}&seed={SAMPLE_SEED}")
        check(len(got) == len(poses) and all(
            g["error"] is None and np.array_equal(
                np.asarray(g["coords"], np.float32), p.coords)
            for g, p in zip(got, poses)),
            "daemon /dock_best_of equals the exported engine")
        print(f"cli.serve --exported (sampling artifact, own process): "
              f"/health {health}; /dock_best_of {len(got)} poses equal "
              f"the engine's")

        # times: the halves live and exported, best-of-8 live and exported
        (_, cfg_b, batch, _), = list(live.batches(rs, [None] * len(rs)))
        time_halves(live_halves(live.model, cfg_b), batch, label,
                    "live (int counts: the drawn rounds)", card_line)
        time_halves(tensor_halves(live.model, cfg_b), batch, label,
                    "live, tensor counts (while loop)", card_line)
        (_, cfg_e, batch_e, _), = list(engine.batches(rs, [None] * len(rs)))
        time_halves(engine._exported.sampling_halves(cfg_e), batch_e, label,
                    "exported", card_line)
        time_best_of(live, rs, SAMPLES, "live bf16 (phase 12)", card_line,
                     calls=2)
        time_best_of(engine, rs, SAMPLES, "exported bf16", card_line,
                     calls=2)
        del live, engine
    finally:
        stop_processes([daemon] if daemon is not None else [])
    torch.cuda.empty_cache()
    print(f"time phase 12 (exported sampling) wall: "
          f"{time.perf_counter() - t_phase:.1f} s [{card_line}]")
    return ({torch.bfloat16: {label: drop_launches}},
            {torch.bfloat16: {label: live_launches}},
            {torch.bfloat16: {label: gate_launches}})


def dropout_rows(times, max_err, paths) -> list:
    """One JSON row per path ((name prefix, {dtype: {bucket: launches}}))
    and (dtype, bucket) it ran in, with the kernel's times there."""
    rows = []
    for path, counts in paths:
        for dtype, by_bucket in counts.items():
            for label, n in by_bucket.items():
                k_ms, p_ms, b_ms, y_ms = times[(dtype, label)]
                rows.append({
                    "name": f"dropout {path}{str(dtype)[6:]} bucket {label}",
                    "route": "cuda",
                    "source": "fabind_tpu_torch/csrc/dropout.cu",
                    "replaces": DROPOUT_REPLACES, "launches": n,
                    "max_abs_err": max_err[(dtype, label)], "ms": k_ms,
                    "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": "bytes",
                    "library_ms": y_ms})
    return rows


def start_flex_export(buckets) -> subprocess.Popen:
    """Phase 13's export, started before phase 7 so that it runs beside
    phases 7-12: phase 3's seeded weights (fabflex has base FABind's
    parameter tree) through cli.export --preset fabflex (bf16, the small
    bucket, on the card) in a process of its own."""
    shutil.rmtree(FLEX_ROOT, ignore_errors=True)
    FLEX_ROOT.mkdir(parents=True)
    sd = write_seeded_state_dict("fabflex", FLEX_ROOT / "fabflex.pt")
    return start_process(
        "fabind_tpu_torch.cli.export",
        export_args("fabflex", sd, FLEX_ROOT / "artifact", "cuda",
                    buckets[0]), FLEX_ROOT / "export.log", background=True)


def check_pockets(poses, raws, what):
    """Each pose of a flexible engine carries its docked pocket: finite
    float32 coordinates, one residue index of the request's protein per
    row."""
    for p, raw in zip(poses, raws):
        check(p.pocket_coords is not None and p.pocket_residues is not None,
              f"{what}: a pose without its pocket")
        n = len(p.pocket_residues)
        check(p.pocket_coords.shape == (n, 3) and n > 0,
              f"{what}: pocket shape {p.pocket_coords.shape}, {n} residues")
        check(p.pocket_coords.dtype == np.float32
              and bool(np.isfinite(p.pocket_coords).all()),
              f"{what}: finite float32 pocket")
        check(int(p.pocket_residues.max()) < len(raw["protein_xyz"]),
              f"{what}: pocket residues inside the protein")


def same_pockets(a_poses, b_poses) -> bool:
    return all(np.array_equal(a.pocket_residues, b.pocket_residues)
               and np.array_equal(a.pocket_coords, b.pocket_coords)
               for a, b in zip(a_poses, b_poses))


def pocket_moves(poses, raws) -> np.ndarray:
    """Per-residue distance of each docked pocket from its input crop."""
    return np.concatenate([
        np.linalg.norm(p.pocket_coords - raw["protein_xyz"][
            p.pocket_residues], axis=-1) for p, raw in zip(poses, raws)])


def gate_ms_per_batch(cfg) -> float:
    """The gate kernel's device time in one batch of each bucket's served
    shapes, summed over the batch's launches (bf16)."""
    total = {}
    for label, shapes in cfg.items():
        total[label] = sum(
            n * cuda_time_ms(lambda a=pair_inputs(B, Na, Nb, H,
                                                  torch.bfloat16):
                             edge_gate.phi_rank1_pair(*a))
            for _, B, Na, Nb, H, n in shapes)
    return total


def time_in_turns(engines, by_bucket, raws, what, card_line, rounds=4):
    """Batch latency per bucket and dock_raw complexes/s of two engines
    timed in turns (A B, B A, ...), so that the host's drift falls on
    both: {name: ({label: median ms}, complexes/s)}."""
    names = list(engines)
    batches = {n: first_batches(e, by_bucket) for n, e in engines.items()}
    out = {n: ({}, 0.0) for n in names}
    for i, (label, _, _) in enumerate(batches[names[0]]):
        secs = {n: [] for n in names}
        for r in range(rounds):
            for n in names if r % 2 == 0 else names[::-1]:
                _, cfg_b, batch = batches[n][i]
                t0 = time.perf_counter()
                engines[n].run_batch(batch, cfg_b)
                torch.cuda.synchronize()
                secs[n].append(time.perf_counter() - t0)
        for n in names:
            out[n][0][label] = statistics.median(secs[n]) * 1e3
        print(f"time {what} model batch bucket {label} ({BATCH} complexes, "
              f"in turns): " + "; ".join(
                  f"{n} median {out[n][0][label]:.2f} ms of "
                  f"{[round(t * 1e3, 2) for t in secs[n]]}" for n in names)
              + f" [{card_line}]")
    secs = {n: [] for n in names}
    for r in range(rounds):
        for n in names if r % 2 == 0 else names[::-1]:
            t0 = time.perf_counter()
            engines[n].dock_raw(raws)
            secs[n].append(time.perf_counter() - t0)
    for n in names:
        out[n] = (out[n][0], len(raws) / statistics.median(secs[n]))
    print(f"time {what} dock_raw {len(raws)} requests (in turns, protein "
          f"cache warm): " + "; ".join(
              f"{n} {out[n][1]:.2f} complexes/s of "
              f"{[round(t, 3) for t in secs[n]]} s" for n in names)
          + f" [{card_line}]")
    return out


def flex_phase(raws, buckets, proc, card_line):
    """Phase 13: flexible docking (preset fabflex) served live in bf16 and
    fp32 on phase 3's seeded weights, through the daemon and from the
    artifact exported by `start_flex_export`, timed in turns with the base
    engine; then cli.selftest. Returns the gate launches by path, each
    {dtype: {bucket: launches}}."""
    t_phase = time.perf_counter()
    cfg = preset("fabflex", **SMOKE_SHAPES)
    small = buckets[0]
    small_label = bucket_label(small)
    check(cfg.model.flexible_docking, "fabflex is flexible")

    # live bf16: the main path, dock_screen, the daemon, times
    engine = DockingEngine(cfg, buckets=buckets, batch_size=BATCH, seed=0)
    warm = engine.warmup()
    print(f"time fabflex bf16 warmup ({len(buckets)} buckets): {warm:.3f} "
          f"s [{card_line}]")
    poses, counter, _, _ = serve_main_path(engine, raws, "fabflex bf16")
    check_pockets(poses, raws, "fabflex bf16")
    launches = {"": {torch.bfloat16: counter.launches}}
    by_bucket = route(engine, raws)
    protein = {k: raws[0][k] for k in ("protein_xyz", "esm_feat")}
    ligs = [{k: v for k, v in r.items() if k not in protein}
            for r in raws[:N_SCREEN]]
    screened = engine.dock_screen(protein, ligs)
    direct = engine.dock_raw([dict(lig, **protein) for lig in ligs])
    check_poses(screened, ligs, "fabflex dock_screen")
    check(pose_dist(screened, direct).max() == 0.0
          and same_pockets(screened, direct),
          "fabflex dock_screen equals dock_raw, pockets included")
    print(f"fabflex dock_screen {N_SCREEN} ligands equals dock_raw, "
          f"pockets included")
    n_daemon = http_round_trip(engine, raws[:BATCH])
    per_batch = sum(s[-1] for s in served_pair_shapes(cfg))
    n_batches = len(list(engine.batches(raws[:BATCH], [None] * BATCH)))
    check(n_daemon == per_batch * n_batches,
          f"fabflex daemon launched the gate {n_daemon} times in "
          f"{n_batches} batches")
    held = reset_peak()
    engine.dock_raw(raws)
    print_peak("fabflex bf16 engine (dock_raw of the requests)", held,
               card_line)
    rigid = DockingEngine(preset("fabind", **SMOKE_SHAPES), buckets=buckets,
                          batch_size=BATCH, seed=0)
    rigid.warmup()
    turns = time_in_turns({"fabind": rigid, "fabflex": engine}, by_bucket,
                          raws, "bf16 fabind vs fabflex", card_line)
    (lat0, rate0), (lat, rate) = turns["fabind"], turns["fabflex"]
    for label, ms in lat.items():
        print(f"time fabflex / fabind bf16 model batch bucket {label}: "
              f"{ms / lat0[label]:.3f}x [{card_line}]")
    print(f"time fabflex / fabind bf16 dock_raw complexes/s: "
          f"{rate / rate0:.3f}x [{card_line}]")
    served = {bucket_label(s): served_pair_shapes(cfg.replace(shapes=s))
              for s in buckets}
    for label, ms in gate_ms_per_batch(served).items():
        print(f"time fabflex edge_gate bf16 per batch bucket {label}: "
              f"{ms:.4f} ms in {per_batch} launches [{card_line}]")
    del engine, rigid
    torch.cuda.empty_cache()

    # live fp32: the pocket moved; bf16 against it (printed, not gated:
    # the JAX package has no bound for fabflex)
    engine32 = DockingEngine(cfg, buckets=buckets, batch_size=BATCH,
                             bf16=False, seed=0)
    poses32, counter, _, _ = serve_main_path(engine32, raws, "fabflex fp32")
    check_pockets(poses32, raws, "fabflex fp32")
    launches[""][torch.float32] = counter.launches
    moved = pocket_moves(poses32, raws)
    print(f"fabflex fp32 docked pocket vs its input crop, {len(moved)} "
          f"residues: distance mean {moved.mean():.3e} A, max "
          f"{moved.max():.3e} A")
    check(moved.max() > 1e-4, "fabflex fp32: the pocket did not move")
    d = pose_dist(poses, poses32)
    same = [i for i, (a, b) in enumerate(zip(poses, poses32))
            if np.array_equal(a.pocket_residues, b.pocket_residues)]
    dp = np.concatenate([np.linalg.norm(
        poses[i].pocket_coords - poses32[i].pocket_coords, axis=-1)
        for i in same]) if same else np.zeros(1)
    print(f"fabflex bf16 vs fp32, {len(d)} atoms: ligand per-atom distance "
          f"mean {d.mean():.3f} A, max {d.max():.3f} A; pocket per-residue "
          f"distance over the {len(same)} requests with the same crop: mean "
          f"{dp.mean():.3f} A, max {dp.max():.3f} A (printed, not gated)")
    del engine32
    torch.cuda.empty_cache()

    # one recycle: the ligand does not see the moved pocket, so fabflex
    # docks the rigid engine's ligand
    one = {name: DockingEngine(preset(name, **SMOKE_SHAPES, n_iter=1),
                               buckets=buckets, batch_size=BATCH, bf16=False,
                               seed=0).dock_raw(raws)
           for name in ("fabflex", "fabind")}
    d = pose_dist(one["fabflex"], one["fabind"])
    print(f"n_iter=1 fp32, fabflex vs fabind ligand, {len(d)} atoms: max "
          f"per-atom distance {d.max():.3e} A (limit 1e-5 A)")
    check(d.max() <= 1e-5, f"n_iter=1 ligands differ by {d.max()} A")
    check(one["fabind"][0].pocket_coords is None,
          "a rigid engine's pose carries no pocket")
    del one
    torch.cuda.empty_cache()

    # the artifact exported beside phases 7-12, served on the card
    art = FLEX_ROOT / "artifact"
    finish_export(proc, FLEX_ROOT / "export.log",
                  "fabflex bf16 small bucket (cuda, own process)", card_line)
    with open(art / "manifest.json") as f:
        man = json.load(f)
    check(man["flexible"] and man["outputs"][2:5] == [
        "pocket_coords", "pocket_residues", "pocket_mask"],
        f"fabflex manifest {man['flexible']} {man['outputs']}")
    exported = load_exported(art, "fabflex bf16", card_line)
    idx = [i for i, r in enumerate(raws)
           if any(r is q for q in by_bucket[small_label])]
    rs = [raws[i] for i in idx]
    got, counter, _, _ = serve_main_path(exported, rs,
                                         "exported fabflex bf16")
    launches["exported "] = {torch.bfloat16: counter.launches}
    want = [poses[i] for i in idx]
    check_pockets(got, rs, "exported fabflex bf16")
    check(pose_dist(got, want).max() == 0.0 and same_pockets(got, want)
          and all(p.pocket_truncated == q.pocket_truncated
                  for p, q in zip(got, want)),
          "exported fabflex poses and pockets equal the live ones")
    print(f"exported vs live fabflex bf16, {len(rs)} requests of bucket "
          f"{small_label}: poses, pockets and pocket_truncated equal bit "
          f"for bit")
    del exported
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    rc = cli_selftest.main(["--preset", "fabflex", "--bf16", "--train",
                            "--prod", "--device", "cuda"])
    check(rc == 0, f"cli.selftest --preset fabflex returned {rc}")
    print(f"time cli.selftest --preset fabflex --bf16 --train --prod: "
          f"{time.perf_counter() - t0:.1f} s [{card_line}]")
    print(f"time phase 13 (flexible docking) wall: "
          f"{time.perf_counter() - t_phase:.1f} s [{card_line}]")
    return launches


def dp_mapped_dropout_checks(sampling_buckets, card_line) -> dict:
    """Phase 14: the row-mapped dropout kernel at each bucket's sampling
    shape (R = 162 or 210 x 33 x 1025 elements per row, odd), in fp32 and
    bf16: a half batch mapped as a training rank's strided rows (2, r) or a
    replica's block (1, B / 2) equals the unmapped kernel's global mask at
    those rows bit for bit, and its plain version; then its times at the
    half batch beside the unmapped kernel's, its plain version's, torch.rand
    + torch.where and its bound. Returns {(dtype, label): (mapped ms,
    unmapped ms, plain ms, bound ms, yardstick ms)}."""
    out = {}
    for label, c in sampling_buckets.items():
        shape = dropout_shape(c)
        half = BATCH // 2
        for dtype in DTYPES:
            x, seed, rnd = dropout_inputs(shape, dtype, seed=3)
            full = dropout.dropout(x, seed, rnd, 7, 1, 0.1)
            for mul, add, rows in ((2, 0, slice(0, None, 2)),
                                   (2, 1, slice(1, None, 2)),
                                   (1, half, slice(half, None))):
                part = x[rows].contiguous()
                got = dropout.dropout(part, seed, rnd, 7, 1, 0.1, mul, add)
                check(torch.equal(got, full[rows]),
                      f"mapped dropout ({mul}, {add}) {shape} {dtype}: not "
                      f"the global mask's rows")
                if (mul, add) == (2, 1):
                    want = dropout.dropout_reference(part, seed, rnd, 7, 1,
                                                     0.1, mul, add)
                    check(torch.equal(got, want),
                          f"mapped dropout {shape} {dtype}: kernel != plain")
            print(f"dp dropout {list(shape)} {str(dtype)[6:]}: row-mapped "
                  f"halves (2, 0), (2, 1), (1, {half}) == the global mask's "
                  f"rows bit for bit, (2, 1) == plain")
            part = x[1::2].contiguous()
            g = torch.Generator(part.device).manual_seed(0)
            m_ms = cuda_time_ms(lambda: dropout.dropout(part, seed, rnd, 7, 1,
                                                        0.1, 2, 1))
            u_ms = cuda_time_ms(lambda: dropout.dropout(part, seed, rnd, 7, 1,
                                                        0.1))
            p_ms = cuda_time_ms(lambda: dropout.dropout_reference(
                part, seed, rnd, 7, 1, 0.1, 2, 1), iters=3, warmup=1)
            y_ms = cuda_time_ms(lambda: torch.where(
                torch.rand(part.shape, generator=g, device=part.device)
                >= 0.1, part / 0.9, 0.0))
            b_ms = 2 * part.numel() * part.element_size() / PEAK_BYTES_S * 1e3
            out[(dtype, label)] = (m_ms, u_ms, p_ms, b_ms, y_ms)
            print(f"time dp dropout half batch {[half, *shape[1:]]} "
                  f"{str(dtype)[6:]} (bucket {label}): row-mapped kernel "
                  f"{m_ms:.4f} ms, unmapped kernel {u_ms:.4f} ms, plain "
                  f"{p_ms:.4f} ms, bound {b_ms:.4f} ms, torch.rand + "
                  f"torch.where {y_ms:.4f} ms [{card_line}]")
            del x, full, part
    return out


def dp_train_checks(raws, card_line) -> dict:
    """Phase 14, training: two gloo ranks on cuda:0 (parallel.dp.launch of
    cli.train's rank worker, `--dp 2`, preset fabind at full width, fp32,
    TF32 off, global batch 8, one bucket) run two steps at dropout 0, then
    two at 0.1, against one process's Trainer on the same global batches
    (the ranks' Loader(host_shard) batches interleaved). Checks per run:
    the ranks report the same metrics; each rank launches the gate 1 + 4 x
    the step's drawn recycle count; each rank launches dropout as often as
    the one-process step does (its sites and drawn counts), every launch
    row-mapped; the losses within DP_LOSS_RTOL; the parameters after both
    updates (rank 0's checkpoint) within DP_PARAM_MEDIAN_ATOL at the median
    and 2 x (lr_0 + lr_1) everywhere. Returns the launches by kernel path:
    {"gate": n, "dropout_rows": n} summed over ranks and runs."""
    t0 = time.perf_counter()
    # 2 x BATCH train requests, two global batches: the NPZ source trains
    # on the first 90% by name (18 requests for BATCH 8: 16 train, 2 valid)
    data = write_npz_dir(raws[:-(-20 * BATCH // 9)], DP_ROOT / "data")
    src, names = open_source(data)
    train = names[:int(0.9 * len(names))]
    argvs, cfgs = [], []
    for rate in DP_RATES:
        out = DP_ROOT / f"run_dropout{rate}"
        shutil.rmtree(out, ignore_errors=True)
        argv = ["--preset", "fabind", "--data", data, "--output", str(out),
                "--epochs", "1", "--batch-size", str(BATCH), "--buckets",
                "none", "--workers", "4", "--prefetch", "2", "--eval-every",
                "0", "--keep", "1", "--dp", "2", "--set", f"dropout={rate}"]
        for k, v in SMOKE_SHAPES.items():
            argv += ["--set", f"{k}={v}"]
        argvs.append(argv)
        cfgs.append(preset("fabind", **SMOKE_SHAPES, dropout=rate,
                           total_epochs=1, batch_size=BATCH, remat=False))
    t_launch = time.perf_counter()
    runs = dp.launch(dp_steps.cli_train_runs, (argvs,), DP_DEVICES,
                     backend="gloo", timeout=DP_JOIN_S,
                     group_timeout=DP_GROUP_TIMEOUT_S)
    launch_s = time.perf_counter() - t_launch
    totals = {"gate": 0, "dropout_rows": 0}
    for i, (rate, cfg) in enumerate(zip(DP_RATES, cfgs)):
        r0, r1 = runs[0][i], runs[1][i]
        check(len(r0) == len(r1) == 2, f"dp train dropout {rate}: steps "
              f"{len(r0)}, {len(r1)}")
        check([s["metrics"] for s in r0] == [s["metrics"] for s in r1],
              f"dp train dropout {rate}: the ranks' metrics differ")
        parts = [list(Loader(src, train, cfg, group="train",
                             batch_size=BATCH // 2, seed=cfg.train.seed,
                             workers=4, host_shard=(r, 2)).epoch(0))
                 for r in range(2)]
        one = Trainer(cfg, DP_DEVICES[0])
        sched = build_schedule(cfg.train)
        for step, (a, b) in enumerate(zip(*parts)):
            before = dropout.KERNEL.launches
            m = one.train_step(FABindBatch.from_numpy(
                dp.interleave_rows([a, b]), DP_DEVICES[0]))
            one_drop = dropout.KERNEL.launches - before
            pc, dc = recycle_counts(cfg.model, step_generator(
                cfg.train.seed, step, "cpu").initial_seed())
            want_gate = (cfg.model.pocket_pred_layers * pc
                         + cfg.model.mean_layers * dc)
            for rank, s in enumerate((r0[step], r1[step])):
                check(s["gate"] == want_gate, f"dp train dropout {rate} "
                      f"rank {rank} step {step}: gate launches {s['gate']}, "
                      f"expected {want_gate} (recycle count {dc})")
                check(s["dropout"] == one_drop == s["dropout_rows"]
                      if rate else s["dropout"] == one_drop == 0,
                      f"dp train dropout {rate} rank {rank} step {step}: "
                      f"dropout launches {s['dropout']} (row-mapped "
                      f"{s['dropout_rows']}), one process {one_drop}")
                totals["gate"] += s["gate"]
                totals["dropout_rows"] += s["dropout_rows"]
            got = r0[step]["metrics"]
            rel = abs(got["loss"] - m["loss"]) / max(abs(m["loss"]), 1e-12)
            print(f"dp train dropout {rate} step {step}: loss two ranks "
                  f"{got['loss']:.6f}, one process {m['loss']:.6f} (rel "
                  f"{rel:.2e}), grad_norm {got['grad_norm']:.4f} / "
                  f"{m['grad_norm']:.4f}, stage 2 {got['use_stage2']}, "
                  f"recycle count {dc}, gate launches per rank {want_gate}, "
                  f"dropout launches per rank {r0[step]['dropout']} "
                  f"(row-mapped {r0[step]['dropout_rows']})")
            check(rel <= DP_LOSS_RTOL and got["skipped_nan"] == 0.0,
                  f"dp train dropout {rate} step {step}: loss {got['loss']} "
                  f"vs one process {m['loss']}")
            check(got["use_stage2"] == m["use_stage2"],
                  f"dp train dropout {rate} step {step}: stage gate")
        state, _ = TrainCheckpointer(
            str(DP_ROOT / f"run_dropout{rate}" / "ckpt")).restore()
        diffs = torch.cat([(state["model"][n] - p.detach().cpu()).abs()
                           .reshape(-1).float()
                           for n, p in one.model.state_dict().items()])
        bound = 2 * (sched(0) + sched(1))
        med, mx = float(diffs.median()), float(diffs.max())
        print(f"dp train dropout {rate}: parameters after 2 updates, two "
              f"ranks vs one process: median |diff| {med:.3e} (limit "
              f"{DP_PARAM_MEDIAN_ATOL}), max {mx:.3e} (limit {bound:.3e}), "
              f"{int((diffs > DP_PARAM_MEDIAN_ATOL).sum())} of "
              f"{diffs.numel()} above {DP_PARAM_MEDIAN_ATOL}")
        check(med <= DP_PARAM_MEDIAN_ATOL and mx <= bound,
              f"dp train dropout {rate}: parameters median {med}, max {mx}")
        del one
    torch.cuda.empty_cache()
    print(f"time dp train: two gloo ranks sharing one card, {len(DP_RATES)} "
          f"runs of 2 steps in one launch: {launch_s:.1f} s (spawn, "
          f"featurize, build, steps); the phase's training part "
          f"{time.perf_counter() - t0:.1f} s [{card_line}]")
    return totals


def dp_phase(raws, by_bucket, buckets, poses16, poses32, card_line):
    """Phase 14: data parallelism on the one card: training ranks
    (dp_train_checks), two serving replicas on cuda:0 in bf16 and fp32
    against phase 3's one-replica poses and in turns with one replica,
    best-of-8 with two replicas, two ESM2 replicas, and the row-mapped
    dropout kernel. Returns (gate launches by path, dropout launches by
    path, mapped-kernel times)."""
    t_phase = time.perf_counter()
    cfg = preset("fabind", **SMOKE_SHAPES)
    sampling_buckets = {bucket_label(s): preset(
        "fabind_plus_sampling", **SMOKE_SHAPES).replace(shapes=s)
        for s in buckets}
    times = dp_mapped_dropout_checks(sampling_buckets, card_line)
    train = dp_train_checks(raws, card_line)
    large = bucket_label(buckets[-1])

    # serving: two replicas on cuda:0, 33 gate launches per replica block
    per_batch = len(DP_DEVICES) * sum(s[-1] for s in served_pair_shapes(cfg))
    serve_counts, engines = {}, {}
    for dtype, want in ((torch.bfloat16, poses16), (torch.float32, poses32)):
        tag = str(dtype)[6:]
        eng = DockingEngine(cfg, buckets=buckets, batch_size=BATCH, seed=0,
                            bf16=dtype == torch.bfloat16, device=DP_DEVICES)
        eng.warmup()
        got, counter, _, _ = serve_main_path(eng, raws, f"dp two-replica "
                                             f"{tag}", per_batch=per_batch)
        serve_counts[dtype] = counter.launches
        d = pose_dist(got, want)
        print(f"dp two replicas vs one, {tag}, {len(d)} atoms: per-atom "
              f"distance mean {d.mean():.3e} A, max {d.max():.3e} A"
              + (f" (max limit {DP_POSE_MAX_A} A)" if dtype == torch.float32
                 else " (printed, not gated)"))
        if dtype == torch.float32:
            check(d.max() <= DP_POSE_MAX_A, f"dp fp32 poses max {d.max()}")
        check(all(len(c) for c in eng._prot_rows),
              "dp: each replica caches its protein rows")
        engines[tag] = eng
    del engines["float32"]
    one = DockingEngine(cfg, buckets=buckets, batch_size=BATCH, seed=0)
    one.warmup()
    time_in_turns({"one replica": one,
                   "two replicas sharing one card": engines["bfloat16"]},
                  by_bucket, raws, "dp bf16 (not a dp speed: both replicas "
                  "on cuda:0)", card_line, rounds=2)
    del one, engines
    torch.cuda.empty_cache()

    # best-of-8 over the small bucket's requests with two replicas
    cfg_s = preset("fabind_plus_sampling", **SMOKE_SHAPES)
    small = bucket_label(buckets[0])
    rs = by_bucket[small][:BATCH]
    one_s = DockingEngine(cfg_s, buckets=buckets, batch_size=BATCH, seed=0)
    two_s = DockingEngine(cfg_s, buckets=buckets, batch_size=BATCH, seed=0,
                          device=DP_DEVICES)
    one_s.warmup()
    two_s.warmup()
    want = time_best_of(one_s, rs, SAMPLES, "dp one-replica bf16", card_line)
    dropout.KERNEL.launches = 0
    dropout.KERNEL.variants.clear()
    got = time_best_of(two_s, rs, SAMPLES, "dp two-replica bf16 (both on "
                       "cuda:0)", card_line)
    best_of = {"dropout": dropout.KERNEL.launches
               - dropout.KERNEL.variants.get("rows", 0),
               "dropout_rows": dropout.KERNEL.variants.get("rows", 0)}
    check_poses(got, rs, "dp best-of")
    check(best_of["dropout"] == best_of["dropout_rows"] > 0,
          f"dp best-of: replica 0 (unmapped) and replica 1 (row-mapped) "
          f"dropout launches {best_of}")
    same = [float(np.linalg.norm(a.coords - b.coords, axis=-1).max())
            <= DP_SAME_WINNER_A for a, b in zip(got, want)]
    d = pose_dist(got, want)
    print(f"dp best-of-{SAMPLES} two replicas vs one (bf16): winners equal "
          f"(max per-atom distance <= {DP_SAME_WINNER_A} A) {sum(same)} of "
          f"{len(same)}; per-atom distance mean {d.mean():.3e} A, max "
          f"{d.max():.3e} A; dropout launches unmapped {best_of['dropout']}, "
          f"row-mapped {best_of['dropout_rows']}")
    del one_s, two_s
    torch.cuda.empty_cache()

    # ESM2 t33 cut to 2 layers at full width: two replicas vs one
    enc = seeded_encoder(Esm2Config(num_layers=ESM_CLI_LAYERS), ESM_SEED,
                         torch.device(DP_DEVICES[0]))
    rng = np.random.RandomState(ESM_SEED)
    letters = sorted(set(THREE_TO_ONE.values()))
    seqs = ["".join(rng.choice(letters, len(r["protein_xyz"])))
            for r in raws[:8]]
    t0 = time.perf_counter()
    e1 = enc.embed_sequences(seqs, batch_size=ESM_BATCH // 2)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    e2 = enc.embed_sequences(seqs, batch_size=ESM_BATCH // 2,
                             dp=list(DP_DEVICES))
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    err = max(float(np.abs(a - b).max()) for a, b in zip(e1, e2))
    check(all(a.shape == b.shape for a, b in zip(e1, e2)) and err
          <= ESM_BATCH_ATOL, f"dp ESM2: two replicas vs one max {err}")
    print(f"dp ESM2 ({ESM_CLI_LAYERS} of 33 layers, width 1280, fp32) two "
          f"replicas vs one over {len(seqs)} sequences: max abs {err:.3e} "
          f"(limit {ESM_BATCH_ATOL}); {t1 - t0:.3f} s one, {t2 - t1:.3f} s "
          f"two on one card [{card_line}]")
    del enc
    torch.cuda.empty_cache()
    print(f"time phase 14 (data parallelism, two parts sharing one card) "
          f"wall: {time.perf_counter() - t_phase:.1f} s [{card_line}]")
    gate_paths = [("dp serve ", {d: c for d, c in serve_counts.items()}),
                  ("dp train ", {torch.float32: {large: train["gate"]}})]
    drop_paths = {"dropout_rows": [
        ("dp train ", {torch.float32: {large: train["dropout_rows"]}}),
        ("dp best-of ", {torch.bfloat16: {small: best_of["dropout_rows"]}})],
        "dropout": [
        ("dp best-of ", {torch.bfloat16: {small: best_of["dropout"]}})]}
    return gate_paths, drop_paths, times


def dp_dropout_rows(times, drop_paths) -> list:
    """JSON rows of phase 14's dropout launches: the row-mapped kernel and
    the unmapped one (replica 0's block) with their half-batch times."""
    rows = []
    for kernel, paths in drop_paths.items():
        for path, counts in paths:
            for dtype, by_bucket in counts.items():
                for label, n in by_bucket.items():
                    m_ms, u_ms, p_ms, b_ms, y_ms = times[(dtype, label)]
                    rows.append({
                        "name": f"{kernel} {path}{str(dtype)[6:]} bucket "
                                f"{label}",
                        "route": "cuda",
                        "source": "fabind_tpu_torch/csrc/dropout.cu",
                        "replaces": DROPOUT_REPLACES, "launches": n,
                        "max_abs_err": 0.0,
                        "ms": m_ms if kernel == "dropout_rows" else u_ms,
                        "plain_ms": p_ms, "bound_ms": b_ms,
                        "bound_by": "bytes", "library_ms": y_ms})
    return rows


def backbone_requests(raws, seed: int):
    """The requests with protein_full_coords [Nr, 4, 3]: N, CA, C, O at
    BACKBONE_OFFSETS from each CA plus seeded jitter (CA exact)."""
    rng = np.random.RandomState(seed)
    offsets = np.array([BACKBONE_OFFSETS[a] for a in ("N", "CA", "C", "O")],
                       np.float32)
    out = []
    for raw in raws:
        ca = raw["protein_xyz"]
        full = (ca[:, None] + offsets[None]
                + BACKBONE_JITTER_A * rng.randn(len(ca), 4, 3))
        full[:, 1] = ca
        out.append(dict(raw, protein_full_coords=full.astype(np.float32)))
    return out


def ablation_requests(cfg, raws, full):
    """What a user of the configuration sends: the GVP configurations'
    requests carry the backbone, and without ESM2 features no esm_feat."""
    if cfg.model.use_esm2_feat and not cfg.model.esm2_concat_raw:
        return raws
    if cfg.model.esm2_concat_raw:
        return full
    return [{k: v for k, v in r.items() if k != "esm_feat"} for r in full]


def ablation_serving(name, cfg, reqs, buckets, card_line):
    """bf16 and fp32 engines of one configuration over the requests: the
    main path with its gate launches per batch (33, or 0 for the
    no-attention stacks), each bucket's first batch again with the plain
    gate (bf16: mean per-atom distance within phase 3's bound; fp32: max
    coordinate difference within POSE_TOL_A), batch ms per bucket, peak
    memory, bf16 vs fp32 distance. Returns ({dtype: {bucket: launches}},
    the bf16 poses)."""
    per_batch = 0 if name in ABLATION_GATE_FREE else sum(
        s[-1] for s in served_pair_shapes(cfg))
    launches, poses = {}, {}
    for dtype in DTYPES:
        tag = str(dtype)[6:]
        what = f"ablation {name} {tag}"
        held = reset_peak()
        engine = DockingEngine(cfg, buckets=buckets, batch_size=BATCH,
                               bf16=dtype == torch.bfloat16, seed=0)
        poses[dtype], counter, _, first_s = serve_main_path(
            engine, reqs, what, per_batch=per_batch)
        launches[dtype] = counter.launches
        for label, cfg_b, batch in first_batches(engine, route(engine, reqs)):
            ms = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = engine.run_batch(batch, cfg_b)[0]
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
            line = (f"time {what} model batch bucket {label} ({BATCH} "
                    f"complexes): median {statistics.median(ms):.2f} ms of "
                    f"{[round(m, 2) for m in ms]}")
            if per_batch:
                plain = run_plain_gate(engine, batch, cfg_b)[0]
                d = batch_dist(out, plain, batch)
                if dtype == torch.bfloat16:
                    line += (f"; kernel vs plain gate per-atom distance mean "
                             f"{d.mean():.3e} A (limit "
                             f"{BF16_POSE_MEAN_TOL_A} A)")
                    check(d.mean() <= BF16_POSE_MEAN_TOL_A,
                          f"{what} kernel vs plain gate mean {d.mean()} A")
                else:
                    diff = (out - plain).abs().max().item()
                    line += (f"; kernel vs plain gate max coordinate "
                             f"difference {diff:.3e} A (limit {POSE_TOL_A} "
                             f"A)")
                    check(diff <= POSE_TOL_A,
                          f"{what} kernel vs plain gate {diff} A")
            print(line + f" [{card_line}]")
        print(f"time {what} dock_raw first call: {first_s:.3f} s "
              f"[{card_line}]")
        print_peak(what, held, card_line)
        del engine
        torch.cuda.empty_cache()
    d = pose_dist(poses[torch.bfloat16], poses[torch.float32])
    moved = [float(np.linalg.norm(a.coords.mean(0) - b.coords.mean(0)))
             for a, b in zip(poses[torch.bfloat16], poses[torch.float32])]
    print(f"ablation {name} bf16 vs fp32 engine, {len(d)} atoms: per-atom "
          f"distance mean {d.mean():.3f} A, max {d.max():.3f} A; "
          f"{sum(m > 4.0 for m in moved)} of {len(moved)} ligand centroids "
          f"more than 4 A apart (another pocket), largest "
          f"{max(moved):.3f} A (printed, not gated)")
    return launches, poses[torch.bfloat16]


def start_ablation_exports(buckets) -> dict:
    """Phase 15's exports, started before phase 7 so that they run beside
    phases 7-11: for each of ABLATION_EXPORTS, the seeded weights of
    `fabind` with its flags through cli.export --set (bf16, the small
    bucket, on the card), each in a process of its own. Returns {name:
    process}."""
    shutil.rmtree(ABLATION_EXPORT_ROOT, ignore_errors=True)
    ABLATION_EXPORT_ROOT.mkdir(parents=True)
    procs = {}
    for name in ABLATION_EXPORTS:
        flags = dict(ABLATION_CONFIGS)[name]
        sd = write_seeded_state_dict("fabind",
                                     ABLATION_EXPORT_ROOT / f"{name}.pt",
                                     **flags)
        procs[name] = start_process(
            "fabind_tpu_torch.cli.export",
            export_args("fabind", sd, ABLATION_EXPORT_ROOT / name, "cuda",
                        buckets[0])
            + [f"--set={k}={v}" for k, v in flags.items()],
            ABLATION_EXPORT_ROOT / f"{name}.log", background=True)
    return procs


def ablation_exported(name, proc, reqs, live, card_line):
    """The artifact `start_ablation_exports` wrote for configuration
    `name`, served by DockingEngine.from_exported on the small bucket's
    requests `reqs`: poses bit-equal to the live bf16 engine's `live`, the
    gate launched 33 times per batch (0 for the no-attention stacks).
    Returns {dtype: {bucket: launches}}."""
    what = f"exported ablation {name} bf16"
    finish_export(proc, ABLATION_EXPORT_ROOT / f"{name}.log",
                  f"ablation {name} bf16 small bucket (cuda, own process)",
                  card_line)
    engine = load_exported(ABLATION_EXPORT_ROOT / name, what, card_line)
    per_batch = 0 if name in ABLATION_GATE_FREE else sum(
        s[-1] for s in served_pair_shapes(engine.cfg))
    got, counter, _, _ = serve_main_path(engine, reqs, what,
                                         per_batch=per_batch)
    d = pose_dist(got, live)
    print(f"{what} vs live, {len(reqs)} requests of bucket "
          f"{list(counter.batches)}: max per-atom distance {d.max():.3e} A; "
          f"gate launches {counter.launches} in batches {counter.batches}")
    check(d.max() == 0.0, f"{what}: poses differ from live by {d.max()} A")
    del engine
    torch.cuda.empty_cache()
    return {torch.bfloat16: counter.launches}


class DropoutDraws:
    """While open, predicts the dropout kernel's launches from the modules:
    each active Dropout forward launches once, and once more in the
    backward when its output receives a gradient (a hook on the output
    counts those). Also records the gate launches each recycle round of an
    attention stack predicts (one per InterAttention layer)."""

    def __enter__(self):
        self.forward = self.backward = self.gate = 0
        probe = self
        self.orig = (layers.Dropout.forward, EfficientMCAttModel._step)

        def forward(mod, x, call=0):
            y = probe.orig[0](mod, x, call)
            if mod.active:
                probe.forward += 1
                if y.requires_grad:
                    y.register_hook(probe._count_backward)
            return y

        def step(model, *a, **kw):
            if isinstance(model.gnn, MCAttEGNN) and not model.cfg.is_plus:
                probe.gate += model.gnn.n_layers
            return probe.orig[1](model, *a, **kw)

        layers.Dropout.forward, EfficientMCAttModel._step = forward, step
        return self

    def _count_backward(self, grad):
        self.backward += 1

    def __exit__(self, *exc):
        layers.Dropout.forward, EfficientMCAttModel._step = self.orig


def ablation_train_step(name, cfg, data, buckets, card_line):
    """One fp32 Trainer step of a configuration at dropout 0.1 (recycle
    count drawn) on the large bucket's first batch: finite and not
    skipped, gate and dropout launches as DropoutDraws predicts. Returns
    (gate launches, dropout launches) as {dtype: {bucket: launches}}."""
    large = bucket_label(buckets[-1])
    batch, cfg_b = first_batch(data, cfg, buckets, large)
    held = reset_peak()
    tr = Trainer(cfg, "cuda")
    torch.cuda.synchronize()
    edge_gate.KERNEL.launches = dropout.KERNEL.launches = 0
    t0 = time.perf_counter()
    with DropoutDraws() as draws:
        m = tr.train_step(batch, cfg_b)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    gate, drop = edge_gate.KERNEL.launches, dropout.KERNEL.launches
    what = f"ablation train {name} fp32"
    print(f"{what} step bucket {large}: loss {m['loss']:.6f}, "
          f"{sec * 1e3:.2f} ms; gate launches {gate} (predicted "
          f"{draws.gate}), dropout launches {drop} (predicted "
          f"{draws.forward} forward + {draws.backward} backward) "
          f"[{card_line}]")
    print_peak(what, held, card_line)
    check(m["skipped_nan"] == 0.0, f"{what}: skipped")
    check(all(np.isfinite(v) for v in m.values()), f"{what}: {m}")
    check(gate == draws.gate, f"{what}: {gate} gate launches")
    check(draws.forward > 0 and drop == draws.forward + draws.backward,
          f"{what}: {drop} dropout launches")
    del tr
    torch.cuda.empty_cache()
    return ({torch.float32: {large: gate}}, {torch.float32: {large: drop}})


def ablation_phase(raws, small, buckets, procs, card_line):
    """Phase 15: the ablation and extra configurations (ABLATION_CONFIGS)
    served at released width in bf16 and fp32 over the 32 requests (the
    GVP ones with a seeded backbone), the artifacts of `procs`
    (start_ablation_exports) served on the indices `small` of the small
    bucket's requests, and one fp32 training step per EGNN stack type.
    Returns (gate launches by path, dropout launches by path), each a list
    of (name prefix, {dtype: {bucket: launches}})."""
    t_phase = time.perf_counter()
    full = backbone_requests(raws, BACKBONE_SEED)
    gate_paths, drop_paths = [], []
    for name, flags in ABLATION_CONFIGS:
        cfg = preset("fabind", **flags, **SMOKE_SHAPES)
        reqs = ablation_requests(cfg, raws, full)
        launches, live = ablation_serving(name, cfg, reqs, buckets,
                                          card_line)
        gate_paths.append((f"ablation {name} ", launches))
        if name in procs:
            gate_paths.append((f"ablation exported {name} ",
                               ablation_exported(
                                   name, procs[name],
                                   [reqs[i] for i in small],
                                   [live[i] for i in small], card_line)))
    data = write_npz_dir(raws, ABLATION_ROOT / "data")
    for name in ABLATION_TRAIN:
        cfg = preset("fabind", dropout=ABLATION_DROPOUT,
                     **dict(ABLATION_CONFIGS)[name], **SMOKE_SHAPES)
        gate, drop = ablation_train_step(name, cfg, data, buckets, card_line)
        gate_paths.append((f"ablation train {name} ", gate))
        drop_paths.append((f"ablation train {name} ", drop))
    shutil.rmtree(ABLATION_ROOT, ignore_errors=True)
    shutil.rmtree(ABLATION_EXPORT_ROOT, ignore_errors=True)
    print(f"time ablation phase wall: {time.perf_counter() - t_phase:.1f} s "
          f"[{card_line}]")
    return gate_paths, drop_paths


def same_collation(got: dict, want: dict, what: str) -> None:
    """collate_native's arrays against collate's, field by field: bond_idx
    as per-row sets under the mask and bond_mask by row sums (the packer
    may fill a row's slots in another order), every other field bit for
    bit and of the same dtype."""
    check(set(got) == set(want), f"{what}: fields {set(got) ^ set(want)}")
    for k, w in want.items():
        g = got[k]
        if w is None:
            same = g is None
        elif k == "bond_idx":
            mg, mw = got["bond_mask"], want["bond_mask"]
            same = all(set(g[b, i][mg[b, i]]) == set(w[b, i][mw[b, i]])
                       for b in range(w.shape[0]) for i in range(w.shape[1]))
        elif k == "bond_mask":
            same = np.array_equal(g.sum(-1), w.sum(-1))
        else:
            same = g.dtype == w.dtype and np.array_equal(g, w)
        check(same, f"{what}: collate_native's {k} differs from collate's")


def padded_batches(samples):
    """(samples padded to BATCH with the last one, n_real) per batch of
    BATCH, as the engine and the Loader pad a bucket's last batch."""
    for i in range(0, len(samples), BATCH):
        ss = samples[i:i + BATCH]
        yield ss + [ss[-1]] * (BATCH - len(ss)), len(ss)


def time_collators(samples, cfg_b, n_real, what, card_line) -> None:
    """Host ms of collate and of collate_native on one batch of BATCH
    samples, COLLATE_REPEATS of each in turns: median and range; and of
    the np.zeros of the prot_feat buffer that both fill, the largest."""
    feat = (BATCH, cfg_b.shapes.max_protein, cfg_b.model.protein_feat_dim)
    ms = {collate: [], collate_native: [], "zeros": []}
    for _ in range(COLLATE_REPEATS):
        for fn, times in ms.items():
            t0 = time.perf_counter()
            if fn == "zeros":
                np.zeros(feat, np.float32)
            else:
                fn(samples, cfg_b, n_valid=n_real)
            times.append((time.perf_counter() - t0) * 1e3)
    (p, pt), (n, nt), (z, _) = ((statistics.median(t), t)
                                for t in ms.values())
    print(f"time collate {what} (batch of {BATCH}, {COLLATE_REPEATS} "
          f"repeats): python median {p:.3f} ms (range {min(pt):.3f}-"
          f"{max(pt):.3f}), native median {n:.3f} ms (range "
          f"{min(nt):.3f}-{max(nt):.3f}); python / native {p / n:.3f}x; "
          f"np.zeros of the prot_feat buffer {list(feat)} alone median "
          f"{z:.3f} ms [{card_line}]")


def collate_phase(raws, buckets, card_line):
    """Phase 16: host collation, on the host of the card. The packer's library
    was built in phase 1. collate_native against collate, field by field,
    on every batch of phase 3's 32 requests as the engine routes and pads
    them, and of the requests as NPZ training samples (group train, no
    isomorphisms, routed as the Loader routes them); host ms per batch of
    both collators per bucket and source; one batch of each bucket that
    collate_native built, served by phase 3's bf16 engine (the same seeded
    weights): poses bit-equal to those of the batch collate built, the gate
    launched 33 times. Returns those launches, {bf16: {bucket: n}}."""
    t_phase = time.perf_counter()
    cfg = preset("fabind", **SMOKE_SHAPES)
    engine = DockingEngine(cfg, buckets=buckets, batch_size=BATCH, seed=0)
    per_batch = sum(s[-1] for s in served_pair_shapes(cfg))

    # serving: the engine's own host batches, which collate built
    serving, results, n_batches = {}, [None] * len(raws), 0
    for chunk, cfg_b, arrays, n_real in engine._routed_batches(raws,
                                                               results):
        ss, _ = next(padded_batches([s for _, s in chunk]))
        label = bucket_label(cfg_b.shapes)
        same_collation(collate_native(ss, cfg_b, n_valid=n_real), arrays,
                       f"serving batch {n_batches} bucket {label}")
        serving.setdefault(label, (cfg_b, ss, n_real, arrays))
        n_batches += 1
    check(all(r is None for r in results), "serving: a request failed")

    # training: the requests as NPZ samples of the train group
    src = NPZSource(write_npz_dir(raws, COLLATE_ROOT / "data"))
    rng = np.random.RandomState(REQUEST_SEED)
    train = {}
    for name in src.names:
        raw = src.get(name)
        cfg_b = route_sample(build_sample(raw, cfg, group="test"),
                             engine.bucket_cfgs)
        s = build_sample(raw, cfg, group="train", rng=rng,
                         isomorphisms=raw.get("isomorphisms"))
        check(s["isomorphisms"] is None, f"{name} carries isomorphisms")
        train.setdefault(bucket_label(cfg_b.shapes), (cfg_b, []))[1].append(s)
    for label, (cfg_b, samples) in train.items():
        for i, (ss, n_real) in enumerate(padded_batches(samples)):
            same_collation(collate_native(ss, cfg_b, n_valid=n_real),
                           collate(ss, cfg_b, n_valid=n_real),
                           f"train batch {i} bucket {label}")
            n_batches += 1
    shutil.rmtree(COLLATE_ROOT, ignore_errors=True)
    print(f"collate_native equals collate on {n_batches} batches (serving "
          f"and training, both buckets)")

    for label, (cfg_b, ss, n_real, _) in serving.items():
        time_collators(ss, cfg_b, n_real, f"serving bucket {label}",
                       card_line)
    for label, (cfg_b, samples) in train.items():
        ss, n_real = next(padded_batches(samples))
        time_collators(ss, cfg_b, n_real, f"train bucket {label}", card_line)

    launches = {}
    for label, (cfg_b, ss, n_real, arrays) in serving.items():
        native_batch = engine._to_device(collate_native(ss, cfg_b,
                                                        n_valid=n_real))
        python_batch = engine._to_device(arrays)
        edge_gate.KERNEL.launches = 0
        got = engine.run_batch(native_batch, cfg_b)[0]
        torch.cuda.synchronize()
        launches[label] = edge_gate.KERNEL.launches
        want = engine.run_batch(python_batch, cfg_b)[0]
        same = torch.equal(got, want)
        print(f"bf16 batch bucket {label} collated by collate_native: poses "
              f"{'bit-equal' if same else 'NOT equal'} to the collate "
              f"batch's, edge_gate launches {launches[label]} (expected "
              f"{per_batch})")
        check(same, f"bucket {label}: the native batch's poses differ")
        check(launches[label] == per_batch,
              f"bucket {label}: {launches[label]} gate launches")
    del engine
    torch.cuda.empty_cache()
    print(f"time phase 16 (host collation) wall: "
          f"{time.perf_counter() - t_phase:.1f} s [{card_line}]")
    return {torch.bfloat16: launches}


def time_kernel_rows(served, max_err, paths, sms, clock_hz, card_line):
    """Kernel and plain times at each bucket's shapes, in each dtype: one
    JSON row per (dtype, bucket), means per launch weighted by the launches
    per batch, for each path of `paths` ((name prefix, {dtype: {bucket:
    launches}}): serving, training, evaluation, dock_sdf, exported serving,
    training and evaluation from the processed store, flexible docking)
    that ran in that dtype, with its launch counts (its batches have the
    served shapes)."""
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
            for path, counts in paths:
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
                         "of each bucket, of one training step in fp32 "
                         "and bf16, and of one ESM2 forward, beside PATH")
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
    build_all([edge_gate.KERNEL, dropout.KERNEL])
    print(f"kernel build (edge_gate.cu, dropout.cu in parallel): "
          f"{time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    lib = build_library()
    print(f"host packer build (csrc/collate.cc, C++ compiler): "
          f"{time.perf_counter() - t0:.2f} s -> {lib}")
    for kernel in (edge_gate.KERNEL, dropout.KERNEL):
        for line in kernel.build_log.splitlines():
            if any(k in line for k in ("entry function", "registers",
                                       "spill")):
                print("ptxas:", line.strip())
    print_sass_mufu(edge_gate.KERNEL.lib_path)

    # ---- 2. kernels against their plain versions, at every served shape
    cfg = preset("fabind", **SMOKE_SHAPES)
    buckets = resolve_buckets(BUCKETS, cfg)
    served = {bucket_label(s): served_pair_shapes(cfg.replace(shapes=s))
              for s in buckets}
    max_err = check_kernels(served)
    sampling_buckets = {bucket_label(s): preset(
        "fabind_plus_sampling", **SMOKE_SHAPES).replace(shapes=s)
        for s in buckets}
    drop_err = check_dropout(sampling_buckets)

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
    before = graph_counts()
    poses, counter, launches, _ = serve_main_path(engine, raws, "bf16")
    main_launches = {torch.bfloat16: counter.launches}
    check_graphed(engine, raws, poses, counter, before, "bf16")
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
    before = graph_counts()
    poses32, counter, _, _ = serve_main_path(engine32, raws, "fp32")
    main_launches[torch.float32] = counter.launches
    check_graphed(engine32, raws, poses32, counter, before, "fp32")
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
    plus_poses = plus_phase(raws, buckets, card_line, args.profile)
    torch.cuda.empty_cache()
    best_of_phase(raws, buckets, card_line)

    # ---- 12's, 13's and 15's exports start here, in processes of their
    # own, beside 7-11
    sampling_proc = start_sampling_export(buckets)
    flex_proc = start_flex_export(buckets)
    ablation_procs = start_ablation_exports(buckets)
    try:
        # ---- 7. training
        torch.cuda.empty_cache()
        train_launches = train_phase(raws, card_line, lat16, args.profile)

        # ---- 8. evaluation and confidence training, from phase 7's runs
        torch.cuda.empty_cache()
        eval_launches = eval_phase(raws, card_line)

        # ---- 9. structure files: ESM2, dock_sdf, /dock_sdf and the CLIs
        torch.cuda.empty_cache()
        sdf_launches = sdf_phase(raws, buckets, card_line, args.profile)

        # ---- 10. exported serving: cli.export, from_exported, the daemon
        torch.cuda.empty_cache()
        exported_launches = export_phase(raws, buckets, poses, plus_poses,
                                         card_line)

        # ---- 11. training and evaluation from the processed PDBbind store
        torch.cuda.empty_cache()
        store_train_launches, store_eval_launches = store_phase(
            raws, buckets, card_line)

        # ---- 12. exported best-of-N sampling
        torch.cuda.empty_cache()
        drop_exported, drop_live, gate_sampling = sampling_phase(
            raws, buckets, sampling_proc, card_line)

        # ---- 13. flexible docking: live, the daemon, exported, selftest
        torch.cuda.empty_cache()
        flex_launches = flex_phase(raws, buckets, flex_proc, card_line)

        # ---- 14. data parallelism: two ranks and two replicas on the card
        torch.cuda.empty_cache()
        dp_gate, dp_drop, dp_times = dp_phase(raws, by_bucket, buckets,
                                              poses, poses32, card_line)

        # ---- 15. the ablation and extra configurations, two exported
        torch.cuda.empty_cache()
        small = [i for i, r in enumerate(raws) if any(
            r is q for q in by_bucket[bucket_label(buckets[0])])]
        ablation_gate, ablation_drop = ablation_phase(
            raws, small, buckets, ablation_procs, card_line)
    finally:
        stop_processes([sampling_proc, flex_proc,
                        *ablation_procs.values()])

    # ---- 16. host collation: collate_native against collate
    torch.cuda.empty_cache()
    native_launches = collate_phase(raws, buckets, card_line)

    # ---- 4b. kernel times
    rows = time_kernel_rows(
        served, max_err,
        [("", main_launches), ("train ", train_launches),
         ("evaluate ", eval_launches), ("dock_sdf ", sdf_launches),
         ("exported ", exported_launches),
         ("train store ", store_train_launches),
         ("evaluate store ", store_eval_launches),
         ("exported sampling ", gate_sampling)]
        + [(f"fabflex {path}", counts)
           for path, counts in flex_launches.items()] + dp_gate
        + ablation_gate + [("collate_native ", native_launches)], sms,
        clock_hz, card_line)
    rows += dropout_rows(time_dropout(sampling_buckets, card_line), drop_err,
                         [("exported sampling ", drop_exported),
                          ("sampling ", drop_live)] + ablation_drop)
    rows += dp_dropout_rows(dp_times, dp_drop)
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
