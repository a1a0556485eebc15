"""Docking engine: the serving layer of the port.

Counterpart of fabind_tpu/serve.py `DockingEngine`: load weights once, then
dock prebuilt raw-feature requests in fixed-shape batches, each request
routed to the smallest shape bucket it fits, in bfloat16 by default. Poses
come back in the world frame of the input structure.

- One module with one copy of the weights on the device serves every
  bucket: the bucket's ShapeConfig is passed to its forward.
- bf16 is a whole cast of the weights and of every float field of each batch
  (utils/precision.py), as the JAX engine serves.
- All batches of a call are launched before any result is copied back, so
  the host featurizes and uploads batch i+1 while the device runs batch i.
- Protein rows seen before stay on the device (an LRU keyed by content), so
  a repeated protein skips its upload; `dock_screen` uploads its one protein
  once per bucket.
- FABind+ presets serve the same way; `dock_best_of` runs best-of-N
  sampling (sample.py) and keeps each request's most confident pose.

Example:
    eng = DockingEngine(preset("fabind"), state_dict=sd)   # on the GPU, bf16
    poses = eng.dock_raw(raws)
    poses[0].coords    # [n_atoms, 3] float32
    best = DockingEngine(preset("fabind_plus_sampling"), state_dict=sd_plus
                         ).dock_best_of(raws, sample_size=40, seed=0)

Thread safety: every dock_* method may be called from several threads at
once. The protein-row cache is read and filled under an RLock; the model runs
outside it (its forward keeps no state), so concurrent calls interleave at
batch granularity and give the poses of serial calls. `dock_best_of` turns
dropout on for its own thread only (layers.dropout_rng), so a concurrent
dock_raw on the same engine stays deterministic.
"""
from __future__ import annotations

import hashlib
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from fabind_tpu_torch.config import FABindConfig
from fabind_tpu_torch.data.batching import SampleTooLarge, build_sample, collate
from fabind_tpu_torch.data.buckets import route_sample, sort_bucket_cfgs
from fabind_tpu_torch.data.types import FABindBatch, dummy_arrays, to_device
from fabind_tpu_torch.models.fabind import init_params, make_model
from fabind_tpu_torch.postopt import post_optimize_batch
from fabind_tpu_torch.sample import sample_poses
from fabind_tpu_torch.utils.precision import (cast_batch_bf16,
                                              cast_module_bf16,
                                              cast_tensor_bf16)

_PROT_FIELDS = ("prot_feat", "prot_mask", "prot_xyz")


@dataclass
class Pose:
    """One docking result (world frame of the input structure)."""

    coords: np.ndarray                 # [n_atoms, 3] float32
    confidence: float                  # FABind+ confidence head (0.0 for base)
    error: Optional[str] = None        # set when the request was skipped
    pocket_truncated: int = 0          # predicted-keep residues dropped by
    #                                    the Np bucket (re-dock with a larger
    #                                    bucket when > 0); not measured by
    #                                    dock_best_of


class DockingEngine:
    """Weight-resident batch docking with shape-bucket routing on one
    device.

    Args:
      cfg: FABindConfig (`preset("fabind")`, `"fabind_plus"` or
        `"fabind_plus_sampling"`); cfg.shapes is the largest accepted
        complex size.
      state_dict: port state dict (`train.convert.state_dict_from_flax` or
        `load_torch_checkpoint`), loaded with strict=True. None draws seeded
        random weights from `seed`.
      buckets: optional list of ShapeConfig; each request runs in the
        smallest one it fits. The largest must cover cfg.shapes. Defaults to
        [cfg.shapes].
      batch_size: fixed device batch.
      bf16: serve in bfloat16 (weights and every float field of a batch).
      post_optim_steps: > 0 runs the batched LAS post-optimization
        (postopt.py) on every pose.
      device: "cuda" when None; raises if CUDA is not available. Pass
        device="cpu" to run on the CPU.
      dev_prot_cache: protein rows kept on the device (0 disables).
    """

    def __init__(self, cfg: FABindConfig,
                 state_dict: Optional[Dict[str, torch.Tensor]] = None,
                 buckets: Optional[Sequence] = None, batch_size: int = 8,
                 bf16: bool = True, post_optim_steps: int = 0, device=None,
                 seed: int = 0, dev_prot_cache: int = 32):
        device = torch.device("cuda" if device is None else device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "DockingEngine: CUDA is not available; pass device='cpu' to "
                "run on the CPU")
        # per-process backend flags, as the JAX engine's XLA settings
        if bf16:
            # cuBLAS accumulates bf16 products in fp32 and rounds once, as
            # XLA does; a reduced-precision reduction would round partial
            # sums to bf16 and compute another function
            cuda_matmul = torch.backends.cuda.matmul
            cuda_matmul.allow_bf16_reduced_precision_reduction = False
        else:
            # full-precision fp32 matmuls and convolutions (no TF32)
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.cfg = cfg
        self.batch_size = batch_size
        self.bf16 = bf16
        self.dtype = torch.bfloat16 if bf16 else torch.float32
        self.post_optim_steps = post_optim_steps
        self.device = device
        self.bucket_cfgs = sort_bucket_cfgs(cfg, buckets)
        model = make_model(cfg)
        if state_dict is None:
            init_params(model, torch.Generator().manual_seed(seed))
        else:
            model.load_state_dict(state_dict, strict=True)
        model = model.to(self.device).eval()
        self.model = cast_module_bf16(model) if bf16 else model
        self.dev_prot_cache = dev_prot_cache
        self._dev_prot_rows: "OrderedDict[tuple, Dict[str, torch.Tensor]]" = \
            OrderedDict()
        self._lock = threading.RLock()

    # ------------------------------------------------------------- routing
    def _route(self, s: Dict) -> FABindConfig:
        c = route_sample(s, self.bucket_cfgs)
        if c is None:
            big = self.bucket_cfgs[-1].shapes
            raise SampleTooLarge(
                f"complex (lig {s['lig_feat'].shape[0]}, "
                f"prot {s['prot_xyz'].shape[0]}, "
                f"bond_deg {s['bond_deg']}) exceeds every bucket "
                f"(largest: lig {big.max_ligand}, prot {big.max_protein}, "
                f"bond_k {big.bond_k})")
        return c

    def _routed_batches(self, raws: Sequence[Dict[str, np.ndarray]],
                        results: List[Optional[Pose]]):
        """Route requests to buckets and yield fixed-size host batches
        (chunk [(req_pos, sample)...], cfg_b, arrays, n_real). Requests that
        fail to featurize or fit no bucket are written to `results` as error
        Poses."""
        by_bucket: Dict[int, Tuple[FABindConfig, List[Tuple[int, Dict]]]] = {}
        for pos, raw in enumerate(raws):
            try:
                s = build_sample(raw, self.cfg, group="test")
                cfg_b = self._route(s)
            except Exception as e:   # skip-and-continue per request
                results[pos] = Pose(coords=np.zeros((0, 3), np.float32),
                                    confidence=0.0,
                                    error=f"{type(e).__name__}: {e}")
                continue
            by_bucket.setdefault(id(cfg_b), (cfg_b, []))[1].append((pos, s))
        for cfg_b, items in by_bucket.values():
            for i in range(0, len(items), self.batch_size):
                chunk = items[i:i + self.batch_size]
                ss = [s for _, s in chunk]
                ss += [ss[-1]] * (self.batch_size - len(ss))
                yield chunk, cfg_b, collate(ss, cfg_b, n_valid=len(chunk)), \
                    len(chunk)

    # ------------------------------------------------------------- batches
    def _to_device(self, arrays: Dict, prot: Optional[Dict] = None
                   ) -> FABindBatch:
        """Host arrays -> a batch on the engine's device in its dtype; the
        protein fields come from `prot` (already on the device) when
        given."""
        batch = FABindBatch.from_numpy(dict(arrays, **(prot or {})),
                                       self.device)
        return cast_batch_bf16(batch) if self.bf16 else batch

    def _cached_prot(self, arrays: Dict, chunk, n_real: int
                     ) -> Dict[str, torch.Tensor]:
        """The batch's protein fields stacked from device-resident rows,
        keyed by (Nr, dtype, sha1 of the unpadded ESM features and CA
        coords); only rows not seen before are uploaded. Bit-identical to
        uploading the whole batch: a cached row is the collated, cast row.
        {} when the cache is off."""
        if not self.dev_prot_cache:
            return {}
        B, nr = arrays["prot_feat"].shape[:2]
        keys = []
        for b in range(B):
            _, s = chunk[min(b, n_real - 1)]   # padding rows repeat the last
            h = hashlib.sha1()
            h.update(np.ascontiguousarray(s["prot_feat"]).tobytes())
            h.update(np.ascontiguousarray(s["prot_xyz"]).tobytes())
            keys.append((nr, self.dtype, h.hexdigest()))
        cast = cast_tensor_bf16 if self.bf16 else (lambda t: t)
        with self._lock:
            rows = []
            for b, key in enumerate(keys):
                if key in self._dev_prot_rows:
                    self._dev_prot_rows.move_to_end(key)
                else:
                    self._dev_prot_rows[key] = {
                        f: cast(to_device(torch.from_numpy(arrays[f][b]),
                                          self.device))
                        for f in _PROT_FIELDS}
                rows.append(self._dev_prot_rows[key])
            while len(self._dev_prot_rows) > self.dev_prot_cache:
                self._dev_prot_rows.popitem(last=False)
        return {f: torch.stack([r[f] for r in rows]) for f in _PROT_FIELDS}

    def batches(self, raws: Sequence[Dict[str, np.ndarray]],
                results: List[Optional[Pose]]):
        """Featurize, route and upload requests: yields device batches
        (chunk [(req_pos, sample)...], cfg_b, batch, n_real). Failed
        requests are written to `results` as error Poses."""
        for chunk, cfg_b, arrays, n_real in self._routed_batches(raws,
                                                                 results):
            yield chunk, cfg_b, self._to_device(
                arrays, self._cached_prot(arrays, chunk, n_real)), n_real

    def run_batch(self, batch: FABindBatch, cfg_b: FABindConfig):
        """(coords [B,Nc,3], confidence [B], pocket_overflow [B]) for one
        batch of bucket cfg_b, on the device and not waited for;
        post-optimized when post_optim_steps > 0."""
        with torch.inference_mode():
            coords, conf, overflow = self.model.inference_diag(
                batch, shapes=cfg_b.shapes)
        return self._post_optimize(coords, batch), conf, overflow

    def _best_of_batch(self, batch: FABindBatch, cfg_b: FABindConfig,
                      sample_size: int, seed: int, batch_idx: int):
        """Best-of-N for one batch of bucket cfg_b: (the most confident of
        `sample_size` sampled poses [B,Nc,3] in float32, its confidence [B],
        zeros [B]: the crop's overflow is not measured on this path), on
        the device. The winner is post-optimized when post_optim_steps > 0,
        in float32 as the JAX package does: in bf16 a coordinate near 32 A
        moves in steps of 0.25 A, and most lr-0.1 Adam updates round
        away."""
        coords, scores = sample_poses(self.model, batch, cfg_b, sample_size,
                                      seed=seed, batch_idx=batch_idx)
        best = scores.float().argmax(0)                       # [B]
        rows = torch.arange(best.shape[0], device=best.device)
        return (self._post_optimize(coords[best, rows].float(), batch),
                scores[best, rows], torch.zeros_like(best))

    def _post_optimize(self, coords, batch: FABindBatch):
        if not self.post_optim_steps:
            return coords
        return post_optimize_batch(coords, batch.lig_rdkit_coords,
                                   batch.las_adj, batch.lig_mask,
                                   steps=self.post_optim_steps)[0]

    @staticmethod
    def _collect(inflight, results: List[Optional[Pose]]) -> None:
        """Copy launched batches back in order and unpack per-request
        Poses (float32: numpy has no bf16)."""
        for chunk, n_real, out in inflight:
            lig, conf = (t.float().cpu().numpy() for t in out[:2])
            overflow = out[2].cpu().numpy()
            for b in range(n_real):
                pos, s = chunk[b]
                n = s["lig_feat"].shape[0]
                results[pos] = Pose(
                    coords=lig[b, :n] + s["coord_offset"],
                    confidence=float(conf[b]),
                    pocket_truncated=int(overflow[b]))

    # ------------------------------------------------------------- serving
    def warmup(self) -> float:
        """Run one dummy batch per bucket through the model now (builds or
        loads the kernels, warms cuBLAS and the allocator), so the first
        request of each bucket is served at steady-state latency. Returns
        seconds spent."""
        t0 = time.perf_counter()
        for c in self.bucket_cfgs:
            arrays = dummy_arrays(c.shapes, batch_size=self.batch_size,
                                  feat_dim=c.model.compound_feat_dim,
                                  prot_feat_dim=c.model.protein_feat_dim)
            self.run_batch(self._to_device(arrays), c)[0].cpu()
        return time.perf_counter() - t0

    def dock_raw(self, raws: Sequence[Dict[str, np.ndarray]]) -> List[Pose]:
        """Dock prebuilt raw-feature dicts (see data.batching.build_sample
        for the schema). Returns one Pose per request, in request order;
        requests that fail featurization or routing come back as
        Pose(error=...). Every batch is launched before any result is
        copied back."""
        results: List[Optional[Pose]] = [None] * len(raws)
        inflight = [(chunk, n_real, self.run_batch(batch, cfg_b))
                    for chunk, cfg_b, batch, n_real
                    in self.batches(raws, results)]
        self._collect(inflight, results)
        return results   # type: ignore[return-value]

    def dock_best_of(self, raws: Sequence[Dict[str, np.ndarray]],
                     sample_size: int = 40, seed: int = 0) -> List[Pose]:
        """FABind+ best-of-N sampling: `sample_size` stochastic docking
        passes per request (dropout on, host DBSCAN pocket centers when
        cfg.model.use_clustering), each request's pose with the highest
        confidence kept. Routing, the protein-row cache, the bf16 cast and
        the post-optimization (of the winner only) are dock_raw's. The same
        seed on the same device gives the same poses. Needs a confidence
        head (preset "fabind_plus_sampling"); pocket_truncated is not
        measured on this path."""
        if not self.cfg.model.confidence_training:
            raise ValueError("dock_best_of ranks poses by the confidence "
                             "head: serve preset 'fabind_plus_sampling'")
        if sample_size < 1:
            raise ValueError(f"sample_size {sample_size} < 1")
        results: List[Optional[Pose]] = [None] * len(raws)
        inflight = [(chunk, n_real,
                     self._best_of_batch(batch, cfg_b, sample_size, seed, bi))
                    for bi, (chunk, cfg_b, batch, n_real)
                    in enumerate(self.batches(raws, results))]
        self._collect(inflight, results)
        return results   # type: ignore[return-value]

    def dock_screen(self, protein_raw: Dict[str, np.ndarray],
                    ligand_raws: Sequence[Dict[str, np.ndarray]]
                    ) -> List[Pose]:
        """Virtual screening: many ligands against one protein. The protein
        tensors (protein_xyz [Nr,3], esm_feat [Nr,1280] in `protein_raw`)
        go to the device once per shape bucket and are shared by every batch
        of the screen; only the ligand tensors travel per batch. Same poses
        as dock_raw of each ligand with the protein."""
        pkeys = [k for k in ("protein_xyz", "esm_feat", "protein_full_coords")
                 if k in protein_raw]
        raws = [dict(lig, **{k: protein_raw[k] for k in pkeys})
                for lig in ligand_raws]
        results: List[Optional[Pose]] = [None] * len(raws)
        dev_prot: Dict[int, Dict[str, torch.Tensor]] = {}
        inflight = []
        for chunk, cfg_b, arrays, n_real in self._routed_batches(raws,
                                                                 results):
            batch = self._to_device(arrays, dev_prot.get(id(cfg_b)))
            dev_prot.setdefault(id(cfg_b), {f: getattr(batch, f)
                                            for f in _PROT_FIELDS})
            inflight.append((chunk, n_real, self.run_batch(batch, cfg_b)))
        self._collect(inflight, results)
        return results   # type: ignore[return-value]
