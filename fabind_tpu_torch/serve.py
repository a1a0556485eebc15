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
- Preset "fabflex" (flexible docking) serves the same way too; its Poses
  also carry the docked pocket: the moved pocket residues' coordinates
  and their indices into the protein.
- `DockingEngine.from_exported(dir)` serves the per-bucket programs of an
  artifact directory (aot.py, cli/export.py) without building the model;
  `dock_best_of` too when the artifact holds the sampling programs
  (`cli.export --sampling`).
- `DockingEngine(dp=N)` serves data-parallel over N devices (JAX's
  `dp`): a replica of the weights on each (parallel.dp.ReplicaSet), each
  batch's rows split into N contiguous blocks that run on their replicas
  in threads of their own and come back in row order. Every dock_* method
  runs so, best-of-N included (its host step between the halves stays on
  the whole batch). Each replica keeps its own protein-row cache.
- Tracing (utils/tracing.py): while it is on or a profiler records, a
  dock_* call records spans serve.call, serve.featurize, serve.collate,
  serve.upload, serve.run_batch, serve.postopt and serve.collect, a
  batch's spans carrying its index in the call and its bucket; always, it
  counts
  requests, failures, batches and padding rows by bucket, real and padded
  cells, and protein-row cache hits and misses (GET /health reports them).
- `dock_sdf` docks (ligand SDF, protein PDB) pairs: the files are parsed
  and featurized on the host without RDKit (data/featurize.py), each
  protein is embedded once by the engine's ESM2 encoder (`esm`) and kept
  in a host LRU, and each Pose carries what `featurize.write_sdf` needs to
  write the docked ligand.

Example:
    eng = DockingEngine(preset("fabind"), state_dict=sd)   # on the GPU, bf16
    poses = eng.dock_raw(raws)
    poses[0].coords    # [n_atoms, 3] float32
    sdf_poses = DockingEngine(preset("fabind"), state_dict=sd,
                              esm=load_esm2("esm2_t33_650M/")
                              ).dock_sdf([("lig.sdf", "prot.pdb")])
    best = DockingEngine(preset("fabind_plus_sampling"), state_dict=sd_plus
                         ).dock_best_of(raws, sample_size=40, seed=0)

Thread safety: every dock_* method may be called from several threads at
once. The protein-row cache is read and filled under an RLock; the model runs
outside it (its forward keeps no state), and an exported program runs under
the artifact's own lock one call at a time (aot.ExportedInference), so
concurrent calls interleave at program-call granularity (a best-of-N pass
releases it between its halves) and give the poses of serial calls. A protein's ESM2 forward runs under a lock of its own path,
not the engine's, so it does not stall requests for other proteins.
`dock_best_of` turns dropout on for its own thread only
(layers.dropout_seed), so a concurrent dock_raw on the same engine stays
deterministic.
"""
from __future__ import annotations

import hashlib
import itertools
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from fabind_tpu_torch.config import FABindConfig
from fabind_tpu_torch.data import featurize as F
from fabind_tpu_torch.data.batching import (SampleTooLarge, build_sample,
                                            collate, uniform_random_rotation)
from fabind_tpu_torch.data.buckets import route_sample, sort_bucket_cfgs
from fabind_tpu_torch.data.torsion import randomize_torsions
from fabind_tpu_torch.data.types import FABindBatch, dummy_arrays, to_device
from fabind_tpu_torch.models.fabind import init_params, make_model
from fabind_tpu_torch.parallel.dp import ReplicaSet, dp_devices
from fabind_tpu_torch.postopt import post_optimize_batch
from fabind_tpu_torch.sample import sample_poses
from fabind_tpu_torch.train.convert import drop_dead_keys
from fabind_tpu_torch.utils import tracing
from fabind_tpu_torch.utils.precision import (cast_batch_bf16,
                                              cast_module_bf16,
                                              cast_tensor_bf16)

_PROT_FIELDS = ("prot_feat", "prot_mask", "prot_xyz")
_PROTEIN_LRU = 256      # proteins whose structure and embedding are kept


@dataclass
class Pose:
    """One docking result (world frame of the input structure)."""

    coords: np.ndarray                 # [n_atoms, 3] float32
    confidence: float                  # FABind+ confidence head (0.0 for base)
    pocket_coords: Optional[np.ndarray] = None    # [n_pocket, 3] float32
    pocket_residues: Optional[np.ndarray] = None  # [n_pocket] residue
    #                                    indices; both set by flexible
    #                                    engines only (not dock_best_of)
    error: Optional[str] = None        # set when the request was skipped
    sdf_meta: Optional[Dict] = None    # symbols/bonds/charges (dock_sdf),
    #                                    what featurize.write_sdf needs
    pocket_truncated: int = 0          # predicted-keep residues dropped by
    #                                    the Np bucket (re-dock with a larger
    #                                    bucket when > 0); not measured by
    #                                    dock_best_of


def _resolve_device(device) -> torch.device:
    """`device`, cuda when None; cuda raises when it is not available."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "DockingEngine: CUDA is not available; pass device='cpu' to "
            "run on the CPU")
    return device


def _count_batch(chunk, shapes, bucket: str, batch_size: int) -> None:
    """Count one collated batch of `bucket`: the batch, its padding rows
    (repeats of the last request), and its real cells (ligand atoms x
    residues of each request) against its padded ones (rows x Nc x Nr)."""
    tracing.count("serve.batches", key=bucket)
    tracing.count("serve.padding_rows", batch_size - len(chunk), key=bucket)
    tracing.count("serve.cells_real", sum(
        s["lig_feat"].shape[0] * s["prot_xyz"].shape[0] for _, s in chunk))
    tracing.count("serve.cells_padded",
                  batch_size * shapes.max_ligand * shapes.max_protein)


def _call_ids(engine: "DockingEngine", *_) -> Dict:
    """The ids of a new dock_* call's span: its number in the engine."""
    return {"call": next(engine._calls)}


def _batch_ids(engine: "DockingEngine", *_) -> Dict:
    """The ids of the calling thread's current batch (its index in the call
    and its bucket, set by _routed_batches), for its upload and run."""
    return getattr(engine._tls, "ids", {})


class DockingEngine:
    """Weight-resident batch docking with shape-bucket routing on one
    device, or data-parallel over several.

    Args:
      cfg: FABindConfig (`preset("fabind")`, `"fabind_plus"`,
        `"fabind_plus_sampling"` or `"fabflex"`); cfg.shapes is the
        largest accepted complex size.
      state_dict: port state dict (`train.convert.state_dict_from_flax` or
        `load_torch_checkpoint`), loaded with strict=True after the
        reference's dead ablation keys the model lacks are dropped
        (`train.convert.drop_dead_keys`). None draws seeded random weights
        from `seed`.
      buckets: optional list of ShapeConfig; each request runs in the
        smallest one it fits. The largest must cover cfg.shapes. Defaults to
        [cfg.shapes].
      batch_size: fixed device batch.
      bf16: serve in bfloat16 (weights and every float field of a batch).
      post_optim_steps: > 0 runs the batched LAS post-optimization
        (postopt.py) on every pose.
      device: "cuda" when None; raises if CUDA is not available. Pass
        device="cpu" to run on the CPU. A sequence of devices puts one
        replica on each (a device may repeat).
      dp: replicas, one per card cuda:0..dp-1 (0: every visible card;
        raises when fewer are visible), or dp CPU replicas with
        device="cpu". batch_size must divide by the replica count: each
        replica docks a contiguous block of batch_size / dp rows.
      dev_prot_cache: protein rows kept on each replica's device (0
        disables).
      esm: an `models.esm2.Esm2Model` that embeds the proteins of
        `dock_sdf`, moved to the engine's device in float32 (the JAX
        package's embedding dtype, whatever `bf16` says). Without it a
        request that names a PDB file comes back as an error Pose.
    """

    def __init__(self, cfg: FABindConfig,
                 state_dict: Optional[Dict[str, torch.Tensor]] = None,
                 buckets: Optional[Sequence] = None, batch_size: int = 8,
                 bf16: bool = True, post_optim_steps: int = 0, device=None,
                 seed: int = 0, dev_prot_cache: int = 32, esm=None,
                 dp: int = 1):
        if isinstance(device, (list, tuple)):
            if dp not in (1, len(device)):
                raise ValueError(f"dp {dp} with {len(device)} devices")
            devices = [_resolve_device(d) for d in device]
        elif dp == 1:
            devices = [_resolve_device(device)]
        else:
            devices = dp_devices(device, dp)
        self._setup(cfg, sort_bucket_cfgs(cfg, buckets), batch_size, bf16,
                    post_optim_steps, devices, dev_prot_cache, esm)
        model = make_model(cfg)
        if state_dict is None:
            init_params(model, torch.Generator().manual_seed(seed))
        else:
            model.load_state_dict(drop_dead_keys(state_dict,
                                                 model.state_dict()),
                                  strict=True)
        model = model.eval()
        self.replicas = ReplicaSet(cast_module_bf16(model) if bf16 else model,
                                   devices)
        self.model = self.replicas.modules[0]
        self._exported = None

    def _setup(self, cfg: FABindConfig, bucket_cfgs, batch_size: int,
               bf16: bool, post_optim_steps: int, devices,
               dev_prot_cache: int, esm) -> None:
        """What a live and an exported engine share: the replicas' devices,
        the process's backend flags, the buckets, the caches and the
        encoder (on the first device)."""
        device = devices[0]
        if batch_size % len(devices):
            raise ValueError(f"batch_size {batch_size} not divisible by dp "
                             f"{len(devices)}")
        # per-process backend flags, as the JAX engine's XLA settings
        if bf16:
            # cuBLAS accumulates bf16 products in fp32 and rounds once, as
            # XLA does; a reduced-precision reduction would round partial
            # sums to bf16 and compute another function
            cuda_matmul = torch.backends.cuda.matmul
            cuda_matmul.allow_bf16_reduced_precision_reduction = False
        if not bf16 or esm is not None:
            # full-precision fp32 matmuls and convolutions (no TF32), for
            # the fp32 model and for the float32 encoder
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.cfg = cfg
        self.batch_size = batch_size
        self.bf16 = bf16
        self.dtype = torch.bfloat16 if bf16 else torch.float32
        self.post_optim_steps = post_optim_steps
        self.device = device
        self.devices = devices
        self.bucket_cfgs = bucket_cfgs
        self.dev_prot_cache = dev_prot_cache
        # one protein-row LRU per replica
        self._prot_rows: List["OrderedDict[tuple, Dict[str, torch.Tensor]]"] \
            = [OrderedDict() for _ in devices]
        self._lock = threading.RLock()
        self.esm = (None if esm is None
                    else esm.to(self.device, torch.float32).eval())
        self._protein_cache: "OrderedDict[str, tuple]" = OrderedDict()
        self._protein_locks: Dict[str, threading.Lock] = {}
        self._calls = itertools.count()      # serve.call's id
        self._tls = threading.local()        # this thread's batch ids

    @classmethod
    def from_exported(cls, path: str, post_optim_steps: Optional[int] = None,
                      device=None, dev_prot_cache: int = 32,
                      esm=None) -> "DockingEngine":
        """Serve an artifact directory of `aot.export_inference` (or
        `cli.export`) instead of the model's code and a checkpoint: each
        bucket's batch runs its exported program, with the weights baked
        in, so no FABind module is built (`model` is None). The config,
        buckets, batch size and dtype come from the manifest. Routing, the
        protein-row cache, dock_raw, dock_screen, dock_sdf and warmup are
        the live engine's; dock_best_of runs the artifact's sampling halves
        and raises with a re-export hint when it has none.

        The manifest's post-optimization steps run after the program with
        the live engine's function; a `post_optim_steps` other than the
        manifest's raises, as the count is fixed at export time."""
        from fabind_tpu_torch.aot import ExportedInference, read_manifest

        device = _resolve_device(device)
        baked = read_manifest(path)["post_optim_steps"]
        if post_optim_steps is not None and post_optim_steps != baked:
            raise ValueError(
                f"post_optim_steps is baked into the artifact at export "
                f"time (artifact: {baked}, requested: {post_optim_steps}) "
                f"— re-export with the desired value")
        ex = ExportedInference(path, device)
        self = cls.__new__(cls)
        # the backend flags too: the programs compute the exported function
        # only under them
        self._setup(ex.cfg, ex.bucket_cfgs, ex.batch_size, ex.bf16,
                    ex.post_optim_steps, [ex.device], dev_prot_cache, esm)
        self.replicas = ReplicaSet(None, [ex.device])
        self.model = None
        self._exported = ex
        return self

    @property
    def _dev_prot_rows(self) -> "OrderedDict[tuple, Dict[str, torch.Tensor]]":
        """The first replica's protein-row cache."""
        return self._prot_rows[0]

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
        Poses. While a batch is out, this thread's batch ids (`_batch_ids`)
        are its own."""
        by_bucket: Dict[int, Tuple[FABindConfig, List[Tuple[int, Dict]]]] = {}
        tracing.count("serve.requests", len(raws))
        with tracing.span("serve.featurize"):
            for pos, raw in enumerate(raws):
                try:
                    s = build_sample(raw, self.cfg, group="test")
                    cfg_b = self._route(s)
                except Exception as e:   # skip-and-continue per request
                    tracing.count("serve.requests_failed")
                    results[pos] = Pose(coords=np.zeros((0, 3), np.float32),
                                        confidence=0.0,
                                        error=f"{type(e).__name__}: {e}")
                    continue
                by_bucket.setdefault(id(cfg_b), (cfg_b, []))[1].append(
                    (pos, s))
        bi = 0
        try:
            for cfg_b, items in by_bucket.values():
                sh = cfg_b.shapes
                bucket = f"{sh.max_ligand}x{sh.max_pocket}x{sh.max_protein}"
                for i in range(0, len(items), self.batch_size):
                    chunk = items[i:i + self.batch_size]
                    ss = [s for _, s in chunk]
                    ss += [ss[-1]] * (self.batch_size - len(ss))
                    self._tls.ids = {"batch": bi, "bucket": bucket}
                    with tracing.span("serve.collate", **self._tls.ids):
                        arrays = collate(ss, cfg_b, n_valid=len(chunk))
                    _count_batch(chunk, sh, bucket, self.batch_size)
                    bi += 1
                    yield chunk, cfg_b, arrays, len(chunk)
        finally:
            self._tls.__dict__.pop("ids", None)

    # ------------------------------------------------------------- batches
    def _to_device(self, arrays: Dict, prot: Optional[Dict] = None,
                   r: int = 0) -> FABindBatch:
        """Host arrays -> a batch on replica r's device in the engine's
        dtype; the protein fields come from `prot` (already on that
        device) when given."""
        batch = FABindBatch.from_numpy(dict(arrays, **(prot or {})),
                                       self.devices[r])
        return cast_batch_bf16(batch) if self.bf16 else batch

    def _cached_prot(self, arrays: Dict, chunk, n_real: int, r: int = 0,
                     start: int = 0) -> Dict[str, torch.Tensor]:
        """The protein fields of host rows `arrays` (rows start.. of the
        batch) stacked from replica r's device-resident rows, keyed by
        (Nr, dtype, sha1 of the unpadded ESM features and CA coords); only
        rows not seen before are uploaded. Bit-identical to uploading the
        rows: a cached row is the collated, cast row. {} when the cache is
        off."""
        if not self.dev_prot_cache:
            return {}
        B, nr = arrays["prot_feat"].shape[:2]
        keys = []
        for b in range(start, start + B):
            _, s = chunk[min(b, n_real - 1)]   # padding rows repeat the last
            h = hashlib.sha1()
            h.update(np.ascontiguousarray(s["prot_feat"]).tobytes())
            h.update(np.ascontiguousarray(s["prot_xyz"]).tobytes())
            keys.append((nr, self.dtype, h.hexdigest()))
        cast = cast_tensor_bf16 if self.bf16 else (lambda t: t)
        cache = self._prot_rows[r]
        with self._lock:
            rows = []
            for b, key in enumerate(keys):
                if key in cache:
                    tracing.count("serve.prot_rows_hit")
                    cache.move_to_end(key)
                else:
                    tracing.count("serve.prot_rows_miss")
                    cache[key] = {
                        f: cast(to_device(torch.from_numpy(arrays[f][b]),
                                          self.devices[r]))
                        for f in _PROT_FIELDS}
                rows.append(cache[key])
            while len(cache) > self.dev_prot_cache:
                cache.popitem(last=False)
        return {f: torch.stack([row[f] for row in rows])
                for f in _PROT_FIELDS}

    @tracing.spanned("serve.upload", _batch_ids)
    def _upload(self, arrays: Dict, chunk, n_real: int,
                prot: Optional[List[Dict]] = None):
        """A host batch on the device: one FABindBatch, or with several
        replicas a list of each one's contiguous block of rows. `prot`
        gives each replica's protein fields; else they come from its
        cache."""
        if len(self.devices) == 1:
            return self._to_device(arrays, prot[0] if prot else
                                   self._cached_prot(arrays, chunk, n_real))
        blocks = []
        for r, rows in enumerate(self.replicas.blocks(
                arrays["prot_feat"].shape[0])):
            part = {k: None if v is None else v[rows]
                    for k, v in arrays.items()}
            blocks.append(self._to_device(
                part, prot[r] if prot else self._cached_prot(
                    part, chunk, n_real, r, rows.start), r))
        return blocks

    def batches(self, raws: Sequence[Dict[str, np.ndarray]],
                results: List[Optional[Pose]]):
        """Featurize, route and upload requests: yields device batches
        (chunk [(req_pos, sample)...], cfg_b, batch, n_real), where batch
        is a FABindBatch, or with several replicas the list of their
        blocks. Failed requests are written to `results` as error Poses."""
        for chunk, cfg_b, arrays, n_real in self._routed_batches(raws,
                                                                 results):
            yield chunk, cfg_b, self._upload(arrays, chunk, n_real), n_real

    def _blocks(self, batch) -> list:
        """A batch as one block per replica: the list `batches` gives, or
        a FABindBatch split by rows."""
        return batch if isinstance(batch, list) else self.replicas.split(
            batch)

    @tracing.spanned("serve.run_batch", _batch_ids)
    def run_batch(self, batch, cfg_b: FABindConfig):
        """(coords [B,Nc,3], confidence [B], pocket_overflow [B]) for one
        batch of bucket cfg_b (a FABindBatch, or the replicas' blocks), on
        the (first) device and not waited for; post-optimized when
        post_optim_steps > 0. A flexible config also returns the docked
        pocket, in an exported program's order: (coords, confidence,
        pocket_coords [B,Np,3], pkt_idx [B,Np], pkt_mask [B,Np],
        pocket_overflow). Each replica runs its block in its own thread."""
        return self.replicas.gather(self.replicas.map(
            lambda r, b: self._run_block(r, b, cfg_b), self._blocks(batch)))

    def _run_block(self, r: int, batch: FABindBatch, cfg_b: FABindConfig):
        """run_batch of replica r's block."""
        with torch.inference_mode():
            if self._exported is not None:
                out = self._exported.fn(cfg_b)(batch)
            elif cfg_b.model.flexible_docking:
                coords, pkt, idx, mask, conf, overflow = \
                    self.replicas.modules[r].inference_flexible_diag(
                        batch, shapes=cfg_b.shapes)
                out = (coords, conf, pkt, idx, mask, overflow)
            else:
                out = self.replicas.modules[r].inference_diag(
                    batch, shapes=cfg_b.shapes)
        return (self._post_optimize(out[0], batch), *out[1:])

    @tracing.spanned("serve.run_batch", _batch_ids)
    def _best_of_batch(self, batch, cfg_b: FABindConfig,
                      sample_size: int, seed: int, batch_idx: int):
        """Best-of-N for one batch of bucket cfg_b: (the most confident of
        `sample_size` sampled poses [B,Nc,3] in float32, its confidence [B],
        zeros [B]: the crop's overflow is not measured on this path), on
        the (first) device. The winner is post-optimized when
        post_optim_steps > 0, in float32 as the JAX package does: in bf16 a
        coordinate near 32 A moves in steps of 0.25 A, and most lr-0.1 Adam
        updates round away. With several replicas the passes run per
        replica (sample.sample_poses)."""
        blocks = self._blocks(batch)
        if self._exported is not None:
            coords, scores = sample_poses(
                None, blocks[0], cfg_b, sample_size, seed=seed,
                batch_idx=batch_idx,
                halves=self._exported.sampling_halves(cfg_b))
        elif len(blocks) == 1:
            coords, scores = sample_poses(self.model, blocks[0], cfg_b,
                                          sample_size, seed=seed,
                                          batch_idx=batch_idx)
        else:
            coords, scores = sample_poses(None, blocks, cfg_b, sample_size,
                                          seed=seed, batch_idx=batch_idx,
                                          replicas=self.replicas)
        best = scores.float().argmax(0)                       # [B]
        rows = torch.arange(best.shape[0], device=best.device)
        win = coords[best, rows].float()
        if self.post_optim_steps:
            win = self.replicas.gather(self.replicas.map(
                lambda r, w, b: self._post_optimize(w, b),
                [win[s].to(d) for s, d in zip(
                    self.replicas.blocks(win.shape[0]), self.devices)],
                blocks))
        return win, scores[best, rows], torch.zeros_like(best)

    def _post_optimize(self, coords, batch: FABindBatch):
        if not self.post_optim_steps:
            return coords
        with tracing.span("serve.postopt"):
            return post_optimize_batch(coords, batch.lig_rdkit_coords,
                                       batch.las_adj, batch.lig_mask,
                                       steps=self.post_optim_steps)[0]

    @staticmethod
    @tracing.spanned("serve.collect")
    def _collect(inflight, results: List[Optional[Pose]]) -> None:
        """Copy launched batches back in order and unpack per-request
        Poses (float32: numpy has no bf16), with the docked pocket's real
        rows when a batch's output holds one (run_batch)."""
        for chunk, n_real, out in inflight:
            lig, conf = (t.float().cpu().numpy() for t in out[:2])
            overflow = out[-1].cpu().numpy()
            pocket = None
            if len(out) == 6:
                pkt = out[2].float().cpu().numpy()
                idx, mask = (t.cpu().numpy() for t in out[3:5])
                pocket = pkt, idx, mask
            for b in range(n_real):
                pos, s = chunk[b]
                n = s["lig_feat"].shape[0]
                off = s["coord_offset"]
                pose = Pose(coords=lig[b, :n] + off,
                            confidence=float(conf[b]),
                            pocket_truncated=int(overflow[b]))
                if pocket is not None:
                    pkt, idx, mask = pocket
                    pose.pocket_coords = pkt[b][mask[b]] + off
                    pose.pocket_residues = idx[b][mask[b]]
                results[pos] = pose

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

    @tracing.spanned("serve.call", _call_ids)
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

    @tracing.spanned("serve.call", _call_ids)
    def dock_best_of(self, raws: Sequence[Dict[str, np.ndarray]],
                     sample_size: int = 40, seed: int = 0) -> List[Pose]:
        """FABind+ best-of-N sampling: `sample_size` stochastic docking
        passes per request (dropout on, host DBSCAN pocket centers when
        cfg.model.use_clustering), each request's pose with the highest
        confidence kept. Routing, the protein-row cache, the bf16 cast and
        the post-optimization (of the winner only) are dock_raw's. The same
        seed gives the same poses, live or from an artifact exported with
        its sampling programs (whose halves run here instead of the
        model's). Needs a confidence head (preset "fabind_plus_sampling");
        pocket_truncated is not measured on this path."""
        if self._exported is not None and not self._exported.sampling:
            from fabind_tpu_torch.aot import NO_SAMPLING
            raise ValueError(NO_SAMPLING)
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

    @tracing.spanned("serve.call", _call_ids)
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
        # per bucket, each replica's protein fields of its rows
        dev_prot: Dict[int, List[Dict[str, torch.Tensor]]] = {}
        inflight = []
        for chunk, cfg_b, arrays, n_real in self._routed_batches(raws,
                                                                 results):
            prot = dev_prot.get(id(cfg_b))
            if prot is None:
                # the screen's one protein goes to each device once
                prot = [{} for _ in self.devices]
            batch = self._upload(arrays, chunk, n_real, prot)
            dev_prot.setdefault(id(cfg_b), [
                {f: getattr(b, f) for f in _PROT_FIELDS}
                for b in self._blocks(batch)])
            inflight.append((chunk, n_real, self.run_batch(batch, cfg_b)))
        self._collect(inflight, results)
        return results   # type: ignore[return-value]

    # ------------------------------------------------------ structure files
    def _protein_raw(self, pdb_path: str):
        """(structure, ESM2 embedding) of a PDB file, LRU-cached for 256
        proteins (~1.3 MB of embedding each at typical sizes: a client
        cycling through many paths must not grow host memory without
        bound). The parse and the ESM2 forward run under a lock of this
        path, never the engine's: holding the engine's lock would stall
        other requests for the whole forward."""
        with self._lock:
            if pdb_path in self._protein_cache:
                self._protein_cache.move_to_end(pdb_path)
                return self._protein_cache[pdb_path]
            plock = self._protein_locks.setdefault(pdb_path,
                                                   threading.Lock())
        with plock:
            with self._lock:   # another thread may have finished it
                if pdb_path in self._protein_cache:
                    return self._protein_cache[pdb_path]
            if self.esm is None:
                raise RuntimeError(
                    "DockingEngine has no ESM2 encoder to embed the "
                    "protein; pass esm=models.esm2.load_esm2(...)")
            struct = F.extract_protein_structure(pdb_path)
            esm = F.extract_esm_feature(struct["seq"], self.esm)
            with self._lock:
                self._protein_cache[pdb_path] = (struct, esm)
                self._protein_cache.move_to_end(pdb_path)
                while len(self._protein_cache) > _PROTEIN_LRU:
                    old, _ = self._protein_cache.popitem(last=False)
                    self._protein_locks.pop(old, None)
            return struct, esm

    @tracing.spanned("serve.call", _call_ids)
    def dock_sdf(self, requests: Sequence[Tuple[str, str]],
                 randomize_init: bool = False, seed: int = 0) -> List[Pose]:
        """Dock (ligand, pdb_path) pairs without RDKit. Each ligand is a
        path to a V2000 .sdf file or the molfile's text (anything holding a
        newline is text: the HTTP /dock_sdf body), parsed and featurized by
        `featurize.featurize_sdf` (exact for explicit-H SDFs with aromatic
        type-4 bonds, documented approximations otherwise). The SDF's
        conformer is the LAS reference and the initial pose (redocking),
        and each Pose carries `sdf_meta` for `featurize.write_sdf`.

        randomize_init: set every rotatable torsion to a uniform random
        angle (data/torsion.py), then apply a uniform random rigid rotation
        about the ligand's centroid, both drawn from one
        `np.random.RandomState(seed)` across the requests in order: with
        a crystal pose as input, docking then does not start from the
        answer. Bond lengths, angles and every LAS distance are kept.

        A request whose files fail to parse, or whose protein cannot be
        embedded (no encoder), comes back as Pose(error=...)."""
        rng = np.random.RandomState(seed)
        raws: List[Dict] = []
        for sdf, pdb_path in requests:
            try:
                feat = (F.featurize_sdf_text(sdf) if "\n" in sdf
                        else F.featurize_sdf(sdf))
                if randomize_init:
                    c = feat["coords"].mean(0, keepdims=True)
                    # randomize_torsions returns a centered conformer:
                    # rotate it about the origin, then restore the input's
                    # centroid so the initial pose stays on the pocket
                    rand = randomize_torsions(
                        feat["coords"], feat["bond_edges"], rng,
                        bond_orders=feat["bond_orders"])
                    feat = dict(feat, coords=(
                        uniform_random_rotation(rand, rng)
                        + c).astype(np.float32))
                struct, esm = self._protein_raw(pdb_path)
                raws.append({
                    "protein_xyz": struct["coords"][:, 1],
                    "protein_full_coords": struct["coords"],
                    "esm_feat": esm,
                    "lig_coords": feat["coords"],
                    "lig_feats": feat["feats"],
                    "bond_edges": feat["bond_edges"],
                    "las_mask": feat["las_mask"],
                    "rdkit_coords": feat["coords"],
                    "_sdf_meta": {"symbols": feat["symbols"],
                                  "bonds": feat["heavy_bonds"],
                                  "charges": feat["charges"]},
                })
            except Exception as e:   # skip-and-continue per request
                raws.append({"_error": f"{type(e).__name__}: {e}"})
        poses = self._finish_mol_requests(raws)
        for raw, pose in zip(raws, poses):
            if pose.error is None:
                pose.sdf_meta = raw["_sdf_meta"]
        return poses

    def dock_smiles(self, requests: Sequence[Tuple[str, str]]) -> List[Pose]:
        """(smiles, pdb_path) pairs need RDKit for the conformer, which the
        port does not use: each request comes back as the error Pose the
        JAX engine gives on a host without RDKit."""
        return [Pose(coords=np.zeros((0, 3), np.float32), confidence=0.0,
                     error=f"ImportError: {F.RDKIT_MISSING}")
                for _ in requests]

    def _finish_mol_requests(self, raws: List[Dict]) -> List[Pose]:
        """Dock the featurized dicts through dock_raw and put the
        featurization errors back in request order as error Poses."""
        ok_idx = [i for i, r in enumerate(raws) if "_error" not in r]
        poses = self.dock_raw([{k: v for k, v in raws[i].items()
                                if not k.startswith("_")} for i in ok_idx])
        out = [Pose(coords=np.zeros((0, 3), np.float32), confidence=0.0,
                    error=r["_error"]) if "_error" in r else None
               for r in raws]
        for i, pose in zip(ok_idx, poses):
            out[i] = pose
        return out   # type: ignore[return-value]
