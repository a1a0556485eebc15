"""Deployment artifacts: the served inference program of each shape bucket,
traced by `torch.export` with the (optionally bf16-cast) weights baked in,
and with `sampling=True` the two halves of a best-of-N sampling pass.

Counterpart of fabind_tpu/aot.py. A serving process loads the artifact
directory and runs the programs without building the model from its code or
reading a checkpoint (`DockingEngine.from_exported`).

Artifact directory layout:
    manifest.json                   config, bucket dims, batch size, dtypes,
                                    the programs' input order
    bucket_<L>_<P>_<R>.pt2          `torch.export.save` of one bucket's
                                    program (graph and weights)
    pocket_<L>_<P>_<R>.pt2          with sampling: the pocket half
    sample_<L>_<P>_<R>.pt2          with sampling: the stochastic dock half

Each program's signature is a flat tuple of the batch's tensors in the order
`manifest["inputs"]` records (BATCH_FIELDS), then the program's own inputs:
no registered dataclass pytree, whose registration is a property of the
process that made the artifact, not of the artifact. The main program
returns (lig_coords [B,Nc,3], confidence [B], pocket_overflow [B]), the live
engine's `model.inference_diag`; for a flexible-docking config
(`manifest["flexible"]`, preset "fabflex") it runs
`model.inference_flexible_diag` and returns (lig_coords, confidence,
pocket_coords [B,Np,3], pocket_residues [B,Np], pocket_mask [B,Np],
overflow), the JAX package's order (`manifest["outputs"]`). The sampling
halves depend on the
manifest's `sampling_pocket_mode` (sample.py's functions, traced):

  - "stochastic": pocket (batch, seed, count) -> (compound_out,
    protein_out, cls_logits, radius_pred, center [B,3] f32); sample (batch,
    the four pocket outputs, center [B,3] f32, seed, count) -> (coords,
    confidence)
  - "fixed": pocket (batch) -> the four pocket outputs, deterministic;
    sample (batch, center [B,3] f32, seed, pocket_count, count) ->
    (coords, confidence), a whole stochastic forward

seed and the counts are int64 0-d tensors on the program's device: the
dropout masks are a function of the seed (the registered operator
`fabind_tpu_torch::dropout`, ops/dropout.py), and the recycle count, drawn
on the host from the seed (sample.recycle_counts), runs the rounds as a
while loop (models/att_model.py). So a program draws the live model's masks
and gives its poses bit for bit.

The edge gate is the registered operator `fabind_tpu_torch::edge_gate_pair`
(ops/edge_gate.py), so a program holds one call of it per launch and
dispatches on the device it runs on: the CUDA kernel on the card, the plain
version on the CPU. A program exported on one device serves on another
(`torch.export.passes.move_to_device_pass` moves its weights and the device
of every tensor it creates).

Post-optimization (postopt.py) is Adam with autograd, which a traced
inference program cannot hold: the manifest records its step count and the
engine applies it after the program, with the live engine's function.
"""
from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
from typing import Dict, List, Optional, Sequence

import torch
from torch import nn

from fabind_tpu_torch.config import (FABindConfig, ModelConfig, ShapeConfig,
                                     TrainConfig)
from fabind_tpu_torch.data.buckets import sort_bucket_cfgs
from fabind_tpu_torch.data.types import FABindBatch, dummy_arrays
from fabind_tpu_torch.models.layers import signed64, upload_int64
# registers the gate's and the dropout's operators, which the programs
# call by name
from fabind_tpu_torch.ops import dropout, edge_gate  # noqa: F401
from fabind_tpu_torch.sample import (recycle_counts, stochastic_dock,
                                     stochastic_inference, stochastic_pocket)
from fabind_tpu_torch.utils.precision import (cast_batch_bf16,
                                              cast_module_bf16)

MANIFEST = "manifest.json"
_FORMAT_VERSION = 1
_OUTPUTS = ("lig_coords", "confidence", "overflow")
_OUTPUTS_FLEX = ("lig_coords", "confidence", "pocket_coords",
                 "pocket_residues", "pocket_mask", "overflow")
# the serving batch (`collate(..., n_valid=...)`): sample_valid present, the
# isomorphism fields, which inference never reads, absent
BATCH_FIELDS = tuple(f.name for f in dataclasses.fields(FABindBatch)
                     if f.name not in ("isomorphisms", "iso_mask"))
_POCKET_OUTPUTS = ("compound_out", "protein_out", "cls_logits",
                   "radius_pred")
NO_SAMPLING = ("this artifact was exported without the sampling programs — "
               "re-export with export_inference(..., sampling=True) / "
               "cli.export --sampling to serve dock_best_of")


def _bucket_name(shapes: ShapeConfig, kind: str = "bucket") -> str:
    return (f"{kind}_{shapes.max_ligand}_{shapes.max_pocket}_"
            f"{shapes.max_protein}.pt2")


def normalize_batch(batch: FABindBatch, batch_size: int) -> FABindBatch:
    """Match a live batch to the exported calling convention: sample_valid
    materialized (all rows real when the caller left it None, as warmup's
    dummy batches do), the isomorphism fields dropped."""
    if batch.sample_valid is None:
        batch = dataclasses.replace(batch, sample_valid=torch.ones(
            batch_size, dtype=torch.bool, device=batch.lig_feat.device))
    if batch.isomorphisms is not None or batch.iso_mask is not None:
        batch = dataclasses.replace(batch, isomorphisms=None, iso_mask=None)
    return batch


def batch_leaves(batch: FABindBatch) -> tuple:
    return tuple(getattr(batch, f) for f in BATCH_FIELDS)


class _BucketProgram(nn.Module):
    """What one artifact runs: the flat batch in, inference_diag in the
    bucket's shapes (inference_flexible_diag in the outputs' order of
    _OUTPUTS_FLEX for a flexible-docking model)."""

    def __init__(self, model: nn.Module, shapes: ShapeConfig):
        super().__init__()
        self.model = model
        self.shapes = shapes

    def forward(self, *leaves):
        batch = FABindBatch(**dict(zip(BATCH_FIELDS, leaves)))
        if not self.model.cfg.flexible_docking:
            return self.model.inference_diag(batch, shapes=self.shapes)
        lig, pkt, idx, mask, conf, overflow = \
            self.model.inference_flexible_diag(batch, shapes=self.shapes)
        return lig, conf, pkt, idx, mask, overflow


class _StochasticPocket(_BucketProgram):
    def forward(self, *args):
        *leaves, seed, count = args
        batch = FABindBatch(**dict(zip(BATCH_FIELDS, leaves)))
        pocket, center = stochastic_pocket(self.model, batch, self.shapes,
                                           seed, count)
        return (*pocket, center)


class _StochasticDock(_BucketProgram):
    def forward(self, *args):
        *leaves, co, po, cl, ra, center, seed, count = args
        batch = FABindBatch(**dict(zip(BATCH_FIELDS, leaves)))
        return stochastic_dock(self.model, batch, self.shapes,
                               (co, po, cl, ra), center, seed, count)


class _FixedPocket(_BucketProgram):
    def forward(self, *leaves):
        batch = FABindBatch(**dict(zip(BATCH_FIELDS, leaves)))
        return self.model._pocket_pred(batch, self.shapes)


class _FixedSample(_BucketProgram):
    def forward(self, *args):
        *leaves, center, seed, pocket_count, count = args
        batch = FABindBatch(**dict(zip(BATCH_FIELDS, leaves)))
        return stochastic_inference(self.model, batch, self.shapes, center,
                                    seed, pocket_count, count)


def _export(program: nn.Module, args: tuple, out_dir: str, name: str
            ) -> None:
    """Trace one program on `args` and save it as `name`."""
    with torch.no_grad():
        ep = torch.export.export(program, args, strict=False)
    torch.export.save(ep, os.path.join(out_dir, name))


def _specs(names: Sequence[str], tensors: Sequence[torch.Tensor]
           ) -> List[Dict]:
    """Manifest input specs of a program's inputs after the batch."""
    return [{"name": n, "shape": list(t.shape),
             "dtype": str(t.dtype)[len("torch."):]}
            for n, t in zip(names, tensors)]


def _export_sampling(model: nn.Module, cfg_b: FABindConfig, example: tuple,
                     out_dir: str, device) -> Dict:
    """The two sampling halves of one bucket (module docstring), traced on
    the seed 0 and its counts; returns the manifest entry's fields."""
    shapes = cfg_b.shapes
    mode = cfg_b.model.sampling_pocket_mode

    def scalar(v):
        return torch.tensor(v, dtype=torch.int64, device=device)

    seed = scalar(0)
    pc, dc = (scalar(c) for c in recycle_counts(cfg_b.model, 0))
    center = torch.zeros((example[0].shape[0], 3), dtype=torch.float32,
                         device=device)
    if mode == "stochastic":
        pocket_prog = _StochasticPocket(model, shapes)
        p_names, p_extra = ("seed", "count"), (seed, pc)
        with torch.no_grad():
            pocket = pocket_prog(*example, *p_extra)[:4]
        sample_prog = _StochasticDock(model, shapes)
        s_names = (*_POCKET_OUTPUTS, "center", "seed", "count")
        s_extra = (*pocket, center, seed, dc)
    elif mode == "fixed":
        pocket_prog = _FixedPocket(model, shapes)
        p_names, p_extra = (), ()
        sample_prog = _FixedSample(model, shapes)
        s_names = ("center", "seed", "pocket_count", "count")
        s_extra = (center, seed, pc, dc)
    else:
        raise ValueError(f"sampling_pocket_mode {mode!r}")
    pname = _bucket_name(shapes, "pocket")
    sname = _bucket_name(shapes, "sample")
    _export(pocket_prog, (*example, *p_extra), out_dir, pname)
    _export(sample_prog, (*example, *s_extra), out_dir, sname)
    return {"pocket_file": pname, "sample_file": sname,
            "pocket_inputs": _specs(p_names, p_extra),
            "sample_inputs": _specs(s_names, s_extra)}


def _example_batch(cfg_b: FABindConfig, batch_size: int, bf16: bool,
                   device) -> FABindBatch:
    arrays = dummy_arrays(cfg_b.shapes, batch_size=batch_size,
                          feat_dim=cfg_b.model.compound_feat_dim,
                          prot_feat_dim=cfg_b.model.protein_feat_dim)
    batch = normalize_batch(FABindBatch.from_numpy(arrays, device),
                            batch_size)
    return cast_batch_bf16(batch) if bf16 else batch


def export_inference(cfg: FABindConfig, state_dict: Dict[str, torch.Tensor],
                     out_dir: str, *, buckets: Optional[Sequence] = None,
                     batch_size: int = 8, bf16: bool = True,
                     post_optim_steps: int = 0, device="cuda",
                     sampling: bool = False) -> Dict:
    """Export one inference program per bucket to `out_dir`; returns the
    manifest.

    `state_dict` is the fp32 port state dict (loaded strictly); the bf16
    deployment cast happens here, so the artifact holds the exact serving
    weights. The trace runs on `device` ("cuda" by default; raises without
    CUDA). `post_optim_steps` is recorded, not traced (module docstring).
    `sampling` also exports each bucket's two halves of a best-of-N pass
    in the config's `sampling_pocket_mode`; it needs the confidence head
    (preset "fabind_plus_sampling").
    """
    from fabind_tpu_torch.models.fabind import make_model

    if sampling:
        assert cfg.model.confidence_training, (
            "sampling export needs the confidence head — use a "
            "fabind_plus_sampling config")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("export_inference: CUDA is not available; pass "
                           "device='cpu' to export on the CPU")
    os.makedirs(out_dir, exist_ok=True)
    model = make_model(cfg)
    model.load_state_dict(state_dict, strict=True)
    model = model.to(device).eval()
    if bf16:
        model = cast_module_bf16(model)

    flexible = bool(cfg.model.flexible_docking)
    entries: List[Dict] = []
    inputs = None
    for cfg_b in sort_bucket_cfgs(cfg, buckets):
        example = batch_leaves(_example_batch(cfg_b, batch_size, bf16,
                                              device))
        t0 = time.perf_counter()
        name = _bucket_name(cfg_b.shapes)
        _export(_BucketProgram(model, cfg_b.shapes), example, out_dir, name)
        entry = {"file": name, "shapes": dataclasses.asdict(cfg_b.shapes),
                 "inputs": [list(t.shape) for t in example]}
        if sampling:
            entry.update(_export_sampling(model, cfg_b, example, out_dir,
                                          device))
        entry["seconds"] = time.perf_counter() - t0
        entries.append(entry)
        inputs = [{"name": n, "dtype": str(t.dtype)[len("torch."):]}
                  for n, t in zip(BATCH_FIELDS, example)]

    manifest = {
        "format_version": _FORMAT_VERSION,
        "torch_version": torch.__version__,
        "config": dataclasses.asdict(cfg),
        "buckets": entries,
        "batch_size": batch_size,
        "bf16": bf16,
        "flexible": flexible,
        "post_optim_steps": post_optim_steps,
        "sampling": bool(sampling),
        "sampling_pocket_mode": (cfg.model.sampling_pocket_mode if sampling
                                 else None),
        "export_device": device.type,
        "inputs": inputs,
        "outputs": list(_OUTPUTS_FLEX if flexible else _OUTPUTS),
    }
    with open(os.path.join(out_dir, MANIFEST), "w") as f:
        json.dump(manifest, f, indent=1)
    return manifest


def config_from_dict(d: Dict) -> FABindConfig:
    """A FABindConfig from manifest JSON (every field is a scalar)."""
    return FABindConfig(model=ModelConfig(**d["model"]),
                        shapes=ShapeConfig(**d["shapes"]),
                        train=TrainConfig(**d["train"]))


def read_manifest(path: str) -> Dict:
    """The manifest of artifact directory `path`; raises on a format this
    build does not read."""
    with open(os.path.join(path, MANIFEST)) as f:
        m = json.load(f)
    v = m.get("format_version")
    if v != _FORMAT_VERSION:
        raise ValueError(f"{path}: unsupported artifact format {v!r} "
                         f"(this build reads {_FORMAT_VERSION})")
    return m


class ExportedInference:
    """A loaded artifact directory on `device` (default cuda; the programs
    are moved there when they were exported elsewhere): one callable per
    bucket config with the engine's run_batch contract (batch -> the
    manifest's outputs), and with sampling programs each bucket's
    `sampling_halves`. One program call runs at a time: a program's module
    is not documented as safe to call from several threads."""

    def __init__(self, path: str, device=None):
        self.manifest = m = read_manifest(path)
        self._lock = threading.Lock()
        self.device = torch.device("cuda" if device is None else device)
        self.cfg = config_from_dict(m["config"])
        self.batch_size = int(m["batch_size"])
        self.bf16 = bool(m["bf16"])
        self.post_optim_steps = int(m["post_optim_steps"])
        self.flexible = bool(m["flexible"])
        self.sampling = bool(m.get("sampling", False))
        self.sampling_pocket_mode = m.get("sampling_pocket_mode")
        self.bucket_cfgs = [
            self.cfg.replace(shapes=ShapeConfig(**e["shapes"]))
            for e in m["buckets"]]
        # bucket -> its main program; (bucket, kind) -> a sampling half;
        # either -> its input specs
        self._programs, self._halves, self._specs = {}, {}, {}
        for cfg_b, e in zip(self.bucket_cfgs, m["buckets"]):
            batch_specs = [
                (i["name"], tuple(shape), getattr(torch, i["dtype"]))
                for i, shape in zip(m["inputs"], e["inputs"])]
            self._programs[id(cfg_b)] = self._load(path, e["file"],
                                                   m["export_device"])
            self._specs[id(cfg_b)] = batch_specs
            for kind in ("pocket", "sample") if self.sampling else ():
                self._halves[id(cfg_b), kind] = self._load(
                    path, e[f"{kind}_file"], m["export_device"])
                self._specs[id(cfg_b), kind] = batch_specs + [
                    (i["name"], tuple(i["shape"]), getattr(torch, i["dtype"]))
                    for i in e[f"{kind}_inputs"]]

    def _load(self, path: str, name: str, export_device: str):
        ep = torch.export.load(os.path.join(path, name))
        if export_device != self.device.type:
            from torch.export.passes import move_to_device_pass
            ep = move_to_device_pass(ep, self.device)
        return ep.module()

    def _check(self, cfg_b: FABindConfig, specs, args) -> None:
        """The clear error for inputs that do not fit the program."""
        for (name, shape, dtype), t in zip(specs, args):
            if (t is None or tuple(t.shape) != shape or t.dtype != dtype
                    or t.device.type != self.device.type):
                got = (None if t is None
                       else (tuple(t.shape), t.dtype, t.device.type))
                s = cfg_b.shapes
                raise ValueError(
                    f"batch does not match the exported calling convention "
                    f"(batch_size {self.batch_size}, bf16={self.bf16}, "
                    f"bucket lig {s.max_ligand}/pkt {s.max_pocket}/prot "
                    f"{s.max_protein}, device {self.device.type}) — "
                    f"re-export or fix the caller: {name} is {got}, the "
                    f"program takes {(shape, dtype, self.device.type)}")

    def _runner(self, cfg_b: FABindConfig, kind: Optional[str] = None):
        """Call bucket cfg_b's main program (or its sampling half `kind`)
        on (batch, *extra inputs), after checking them."""
        if kind is None:
            program, specs = self._programs[id(cfg_b)], self._specs[id(cfg_b)]
        else:
            program = self._halves[id(cfg_b), kind]
            specs = self._specs[id(cfg_b), kind]

        def run(batch: FABindBatch, *extra):
            args = (*batch_leaves(normalize_batch(batch, self.batch_size)),
                    *extra)
            self._check(cfg_b, specs, args)
            with self._lock:
                return program(*args)

        return run

    def fn(self, cfg_b: FABindConfig):
        """The program of bucket cfg_b (identity-keyed, as the engine's
        bucket configs are): batch -> the manifest's outputs."""
        return self._runner(cfg_b)

    def sampling_halves(self, cfg_b: FABindConfig):
        """(pocket_fn, dock_fn) of bucket cfg_b with sample.live_halves'
        contract for the artifact's `sampling_pocket_mode`, for
        sample.sample_poses(..., halves=...). Each call uploads the pass's
        seed and recycle counts (drawn on the host from the seed,
        sample.recycle_counts) as int64 tensors. Raises when the artifact
        was exported without `sampling=True`."""
        if not self.sampling:
            raise ValueError(NO_SAMPLING)
        pocket_prog = self._runner(cfg_b, "pocket")
        sample_prog = self._runner(cfg_b, "sample")
        m = self.cfg.model

        def keys(seed: int):
            """(seed, pocket count, dock count) on the device."""
            return upload_int64([signed64(seed), *recycle_counts(m, seed)],
                           self.device).unbind()

        if self.sampling_pocket_mode == "stochastic":
            def pocket_fn(batch, seed):
                s, pc, _ = keys(seed)
                *pocket, center = pocket_prog(batch, s, pc)
                return tuple(pocket), center

            def dock_fn(batch, pocket, center, seed):
                s, _, dc = keys(seed)
                return tuple(sample_prog(batch, *pocket,
                                         center.to(torch.float32), s, dc))
        else:
            def pocket_fn(batch):
                return tuple(pocket_prog(batch))

            def dock_fn(batch, center, seed):
                return tuple(sample_prog(batch, center.to(torch.float32),
                                         *keys(seed)))

        return pocket_fn, dock_fn
