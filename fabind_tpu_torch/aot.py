"""Deployment artifacts: the served inference program of each shape bucket,
traced by `torch.export` with the (optionally bf16-cast) weights baked in.

Counterpart of fabind_tpu/aot.py. A serving process loads the artifact
directory and runs the programs without building the model from its code or
reading a checkpoint (`DockingEngine.from_exported`).

Artifact directory layout:
    manifest.json                   config, bucket dims, batch size, dtypes,
                                    the programs' input order
    bucket_<L>_<P>_<R>.pt2          `torch.export.save` of one bucket's
                                    program (graph and weights)

Each program's signature is a flat tuple of the batch's tensors in the order
`manifest["inputs"]` records (BATCH_FIELDS): no registered dataclass pytree,
whose registration is a property of the process that made the artifact, not
of the artifact. It returns (lig_coords [B,Nc,3], confidence [B],
pocket_overflow [B]), the live engine's `model.inference_diag`.

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
import time
from typing import Dict, List, Optional, Sequence

import torch
from torch import nn

from fabind_tpu_torch.config import (FABindConfig, ModelConfig, ShapeConfig,
                                     TrainConfig)
from fabind_tpu_torch.data.buckets import sort_bucket_cfgs
from fabind_tpu_torch.data.types import FABindBatch, dummy_arrays
# registers the gate's operator, which the programs call by name
from fabind_tpu_torch.ops import edge_gate  # noqa: F401
from fabind_tpu_torch.utils.precision import (cast_batch_bf16,
                                              cast_module_bf16)

MANIFEST = "manifest.json"
_FORMAT_VERSION = 1
_OUTPUTS = ("lig_coords", "confidence", "overflow")
# the serving batch (`collate(..., n_valid=...)`): sample_valid present, the
# isomorphism fields, which inference never reads, absent
BATCH_FIELDS = tuple(f.name for f in dataclasses.fields(FABindBatch)
                     if f.name not in ("isomorphisms", "iso_mask"))
SAMPLING_TODO = ("the port exports no sampling programs yet (ROADMAP queue 1: "
                 "exported sampling programs)")


def _bucket_name(shapes: ShapeConfig) -> str:
    return (f"bucket_{shapes.max_ligand}_{shapes.max_pocket}_"
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
    bucket's shapes."""

    def __init__(self, model: nn.Module, shapes: ShapeConfig):
        super().__init__()
        self.model = model
        self.shapes = shapes

    def forward(self, *leaves):
        batch = FABindBatch(**dict(zip(BATCH_FIELDS, leaves)))
        return self.model.inference_diag(batch, shapes=self.shapes)


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
    """
    from fabind_tpu_torch.models.fabind import make_model

    if sampling:
        raise NotImplementedError(SAMPLING_TODO)
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

    entries: List[Dict] = []
    inputs = None
    for cfg_b in sort_bucket_cfgs(cfg, buckets):
        example = batch_leaves(_example_batch(cfg_b, batch_size, bf16,
                                              device))
        t0 = time.perf_counter()
        with torch.no_grad():
            ep = torch.export.export(_BucketProgram(model, cfg_b.shapes),
                                     example, strict=False)
        name = _bucket_name(cfg_b.shapes)
        torch.export.save(ep, os.path.join(out_dir, name))
        entries.append({"file": name,
                        "shapes": dataclasses.asdict(cfg_b.shapes),
                        "inputs": [list(t.shape) for t in example],
                        "seconds": time.perf_counter() - t0})
        inputs = [{"name": n, "dtype": str(t.dtype)[len("torch."):]}
                  for n, t in zip(BATCH_FIELDS, example)]

    manifest = {
        "format_version": _FORMAT_VERSION,
        "torch_version": torch.__version__,
        "config": dataclasses.asdict(cfg),
        "buckets": entries,
        "batch_size": batch_size,
        "bf16": bf16,
        "flexible": False,
        "post_optim_steps": post_optim_steps,
        "sampling": False,
        "sampling_pocket_mode": None,
        "export_device": device.type,
        "inputs": inputs,
        "outputs": list(_OUTPUTS),
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
    bucket config with the engine's batch -> (coords, confidence,
    pocket_overflow) contract."""

    def __init__(self, path: str, device=None):
        self.manifest = m = read_manifest(path)
        self.device = torch.device("cuda" if device is None else device)
        self.cfg = config_from_dict(m["config"])
        self.batch_size = int(m["batch_size"])
        self.bf16 = bool(m["bf16"])
        self.post_optim_steps = int(m["post_optim_steps"])
        self.bucket_cfgs = [
            self.cfg.replace(shapes=ShapeConfig(**e["shapes"]))
            for e in m["buckets"]]
        self._specs = {}
        self._programs = {}
        for cfg_b, e in zip(self.bucket_cfgs, m["buckets"]):
            ep = torch.export.load(os.path.join(path, e["file"]))
            if m["export_device"] != self.device.type:
                from torch.export.passes import move_to_device_pass
                ep = move_to_device_pass(ep, self.device)
            self._programs[id(cfg_b)] = ep.module()
            self._specs[id(cfg_b)] = [
                (i["name"], tuple(shape), getattr(torch, i["dtype"]))
                for i, shape in zip(m["inputs"], e["inputs"])]

    def _check(self, cfg_b: FABindConfig, leaves) -> None:
        """The clear error for a batch that does not fit the program."""
        for (name, shape, dtype), t in zip(self._specs[id(cfg_b)], leaves):
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

    def fn(self, cfg_b: FABindConfig):
        """The program of bucket cfg_b (identity-keyed, as the engine's
        bucket configs are): batch -> (coords, confidence, overflow)."""
        program = self._programs[id(cfg_b)]

        def call(batch: FABindBatch):
            leaves = batch_leaves(normalize_batch(batch, self.batch_size))
            self._check(cfg_b, leaves)
            return program(*leaves)

        return call
