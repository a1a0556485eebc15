"""Configurations by name: configs/<name>.json, read as data.

A file gives the preset and its overrides (the configuration as it is run),
the shape buckets, the batch, the serving dtype, the published source, what
was reduced from it and what was assumed. `flops` holds the closed form of
the model's product FLOPs (flops.py `fit`).
"""
from __future__ import annotations

import dataclasses
import json
from functools import lru_cache
from pathlib import Path
from typing import Dict, List

ROOT = Path(__file__).resolve().parent


@dataclasses.dataclass(frozen=True)
class BenchConfig:
    name: str
    data: Dict

    @property
    def preset(self) -> str:
        return self.data["preset"]

    @property
    def overrides(self) -> Dict:
        return dict(self.data.get("overrides", {}))

    @property
    def buckets(self) -> List[tuple]:
        return [tuple(b) for b in self.data["buckets"]]

    @property
    def batch_size(self) -> int:
        return int(self.data["batch_size"])

    @property
    def serve_dtype(self) -> str:
        return self.data["serve_dtype"]

    @property
    def coord_scale(self) -> float:
        """The factor of the coordinate heads' output layers in the seeded
        weights (weights.py)."""
        return float(self.data.get("coord_head_scale", 1e-3))

    @property
    def ref_cfg(self):
        """The reference's FABindConfig of this configuration."""
        from benchmark.reference.config import preset
        return preset(self.preset, **self.overrides)

    def ref_bucket_cfgs(self):
        """The reference's per-bucket configs, small to large."""
        from benchmark.reference.buckets import sort_bucket_cfgs
        cfg = self.ref_cfg
        return sort_bucket_cfgs(cfg, [dataclasses.replace(
            cfg.shapes, max_ligand=a, max_pocket=b, max_protein=c)
            for a, b, c in self.buckets])


@lru_cache(maxsize=None)
def load_config(name: str) -> BenchConfig:
    return BenchConfig(name, json.loads(
        (ROOT / "configs" / f"{name}.json").read_text()))
