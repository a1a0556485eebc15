"""Spawn targets of data-parallel training that take their batches as
arguments (cli.train's ranks read theirs from a Loader: cli.train.rank_main).

`train_steps` runs one Trainer rank over given global batches, so a test
or chip_smoke.py can hold N ranks against one process on the same batches.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from fabind_tpu_torch.config import FABindConfig
from fabind_tpu_torch.data.types import FABindBatch
from fabind_tpu_torch.ops import dropout, edge_gate
from fabind_tpu_torch.parallel.dp import DPGroup, strided_rows
from fabind_tpu_torch.train.trainer import Trainer


def train_steps(rank: int, world: int, device, cfg: FABindConfig,
                batches: Sequence[Dict[str, np.ndarray]],
                gumbel_us: Optional[Sequence[np.ndarray]] = None,
                state_dict: Optional[Dict[str, torch.Tensor]] = None
                ) -> Dict:
    """Rank `rank` of `world` takes one train step on its strided rows of
    each collated global batch in `batches` (with the global batch's gumbel
    uniforms [B, Nr, 2] from `gumbel_us` when given), starting from
    `state_dict` (default: the seeded weights). Returns {"params": the
    model's state dict as CPU tensors, "metrics": per step, "gate",
    "dropout", "dropout_rows": the kernel launches of each step in this
    process}."""
    trainer = Trainer(cfg, device, state_dict=state_dict,
                      group=DPGroup(rank, world, device))
    out: Dict[str, List] = {"metrics": [], "gate": [], "dropout": [],
                            "dropout_rows": []}
    for i, arrays in enumerate(batches):
        part = FABindBatch.from_numpy(strided_rows(arrays, rank, world),
                                      device)
        u = (None if gumbel_us is None
             else torch.from_numpy(gumbel_us[i]).to(device))
        before = (edge_gate.KERNEL.launches, dropout.KERNEL.launches,
                  dropout.KERNEL.variants.get("rows", 0))
        out["metrics"].append(trainer.train_step(part, gumbel_u=u))
        after = (edge_gate.KERNEL.launches, dropout.KERNEL.launches,
                 dropout.KERNEL.variants.get("rows", 0))
        for key, a, b in zip(("gate", "dropout", "dropout_rows"), after,
                             before):
            out[key].append(a - b)
    out["params"] = {k: v.detach().cpu()
                     for k, v in trainer.model.state_dict().items()}
    return out


def train_jobs(rank: int, world: int, device, jobs: Sequence) -> List[Dict]:
    """train_steps over each (cfg, batches, gumbel_us, state_dict) of
    `jobs`, in order, in one process group (one spawn for several
    comparisons)."""
    return [train_steps(rank, world, device, *job) for job in jobs]


def cli_train_runs(rank: int, world: int, device,
                   argvs: Sequence[Sequence[str]]) -> List[List[Dict]]:
    """cli.train's rank worker over each argv of `argvs`, in order, in one
    process group: each run's steps (cli.train.rank_main)."""
    from fabind_tpu_torch.cli.train import rank_main
    return [rank_main(rank, world, device, list(a)) for a in argvs]
