"""Deployment self-test: check the install and the card in well under a
minute.

Counterpart of fabind_tpu/cli/selftest.py. One command checks, on the card
(or the CPU with --device cpu):

  1. the device: its kind and count;
  2. a seeded model and its inference forward on tiny synthetic complexes
     (finite coordinates of the right shape, and for preset fabflex a
     finite, non-empty docked pocket); on the card the base model's
     forward launches the edge-gate kernel, once per attention layer of
     each stage and recycle, and the line reports the launches;
  3. optionally (--train) one optimizer step (finite loss, a gradient,
     no skipped step);
  4. optionally (--prod) the forward at production bucket shapes with the
     released widths.

Exit code 0 = every check passed. Prints one JSON line per check.

Usage:
  python -m fabind_tpu_torch.cli.selftest [--preset fabind] [--train]
      [--prod] [--bf16] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import json
import sys
import time


def _check(name: str, t0: float, **extra) -> None:
    print(json.dumps({"check": name, "ok": True,
                      "seconds": round(time.perf_counter() - t0, 2), **extra}),
          flush=True)


def _require(cond: bool, msg) -> None:
    """Explicit health check: `assert` would be stripped under python -O,
    making a broken install pass the deployment gate silently."""
    if not cond:
        raise RuntimeError(f"selftest check failed: {msg}")


def gate_launches_per_forward(cfg) -> int:
    """Edge-gate launches of one inference forward on the card: one per
    attention layer of the pocket stage and of each docking recycle; none
    for the LayerNorm coordinate MLPs of FABind+, which bypass the gate."""
    m = cfg.model
    if m.use_ln_mlp:
        return 0
    return (m.pocket_pred_layers * m.pocket_pred_n_iter
            + m.mean_layers * m.n_iter)


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--preset", default="fabind",
                   choices=["fabind", "fabind_plus", "fabind_plus_sampling",
                            "fabflex"])
    p.add_argument("--train", action="store_true",
                   help="also run one optimizer step")
    p.add_argument("--prod", action="store_true",
                   help="also run a forward at production bucket shapes "
                        "(lig 48 / pkt 158 / prot 408, 8 recycles)")
    p.add_argument("--bf16", action="store_true",
                   help="run the inference checks in bfloat16 (the serving "
                        "dtype)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    import numpy as np
    import torch

    from fabind_tpu_torch.cli.common import resolve_device
    from fabind_tpu_torch.config import preset
    from fabind_tpu_torch.data.types import dummy_batch
    from fabind_tpu_torch.models.fabind import init_params, make_model
    from fabind_tpu_torch.ops import edge_gate
    from fabind_tpu_torch.utils.precision import (cast_batch_bf16,
                                                  cast_module_bf16)

    t0 = time.perf_counter()
    device = resolve_device(args.device, "cli.selftest")
    if device.type == "cuda":
        n = torch.cuda.device_count()
        kinds = sorted({torch.cuda.get_device_name(i) for i in range(n)})
    else:
        n, kinds = 1, ["cpu"]
    _check("devices", t0, backend=device.type, n=n, kinds=kinds)
    if args.bf16 and device.type == "cuda":
        # bf16 products accumulate in fp32, as the serving engine sets it
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            False

    def forward(cfg, batch_size, n_lig, n_prot, label):
        t = time.perf_counter()
        batch = dummy_batch(cfg.shapes, batch_size=batch_size,
                            n_lig_valid=n_lig, n_prot_valid=n_prot,
                            device=device)
        model = make_model(cfg)
        init_params(model, torch.Generator().manual_seed(0))
        model = model.to(device).eval()
        if args.bf16:
            model, batch = cast_module_bf16(model), cast_batch_bf16(batch)
        flexible = cfg.model.flexible_docking
        before = edge_gate.KERNEL.launches
        with torch.inference_mode():
            if flexible:
                coords, pocket, _, pkt_mask, _ = model.inference_flexible(
                    batch)
            else:
                coords, _ = model.inference(batch)
        coords = coords.float().cpu().numpy()
        launches = edge_gate.KERNEL.launches - before
        _require(coords.shape == (batch_size, cfg.shapes.max_ligand, 3),
                 coords.shape)
        _require(np.isfinite(coords).all(), "non-finite coordinates")
        if flexible:
            pocket = pocket.float().cpu().numpy()
            _require(pocket.shape == (batch_size, cfg.shapes.max_pocket, 3),
                     pocket.shape)
            _require(np.isfinite(pocket).all() and bool(pkt_mask.any()),
                     "non-finite or empty docked pocket")
        if device.type == "cuda":
            want = gate_launches_per_forward(cfg)
            _require(launches == want,
                     f"{launches} edge-gate launches, expected {want}")
        _check(label, t, coords_shape=list(coords.shape),
               dtype="bf16" if args.bf16 else "fp32",
               gate_launches=launches)

    tiny = preset(args.preset, max_ligand=8, max_pocket=16, max_protein=32,
                  ctx_k=6, ctx_k_whole=6, hidden_size=16,
                  pocket_pred_hidden_size=16, mean_layers=1, n_iter=2,
                  batch_size=2)
    forward(tiny, 2, 6, 24, "inference_tiny")

    if args.train:
        from fabind_tpu_torch.train.trainer import Trainer
        t = time.perf_counter()
        trainer = Trainer(tiny, device)
        batch = dummy_batch(tiny.shapes, batch_size=2, n_lig_valid=6,
                            n_prot_valid=24, device=device)
        metrics = trainer.train_step(batch)
        loss, gnorm = metrics["loss"], metrics["grad_norm"]
        _require(np.isfinite(loss), f"non-finite loss {loss}")
        _require(np.isfinite(gnorm) and gnorm > 0, f"bad grad norm {gnorm}")
        _require(metrics["skipped_nan"] == 0.0, "the step was skipped")
        _require(trainer.step == 1, "step count != 1")
        # gradient flow, not a parameter delta, is the health signal here
        _check("train_step", t, loss=round(loss, 4),
               grad_norm=round(gnorm, 4))

    if args.prod:
        cfg = preset(args.preset, max_ligand=48, max_pocket=158,
                     max_protein=408, n_iter=8)
        forward(cfg, 4, 48, 400, "inference_prod")

    print(json.dumps({"selftest": "ok"}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
