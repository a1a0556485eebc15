"""Evaluation entry point: score a checkpoint on a dataset of complexes.

Counterpart of fabind_tpu/cli/evaluate.py, on the GPU by default:

  python -m fabind_tpu_torch.cli.evaluate --preset fabind --data DATA \\
      --ckpt best_model.bin [--split test] [--unseen-index FILE] \\
      [--stage 2] [--post-optim] [--distmap-dock] [--symmetric-rmsd] \\
      [--save-rmsd out.txt] [--write-coords-dir DIR] [--buckets auto] \\
      [--out metrics.json] [--device cpu]

`--data` is the reference's processed PDBbind store (`--split` picks its
valid or test rows under the preset's filters) or a directory of .npz
samples (all of them). The model runs in float32, one module for every
shape bucket (the bucket's shapes go to the forward). The JSON is
`MetricAccumulator.summarize()` plus `complexes_per_sec` and
`n_dropped_oversize`, with the JAX CLI's keys.
`--ckpt` takes a released-format `.bin`/`.pt`, a `save_params` file or a
`cli.train` run (or its checkpoint directory). `--profile-dir` writes a
torch.profiler Chrome trace of the evaluation loop.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from fabind_tpu_torch.cli.common import load_model, resolve_device
from fabind_tpu_torch.config import parse_overrides, preset
from fabind_tpu_torch.data.buckets import resolve_buckets
from fabind_tpu_torch.data.dataset import Loader, NPZSource, open_source
from fabind_tpu_torch.data.types import FABindBatch
from fabind_tpu_torch.postopt import distance_dock_best_of, post_optimize_batch
from fabind_tpu_torch.train.trainer import eval_forward
from fabind_tpu_torch.utils.metrics import MetricAccumulator


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--preset", default="fabind",
                   choices=["fabind", "fabind_plus"])
    p.add_argument("--data", required=True,
                   help="the reference's processed PDBbind root or a "
                        "directory of per-complex .npz samples")
    p.add_argument("--ckpt", required=True)
    p.add_argument("--split", default="test", choices=["valid", "test"],
                   help="the store's split and the loader group (an NPZ "
                        "directory has no splits)")
    p.add_argument("--unseen-index", default=None,
                   help="file of pdb ids, one per line, to restrict the "
                        "split to (a store's pdb column, else its "
                        "compound_name; NPZ names are the pdb ids)")
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                   help="config override (any ModelConfig/ShapeConfig/"
                        "TrainConfig field)")
    p.add_argument("--stage", type=int, default=2)
    p.add_argument("--post-optim", action="store_true",
                   help="LAS-constraint refinement of the predicted poses")
    p.add_argument("--post-optim-steps", type=int, default=1000)
    p.add_argument("--distmap-dock", action="store_true",
                   help="legacy docking: discard the coordinate head's pose "
                        "and fit coordinates to the predicted distance map "
                        "and the LAS constraints")
    p.add_argument("--distmap-repeats", type=int, default=1,
                   help="random restarts per complex; the lowest final "
                        "loss wins")
    p.add_argument("--distmap-steps", type=int, default=5000)
    p.add_argument("--symmetric-rmsd", action="store_true",
                   help="RMSD minimized over the ligand's automorphisms "
                        "(the FABind+ protocol)")
    p.add_argument("--save-rmsd", default=None,
                   help="write 'pdb rmsd' lines here")
    p.add_argument("--write-coords-dir", default=None,
                   help="write each predicted pose as {pdb}.npz here")
    p.add_argument("--buckets", default=None,
                   help="shape buckets 'lig:pocket:protein,...' (small to "
                        "large), or 'auto'/'auto:K' to infer up to K "
                        "(default 3) from the directory's sizes")
    p.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler trace (Chrome JSON) of the "
                        "evaluation loop here")
    p.add_argument("--workers", type=int, default=8,
                   help="host featurization threads (0 = inline)")
    p.add_argument("--prefetch", type=int, default=2,
                   help="batches prepared ahead of the device (0 = off)")
    p.add_argument("--out", default=None, help="write the metrics JSON here")
    p.add_argument("--device", default=None,
                   help="torch device (default cuda; raises without CUDA "
                        "unless --device cpu)")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Evaluate; returns the metrics it prints (and writes to --out)."""
    args = parse_args(argv)
    device = resolve_device(args.device, "cli.evaluate")
    overrides = parse_overrides(args.set)
    overrides.setdefault("batch_size", args.batch_size)
    cfg = preset(args.preset, **overrides)
    model = load_model(cfg, args.ckpt, device)

    source, indices = open_source(args.data, variant=args.preset,
                                  split=args.split,
                                  use_esm2_feat=cfg.model.use_esm2_feat)
    if args.unseen_index:
        with open(args.unseen_index) as f:
            wanted = {line.strip() for line in f if line.strip()}
        if isinstance(source, NPZSource):
            indices = [n for n in indices if n in wanted]
        else:
            ids = source.index["pdb" if "pdb" in source.index
                               else "compound_name"]
            indices = [i for i in indices if str(ids[i]) in wanted]
        if not indices:
            raise SystemExit(f"--unseen-index {args.unseen_index}: no ids "
                             f"from the file are present in {args.data}")
        print(f"unseen subset: {len(indices)} of {len(wanted)} ids present")
    buckets = resolve_buckets(args.buckets, cfg, source, indices,
                              group=args.split)
    if buckets is not None:
        print("buckets:", [(s.max_ligand, s.max_pocket, s.max_protein)
                           for s in buckets])
    loader = Loader(source, indices, cfg, group=args.split,
                    batch_size=cfg.train.batch_size, buckets=buckets,
                    workers=args.workers, prefetch_depth=args.prefetch)

    acc = MetricAccumulator(symmetric=args.symmetric_rmsd)
    if args.write_coords_dir:
        os.makedirs(args.write_coords_dir, exist_ok=True)
    prof = None
    if args.profile_dir:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.start()
    t0 = time.time()
    n = 0
    for arrays, meta in loader.epoch(0, with_meta=True):
        batch = FABindBatch.from_numpy(arrays, device)
        out = eval_forward(model, batch, args.stage, meta["cfg"].shapes)
        if args.distmap_dock:
            # each batch's restarts draw from the running complex count, as
            # the JAX CLI keys them with PRNGKey(n)
            gen = torch.Generator(device).manual_seed(n)
            coords, _, _ = distance_dock_best_of(
                out.y_pred, out.pocket_coords, batch.lig_rdkit_coords,
                batch.las_adj, batch.lig_mask, out.pkt_mask, gen,
                n_repeat=args.distmap_repeats, steps=args.distmap_steps,
                dis_thres=float(cfg.model.dis_map_thres))
            out.coords = coords
        if args.post_optim:
            out.coords, _ = post_optimize_batch(
                out.coords, batch.lig_rdkit_coords, batch.las_adj,
                batch.lig_mask, steps=args.post_optim_steps)
        acc.update(out, batch, pdbs=meta["pdb"], isomorphisms=meta.get("iso"))
        if args.write_coords_dir:
            coords = out.coords.cpu().numpy()
            lm = out.lig_mask.cpu().numpy()
            for i, pdb in enumerate(meta["pdb"]):
                np.savez(os.path.join(args.write_coords_dir, f"{pdb}.npz"),
                         pred_coords=coords[i, :int(lm[i].sum())])
        n += meta["n_valid"]
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.time() - t0
    if prof is not None:
        prof.stop()
        os.makedirs(args.profile_dir, exist_ok=True)
        path = os.path.join(args.profile_dir, "evaluate.json")
        prof.export_chrome_trace(path)
        print(f"profiler trace -> {path}")
    metrics = acc.summarize()
    metrics["complexes_per_sec"] = n / dt
    metrics["n_dropped_oversize"] = loader.n_dropped
    if args.save_rmsd:
        acc.dump_per_pdb(args.save_rmsd)
    print(json.dumps(metrics, indent=2))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(metrics, f, indent=2)
    return metrics


if __name__ == "__main__":
    main()
