"""Best-of-N sampling over a directory of complexes (FABind+).

Counterpart of fabind_tpu/cli/sample.py `main`, on the GPU by default:

  python -m fabind_tpu_torch.cli.sample --ckpt CKPT --data NPZ_DIR \\
      [--preset fabind_plus_sampling] [--sample-size 40] [--batch-size 4] \\
      [--seed 0] [--pocket-mode stochastic|fixed] [--topn 1] \\
      [--save-rmsd-dir DIR] [--symmetric-rmsd] [--out metrics.json] \\
      [--device cpu]

Each batch runs `sample.sample_poses` (sample_size stochastic passes,
float32); per complex the best RMSD and centroid distance among the top-N
poses by confidence are summarized, as the reference benchmark does
(N = 1). `--ckpt` takes what `checkpoints.load_weights` reads; a confidence
head it lacks keeps its fresh init. `--dp` is not ported (ROADMAP queue 1,
data parallelism).
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np

from fabind_tpu_torch.cli.common import load_model, resolve_device
from fabind_tpu_torch.config import parse_overrides, preset
from fabind_tpu_torch.data.dataset import Loader, open_source
from fabind_tpu_torch.data.types import FABindBatch
from fabind_tpu_torch.sample import sample_poses
from fabind_tpu_torch.utils.metrics import (centroid_distance, ligand_rmsd,
                                            summarize_rmsd, symmetric_rmsd)


def aggregate_topn(rmsds: np.ndarray, cents: np.ndarray, confs: np.ndarray,
                   topn: int = 1):
    """Per complex, the best RMSD and centroid distance among its top-N
    poses by confidence. Inputs are [S, n] over S sampling passes."""
    order = np.argsort(-confs, axis=0)[:topn]               # [N, n]
    best_rmsd = np.min(np.take_along_axis(rmsds, order, 0), axis=0)
    best_cent = np.min(np.take_along_axis(cents, order, 0), axis=0)
    return best_rmsd, best_cent


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--preset", default="fabind_plus_sampling")
    p.add_argument("--ckpt", required=True)
    p.add_argument("--data", required=True,
                   help="directory of per-complex .npz samples")
    p.add_argument("--split", default="test",
                   help="the loader group (an NPZ directory has no splits)")
    p.add_argument("--sample-size", type=int, default=40)
    p.add_argument("--batch-size", type=int, default=4)
    p.add_argument("--dp", type=int, default=1,
                   help="data parallelism: not ported; only 1 is accepted")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--pocket-mode", default=None,
                   choices=["stochastic", "fixed"],
                   help="sampling protocol (default cfg.model."
                        "sampling_pocket_mode): 'stochastic' reruns the "
                        "pocket stage with dropout every pass, 'fixed' "
                        "clusters one deterministic pocket stage per batch")
    p.add_argument("--topn", type=int, default=1,
                   help="best RMSD among the top-N poses by confidence")
    p.add_argument("--save-rmsd-dir", default=None,
                   help="write 'pdb rmsd centroid confidence' lines per "
                        "sampling pass as epoch{i}_confidence.txt")
    p.add_argument("--symmetric-rmsd", action="store_true",
                   help="RMSD minimized over the ligand's automorphisms")
    p.add_argument("--out", default=None, help="write the metrics JSON here")
    p.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                   help="config override (any ModelConfig/ShapeConfig/"
                        "TrainConfig field)")
    p.add_argument("--device", default=None,
                   help="torch device (default cuda; raises without CUDA "
                        "unless --device cpu)")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Sample; returns the metrics it prints (and writes to --out)."""
    args = parse_args(argv)
    if args.dp != 1:
        raise SystemExit("--dp: data-parallel sampling is not ported yet "
                         "(ROADMAP queue 1); run with --dp 1")
    device = resolve_device(args.device, "cli.sample")
    overrides = parse_overrides(args.set)
    if args.pocket_mode:
        overrides["sampling_pocket_mode"] = args.pocket_mode
    cfg = preset(args.preset, **overrides)
    model = load_model(cfg, args.ckpt, device)

    source, indices = open_source(args.data)
    loader = Loader(source, indices, cfg, group=args.split,
                    batch_size=args.batch_size, workers=8, prefetch_depth=2)
    # [S, n] per-complex arrays across the sampling passes
    rmsds, cents, confs, pdbs = [], [], [], []
    for bi, (arrays, meta) in enumerate(loader.epoch(0, with_meta=True)):
        nv = meta["n_valid"]
        batch = FABindBatch.from_numpy(arrays, device)
        coords, scores = sample_poses(model, batch, cfg, args.sample_size,
                                      seed=args.seed, batch_idx=bi)
        coords = coords.float().cpu().numpy()
        true = arrays["lig_coords"]
        mask = arrays["lig_mask"]
        if args.symmetric_rmsd:
            r = np.zeros((coords.shape[0], nv))
            for s in range(coords.shape[0]):
                for i in range(nv):
                    nl = int(mask[i].sum())
                    r[s, i] = symmetric_rmsd(coords[s, i, :nl],
                                             true[i, :nl], meta["iso"][i])
            rmsds.append(r)
        else:
            rmsds.append(np.stack([ligand_rmsd(c, true, mask)[:nv]
                                   for c in coords]))
        cents.append(np.stack([centroid_distance(c, true, mask)[:nv]
                               for c in coords]))
        confs.append(scores.float().cpu().numpy()[:, :nv])
        pdbs.extend(meta["pdb"])
    rmsds = np.concatenate(rmsds, axis=1)
    cents = np.concatenate(cents, axis=1)
    confs = np.concatenate(confs, axis=1)

    if args.save_rmsd_dir:
        os.makedirs(args.save_rmsd_dir, exist_ok=True)
        for s in range(rmsds.shape[0]):
            path = os.path.join(args.save_rmsd_dir,
                                f"epoch{s}_confidence.txt")
            with open(path, "w") as f:
                for i, pdb in enumerate(pdbs):
                    f.write(f"{pdb} {rmsds[s, i]:.6f} {cents[s, i]:.6f} "
                            f"{confs[s, i]:.6f}\n")

    best_rmsd, best_cent = aggregate_topn(rmsds, cents, confs, args.topn)
    metrics = summarize_rmsd(best_rmsd)
    metrics.update(summarize_rmsd(best_cent, prefix="centroid_dis"))
    metrics["n"] = int(rmsds.shape[1])
    metrics["sample_size"] = int(rmsds.shape[0])
    print(json.dumps(metrics, indent=2))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(metrics, f, indent=2)
    return metrics


if __name__ == "__main__":
    main()
