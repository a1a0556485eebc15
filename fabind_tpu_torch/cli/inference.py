"""Custom-complex inference: an index of (ligand, protein) rows -> docked
SDF files, on the GPU by default.

Own copy of fabind_tpu/cli/inference.py on the port's DockingEngine. With
--ligand-sdf-dir each row's ligand is an SDF conformer, docked without RDKit
(`DockingEngine.dock_sdf`: pure V2000 reader and writer, the protein
embedded by the port's ESM2 encoder) and written in the PDB's world frame.
Rows without --ligand-sdf-dir are SMILES, which need RDKit for a conformer:
each is skipped with the JAX package's RDKit error, as on a host without
RDKit.

Usage:
  python -m fabind_tpu_torch.cli.inference --preset fabind \
      --ckpt best_model.bin --esm-weights esm2_t33_650M_UR50D/ \
      --index example.csv --pdb-dir pdbs/ --ligand-sdf-dir ligands/ \
      --output out/ [--post-optim] [--bf16] [--device cuda|cpu] \
      [--set KEY=VALUE ...]

Index CSV columns: Cleaned_SMILES (or smiles), pdb_file (or pdb, pdb_id),
and optionally ligand_id. With --ligand-sdf-dir the ligand of a row is
DIR/{id}/{id}_ligand.sdf or DIR/{id}.sdf, id = ligand_id or the pdb name.
The output directory gets one SDF per docked row and index.csv (pdb,
smiles, sdf). With --preset fabflex each row also gets NAME_pocket.npz
(`coords` [n_pocket, 3] of the docked pocket residues, `residues` their
indices into the protein) and index.csv a `pocket` column naming it.
"""
from __future__ import annotations

import argparse
import csv
import os
import zlib

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--preset", default="fabind",
                   choices=["fabind", "fabind_plus", "fabflex"])
    p.add_argument("--ckpt", required=True,
                   help="docking weights: a released .bin/.pt, a "
                        "save_params file or a cli.train run")
    p.add_argument("--esm-weights", required=True, metavar="PATH",
                   help="ESM2 encoder: a local HuggingFace directory or "
                        "torch state dict (models.esm2.load_esm2)")
    p.add_argument("--index", required=True, help="csv with SMILES + pdb ids")
    p.add_argument("--pdb-dir", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--batch-size", type=int, default=4)
    p.add_argument("--post-optim", action="store_true")
    p.add_argument("--post-optim-steps", type=int, default=1000)
    p.add_argument("--bf16", action="store_true",
                   help="serve in bfloat16 (the deployment dtype); default "
                        "fp32")
    p.add_argument("--write-mol2", action="store_true",
                   help="not in the port: the MOL2 conversion needs "
                        "RDKit/openbabel")
    p.add_argument("--ligand-sdf-dir", default=None,
                   help="dock SDF conformers: per row, the ligand is "
                        "DIR/{id}/{id}_ligand.sdf or DIR/{id}.sdf (the "
                        "reference's gt_mol_files layout)")
    p.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                   help="override a preset field (config.parse_overrides)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    if args.write_mol2:
        raise SystemExit("--write-mol2 needs RDKit/openbabel, which the "
                         "port does not use")

    from fabind_tpu_torch.cli.common import resolve_device
    from fabind_tpu_torch.config import parse_overrides, preset
    from fabind_tpu_torch.data.featurize import write_sdf
    from fabind_tpu_torch.models.esm2 import load_esm2
    from fabind_tpu_torch.serve import DockingEngine
    from fabind_tpu_torch.train.checkpoints import load_weights

    device = resolve_device(args.device, "cli.inference")
    cfg = preset(args.preset, **parse_overrides(args.set))
    engine = DockingEngine(
        cfg, state_dict=load_weights(args.ckpt), batch_size=args.batch_size,
        bf16=args.bf16,
        post_optim_steps=args.post_optim_steps if args.post_optim else 0,
        device=device, esm=load_esm2(args.esm_weights))
    os.makedirs(args.output, exist_ok=True)

    with open(args.index) as f:
        rows = list(csv.DictReader(f))
    requests, metas = [], []
    for row in rows:
        smiles = row.get("Cleaned_SMILES") or row.get("smiles")
        pdb = row.get("pdb_file") or row.get("pdb") or row.get("pdb_id")
        lig_id = row.get("ligand_id") or pdb
        pdb_path = os.path.join(args.pdb_dir, pdb + ".pdb")
        if args.ligand_sdf_dir:
            cand = [os.path.join(args.ligand_sdf_dir, lig_id,
                                 lig_id + "_ligand.sdf"),
                    os.path.join(args.ligand_sdf_dir, lig_id + ".sdf")]
            lig = next((c for c in cand if os.path.exists(c)), cand[-1])
            requests.append((lig, pdb_path))
            metas.append({"smiles": smiles or lig_id, "pdb": pdb})
        else:
            requests.append((smiles, pdb_path))
            metas.append({"smiles": smiles, "pdb": pdb})

    poses = (engine.dock_sdf(requests) if args.ligand_sdf_dir
             else engine.dock_smiles(requests))

    index_rows = []
    n_skipped = 0
    for meta, pose in zip(metas, poses):
        if pose.error is not None:   # skip and go on, per complex
            n_skipped += 1
            print(f"SKIP {meta['pdb']} / {meta['smiles'][:40]}: {pose.error}")
            continue
        # crc32, not hash(): str hashes change from process to process
        name = f"{meta['pdb']}_{zlib.crc32(meta['smiles'].encode()):08x}"
        # rows that fall back to the same (pdb, ligand id) must not
        # overwrite each other's SDF: number them in row order
        taken = {r["sdf"] for r in index_rows}
        if os.path.join(args.output, name + ".sdf") in taken:
            k = 2
            while os.path.join(args.output, f"{name}_r{k}.sdf") in taken:
                k += 1
            name = f"{name}_r{k}"
        sdf = os.path.join(args.output, name + ".sdf")
        write_sdf(sdf, pose.sdf_meta["symbols"], pose.coords,
                  pose.sdf_meta["bonds"], name=name,
                  charges=pose.sdf_meta["charges"])
        row = {"pdb": meta["pdb"], "smiles": meta["smiles"], "sdf": sdf}
        if cfg.model.flexible_docking and pose.pocket_coords is not None:
            # the docked pocket beside the pose
            row["pocket"] = os.path.join(args.output, name + "_pocket.npz")
            np.savez(row["pocket"], coords=pose.pocket_coords,
                     residues=pose.pocket_residues)
        index_rows.append(row)
    if n_skipped:
        print(f"skipped {n_skipped}/{len(rows)} complexes")
    fields = ["pdb", "smiles", "sdf"]
    if cfg.model.flexible_docking:
        fields.append("pocket")
    with open(os.path.join(args.output, "index.csv"), "w", newline="") as f:
        wtr = csv.DictWriter(f, fieldnames=fields)
        wtr.writeheader()
        wtr.writerows(index_rows)
    print(f"wrote {len(index_rows)} poses to {args.output}")


if __name__ == "__main__":
    main()
