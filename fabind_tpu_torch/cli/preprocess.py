"""Preprocessing: structure files -> the NPZ store `data.dataset.NPZSource`
reads, and FASTA -> ESM2 embeddings; on the GPU by default.

Own copy of two modes of fabind_tpu/cli/preprocess.py:
- inference: an index CSV of (name, sdf, pdb_file) rows -> one {name}.npz
  per complex with the JAX package's keys: the SDF conformer featurized
  without RDKit (data/featurize.py featurize_sdf), the protein parsed from
  its PDB and embedded by the port's ESM2 encoder (once per file). A row
  without an `sdf` is a SMILES, which needs RDKit for a conformer: it is
  skipped with the JAX package's RDKit error, as on a host without RDKit;
- esm: a FASTA file -> {name}.npy per sequence, batched
  (reference tools/generate_esm2_t33.py:20-53).

Not ported (ROADMAP queue 1): --isomorphisms (networkx VF2), the pdbbind
and inject-iso modes (the processed-LMDB store), esm --lmdb and --esm-dp
(data-parallel embedding); each raises.

Usage:
  python -m fabind_tpu_torch.cli.preprocess inference --index pairs.csv \
      --out npz/ --esm-weights esm2_t33_650M_UR50D/ [--device cuda|cpu]
  python -m fabind_tpu_torch.cli.preprocess esm --seqs seqs.fasta \
      --out esm/ --esm-weights esm2_t33_650M_UR50D/ [--esm-batch 8]
"""
from __future__ import annotations

import argparse
import csv
import os
import sys

import numpy as np

_NOT_PORTED = ("is not ported yet (ROADMAP.md, open items, queue 1: {})")


def _log(msg):
    print(msg, file=sys.stderr, flush=True)


def _encoder(args):
    from fabind_tpu_torch.cli.common import resolve_device
    from fabind_tpu_torch.models.esm2 import load_esm2
    device = resolve_device(args.device, "cli.preprocess")
    return load_esm2(args.esm_weights).to(device)


def _mol_record(row):
    """The featurized ligand of a row, or None (logged) when it fails: one
    bad ligand must not abort the run."""
    from fabind_tpu_torch.data.featurize import RDKIT_MISSING, featurize_sdf
    sdf = (row.get("sdf") or "").strip()
    try:
        if not sdf:   # a SMILES row: its conformer needs RDKit
            raise ImportError(RDKIT_MISSING)
        return featurize_sdf(sdf)
    except Exception as e:
        _log(f"skip {sdf or row.get('smiles')!r}: {type(e).__name__}: {e}")
        return None


def run_inference_mode(args):
    from fabind_tpu_torch.data.featurize import (extract_esm_feature,
                                                 extract_protein_structure)
    if args.isomorphisms:
        raise NotImplementedError(
            "--isomorphisms " + _NOT_PORTED.format("data/isomorphism.py "
                                                   "VF2"))
    model = _encoder(args)
    os.makedirs(args.out, exist_ok=True)
    with open(args.index) as f:
        rows = list(csv.DictReader(f))
    _log(f"{len(rows)} complexes")
    protein_cache = {}
    n_ok = 0
    for row in rows:
        rec = _mol_record(row)
        if rec is None:
            continue
        try:
            pdb_file = row["pdb_file"]
            if pdb_file not in protein_cache:
                st = extract_protein_structure(pdb_file)
                protein_cache[pdb_file] = (
                    st, extract_esm_feature(st["seq"], model))
            st, esm = protein_cache[pdb_file]
            np.savez(os.path.join(args.out, row["name"] + ".npz"),
                     protein_xyz=st["coords"][:, 1],          # CA
                     protein_full_coords=st["coords"],
                     esm_feat=esm,
                     lig_coords=rec["coords"],                # conformer
                     lig_feats=rec["feats"],
                     bond_edges=rec["bond_edges"],
                     bond_orders=rec["bond_orders"],
                     iso_labels=rec["iso_labels"],
                     las_mask=rec["las_mask"],
                     rdkit_coords=rec["coords"],
                     smiles=np.asarray(rec["smiles"]
                                       or row.get("smiles") or ""),
                     seq=np.asarray(st["seq"]))
            n_ok += 1
        except Exception as e:   # skip and go on, per complex
            _log(f"SKIP {row.get('name')}: {type(e).__name__}: {e}")
    _log(f"wrote {n_ok}/{len(rows)} complexes -> {args.out}")


def read_fasta(path: str):
    """[(name, sequence)] of a FASTA file, in file order."""
    entries, name, parts = [], None, []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line.startswith(">"):
                if name:
                    entries.append((name, "".join(parts)))
                name, parts = line[1:], []
            elif line:
                parts.append(line)
    if name:
        entries.append((name, "".join(parts)))
    return entries


def run_esm_mode(args):
    """FASTA -> {name}.npy, `--esm-batch` sequences per forward."""
    from fabind_tpu_torch.data.featurize import extract_esm_features
    if args.lmdb:
        raise NotImplementedError(
            "esm --lmdb " + _NOT_PORTED.format("the processed-LMDB source"))
    if args.esm_dp != 1:
        raise NotImplementedError(
            "--esm-dp " + _NOT_PORTED.format("data parallelism"))
    if not (args.seqs and args.out):
        raise SystemExit("esm mode needs --seqs AND --out")
    model = _encoder(args)
    entries = read_fasta(args.seqs)
    embs = extract_esm_features([s for _, s in entries], model,
                                batch_size=args.esm_batch)
    os.makedirs(args.out, exist_ok=True)
    for (name, _), emb in zip(entries, embs):
        np.save(os.path.join(args.out, f"{name}.npy"), emb)
        _log(f"{name}: {emb.shape}")


def main(argv=None):
    p = argparse.ArgumentParser()
    sub = p.add_subparsers(dest="mode", required=True)

    pi = sub.add_parser("inference")
    pi.add_argument("--index", required=True,
                    help="CSV with columns name,sdf,pdb_file (or smiles "
                         "in place of sdf, which needs RDKit)")
    pi.add_argument("--out", required=True)
    pi.add_argument("--isomorphisms", action="store_true",
                    help="not ported yet (networkx VF2)")

    pe = sub.add_parser("esm")
    pe.add_argument("--seqs", default=None, help="FASTA file")
    pe.add_argument("--out", default=None)
    pe.add_argument("--lmdb", default=None, help="not ported yet")
    pe.add_argument("--esm-batch", type=int, default=8,
                    help="sequences per forward")
    pe.add_argument("--esm-dp", type=int, default=1, help="not ported yet")

    for sp in (pi, pe):
        sp.add_argument("--esm-weights", required=True, metavar="PATH",
                        help="ESM2 encoder: a local HuggingFace directory "
                             "or torch state dict (models.esm2.load_esm2)")
        sp.add_argument("--device", default="cuda")
    for mode, what in (("pdbbind", "the processed-LMDB source"),
                       ("inject-iso", "data/isomorphism.py VF2")):
        sp = sub.add_parser(mode, help="not ported yet")
        sp.set_defaults(not_ported=what)

    args, rest = p.parse_known_args(argv)
    if getattr(args, "not_ported", None):
        raise NotImplementedError(
            f"preprocess {args.mode} " + _NOT_PORTED.format(args.not_ported))
    if rest:
        p.error(f"unrecognized arguments: {' '.join(rest)}")
    if args.mode == "inference":
        run_inference_mode(args)
    else:
        run_esm_mode(args)


if __name__ == "__main__":
    main()
