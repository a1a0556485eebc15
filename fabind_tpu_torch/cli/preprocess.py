"""Preprocessing: structure files or the reference's processed PDBbind
store -> the NPZ store `data.dataset.NPZSource` reads; the store's
automorphism upgrade; ESM2 embeddings. The modes that run the ESM2 encoder
run on the GPU by default.

Own copy of fabind_tpu/cli/preprocess.py:
- inference: an index CSV of (name, sdf, pdb_file) rows -> one {name}.npz
  per complex with the JAX package's keys: the SDF conformer featurized
  without RDKit (data/featurize.py featurize_sdf), the protein parsed from
  its PDB and embedded by the port's ESM2 encoder (once per file);
  `--isomorphisms` adds the ligand's automorphisms (data/isomorphism.py).
  A row without an `sdf` is a SMILES, which needs RDKit for a conformer:
  it is skipped with the JAX package's RDKit error, as on a host without
  RDKit;
- pdbbind: the reference's processed store -> an NPZ directory, one
  {pdb}.npz per index row (`--limit` rows), with automorphisms under
  `--isomorphisms`; host only;
- inject-iso: data.pt -> data_new.pt with FABind+'s `isomorphics` column
  (the reference's tools/inject_isomorphism_to_data.py:30-47), computed
  from the compound graphs in the store; rows with use_compound_com False
  get []; written without pandas (data/frame.py save_frame); host only;
- esm: a FASTA file -> {name}.npy per sequence, or with `--lmdb ROOT` the
  store's protein_1d_3d.lmdb -> esm2_t33_650M_UR50D.lmdb, batched
  (reference tools/generate_esm2_t33.py:20-53).

`esm --esm-dp N` embeds over N replicas of the encoder (cards
cuda:0..N-1, 0 = every visible card, or N CPU replicas with --device cpu),
held for the run: each forward takes --esm-batch x N rows, --esm-batch on
each replica (models.esm2.Esm2Model.embed_sequences).

Usage:
  python -m fabind_tpu_torch.cli.preprocess inference --index pairs.csv \
      --out npz/ --esm-weights esm2_t33_650M_UR50D/ [--isomorphisms] \
      [--device cuda|cpu]
  python -m fabind_tpu_torch.cli.preprocess pdbbind --data ROOT --out npz/ \
      [--limit N] [--isomorphisms] [--max-iso K]
  python -m fabind_tpu_torch.cli.preprocess inject-iso --data ROOT \
      [--max-iso K]
  python -m fabind_tpu_torch.cli.preprocess esm --seqs seqs.fasta \
      --out esm/ --esm-weights esm2_t33_650M_UR50D/ [--esm-batch 8] \
      [--esm-dp N]
  python -m fabind_tpu_torch.cli.preprocess esm --lmdb ROOT \
      --esm-weights esm2_t33_650M_UR50D/ [--esm-batch 8] [--esm-dp N]
"""
from __future__ import annotations

import argparse
import csv
import os
import pickle
import sys

import numpy as np


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


def _max_iso(args):
    """--max-iso: 0 (the default) stores the full group, bounded by
    HARD_ISO_LIMIT; the collator caps the device copy separately."""
    return args.max_iso if args.max_iso > 0 else None


def _automorphisms(feats, bond_edges, bond_orders, max_iso, labels=None):
    """The ligand's automorphisms under the reference's labels
    (atomic number * 100 + incident bond-type indices)."""
    from fabind_tpu_torch.data.isomorphism import (automorphisms_from_graph,
                                                   iso_labels_from_arrays)
    if labels is None:
        labels = iso_labels_from_arrays(feats, bond_edges, bond_orders)
    return automorphisms_from_graph(feats.shape[0], bond_edges, labels,
                                    max_iso=max_iso)


def run_inference_mode(args):
    from fabind_tpu_torch.data.featurize import (extract_esm_feature,
                                                 extract_protein_structure)
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
            out = dict(protein_xyz=st["coords"][:, 1],          # CA
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
            if args.isomorphisms:
                out["isomorphisms"] = _automorphisms(
                    rec["feats"], rec["bond_edges"], rec["bond_orders"],
                    _max_iso(args), labels=rec["iso_labels"])
            np.savez(os.path.join(args.out, row["name"] + ".npz"), **out)
            n_ok += 1
        except Exception as e:   # skip and go on, per complex
            _log(f"SKIP {row.get('name')}: {type(e).__name__}: {e}")
    _log(f"wrote {n_ok}/{len(rows)} complexes -> {args.out}")


def run_pdbbind_mode(args):
    """The processed store -> {pdb}.npz per index row (the first --limit)."""
    from fabind_tpu_torch.data.dataset import PDBBindLMDBSource
    src = PDBBindLMDBSource(args.data, use_esm2_feat=True)
    os.makedirs(args.out, exist_ok=True)
    n = len(src) if args.limit is None else min(args.limit, len(src))
    n_ok = 0
    for i in range(n):
        try:
            raw = src.get(i)
            name = str(raw.get("pdb", i))
            if args.isomorphisms and raw.get("isomorphisms") is None:
                raw["isomorphisms"] = _automorphisms(
                    raw["lig_feats"], raw["bond_edges"],
                    raw.get("bond_orders"), _max_iso(args))
            raw.pop("group", None)
            np.savez(os.path.join(args.out, f"{name}.npz"),
                     **{k: v for k, v in raw.items() if v is not None})
            n_ok += 1
        except Exception as e:   # skip and go on, per complex
            _log(f"SKIP {i}: {type(e).__name__}: {e}")
    _log(f"wrote {n_ok} complexes -> {args.out}")


def run_inject_iso_mode(args):
    """The store's index -> data_new.pt with the `isomorphics` column
    (FABind_plus/fabind/tools/inject_isomorphism_to_data.py:30-47), from
    the compound graphs already in the store instead of an SDF directory
    through RDKit. Rows with use_compound_com False get [], as in the
    reference (:35-37). The source's own index is upgraded (data_new.pt
    when present), so a second run replaces the column in place."""
    from fabind_tpu_torch.data.dataset import PDBBindLMDBSource
    from fabind_tpu_torch.data.frame import save_frame

    src = PDBBindLMDBSource(args.data, use_esm2_feat=False)
    use = src.index["use_compound_com"] if "use_compound_com" in src.index \
        else [True] * len(src)
    isomorphics = []
    n_nontrivial = 0
    for i in range(len(src)):
        if not bool(use[i]):
            isomorphics.append([])
            continue
        raw = src.get(i)
        autos = _automorphisms(raw["lig_feats"], raw["bond_edges"],
                               raw.get("bond_orders"), _max_iso(args))
        isomorphics.append([np.asarray(a, np.int64) for a in autos])
        n_nontrivial += len(autos) > 1
    out = os.path.join(args.data, "dataset", "processed", "data_new.pt")
    save_frame(out, {**src.index.columns, "isomorphics": isomorphics})
    _log(f"wrote {out}: {len(src)} rows, {n_nontrivial} with a non-trivial "
         f"automorphism group")


# int code -> residue letter of the store's protein_1d_3d.lmdb sequences
# (generate_esm2_t33.py:13-18; fixed by the published dataset format)
_NUM_TO_LETTER = {4: "C", 3: "D", 15: "S", 5: "Q", 11: "K", 9: "I",
                  14: "P", 16: "T", 13: "F", 0: "A", 7: "G", 8: "H",
                  6: "E", 10: "L", 1: "R", 17: "W", 19: "V",
                  2: "N", 18: "Y", 12: "M"}


def run_esm_lmdb_mode(args, model, replicas=None):
    """protein_1d_3d.lmdb -> esm2_t33_650M_UR50D.lmdb (the reference's
    tools/generate_esm2_t33.py:25-53), batched: the store's sequences in
    key order, embedded in chunks of 4 forwards of --esm-batch (on each of
    the encoder's `replicas`), each embedding pickled as a float32 numpy
    array."""
    from fabind_tpu_torch.data.featurize import extract_esm_features
    from fabind_tpu_torch.data.kv import open_kv
    p = os.path.join(args.lmdb, "dataset", "processed")
    src = open_kv(os.path.join(p, "protein_1d_3d.lmdb"), readonly=True)
    dst = open_kv(os.path.join(p, "esm2_t33_650M_UR50D.lmdb"),
                  readonly=False, map_size=1024 ** 4)
    n = 0
    chunk_rows = args.esm_batch * (1 if replicas is None
                                   else len(replicas)) * 4
    with src.begin(write=False) as txn, dst.begin(write=True) as out:
        pending = []

        def flush():
            nonlocal n
            embs = extract_esm_features([s for _, s in pending], model,
                                        batch_size=args.esm_batch,
                                        dp=replicas or 1)
            for (key, _), emb in zip(pending, embs):
                out.put(key, pickle.dumps(emb))
                n += 1
                if n % 100 == 0:
                    _log(f"{n} proteins embedded")
            pending.clear()

        for key, value in txn.cursor():
            seq_ids = pickle.loads(value)[1].tolist()
            pending.append(
                (bytes(key), "".join(_NUM_TO_LETTER[a] for a in seq_ids)))
            if len(pending) >= chunk_rows:
                flush()
        if pending:
            flush()
    src.close()
    dst.close()
    _log(f"wrote {n} embeddings -> {p}/esm2_t33_650M_UR50D.lmdb")


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
    """FASTA -> {name}.npy (or, with --lmdb, the store's ESM2 LMDB),
    `--esm-batch` sequences per forward."""
    from fabind_tpu_torch.data.featurize import extract_esm_features
    from fabind_tpu_torch.parallel.dp import ReplicaSet, dp_devices
    if not (args.lmdb or (args.seqs and args.out)):
        raise SystemExit("esm mode needs --seqs AND --out (or --lmdb)")
    model = _encoder(args)
    replicas = None
    if args.esm_dp != 1:
        replicas = ReplicaSet(model, dp_devices(args.device, args.esm_dp))
    try:
        if args.lmdb:
            return run_esm_lmdb_mode(args, model, replicas)
        entries = read_fasta(args.seqs)
        embs = extract_esm_features([s for _, s in entries], model,
                                    batch_size=args.esm_batch,
                                    dp=replicas or 1)
    finally:
        if replicas is not None:
            replicas.close()
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
                    help="store each ligand's automorphisms")
    pi.add_argument("--max-iso", type=int, default=0,
                    help="cap stored automorphisms (0 = full group; the "
                         "collator caps the device copy separately)")

    pp = sub.add_parser("pdbbind")
    pp.add_argument("--data", required=True,
                    help="the reference's processed PDBbind root")
    pp.add_argument("--out", required=True)
    pp.add_argument("--limit", type=int, default=None)
    pp.add_argument("--isomorphisms", action="store_true")
    pp.add_argument("--max-iso", type=int, default=0,
                    help="cap stored automorphisms (0 = full group)")

    pj = sub.add_parser(
        "inject-iso",
        help="upgrade a processed store's data.pt to data_new.pt with the "
             "isomorphics column")
    pj.add_argument("--data", required=True,
                    help="the reference's processed PDBbind root")
    pj.add_argument("--max-iso", type=int, default=0,
                    help="cap stored automorphisms (0 = full group)")

    pe = sub.add_parser("esm")
    pe.add_argument("--seqs", default=None, help="FASTA file")
    pe.add_argument("--out", default=None)
    pe.add_argument("--lmdb", default=None,
                    help="processed PDBbind root: embed protein_1d_3d.lmdb "
                         "into esm2_t33_650M_UR50D.lmdb instead of "
                         "FASTA -> npy")
    pe.add_argument("--esm-batch", type=int, default=8,
                    help="sequences per forward")
    pe.add_argument("--esm-dp", type=int, default=1,
                    help="encoder replicas, one per card (0 = every "
                         "visible card); each forward takes --esm-batch "
                         "rows on each")

    for sp in (pi, pe):
        sp.add_argument("--esm-weights", required=True, metavar="PATH",
                        help="ESM2 encoder: a local HuggingFace directory "
                             "or torch state dict (models.esm2.load_esm2)")
        sp.add_argument("--device", default="cuda")

    args = p.parse_args(argv)
    if args.mode == "inference":
        run_inference_mode(args)
    elif args.mode == "pdbbind":
        run_pdbbind_mode(args)
    elif args.mode == "inject-iso":
        run_inject_iso_mode(args)
    else:
        run_esm_mode(args)


if __name__ == "__main__":
    main()
