"""Serving daemon entry point: a weight-resident DockingEngine behind the
HTTP server (fabind_tpu_torch.serve_http), on the GPU by default.

Usage:
  python -m fabind_tpu_torch.cli.serve \
      --preset fabind|fabind_plus|fabind_plus_sampling --ckpt best_model.bin \
      [--host 127.0.0.1] [--port 8400] [--batch-size 8] [--no-bf16] \
      [--post-optim-steps N] [--warmup] [--dp N] \
      [--buckets l:p:r,l:p:r | --buckets auto[:K] --data DATA] \
      [--set KEY=VALUE ...] [--device cuda|cpu] \
      [--esm-weights PATH] [--pdb-root DIR]

  # or serve an artifact directory of cli.export: no model built, no
  # checkpoint read; preset, buckets, batch size and dtype come from its
  # manifest; /dock_best_of when it was exported with --sampling
  python -m fabind_tpu_torch.cli.serve --exported exported/ [--port 8400] \
      [--device cuda|cpu] [--warmup] [--esm-weights PATH] [--pdb-root DIR]

Without --ckpt the engine serves seeded random weights (smoke tests only).
--dp N serves one engine over N cards (cuda:0..N-1, 0 = every visible card;
N CPU replicas with --device cpu): each batch's rows split into N blocks,
one per replica (DockingEngine(dp=N)); --batch-size must divide by N. An
artifact (--exported) serves on one device, and --dp refuses it.
/dock_sdf needs --esm-weights (models.esm2.load_esm2: a local HuggingFace
ESM2 directory or state dict) to embed its proteins.
"""
from __future__ import annotations

import argparse


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--preset", default="fabind",
                   choices=["fabind", "fabind_plus", "fabind_plus_sampling",
                            "fabflex"])
    p.add_argument("--ckpt", default=None,
                   help="released torch .bin/.pt checkpoint "
                        "(train.convert.load_torch_checkpoint)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8400)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--no-bf16", action="store_true",
                   help="serve in fp32 instead of bf16")
    p.add_argument("--dp", type=int, default=1,
                   help="data-parallel serving over N devices")
    p.add_argument("--post-optim-steps", type=int, default=0)
    p.add_argument("--buckets", default=None,
                   help="explicit shape buckets 'lig:pocket:protein,...' "
                        "(the largest must cover the preset's shapes), or "
                        "'auto'/'auto:K' to infer up to K (default 3) "
                        "buckets from --data's size distribution")
    p.add_argument("--data", default=None,
                   help="what '--buckets auto' measures: the reference's "
                        "processed PDBbind root (its test split) or a "
                        "directory of .npz samples")
    p.add_argument("--warmup", action="store_true",
                   help="run one batch in every bucket before binding the "
                        "port")
    p.add_argument("--pdb-root", default=None,
                   help="restrict /dock_sdf requests to PDB files under "
                        "this directory (path-checked); without it "
                        "/dock_sdf accepts any path on the server")
    p.add_argument("--esm-weights", default=None, metavar="PATH",
                   help="ESM2 encoder for /dock_sdf's proteins: a local "
                        "HuggingFace directory or torch state dict")
    p.add_argument("--exported", default=None, metavar="DIR",
                   help="serve a cli.export artifact directory instead "
                        "of --ckpt: weights are baked into the per-bucket "
                        "programs, and config/buckets/batch-size/bf16 "
                        "come from the manifest — model flags passed "
                        "alongside are rejected to prevent silent "
                        "disagreement (--preset/--batch-size have argparse "
                        "defaults and are simply ignored)")
    p.add_argument("--set", action="append", default=[], metavar="KEY=VALUE")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    if args.exported:
        baked = [n for n, v in [("--ckpt", args.ckpt),
                                ("--buckets", args.buckets),
                                ("--set", args.set or None),
                                ("--dp", args.dp if args.dp != 1 else None),
                                ("--no-bf16", args.no_bf16 or None),
                                ("--post-optim-steps",
                                 args.post_optim_steps or None)]
                 if v is not None]
        if baked:
            raise SystemExit(f"--exported bakes these into the artifact; "
                             f"drop {', '.join(baked)} (re-export to change "
                             f"them)")

    from fabind_tpu_torch.config import parse_overrides, preset
    from fabind_tpu_torch.data.buckets import resolve_buckets
    from fabind_tpu_torch.serve import DockingEngine

    esm = None
    if args.esm_weights is not None:
        from fabind_tpu_torch.models.esm2 import load_esm2
        esm = load_esm2(args.esm_weights)
    if args.exported:
        engine = DockingEngine.from_exported(args.exported,
                                             device=args.device, esm=esm)
        _serve(engine, args)
        return

    cfg = preset(args.preset, **parse_overrides(args.set))
    source = indices = None
    if args.buckets and args.buckets.startswith("auto"):
        if not args.data:
            raise SystemExit("--buckets auto requires --data to measure "
                             "the complex-size distribution")
        from fabind_tpu_torch.data.dataset import open_source
        source, indices = open_source(args.data, variant=args.preset,
                                      split="test",
                                      use_esm2_feat=cfg.model.use_esm2_feat)
    buckets = resolve_buckets(args.buckets, cfg, source, indices,
                              group="test")
    if buckets is not None:
        print("buckets:", [(s.max_ligand, s.max_pocket, s.max_protein)
                           for s in buckets])
    state_dict = None
    if args.ckpt is not None:
        from fabind_tpu_torch.train.convert import load_torch_checkpoint
        state_dict = load_torch_checkpoint(args.ckpt)
    engine = DockingEngine(cfg, state_dict=state_dict, buckets=buckets,
                           batch_size=args.batch_size,
                           bf16=not args.no_bf16,
                           post_optim_steps=args.post_optim_steps,
                           device=args.device, esm=esm, dp=args.dp)
    _serve(engine, args)


def _serve(engine, args) -> None:
    from fabind_tpu_torch.serve_http import serve_forever

    if args.warmup:
        print(f"warming up {len(engine.bucket_cfgs)} bucket(s)...",
              flush=True)
        print(f"warmup done in {engine.warmup():.1f}s", flush=True)
    serve_forever(engine, args.host, args.port, pdb_root=args.pdb_root)


if __name__ == "__main__":
    main()
