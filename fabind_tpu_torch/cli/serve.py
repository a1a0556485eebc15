"""Serving daemon entry point: a weight-resident DockingEngine behind the
HTTP server (fabind_tpu_torch.serve_http), on the GPU by default.

Usage:
  python -m fabind_tpu_torch.cli.serve \
      --preset fabind|fabind_plus|fabind_plus_sampling --ckpt best_model.bin \
      [--host 127.0.0.1] [--port 8400] [--batch-size 8] [--no-bf16] \
      [--post-optim-steps N] [--warmup] \
      [--buckets l:p:r,l:p:r | --buckets auto[:K] --data NPZ_DIR] \
      [--set KEY=VALUE ...] [--device cuda|cpu]

Without --ckpt the engine serves seeded random weights (smoke tests only).
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
    p.add_argument("--post-optim-steps", type=int, default=0)
    p.add_argument("--buckets", default=None,
                   help="explicit shape buckets 'lig:pocket:protein,...' "
                        "(the largest must cover the preset's shapes), or "
                        "'auto'/'auto:K' to infer up to K (default 3) "
                        "buckets from --data's size distribution")
    p.add_argument("--data", default=None,
                   help="directory of .npz samples that '--buckets auto' "
                        "measures")
    p.add_argument("--warmup", action="store_true",
                   help="run one batch in every bucket before binding the "
                        "port")
    p.add_argument("--set", action="append", default=[], metavar="KEY=VALUE")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    if args.preset == "fabflex":
        raise NotImplementedError(
            "preset 'fabflex': the flexible-docking forward is not ported "
            "yet (ROADMAP queue 1)")

    from fabind_tpu_torch.config import parse_overrides, preset
    from fabind_tpu_torch.data.buckets import resolve_buckets
    from fabind_tpu_torch.serve import DockingEngine
    from fabind_tpu_torch.serve_http import serve_forever

    cfg = preset(args.preset, **parse_overrides(args.set))
    source = indices = None
    if args.buckets and args.buckets.startswith("auto"):
        if not args.data:
            raise SystemExit("--buckets auto requires --data to measure "
                             "the complex-size distribution")
        from fabind_tpu_torch.data.dataset import open_source
        source, indices = open_source(args.data)
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
                           device=args.device)
    if args.warmup:
        print(f"warming up {len(engine.bucket_cfgs)} bucket(s)...",
              flush=True)
        print(f"warmup done in {engine.warmup():.1f}s", flush=True)
    serve_forever(engine, args.host, args.port)


if __name__ == "__main__":
    main()
