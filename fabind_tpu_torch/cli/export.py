"""Export deployment artifacts: one weights-baked `torch.export` program per
shape bucket (fabind_tpu_torch.aot), traced on the card by default.

Counterpart of fabind_tpu/cli/export.py; `--device` takes the place of its
`--platforms` (an artifact exported on the CPU serves on the card too).
`--sampling` adds each bucket's two best-of-N sampling halves (a preset
with the confidence head: fabind_plus_sampling), so the artifact's engine
serves dock_best_of.

Usage:
  python -m fabind_tpu_torch.cli.export --preset fabind --ckpt best_model.bin \
      --output exported/ [--buckets 48:160:408,96:160:512,128:256:1024] \
      [--batch-size 8] [--no-bf16] [--device cuda|cpu] \
      [--post-optim-steps N] [--sampling] [--set KEY=VALUE ...]

--ckpt takes a released `.bin`/`.pt` checkpoint or a port checkpoint (a
`save_params` file, a checkpoint directory or a `cli.train` run directory).
Serve the artifact with `DockingEngine.from_exported("exported/")` or
`python -m fabind_tpu_torch.cli.serve --exported exported/`.
"""
from __future__ import annotations

import argparse
import json
import os
import time


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--preset", default="fabind",
                   choices=["fabind", "fabind_plus", "fabind_plus_sampling",
                            "fabflex"])
    p.add_argument("--ckpt", required=True,
                   help="released .bin/.pt checkpoint or port checkpoint "
                        "(train.checkpoints.load_weights)")
    p.add_argument("--output", required=True, help="artifact directory")
    p.add_argument("--buckets", default=None,
                   help="explicit shape buckets 'lig:pocket:protein[,...]' "
                        "(default: the single cfg.shapes bucket); each "
                        "bucket becomes one exported program")
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--no-bf16", action="store_true",
                   help="export fp32 programs (default bakes the bf16 "
                        "deployment cast into the artifact)")
    p.add_argument("--device", default="cuda",
                   help="device the programs are traced on (cuda or cpu); "
                        "the artifact serves on either")
    p.add_argument("--post-optim-steps", type=int, default=0,
                   help="LAS post-optimization steps the artifact's engine "
                        "runs after each program (reference "
                        "fabind_inference.py:373)")
    p.add_argument("--sampling", action="store_true",
                   help="also export the best-of-N sampling programs "
                        "(pocket half + stochastic dock half per bucket; "
                        "needs the confidence head: fabind_plus_sampling)")
    p.add_argument("--set", action="append", default=[], metavar="KEY=VALUE")
    args = p.parse_args(argv)

    from fabind_tpu_torch.aot import export_inference
    from fabind_tpu_torch.cli.common import load_model, resolve_device
    from fabind_tpu_torch.config import parse_overrides, preset
    from fabind_tpu_torch.data.buckets import resolve_buckets

    device = resolve_device(args.device, "cli.export")
    cfg = preset(args.preset, **parse_overrides(args.set))
    buckets = resolve_buckets(args.buckets, cfg)
    state_dict = load_model(cfg, args.ckpt, "cpu").state_dict()

    t0 = time.perf_counter()
    manifest = export_inference(
        cfg, state_dict, args.output, buckets=buckets,
        batch_size=args.batch_size, bf16=not args.no_bf16,
        post_optim_steps=args.post_optim_steps, device=device,
        sampling=args.sampling)
    size = sum(os.path.getsize(os.path.join(args.output, e[k]))
               for e in manifest["buckets"]
               for k in ("file", "pocket_file", "sample_file") if k in e)
    print(json.dumps({"artifacts": len(manifest["buckets"]), "bytes": size,
                      "seconds": round(time.perf_counter() - t0, 1),
                      "output": args.output}))


if __name__ == "__main__":
    main()
