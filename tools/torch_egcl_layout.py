"""The FABind+ EGCL's per-edge source projection on one CUDA card.

    python3 tools/torch_egcl_layout.py [--bucket 48:160:512] [--batch 8]

The FABind+ EGCL (fabind_tpu_torch/models/egnn.py) gathers each edge's
source row from the packed per-node rows [x ++ h] and multiplies its
features by the source block of the edge MLP's gamma-scaled first linear
layer: [E, C] @ [C, H], where H, the edge MLP's hidden width, is 2C+1 at the
released mlp_hidden_scale 1 (1025 at C = 512). This script times that
product in bf16 at the docking stack's shapes (released width, seeded
random weights) and names the kernel cuBLAS runs for it:

  1. on fresh random operands: H as served, H padded to a multiple of 8,
     H = C, and padded H with the input rows read at element 3 of C+3;
  2. on the served operands of the first docking EGCL, for each packing of
     the gathered rows (packed 3+C [x ++ h], as served; packed 8+C
     [x ++ 0 ++ h]; h gathered alone) and each weight layout (the block
     sliced from the [H, 2C+1] weight, as served; copied out; copied out
     with zero rows that pad H to a multiple of 8);

then one docking EGCL forward and one FABind+ bf16 model batch of the model
in this checkout (median host-clock ms of work that ends in synchronize).
"""
from __future__ import annotations

import argparse
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from fabind_tpu_torch.config import preset  # noqa: E402
from fabind_tpu_torch.data.types import dummy_arrays  # noqa: E402
from fabind_tpu_torch.models.egnn import EGCL  # noqa: E402
from fabind_tpu_torch.ops import graph as G  # noqa: E402
from fabind_tpu_torch.serve import DockingEngine  # noqa: E402


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def device_ms(fn, iters=50, warmup=5) -> float:
    """Device time per call (CUDA events; a spin kernel holds the stream
    while the calls queue, so the host's launch rate does not count)."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(50_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_ms(fn, iters=7) -> float:
    """Median host-clock ms of fn() followed by synchronize."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def top_kernel(fn) -> str:
    """The device kernel with the most time in one call of fn."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    if not kernels:
        return "not measured (no device events)"
    return max(kernels, key=lambda e: e.self_device_time_total).key[:90]


def rand_bf16(*shape, offset: int = 0, seed: int = 0) -> torch.Tensor:
    """A random bf16 [*shape] tensor on the card; with `offset`, a view
    starting `offset` elements into each row of a wider buffer (a row
    stride of shape[-1] + offset, as a gathered packed row)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    t = torch.randn(*shape[:-1], shape[-1] + offset, device="cuda",
                    generator=g).to(torch.bfloat16)
    return t[..., offset:]


def gemm_line(what: str, a: torch.Tensor, w: torch.Tensor, line: str) -> None:
    fn = (lambda: F.linear(a, w))
    ms = device_ms(fn)
    rows = a.numel() // a.shape[-1]
    tflops = 2 * rows * a.shape[-1] * w.shape[0] / ms / 1e9
    print(f"{what} [{rows}, {a.shape[-1]}] @ [{a.shape[-1]}, {w.shape[0]}]: "
          f"{ms:.4f} ms, {tflops:.1f} TFLOP/s, kernel {top_kernel(fn)} "
          f"[{line}]")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--bucket", default="48:160:512",
                    help="lig:pocket:protein shape bucket")
    ap.add_argument("--batch", type=int, default=8)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_egcl_layout: needs a CUDA card", file=sys.stderr)
        return 1
    lig, pkt, prot = (int(v) for v in args.bucket.split(":"))
    cfg = preset("fabind_plus", max_ligand=lig, max_pocket=pkt,
                 max_protein=prot)
    C = cfg.model.hidden_size
    line = card_line()
    print(f"card: {line}")
    engine = DockingEngine(cfg, batch_size=args.batch, seed=0)
    batch = engine._to_device(dummy_arrays(
        cfg.shapes, batch_size=args.batch, seed=0,
        feat_dim=cfg.model.compound_feat_dim,
        prot_feat_dim=cfg.model.protein_feat_dim))
    dock = [m for m in engine.model.modules() if isinstance(m, EGCL)
            and m.edge_mlp.lin1.in_features == 2 * C + 1]
    egcl = dock[0]
    seen = []
    hook = egcl.register_forward_pre_hook(
        lambda mod, a: seen.append(a) if not seen else None)

    # 1. The src projection's product on fresh random operands: rows = a
    # batch's ctx edges (each node's ctx_k neighbours and itself over
    # ligand, pocket and the two global nodes), C inputs, H outputs with H
    # the edge MLP's hidden width (2C+1 at mlp_hidden_scale 1), H padded to
    # a multiple of 8, and H = C; then padded H with the rows read at
    # element 3 of C+3 (as from the packed gather)
    rows = args.batch * (lig + pkt + 2) * (cfg.shapes.ctx_k + 1)
    H = egcl.edge_mlp.lin1.out_features
    H8 = -(-H // 8) * 8
    x_al, x_mis = rand_bf16(rows, C), rand_bf16(rows, C, offset=3)
    for what, xa, n in (("1 fresh, H", x_al, H),
                        ("1 fresh, H padded", x_al, H8),
                        ("1 fresh, H = C", x_al, C),
                        ("1 fresh, rows at element 3, H padded", x_mis, H8)):
        gemm_line(what, xa, rand_bf16(n, C, seed=1), line)

    # 2. The served operands of the first docking EGCL: each packing, with
    # the src block as the EGCL slices it, copied out, and copied out with
    # zero rows that pad H to a multiple of 8
    with torch.inference_mode():
        engine.model.inference_diag(batch, shapes=cfg.shapes)
    hook.remove()
    h, x, ctx, gi = seen[0]
    idx = ctx.nbr_idx
    E = idx.numel()
    print(f"bucket {args.bucket}, batch {args.batch}, C {C}, H {H}, ctx "
          f"edges per node {idx.shape[-1]}, nodes {h.shape[1]}, {E} edges, "
          f"dtype {h.dtype}")
    with torch.inference_mode():
        Wg = egcl.edge_mlp.lin1.weight * egcl.edge_mlp.layernorm.weight
        w_src = Wg[:, C:2 * C]
        weights = {"w sliced": w_src, "w contiguous": w_src.contiguous(),
                   "w padded": F.pad(w_src, (0, 0, 0, H8 - H))}
        pad = torch.zeros(*x.shape[:-1], 5, dtype=h.dtype, device=h.device)
        packed3, packed8 = torch.cat([x, h], -1), torch.cat([x, pad, h], -1)
        layouts = {
            "packed 3+C": lambda: G.gather_nodes(packed3, idx)[..., 3:],
            "packed 8+C": lambda: G.gather_nodes(packed8, idx)[..., 8:],
            "h alone": lambda: G.gather_nodes(h, idx)}
        ms = device_ms(lambda: G.gather_nodes(x, idx))
        print(f"gather x alone [{E} edges, 3 wide]: {ms:.4f} ms [{line}]")
        for lname, gather in layouts.items():
            ms = device_ms(gather)
            src = gather()
            print(f"gather {lname} [{E} edges, row stride {src.stride(-2)}, "
                  f"features at element {src.storage_offset()}]: "
                  f"{ms:.4f} ms [{line}]")
            for wname, wt in weights.items():
                gemm_line(f"2 served {lname}, {wname}", src, wt, line)
        egcl_ms = device_ms(lambda: egcl(h, x, ctx, gi), iters=20)
        print(f"one docking EGCL forward (this checkout): {egcl_ms:.4f} ms "
              f"device [{line}]")
        batch_ms = host_ms(lambda: engine.model.inference_diag(
            batch, shapes=cfg.shapes))
        print(f"one FABind+ bf16 model batch (this checkout): median "
              f"{batch_ms:.2f} ms [{line}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
