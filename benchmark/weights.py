"""Seeded weights for both sides: one float32 state dict made on the device
from `--seed`, in one draw.

The scales are the port's `init_params` (fabind_tpu_torch/models/fabind.py
:453), copied: every Linear weight and bias uniform in +-1/sqrt(fan_in), the
coordinate heads' output layers (a `coord_mlp` Linear with one output)
scaled by 1e-3, LayerNorms at identity, the global tokens at one. The names
and shapes come from the reference model built on the meta device, so
nothing of the program is read.
"""
from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from benchmark.reference.models.fabind import make_model


def seeded_state_dict(cfg, seed: int, device, coord_scale: float = 1e-3
                      ) -> Dict[str, torch.Tensor]:
    """{name: float32 tensor on `device`} for the model of `cfg` (a
    reference FABindConfig); `coord_scale` multiplies the coordinate
    heads' output layers."""
    with torch.device("meta"):
        model = make_model(cfg)
    sd = model.state_dict()
    uniform = []      # (name, scale) of every tensor drawn from the flat draw
    out: Dict[str, torch.Tensor] = {}
    for name, mod in model.named_modules():
        pre = f"{name}." if name else ""
        if isinstance(mod, nn.Linear):
            a = mod.in_features ** -0.5
            w_scale = a * (coord_scale if name.split(".")[-2:-1] == ["coord_mlp"]
                           and mod.out_features == 1 else 1.0)
            uniform.append((pre + "weight", w_scale))
            if mod.bias is not None:
                uniform.append((pre + "bias", a))
        elif isinstance(mod, nn.LayerNorm):
            out[pre + "weight"] = torch.ones(sd[pre + "weight"].shape,
                                             device=device)
            out[pre + "bias"] = torch.zeros(sd[pre + "bias"].shape,
                                            device=device)
    for name in ("glb_c", "glb_p"):
        out[name] = torch.ones(sd[name].shape, device=device)
    total = sum(sd[n].numel() for n, _ in uniform)
    g = torch.Generator(device=device).manual_seed(seed % 2**63)
    flat = torch.rand(total, generator=g, device=device) * 2 - 1
    start = 0
    for name, s in uniform:
        n = sd[name].numel()
        out[name] = (flat[start:start + n] * s).view(sd[name].shape)
        start += n
    missing = set(sd) - set(out)
    if missing:
        raise KeyError(f"no initialisation rule for {sorted(missing)[:5]}")
    return {k: out[k] for k in sd}
