"""The bf16 deployment cast.

Counterpart of fabind_tpu/utils/precision.py `cast_tree_bf16`: every float32
parameter and buffer of a module, and every float32 field of a batch, becomes
bfloat16; int, bool and other float dtypes stay as they are. It is a whole
cast, not `torch.autocast` (which keeps some ops in float32 and so computes
another function than the JAX package's bf16 program). Casting the weights
alone would be a silent no-op: float32 inputs promote every product back.

float32 -> bfloat16 rounds to nearest even in both frameworks, so flax
parameters converted in float32 (`train.convert.state_dict_from_flax`) and
cast here equal the JAX package's bf16 parameters bit for bit.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from fabind_tpu_torch.data.types import FABindBatch


def cast_tensor_bf16(t: torch.Tensor) -> torch.Tensor:
    """t in bfloat16 if it is float32, else t."""
    return t.to(torch.bfloat16) if t.dtype == torch.float32 else t


def cast_module_bf16(module: nn.Module) -> nn.Module:
    """Cast the module's float32 parameters and buffers to bfloat16 in
    place (`nn.Module.to` would cast every floating dtype); returns it."""
    return module._apply(cast_tensor_bf16)


def cast_batch_bf16(batch: FABindBatch) -> FABindBatch:
    """The batch with its float32 fields in bfloat16."""
    return dataclasses.replace(batch, **{
        f.name: cast_tensor_bf16(getattr(batch, f.name))
        for f in dataclasses.fields(batch)
        if isinstance(getattr(batch, f.name), torch.Tensor)})
