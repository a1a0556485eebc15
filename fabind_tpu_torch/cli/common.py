"""What the port's command-line entry points share: the device they run
on and the model they load."""
from __future__ import annotations

from typing import Optional

import torch

from fabind_tpu_torch.config import FABindConfig
from fabind_tpu_torch.models.fabind import FABind, init_params, make_model
from fabind_tpu_torch.train.checkpoints import load_into, load_weights


def resolve_device(name: Optional[str], who: str) -> torch.device:
    """The torch device `name` (default cuda). Without CUDA, cuda raises:
    the entry points run on the CPU only when asked. On the card, float32
    products run in full precision (no TF32), as the JAX package's do."""
    device = torch.device(name or "cuda")
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"{who}: CUDA is not available; pass "
                               f"--device cpu to run on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return device


def load_model(cfg: FABindConfig, ckpt: Optional[str], device,
               seed: int = 0) -> FABind:
    """The float32 model of `cfg` in eval mode on `device`: seeded random
    weights (`seed`), then the checkpoint `ckpt` (any file
    `checkpoints.load_weights` reads) over them, where a confidence head the
    checkpoint lacks keeps its fresh init."""
    model = make_model(cfg)
    init_params(model, torch.Generator().manual_seed(seed))
    if ckpt:
        missing = load_into(model, load_weights(ckpt))
        print(f"loaded {ckpt}" + (f"; {len(missing)} confidence-head "
                                  f"tensors not in it keep their fresh init"
                                  if missing else ""))
    return model.to(device).eval()
