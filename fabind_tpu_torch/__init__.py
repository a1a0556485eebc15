"""fabind_tpu_torch: FABind docking in PyTorch, with hand-written CUDA kernels
for NVIDIA Hopper.

The port mirrors the module layout of the JAX package `fabind_tpu` (which
stays the reference) and imports nothing from it. Entry points:
`fabind_tpu_torch.serve.DockingEngine` (serving) and
`python -m fabind_tpu_torch.cli.train` (training, `train.trainer.Trainer`).
"""
from fabind_tpu_torch.config import FABindConfig, preset

__all__ = ["FABindConfig", "preset"]
