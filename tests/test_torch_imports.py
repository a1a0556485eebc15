"""The port stands alone: it imports neither JAX nor the JAX package (nor
scikit-learn, which the card's machine lacks), and it never falls back to
the CPU on its own."""
import json
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import fabind_tpu_torch
from fabind_tpu_torch.config import preset
from fabind_tpu_torch.serve import DockingEngine

REPO = Path(__file__).resolve().parents[1]


def test_port_and_chip_smoke_import_no_jax():
    modules = sorted(m.name for m in pkgutil.walk_packages(
        fabind_tpu_torch.__path__, "fabind_tpu_torch."))
    for m in ("ops.edge_gate", "utils.precision", "data.buckets", "postopt",
              "serve_http", "cli.serve", "sample"):
        assert f"fabind_tpu_torch.{m}" in modules
    code = (
        "import importlib, json, sys\n"
        f"for m in {modules!r} + ['chip_smoke']:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'fabind_tpu', 'sklearn'))\n"
        "print(json.dumps(bad))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_engine_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = preset("fabind", max_ligand=8, max_pocket=16, max_protein=32,
                 hidden_size=16, pocket_pred_hidden_size=16, mean_layers=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DockingEngine(cfg)
    assert DockingEngine(cfg, device="cpu").device.type == "cpu"
