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
              "serve_http", "cli.serve", "sample", "train.losses",
              "train.schedule", "train.trainer", "train.checkpoints",
              "data.torsion", "data.dataset", "utils.metrics",
              "utils.logging_utils", "cli.train", "cli.common",
              "cli.evaluate", "cli.sample", "cli.train_confidence",
              "train.confidence"):
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


def test_train_cli_without_cuda_raises(monkeypatch, tmp_path):
    from fabind_tpu_torch.cli import train as cli_train
    from fabind_tpu_torch.train.trainer import Trainer
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli_train.main(["--data", str(tmp_path), "--output",
                        str(tmp_path / "run")])
    cfg = preset("fabind", max_ligand=8, max_pocket=16, max_protein=32,
                 hidden_size=16, pocket_pred_hidden_size=16, mean_layers=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(cfg)
    assert Trainer(cfg, "cpu").device.type == "cpu"


@pytest.mark.parametrize("cli", ["evaluate", "sample", "train_confidence"])
def test_new_clis_without_cuda_raise(monkeypatch, tmp_path, cli):
    """Without --device cpu the CLIs run on CUDA, and raise without it
    (before reading anything)."""
    import importlib
    mod = importlib.import_module(f"fabind_tpu_torch.cli.{cli}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--data", str(tmp_path)]
    if cli != "train_confidence":
        argv += ["--ckpt", str(tmp_path / "none.bin")]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mod.main(argv)
