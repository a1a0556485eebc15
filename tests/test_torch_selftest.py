"""The port's deployment self-test (fabind_tpu_torch.cli.selftest) passes on
the CPU with --device cpu, mirroring tests/test_selftest.py (without CUDA
and without --device cpu it raises: tests/test_torch_imports.py)."""
import json

import pytest
import torch

from fabind_tpu_torch.cli import selftest


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's torch work: its tensors are
    toy-sized, and the suite runs in parallel workers that would otherwise
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _lines(capsys):
    return [json.loads(l) for l in capsys.readouterr().out.splitlines()]


@pytest.mark.parametrize("bf16", [False, True])
def test_selftest_inference(capsys, bf16):
    assert selftest.main(["--device", "cpu"] + ["--bf16"] * bf16) == 0
    lines = _lines(capsys)
    checks = {l["check"]: l for l in lines if "check" in l}
    assert checks["devices"]["ok"] and checks["devices"]["n"] >= 1
    assert checks["devices"]["backend"] == "cpu"
    tiny = checks["inference_tiny"]
    assert tiny["ok"] and tiny["coords_shape"] == [2, 8, 3]
    assert tiny["dtype"] == ("bf16" if bf16 else "fp32")
    assert tiny["gate_launches"] == 0          # the CPU takes the plain gate
    assert lines[-1] == {"selftest": "ok"}


def test_selftest_train_step(capsys):
    assert selftest.main(["--device", "cpu", "--train"]) == 0
    lines = _lines(capsys)
    checks = {l["check"]: l for l in lines if "check" in l}
    assert checks["train_step"]["grad_norm"] > 0
    assert lines[-1] == {"selftest": "ok"}


def test_gate_launches_per_forward():
    from fabind_tpu_torch.config import preset
    assert selftest.gate_launches_per_forward(preset("fabind")) == 33
    assert selftest.gate_launches_per_forward(preset("fabind_plus")) == 0
