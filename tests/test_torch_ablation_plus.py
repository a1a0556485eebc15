"""FABind+ (preset `fabind_plus`) inference_diag for the ablation and extra
configurations that the JAX package builds in that family, against JAX's
on the CPU (test_torch_ablation_model.py has the method and the `fabind`
cases)."""
from __future__ import annotations

import pytest
import torch

from test_torch_ablation_model import INFERENCE_FLAGS, check_inference_diag


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's torch work: its tensors are
    toy-sized, and the suite runs in parallel workers that would otherwise
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("flag", INFERENCE_FLAGS)
def test_plus_inference_diag_matches_jax(flag):
    check_inference_diag("fabind_plus", flag)
