"""The whole model for the ablation and extra configurations of the port
against the JAX package on the CPU: FABind.inference_diag (pocket stage,
crop, docking) for triangle attention, the no-attention stack with the
cross attention and the outer-product pair embedding (FABind+ in
test_torch_ablation_plus.py), and the recycle loop with a tensor count
(the traced form) equal to the Python loop.

Same inputs (numpy, seeded) and the same weights (the JAX package's init,
carried across by state_dict_from_flax) in fp32 at hidden 16, one docking
layer (test_torch_ablation.py runs the stacks at two), 2 recycles,
dropout 0; each JAX side is one jitted function (its init and
its forward). Coordinates within 2e-4 (keep_trig_attn 5e-4, as
tests/test_ablation.py holds the JAX package to the reference).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_serve import make_raw
from test_torch_ablation import (FLAGS, TINY_FULL, TRIG_X_ATOL, X_ATOL,
                                 _close, _np_tree)

from fabind_tpu.config import preset as jax_preset
from fabind_tpu.data.types import FABindBatch as JaxBatch
from fabind_tpu.models.fabind import make_model as jax_make_model

from fabind_tpu_torch.aot import export_inference
from fabind_tpu_torch.config import preset
from fabind_tpu_torch.data.types import FABindBatch, dummy_arrays
from fabind_tpu_torch.models.fabind import init_params, make_model
from fabind_tpu_torch.serve import DockingEngine
from fabind_tpu_torch.train.convert import state_dict_from_flax

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's torch work: its tensors are
    toy-sized, and the suite runs in parallel workers that would otherwise
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


INFERENCE_FLAGS = ("keep_trig_attn", "ablation_no_attention_with_cross_attn",
                   "opm")


@pytest.mark.parametrize("flag", INFERENCE_FLAGS)
def test_inference_diag_matches_jax(flag):
    check_inference_diag("fabind", flag)


def check_inference_diag(variant, flag):
    """FABind.inference_diag of `variant` with `flag` against the JAX
    package's: poses, confidence and pocket overflow."""
    kw = dict(TINY_FULL, **FLAGS[flag])
    cfg, jcfg = preset(variant, **kw), jax_preset(variant, **kw)
    arrays = dummy_arrays(cfg.shapes, batch_size=2, seed=1, n_lig_valid=6,
                          n_prot_valid=20)
    jb = JaxBatch(**{k: jnp.asarray(v) for k, v in arrays.items()})
    jm = jax_make_model(jcfg)

    def run():
        k = jax.random.PRNGKey(0)
        return jm.init_with_output({"params": k, "dropout": k, "sample": k},
                                   jb, method="inference_diag")

    (coords, conf, overflow), variables = jax.jit(run)()
    model = make_model(cfg)
    model.load_state_dict(state_dict_from_flax(
        _np_tree(variables["params"]), is_plus=cfg.model.is_plus),
        strict=True)
    with torch.inference_mode():
        got = model.eval().inference_diag(FABindBatch.from_numpy(arrays,
                                                                 "cpu"))
    atol = TRIG_X_ATOL if flag == "keep_trig_attn" else X_ATOL
    _close(got[0], coords, atol)
    _close(got[1], conf, atol)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(overflow))


@pytest.mark.parametrize("flag", ["keep_trig_attn", "implicit_pair",
                                  "ablation_no_attention_with_cross_attn"])
def test_tensor_recycle_count_equals_the_python_loop(flag):
    """A recycle count given as a tensor runs the rounds as one while_loop
    whose inputs are the tensors the config has (the distance embeddings,
    or no pair at all): the poses of the Python loop, bit for bit."""
    cfg = preset("fabind", **dict(TINY_FULL, n_iter=3, **FLAGS[flag]))
    model = make_model(cfg)
    init_params(model, torch.Generator().manual_seed(1))
    batch = FABindBatch.from_numpy(dummy_arrays(
        cfg.shapes, batch_size=2, seed=3, n_lig_valid=6, n_prot_valid=20),
        "cpu")
    with torch.inference_mode():
        live = model.eval().inference_diag(batch, count=3)
        traced = model.inference_diag(batch, count=torch.tensor(3))
    torch.testing.assert_close(traced[0], live[0], rtol=0, atol=0)


@pytest.mark.parametrize("flag", ["ablation_no_attention_with_cross_attn",
                                  "keep_trig_attn"])
def test_export_round_trip_equals_live(flag, tmp_path):
    """torch.export of the inference program on the CPU (fp32, one toy
    bucket): the artifact's poses equal the live engine's."""
    cfg = preset("fabind", **dict(TINY_FULL, **FLAGS[flag]))
    model = make_model(cfg)
    init_params(model, torch.Generator().manual_seed(2))
    sd = model.state_dict()
    out = str(tmp_path / "art")
    export_inference(cfg, sd, out, batch_size=2, bf16=False, device="cpu")
    raws = [make_raw(n=5, nr=20, seed=1), make_raw(n=7, nr=18, seed=2),
            make_raw(n=6, nr=24, seed=3)]
    live = DockingEngine(cfg, state_dict=sd, batch_size=2, bf16=False,
                         device="cpu").dock_raw(raws)
    exported = DockingEngine.from_exported(out, device="cpu").dock_raw(raws)
    for a, b in zip(live, exported):
        assert a.error is None and b.error is None
        np.testing.assert_array_equal(a.coords, b.coords)
