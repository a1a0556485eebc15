"""The weight bridge: flax parameter trees -> port state dicts that load with
strict=True, for both released model families and the FABind+ confidence
heads."""
import jax
import numpy as np
import pytest
import torch

from common import TINY

from fabind_tpu.config import preset as jax_preset
from fabind_tpu.data.types import dummy_batch as jax_dummy_batch
from fabind_tpu.models.fabind import make_model as jax_make_model
from fabind_tpu.train.convert import export_torch_state_dict

from fabind_tpu_torch.config import preset
from fabind_tpu_torch.models.fabind import make_model
from fabind_tpu_torch.train.convert import (load_torch_checkpoint,
                                            state_dict_from_flax)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's torch work: its tensors are
    toy-sized, and the suite runs in parallel workers that would otherwise
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flax_params(name):
    """A flax parameter tree of the right shapes, filled from a seed (the
    init is only traced, never compiled)."""
    cfg = jax_preset(name, **dict(TINY, mean_layers=2))
    batch = jax_dummy_batch(cfg.shapes, batch_size=1, n_lig_valid=8,
                            n_prot_valid=30)
    k = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda: jax_make_model(cfg).init(
        {"params": k, "dropout": k, "sample": k}, batch, train=False,
        stage=2))["params"]
    rng = np.random.RandomState(0)
    return jax.tree_util.tree_map(
        lambda s: rng.randn(*s.shape).astype(np.float32), shapes)


@pytest.mark.parametrize("name", ["fabind", "fabind_plus",
                                  "fabind_plus_sampling"])
def test_flax_params_load_strict(name):
    params = _flax_params(name)
    is_plus = name != "fabind"
    sd = state_dict_from_flax(params, is_plus=is_plus)
    model = make_model(preset(name, **dict(TINY, mean_layers=2)))
    result = model.load_state_dict(sd, strict=True)
    assert not result.missing_keys and not result.unexpected_keys
    # the port's copy of the mapping names every tensor as the JAX
    # package's exporter does, with the same values
    ref = export_torch_state_dict(params, is_plus=is_plus)
    assert set(sd) == set(ref) == set(model.state_dict())
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(ref[k]))


def test_load_torch_checkpoint_strips_ddp_prefix(tmp_path):
    sd = {"module.glb_c": torch.ones(1, 4), "module.layernorm.weight":
          torch.arange(4.0)}
    path = tmp_path / "ckpt.bin"
    torch.save(sd, path)
    got = load_torch_checkpoint(str(path))
    assert set(got) == {"glb_c", "layernorm.weight"}
    torch.testing.assert_close(got["layernorm.weight"], torch.arange(4.0))
