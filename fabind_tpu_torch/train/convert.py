"""Weight bridge: flax parameter trees and torch checkpoints -> port state
dicts.

The port's modules carry the torch reference's names, so a released `.bin`
loads as it is, and a flax parameter tree of the JAX package maps by a
mechanical rename + transpose (an own copy of the mapping in
fabind_tpu/train/convert.py export_torch_state_dict):

- flax Dense kernel [in, out]      -> torch Linear weight [out, in]
- flax LayerNorm scale/bias        -> torch LayerNorm weight/bias
- base MLPBlock linear1/linear2    -> Sequential children 0/2 under the
                                      edge/node/coord/att/distmap MLPs
- linear_kv_kernel/_bias           -> linear_kv weight/bias
- RBF mlp_0/mlp_3                  -> mlp.0/mlp.3

The ablation modules (triangle attention, the RBF distance layers, the
no-attention stacks' EGCLs, the outer-product InteractionModule) follow the
same rules. A reference checkpoint of an ablation also holds keys of modules
its forward never runs (DEAD_REFERENCE_KEYS), which loading skips.
"""
from __future__ import annotations

import re
from typing import Any, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

# base-FABind modules that are nn.Sequential in torch (children named 0/2)
_SEQUENTIAL_PARENTS = ("edge_mlp", "node_mlp", "coord_mlp", "att_mlp",
                       "distmap_mlp")


def _flatten(tree, prefix=()) -> List[Tuple[Tuple[str, ...], Any]]:
    if hasattr(tree, "items"):
        return [item for k, v in tree.items()
                for item in _flatten(v, prefix + (str(k),))]
    return [(prefix, tree)]


def state_dict_from_flax(flax_params: Dict[str, Any],
                         is_plus: bool) -> Dict[str, torch.Tensor]:
    """A flax parameter tree (nested dicts of numpy arrays) -> a port state
    dict that loads with `load_state_dict(strict=True)`. is_plus keeps the
    FABind+ MLPs' linear1/linear2 names."""
    sd = {}
    seq = {"linear1": "0", "linear2": "2"}
    for path, arr in _flatten(flax_params):
        arr = np.asarray(arr, np.float32)
        parts = list(path)
        if not is_plus:
            parts = [seq[c] if c in seq and i > 0
                     and parts[i - 1] in _SEQUENTIAL_PARENTS else c
                     for i, c in enumerate(parts)]
        parts = [c2 for c in parts
                 for c2 in (("mlp", c[4:]) if c in ("mlp_0", "mlp_3") else (c,))]
        leaf = parts[-1]
        if leaf == "linear_kv_kernel":
            key, arr = ".".join(parts[:-1] + ["linear_kv", "weight"]), arr.T
        elif leaf == "linear_kv_bias":
            key = ".".join(parts[:-1] + ["linear_kv", "bias"])
        elif leaf == "kernel":
            key = ".".join(parts[:-1] + ["weight"])
            arr = arr.T if arr.ndim == 2 else arr
        elif leaf == "scale":
            key = ".".join(parts[:-1] + ["weight"])
        else:
            key = ".".join(parts)
        sd[key] = torch.tensor(arr)
    return sd


# keys the reference's ablation modules create but never run: the
# interfacial layers' own InteractionModule when the cross attention layer is
# on, the column triangle block (the row block serves both orientations) and
# the RBF centers' buffer (GaussianSmearing computes them)
DEAD_REFERENCE_KEYS = (".inter_layer.", ".triangle_block_column.",
                       ".rbf.offset")


def drop_dead_keys(sd: Dict[str, torch.Tensor], want: Iterable[str]
                   ) -> Dict[str, torch.Tensor]:
    """`sd` without the reference's dead keys (DEAD_REFERENCE_KEYS) that
    the model's state dict keys `want` lack; every other key stays, so a
    strict load still refuses a checkpoint that does not fit."""
    want = set(want)
    return {k: v for k, v in sd.items()
            if k in want or not any(d in k for d in DEAD_REFERENCE_KEYS)}


def load_torch_checkpoint(path: str, model: Optional[torch.nn.Module] = None
                          ) -> Dict[str, torch.Tensor]:
    """A released FABind checkpoint (`best_model.bin` and the others) -> a
    state dict with the DDP `module.` prefix stripped; given the `model`
    it is for, without the reference's dead keys that the model lacks
    (drop_dead_keys)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if "state_dict" in sd:
        sd = sd["state_dict"]
    sd = {re.sub(r"^module\.", "", k): v for k, v in sd.items()}
    return sd if model is None else drop_dead_keys(sd, model.state_dict())


# ------------------------------------------------------------------- ESM2
# keys of a HuggingFace ESM checkpoint that the encoder does not use: the
# pooler, the contact and masked-LM heads, and buffers the port recomputes
_ESM_LEFTOVERS = ("pooler.", "contact_head.", "lm_head.", "inv_freq",
                  "position_ids")

# flax Esm2Layer child -> HuggingFace EsmLayer path
_ESM_LAYER_NAMES = {
    "attn_ln": "attention.LayerNorm", "query": "attention.self.query",
    "key": "attention.self.key", "value": "attention.self.value",
    "attn_out": "attention.output.dense", "ffn_ln": "LayerNorm",
    "intermediate": "intermediate.dense", "ffn_out": "output.dense"}


def esm_state_dict_from_flax(params: Dict[str, Any]
                             ) -> Dict[str, torch.Tensor]:
    """The JAX package's Esm2Model parameter tree -> HuggingFace EsmModel
    names (Dense kernels transposed, LayerNorm scale -> weight), the names
    `models.esm2.Esm2Model` carries."""
    sd = {}
    for path, arr in _flatten(params):
        arr = np.asarray(arr, np.float32)
        *mods, leaf = path
        if mods == ["word_embeddings"]:
            key = "embeddings.word_embeddings.weight"
        elif mods == ["emb_layer_norm_after"]:
            key = "encoder.emb_layer_norm_after." + (
                "weight" if leaf == "scale" else leaf)
        else:
            layer, child = mods
            name = "weight" if leaf in ("kernel", "scale") else leaf
            key = (f"encoder.layer.{layer[len('layer_'):]}."
                   f"{_ESM_LAYER_NAMES[child]}.{name}")
            arr = arr.T if leaf == "kernel" else arr
        sd[key] = torch.tensor(arr)
    return sd


def load_esm_state_dict(module: torch.nn.Module,
                        torch_sd: Dict[str, torch.Tensor]) -> List[str]:
    """Load a HuggingFace ESM state dict (`EsmModel`, or `esm.`-prefixed as
    in `EsmForMaskedLM`) into an Esm2Model; returns the keys it did not use
    (pooler, contact and LM heads, rotary `inv_freq`, `position_ids`). Any
    other unused key, a missing one or a shape mismatch raises."""
    sd = {k[4:] if k.startswith("esm.") else k: v
          for k, v in torch_sd.items()}
    want = module.state_dict()
    unused = sorted(k for k in sd if k not in want)
    bad = [k for k in unused if not any(s in k for s in _ESM_LEFTOVERS)]
    if bad:
        raise ValueError(f"ESM state dict has {len(bad)} keys the encoder "
                         f"does not know: {bad[:5]}")
    module.load_state_dict({k: v for k, v in sd.items() if k in want},
                           strict=True)
    return unused
