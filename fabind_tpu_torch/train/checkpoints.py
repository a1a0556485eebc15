"""Training checkpoints.

Counterpart of fabind_tpu/train/checkpoints.py `TrainCheckpointer` (the
JAX package writes orbax; this writes torch.save files and does not read
orbax checkpoints):
- saves run in a background thread from the CPU copies that
  `Trainer.state_dict()` returns, so training goes on while the file is
  written;
- one bare-integer directory per step under the checkpoint root, holding
  `state.pt` (model, optimizer, step) and `meta.json` (the data-order
  position: epoch, batch_in_epoch); the newest `max_to_keep` are kept;
- a step directory appears only once complete (written under a temporary
  name, then renamed), so a run killed mid-save restores the step before.

`save_params` / `load_params` write and read a bare model state dict;
`load_weights` reads any of the files the CLIs take, and `load_into`
loads them into a model, leaving a missing confidence head at its fresh
init as the JAX package's `overlay` does.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Dict, List, Optional, Tuple

import torch

from fabind_tpu_torch.train.convert import drop_dead_keys
from fabind_tpu_torch.train.trainer import to_cpu


class TrainCheckpointer:
    """Async, retained checkpoints of `Trainer.state_dict()` with a JSON
    meta (see module docstring)."""

    def __init__(self, ckpt_dir: str, max_to_keep: int = 3):
        self.root = os.path.abspath(ckpt_dir)
        self.max_to_keep = max_to_keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        os.makedirs(self.root, exist_ok=True)

    def steps(self):
        return sorted(int(d) for d in os.listdir(self.root) if d.isdigit())

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, state: Dict, meta: Optional[dict] = None,
             step: Optional[int] = None) -> None:
        """Write `state` (a Trainer.state_dict(): CPU copies, which the
        background write reads while training goes on) at `step` (default
        state["step"])."""
        self.wait()
        step = int(state["step"] if step is None else step)
        self._thread = threading.Thread(
            target=self._write, args=(state, dict(meta or {}), step),
            daemon=True, name="fabind-ckpt")
        self._thread.start()

    def _write(self, host: Dict, meta: dict, step: int) -> None:
        try:
            tmp = os.path.join(self.root, f".tmp-{step}")
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            torch.save(host, os.path.join(tmp, "state.pt"))
            with open(os.path.join(tmp, "meta.json"), "w") as f:
                json.dump(meta, f)
            final = os.path.join(self.root, str(step))
            shutil.rmtree(final, ignore_errors=True)
            os.rename(tmp, final)
            if self.max_to_keep and self.max_to_keep > 0:
                for old in self.steps()[:-self.max_to_keep]:
                    shutil.rmtree(os.path.join(self.root, str(old)),
                                  ignore_errors=True)
        except Exception as e:           # re-raised by wait()
            self._error = e

    def wait(self) -> None:
        """Block until the save in flight is on disk; re-raise its error."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def restore(self, step: Optional[int] = None
                ) -> Optional[Tuple[Dict, dict]]:
        """(state, meta) of `step` (default the latest), or None when there
        is no checkpoint."""
        self.wait()
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        d = os.path.join(self.root, str(step))
        state = torch.load(os.path.join(d, "state.pt"), map_location="cpu",
                           weights_only=True)
        with open(os.path.join(d, "meta.json")) as f:
            meta = json.load(f)
        return state, meta

    def close(self) -> None:
        self.wait()


def save_params(path: str, model_state: Dict[str, torch.Tensor]) -> str:
    """A model state dict to one file."""
    torch.save(to_cpu(model_state), path)
    return path


def load_params(path: str) -> Dict[str, torch.Tensor]:
    """A model state dict from `save_params`'s file, or the model of a
    training run's checkpoint directory (its latest step)."""
    if os.path.isdir(path):
        restored = TrainCheckpointer(path).restore()
        if restored is None:
            raise FileNotFoundError(f"{path}: no checkpoint")
        return restored[0]["model"]
    return torch.load(path, map_location="cpu", weights_only=True)


# parameters a checkpoint may lack: the FABind+ confidence head, trained
# after the regression model (the JAX package's confidence_param_labels)
HEAD_PREFIXES = ("ranking", "confidence")


def load_weights(path: str) -> Dict[str, torch.Tensor]:
    """A model state dict from a released-format `.bin`/`.pt` checkpoint
    (`convert.load_torch_checkpoint`), a `save_params` file, a
    `TrainCheckpointer` directory, or a `cli.train` run directory (its
    `ckpt/`)."""
    if path.endswith((".bin", ".pt")):
        from fabind_tpu_torch.train.convert import load_torch_checkpoint
        return load_torch_checkpoint(path)
    if os.path.isdir(os.path.join(path, "ckpt")):
        path = os.path.join(path, "ckpt")
    return load_params(path)


def load_into(model: torch.nn.Module, state_dict: Dict[str, torch.Tensor]
              ) -> List[str]:
    """Load `state_dict` into `model`; parameters of the confidence head
    (HEAD_PREFIXES) that the checkpoint lacks keep the model's values, and
    the reference's keys of modules an ablation never runs are dropped
    (convert.drop_dead_keys). Returns the missing keys. A missing key
    outside the head, another unused key or a shape mismatch raises: a
    wrong checkpoint must not load."""
    want = model.state_dict()
    state_dict = drop_dead_keys(state_dict, want)
    missing = sorted(k for k in want if k not in state_dict)
    unused = sorted(k for k in state_dict if k not in want)
    bad = [k for k in missing if not k.startswith(HEAD_PREFIXES)]
    if bad or unused:
        raise ValueError(f"checkpoint does not fit the model: {len(bad)} "
                         f"missing keys outside the confidence head "
                         f"{bad[:5]}, {len(unused)} unused keys "
                         f"{unused[:5]}")
    model.load_state_dict(state_dict, strict=False)
    return missing
