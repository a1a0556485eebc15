"""Data-parallel training on the CPU: two gloo ranks (parallel.dp.launch,
spawned processes in a file-store process group) against one process.

- Two ranks on the global batch equal the one-process Trainer: dropout 0.1
  with drawn recycle counts (the row-mapped masks, the global draws, the
  global stage gate), gradient accumulation over 4 micro-batches, and the
  stage-2 crop every step; parameters within 2e-6 after two AdamW updates,
  metrics equal on both ranks.
- At dropout 0 with the gumbel uniforms given, two ranks equal JAX's
  make_sharded_train_step on a two-device CPU mesh, within
  test_torch_train_loop.py's tolerances.
- `cli.train --device cpu --dp 2`: one metrics.jsonl and checkpoints from
  rank 0 only; a SIGTERM stops both ranks after the same step; --resume
  ends with the unbroken run's parameters.

Every launch has a 60 s process-group timeout and a join limit, so a dead
rank fails its test instead of hanging the run. One spawn serves the
first four tests (parallel.steps.train_jobs); each spawn costs ~8 s of
process start-up.
"""
from __future__ import annotations

import functools
import os
import signal
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from common import TINY_XS
from test_data import make_raw
from test_torch_train_loop import CLI_SETS

import fabind_tpu.ops.gumbel as jax_gumbel
from fabind_tpu.config import preset as jax_preset
from fabind_tpu.data.types import FABindBatch as JaxBatch
from fabind_tpu.parallel.mesh import make_mesh, replicate, shard_batch
from fabind_tpu.train.trainer import (create_train_state,
                                      make_sharded_train_step)

from fabind_tpu_torch.cli import train as cli_train
from fabind_tpu_torch.config import preset
from fabind_tpu_torch.data.types import FABindBatch, dummy_arrays
from fabind_tpu_torch.parallel.dp import launch
from fabind_tpu_torch.parallel.steps import train_jobs
from fabind_tpu_torch.train.checkpoints import TrainCheckpointer
from fabind_tpu_torch.train.convert import state_dict_from_flax
from fabind_tpu_torch.train.trainer import Trainer

PARAM_ATOL = 2e-6
GROUP_TIMEOUT = 60
JOIN_S = 240
CASES = {"dropout": dict(dropout=0.1),
         "accumulate": dict(dropout=0.1, gradient_accumulate_step=2),
         "stage2": dict(dropout=0.1, stage_prob=1.0,
                        center_dist_threshold=1e9)}
JAX_KW = dict(TINY_XS, dropout=0.0, random_n_iter=False, stage_prob=0.0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _arrays(cfg, n):
    return [dummy_arrays(cfg.shapes, batch_size=4, seed=s, n_lig_valid=6,
                         n_prot_valid=24) for s in range(n)]


def _gumbel(cfg, n):
    """The same uniforms for every step: the jitted JAX step bakes its
    patched draw in when it traces, once."""
    u = np.random.RandomState(1).uniform(
        1e-6, 1.0, (4, cfg.shapes.max_protein, 2)).astype(np.float32)
    return [u] * n


@pytest.fixture(scope="module")
def jax_run():
    """JAX's sharded step on a 2-device mesh: its initial and final
    parameters (port names) and metrics over two global batches of 4."""
    jcfg = jax_preset("fabind", **JAX_KW)
    arrays = _arrays(preset("fabind", **JAX_KW), 2)
    us = _gumbel(jcfg, 2)
    jb = [JaxBatch(**{k: jnp.asarray(v) for k, v in a.items()})
          for a in arrays]

    def gumbel_softmax(logits, key, tau=1.0, hard=False, axis=-1):
        g = -jnp.log(-jnp.log(jnp.asarray(us[0])))
        return jax.nn.softmax((logits + g) / tau, axis=axis)

    orig = jax_gumbel.gumbel_softmax
    jax_gumbel.gumbel_softmax = gumbel_softmax
    try:
        model, state = create_train_state(jcfg, jax.random.PRNGKey(0), jb[0])
        sd0 = state_dict_from_flax(jax.tree_util.tree_map(
            np.asarray, state.params), is_plus=False)
        mesh = make_mesh(2)
        state = replicate(state, mesh)
        step = make_sharded_train_step(model, jcfg, mesh)
        metrics = []
        for b in jb:
            state, m = step(state, shard_batch(b, mesh))
            metrics.append({k: float(v) for k, v in m.items()})
    finally:
        jax_gumbel.gumbel_softmax = orig
    want = state_dict_from_flax(jax.tree_util.tree_map(
        np.asarray, state.params), is_plus=False)
    return sd0, want, metrics, arrays, us


@pytest.fixture(scope="module")
def ranks(jax_run):
    """One launch of two gloo ranks: every CASES job, then the JAX-parity
    job (dropout 0, JAX's initial weights and uniforms)."""
    jobs = []
    for kw in CASES.values():
        cfg = preset("fabind", **dict(TINY_XS, **kw))
        jobs.append((cfg, _arrays(cfg, 2 * cfg.train.gradient_accumulate_step),
                     None, None))
    sd0, _, _, arrays, us = jax_run
    jobs.append((preset("fabind", **JAX_KW), arrays, us, sd0))
    return jobs, launch(train_jobs, (jobs,), ["cpu", "cpu"], timeout=JOIN_S,
                        group_timeout=GROUP_TIMEOUT, threads=1)


@pytest.mark.parametrize("case", list(CASES))
def test_dp_train_equals_one_process(ranks, case):
    """Two ranks, each on its strided rows, end where one Trainer on the
    global batches ends (within 2e-6), and report its metrics."""
    jobs, results = ranks
    i = list(CASES).index(case)
    cfg, arrays, _, _ = jobs[i]
    one = Trainer(cfg, "cpu")
    want = [one.train_step(FABindBatch.from_numpy(a, "cpu")) for a in arrays]
    r0, r1 = results[0][i], results[1][i]
    assert r0["metrics"] == r1["metrics"]
    for got, m in zip(r0["metrics"], want):
        assert got["skipped_nan"] == m["skipped_nan"] == 0.0
        assert got["use_stage2"] == m["use_stage2"]
        for k in ("loss", "grad_norm", "rmsd_mean", "com_coord_loss",
                  "pocket_cls_loss", "keep_less_5", "pocket_overflow"):
            assert abs(got[k] - m[k]) <= 1e-5 * max(1.0, abs(m[k])), (k, got,
                                                                      m)
    if case == "stage2":
        assert all(m["use_stage2"] == 1.0 for m in want)
    for n, p in one.model.state_dict().items():
        assert torch.equal(r0["params"][n], r1["params"][n]), n
        d = float((r0["params"][n] - p).abs().max())
        assert d <= PARAM_ATOL, (n, d)


def test_dp_train_equals_jax_sharded_step(ranks, jax_run):
    """At dropout 0 with the uniforms given, two ranks end where JAX's
    sharded step on two CPU devices ends."""
    _, results = ranks
    sd0, want, jmetrics, _, _ = jax_run
    got = results[0][-1]
    for m, jm in zip(got["metrics"], jmetrics):
        assert abs(m["loss"] - jm["loss"]) <= 2e-4
        assert abs(m["grad_norm"] - jm["grad_norm"]) <= 1e-3
    moved = 0.0
    for n, p in got["params"].items():
        assert float((p - torch.as_tensor(want[n])).abs().max()) <= \
            PARAM_ATOL, n
        moved = max(moved, float((p - torch.as_tensor(sd0[n])).abs().max()))
    assert moved > 5e-5


# ------------------------------------------------------------ cli.train
@pytest.fixture(scope="module")
def npz_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("npz")
    for i in range(11):
        n, nr = (6, 26) if i % 3 else (14, 44)
        np.savez(d / f"c{i}.npz", **make_raw(n=n, nr=nr, seed=i))
    return str(d)


def _argv(npz_dir, out, *extra):
    argv = ["--data", npz_dir, "--output", str(out), "--epochs", "2",
            "--batch-size", "2", "--workers", "0", "--prefetch", "0",
            "--buckets", "auto:2", "--device", "cpu", "--dp", "2", *extra]
    for s in CLI_SETS:
        argv += ["--set", s]
    return argv


def _final_params(out):
    state, _ = TrainCheckpointer(str(out / "ckpt")).restore()
    return state["model"]


def test_cli_train_dp_preempted_then_resumed(npz_dir, tmp_path,
                                             monkeypatch):
    """`cli.train --dp 2` (its launch given this module's limits and one
    thread per rank): rank 0 alone writes log.txt, metrics.jsonl and
    ckpt/. Its rank workers under a SIGTERM sent after the first
    checkpoint: both ranks report the same metrics and stop after the same
    step k, and rank 0 checkpoints k. `--resume` then ends with the
    unbroken run's parameters bit for bit."""
    limited = functools.partial(launch, timeout=JOIN_S,
                                group_timeout=GROUP_TIMEOUT, threads=1)
    monkeypatch.setattr(cli_train, "launch", limited)
    assert cli_train.main(_argv(npz_dir, tmp_path / "full")) == 0
    files = set(os.listdir(tmp_path / "full"))
    assert {"ckpt", "log.txt", "metrics.jsonl"} <= files, files
    records = (tmp_path / "full" / "metrics.jsonl").read_text().splitlines()
    assert sum('"phase": "epoch"' in r for r in records) == 2
    # rank 0's records only: one per epoch and per evaluation stage
    assert sum('"phase": "valid_stage1"' in r for r in records) == 2
    n_steps = TrainCheckpointer(str(tmp_path / "full" / "ckpt")).latest_step()
    assert n_steps >= 6

    out = tmp_path / "run"
    first = out / "ckpt" / "1"
    stop = threading.Event()

    def signal_after_first_checkpoint():
        while not stop.is_set():
            if first.is_dir():
                os.kill(os.getpid(), signal.SIGTERM)
                return
            time.sleep(0.01)

    watcher = threading.Thread(target=signal_after_first_checkpoint)
    watcher.start()
    try:
        parts = limited(cli_train.rank_main,
                        (_argv(npz_dir, out, "--save-every-steps", "1"),),
                        ["cpu", "cpu"])
    finally:
        stop.set()
        watcher.join(10)
    k = len(parts[0])
    assert [s["metrics"] for s in parts[0]] == [s["metrics"] for s in parts[1]]
    assert all(s["metrics"]["skipped_nan"] == 0.0 for s in parts[0])
    assert len(parts[1]) == k and 1 <= k < n_steps
    assert TrainCheckpointer(str(out / "ckpt")).latest_step() == k
    assert signal.getsignal(signal.SIGTERM) is signal.SIG_DFL

    assert cli_train.main(_argv(npz_dir, out, "--resume")) == 0
    assert f"resumed at step {k}" in (out / "log.txt").read_text()
    got, want = _final_params(out), _final_params(tmp_path / "full")
    for n, p in want.items():
        assert torch.equal(got[n], p), n
