"""The check that decides `correct`, driven on the CPU at toy widths: the
port's bf16 path passes against the float32 reference, and the float8
control and each fault a cell can have, planted under the timed path, fail.

The faults (for one chip there is no exchange between chips to leave out):
a step that returns its state unchanged (the served poses are the model's
input placement; in training, no update), half of each batch left out
(its first half of rows, or its second half, comes back as zeros; in
training, the step takes the other half only), and an answer altered
where it is produced (one pose's atoms in reverse order; in training, one
leaf's gradient doubled)."""
from __future__ import annotations

import dataclasses
import importlib
import json
import time
from pathlib import Path

import pytest

from benchmark import harness
from benchmark.configs_io import BenchConfig

ROOT = Path(__file__).resolve().parents[1]
TOY = json.loads((ROOT / "tests" / "data" / "toy.json").read_text())
CASES = {"toy_batch": "toy_fabind", "toy_train": "toy_fabind_fp32"}
SEED = 2**31 + 99


def _fault(kind, coords, batch):
    c = coords.clone()
    if kind == "unchanged":
        return (batch.lig_coords_init.to(c.dtype)
                * batch.lig_mask[..., None].to(c.dtype))
    if kind == "half":
        c[:c.shape[0] // 2] = 0
    elif kind == "half_back":
        c[c.shape[0] // 2:] = 0
    elif kind == "altered":
        n = int(batch.lig_mask[0].sum())
        c[0, :n] = c[0, :n].flip(0)
    return c


def _train_hook(kind):
    """Plant the fault in the training step: no update (its state
    unchanged), a step on the first half of each batch only (the mean taken
    over the rest), or one leaf's gradient doubled before the update."""
    def plant(trainer):
        if kind == "unchanged":
            trainer.optimizer.step = lambda: True
        elif kind == "half":
            step = trainer.train_step

            def half(batch, cfg_b=None, gumbel_u=None):
                n = batch.batch_size // 2
                return step(dataclasses.replace(batch, **{
                    f.name: getattr(batch, f.name)[:n]
                    for f in dataclasses.fields(batch)
                    if getattr(batch, f.name) is not None}), cfg_b, gumbel_u)
            trainer.train_step = half
        else:
            update = trainer.optimizer.step

            def altered():
                p = next(p for p in trainer.model.parameters()
                         if p.grad is not None)
                p.grad.mul_(2)
                return update()
            trainer.optimizer.step = altered
    return plant


def _hook(kind, entry):
    """Plant the fault under the timed path: in run_batch, where dock_raw's
    poses are produced, or in the training step."""
    if entry == "train_step":
        return _train_hook(kind)

    def plant(engine):
        orig = engine.run_batch

        def broken(batch, cfg_b, *a, **kw):
            out = orig(batch, cfg_b, *a, **kw)
            return (_fault(kind, out[0], batch), *out[1:])
        engine.run_batch = broken
    return plant


def _config(name):
    if name == "toy_fabind_fp32":     # training runs in float32
        return BenchConfig(name, dict(TOY["configs"]["toy_fabind"],
                                      serve_dtype="fp32"))
    return BenchConfig(name, TOY["configs"][name])


def _run(mix, kind=None, control=False, seed=SEED):
    m = TOY["traffic"][mix]
    cfg = _config(CASES[mix])
    ctx = harness.Context(
        mix, {"chips": 1}, {"per_layer": [], "end_to_end": []}, cfg, m, seed,
        0.5, False, time.perf_counter(), device="cpu",
        engine_hook=None if kind is None else _hook(kind, m["entry"]))
    drv = importlib.import_module(f"benchmark.drivers.{m['driver']}")
    if control:
        drv.prepare_control(ctx)
    else:
        drv.run(ctx)
        assert ctx.record["attempted"] > 0 and ctx.record["failed"] == 0
    numbers = drv.check(ctx, control=control)
    return harness.judge(numbers, TOY["limits"][mix])


@pytest.mark.parametrize("mix", sorted(CASES))
def test_sound_run_is_correct(mix):
    ok, rows = _run(mix)
    assert ok, rows


def test_control_is_not_correct():
    """(The training control, TF32, changes nothing on the CPU: it is read
    on the chip.)"""
    ok, rows = _run("toy_batch", control=True)
    assert not ok, rows


@pytest.mark.parametrize("mix, kind", [
    ("toy_batch", "unchanged"), ("toy_batch", "half"),
    ("toy_batch", "half_back"), ("toy_batch", "altered"),
    ("toy_train", "unchanged"), ("toy_train", "half"),
    ("toy_train", "altered")])
def test_fault_is_not_correct(mix, kind):
    ok, rows = _run(mix, kind)
    assert not ok, rows


def test_back_half_fault_fails_the_count():
    """Zeros in the second half of each batch's rows, which a partial
    batch leaves without real requests: the count of poses off by more
    than the mix's gap fails."""
    ok, rows = _run("toy_batch", "half_back")
    failed = {n for n, v, lim in rows if v > lim}
    assert not ok and "poses_over_gap" in failed, rows


def test_judge():
    assert harness.judge({"a": 1.0}, {"a": 1.0}) == (True, [["a", 1.0, 1.0]])
    assert not harness.judge({"a": 1.5}, {"a": 1.0})[0]
    assert not harness.judge({"a": float("nan")}, {"a": 1.0})[0]
    assert not harness.judge({"a": 1.0}, None)[0]
    assert not harness.judge({}, {"a": 1.0})[0]
