"""Best-of-N sampling against its plain reference (reference/sample.py),
on the CPU at toy width: the port's `dock_best_of` with dropout on gives,
in float32, every pass's pose and confidence, its picks and its winner as
the reference does, in both pocket modes; the sampling cell's check
(drivers/sample.py) passes the port's bf16 path and fails the float8
control and each fault planted under the timed path: one pass with its
dropout off, one pass docked at its default center instead of its pick,
the least confident pass returned, default centers moved, crops at a
smaller radius; and a traced run gives the cell's host-side readers their
numbers."""
from __future__ import annotations

import importlib
import json
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.configs_io import BenchConfig

ROOT = Path(__file__).resolve().parents[1]
TOY = json.loads((ROOT / "tests" / "data" / "toy_sample.json").read_text())
CONFIG, MIX = "toy_fabind_plus_sampling", "toy_best_of"
SEED = 2**31 + 99


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _config(**kw):
    return BenchConfig(CONFIG, dict(TOY["configs"][CONFIG], **kw))


@pytest.mark.parametrize("mode", ["stochastic", "fixed"])
def test_dock_best_of_equals_the_reference(mode, monkeypatch):
    """float32: per pass the port's pose, confidence and docking center
    equal the reference's own (its DBSCAN and picks on its own pocket
    stage), and each served pose is the reference's winner."""
    import fabind_tpu_torch.sample as program
    import fabind_tpu_torch.serve as serve
    from benchmark.reference import dock as ref_dock
    from benchmark.reference import sample as ref
    from benchmark.weights import seeded_state_dict
    from fabind_tpu_torch.serve import DockingEngine
    from fabind_tpu_torch.utils import tracing

    c = _config(serve_dtype="fp32",
                overrides=dict(TOY["configs"][CONFIG]["overrides"],
                               sampling_pocket_mode=mode))
    mix = TOY["traffic"][MIX]
    ctx = harness.Context(MIX, {"chips": 1}, {}, c, mix, 5, 0.0, False,
                          time.perf_counter(), device="cpu")
    sample_drv = importlib.import_module("benchmark.drivers.sample")
    raws = sample_drv.make_calls(ctx)[0]
    size, seed = c.data["sample_size"], 7
    sd = seeded_state_dict(c.ref_cfg, 5, "cpu", c.coord_scale)
    cfg, buckets = harness.port_config(c)
    eng = DockingEngine(cfg, state_dict=sd, buckets=buckets,
                        batch_size=c.batch_size, bf16=False, device="cpu")
    passes, centers = [], []
    sample_poses = serve.sample_poses
    monkeypatch.setattr(serve, "sample_poses", lambda *a, **kw: passes.append(
        sample_poses(*a, **kw)) or passes[-1])
    name = "stochastic_dock" if mode == "stochastic" else \
        "stochastic_inference"
    half = getattr(program, name)
    monkeypatch.setattr(program, name, lambda model, batch, shapes, *a: (
        centers.append(a[1 if mode == "stochastic" else 0].clone())
        or half(model, batch, shapes, *a)))
    before = tracing.snapshot()["counters"].get("sample.centers", {})
    poses = eng.dock_best_of(raws, sample_size=size, seed=seed)
    after = tracing.snapshot()["counters"]["sample.centers"]

    want = ref.best_of(ref_dock.build(c.ref_cfg, sd, "cpu"), raws,
                       c.ref_bucket_cfgs(), c.batch_size, size, seed, "cpu")
    assert len(passes) == len(want) == len(c.buckets)
    for bi, ((coords, scores), w) in enumerate(zip(passes, want)):
        for s, p in enumerate(w["passes"]):
            np.testing.assert_allclose(coords[s].numpy(), p["coords"],
                                       atol=1e-4)
            np.testing.assert_allclose(scores[s].numpy(), p["conf"],
                                       atol=1e-5)
            np.testing.assert_allclose(centers[bi * size + s].numpy(),
                                       p["center"], atol=1e-5)
    # some rows docked at a cluster's center
    assert after["cluster"] > before.get("cluster", 0)
    got = ref.requests(want, raws, c.ref_bucket_cfgs())
    for i, pose in enumerate(poses):
        r = got[i]
        np.testing.assert_allclose(pose.coords, r["coords"][r["winner"]],
                                   atol=1e-4)
        assert pose.confidence == pytest.approx(float(r["conf"].max()),
                                                abs=1e-5)


def _fault(kind, monkeypatch):
    """A hook that plants the fault under the timed path (module
    attributes of the port, restored after the test)."""
    import fabind_tpu_torch.sample as program
    import fabind_tpu_torch.serve as serve

    def plant(engine):
        if kind == "dropout_off":
            # pass 1 of the first batch run without its dropout masks
            real = program.dropout_seed
            off = program.pass_seed(TOY["traffic"][MIX]["sample_seed"], 0, 1)
            monkeypatch.setattr(program, "dropout_seed", lambda seed, *a: (
                torch.inference_mode() if seed == off else real(seed, *a)))
        elif kind == "default_center":
            # in each call, the first pass that picks a center other than
            # its default docks at its defaults
            real, done = program._picks, []

            def picks(clusters, prob, default, rng):
                centers, took = real(clusters, prob, default, rng)
                if np.abs(centers - default).max() > 1e-3 and not done:
                    done.append(1)
                    return default.copy(), np.zeros_like(took)
                return centers, took
            monkeypatch.setattr(program, "_picks", picks)
            call = engine.dock_best_of

            def each_call(*a, **kw):
                done.clear()
                return call(*a, **kw)
            engine.dock_best_of = each_call
        elif kind == "center_off":
            # every pass's default center 1 A off the pocket stage's
            real = program.stochastic_pocket
            monkeypatch.setattr(program, "stochastic_pocket", lambda *a: (
                lambda out: (out[0], out[1] + 1.0))(real(*a)))
        elif kind == "crop_radius":
            # the crop at half the radius the pocket stage predicts
            real = engine.model._crop_radius
            monkeypatch.setattr(engine.model, "_crop_radius",
                                lambda r: real(r) * 0.5)
        else:
            # the least confident pass of each request is served
            real = serve.sample_poses

            def least(*a, **kw):
                coords, scores = real(*a, **kw)
                return coords, -scores
            monkeypatch.setattr(serve, "sample_poses", least)
    return plant


def _run(kind=None, control=False, monkeypatch=None, seed=SEED):
    ctx = harness.Context(
        MIX, {"chips": 1}, {"per_layer": [], "end_to_end": []}, _config(),
        TOY["traffic"][MIX], seed, 0.5, False, time.perf_counter(),
        device="cpu",
        engine_hook=None if kind is None else _fault(kind, monkeypatch))
    drv = importlib.import_module("benchmark.drivers.sample")
    if control:
        drv.prepare_control(ctx)
    else:
        drv.run(ctx)
        assert ctx.record["attempted"] > 0 and ctx.record["failed"] == 0
        assert {tuple(c["batches"]) for c in ctx.record["calls"]} == {(2, 2)}
    return harness.judge(drv.check(ctx, control=control),
                         TOY["limits"][MIX])


def test_sound_run_is_correct():
    ok, rows = _run()
    assert ok, rows


def test_control_is_not_correct():
    ok, rows = _run(control=True)
    assert not ok, rows


@pytest.mark.parametrize("kind, number", [
    ("dropout_off", None), ("default_center", "pick_mismatches"),
    ("least_confident", "served_not_argmax"),
    ("center_off", "center_err_max_A"), ("crop_radius", "crop_mismatches")])
def test_fault_is_not_correct(kind, number, monkeypatch):
    ok, rows = _run(kind, monkeypatch=monkeypatch)
    failed = {n for n, v, lim in rows if v > lim}
    assert not ok and (number is None or number in failed), rows


# the cell's per-layer readers that read host spans and batch records,
# which a CPU profile has (the device's need the card)
HOST_READERS = ("host_prep_ms.dock", "pad_share.dock",
                "collate_upload_ms.dock", "cluster_ms.sample",
                "readback_ms.sample")


def test_host_readers_after_a_traced_run():
    """A traced toy run (both batches of its second call profiled; the
    first batch's collate runs before the profiler starts) gives each
    host-side reader of the cell a number, and the cell lists them."""
    bench = json.loads((ROOT.parent / "BENCHMARK.json").read_text())
    cell = "fabind_plus_sampling.best_of_8"
    listed = {m["name"] for m in bench["per_layer"]
              if cell in m.get("workloads", [cell])}
    assert set(HOST_READERS) <= listed
    ctx = harness.Context(
        MIX, {"chips": 1}, {"per_layer": [], "end_to_end": []}, _config(),
        dict(TOY["traffic"][MIX], trace_batches=2), SEED, 5.0, True,
        time.perf_counter(), device="cpu")
    importlib.import_module("benchmark.drivers.sample").run(ctx)
    # call 0 unprofiled (host_prep_ms.dock reads it), call 1 profiled
    assert len(ctx.record["calls"]) >= 2
    for name in HOST_READERS:
        v = harness.read_metric(name, ctx)
        assert v is not None and v >= 0, name


def test_every_seed_asks_for_the_same_work():
    """Each call routes exactly per_bucket requests to each bucket, bucket
    after bucket, with the same multiset of sizes for every seed."""
    from benchmark.reference.batching import build_sample
    from benchmark.reference.buckets import route_sample

    c = _config()
    drv = importlib.import_module("benchmark.drivers.sample")
    mix = TOY["traffic"][MIX]
    cfgs = c.ref_bucket_cfgs()
    seen = set()
    for seed in (1, 2**31 + 7):
        ctx = harness.Context(MIX, {"chips": 1}, {}, c, mix, seed, 0.0,
                              False, time.perf_counter(), device="cpu")
        calls = drv.make_calls(ctx)
        assert len(calls) == mix["pool_calls"]
        for call in calls:
            routed = [cfgs.index(route_sample(
                build_sample(r, cfgs[-1], group="test"), cfgs)) for r in call]
            assert routed == sorted(routed) == [
                k for k in range(len(cfgs)) for _ in range(mix["per_bucket"])]
            seen.add(tuple(sorted((r["protein_xyz"].shape[0],
                                   r["lig_feats"].shape[0]) for r in call)))
    assert len(seen) == 1


def test_reference_imports_no_port_and_no_jax():
    """reference/sample.py imports nothing of fabind_tpu_torch, JAX, flax
    or the JAX package; the driver and the new readers import no JAX."""
    import subprocess
    import sys

    code = (
        "import sys, importlib\n"
        "importlib.import_module('benchmark.reference.sample')\n"
        "top = {m.split('.')[0] for m in sys.modules}\n"
        "assert 'fabind_tpu_torch' not in top, 'the reference imports the port'\n"
        "importlib.import_module('benchmark.drivers.sample')\n"
        "from benchmark import harness\n"
        "assert harness.forbidden_modules() == [], harness.forbidden_modules()\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT.parent,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_closed_form_of_the_sampling_config():
    """The configuration's FLOPs closed form equals the meta count at sizes
    it was not fitted at."""
    from benchmark import flops
    from benchmark.configs_io import load_config

    c = load_config("fabind_plus_sampling")
    for sizes, n in (((23, 77, 256), 3), ((61, 140, 700), 8)):
        assert flops.closed_form(c.data["flops"], *sizes, n) == \
            flops.forward_flops(c.ref_cfg, *sizes, 1, n)
