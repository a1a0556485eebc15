"""The benchmark's data side on the CPU: traffic from the seed, the files
found by name, the model FLOPs against the profiler, and the imports."""
from __future__ import annotations

import dataclasses
import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import gen
from benchmark.configs_io import BenchConfig, load_config

ROOT = Path(__file__).resolve().parents[1]
CHECKOUT = ROOT.parent
TOY = json.loads((ROOT / "tests" / "data" / "toy.json").read_text())
BIG_SEED = 2**31 + 12345


def _bench():
    return json.loads((CHECKOUT / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("mix", ["batch64", "train_fp32"])
def test_traffic_same_for_a_seed_and_in_range(mix):
    m = gen.load_mix(mix)
    a, b = gen.make_pool(m, BIG_SEED), gen.make_pool(m, BIG_SEED)
    assert len(a) == m["pool_requests"]
    for x, y in zip(a, b):
        assert x.keys() == y.keys()
        assert all(np.array_equal(x[k], y[k]) for k in x)
    sizes = gen.sizes(m, BIG_SEED)
    for col, key in ((0, "protein_residues"), (1, "ligand_atoms")):
        lo, hi = m[key]["min"], m[key]["max"]
        assert sizes[:, col].min() >= lo and sizes[:, col].max() <= hi
    for raw, (nr, na) in zip(a, sizes):
        assert raw["protein_xyz"].shape == (nr, 3)
        assert raw["esm_feat"].shape == (nr, gen.ESM_DIM)
        assert raw["lig_coords"].shape == (na, 3)
        assert raw["las_mask"].shape == (na, na)


def test_traffic_differs_between_seeds_in_order_not_in_work():
    """Two seeds ask for the same multiset of sizes in every call, in
    different orders, with different contents."""
    m = gen.load_mix("batch64")
    a, b = gen.sizes(m, BIG_SEED), gen.sizes(m, BIG_SEED + 1)
    assert not np.array_equal(a, b)
    n = m["requests_per_call"]
    for i in range(0, len(a), n):
        for x in (a, b):
            assert sorted(map(tuple, x[i:i + n])) == \
                sorted(map(tuple, gen.block_sizes(m)))
    ra, rb = gen.make_pool(dict(m, pool_requests=2), 1), \
        gen.make_pool(dict(m, pool_requests=2), 2)
    assert not np.array_equal(ra[0]["lig_feats"][:3], rb[0]["lig_feats"][:3])


def test_train_mix_fixes_the_draws_of_every_step():
    """The training mix fixes the seed of every step's draws (recycle
    counts, dropout masks, stage coin) and the set-up's length, so two
    --seed values run the same recycle counts step by step on their own
    complexes, weights and shuffle."""
    from benchmark.drivers import train
    from benchmark.harness import load_context
    a, b = (load_context("fabind.train_fp32", s, 1.0, False, 0.0)
            for s in (BIG_SEED, BIG_SEED + 1))
    assert "step_seed" in a.mix and a.mix["setup_steps"] >= \
        a.mix["check_steps"]
    assert train.step_seed(a) == train.step_seed(b)
    assert train.train_seed(a) != train.train_seed(b)


def test_traffic_sizes_are_heavy_tailed():
    """The mix's medians and its tail: half the ligands under 28 atoms and
    some above 60; half the proteins under 300 residues, some above 600."""
    s = gen.sizes(dict(gen.load_mix("batch64"), pool_requests=4000), 7)
    assert 24 <= np.median(s[:, 1]) <= 32 and (s[:, 1] > 60).mean() > 0.02
    assert 270 <= np.median(s[:, 0]) <= 330 and (s[:, 0] > 600).mean() > 0.02


def test_benchmark_json_names_files_that_exist():
    bench = _bench()
    for c in bench["configs"]:
        assert (CHECKOUT / c["file"]).exists()
        assert load_config(c["name"]).preset
    for w in bench["workloads"]:
        assert (ROOT / "traffic" / f"{w['traffic']}.json").exists()
        assert (ROOT / "limits" / f"{w['name']}.json").exists()
        mix = gen.load_mix(w["traffic"])
        assert (ROOT / "drivers" / f"{mix['driver']}.py").exists()
    for m in bench["per_layer"]:
        assert (ROOT / "metrics" / f"{m['name']}.py").exists()


def test_a_new_cell_takes_new_files_and_entries_only(tmp_path):
    """A copy of the benchmark gains a configuration, a traffic mix, a
    metric and a cell by new files and new entries alone, and the harness
    finds each by name."""
    shutil.copytree(ROOT, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = _bench()
    new = tmp_path / "benchmark"
    (new / "configs" / "toy_new.json").write_text(json.dumps(
        dict(TOY["configs"]["toy_fabind"], name="toy_new")))
    (new / "traffic" / "toy_new_mix.json").write_text(json.dumps(
        TOY["traffic"]["toy_batch"]))
    (new / "metrics" / "answer.toy.py").write_text(
        "def read(ctx):\n    return float(len(ctx.mix))\n")
    bench["configs"].append({"name": "toy_new", "source": "x",
                             "file": "benchmark/configs/toy_new.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "toy_new.cell", "config": "toy_new",
                               "traffic": "toy_new_mix", "chips": 1,
                               "why": "x"})
    bench["per_layer"].append({"name": "answer.toy", "unit": "%",
                               "better": "higher", "source": "program_span",
                               "layer": "x", "moves": "setup_s",
                               "workloads": ["toy_new.cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = (
        "from benchmark import harness\n"
        "ctx = harness.load_context('toy_new.cell', 1, 1.0, True, 0.0)\n"
        "assert ctx.config.preset == 'fabind'\n"
        "assert ctx.mix['driver'] == 'dock'\n"
        "assert ctx.per_layer_names() == ['answer.toy']\n"
        "print(harness.read_metric('answer.toy', ctx))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert float(out.stdout.split()[-1]) == len(TOY["traffic"]["toy_batch"])


def test_flops_equal_the_profilers_count():
    """flops.forward_flops (the meta count) equals the profiler's
    `with_flops` total of the reference's matrix products on the CPU, at
    toy width and sizes that fill the bucket; the closed form equals the
    meta count."""
    from torch.profiler import ProfilerActivity, profile

    from benchmark import flops
    from benchmark.reference.batching import build_sample, collate
    from benchmark.reference.dock import build
    from benchmark.reference.types import FABindBatch
    from benchmark.weights import seeded_state_dict

    cfg = BenchConfig("toy_fabind", TOY["configs"]["toy_fabind"]).ref_cfg
    raw = gen.make_request(np.random.default_rng(3), 40, 12)
    s = build_sample(raw, cfg, group="test")
    n_pkt = len(s["pocket_idx"])
    shapes = dataclasses.replace(cfg.shapes, max_ligand=12,
                                 max_pocket=n_pkt, max_protein=40)
    c = cfg.replace(shapes=shapes)
    batch = FABindBatch.from_numpy(collate([s], c), "cpu")
    model = build(cfg, seeded_state_dict(cfg, 5, "cpu"), "cpu")
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU],
                                  with_flops=True) as prof:
        model.inference_diag(batch, shapes=shapes, pocket_count=1,
                             count=2)
    counted = sum(e.flops for e in prof.events()
                  if e.name in ("aten::mm", "aten::addmm", "aten::bmm",
                                "aten::baddbmm"))
    assert counted == flops.forward_flops(cfg, 12, n_pkt, 40, 1, 2)


def test_closed_form_of_the_configs():
    """The closed form in the configuration file equals the meta count at
    sizes that are not among those it was fitted at."""
    from benchmark import flops
    c = load_config("fabind")
    coef = c.data["flops"]
    for sizes, n in (((23, 77, 256), 3), ((61, 140, 700), 8)):
        assert flops.closed_form(coef, *sizes, n) == \
            flops.forward_flops(c.ref_cfg, *sizes, 1, n)


def test_imports_no_jax_and_reference_imports_no_port():
    """What `python -m benchmark.run` imports holds no module named jax,
    jaxlib, flax or fabind_tpu (top-level names compared whole); the
    reference and the yardstick import nothing of fabind_tpu_torch."""
    code = (
        "import sys, importlib\n"
        "mods = ['benchmark.reference.dock', 'benchmark.reference.train',"
        " 'benchmark.flops', 'benchmark.weights', 'benchmark.peaks',"
        " 'benchmark.compare', 'benchmark.gen', 'benchmark.trace']\n"
        "for m in mods: importlib.import_module(m)\n"
        "top = {m.split('.')[0] for m in sys.modules}\n"
        "assert 'fabind_tpu_torch' not in top, 'reference imports the port'\n"
        "for m in ['benchmark.run', 'benchmark.harness',"
        " 'benchmark.drivers.dock', 'benchmark.drivers.train',"
        " 'fabind_tpu_torch.serve', 'fabind_tpu_torch.train.trainer']:\n"
        "    importlib.import_module(m)\n"
        "from benchmark import harness\n"
        "assert harness.forbidden_modules() == [], harness.forbidden_modules()\n"
        "top = {m.split('.')[0] for m in sys.modules}\n"
        "assert not top & {'jax', 'jaxlib', 'flax', 'fabind_tpu'}\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=CHECKOUT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_forbidden_names_are_compared_whole(monkeypatch):
    from benchmark import harness
    monkeypatch.setitem(sys.modules, "fabind_tpu_torch_x", object())
    monkeypatch.setitem(sys.modules, "jaxify", object())
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "fabind_tpu.models", object())
    assert harness.forbidden_modules() == ["fabind_tpu"]


def test_run_refuses_without_cuda_devices():
    """The command exits non-zero and prints no result without a card."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         "fabind.batch_dock", "--seed", str(BIG_SEED), "--seconds", "1",
         "--trace", "0"], cwd=CHECKOUT, capture_output=True, text=True,
        timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_run_refuses_in_a_checkout_of_only_the_benchmark(tmp_path):
    """With only BENCHMARK.json and the benchmark's files, the command
    exits non-zero and prints no result."""
    shutil.copytree(ROOT, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(CHECKOUT / "BENCHMARK.json", tmp_path)
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         "fabind.batch_dock", "--seed", "1", "--seconds", "1", "--trace",
         "0"], cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
