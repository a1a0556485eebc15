"""The port's deployment artifacts (fabind_tpu_torch.aot, cli.export,
DockingEngine.from_exported, cli.serve --exported) on the CPU at the toy
widths of tests/common.py TINY, mirroring tests/test_aot.py.

The exported engine is held to the port's live engine bit for bit (fp32 and
bf16: the program runs the same ATen operations on the same weights), and to
the JAX package's exported engine (`fabind_tpu.aot.export_inference` with
platforms=("cpu",), then `from_exported`) on the same weights
(`state_dict_from_flax`): within 2e-4 A in fp32 (tests/test_torch_model.py's
ATOL), and in bf16 within the bound of test_torch_serve.py's
test_dock_raw_bf16_matches_jax_bf16 (mean per-atom distance at most 2x the
JAX package's own bf16-vs-fp32 distance + 1e-3 A).
"""
from __future__ import annotations

import dataclasses
import json
import os
import threading

import jax
import numpy as np
import pytest
import torch

from common import TINY
from test_serve import make_raw

from fabind_tpu.aot import export_inference as jax_export_inference
from fabind_tpu.config import preset as jax_preset
from fabind_tpu.serve import DockingEngine as JaxEngine

from fabind_tpu_torch import aot
from fabind_tpu_torch.aot import ExportedInference, export_inference
from fabind_tpu_torch.config import preset
from fabind_tpu_torch.data.types import dummy_batch
from fabind_tpu_torch.ops import edge_gate
from fabind_tpu_torch.serve import DockingEngine
from fabind_tpu_torch.train.convert import state_dict_from_flax
from fabind_tpu_torch.utils.precision import cast_batch_bf16

ATOL_A = 2e-4
POSE_SLACK_A = 1e-3
_TINY_SET = [f"--set={k}={v}" for k, v in TINY.items()]
_SMALL_SET = ["--set=max_ligand=8", "--set=max_pocket=16",
              "--set=max_protein=32"]
_GATE_OP = torch.ops.fabind_tpu_torch.edge_gate_pair.default


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's torch work: its tensors are
    toy-sized, and the suite runs in parallel workers that would otherwise
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _small(shapes):
    return dataclasses.replace(shapes, max_ligand=8, max_pocket=16,
                               max_protein=32)


def _small_raws():
    """Requests that fit the small bucket 8:16:32 (two batches of 2)."""
    return [make_raw(n=5, nr=20, seed=1), make_raw(n=6, nr=20, seed=4),
            make_raw(n=7, nr=30, seed=5), make_raw(n=8, nr=24, seed=11)]


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The JAX engine's fp32 init at TINY carried across, a bf16 artifact
    over the two TINY buckets exported on the CPU, loaded once, and the
    live bf16 engine on the same weights."""
    cfg, jcfg = preset("fabind", **TINY), jax_preset("fabind", **TINY)
    buckets = [_small(cfg.shapes), cfg.shapes]
    jparams = jax.tree_util.tree_map(
        np.asarray, JaxEngine(jcfg, batch_size=2, bf16=False).params)
    sd = state_dict_from_flax(jparams, is_plus=False)
    out = str(tmp_path_factory.mktemp("aot"))
    manifest = export_inference(cfg, sd, out, buckets=buckets, batch_size=2,
                                bf16=True, device="cpu")
    live = DockingEngine(cfg, state_dict=sd, buckets=buckets, batch_size=2,
                         device="cpu")
    exported = DockingEngine.from_exported(out, device="cpu")
    return cfg, jcfg, jparams, sd, out, manifest, live, exported


@pytest.fixture(scope="module")
def fp32_small(setup, tmp_path_factory):
    """An fp32 artifact of the small bucket, through cli.export from a
    state-dict file, and the live fp32 engine of the same bucket."""
    from fabind_tpu_torch.cli import export as cli_export

    cfg, _, _, sd, _, _, _, _ = setup
    root = tmp_path_factory.mktemp("aot32")
    torch.save(sd, root / "sd.pt")
    out = str(root / "art")
    cli_export.main(["--ckpt", str(root / "sd.pt"), "--output", out,
                     "--batch-size", "2", "--no-bf16", "--device", "cpu",
                     "--post-optim-steps", "3"] + _TINY_SET + _SMALL_SET)
    small = cfg.replace(shapes=_small(cfg.shapes))
    live = DockingEngine(small, state_dict=sd, batch_size=2, bf16=False,
                         device="cpu", post_optim_steps=3)
    return out, live


@pytest.fixture(scope="module")
def jax_small(setup, tmp_path_factory):
    """{bf16: the JAX package's exported engine's poses of _small_raws()}
    for the small bucket on the same weights."""
    _, jcfg, jparams, _, _, _, _, _ = setup
    small = jcfg.replace(shapes=_small(jcfg.shapes))
    poses = {}
    for bf16 in (False, True):
        out = str(tmp_path_factory.mktemp(f"jax{int(bf16)}"))
        jax_export_inference(small, jparams, out, batch_size=2, bf16=bf16,
                             platforms=("cpu",))
        poses[bf16] = JaxEngine.from_exported(out).dock_raw(_small_raws())
    return poses


def test_manifest_and_artifacts(setup):
    cfg, _, _, _, out, manifest, _, _ = setup
    assert manifest["format_version"] == 1
    assert manifest["batch_size"] == 2 and manifest["bf16"] is True
    assert manifest["flexible"] is False and manifest["sampling"] is False
    assert manifest["sampling_pocket_mode"] is None
    assert manifest["post_optim_steps"] == 0
    assert manifest["export_device"] == "cpu"
    assert manifest["torch_version"] == torch.__version__
    assert manifest["outputs"] == ["lig_coords", "confidence", "overflow"]
    assert [i["name"] for i in manifest["inputs"]] == list(aot.BATCH_FIELDS)
    assert "isomorphisms" not in aot.BATCH_FIELDS
    assert [e["file"] for e in manifest["buckets"]] == [
        "bucket_8_16_32.pt2", "bucket_16_24_48.pt2"]
    for e in manifest["buckets"]:
        assert os.path.getsize(os.path.join(out, e["file"])) > 1000
    with open(os.path.join(out, "manifest.json")) as fh:
        disk = json.load(fh)
    assert disk["config"]["model"]["hidden_size"] == cfg.model.hidden_size
    assert aot.config_from_dict(disk["config"]) == cfg


def test_programs_call_the_gate_operator(setup):
    """Each program holds one call of the registered gate operator per
    launch of the live forward (1 pocket layer + 1 layer x 2 recycles),
    so on the card it launches the kernel as the live model does."""
    programs = setup[-1]._exported._programs
    assert len(programs) == 2
    for prog in programs.values():
        calls = [n for n in prog.graph.nodes if n.target is _GATE_OP]
        assert len(calls) == 3


def test_exported_engine_matches_live(setup):
    _, _, _, _, _, _, live, exported = setup
    assert exported.model is None
    assert exported.bf16 and exported.batch_size == 2
    raws = [make_raw(n=5, nr=20, seed=1),     # small bucket
            make_raw(n=12, nr=40, seed=2),    # large bucket
            make_raw(n=40, nr=40, seed=3),    # oversize -> error pose
            make_raw(n=6, nr=20, seed=4),
            make_raw(n=14, nr=44, seed=6)]
    before = edge_gate.KERNEL.launches
    got = exported.dock_raw(raws)
    assert edge_gate.KERNEL.launches == before     # CPU: the plain version
    want = live.dock_raw(raws)
    assert got[2].error is not None and "exceeds" in got[2].error
    assert {g.pocket_truncated for g in got} != {0}
    for i in (0, 1, 3, 4):
        assert got[i].error is None
        np.testing.assert_array_equal(got[i].coords, want[i].coords)
        assert got[i].confidence == want[i].confidence
        assert got[i].pocket_truncated == want[i].pocket_truncated


def test_exported_engine_warmup_and_screen(setup):
    _, _, _, _, _, _, _, exported = setup
    assert exported.warmup() > 0.0       # dummy batches: sample_valid None
    prot = make_raw(n=5, nr=20, seed=7)
    ligs = [make_raw(n=4, nr=20, seed=8), make_raw(n=6, nr=20, seed=9),
            make_raw(n=12, nr=20, seed=10)]
    pkeys = ("protein_xyz", "esm_feat")
    for lig in ligs:
        for k in pkeys:
            lig.pop(k)
    protein = {k: prot[k] for k in pkeys}
    poses = exported.dock_screen(protein, ligs)
    direct = exported.dock_raw([dict(lig, **protein) for lig in ligs])
    for p, d in zip(poses, direct):
        assert p.error is None and np.isfinite(p.coords).all()
        np.testing.assert_array_equal(p.coords, d.coords)


def test_exported_engine_docks_eagerly(setup, monkeypatch):
    """An exported engine replays no docking graph, where a live one on
    the same device would (the capture's stand-in, graphs.Rerun, on the
    CPU): its programs run whole, each batch counted under
    serve.graph_eager."""
    from fabind_tpu_torch import graphs
    from fabind_tpu_torch.utils import tracing

    monkeypatch.setattr(graphs, "backend_for", lambda device: graphs.Rerun)
    _, _, _, _, out, _, _, _ = setup
    exported = DockingEngine.from_exported(out, device="cpu")
    assert exported._graphs is None
    live = DockingEngine(setup[0], state_dict=setup[3],
                         buckets=[_small(setup[0].shapes), setup[0].shapes],
                         batch_size=2, device="cpu")
    assert live._graphs is not None

    def eager():
        return dict(tracing.snapshot()["counters"].get("serve.graph_eager",
                                                       {}))

    before = eager()
    exported.dock_raw(_small_raws())
    after = eager()
    assert after.get("8x16x32", 0) - before.get("8x16x32", 0) == 2


def test_exported_engine_under_threads(setup):
    """Three threads docking through one exported engine at once (as the
    daemon's handler threads do) get the poses of serial calls."""
    exported = setup[-1]
    work = [[make_raw(n=5 + i, nr=20, seed=30 + i),
             make_raw(n=12, nr=40, seed=40 + i)] for i in range(3)]
    serial = [exported.dock_raw(w) for w in work]
    out = [None] * 3

    def call(i):
        out[i] = exported.dock_raw(work[i])

    threads = [threading.Thread(target=call, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    for got, want in zip(out, serial):
        for g, w in zip(got, want):
            assert g.error is None
            np.testing.assert_array_equal(g.coords, w.coords)


def test_best_of_and_sampling_export_raise(setup):
    """An artifact exported without the sampling programs: the exported
    engine refuses dock_best_of with the re-export hint."""
    exported = setup[-1]
    assert not exported._exported.sampling
    with pytest.raises(ValueError, match="re-export .*--sampling"):
        exported.dock_best_of([make_raw(n=5, nr=20, seed=1)], sample_size=2)
    with pytest.raises(ValueError, match="re-export"):
        exported._exported.sampling_halves(exported.bucket_cfgs[0])


def test_sampling_export_needs_confidence_head(setup, tmp_path):
    """export_inference(sampling=True) and cli.export --sampling refuse a
    preset without the confidence head, before writing an artifact."""
    from fabind_tpu_torch.cli import export as cli_export

    cfg, _, _, sd, _, _, _, _ = setup
    out = tmp_path / "art"
    with pytest.raises(AssertionError, match="confidence head"):
        export_inference(cfg, sd, str(out), batch_size=2, device="cpu",
                         sampling=True)
    ckpt = tmp_path / "sd.pt"
    torch.save(sd, ckpt)
    with pytest.raises(AssertionError, match="confidence head"):
        cli_export.main(["--ckpt", str(ckpt), "--output", str(out),
                         "--device", "cpu", "--sampling", *_TINY_SET])
    assert not out.exists()


def test_wrong_bucket_batch_clear_error(setup):
    cfg, _, _, _, _, _, _, exported = setup
    ex = exported._exported
    small_cfg, large_cfg = ex.bucket_cfgs
    b = cast_batch_bf16(dummy_batch(small_cfg.shapes, batch_size=2))
    with pytest.raises(ValueError, match="calling convention"):
        ex.fn(large_cfg)(b)
    # the right bucket, the wrong dtype
    with pytest.raises(ValueError, match="calling convention"):
        ex.fn(small_cfg)(dummy_batch(small_cfg.shapes, batch_size=2))
    coords, conf, overflow = ex.fn(small_cfg)(b)
    assert coords.shape == (2, 8, 3) and coords.dtype == torch.bfloat16


def test_exported_on_cpu_serves_on_another_device(fp32_small):
    """move_to_device_pass moves the weights and every tensor the program
    creates: the CPU artifact runs on the meta device with no CPU tensor
    left in it (a CPU constant beside meta inputs would raise)."""
    ex = ExportedInference(fp32_small[0], "meta")
    cfg_b, = ex.bucket_cfgs
    b = dummy_batch(cfg_b.shapes, batch_size=2, device="meta")
    coords, conf, overflow = ex.fn(cfg_b)(b)
    assert coords.device.type == "meta" and coords.shape == (2, 8, 3)
    prog, = ex._programs.values()
    devices = {str(n.kwargs["device"]) for n in prog.graph.nodes
               if "device" in n.kwargs}
    assert devices == {"meta"}


def test_fp32_export_matches_live_and_jax(fp32_small, jax_small):
    """cli.export's fp32 artifact: post-optimization recorded and guarded,
    poses equal to the live engine's with the same steps; without them,
    within ATOL_A of the JAX package's exported fp32 engine."""
    out, live = fp32_small
    with open(os.path.join(out, "manifest.json")) as fh:
        m = json.load(fh)
    assert m["post_optim_steps"] == 3 and m["bf16"] is False
    with pytest.raises(ValueError, match="baked into the artifact"):
        DockingEngine.from_exported(out, post_optim_steps=5, device="cpu")
    exported = DockingEngine.from_exported(out, post_optim_steps=3,
                                           device="cpu")
    assert exported.post_optim_steps == 3 and exported.model is None
    raws = _small_raws()
    got, want = exported.dock_raw(raws), live.dock_raw(raws)
    for g, w in zip(got, want):
        assert g.error is None
        np.testing.assert_array_equal(g.coords, w.coords)

    exported.post_optim_steps = live.post_optim_steps = 0
    for g, w, j in zip(exported.dock_raw(raws), live.dock_raw(raws),
                       jax_small[False]):
        assert j.error is None
        np.testing.assert_array_equal(g.coords, w.coords)
        np.testing.assert_allclose(g.coords, j.coords, atol=ATOL_A, rtol=0)
        assert g.pocket_truncated == j.pocket_truncated


def test_bf16_export_matches_jax_bf16(setup, jax_small):
    """The bf16 artifact against the JAX package's bf16 artifact of the
    small bucket, both against the JAX fp32 artifact."""
    exported = setup[-1]
    d_port, d_jax = [], []
    for g, w, w32 in zip(exported.dock_raw(_small_raws()), jax_small[True],
                         jax_small[False]):
        assert g.error is None and w.error is None
        assert g.pocket_truncated == w.pocket_truncated
        d_port.append(np.linalg.norm(g.coords.astype(np.float64) - w.coords,
                                     axis=-1))
        d_jax.append(np.linalg.norm(w.coords.astype(np.float64) - w32.coords,
                                    axis=-1))
    d_port, d_jax = np.concatenate(d_port), np.concatenate(d_jax)
    assert d_jax.mean() > 0
    assert d_port.mean() <= 2 * d_jax.mean() + POSE_SLACK_A, \
        (d_port.mean(), d_jax.mean())


def test_exported_dock_sdf(setup, fp32_small, tmp_path):
    """dock_sdf through an exported engine with an encoder (ESM2 at width
    1280, one layer, seeded): the live engine's poses and sdf_meta, the
    manifest's post-optimization included."""
    from chip_smoke import pdb_text
    from test_torch_featurize import synthetic_ligand

    from fabind_tpu_torch.data import featurize as F
    from fabind_tpu_torch.models.esm2 import Esm2Config, Esm2Model

    cfg, sd = setup[0], setup[3]
    out, _ = fp32_small
    rng = np.random.RandomState(3)
    aas = sorted(F.THREE_TO_ONE.values())
    pairs = []
    for i, n in enumerate((24, 30)):
        ca = rng.randn(n, 3) * 2.5
        ca[12:] += 60.0
        pdb = tmp_path / f"p{i}.pdb"
        pdb.write_text(pdb_text("".join(rng.choice(aas, n)), ca))
        symbols, coords, bonds = synthetic_ligand(rng, 6 + i, n_rings=1,
                                                  center=ca[:4].mean(0))
        sdf = tmp_path / f"l{i}.sdf"
        F.write_sdf(str(sdf), symbols, coords, bonds, name=f"l{i}")
        pairs.append((str(sdf), str(pdb)))
    torch.manual_seed(0)
    esm = Esm2Model(Esm2Config(hidden_size=1280, num_layers=1, num_heads=20,
                               intermediate_size=64))
    exported = DockingEngine.from_exported(out, device="cpu", esm=esm)
    live = DockingEngine(cfg.replace(shapes=_small(cfg.shapes)),
                         state_dict=sd, batch_size=2, bf16=False,
                         device="cpu", post_optim_steps=3, esm=esm)
    got, want = exported.dock_sdf(pairs), live.dock_sdf(pairs)
    for g, w in zip(got, want):
        assert g.error is None and g.sdf_meta.keys() == w.sdf_meta.keys()
        for k in w.sdf_meta:
            np.testing.assert_array_equal(g.sdf_meta[k], w.sdf_meta[k])
        np.testing.assert_array_equal(g.coords, w.coords)


def test_cli_serve_exported(setup, fp32_small, monkeypatch):
    """cli.serve --exported serves the artifact's engine and refuses the
    flags the artifact fixes, with the JAX command line's message."""
    import fabind_tpu_torch.serve_http as sh
    from fabind_tpu_torch.cli import serve as cs

    out, _ = fp32_small
    captured = {}
    monkeypatch.setattr(sh, "serve_forever",
                        lambda engine, host, port, pdb_root=None:
                        captured.update(engine=engine, port=port))
    for flags in (["--ckpt", "x.bin"], ["--buckets", "8:16:32"],
                  ["--set", "hidden_size=8"], ["--no-bf16"],
                  ["--post-optim-steps", "2"]):
        with pytest.raises(SystemExit, match="bakes these into the artifact"):
            cs.main(["--exported", out, "--device", "cpu"] + flags)
    assert not captured
    cs.main(["--exported", out, "--device", "cpu", "--port", "8123",
             "--warmup"])
    eng = captured["engine"]
    assert captured["port"] == 8123
    assert eng.model is None and eng.post_optim_steps == 3
    assert eng.bf16 is False and eng.device.type == "cpu"


def test_from_exported_without_cuda_raises(setup, monkeypatch):
    out = setup[4]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DockingEngine.from_exported(out)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        export_inference(setup[0], setup[3], out, device="cuda")
