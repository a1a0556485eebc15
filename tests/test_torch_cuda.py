"""The edge-gate CUDA kernel against its plain PyTorch version, on the card:
its launch over both attention directions (phi_rank1_pair); and the
serving engine on the card (bf16 against fp32, bucket routing, the
protein-row cache, the launch count under threads; FABind+ against the
CPU, seeded best-of-N sampling); and a training step on the card against
the same step on the CPU, with the gate's gradients at a docking training
shape; and the evaluation and confidence paths on the card against the
CPU.

Needs a CUDA device and nvcc; skips elsewhere. The file imports neither JAX
nor the JAX package, so it runs where only PyTorch is installed:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""
import dataclasses
import threading

import numpy as np
import pytest
import torch

from fabind_tpu_torch.config import preset
from fabind_tpu_torch.ops import edge_gate
from fabind_tpu_torch.ops.edge_gate import (phi_rank1_pair,
                                            phi_rank1_pair_reference)
from fabind_tpu_torch.serve import DockingEngine

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _pair_inputs(shape, dtype, device, seed=0, wide=False):
    """(l1_a, l1_b, r, u, w2); with `wide`, l1 uniform in [-100, 100]."""
    B, Na, Nb, H = shape
    g = torch.Generator().manual_seed(seed)
    l1 = [torch.randn(B, n, H, generator=g) for n in (Na, Nb)]
    if wide:
        l1 = [(torch.rand(t.shape, generator=g) * 2 - 1) * 100 for t in l1]
    rest = [torch.randn(*s, generator=g) for s in ((B, Na, Nb), (H,), (H,))]
    return tuple(t.to(device, dtype) for t in l1 + rest)


# the main path's pair shapes (pocket, docking), a ragged pair and an H that
# is a multiple of no chunk
PAIR_SHAPES = [(8, 48, 512, 128), (8, 48, 160, 512), (2, 7, 11, 48),
               (2, 13, 21, 100)]


@pytest.mark.parametrize("act", ["silu", "relu"])
@pytest.mark.parametrize("shape", PAIR_SHAPES)
def test_pair_kernel_matches_plain_fp32(cuda, act, shape):
    args = _pair_inputs(shape, torch.float32, cuda)
    before = edge_gate.KERNEL.launches
    got = phi_rank1_pair(*args, act=act)
    torch.cuda.synchronize()
    assert edge_gate.KERNEL.launches == before + 1
    for g, w in zip(got, phi_rank1_pair_reference(*args, act=act)):
        torch.testing.assert_close(g, w, atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("shape", [(8, 48, 160, 512), (2, 7, 11, 48)])
def test_pair_kernel_matches_plain_bf16(cuda, shape):
    args = _pair_inputs(shape, torch.bfloat16, cuda)
    got = phi_rank1_pair(*args, act="silu")
    for g, w in zip(got, phi_rank1_pair_reference(*args)):
        assert g.dtype == torch.bfloat16
        torch.testing.assert_close(g.float(), w.float(), atol=1e-2,
                                   rtol=1e-2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pair_kernel_wide_preactivations(cuda, dtype):
    """Pre-activations up to +-100: the approximate silu keeps F.silu's
    limits (0 at the negative end, x at the positive end, no NaN)."""
    args = _pair_inputs((2, 16, 32, 64), dtype, cuda, wide=True)
    got = phi_rank1_pair(*args, act="silu")
    tol = (1e-4, 1e-5) if dtype == torch.float32 else (1e-2, 1e-2)
    for g, w in zip(got, phi_rank1_pair_reference(*args)):
        assert bool(torch.isfinite(g).all())
        torch.testing.assert_close(g.float(), w.float(), atol=tol[0],
                                   rtol=tol[1])


def test_pair_kernel_backward_matches_plain(cuda):
    args = [t.requires_grad_() for t in _pair_inputs((1, 5, 9, 16),
                                                     torch.float32, cuda)]
    g_ab = torch.randn(1, 5, 9, device=cuda)
    g_ba = torch.randn(1, 9, 5, device=cuda)

    def grads(fn):
        ab, ba = fn(*args)
        return torch.autograd.grad((ab * g_ab).sum() + (ba * g_ba).sum(),
                                   args)

    for a, b in zip(grads(phi_rank1_pair), grads(phi_rank1_pair_reference)):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)


def test_pair_kernel_rejects_bad_input(cuda):
    l1_a, l1_b, r, u, w2 = _pair_inputs((1, 4, 8, 16), torch.float32, cuda)
    with pytest.raises(ValueError, match="shape mismatch"):
        phi_rank1_pair(l1_b, l1_a, r, u, w2)
    with pytest.raises(ValueError, match="contiguous"):
        phi_rank1_pair(l1_a, l1_b, r.transpose(1, 2).contiguous()
                       .transpose(1, 2), u, w2)
    with pytest.raises(TypeError):
        phi_rank1_pair(*(t.double() for t in (l1_a, l1_b, r, u, w2)))


# ---------------------------------------------------------------- serving
# toy widths at the released depth (4 docking layers x 8 recycles, 1 pocket
# layer): 33 gate launches per batch, as on the main path
ENGINE_KW = dict(max_ligand=16, max_pocket=24, max_protein=48, ctx_k=8,
                 ctx_k_whole=8, hidden_size=32, pocket_pred_hidden_size=16)
LAUNCHES_PER_BATCH = 33


def _raw(n, nr, seed):
    """A small request: a compact protein of nr residues, a chain ligand of
    n atoms beside its first residues."""
    rng = np.random.RandomState(seed)
    prot = (rng.randn(nr, 3) * 3).astype(np.float32)
    lig = (prot[:3].mean(0) + rng.randn(n, 3)).astype(np.float32)
    bonds = [(i, i + 1) for i in range(n - 1)]
    bonds += [(j, i) for i, j in bonds]
    las = np.abs(np.arange(n)[:, None] - np.arange(n)[None]) == 1
    return dict(protein_xyz=prot,
                esm_feat=rng.randn(nr, 1280).astype(np.float32),
                lig_coords=lig, rdkit_coords=lig,
                lig_feats=rng.randn(n, 56).astype(np.float32),
                bond_edges=np.asarray(bonds), las_mask=las)


def _engine(**kw):
    cfg = preset("fabind", **ENGINE_KW)
    small = dataclasses.replace(cfg.shapes, max_ligand=8, max_pocket=16,
                                max_protein=32)
    return DockingEngine(cfg, buckets=[small, cfg.shapes], batch_size=2,
                         seed=0, **kw)


def _requests():
    # two for the small bucket (8:16:32), two for the large, one too large
    return [_raw(5, 12, 1), _raw(12, 40, 2), _raw(30, 40, 3), _raw(6, 14, 4),
            _raw(14, 44, 5)]


def test_engine_bf16_buckets_against_fp32(cuda):
    """The bf16 engine on the card: requests routed to both buckets (each
    batch padded to its bucket), finite float32 poses within the JAX
    package's bf16-vs-fp32 bound (mean per-atom 0.75 A) of the fp32
    engine's."""
    eng16, eng32 = _engine(), _engine(bf16=False)
    assert eng16.device.type == "cuda" and eng16.dtype == torch.bfloat16
    raws = _requests()
    seen = [(cfg_b.shapes.max_pocket, batch.pocket_mask.shape[1],
             batch.prot_feat.dtype)
            for _, cfg_b, batch, _ in eng16.batches(raws, [None] * 5)]
    assert sorted(seen) == [(16, 16, torch.bfloat16), (24, 24, torch.bfloat16)]
    p16, p32 = eng16.dock_raw(raws), eng32.dock_raw(raws)
    assert p16[2].error is not None and "exceeds every bucket" in p16[2].error
    d = []
    for a, b, raw in zip(p16, p32, raws):
        assert (a.error is None) == (b.error is None)
        if a.error is None:
            assert a.coords.dtype == np.float32
            assert a.coords.shape == raw["lig_coords"].shape
            assert np.isfinite(a.coords).all()
            d.append(np.linalg.norm(a.coords - b.coords, axis=-1))
    assert np.concatenate(d).mean() < 0.75


def test_protein_cache_bit_identical_on_card(cuda):
    eng = _engine(dev_prot_cache=8)
    raws = _requests()
    cold, warm = eng.dock_raw(raws), eng.dock_raw(raws)
    off = _engine(dev_prot_cache=0).dock_raw(raws)
    assert len(eng._dev_prot_rows) == 4
    for c, w, o in zip(cold, warm, off):
        assert c.error == w.error == o.error
        np.testing.assert_array_equal(c.coords, w.coords)
        np.testing.assert_array_equal(c.coords, o.coords)


def test_launch_count_under_threads(cuda):
    """4 threads, one batch each: every launch is counted (4 x 33), and
    the poses are the serial ones."""
    eng = _engine()
    work = [[_raw(5 + i, 14, 10 + i), _raw(6, 12, 20 + i)] for i in range(4)]
    serial = [eng.dock_raw(w) for w in work]
    out = [None] * 4

    def call(i):
        out[i] = eng.dock_raw(work[i])

    threads = [threading.Thread(target=call, args=(i,)) for i in range(4)]
    edge_gate.KERNEL.launches = 0
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    assert edge_gate.KERNEL.launches == 4 * LAUNCHES_PER_BATCH
    for got, want in zip(out, serial):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.coords, w.coords)


def _plus_engine(name, device=None, **kw):
    """FABind+ at toy widths and its released depth (5 layers x 8
    recycles) over the two toy buckets."""
    cfg = preset(name, **ENGINE_KW)
    small = dataclasses.replace(cfg.shapes, max_ligand=8, max_pocket=16,
                                max_protein=32)
    return DockingEngine(cfg, buckets=[small, cfg.shapes], batch_size=2,
                         seed=0, device=device, **kw)


def test_plus_dock_raw_on_card_matches_cpu(cuda):
    """FABind+ dock_raw in fp32 on the card against the same engine on the
    CPU (TF32 off): the same errors and crops, poses within 1e-3 A; no
    edge-gate launch on the card."""
    raws = _requests()
    before = edge_gate.KERNEL.launches
    card = _plus_engine("fabind_plus", bf16=False).dock_raw(raws)
    assert edge_gate.KERNEL.launches == before
    host = _plus_engine("fabind_plus", device="cpu", bf16=False).dock_raw(raws)
    for a, b in zip(card, host):
        assert a.error == b.error
        if a.error is None:
            assert a.pocket_truncated == b.pocket_truncated
            np.testing.assert_allclose(a.coords, b.coords, atol=1e-3, rtol=0)


def test_dock_best_of_seeded_on_card(cuda):
    """bf16 best-of-N on the card: the same seed gives the same poses bit
    for bit, another seed other poses."""
    eng = _plus_engine("fabind_plus_sampling")
    raws = _requests()
    a, b = (eng.dock_best_of(raws, sample_size=4, seed=1) for _ in range(2))
    c = eng.dock_best_of(raws, sample_size=4, seed=2)
    assert a[2].error is not None and "exceeds every bucket" in a[2].error
    diff = []
    for x, y, z in zip(a, b, c):
        assert x.error == y.error == z.error
        if x.error is None:
            assert np.isfinite(x.coords).all()
            np.testing.assert_array_equal(x.coords, y.coords)
            assert x.confidence == y.confidence
            diff.append(np.abs(x.coords - z.coords).max())
    assert max(diff) > 0


# --------------------------------------------------------------- training
def test_pair_kernel_gradients_at_training_shape(cuda):
    """The gate's autograd.Function at the docking shape of a training
    batch (B 8, 48 ligand x 160 pocket, H 512): the kernel forward and the
    plain-VJP backward against autograd through the plain version."""
    args = [t.requires_grad_() for t in _pair_inputs((8, 48, 160, 512),
                                                     torch.float32, cuda)]
    g = torch.Generator().manual_seed(3)
    g_ab = torch.randn(8, 48, 160, generator=g).to(cuda)
    g_ba = torch.randn(8, 160, 48, generator=g).to(cuda)

    def grads(fn):
        ab, ba = fn(*args)
        return torch.autograd.grad((ab * g_ab).sum() + (ba * g_ba).sum(),
                                   args)

    before = edge_gate.KERNEL.launches
    got = grads(phi_rank1_pair)
    assert edge_gate.KERNEL.launches == before + 1
    for a, b in zip(got, grads(phi_rank1_pair_reference)):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-5)


def test_train_step_on_card_matches_cpu(cuda):
    """A dropout-0 fp32 training step (released depth: 4 layers x 8
    recycles, toy widths) on the card against the same step on the CPU:
    the same loss and gradients within 1e-4 + 1e-4 * max|g| per tensor,
    and the gate launched once per attention layer of the forward (33)."""
    from fabind_tpu_torch.data.types import FABindBatch, dummy_arrays
    from fabind_tpu_torch.models.fabind import init_params, make_model
    from fabind_tpu_torch.train.trainer import Trainer, step_generator

    cfg = preset("fabind", **ENGINE_KW, dropout=0.0, random_n_iter=False,
                 stage_prob=0.0)
    model = make_model(cfg)
    init_params(model, torch.Generator().manual_seed(0))
    sd = model.state_dict()
    arrays = dummy_arrays(cfg.shapes, batch_size=2, seed=0, n_lig_valid=12,
                          n_prot_valid=40)
    u = torch.rand(2, cfg.shapes.max_protein, 2,
                   generator=torch.Generator().manual_seed(1)).clamp(min=1e-6)
    res = {}
    for dev in ("cpu", "cuda"):
        tr = Trainer(cfg, dev, state_dict=sd)
        before = edge_gate.KERNEL.launches
        m = tr._forward_loss(FABindBatch.from_numpy(arrays, dev), cfg,
                             step_generator(0, 0, dev), u.to(dev))
        res[dev] = (float(m["loss"].detach()),
                    {n: p.grad.detach().cpu()
                     for n, p in tr.model.named_parameters()
                     if p.grad is not None},
                    edge_gate.KERNEL.launches - before)
    (l_cpu, g_cpu, n_cpu), (l_gpu, g_gpu, n_gpu) = res["cpu"], res["cuda"]
    assert n_cpu == 0 and n_gpu == LAUNCHES_PER_BATCH
    assert abs(l_gpu - l_cpu) <= 1e-4 * abs(l_cpu)
    assert set(g_cpu) == set(g_gpu)
    for n, g in g_cpu.items():
        tol = 1e-4 + 1e-4 * float(g.abs().max())
        assert float((g_gpu[n] - g).abs().max()) <= tol, n


# ------------------------------------------------ evaluation and confidence
def _npz_requests(root, n=5, iso=False):
    """The in-bucket requests of _requests (and more) as an NPZ directory;
    with `iso` each chain ligand carries [identity, reversed]."""
    root.mkdir()
    raws = [_raw(5, 12, 1), _raw(12, 40, 2), _raw(6, 14, 4), _raw(14, 44, 5),
            _raw(9, 30, 6), _raw(7, 20, 7)][:n]
    for i, raw in enumerate(raws):
        extra = {}
        if iso:
            k = raw["lig_coords"].shape[0]
            extra["isomorphisms"] = np.stack(
                [np.arange(k), np.arange(k)[::-1]]).astype(np.int32)
        np.savez(root / f"c{i}.npz", **raw, **extra)
    return str(root)


def _sets(kw):
    out = []
    for k, v in kw.items():
        out += ["--set", f"{k}={v}"]
    return out


def test_evaluate_on_card_matches_cpu(cuda, tmp_path):
    """cli.evaluate (fp32, base, released depth at toy widths, stage 2,
    --post-optim and --distmap-dock) on the card against the CPU: the same
    per-pdb RMSDs within 1e-2 A, the gate launched 33 times per batch on
    the card and never on the CPU."""
    from fabind_tpu_torch.cli import evaluate
    from fabind_tpu_torch.models.fabind import init_params, make_model

    data = _npz_requests(tmp_path / "npz")
    cfg = preset("fabind", **ENGINE_KW)
    model = make_model(cfg)
    init_params(model, torch.Generator().manual_seed(0))
    torch.save(model.state_dict(), tmp_path / "w.bin")
    rows = {}
    for dev in ("cpu", "cuda"):
        before = edge_gate.KERNEL.launches
        m = evaluate.main(["--data", data, "--ckpt", str(tmp_path / "w.bin"),
                           "--batch-size", "2", "--workers", "0",
                           "--post-optim", "--post-optim-steps", "20",
                           "--save-rmsd", str(tmp_path / f"{dev}.txt"),
                           "--device", dev] + _sets(ENGINE_KW))
        n_batches = -(-m["n"] // 2)
        assert edge_gate.KERNEL.launches - before == (
            0 if dev == "cpu" else LAUNCHES_PER_BATCH * n_batches)
        rows[dev] = [line.split() for line in
                     (tmp_path / f"{dev}.txt").read_text().splitlines()]
    assert [r[0] for r in rows["cpu"]] == [r[0] for r in rows["cuda"]]
    for a, b in zip(rows["cpu"], rows["cuda"]):
        assert abs(float(a[1]) - float(b[1])) <= 1e-2, (a, b)
    dock = ["--data", data, "--ckpt", str(tmp_path / "w.bin"),
            "--batch-size", "2", "--workers", "0", "--distmap-dock",
            "--distmap-steps", "200", "--distmap-repeats", "2",
            "--device", "cuda"] + _sets(ENGINE_KW)
    a, b = evaluate.main(dock), evaluate.main(dock)
    a.pop("complexes_per_sec"), b.pop("complexes_per_sec")
    assert a == b and np.isfinite(a["rmsd_mean"])


def test_distance_dock_on_card_matches_cpu(cuda):
    """distance_dock_best_of from the same starts (the smooth L2 mode,
    600 steps) on the card and the CPU: the same winners, poses within
    1e-3 A."""
    from fabind_tpu_torch.postopt import distance_dock_best_of

    g = torch.Generator().manual_seed(0)
    B, Np, Nc, R = 3, 10, 7, 2
    prot = torch.randn(B, Np, 3, generator=g) * 4
    pose = torch.randn(B, Nc, 3, generator=g) * 1.5
    ref = pose + 0.05 * torch.randn(B, Nc, 3, generator=g)
    y = torch.cdist(prot, pose).clamp(max=10.0)
    am = torch.ones(B, Nc, dtype=torch.bool)
    pm = torch.ones(B, Np, dtype=torch.bool)
    las = (torch.ones(Nc, Nc, dtype=torch.bool).triu(1)
           & ~torch.ones(Nc, Nc, dtype=torch.bool).triu(3))
    las = (las | las.T).expand(B, Nc, Nc)
    x0s = pose + 2.0 * torch.randn(R, B, Nc, 3, generator=g)
    out = {}
    for dev in ("cpu", "cuda"):
        best, _, losses = distance_dock_best_of(
            *(t.to(dev) for t in (y, prot, ref, las, am, pm)), n_repeat=R,
            steps=600, mode=1, x0s=x0s.to(dev))
        out[dev] = (best.cpu(), losses.argmin(0).cpu())
    assert torch.equal(out["cpu"][1], out["cuda"][1])
    torch.testing.assert_close(out["cuda"][0], out["cpu"][0], atol=1e-3,
                               rtol=0)


def test_confidence_step_on_card_matches_cpu(cuda):
    """One inference-source confidence step (FABind+ at toy widths, dropout
    0) on the card against the CPU from the same copy inputs: the same
    loss and metrics within 1e-3, the trunk unchanged on the card, no
    gradient in it, no gate launch."""
    from fabind_tpu_torch.data.types import FABindBatch, dummy_arrays
    from fabind_tpu_torch.models.fabind import init_params, make_model
    from fabind_tpu_torch.train import confidence as conf

    cfg = preset("fabind_plus", **ENGINE_KW, dropout=0.0,
                 random_n_iter=False, confidence_training=True, num_copies=3)
    model = make_model(cfg)
    init_params(model, torch.Generator().manual_seed(0))
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    arrays = dummy_arrays(cfg.shapes, batch_size=2, seed=1, n_lig_valid=10,
                          n_prot_valid=40)
    init, cent = conf.sample_copy_inputs(
        model, FABindBatch.from_numpy(arrays, "cpu"), cfg, 3,
        np.random.RandomState(0))
    res = {}
    for dev in ("cpu", "cuda"):
        m = make_model(cfg)
        m.load_state_dict(sd)
        m.to(dev)
        step = conf.make_confidence_train_step(
            m, cfg, conf.build_confidence_optimizer(cfg, m), "inference")
        before = edge_gate.KERNEL.launches
        res[dev] = step(FABindBatch.from_numpy(arrays, dev),
                        torch.Generator().manual_seed(0), init, cent)
        assert edge_gate.KERNEL.launches == before
        for n, p in m.named_parameters():
            if not n.startswith(("ranking", "confidence")):
                assert p.grad is None and torch.equal(p.detach().cpu(),
                                                      sd[n]), n
    for k, v in res["cpu"].items():
        assert abs(res["cuda"][k] - v) <= 1e-3, (k, res["cuda"][k], v)
