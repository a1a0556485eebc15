"""The edge-gate CUDA kernel against its plain PyTorch version, on the card:
its launch over both attention directions (phi_rank1_pair); and the
serving engine on the card (bf16 against fp32, bucket routing, the
protein-row cache, the launch count under threads, the docking stage's
CUDA graphs against eager docking; FABind+ against the CPU, seeded
best-of-N sampling, its dock halves' graphs against eager ones); and a
training step on the card against
the same step on the CPU, with the gate's gradients at a docking training
shape; and the evaluation and confidence paths on the card against the
CPU; and the structure-file path on the card (the ESM2 encoder against
the CPU, dock_sdf); and exported programs served on the card; and the
dropout kernel against its plain version, and an exported sampling
artifact's dock_best_of on the card against the live engine's.

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
from fabind_tpu_torch.utils import tracing

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
    replays = _graph_counts()["serve.graph_replays"]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    assert edge_gate.KERNEL.launches == 4 * LAUNCHES_PER_BATCH
    # every threaded batch replayed its bucket's graphs (graphs.py)
    assert (sum(_graph_counts()["serve.graph_replays"].values())
            - sum(replays.values())) == 4
    for got, want in zip(out, serial):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.coords, w.coords)


def _graph_counts():
    c = tracing.snapshot()["counters"]
    return {k: dict(c.get(k, {})) for k in (
        "serve.graph_captures", "serve.graph_replays", "serve.graph_eager")}


@pytest.mark.parametrize("name,bf16", [("fabind", True), ("fabind", False),
                                       ("fabind_plus", True),
                                       ("fabflex", True)])
def test_graphed_poses_equal_eager_on_card(cuda, name, bf16):
    """The docking stage replayed as CUDA graphs (graphs.py) gives the
    eager engine's poses bit for bit in every bucket, on the first call
    (each bucket's first batch captured, then replayed) and on a second
    (replays only); under replay the base configurations still launch
    the gate 33 times per batch, FABind+ never."""
    cfg = preset(name, **ENGINE_KW)
    small = dataclasses.replace(cfg.shapes, max_ligand=8, max_pocket=16,
                                max_protein=32)
    kw = dict(buckets=[small, cfg.shapes], batch_size=2, seed=0, bf16=bf16)
    raws = _requests() + [_raw(7, 20, 6), _raw(4, 10, 7), _raw(8, 30, 8),
                          _raw(10, 36, 9)]
    eager = DockingEngine(cfg, **kw)
    eager._graphs = None
    want = eager.dock_raw(raws)
    eng = DockingEngine(cfg, **kw)
    assert eng._graphs is not None
    n_batches = len(list(eng.batches(raws, [None] * len(raws))))
    first = eng.dock_raw(raws)
    before = _graph_counts()
    edge_gate.KERNEL.launches = 0
    second = eng.dock_raw(raws)
    after = _graph_counts()
    per_batch = 0 if name == "fabind_plus" else LAUNCHES_PER_BATCH
    assert edge_gate.KERNEL.launches == n_batches * per_batch
    assert eng._graphs.captured == 2
    assert (sum(after["serve.graph_replays"].values())
            - sum(before["serve.graph_replays"].values())) == n_batches
    assert after["serve.graph_captures"] == before["serve.graph_captures"]
    for got in (first, second):
        for g, w in zip(got, want):
            assert g.error == w.error
            if w.error is None:
                np.testing.assert_array_equal(g.coords, w.coords)
                assert g.confidence == w.confidence
                if w.pocket_coords is not None:
                    np.testing.assert_array_equal(g.pocket_coords,
                                                  w.pocket_coords)


RECORDED = ("aten::mm", "aten::addmm", "aten::bmm", "aten::baddbmm",
            "fabind_tpu_torch::edge_gate_pair")


def _recorded(eng, raws):
    """(name, operand shapes, whether it ran on the device) of every
    product and gate call a dock_raw records under the profiler."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as p:
        eng.dock_raw(raws)
        torch.cuda.synchronize()
    n = {"aten::mm": 2, "aten::bmm": 2, "aten::addmm": 3, "aten::baddbmm": 3}
    return [(e.name, [list(s) for s in e.input_shapes[:n.get(e.name, 5)]],
             getattr(e, "self_device_time_total", 0) > 0)
            for e in p.events() if e.name in RECORDED]


@pytest.mark.parametrize("bf16", [True, False])
def test_graphed_products_keep_their_records_on_card(cuda, bf16):
    """Under replay every matrix product and gate call of the eager
    docking stage is still an operator call with its own record, at the
    same shapes and in the same order, with its kernel's device time under
    it wherever the eager call had it, so the rooflines that read those
    records read the same work."""
    raws = _requests() + [_raw(7, 20, 6), _raw(8, 30, 8)]
    eager = _engine(bf16=bf16)
    eager._graphs = None
    eng = _engine(bf16=bf16)
    eager.dock_raw(raws)
    eng.dock_raw(raws)                               # captures
    want, got = _recorded(eager, raws), _recorded(eng, raws)
    assert sum(r[0] == "aten::addmm" for r in want) > 100
    assert [r[:2] for r in got] == [r[:2] for r in want]
    assert sum(r[2] for r in got) >= sum(r[2] for r in want)


def test_graphed_threads_on_their_own_streams(cuda):
    """Threads that each dock under a CUDA stream of their own replay one
    bucket's graphs in turn and still get the poses of serial calls."""
    eng = _engine()
    work = [[_raw(5 + i, 14, 10 + i), _raw(6, 12, 20 + i)] for i in range(4)]
    serial = [eng.dock_raw(w) for w in work]
    out = [None] * 4

    def call(i):
        with torch.cuda.stream(torch.cuda.Stream()):
            out[i] = eng.dock_raw(work[i])
            torch.cuda.current_stream().synchronize()

    replays = _graph_counts()["serve.graph_replays"]
    threads = [threading.Thread(target=call, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    assert (sum(_graph_counts()["serve.graph_replays"].values())
            - sum(replays.values())) == 4
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


DROPOUT_OP = "fabind_tpu_torch::dropout"


def _best_of_records(eng, raws):
    """Under the profiler, a bf16 dock_best_of's (name, operand shapes) of
    every product and dropout call, in order; its dropout calls; the
    dropout kernels the card ran; its product calls with device time under
    them."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as p:
        eng.dock_best_of(raws, sample_size=4, seed=1)
        torch.cuda.synchronize()
    ops = [e for e in p.events() if e.name in RECORDED + (DROPOUT_OP,)]
    kernels = [e for e in p.events()
               if str(e.device_type).endswith("CUDA")
               and "dropout_kernel<" in e.name]
    n = {"aten::mm": 2, "aten::bmm": 2}     # an out= call records out too
    return ([(e.name, [list(s) for s in e.input_shapes[:n.get(e.name, 3)]])
             for e in ops],
            sum(e.name == DROPOUT_OP for e in ops), len(kernels),
            sum(getattr(e, "self_device_time_total", 0) > 0 for e in ops
                if e.name in RECORDED))


def test_graphed_best_of_equals_eager_on_card(cuda):
    """bf16 best-of-N whose dock halves replay each bucket's stochastic
    docking graphs (graphs.py) gives the poses and confidences of the same
    engine with its graphs set aside, bit for bit, on the call that
    captures and on a call that only replays (every dock half a replay);
    under the profiler the replayed passes keep one dropout operator
    record per dropout kernel the card runs and the eager path's product
    calls, in the same order, at the same shapes and with device time
    (all but a few: the profiler's correlation drops one now and then)."""
    raws = _requests() + [_raw(7, 20, 6), _raw(8, 30, 8)]
    eng = _plus_engine("fabind_plus_sampling")
    assert eng._graphs is not None
    n_batches = len(list(eng.batches(raws, [None] * len(raws))))
    first = eng.dock_best_of(raws, sample_size=4, seed=1)
    before = _graph_counts()
    second = eng.dock_best_of(raws, sample_size=4, seed=1)
    after = _graph_counts()
    assert (sum(after["serve.graph_replays"].values())
            - sum(before["serve.graph_replays"].values())) == 4 * n_batches
    assert after["serve.graph_captures"] == before["serve.graph_captures"]
    assert after["serve.graph_eager"] == before["serve.graph_eager"]
    got = _best_of_records(eng, raws)
    held, eng._graphs = eng._graphs, None
    want_poses = eng.dock_best_of(raws, sample_size=4, seed=1)
    want = _best_of_records(eng, raws)
    eng._graphs = held
    for poses in (first, second):
        for g, w in zip(poses, want_poses):
            assert g.error == w.error
            if w.error is None:
                np.testing.assert_array_equal(g.coords, w.coords)
                assert g.confidence == w.confidence
    assert got[0] == want[0]
    assert got[1] == got[2] == want[1] == want[2] > 0
    assert got[3] >= 0.99 * want[3] > 0


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


# --------------------------------------------------------- structure files
def _esm(cfg, seed=0):
    from fabind_tpu_torch.models.esm2 import Esm2Model
    torch.manual_seed(seed)
    model = Esm2Model(cfg)
    with torch.no_grad():
        model.embeddings.word_embeddings.weight.normal_(0, 1.0)
    return model.eval()


def test_esm2_on_card_matches_cpu(cuda):
    """The encoder in fp32 on the card (TF32 off) against the same weights
    on the CPU over ragged lengths in two buckets, batched and alone."""
    from fabind_tpu_torch.cli.common import resolve_device
    from fabind_tpu_torch.models.esm2 import Esm2Config
    resolve_device("cuda", "test")        # TF32 off, as the entry points
    seqs = ["LAGVSERTILKQNFAMWYHD" * k for k in (1, 4, 9)] + ["MKV"]
    model = _esm(Esm2Config(hidden_size=320, num_layers=4, num_heads=20,
                            intermediate_size=1280))
    want = model.embed_sequences(seqs, pad_multiple=64, batch_size=2)
    card = model.to(cuda)
    got = card.embed_sequences(seqs, pad_multiple=64, batch_size=2)
    alone = card.embed_sequences(seqs[1:2], pad_multiple=64)[0]
    for g, w in zip(got, want):
        assert g.shape == w.shape and np.isfinite(g).all()
        np.testing.assert_allclose(g, w, atol=1e-4, rtol=0)
    np.testing.assert_allclose(alone, got[1], atol=1e-4, rtol=0)


def test_dock_sdf_on_card(cuda, tmp_path):
    """dock_sdf on the card from PDB and SDF files: bf16 over two buckets
    with 33 gate launches per batch and finite poses, a second call
    without an ESM2 forward and equal poses; fp32 on the card within 1e-3
    A of the same engine on the CPU."""
    from chip_smoke import ligand_with_hydrogens, pdb_text
    from fabind_tpu_torch.data.featurize import write_sdf
    from fabind_tpu_torch.models.esm2 import Esm2Config
    rng = np.random.RandomState(3)
    pairs = []
    for i, raw in enumerate(_requests()):
        seq = "".join(rng.choice(list("ACDEFGHIKLMNPQRSTVWY"),
                                 len(raw["protein_xyz"])))
        (tmp_path / f"p{i}.pdb").write_text(pdb_text(seq,
                                                     raw["protein_xyz"]))
        n = len(raw["lig_coords"])
        symbols, coords, bonds = ligand_with_hydrogens(
            rng, raw["lig_coords"], n_rings=1 if n >= 6 else 0)
        write_sdf(str(tmp_path / f"l{i}.sdf"), symbols, coords, bonds)
        pairs.append((str(tmp_path / f"l{i}.sdf"),
                      str(tmp_path / f"p{i}.pdb")))
    esm_cfg = Esm2Config(num_layers=1, intermediate_size=64)
    eng = _engine(esm=_esm(esm_cfg))
    edge_gate.KERNEL.launches = 0
    poses = eng.dock_sdf(pairs)
    assert edge_gate.KERNEL.launches == 2 * LAUNCHES_PER_BATCH
    assert poses[2].error is not None and "exceeds every bucket" in \
        poses[2].error
    calls = []
    embed = eng.esm.embed_sequences
    eng.esm.embed_sequences = lambda *a, **k: calls.append(1) or embed(*a,
                                                                      **k)
    again = eng.dock_sdf(pairs)
    assert calls == []
    for p, q in zip(poses, again):
        assert p.error == q.error
        if p.error is None:
            assert np.isfinite(p.coords).all() and p.sdf_meta is not None
            np.testing.assert_array_equal(p.coords, q.coords)
    card = _engine(esm=_esm(esm_cfg), bf16=False).dock_sdf(pairs)
    host = _engine(esm=_esm(esm_cfg), bf16=False,
                   device="cpu").dock_sdf(pairs)
    for a, b in zip(card, host):
        assert a.error == b.error
        if a.error is None:
            np.testing.assert_allclose(a.coords, b.coords, atol=1e-3, rtol=0)


def test_exported_engine_on_card_matches_live(cuda, tmp_path):
    """The bf16 small bucket exported on the card (aot.export_inference at
    the released depth) and served by DockingEngine.from_exported: no
    model built, the gate kernel launched through the registered operator
    33 times per batch, poses equal to the live engine's bit for bit; the
    same bucket exported on the CPU and served on the card gives them too."""
    from fabind_tpu_torch.aot import export_inference
    from fabind_tpu_torch.models.fabind import init_params, make_model

    cfg = preset("fabind", **dict(ENGINE_KW, max_ligand=8, max_pocket=16,
                                  max_protein=32))
    model = make_model(cfg)
    init_params(model, torch.Generator().manual_seed(0))
    raws = [_raw(5, 12, 1), _raw(6, 14, 4), _raw(7, 20, 6)]
    live = DockingEngine(cfg, batch_size=2, seed=0).dock_raw(raws)
    for device in ("cuda", "cpu"):
        out = str(tmp_path / device)
        export_inference(cfg, model.state_dict(), out, batch_size=2,
                         device=device)
        eng = DockingEngine.from_exported(out)
        assert eng.model is None and eng.device.type == "cuda"
        edge_gate.KERNEL.launches = 0
        got = eng.dock_raw(raws)
        assert edge_gate.KERNEL.launches == 2 * LAUNCHES_PER_BATCH
        for g, w in zip(got, live):
            assert g.error is None
            np.testing.assert_array_equal(g.coords, w.coords)


# ---------------------------------------------------------------- dropout
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,rate", [(8 * 161 * 49 * 32, 0.1), (4099, 0.5)])
def test_dropout_kernel_matches_plain(cuda, dtype, n, rate):
    """The kernel's masks and values equal the plain version's bit for bit,
    on the card and on the CPU, a ragged length included; its Philox gives
    Random123's known answers; its gradient is grad x mask x scale."""
    from fabind_tpu_torch.ops import dropout as D

    rows = np.array([[0] * 6, [0xFFFFFFFF] * 6,
                     [0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344,
                      0xA4093822, 0x299F31D0]], np.uint32)
    want = [D.philox4x32_10(r[:4].tolist(), r[4:].tolist()) for r in rows]
    np.testing.assert_array_equal(D.philox_on_device(rows),
                                  np.array(want, np.uint32))
    x = torch.randn(n, generator=torch.Generator().manual_seed(0)).to(dtype)
    seed, rnd = torch.tensor(-5, device=cuda), torch.tensor(3, device=cuda)
    D.KERNEL.launches = 0
    got = D.dropout(x.to(cuda), seed, rnd, 17, 2, rate)
    assert D.KERNEL.launches == 1
    plain = D.dropout_reference(x.to(cuda), seed, rnd, 17, 2, rate)
    host = D.dropout(x, seed.cpu(), rnd.cpu(), 17, 2, rate)
    assert torch.equal(got, plain) and torch.equal(got.cpu(), host)
    xg = x.to(cuda).requires_grad_()
    g = torch.randn(n, device=cuda).to(dtype)
    (gx,) = torch.autograd.grad(D.dropout(xg, seed, rnd, 17, 2, rate), xg, g)
    assert torch.equal(gx, D.dropout_reference(g, seed, rnd, 17, 2, rate))


def test_sampling_artifact_from_cpu_on_card_matches_live(cuda, tmp_path):
    """A sampling artifact exported on the CPU (fp32 weights, bf16 cast) and
    served on the card: dock_best_of equals the live card engine's bit for
    bit for the same seed, through the dropout kernel."""
    from fabind_tpu_torch.aot import export_inference
    from fabind_tpu_torch.models.fabind import init_params, make_model
    from fabind_tpu_torch.ops import dropout as D

    cfg = preset("fabind_plus_sampling", **dict(
        ENGINE_KW, max_ligand=8, max_pocket=16, max_protein=32,
        mean_layers=1, n_iter=3))
    model = make_model(cfg)
    init_params(model, torch.Generator().manual_seed(0))
    raws = [_raw(5, 12, 1), _raw(6, 14, 4), _raw(7, 20, 6)]
    live = DockingEngine(cfg, state_dict=model.state_dict(), batch_size=2)
    want = live.dock_best_of(raws, sample_size=3, seed=4)
    export_inference(cfg, model.state_dict(), str(tmp_path), batch_size=2,
                     device="cpu", sampling=True)
    eng = DockingEngine.from_exported(str(tmp_path))
    D.KERNEL.launches = 0
    got = eng.dock_best_of(raws, sample_size=3, seed=4)
    assert D.KERNEL.launches > 0
    for g, w in zip(got, want):
        assert g.error is None and np.isfinite(g.coords).all()
        np.testing.assert_array_equal(g.coords, w.coords)
        assert g.confidence == w.confidence


# ------------------------------------------------------ flexible docking
def test_fabflex_engine_on_card(cuda):
    """A bf16 fabflex engine (released depth: 4 layers x 8 recycles) over
    the two toy buckets launches the gate 33 times per batch; every pose
    carries a finite docked pocket, one residue index per coordinate row,
    within the request's protein; the pocket moved in fp32, and the fp32
    card pockets equal the CPU's within 1e-3 A."""
    cfg = preset("fabflex", **ENGINE_KW)
    small = dataclasses.replace(cfg.shapes, max_ligand=8, max_pocket=16,
                                max_protein=32)
    raws = _requests()
    eng = DockingEngine(cfg, buckets=[small, cfg.shapes], batch_size=2,
                        seed=0)
    n_batches = len(list(eng.batches(raws, [None] * len(raws))))
    edge_gate.KERNEL.launches = 0
    poses = eng.dock_raw(raws)
    assert edge_gate.KERNEL.launches == n_batches * LAUNCHES_PER_BATCH
    for p, raw in zip(poses, raws):
        if p.error is not None:
            assert "exceeds every bucket" in p.error
            continue
        assert p.pocket_coords.dtype == np.float32
        assert np.isfinite(p.pocket_coords).all()
        assert len(p.pocket_coords) == len(p.pocket_residues) > 0
        assert p.pocket_residues.max() < len(raw["protein_xyz"])

    kw = dict(buckets=[small, cfg.shapes], batch_size=2, seed=0,
              bf16=False)
    card32 = DockingEngine(cfg, **kw).dock_raw(raws)
    cpu32 = DockingEngine(cfg, device="cpu", **kw).dock_raw(raws)
    moved = 0.0
    for g, w, raw in zip(card32, cpu32, raws):
        if w.error is not None:
            continue
        np.testing.assert_array_equal(g.pocket_residues, w.pocket_residues)
        np.testing.assert_allclose(g.pocket_coords, w.pocket_coords,
                                   atol=1e-3)
        np.testing.assert_allclose(g.coords, w.coords, atol=1e-3)
        moved = max(moved, float(np.abs(
            g.pocket_coords - raw["protein_xyz"][g.pocket_residues]).max()))
    assert moved > 1e-4


# ---------------------------------------------------- data parallelism
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(8, 162, 33, 41), (6, 1025), (4, 7, 3)])
def test_row_mapped_dropout_kernel_matches_plain_and_rows(cuda, dtype, shape):
    """The mapped kernel (rows of R elements, R not a multiple of 4 in
    every case) equals its plain version bit for bit, and a part's masks
    equal the whole tensor's at its rows: (N, r) strided rows and (1,
    start) blocks. Each launch counts once, under the variant "rows"."""
    from fabind_tpu_torch.ops import dropout as D

    g = torch.Generator().manual_seed(1)
    x = (torch.rand(shape, generator=g) * 4 - 2).to(dtype).to(cuda)
    seed, rnd = torch.tensor(-7, device=cuda), torch.tensor(2, device=cuda)
    full = D.dropout(x, seed, rnd, 5, 1, 0.3)
    B = shape[0]
    for world in (2, 4):
        if B % world:
            continue
        k = B // world
        for r in range(world):
            D.KERNEL.variants.clear()
            part = D.dropout(x[r::world].contiguous(), seed, rnd, 5, 1, 0.3,
                             world, r)
            assert D.KERNEL.variants == {"rows": 1}
            assert torch.equal(part, full[r::world])
            assert torch.equal(part, D.dropout_reference(
                x[r::world].contiguous(), seed, rnd, 5, 1, 0.3, world, r))
            block = D.dropout(x[r * k:(r + 1) * k].contiguous(), seed, rnd,
                              5, 1, 0.3, 1, r * k)
            assert torch.equal(block, full[r * k:(r + 1) * k])


def test_replica_engine_on_card_matches_one(cuda):
    """Two replicas on cuda:0 (device list) serve fp32 poses within 1e-3 A
    of one replica's, with 33 gate launches per replica block."""
    raws = _requests()
    one = _engine(bf16=False)
    two = _engine(bf16=False, device=["cuda:0", "cuda:0"])
    n_batches = len(list(two.batches(raws, [None] * len(raws))))
    want = one.dock_raw(raws)
    edge_gate.KERNEL.launches = 0
    got = two.dock_raw(raws)
    assert edge_gate.KERNEL.launches == 2 * n_batches * LAUNCHES_PER_BATCH
    for g, w in zip(got, want):
        assert (g.error is None) == (w.error is None)
        if w.error is None:
            np.testing.assert_allclose(g.coords, w.coords, atol=1e-3)
