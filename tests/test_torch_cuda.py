"""The edge-gate CUDA kernel against its plain PyTorch version, on the card:
its one-direction launch (phi_rank1) and its paired launch over both
attention directions (phi_rank1_pair).

Needs a CUDA device and nvcc; skips elsewhere. The file imports neither JAX
nor the JAX package, so it runs where only PyTorch is installed:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""
import pytest
import torch

from fabind_tpu_torch.ops import edge_gate
from fabind_tpu_torch.ops.edge_gate import (phi_rank1, phi_rank1_pair,
                                            phi_rank1_pair_reference,
                                            phi_rank1_reference)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _inputs(shape, dtype, device, seed=0):
    B, D, N, H = shape
    g = torch.Generator().manual_seed(seed)
    return tuple(torch.randn(*s, generator=g).to(device, dtype)
                 for s in ((B, N, H), (B, D, N), (H,), (H,)))


@pytest.mark.parametrize("act", ["silu", "relu"])
@pytest.mark.parametrize("shape", [(8, 48, 160, 512), (2, 7, 11, 48)])
def test_kernel_matches_plain_fp32(cuda, act, shape):
    args = _inputs(shape, torch.float32, cuda)
    before = edge_gate.KERNEL.launches
    got = phi_rank1(*args, act=act)
    torch.cuda.synchronize()
    assert edge_gate.KERNEL.launches == before + 1
    # the sum over H runs in another order than the plain einsum
    torch.testing.assert_close(got, phi_rank1_reference(*args, act=act),
                               atol=1e-4, rtol=1e-5)


def test_kernel_matches_plain_bf16(cuda):
    args = _inputs((2, 7, 11, 48), torch.bfloat16, cuda)
    got = phi_rank1(*args, act="silu")
    assert got.dtype == torch.bfloat16
    # both compute in fp32 and round once to bf16
    torch.testing.assert_close(got.float(),
                               phi_rank1_reference(*args).float(),
                               atol=1e-2, rtol=1e-2)


def test_kernel_backward_matches_plain(cuda):
    args = [t.requires_grad_() for t in _inputs((1, 5, 9, 16), torch.float32,
                                                cuda)]
    g = torch.randn(1, 5, 9, device=cuda)
    got = torch.autograd.grad(phi_rank1(*args), args, g)
    want = torch.autograd.grad(phi_rank1_reference(*args), args, g)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)


def test_kernel_rejects_bad_input(cuda):
    l1_v, r, u, w2 = _inputs((1, 4, 8, 16), torch.float32, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        phi_rank1(l1_v, r.transpose(1, 2).contiguous().transpose(1, 2),
                  u, w2)
    with pytest.raises(TypeError):
        phi_rank1(l1_v.double(), r.double(), u.double(), w2.double())


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
