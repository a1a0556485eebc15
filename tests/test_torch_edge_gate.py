"""The port's edge gate (fabind_tpu_torch/ops/edge_gate.py) against the JAX
package's, on the CPU.

On the CPU `phi_rank1_pair` is the plain PyTorch version; it and the
one-direction plain version are held to the JAX reference (the pair to two
calls of it) and to the Pallas kernel run in interpret mode, as tests/test_pallas_edge_gate.py runs
it. The CUDA kernel itself is held to the
plain version on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""
import operator

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fabind_tpu.ops.pallas.edge_gate import (phi_rank1_pallas,
                                             phi_rank1_reference as jax_ref)

from fabind_tpu_torch.ops import edge_gate
from fabind_tpu_torch.ops.edge_gate import (check_inputs, phi_rank1_pair,
                                            phi_rank1_pair_reference,
                                            phi_rank1_pair_vjp,
                                            phi_rank1_reference,
                                            phi_rank1_vjp)

ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's torch work: its tensors are
    toy-sized, and the suite runs in parallel workers that would otherwise
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed, B=2, D=13, N=21, H=48):
    rng = np.random.RandomState(seed)
    return tuple(rng.randn(*s).astype(np.float32)
                 for s in ((B, N, H), (B, D, N), (H,), (H,)))


@pytest.mark.parametrize("act", ["silu", "relu"])
@pytest.mark.parametrize("D", [13, 7])
def test_plain_matches_jax_reference_and_pallas(act, D):
    args = _inputs(0, D=D, N=11 if D == 7 else 21)
    want = np.asarray(jax_ref(*map(jnp.asarray, args), act=act))
    pallas = np.asarray(phi_rank1_pallas(*map(jnp.asarray, args), act=act,
                                         block_d=4, interpret=True))
    got = phi_rank1_reference(*map(torch.from_numpy, args), act=act).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    np.testing.assert_allclose(got, pallas, atol=ATOL, rtol=0)


@pytest.mark.parametrize("act", ["silu", "relu"])
def test_gradient_matches_jax_grad(act):
    """The autograd backward (phi_rank1_vjp, the VJP of the plain version)
    against jax.grad of the JAX reference."""
    args = _inputs(2, B=1, D=5, N=9, H=16)
    g = np.random.RandomState(3).randn(1, 5, 9).astype(np.float32)

    want = jax.vjp(lambda *a: jax_ref(*a, act=act),
                   *map(jnp.asarray, args))[1](jnp.asarray(g))
    got = phi_rank1_vjp(*map(torch.from_numpy, args), act,
                        torch.from_numpy(g))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL,
                                   rtol=1e-5)
    # autograd through the plain version gives the same gradients
    targs = [torch.from_numpy(a).requires_grad_() for a in args]
    (phi_rank1_reference(*targs, act=act)
     * torch.from_numpy(g)).sum().backward()
    for t, b in zip(targs, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(b), atol=ATOL,
                                   rtol=1e-5)


def test_mlpblock_rank1_matches_materialized():
    """MLPBlock.finish_scalar_rank1_pair (the model's entry to the gate)
    equals materializing both directions' pre-activations and calling
    finish_scalar; r may be strided."""
    from fabind_tpu_torch.models.layers import MLPBlock

    H = 24
    torch.manual_seed(0)
    mlp = MLPBlock(H, H, 1, act="silu", bias_out=False,
                   sequential_names=True).eval()
    l1_v, r, u, _ = map(torch.from_numpy, _inputs(4, B=2, D=6, N=10, H=H))
    l1_d = torch.from_numpy(_inputs(5, B=2, N=6, H=H)[0])
    r_strided = r.transpose(1, 2).contiguous().transpose(1, 2)
    with torch.no_grad():
        ab, ba = mlp.finish_scalar_rank1_pair(l1_d, l1_v, r_strided, u)
        want_ab = mlp.finish_scalar(l1_v[:, None] + r[..., None] * u)
        want_ba = mlp.finish_scalar(l1_d[:, None]
                                    + r.transpose(1, 2)[..., None] * u)
    torch.testing.assert_close(ab, want_ab, atol=ATOL, rtol=1e-5)
    torch.testing.assert_close(ba, want_ba, atol=ATOL, rtol=1e-5)

def _pair_inputs(seed, B=2, Na=7, Nb=11, H=40):
    rng = np.random.RandomState(seed)
    return tuple(rng.randn(*s).astype(np.float32)
                 for s in ((B, Na, H), (B, Nb, H), (B, Na, Nb), (H,), (H,)))


@pytest.mark.parametrize("act", ["silu", "relu"])
@pytest.mark.parametrize("Na,Nb", [(7, 11), (13, 5)])
def test_pair_plain_matches_two_jax_calls_and_pallas(act, Na, Nb):
    """Both directions of one r: phi_ab is the JAX gate over (l1_b, r),
    phi_ba the JAX gate over (l1_a, r transposed)."""
    l1_a, l1_b, r, u, w2 = _pair_inputs(5, Na=Na, Nb=Nb)
    got = phi_rank1_pair_reference(*map(torch.from_numpy,
                                        (l1_a, l1_b, r, u, w2)), act=act)
    for g, (l1, rr) in zip(got, ((l1_b, r), (l1_a, r.transpose(0, 2, 1)))):
        jargs = tuple(map(jnp.asarray, (l1, rr, u, w2)))
        want = np.asarray(jax_ref(*jargs, act=act))
        pallas = np.asarray(phi_rank1_pallas(*jargs, act=act, block_d=4,
                                             interpret=True))
        np.testing.assert_allclose(g.numpy(), want, atol=ATOL, rtol=0)
        np.testing.assert_allclose(g.numpy(), pallas, atol=ATOL, rtol=0)


def test_pair_wrapper_takes_plain_version_on_cpu():
    args = tuple(map(torch.from_numpy, _pair_inputs(6)))
    before = edge_gate.KERNEL.launches
    got = phi_rank1_pair(*args, act="relu")
    assert edge_gate.KERNEL.launches == before
    for g, w in zip(got, phi_rank1_pair_reference(*args, act="relu")):
        torch.testing.assert_close(g, w, atol=0, rtol=0)
    with pytest.raises(ValueError):
        phi_rank1_pair(*args, act="gelu")


@pytest.mark.parametrize("act", ["silu", "relu"])
def test_pair_gradient_matches_jax_vjp(act):
    """The pair's backward (phi_rank1_pair_vjp, two plain VJPs) against
    jax.vjp of the two JAX reference calls over one r."""
    args = _pair_inputs(7, B=1, Na=5, Nb=9, H=16)
    rng = np.random.RandomState(8)
    g_ab = rng.randn(1, 5, 9).astype(np.float32)
    g_ba = rng.randn(1, 9, 5).astype(np.float32)

    def jax_pair(l1_a, l1_b, r, u, w2):
        return (jax_ref(l1_b, r, u, w2, act=act),
                jax_ref(l1_a, r.transpose(0, 2, 1), u, w2, act=act))

    want = jax.vjp(jax_pair, *map(jnp.asarray, args))[1](
        (jnp.asarray(g_ab), jnp.asarray(g_ba)))
    got = phi_rank1_pair_vjp(*map(torch.from_numpy, args), act,
                             torch.from_numpy(g_ab), torch.from_numpy(g_ba))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL,
                                   rtol=1e-5)


def test_mlpblock_rank1_pair_relu_bias():
    """finish_scalar_rank1_pair with relu and an output bias (the FABind+
    coord MLP's act) against materializing both directions."""
    from fabind_tpu_torch.models.layers import MLPBlock

    H = 24
    torch.manual_seed(1)
    mlp = MLPBlock(H, H, 1, act="relu", bias_out=True).eval()
    l1_a, l1_b, r, u, _ = map(torch.from_numpy,
                              _pair_inputs(9, B=2, Na=6, Nb=10, H=H))
    with torch.no_grad():
        ab, ba = mlp.finish_scalar_rank1_pair(l1_a, l1_b, r, u)
        want_ab = mlp.finish_scalar(l1_b[:, None] + r[..., None] * u)
        want_ba = mlp.finish_scalar(l1_a[:, None]
                                    + r.transpose(1, 2)[..., None] * u)
    torch.testing.assert_close(ab, want_ab, atol=ATOL, rtol=1e-5)
    torch.testing.assert_close(ba, want_ba, atol=ATOL, rtol=1e-5)

def test_check_inputs():
    """The wrapper's checks before a launch: dims back for good input, a
    ValueError or TypeError for what the kernel does not take."""
    l1_a, l1_b, r, u, w2 = map(torch.from_numpy, _pair_inputs(10))
    assert check_inputs(l1_a, l1_b, r, u, w2) == (2, 7, 11, 40)
    with pytest.raises(ValueError, match="shape mismatch"):
        check_inputs(l1_b, l1_a, r, u, w2)
    with pytest.raises(ValueError, match="contiguous"):
        check_inputs(l1_a, l1_b, r.transpose(1, 2).contiguous()
                     .transpose(1, 2), u, w2)
    with pytest.raises(TypeError):
        check_inputs(l1_a.double(), l1_b, r, u, w2)
    big = torch.zeros(1, 1, edge_gate.MAX_H + 1)
    with pytest.raises(ValueError, match="exceeds"):
        check_inputs(big, big, torch.zeros(1, 1, 1), big[0, 0], big[0, 0])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("grad", [False, True])
def test_registered_operator_opcheck(dtype, grad):
    """torch.library.opcheck of the gate's operator on CPU tensors: its
    schema, its fake implementation (shapes, dtype and strides of the
    outputs, what torch.export traces with), its autograd registration and
    an AOT-dispatch trace."""
    args = [t.to(dtype).requires_grad_(grad)
            for t in map(torch.from_numpy, _pair_inputs(11, H=16))]
    torch.library.opcheck(edge_gate.edge_gate_pair, (*args, "silu"))


def test_wrapper_is_the_registered_operator():
    """phi_rank1_pair dispatches through the operator (the device choice is
    the dispatcher's), so a traced program records one call per launch."""
    args = tuple(map(torch.from_numpy, _pair_inputs(12)))
    for act in ("silu", "relu"):
        got = torch.ops.fabind_tpu_torch.edge_gate_pair(*args, act)
        for g, w in zip(got, phi_rank1_pair(*args, act=act)):
            torch.testing.assert_close(g, w, atol=0, rtol=0)
    ep = torch.export.export(_PairModule(), args, strict=False)
    assert [n.target for n in ep.graph.nodes if n.op == "call_function"
            and n.target is not operator.getitem] \
        == [torch.ops.fabind_tpu_torch.edge_gate_pair.default]


class _PairModule(torch.nn.Module):
    def forward(self, *args):
        return phi_rank1_pair(*args, act="silu")
