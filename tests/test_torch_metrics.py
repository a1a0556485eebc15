"""The port's evaluation metrics and FABindBatch shape properties against
the JAX package's, on the CPU, on seeded inputs.

Both sides run the same numpy arithmetic, so the metrics are held within
1e-12 (relative) and the properties exactly. The AUROC is the one
deviation: the JAX package takes it from scikit-learn, the port computes
the rank statistic itself; the two agree within 1e-12, ties included. The
JAX package leaves the key out where scikit-learn raises (an unmasked
[B, I, J] map); the port reports it whenever both classes are present.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch
from sklearn.metrics import roc_auc_score

from fabind_tpu.config import preset as jax_preset
from fabind_tpu.data.batching import build_sample as jax_build_sample
from fabind_tpu.data.batching import collate as jax_collate
from fabind_tpu.utils import metrics as J

from fabind_tpu_torch.config import preset
from fabind_tpu_torch.data.batching import build_sample, collate
from fabind_tpu_torch.data.types import FABindBatch
from fabind_tpu_torch.utils import metrics as M

from tests.test_data import make_raw

RTOL = 1e-12


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's torch work: its tensors are
    toy-sized, and the suite runs in parallel workers that would otherwise
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def assert_same_dict(got: dict, want: dict):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=0,
                                   err_msg=k)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pocket_cls_accuracy_and_kabsch_rmsd(seed):
    rng = np.random.RandomState(seed)
    logits = rng.randn(6, 20)
    labels = (rng.rand(6, 20) < 0.5).astype(np.float32)
    labels[:2] = logits[:2] > 0           # two rows fully correct
    mask = rng.rand(6, 20) < 0.8
    assert M.pocket_cls_accuracy(logits, labels, mask) == \
        J.pocket_cls_accuracy(logits, labels, mask)
    assert M.pocket_cls_accuracy(torch.from_numpy(logits),
                                 torch.from_numpy(labels),
                                 torch.from_numpy(mask)) == \
        J.pocket_cls_accuracy(logits, labels, mask)

    true = rng.randn(12, 3) * 3
    q, _ = np.linalg.qr(rng.randn(3, 3))
    for rot in (q, -q):                   # a rotation and a reflection
        pred = true @ rot.T + rng.randn(3) + 0.2 * rng.randn(12, 3)
        want = J.kabsch_rmsd(pred, true)
        np.testing.assert_allclose(M.kabsch_rmsd(pred, true), want,
                                   rtol=RTOL)
        np.testing.assert_allclose(M.kabsch_rmsd(torch.from_numpy(pred),
                                                 torch.from_numpy(true)),
                                   want, rtol=RTOL)


def assert_contact_metrics(got: dict, y_pred, y_true, mask, prefix):
    """The JAX package's keys and values, and the AUROC against
    scikit-learn's on the same (masked, flattened) entries. JAX has the
    AUROC only where scikit-learn accepted its arrays: with a mask (1-D
    after masking); an unmasked [B, I, J] map makes roc_auc_score raise,
    and JAX drops the key. The port reports it in both cases."""
    want = J.contact_cls_metrics(y_pred, y_true, mask, prefix=prefix)
    key = f"{prefix}_auroc"
    assert (key in want) == (mask is not None)
    sel = np.ones(y_true.shape, bool) if mask is None else mask
    auroc = roc_auc_score(y_true[sel] < 8.0, -y_pred[sel])
    want[key] = want.get(key, auroc)
    np.testing.assert_allclose(want[key], auroc, rtol=RTOL)
    assert_same_dict(got, want)


@pytest.mark.parametrize("seed,masked", [(0, False), (1, True), (2, True)])
def test_contact_cls_metrics_with_tied_scores(seed, masked):
    """Distances rounded to 0.5 A tie many scores across both classes."""
    rng = np.random.RandomState(seed)
    y_true = rng.rand(4, 15, 30) * 16
    y_pred = np.round((y_true + 3 * rng.randn(*y_true.shape)) * 2) / 2
    mask = rng.rand(*y_true.shape) < 0.7 if masked else None
    assert_contact_metrics(M.contact_cls_metrics(y_pred, y_true, mask),
                           y_pred, y_true, mask, "contact")
    got = M.contact_cls_metrics(
        torch.from_numpy(y_pred), torch.from_numpy(y_true),
        None if mask is None else torch.from_numpy(mask), prefix="c")
    assert_contact_metrics(got, y_pred, y_true, mask, "c")
    # one class only: neither package reports an AUROC
    far = y_true + 20
    assert "contact_auroc" not in M.contact_cls_metrics(y_pred, far, mask)
    assert_same_dict(M.contact_cls_metrics(y_pred, far, mask),
                     J.contact_cls_metrics(y_pred, far, mask))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_roc_auc_equals_sklearn(seed):
    rng = np.random.RandomState(seed)
    n = int(rng.randint(2, 300))
    labels = rng.rand(n) < rng.uniform(0.05, 0.95)
    labels[:2] = [True, False]
    scores = np.round(rng.randn(n) + labels, int(rng.randint(0, 3)))
    np.testing.assert_allclose(M.roc_auc(labels, scores),
                               roc_auc_score(labels, scores), rtol=RTOL)
    assert M.roc_auc([True, False, True], [0.5, 0.5, 0.5]) == 0.5


@pytest.mark.parametrize("n", [1, 2, 17])
def test_affinity_metrics(n):
    rng = np.random.RandomState(n)
    true = rng.randn(n) * 2 + 6
    pred = true + rng.randn(n)
    assert_same_dict(M.affinity_metrics(pred, true),
                     J.affinity_metrics(pred, true))
    assert_same_dict(M.affinity_metrics(torch.from_numpy(pred),
                                        torch.from_numpy(true), "a"),
                     J.affinity_metrics(pred, true, "a"))


def test_batch_shape_properties():
    kw = dict(max_ligand=16, max_pocket=32, max_protein=40, bond_k=4)
    rng_p, rng_j = np.random.RandomState(0), np.random.RandomState(0)
    raws = [make_raw(seed=i) for i in range(2)]
    port = FABindBatch.from_numpy(collate([build_sample(
        r, preset("fabind", **kw), group="train", rng=rng_p)
        for r in raws], preset("fabind", **kw)), "cpu")
    jcfg = jax_preset("fabind", **kw)
    jax_batch = jax_collate([jax_build_sample(r, jcfg, group="train",
                                              rng=rng_j) for r in raws],
                            jcfg)
    for name in ("batch_size", "n_lig", "n_pocket", "n_protein"):
        assert getattr(port, name) == getattr(jax_batch, name), name
    assert (port.n_lig, port.n_pocket, port.n_protein) == (16, 32, 40)
