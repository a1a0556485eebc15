"""The port's automorphism enumeration (data/isomorphism.py, an own VF2)
against the JAX package's networkx VF2, on the CPU: the same permutations
in the same ORDER (the collator keeps only the first max_iso for the
permutation loss), on benzene, tert-butyl and hypothesis-drawn labelled
graphs (self loops, repeated edges, edge labels), with max_iso 2, 8 and
None; HARD_ISO_LIMIT, the timeout and the truncation warning as in JAX;
and the port running with networkx unimportable. Every comparison is exact
(integer arrays)."""
from __future__ import annotations

import sys
import threading
import time
import warnings

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from fabind_tpu.data import isomorphism as J
from fabind_tpu.data.featurize import atom_property_prediction_feature

from fabind_tpu_torch.data import isomorphism as P

MAX_ISOS = [2, 8, None]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's torch work (the suite runs in
    parallel workers that would otherwise oversubscribe the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _both(n, edges, labels, edge_labels=None, max_iso=8):
    """(port, JAX) automorphisms_from_graph, warnings silenced."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return (P.automorphisms_from_graph(n, edges, labels, edge_labels,
                                           max_iso),
                J.automorphisms_from_graph(n, edges, labels, edge_labels,
                                           max_iso))


def _directed(edges):
    return np.asarray([e for i, j in edges for e in ((i, j), (j, i))],
                      np.int64)


def _molecules():
    """(name, n, undirected edges, reference labels) of benzene and
    tert-butanol (a tert-butyl on an O), labels from the port's and JAX's
    iso_labels_from_arrays, which must agree."""
    out = []
    for name, symbols, edges, order in (
            ("benzene", ["C"] * 6, [(i, (i + 1) % 6) for i in range(6)], 1.5),
            ("tert-butyl", ["C", "C", "C", "C", "O"],
             [(0, 1), (0, 2), (0, 3), (0, 4)], 1.0)):
        feats = np.stack([atom_property_prediction_feature(
            s, 0, 0, 0, 0, False) for s in symbols])
        d = _directed(edges)
        orders = np.full(len(d), order, np.float32)
        labels = P.iso_labels_from_arrays(feats, d, orders)
        np.testing.assert_array_equal(
            labels, J.iso_labels_from_arrays(feats, d, orders))
        out.append((name, len(symbols), edges, labels))
    return out


@pytest.mark.parametrize("max_iso", MAX_ISOS)
@pytest.mark.parametrize("mol", _molecules(), ids=lambda m: m[0])
def test_molecules_equal_jax_in_order(mol, max_iso):
    name, n, edges, labels = mol
    got, want = _both(n, edges, labels, max_iso=max_iso)
    np.testing.assert_array_equal(got, want)
    full = {"benzene": 12, "tert-butyl": 6}[name]
    assert len(got) == (full if max_iso is None else min(max_iso, full))
    assert (got[0] == np.arange(n)).all()


@st.composite
def _graphs(draw):
    n = draw(st.integers(1, 9))
    edges = draw(st.lists(st.tuples(st.integers(0, n - 1),
                                    st.integers(0, n - 1)), max_size=2 * n))
    labels = draw(st.lists(st.integers(0, 2), min_size=n, max_size=n))
    edge_labels = draw(st.none() | st.lists(
        st.integers(0, 1), min_size=len(edges), max_size=len(edges)))
    return n, edges, labels, edge_labels


@settings(max_examples=60, deadline=None)
@given(_graphs())
def test_drawn_graphs_equal_jax_in_order(graph):
    n, edges, labels, edge_labels = graph
    for max_iso in MAX_ISOS:
        got, want = _both(n, edges, labels, edge_labels, max_iso)
        np.testing.assert_array_equal(got, want)


def test_hard_limit_warning_and_labels_as_jax():
    """A star of 9 equal leaves has 9! automorphisms: both stop at
    HARD_ISO_LIMIT with the same first 4096, truncated, and warn; the full
    group of benzene does not warn."""
    assert P.HARD_ISO_LIMIT == J.HARD_ISO_LIMIT == 4096
    edges = [(0, i) for i in range(1, 10)]
    labels = [616] + [604] * 9
    got, trunc = P.enumerate_automorphisms(10, edges, labels)
    want, jtrunc = J.enumerate_automorphisms(10, edges, labels)
    assert trunc and jtrunc and len(got) == P.HARD_ISO_LIMIT
    np.testing.assert_array_equal(got, want)
    with pytest.warns(UserWarning, match="truncated at 4096 for a 10-atom"):
        P.automorphisms_from_graph(10, edges, labels, max_iso=None)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        P.automorphisms_from_graph(6, [(i, (i + 1) % 6) for i in range(6)],
                                   [600] * 6, max_iso=None)
    np.testing.assert_array_equal(P._VOCAB_ATOMIC_NUM, J._VOCAB_ATOMIC_NUM)
    for order in (1.0, 1.5, 2.0, 3.0, 0.0, 4.0):
        assert (P.ref_bond_index_from_order(order)
                == J.ref_bond_index_from_order(order))


@pytest.mark.parametrize("main_thread", [True, False])
def test_timeout_bounds_enumeration(main_thread):
    """11! automorphisms with no count limit: the SIGALRM (main thread) or
    the between-matches deadline (another thread) ends the scan, truncated,
    identity first; the alarm handler is restored."""
    n = 12
    edges = [(0, i) for i in range(1, n)]
    labels = [616] + [604] * (n - 1)
    out = {}

    def run():
        t0 = time.monotonic()
        out["r"] = P.enumerate_automorphisms(n, edges, labels, limit=10 ** 9,
                                             timeout_s=0.2)
        out["s"] = time.monotonic() - t0

    import signal
    handler = signal.getsignal(signal.SIGALRM)
    if main_thread:
        run()
    else:
        t = threading.Thread(target=run)
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()
    isos, truncated = out["r"]
    assert truncated and out["s"] < 10
    assert len(isos) >= 1 and (isos[0] == np.arange(n)).all()
    assert signal.getsignal(signal.SIGALRM) is handler


def test_runs_without_networkx(monkeypatch):
    """The port's enumeration never imports networkx."""
    monkeypatch.setitem(sys.modules, "networkx", None)
    isos, truncated = P.enumerate_automorphisms(
        6, [(i, (i + 1) % 6) for i in range(6)], [600] * 6)
    assert len(isos) == 12 and not truncated
