"""Ligand graph automorphisms for the permutation-invariant loss and the
symmetric RMSD, without networkx.

Own copy of fabind_tpu/data/isomorphism.py. Node labels follow the
reference: atomic_number * 100 + sum of incident bond-type indices
(FABind_plus/fabind/utils/isomorphism.py:23-31, 49-62), so only chemically
equivalent atoms may permute.

The matcher is an own copy of networkx 3.x's VF2 `GraphMatcher` for a graph
matched against itself (networkx/algorithms/isomorphism/isomorphvf2.py
`candidate_pairs_iter`, `syntactic_feasibility`, `GMState`; vf2userfunc.py
`_semantic_feasibility` with categorical node and edge matches). It yields
the automorphisms in networkx's ORDER, not only the same set: the collator
keeps the first `max_iso` of them for the permutation loss. That order
depends on the node insertion order and on the order in which neighbours
enter the terminal sets, so the adjacency is built as the JAX package's
`nx.Graph` is: nodes 0..n-1, then each undirected edge once, at its first
appearance in `edges` (a later duplicate only updates its label).
"""
from __future__ import annotations

import signal
import sys
import threading
import time
import warnings
from typing import Dict, List, Optional, Sequence

import numpy as np

# safety ceiling for "unbounded" enumeration: highly symmetric ligands can
# have factorially many automorphisms; the reference's spyrmsd bounds the
# analogous blow-up with a 10 s SIGALRM (get_sym_rmsd.py:12-24)
HARD_ISO_LIMIT = 4096


class _IsoTimeout(Exception):
    pass


class _SelfMatcher:
    """VF2 over (G, G) with categorical node labels and optional edge
    labels: networkx's GraphMatcher state and search, specialised to one
    graph (G1 = G2 = G, a simple undirected graph, possibly with self
    loops)."""

    def __init__(self, nodes: List, adj: Dict, node_label: Dict,
                 match_edges: bool):
        self.nodes = nodes                        # G's node order
        self.adj = adj                            # node -> {nbr: label}
        self.node_label = node_label
        self.match_edges = match_edges
        self.order = {n: i for i, n in enumerate(nodes)}
        self.node_set = set(nodes)
        self.core_1, self.core_2 = {}, {}
        self.inout_1, self.inout_2 = {}, {}

    def isomorphisms_iter(self):
        self.core_1, self.core_2 = {}, {}
        self.inout_1, self.inout_2 = {}, {}
        limit = sys.getrecursionlimit()
        if limit < 1.5 * len(self.nodes):
            sys.setrecursionlimit(int(1.5 * len(self.nodes)))
        yield from self._match()

    def _candidate_pairs(self):
        t1 = [n for n in self.inout_1 if n not in self.core_1]
        t2 = [n for n in self.inout_2 if n not in self.core_2]
        if t1 and t2:
            node_2 = min(t2, key=self.order.__getitem__)
            for node_1 in t1:
                yield node_1, node_2
        else:
            other = min(self.node_set - set(self.core_2),
                        key=self.order.__getitem__)
            for node in self.nodes:
                if node not in self.core_1:
                    yield node, other

    def _match(self):
        if len(self.core_1) == len(self.nodes):
            yield dict(self.core_1)
            return
        for n1, n2 in self._candidate_pairs():
            if self._syntactic(n1, n2) and self._semantic(n1, n2):
                depth = self._push(n1, n2)
                yield from self._match()
                self._pop(n1, n2, depth)

    def _syntactic(self, n1, n2) -> bool:
        adj, core_1, core_2 = self.adj, self.core_1, self.core_2
        a1, a2 = adj[n1], adj[n2]
        if (n1 in a1) != (n2 in a2):                       # R_self
            return False
        for nb in a1:                                      # R_neighbor
            if nb in core_1 and core_1[nb] not in a2:
                return False
        for nb in a2:
            if nb in core_2 and core_2[nb] not in a1:
                return False
        num1 = sum(1 for nb in a1                          # R_terminout
                   if nb in self.inout_1 and nb not in core_1)
        num2 = sum(1 for nb in a2 if nb in self.inout_2 and nb not in core_2)
        if num1 != num2:
            return False
        num1 = sum(1 for nb in a1 if nb not in self.inout_1)   # R_new
        num2 = sum(1 for nb in a2 if nb not in self.inout_2)
        return num1 == num2

    def _semantic(self, n1, n2) -> bool:
        if self.node_label[n1] != self.node_label[n2]:
            return False
        if self.match_edges:
            a1, a2 = self.adj[n1], self.adj[n2]
            for nb in a1:
                if nb == n1:
                    if n2 in a2 and a1[n1] != a2[n2]:
                        return False
                elif nb in self.core_1:
                    m = self.core_1[nb]
                    if m in a2 and a1[nb] != a2[m]:
                        return False
        return True

    def _push(self, n1, n2) -> int:
        """GMState(GM, n1, n2): extend the mapping and the terminal sets
        (in networkx's order: the new node, then the unmatched neighbours
        of the mapped nodes, gathered in a set)."""
        self.core_1[n1] = n2
        self.core_2[n2] = n1
        depth = len(self.core_1)
        for core, inout in ((self.core_1, self.inout_1),
                            (self.core_2, self.inout_2)):
            node = n1 if core is self.core_1 else n2
            if node not in inout:
                inout[node] = depth
            new_nodes = set()
            for m in core:
                new_nodes.update([nb for nb in self.adj[m] if nb not in core])
            for m in new_nodes:
                if m not in inout:
                    inout[m] = depth
        return depth

    def _pop(self, n1, n2, depth: int) -> None:
        """GMState.restore."""
        del self.core_1[n1]
        del self.core_2[n2]
        for inout in (self.inout_1, self.inout_2):
            for m in list(inout):
                if inout[m] == depth:
                    del inout[m]


def _graph(n_atoms: int, edges: Sequence, node_labels, edge_labels):
    """(nodes, adjacency {node: {neighbour: edge label}}, node labels) in
    the insertion order of `nx.Graph` built as the JAX package builds it."""
    nodes = list(range(n_atoms))
    adj: Dict = {i: {} for i in nodes}
    node_label = {i: node_labels[i] for i in nodes}
    for k, (i, j) in enumerate(edges):
        i, j = int(i), int(j)
        for v in (i, j):
            if v not in adj:                      # add_edge adds the node
                nodes.append(v)
                adj[v] = {}
                node_label[v] = None
        # a duplicate keeps its place and takes the later label, as the
        # edge's shared data dict does
        adj[i][j] = adj[j][i] = (edge_labels[k] if edge_labels is not None
                                 else None)
    return nodes, adj, node_label


def enumerate_automorphisms(n_atoms: int, edges: Sequence, node_labels,
                            edge_labels=None,
                            limit: int = HARD_ISO_LIMIT,
                            timeout_s: float = 10.0
                            ) -> "tuple[np.ndarray, bool]":
    """Enumerate graph automorphisms up to `limit`, bounded by wall clock.

    `limit` bounds the count, but VF2 can backtrack exponentially between
    matches on pathological ligands, so enumeration is also bounded by
    `timeout_s` (the reference's get_sym_rmsd.py:12-24 SIGALRM semantics).
    On the main thread a SIGALRM interrupts mid-backtrack; elsewhere the
    deadline is checked between matches. A timeout returns what was found
    (at least the identity), truncated=True.

    Args:
      edges: iterable of (i, j) undirected bonds (one direction suffices).
      node_labels: per-atom hashable labels.
      edge_labels: optional per-edge hashable labels (same order as edges).
      timeout_s: wall-clock bound; 0/None disables.
    Returns:
      ([n_iso, n_atoms] int32 with identity first, truncated flag).
    """
    matcher = _SelfMatcher(*_graph(n_atoms, edges, node_labels,
                                   edge_labels),
                           match_edges=edge_labels is not None)

    isos: List[np.ndarray] = []
    seen = set()
    identity = tuple(range(n_atoms))
    truncated = False
    use_alarm = (timeout_s and timeout_s > 0
                 and threading.current_thread() is threading.main_thread())
    deadline = (time.monotonic() + timeout_s) if timeout_s else None

    def _scan():
        nonlocal truncated
        for mapping in matcher.isomorphisms_iter():
            if deadline is not None and time.monotonic() > deadline:
                truncated = True
                break
            perm = tuple(mapping[i] for i in range(n_atoms))
            if perm in seen:
                continue
            seen.add(perm)
            if perm == identity:
                continue
            if len(isos) >= limit - 1:
                truncated = True
                break
            isos.append(np.asarray(perm, np.int32))

    if use_alarm:
        def _raise(signum, frame):
            raise _IsoTimeout()
        old_handler = signal.signal(signal.SIGALRM, _raise)
        # The one-shot itimer fires once, so at most one _IsoTimeout is
        # raised: mid-scan (the except side cleans up) or between the
        # scan's end and setitimer(0), where the except side re-runs the
        # cleanup, which can no longer be interrupted.
        try:
            signal.setitimer(signal.ITIMER_REAL, timeout_s)
            _scan()
            signal.setitimer(signal.ITIMER_REAL, 0)
            signal.signal(signal.SIGALRM, old_handler)
        except _IsoTimeout:
            truncated = True
            signal.setitimer(signal.ITIMER_REAL, 0)
            signal.signal(signal.SIGALRM, old_handler)
    else:
        try:
            _scan()
        except _IsoTimeout:
            truncated = True
    out = [np.arange(n_atoms, dtype=np.int32)] + isos
    return np.stack(out), truncated


def automorphisms_from_graph(n_atoms: int, edges: Sequence, node_labels,
                             edge_labels=None,
                             max_iso: Optional[int] = 8) -> np.ndarray:
    """Automorphism permutations [n_iso, n_atoms] int32, identity first.

    max_iso=None enumerates the full group (bounded by HARD_ISO_LIMIT: the
    evaluation's symmetric RMSD); an int cap serves the training's
    permutation loss, whose device arrays need a small static n_iso.
    Truncation warns."""
    limit = HARD_ISO_LIMIT if max_iso is None else max_iso
    out, truncated = enumerate_automorphisms(
        n_atoms, edges, node_labels, edge_labels, limit=limit)
    if truncated:
        warnings.warn(
            f"automorphism enumeration truncated at {limit} for a "
            f"{n_atoms}-atom ligand; symmetric RMSD may be pessimistic",
            stacklevel=2)
    return out


# torchdrug atom-symbol vocabulary position -> atomic number
# (featurize.ATOM_VOCAB order; trailing unknown slot -> 0)
_VOCAB_ATOMIC_NUM = np.asarray(
    [1, 5, 6, 7, 8, 9, 12, 14, 15, 16, 17, 29, 30, 34, 35, 50, 53, 0],
    np.int64)


def ref_bond_index_from_order(order: float) -> int:
    """Bond order -> the reference's safe_index_bond value
    (FABind_plus isomorphism.py:35-46 over [AROMATIC, TRIPLE, DOUBLE,
    SINGLE, misc] + 1): aromatic(1.5)=1, triple(3)=2, double(2)=3,
    single(1)=4, anything else=5."""
    if order == 1.5:
        return 1
    if order == 3.0:
        return 2
    if order == 2.0:
        return 3
    if order == 1.0:
        return 4
    return 5


def iso_labels_from_arrays(feats: np.ndarray, bond_edges: np.ndarray,
                           bond_orders=None) -> np.ndarray:
    """The reference's node labels (atomGetnum, FABind_plus
    isomorphism.py:49-62) from stored arrays instead of an RDKit mol:
    atomic_number * 100 + sum of bond-type indices over incident bonds.

    feats: [n, 56] torchdrug features (symbol one-hot in the first 18 dims).
    bond_edges: [E, 2] directed (both directions present), so each bond
    counts once per endpoint, as the reference's undirected GetBonds() loop.
    bond_orders: [E] float orders aligned with bond_edges; None counts
    every bond SINGLE.
    """
    feats = np.asarray(feats)
    nums = _VOCAB_ATOMIC_NUM[feats[:, :18].argmax(axis=1)]
    labels = nums * 100
    e = np.asarray(bond_edges).reshape(-1, 2)
    if bond_orders is None:
        orders = np.ones(len(e))
    else:
        orders = np.asarray(bond_orders, float).reshape(-1)
    for (i, _), o in zip(e, orders):
        labels[int(i)] += ref_bond_index_from_order(float(o))
    return labels
