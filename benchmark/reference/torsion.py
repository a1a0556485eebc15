"""Ligand torsion randomization (host-side, numpy).

Own copy of fabind_tpu/data/torsion.py. Reproduces the behavior of the reference's torsion-noise path
(FABind/fabind/utils/utils.py:160-199 `get_torsions`/`SetDihedral` +
:280-299: randomize every rotatable-bond dihedral, canonicalize the
conformer, then apply a uniform random rotation) without requiring RDKit:
rotatable bonds are derived from the bond graph (non-ring single bonds whose
endpoints are both non-terminal, matching the reference's
`[!$(*#*)&!D1]-&!@[!$(*#*)&!D1]` SMARTS), and each torsion is set by rotating
the smaller component around the bond axis.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np


def _adjacency(n: int, bond_edges: np.ndarray) -> List[set]:
    adj = [set() for _ in range(n)]
    for i, j in np.asarray(bond_edges).reshape(-1, 2):
        if i != j:
            adj[int(i)].add(int(j))
            adj[int(j)].add(int(i))
    return adj


def _ring_bonds(n: int, adj: List[set]) -> set:
    """Bonds on cycles = bonds not removable as bridges (Tarjan bridges)."""
    visited = [False] * n
    disc = [0] * n
    low = [0] * n
    bridges = set()
    timer = [0]

    def dfs(root):
        stack = [(root, -1, iter(adj[root]))]
        visited[root] = True
        disc[root] = low[root] = timer[0]
        timer[0] += 1
        while stack:
            u, parent, it = stack[-1]
            advanced = False
            for v in it:
                if v == parent:
                    continue
                if visited[v]:
                    low[u] = min(low[u], disc[v])
                else:
                    visited[v] = True
                    disc[v] = low[v] = timer[0]
                    timer[0] += 1
                    stack.append((v, u, iter(adj[v])))
                    advanced = True
                    break
            if not advanced:
                stack.pop()
                if parent >= 0:
                    low[parent] = min(low[parent], low[u])
                    if low[u] > disc[parent]:
                        bridges.add((min(parent, u), max(parent, u)))

    for s in range(n):
        if not visited[s]:
            dfs(s)
    all_bonds = {(min(u, v), max(u, v)) for u in range(n) for v in adj[u]}
    return all_bonds - bridges


def rotatable_bonds(n: int, bond_edges: np.ndarray,
                    bond_orders: Optional[Sequence[float]] = None
                    ) -> List[Tuple[int, int]]:
    """Non-ring single bonds with both endpoints non-terminal
    (reference get_torsions' torsion-SMARTS semantics, utils.py:160-199)."""
    adj = _adjacency(n, bond_edges)
    rings = _ring_bonds(n, adj)
    orders = {}
    edges = np.asarray(bond_edges).reshape(-1, 2)
    if bond_orders is not None:
        for (i, j), o in zip(edges, np.asarray(bond_orders).reshape(-1)):
            orders[(min(int(i), int(j)), max(int(i), int(j)))] = float(o)
    out = []
    seen = set()
    for i, j in edges:
        i, j = int(i), int(j)
        key = (min(i, j), max(i, j))
        if key in seen:
            continue
        seen.add(key)
        if key in rings:
            continue
        if len(adj[i]) < 2 or len(adj[j]) < 2:
            continue
        if orders.get(key, 1.0) != 1.0:
            continue
        out.append(key)
    return out


def _component_beyond(adj: List[set], j: int, k: int) -> List[int]:
    """Atoms reachable from k without crossing bond (j, k)."""
    seen = {j, k}
    stack = [k]
    comp = [k]
    while stack:
        u = stack.pop()
        for v in adj[u]:
            if v not in seen:
                seen.add(v)
                comp.append(v)
                stack.append(v)
    return comp


def _rotate_about_axis(coords: np.ndarray, origin: np.ndarray,
                       axis: np.ndarray, angle: float) -> np.ndarray:
    axis = axis / max(np.linalg.norm(axis), 1e-9)
    c, s = np.cos(angle), np.sin(angle)
    K = np.array([[0, -axis[2], axis[1]],
                  [axis[2], 0, -axis[0]],
                  [-axis[1], axis[0], 0]])
    R = np.eye(3) + s * K + (1 - c) * (K @ K)
    return (coords - origin) @ R.T + origin


def randomize_torsions(coords: np.ndarray, bond_edges: np.ndarray,
                       rng: np.random.RandomState,
                       bond_orders: Optional[Sequence[float]] = None
                       ) -> np.ndarray:
    """Set every rotatable torsion to a uniform random angle
    (utils.py:293-297: values = 2*pi*rand per rotatable bond), then center
    on the conformer mean (the centering part of CanonicalizeConformer; the
    principal-axis alignment is immaterial because the caller applies a
    uniform random rotation afterwards, data.py:63-68 / build_sample)."""
    coords = np.asarray(coords, np.float64).copy()
    n = coords.shape[0]
    adj = _adjacency(n, bond_edges)
    for j, k in rotatable_bonds(n, bond_edges, bond_orders):
        angle = 2 * np.pi * rng.rand()
        moving = _component_beyond(adj, j, k)
        coords[moving] = _rotate_about_axis(
            coords[moving], coords[k], coords[k] - coords[j], angle)
    return (coords - coords.mean(0)).astype(np.float32)
