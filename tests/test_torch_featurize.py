"""The port's structure-file featurization (fabind_tpu_torch.data.featurize)
against the JAX package's, on the CPU.

Everything here is the same host arithmetic on both sides, so every key is
held bit for bit: the cycle basis (the port's own copy of networkx's
`cycle_basis`) to networkx on fused and bridged ring systems and on drawn
graphs, `featurize_sdf_text` on aromatic, charged, hydrogen-free and
polar-hydrogen-only molfiles, the PDB parser on altlocs, MODEL records,
HETATM and missing backbone atoms, and the V2000 writer byte for byte.

The synthetic structure files (PDB proteins, SDF ligands with rings and
explicit H) are chip_smoke.py's.
"""
from __future__ import annotations

import sys
import warnings

import networkx as nx
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from chip_smoke import ligand_with_hydrogens, pdb_line, pdb_text

from fabind_tpu.data import featurize as JF

from fabind_tpu_torch.data import featurize as F


# ------------------------------------------------------------------ helpers
def synthetic_ligand(rng: np.random.RandomState, n_heavy: int,
                     n_rings: int = 1, center=(0.0, 0.0, 0.0)):
    """(symbols, coords, bonds) of chip_smoke's synthetic ligand: a chain of
    `n_heavy` heavy atoms in 1.5 A steps centered at `center`, ring
    closures and explicit H (chip_smoke.ligand_with_hydrogens)."""
    steps = rng.randn(n_heavy, 3)
    steps *= 1.5 / np.linalg.norm(steps, axis=1, keepdims=True)
    xyz = np.cumsum(steps, 0)
    return ligand_with_hydrogens(rng, xyz + np.asarray(center) - xyz.mean(0),
                                 n_rings)


# ------------------------------------------------------------- cycle basis
def _nx_cycles(adj):
    return [list(c) for c in nx.cycle_basis(nx.from_numpy_array(adj))]


def _adj(n, edges):
    a = np.zeros((n, n), np.int64)
    for i, j in edges:
        a[i, j] = a[j, i] = 1
    return a


RING_SYSTEMS = {
    "naphthalene": (10, [(0, 1), (1, 2), (2, 3), (3, 4), (4, 5), (5, 0),
                         (4, 6), (6, 7), (7, 8), (8, 9), (9, 3)]),
    "norbornane": (7, [(0, 1), (1, 2), (2, 3), (3, 4), (4, 0), (0, 5),
                       (5, 6), (6, 3)]),
    "adamantane": (10, [(0, 1), (1, 2), (2, 3), (3, 4), (4, 5), (5, 0),
                        (1, 6), (6, 7), (7, 3), (7, 8), (8, 9), (9, 5)]),
    "cubane": (8, [(0, 1), (1, 2), (2, 3), (3, 0), (4, 5), (5, 6), (6, 7),
                   (7, 4), (0, 4), (1, 5), (2, 6), (3, 7)]),
    "spiro[4.4]nonane + chain": (12, [(0, 1), (1, 2), (2, 3), (3, 0),
                                      (0, 4), (4, 5), (5, 6), (6, 0),
                                      (6, 7), (9, 10), (10, 11), (11, 9)]),
}


@pytest.mark.parametrize("name", sorted(RING_SYSTEMS))
def test_cycle_basis_matches_networkx_on_ring_systems(name):
    n, edges = RING_SYSTEMS[name]
    for perm in (np.arange(n), np.random.RandomState(n).permutation(n)):
        adj = _adj(n, [(perm[i], perm[j]) for i, j in edges])
        assert F._cycle_basis(adj) == _nx_cycles(adj)
        assert F._sssr_like_rings(adj) == JF._sssr_like_rings(adj)


@settings(max_examples=60, deadline=None)
@given(st.integers(1, 14).flatmap(lambda n: st.tuples(
    st.just(n), st.lists(st.tuples(st.integers(0, n - 1),
                                   st.integers(0, n - 1)), max_size=30))))
def test_cycle_basis_matches_networkx_on_drawn_graphs(graph):
    n, edges = graph
    adj = _adj(n, [(i, j) for i, j in edges if i != j])
    assert F._cycle_basis(adj) == _nx_cycles(adj)


# ------------------------------------------------------- SDF featurization
def _benzoic_acid_aromatic():
    """Benzoic acid with aromatic type-4 ring bonds and explicit H."""
    ring = [(np.cos(a) * 1.4, np.sin(a) * 1.4, 0.0)
            for a in np.arange(6) * np.pi / 3]
    symbols = ["C"] * 6 + ["C", "O", "O"] + ["H"] * 6
    coords = ring + [(2.9, 0, 0), (3.6, 1.0, 0), (3.6, -1.0, 0)]
    bonds = [(i, (i + 1) % 6, 1.5) for i in range(6)]
    bonds += [(0, 6, 1.0), (6, 7, 2.0), (6, 8, 1.0)]
    for k, a in enumerate((1, 2, 3, 4, 5)):
        coords.append(tuple(np.asarray(ring[a]) * 1.75))
        bonds.append((a, 9 + k, 1.0))
    coords.append((4.5, -1.0, 0.0))
    bonds.append((8, 14, 1.0))
    return symbols, np.asarray(coords, np.float32), bonds, None


def _ammonium_acetate_charged():
    """Acetate and methylammonium, charges on M  CHG lines, explicit H."""
    symbols = ["C", "C", "O", "O", "N", "C"] + ["H"] * 9
    coords = np.random.RandomState(1).randn(15, 3).astype(np.float32) * 2
    bonds = [(0, 1, 1.0), (1, 2, 2.0), (1, 3, 1.0), (4, 5, 1.0)]
    bonds += [(0, 6, 1.0), (0, 7, 1.0), (0, 8, 1.0)]
    bonds += [(4, 9, 1.0), (4, 10, 1.0), (4, 11, 1.0)]
    bonds += [(5, 12, 1.0), (5, 13, 1.0), (5, 14, 1.0)]
    charges = np.zeros(15, np.int64)
    charges[3], charges[4] = -1, 1
    return symbols, coords, bonds, charges


def _pyridine_no_h():
    """Pyridine, aromatic bonds, no hydrogens (H counts estimated)."""
    symbols = ["N", "C", "C", "C", "C", "C", "S", "C"]
    coords = np.random.RandomState(2).randn(8, 3).astype(np.float32)
    bonds = [(i, (i + 1) % 6, 1.5) for i in range(6)] + [(2, 6, 1.0),
                                                         (6, 7, 1.0)]
    return symbols, coords, bonds, None


def _propanol_polar_h_only():
    """n-propanol with only the hydroxyl H (the warned input)."""
    symbols = ["C", "C", "C", "O", "H"]
    coords = np.asarray([[0, 0, 0], [1.5, 0, 0], [3.0, 0, 0],
                         [4.2, 1.0, 0], [5.0, 0.6, 0]], np.float32)
    bonds = [(0, 1, 1.0), (1, 2, 1.0), (2, 3, 1.0), (3, 4, 1.0)]
    return symbols, coords, bonds, None


def _synthetic():
    return synthetic_ligand(np.random.RandomState(5), 24, n_rings=2) + (
        None,)


MOLECULES = {"aromatic": _benzoic_acid_aromatic,
             "charged": _ammonium_acetate_charged,
             "no_h": _pyridine_no_h, "polar_h_only": _propanol_polar_h_only,
             "synthetic": _synthetic}


def _assert_same_features(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            assert a[k] == b[k], k


@pytest.mark.parametrize("name", sorted(MOLECULES))
def test_featurize_sdf_text_matches_jax(name, tmp_path):
    """Every key bit for bit (the integer, boolean and float arrays alike:
    the same host arithmetic), from text and from a file, and the
    polar-H-only warning on both sides."""
    symbols, coords, bonds, charges = MOLECULES[name]()
    text = F.sdf_string(symbols, coords, bonds, name=name, charges=charges)
    warn = name == "polar_h_only"
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        got = F.featurize_sdf_text(text)
        want = JF.featurize_sdf_text(text)
    msgs = [str(w.message) for w in caught]
    assert len([m for m in msgs if "polar-H-only" in m]) == (2 if warn
                                                             else 0)
    _assert_same_features(got, want)
    path = tmp_path / f"{name}.sdf"
    path.write_text(text)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        _assert_same_features(F.featurize_sdf(str(path)),
                              JF.featurize_sdf(str(path)))
    np.testing.assert_array_equal(F.sdf_coords(str(path)),
                                  JF.sdf_coords(str(path)))
    if name == "charged":
        assert list(got["charges"]) == [0, 0, 0, -1, 1, 0]
    if name == "aromatic":
        assert got["feats"][:6, -1].all() and not got["feats"][6:, -1].any()


def test_sdf_string_and_write_sdf_match_jax(tmp_path):
    for name, make in sorted(MOLECULES.items()):
        symbols, coords, bonds, charges = make()
        kw = dict(name=name, charges=charges)
        assert (F.sdf_string(symbols, coords, bonds, **kw)
                == JF.sdf_string(symbols, coords, bonds, **kw))
        F.write_sdf(str(tmp_path / "a.sdf"), symbols, coords, bonds, **kw)
        JF.write_sdf(str(tmp_path / "b.sdf"), symbols, coords, bonds, **kw)
        assert ((tmp_path / "a.sdf").read_bytes()
                == (tmp_path / "b.sdf").read_bytes())
    with pytest.raises(ValueError, match="999"):
        F.sdf_string(["C"] * 1000, np.zeros((1000, 3)), [])


def test_bad_molfiles_raise_like_jax():
    for text in ("x\n\n\n  0  0  0  0  0  0  0  0  0  0999 V2000\nM  END\n",
                 "x\n\n\n  0  0  0     0  0            999 V3000\n"):
        for mod in (F, JF):
            with pytest.raises(ValueError):
                mod.featurize_sdf_text(text)


# ------------------------------------------------------------------- PDB
def test_parse_pdb_atoms_matches_jax(tmp_path):
    """Altlocs (the higher occupancy wins, the first on a tie), two MODELs,
    HETATM and non-standard residues skipped, a residue without its O
    dropped, an insertion code kept apart."""
    xyz = np.random.RandomState(3).randn(40, 3) * 5
    lines = ["HEADER    TEST\n", "MODEL        1\n"]
    s = 1
    for i, (res, alt_occ) in enumerate([("ALA", None), ("GLY", (0.4, 0.6)),
                                        ("SER", (0.5, 0.5)),
                                        ("LYS", None)]):
        for a, name in enumerate(("N", "CA", "C", "O")):
            if res == "LYS" and name == "O":
                continue   # missing backbone atom: the residue is dropped
            if alt_occ and name == "CA":
                for alt, occ in zip("AB", alt_occ):
                    lines.append(pdb_line(s, name, res, "A", i + 1,
                                          xyz[s % 40], occ=occ, alt=alt))
                    s += 1
            else:
                lines.append(pdb_line(s, name, res, "A", i + 1, xyz[s % 40]))
                s += 1
    for name in ("N", "CA", "C", "O"):
        lines.append(pdb_line(s, name, "TRP", "A", 4, xyz[s % 40],
                              icode="A"))
        lines.append(pdb_line(s + 1, name, "HOH", "A", 90, xyz[s % 40],
                              rec="HETATM"))
        lines.append(pdb_line(s + 2, name, "MSE", "A", 91, xyz[s % 40]))
        s += 3
    lines += ["TER\n", "ENDMDL\n", "MODEL        2\n"]
    for name in ("N", "CA", "C", "O"):
        lines.append(pdb_line(s, name, "VAL", "A", 1, xyz[s % 40]))
        s += 1
    lines += ["ENDMDL\n", "END\n"]
    path = tmp_path / "p.pdb"
    path.write_text("".join(lines))
    got, want = F.parse_pdb_atoms(str(path)), JF.parse_pdb_atoms(str(path))
    assert got["seq"] == want["seq"] == "AGSWV"
    assert got["coords"].dtype == np.float32
    np.testing.assert_array_equal(got["coords"], want["coords"])
    np.testing.assert_array_equal(
        F.extract_protein_structure(str(path))["coords"], want["coords"])

    seq = "MKVLAGSTWY"
    ca = np.random.RandomState(4).randn(len(seq), 3) * 8
    path.write_text(pdb_text(seq, ca))
    got = F.parse_pdb_atoms(str(path))
    assert got["seq"] == seq and got["coords"].shape == (len(seq), 4, 3)
    np.testing.assert_allclose(got["coords"][:, 1], ca, atol=1e-3)
    np.testing.assert_array_equal(got["coords"],
                                  JF.parse_pdb_atoms(str(path))["coords"])


# ------------------------------------------------------ no networkx needed
def test_featurizer_runs_without_networkx(monkeypatch):
    """With networkx unimportable the port's featurizer gives the same
    rings, while the JAX package's needs networkx."""
    symbols, coords, bonds, _ = _synthetic()
    text = F.sdf_string(symbols, coords, bonds)
    want = JF.featurize_sdf_text(text)
    monkeypatch.setitem(sys.modules, "networkx", None)
    _assert_same_features(F.featurize_sdf_text(text), want)
    with pytest.raises(ImportError):
        JF.featurize_sdf_text(text)

