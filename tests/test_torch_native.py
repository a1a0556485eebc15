"""The port's native batch packer (fabind_tpu_torch.data.native, built from
fabind_tpu_torch/csrc/collate.cc) against both packages' python collators,
on the CPU.

Every array is held bit for bit: the packer copies the same float32 rows,
and C fills each atom's bond slots in the order the python collator does.
The library is built with the host C++ compiler into build/native/; the
module skips only when no compiler is on PATH.
"""
from __future__ import annotations

import os
import shutil
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from fabind_tpu.config import preset as jax_preset
from fabind_tpu.data.batching import collate as jax_collate

from fabind_tpu_torch.config import preset
from fabind_tpu_torch.data import native
from fabind_tpu_torch.data.batching import (SampleTooLarge, build_sample,
                                            collate)
from fabind_tpu_torch.data.types import FABindBatch

from tests.test_data import make_raw

REPO = Path(__file__).resolve().parents[1]
SHAPES = dict(max_ligand=16, max_pocket=32, max_protein=40, bond_k=4)

pytestmark = pytest.mark.skipif(
    shutil.which(os.environ.get("CXX") or "g++") is None,
    reason="no C++ compiler on PATH")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's torch work: its tensors are
    toy-sized, and the suite runs in parallel workers that would otherwise
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def samples_of(group: str, edges: bool, n: int = 3):
    """Port samples of make_raw complexes of several sizes (seeded); with
    `edges` each carries its raw directed edge list, whose duplicates the
    packer drops."""
    cfg = preset("fabind", **SHAPES)
    rng = np.random.RandomState(0)
    out = []
    for i in range(n):
        raw = make_raw(n=7 + 3 * i, nr=25 + 5 * i, seed=i)
        s = build_sample(raw, cfg, group=group, rng=rng)
        if edges:
            e = np.asarray(raw["bond_edges"])
            s["bond_edges"] = np.concatenate([e, e[:2]])
        out.append(s)
    return cfg, out


def assert_same_arrays(got: dict, want: dict, what: str):
    assert set(got) == set(want), what
    for k, v in want.items():
        if v is None:
            assert got[k] is None, (what, k)
            continue
        g = np.asarray(got[k])
        assert g.dtype == np.asarray(v).dtype, (what, k, g.dtype)
        np.testing.assert_array_equal(g, np.asarray(v), err_msg=f"{what} {k}")


@pytest.mark.parametrize("group,edges,n_valid", [
    ("test", True, None), ("test", False, None), ("train", False, 2),
    ("train", True, 1)])
def test_collate_native_equals_both_python_collators(group, edges, n_valid):
    cfg, samples = samples_of(group, edges)
    got = native.collate_native(samples, cfg, n_valid=n_valid)
    assert_same_arrays(got, collate(samples, cfg, n_valid=n_valid), "port")
    jb = jax_collate(samples, jax_preset("fabind", **SHAPES), n_valid=n_valid)
    want = {k: getattr(jb, k) for k in jb.__dataclass_fields__}
    assert_same_arrays(got, want, "jax")
    assert got["sample_valid"].sum() == (n_valid or len(samples))
    batch = FABindBatch.from_numpy(got, "cpu")
    assert (batch.n_lig, batch.n_pocket, batch.n_protein) == (16, 32, 40)


def star_edges(degree: int = 6) -> np.ndarray:
    """Atom 0 bonded to 1..degree, each edge in both directions, and each
    0 -> j edge twice."""
    e = []
    for j in range(1, degree + 1):
        e += [(0, j), (j, 0), (0, j)]
    return np.asarray(e, np.int64)


def test_pack_bonds_overflow_is_loud():
    """A degree above bond_k is reported by C and raises SampleTooLarge in
    collate_native (never a truncated neighbour table); a degree within K
    is exact, duplicates dropped."""
    edges = star_edges()
    lib = native.get_lib()
    for kb in (2, 4):
        idx = np.zeros((1, 7, kb), np.int32)
        mask = np.zeros((1, 7, kb), np.uint8)
        deg = lib.pack_bonds(edges.ctypes.data, len(edges), idx.ctypes.data,
                             mask.ctypes.data, 0, 7, kb)
        assert deg > kb
    idx = np.zeros((1, 7, 8), np.int32)
    mask = np.zeros((1, 7, 8), np.uint8)
    assert lib.pack_bonds(edges.ctypes.data, len(edges), idx.ctypes.data,
                          mask.ctypes.data, 0, 7, 8) == 6
    assert idx[0, 0, :6].tolist() == [1, 2, 3, 4, 5, 6]
    assert mask[0, 0, :6].all() and not mask[0, 0, 6:].any()

    cfg, samples = samples_of("test", True, n=1)
    samples[0]["bond_edges"] = star_edges()
    with pytest.raises(SampleTooLarge, match=r"bond degree \d+ > 4"):
        native.collate_native(samples, cfg)


def test_isomorphisms_raise():
    cfg, samples = samples_of("test", False)
    samples[1]["isomorphisms"] = np.arange(
        len(samples[1]["lig_feat"]))[None]
    with pytest.raises(NotImplementedError, match="isomorphism"):
        native.collate_native(samples, cfg)


class _NoC:
    """Stands in for the library: any C call fails the test."""

    def __getattr__(self, name):
        raise AssertionError(f"C was called ({name})")


@pytest.mark.parametrize("key,bad", [
    ("lig_feat", lambda a: a[:, :50]), ("prot_feat", lambda a: a[:, :-1]),
    ("lig_coords", lambda a: a[:-1]), ("las_adj", lambda a: a[:, :-1]),
    ("bond_edges", lambda a: a + 100)])
def test_mismatched_sample_raises_before_c(monkeypatch, key, bad):
    """A feature dim or row count that disagrees with the sample, or a bond
    to an atom outside the ligand, raises ValueError before any pointer
    goes to C."""
    cfg, samples = samples_of("test", True)
    samples[2][key] = bad(np.asarray(samples[2][key]))
    monkeypatch.setattr(native, "get_lib", lambda: _NoC())
    with pytest.raises(ValueError, match=key):
        native.collate_native(samples[2:], cfg)


def test_library_lands_in_build_native_and_native_is_untouched():
    """The port builds into build/native/ and writes nothing under native/
    (where only the JAX package's own source and library may be: its tests
    build libfabind_collate.so there, possibly at the same moment)."""
    path = Path(native.build_library())
    native.collate_native(samples_of("test", True)[1], preset(
        "fabind", **SHAPES))
    assert path.parent == REPO / "build" / "native"
    assert path.name.startswith("libfabind_collate-") and path.exists()
    assert Path(native.get_lib()._name) == path
    assert REPO / "native" not in (native.SOURCE.parent, path.parent)
    assert {p.name for p in (REPO / "native").iterdir()} <= {
        "collate.cc", "libfabind_collate.so"}


def test_concurrent_builds_are_atomic(tmp_path):
    """Builders racing into one directory all end with the same complete
    library and leave no temporary file."""
    paths, errors = [], []

    def build():
        try:
            paths.append(native.build_library(str(tmp_path)))
        except Exception as e:  # surfaced below
            errors.append(e)

    threads = [threading.Thread(target=build) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors and len(set(paths)) == 1
    assert [p.name for p in tmp_path.iterdir()] == [Path(paths[0]).name]


def test_failed_build_raises_with_compiler_output(monkeypatch, tmp_path):
    """No fallback: a source that does not compile raises with the
    compiler's message, from build_library and from collate_native."""
    src = tmp_path / "collate.cc"
    src.write_text("int broken( {\n")
    monkeypatch.setattr(native, "SOURCE", src)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_LIB", None)
    with pytest.raises(RuntimeError, match="collate.cc failed") as e:
        native.build_library()
    assert "error" in str(e.value)
    cfg, samples = samples_of("test", False)
    with pytest.raises(RuntimeError, match="error"):
        native.collate_native(samples, cfg)
    assert not (tmp_path / "build").exists() or not any(
        (tmp_path / "build").iterdir())
