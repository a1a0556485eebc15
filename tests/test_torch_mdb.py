"""The port's LMDB codec (data/mdb.py, data/kv.py) against the JAX
package's, on the CPU with the `lmdb` binding unimportable: each package
reads the other's stores, at sizes that need overflow pages and a
multi-level B-tree, and the two writers produce the same file byte for
byte. Every comparison is exact (bytes)."""
from __future__ import annotations

import os
import pickle
import sys

import numpy as np
import pytest
import torch

from fabind_tpu.data import kv as jax_kv
from fabind_tpu.data import mdb as jax_mdb

from fabind_tpu_torch.data import kv, mdb


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's torch work (the suite runs in
    parallel workers that would otherwise oversubscribe the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _no_lmdb(monkeypatch):
    """`import lmdb` raises: both packages take their pure-Python codec."""
    monkeypatch.setitem(sys.modules, "lmdb", None)
    assert not kv.have_lmdb() and not jax_kv.have_lmdb()


def _items(kind: str):
    rng = np.random.RandomState(7)
    if kind == "overflow":     # values past NODEMAX, spanning pages
        items = {f"big{i}".encode(): rng.bytes(30_000 + 7919 * i)
                 for i in range(4)}
        items.update({b"tiny": b"x", b"empty": b"",
                      b"edge": rng.bytes(mdb.NODEMAX)})
        return items
    if kind == "btree":        # enough keys for branch pages
        return {f"key-{i:05d}".encode(): (f"v{i}" * (1 + i % 11)).encode()
                for i in range(2500)}
    items = {rng.bytes(int(rng.randint(1, 40))):          # mixed
             rng.bytes(int(rng.randint(0, 5000))) for _ in range(300)}
    items[b"L" * 511] = b"limit"
    return items


def _read(module, path):
    env = module.open(path)
    with env.begin() as txn:
        got = {bytes(k): bytes(v) for k, v in txn.cursor()}
        keys = sorted(got)
        point = {k: bytes(txn.get(k)) for k in keys[:3] + keys[-3:]}
        assert txn.get(b"\xff" * 9 + b"missing") is None
    env.close()
    return got, point


@pytest.mark.parametrize("kind", ["overflow", "btree", "mixed"])
@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_each_package_reads_the_others_store(tmp_path, kind, writer,
                                             reader):
    items = _items(kind)
    path = str(tmp_path / "env.lmdb")
    {"jax": jax_mdb, "port": mdb}[writer].write_env(path, items)
    got, point = _read({"jax": jax_mdb, "port": mdb}[reader], path)
    assert got == items
    assert all(point[k] == items[k] for k in point)
    if kind == "btree":   # the root is a branch page: depth >= 2
        env = mdb.open(path)
        assert env._page(env._root)[0] & mdb.P_BRANCH
        env.close()


@pytest.mark.parametrize("kind", ["overflow", "btree", "mixed"])
def test_writers_agree_byte_for_byte(tmp_path, kind):
    items = _items(kind)
    mdb.write_env(str(tmp_path / "a"), items)
    jax_mdb.write_env(str(tmp_path / "b"), items)
    a = (tmp_path / "a" / "data.mdb").read_bytes()
    assert a == (tmp_path / "b" / "data.mdb").read_bytes()
    assert len(a) > 3 * mdb.PAGESIZE


def test_write_kv_merges_and_jax_reads_it(tmp_path):
    """write_kv merges into an existing store (lmdb's put semantics), the
    env API commits on close, and the JAX package reads the result."""
    path = str(tmp_path / "m.lmdb")
    kv.write_kv(path, {b"a": b"1", b"b": pickle.dumps(np.arange(3))})
    kv.write_kv(path, {b"b": b"new", b"c": b"3" * 5000})
    env = kv.open_kv(path, readonly=False)
    with env.begin(write=True) as txn:
        assert txn.get(b"a") == b"1"
        txn.put(b"d", b"4")
    env.close()
    env = jax_kv.open_kv(path)
    with env.begin() as txn:
        assert dict(txn.cursor()) == {b"a": b"1", b"b": b"new",
                                      b"c": b"3" * 5000, b"d": b"4"}
    assert env.stat()["entries"] == 4
    env.close()
    with pytest.raises(PermissionError):
        kv.open_kv(path).begin(write=True)
    with pytest.raises(FileNotFoundError):
        kv.open_kv(str(tmp_path / "none"))


def test_reads_a_reference_store(tmp_path):
    """The fixture's three LMDB stores (written by the JAX package's
    write_kv) read the same through both codecs."""
    from fixture_pdbbind import make_reference_fixture
    make_reference_fixture(str(tmp_path))
    p = tmp_path / "dataset" / "processed"
    for name in ("protein_1d_3d.lmdb", "compound_LAS_edge_index.lmdb",
                 "esm2_t33_650M_UR50D.lmdb"):
        path = str(p / name)
        assert _read(mdb, path) == _read(jax_mdb, path)
    assert os.path.getsize(p / "esm2_t33_650M_UR50D.lmdb" / "data.mdb") \
        > 10 * mdb.PAGESIZE
