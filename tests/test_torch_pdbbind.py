"""The port's processed-PDBbind path against the JAX package's, on the CPU:
the pandas-free index reader and writer (data/frame.py), the store source
(`PDBBindLMDBSource`: splits, every row's keys, a Loader epoch), the
preprocessing modes pdbbind, inject-iso and esm --lmdb, and the port's
drivers in process on a reference-layout fixture
(tests/fixture_pdbbind.py make_reference_fixture) at toy width.

Tolerances: bit for bit (values, dtypes, order) everywhere, except the
ESM2 rows of esm --lmdb, which are recomputed in other batches and held to
1e-5 absolute against `embed_sequences`.
"""
from __future__ import annotations

import dataclasses
import os
import pickle
import re
import shutil
import types

import numpy as np
import pandas as pd
import pytest
import torch

from fixture_pdbbind import make_reference_fixture

from fabind_tpu.cli import preprocess as jax_preprocess
from fabind_tpu.config import preset as jax_preset
from fabind_tpu.data.dataset import Loader as JaxLoader
from fabind_tpu.data.dataset import PDBBindLMDBSource as JaxSource
from fabind_tpu.data.types import FABindBatch as JaxBatch

from fabind_tpu_torch.cli import evaluate as cli_evaluate
from fabind_tpu_torch.cli import preprocess as cli_preprocess
from fabind_tpu_torch.cli import sample as cli_sample
from fabind_tpu_torch.cli import train as cli_train
from fabind_tpu_torch.cli import train_confidence as cli_conf
from fabind_tpu_torch.config import preset
from fabind_tpu_torch.data import frame as F
from fabind_tpu_torch.data.dataset import (Loader, NPZSource,
                                           PDBBindLMDBSource, open_source)
from fabind_tpu_torch.data.kv import open_kv
from fabind_tpu_torch.models.esm2 import Esm2Config, Esm2Model, load_esm2

# train rows of several protein lengths, so a length cut drops some
TRAIN_SIZES = [(8, 20), (8, 28), (8, 40), (8, 33)]
CLI_SETS = ["max_ligand=16", "max_pocket=32", "max_protein=48", "ctx_k=8",
            "ctx_k_whole=8", "hidden_size=16", "pocket_pred_hidden_size=16",
            "mean_layers=1", "n_iter=2"]
ESM_TOY = Esm2Config(hidden_size=40, num_layers=1, num_heads=20,
                     intermediate_size=16)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's torch work (the suite runs in
    parallel workers that would otherwise oversubscribe the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    """Reference-layout stores: base (data.pt), plus (data_new.pt, the
    symmetric probe ligands with a two-element group), and plus written
    with object string columns (pandas' future.infer_string off)."""
    root = tmp_path_factory.mktemp("stores")
    out = {}
    make_reference_fixture(str(root / "base"), train_sizes=TRAIN_SIZES)
    out["base"] = str(root / "base")
    make_reference_fixture(str(root / "plus"), plus=True, symmetric=True)
    out["plus"] = str(root / "plus")
    with pd.option_context("future.infer_string", False):
        make_reference_fixture(str(root / "object"), plus=True)
    out["object"] = str(root / "object")
    return out


def _index_path(root):
    p = os.path.join(root, "dataset", "processed")
    new = os.path.join(p, "data_new.pt")
    return new if os.path.exists(new) else os.path.join(p, "data.pt")


def _same(a, b) -> bool:
    """Exact equality of index cells and sample values: arrays by dtype,
    shape and bits, lists element by element, NaN equal to NaN."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        return (a.dtype == b.dtype and a.shape == b.shape
                and a.tobytes() == b.tobytes())
    if isinstance(a, (list, tuple)) or isinstance(b, (list, tuple)):
        return (isinstance(a, (list, tuple)) and isinstance(b, (list, tuple))
                and len(a) == len(b) and all(map(_same, a, b)))
    if isinstance(a, float) and isinstance(b, float) and np.isnan(a):
        return bool(np.isnan(b))
    return type(a) is type(b) and a == b or (
        np.isscalar(a) and np.isscalar(b) and a == b
        and np.asarray(a).dtype == np.asarray(b).dtype)


def _frame_equals_pandas(frame, df):
    df = df.reset_index(drop=True)
    assert frame.names == [str(c) for c in df.columns]
    assert len(frame) == len(df)
    for c in df.columns:
        col = frame[c]
        if isinstance(col, np.ndarray):
            assert col.dtype == df[c].to_numpy().dtype, c
        for i in range(len(df)):
            want = df[c].iloc[i]
            if isinstance(col, np.ndarray):
                assert col[i] == want, (c, i)
            else:
                assert _same(col[i], want), (c, i, col[i], want)


# ---- the index: load_frame and save_frame --------------------------------

class _NewObj:
    """Pickled as NEWOBJ of a global, then BUILD with `state`."""

    def __init__(self, cls, state):
        self.cls, self.state = cls, state


class _LegacyPickler(F.Pickler):
    dispatch = dict(F.Pickler.dispatch)

    def save_newobj(self, obj):
        self.save(obj.cls)
        self.save(())
        self.write(pickle.NEWOBJ)
        self.memoize(obj)
        self.save(obj.state)
        self.write(pickle.BUILD)

    dispatch[_NewObj] = save_newobj


def _pandas1_frame(df):
    """`df` in the pandas 1.x pickle layout: NEWOBJ BlockManager with the
    {"0.14.1": {"axes", "blocks"}} state, one block per dtype (object
    values as one 2-D object array), an object column Index and an
    Int64Index of rows that is not a range."""
    g = F._GlobalRef
    names = [str(c) for c in df.columns]
    by_dtype = {}
    for pos, c in enumerate(df.columns):
        v = df[c].to_numpy()
        key = v.dtype.str if v.dtype != object and v.dtype.kind != "U" \
            else "O"
        by_dtype.setdefault(key, []).append(pos)
    blocks = []
    for key, locs in by_dtype.items():
        vals = np.empty((len(locs), len(df)),
                        object if key == "O" else np.dtype(key))
        for k, pos in enumerate(locs):
            col = df[df.columns[pos]].tolist()
            for i in range(len(df)):
                vals[k, i] = col[i]
        place = (slice(locs[0], locs[0] + 1, 1) if len(locs) == 1
                 else np.asarray(locs, np.int64))
        blocks.append({"values": vals, "mgr_locs": place})
    new_index = g("pandas.core.indexes.base", "_new_Index")
    columns = np.empty(len(names), object)
    columns[:] = names
    axes = [F._Reduce(new_index, (g("pandas.core.indexes.base", "Index"),
                                  {"data": columns, "name": None})),
            F._Reduce(new_index, (g("pandas.core.indexes.numeric",
                                    "Int64Index"),
                                  {"data": np.arange(len(df)) * 3 + 7,
                                   "name": None}))]
    mgr = _NewObj(g("pandas.core.internals.managers", "BlockManager"),
                  (axes, [b["values"] for b in blocks], [names],
                   {"0.14.1": {"axes": axes, "blocks": blocks}}))
    return _NewObj(g("pandas.core.frame", "DataFrame"),
                   {"_mgr": mgr, "_typ": "dataframe", "_metadata": [],
                    "attrs": {}, "_flags": {"allows_duplicate_labels": True}})


@pytest.mark.parametrize("layout", ["base", "plus", "object", "pandas1",
                                    "nulls"])
def test_load_frame_equals_pandas(stores, tmp_path, layout):
    """Arrow string columns (pandas 3's default), object string columns,
    the pandas 1.x layout (loaded by pandas through read_pickle's
    compatibility unpickler) and an arrow column with nulls (a validity
    bitmap) give pandas' columns, cell for cell."""
    if layout == "nulls":
        path = str(tmp_path / "nulls.pt")
        torch.save(pd.DataFrame({"pdb": ["a", None, "c", None, "e"] * 3,
                                 "n": np.arange(15)}).iloc[2:], path)
        frame = F.load_frame(path)
        _frame_equals_pandas(frame, torch.load(path, weights_only=False))
        assert np.isnan(frame["pdb"][1]) and frame["pdb"][0] == "c"
        return
    if layout != "pandas1":
        path = _index_path(stores[layout])
        _frame_equals_pandas(F.load_frame(path),
                             torch.load(path, weights_only=False))
        return
    df = torch.load(_index_path(stores["object"]), weights_only=False)
    obj = _pandas1_frame(df)
    raw = tmp_path / "legacy.pkl"
    with open(raw, "wb") as f:
        _LegacyPickler(f, protocol=2).dump(obj)
    legacy = pd.read_pickle(raw)
    assert list(legacy.index) == list(np.arange(len(df)) * 3 + 7)
    path = str(tmp_path / "data.pt")
    torch.save(obj, path, pickle_module=types.SimpleNamespace(
        __name__="legacy", Pickler=_LegacyPickler))
    _frame_equals_pandas(F.load_frame(path), legacy)
    _frame_equals_pandas(F.load_frame(path), df)


def test_load_frame_refuses_other_classes(tmp_path):
    """A global outside the allowlist raises, naming it and the file,
    before anything of it runs; so does a pickle that is no DataFrame."""
    path = str(tmp_path / "dates.pt")
    torch.save(pd.DataFrame({"t": pd.to_datetime(["2020-01-01"])}), path)
    with pytest.raises(pickle.UnpicklingError,
                       match=rf"{re.escape(path)}: pandas\._libs\."):
        F.load_frame(path)

    class Evil:
        def __reduce__(self):
            return os.system, ("false",)

    path = str(tmp_path / "evil.pt")
    torch.save({"x": Evil()}, path)
    with pytest.raises(pickle.UnpicklingError, match=r"evil\.pt: posix\.system"):
        F.load_frame(path)
    path = str(tmp_path / "dict.pt")
    torch.save({"x": np.arange(3)}, path)
    with pytest.raises(pickle.UnpicklingError, match="not a DataFrame"):
        F.load_frame(path)


def test_save_frame_read_by_pandas_and_the_jax_source(stores, tmp_path):
    """save_frame's data_new.pt, with a NaN isomorphics row as inject-iso
    leaves a skipped row, is a DataFrame to pandas (query works) and to the
    JAX source, whose rows equal the port's, NaN row included."""
    root = tmp_path / "store"
    shutil.copytree(stores["plus"], root)
    path = _index_path(str(root))
    cols = dict(F.load_frame(path).columns)
    cols["isomorphics"] = list(cols["isomorphics"])
    cols["isomorphics"][0] = float("nan")
    F.save_frame(path, cols)
    df = torch.load(path, weights_only=False)
    assert list(df.columns) == list(cols)
    kept = df.query("c_length < 100 and use_compound_com")["pdb"].tolist()
    assert kept == [p for p, c, u in zip(cols["pdb"], cols["c_length"],
                                         cols["use_compound_com"])
                    if c < 100 and u]
    _frame_equals_pandas(F.load_frame(path), df)
    jsrc, src = JaxSource(str(root)), PDBBindLMDBSource(str(root))
    assert "isomorphisms" not in src.get(0)
    for i in range(len(src)):
        _assert_raw_equal(src.get(i), jsrc.get(i))
    with pytest.raises(ValueError, match="unequal length"):
        F.save_frame(str(tmp_path / "bad.pt"), {"a": [1], "b": [1, 2]})


# ---- the source -------------------------------------------------------------

def _assert_raw_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert _same(got[k], want[k]), k


@pytest.mark.parametrize("cut", [None, 0, 30])
@pytest.mark.parametrize("variant", ["fabind", "fabind_plus"])
@pytest.mark.parametrize("store", ["base", "plus"])
def test_splits_equal_jax(stores, store, variant, cut):
    got = PDBBindLMDBSource(stores[store]).splits(variant, cut)
    want = JaxSource(stores[store]).splits(variant, cut)
    assert got == {k: [int(i) for i in v] for k, v in want.items()}
    assert got["valid"] and got["test"]
    if store == "base" and variant == "fabind_plus" and cut == 30:
        assert len(got["train"]) == 3 < len(
            PDBBindLMDBSource(stores[store]).splits(variant, 0)["train"])


@pytest.mark.parametrize("store", ["base", "plus", "object"])
def test_get_every_row_equals_jax(stores, store):
    """Every key of every row, bit for bit: bond orders from the relation
    ids, the LAS mask, the automorphisms of data_new.pt; and without the
    ESM store, no esm_feat."""
    src, jsrc = PDBBindLMDBSource(stores[store]), JaxSource(stores[store])
    assert len(src) == len(jsrc.index)
    for i in range(len(src)):
        _assert_raw_equal(src.get(i), jsrc.get(i))
    if store == "plus":
        assert len(src.get(0)["isomorphisms"]) == 2
    raw = PDBBindLMDBSource(stores[store], use_esm2_feat=False).get(0)
    _assert_raw_equal(raw, JaxSource(stores[store],
                                     use_esm2_feat=False).get(0))
    assert "esm_feat" not in raw


@pytest.mark.parametrize("workers", [0, 2])
def test_loader_epoch_equals_jax(stores, workers):
    """A train epoch over the FABind+ store's split (shuffle, noisy crop,
    torsion noise, two buckets): the JAX Loader's batches, bit for bit,
    with the rows' full automorphism lists in the meta."""
    kw = dict(max_ligand=16, max_pocket=32, max_protein=48, ctx_k=8,
              ctx_k_whole=8, batch_size=2, train_ligand_torsion_noise=True)
    cfg, jcfg = preset("fabind_plus", **kw), jax_preset("fabind_plus", **kw)
    small = dataclasses.replace(cfg.shapes, max_ligand=8, max_pocket=24,
                                max_protein=32)
    jsmall = dataclasses.replace(jcfg.shapes, max_ligand=8, max_pocket=24,
                                 max_protein=32)
    src, idx = open_source(stores["plus"], "fabind_plus", "train")
    jsrc = JaxSource(stores["plus"])
    assert idx == [int(i) for i in jsrc.splits("fabind_plus")["train"]]
    got = list(Loader(src, idx, cfg, seed=3, workers=workers,
                      buckets=[small, cfg.shapes]).epoch(1, with_meta=True))
    want = list(JaxLoader(jsrc, idx, jcfg, seed=3, workers=workers,
                          buckets=[jsmall, jcfg.shapes]).epoch(
        1, with_meta=True))
    assert len(got) == len(want) >= 2
    for (a, ma), (b, mb) in zip(got, want):
        assert ma["pdb"] == mb["pdb"] and ma["n_valid"] == mb["n_valid"]
        assert all(_same(x, y) for x, y in zip(ma["iso"], mb["iso"]))
        for f in dataclasses.fields(JaxBatch):
            x, y = a[f.name], getattr(b, f.name)
            assert (x is None) == (y is None), f.name
            if x is not None:
                np.testing.assert_array_equal(x, np.asarray(y),
                                              err_msg=f.name)
    assert any(m["iso"][0] is not None and len(m["iso"][0]) == 2
               for _, m in got)


def test_open_source_probes_the_layout(stores, tmp_path):
    src, idx = open_source(stores["base"], split="test")
    assert isinstance(src, PDBBindLMDBSource) and idx == src.splits()["test"]
    assert open_source(stores["base"])[1] is None
    npz = tmp_path / "npz"
    npz.mkdir()
    np.savez(npz / "b.npz", x=1)
    np.savez(npz / "a.npz", x=1)
    src, idx = open_source(str(npz), split="test")
    assert isinstance(src, NPZSource) and idx == ["a", "b"]
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError, match="processed store"):
        open_source(str(tmp_path / "empty"))


# ---- preprocessing modes --------------------------------------------------

def _npz_dir(path):
    out = {}
    for f in sorted(os.listdir(path)):
        with np.load(os.path.join(path, f), allow_pickle=True) as z:
            out[f] = {k: z[k] for k in z.files}
    return out


def test_pdbbind_mode_equals_jax(stores, tmp_path):
    """The store -> an NPZ directory, with the full automorphism groups
    computed for data.pt rows and read from data_new.pt: the JAX mode's
    files, key for key, bit for bit; --limit cuts the rows."""
    for store, extra in (("base", ["--isomorphisms"]),
                         ("plus", ["--isomorphisms", "--limit", "5"])):
        a, b = tmp_path / f"{store}_port", tmp_path / f"{store}_jax"
        argv = ["pdbbind", "--data", stores[store], *extra]
        cli_preprocess.main(argv + ["--out", str(a)])
        jax_preprocess.main(argv + ["--out", str(b)])
        got, want = _npz_dir(a), _npz_dir(b)
        assert list(got) == list(want)
        assert len(got) == (5 if store == "plus" else 11)
        for f in want:
            _assert_raw_equal(got[f], want[f])
    assert NPZSource(str(tmp_path / "base_port")).get("tr00")[
        "isomorphisms"].shape[1] == 8


def test_inject_iso_equals_jax(stores, tmp_path):
    """data.pt -> data_new.pt: the JAX mode's column (use_compound_com
    False rows []), the other columns as they were; the identity first and
    every automorphism mapping labels and bonds onto themselves; each
    package's source reads the other's file."""
    from fabind_tpu_torch.data.isomorphism import iso_labels_from_arrays
    roots = {}
    for who in ("port", "jax"):
        roots[who] = str(tmp_path / who)
        make_reference_fixture(roots[who], symmetric=True)
    cli_preprocess.main(["inject-iso", "--data", roots["port"]])
    jax_preprocess.main(["inject-iso", "--data", roots["jax"]])
    got = torch.load(_index_path(roots["port"]), weights_only=False)
    want = torch.load(_index_path(roots["jax"]), weights_only=False)
    assert list(got.columns) == list(want.columns)
    for c in want.columns:
        for i in range(len(want)):
            assert _same(got[c].iloc[i], want[c].iloc[i]), (c, i)
    frame = F.load_frame(_index_path(roots["port"]))
    src = PDBBindLMDBSource(roots["port"])
    n_sym = 0
    for i in range(len(src)):
        isos = frame["isomorphics"][i]
        if not frame["use_compound_com"][i]:
            assert isos == []
            continue
        raw = src.get(i)
        labels = iso_labels_from_arrays(raw["lig_feats"], raw["bond_edges"],
                                        raw["bond_orders"])
        bonds = {tuple(e) for e in raw["bond_edges"].tolist()}
        assert (isos[0] == np.arange(len(labels))).all()
        for p in isos:
            assert (labels[p] == labels).all()
            assert {(int(p[i]), int(p[j])) for i, j in bonds} == bonds
        n_sym += len(isos) > 1
    assert n_sym >= 2
    for a, b in ((PDBBindLMDBSource(roots["jax"]), JaxSource(roots["jax"])),
                 (src, JaxSource(roots["port"]))):
        for i in range(len(b.index)):
            _assert_raw_equal(a.get(i), b.get(i))


def test_esm_lmdb_mode_equals_embed_sequences(stores, tmp_path):
    """protein_1d_3d.lmdb -> esm2_t33_650M_UR50D.lmdb with an encoder of
    the port (hidden 40, one layer): one pickled float32 row per protein,
    equal to embed_sequences of the decoded sequence."""
    root = tmp_path / "store"
    shutil.copytree(stores["base"], root)
    enc = Esm2Model(ESM_TOY)
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in enc.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.1)
    sd = str(tmp_path / "esm.pt")
    torch.save(enc.state_dict(), sd)
    cli_preprocess.main(["esm", "--lmdb", str(root), "--esm-weights", sd,
                         "--esm-batch", "2", "--device", "cpu"])
    p = root / "dataset" / "processed"
    seqs, rows = {}, {}
    with open_kv(str(p / "protein_1d_3d.lmdb")).begin() as txn:
        for k, v in txn.cursor():
            seqs[bytes(k)] = "".join(cli_preprocess._NUM_TO_LETTER[a]
                                     for a in pickle.loads(v)[1].tolist())
    with open_kv(str(p / "esm2_t33_650M_UR50D.lmdb")).begin() as txn:
        for k, v in txn.cursor():
            rows[bytes(k)] = pickle.loads(v)
    assert sorted(rows) == sorted(seqs) and len(rows) == 11
    want = load_esm2(sd).embed_sequences(list(seqs.values()))
    for k, w in zip(seqs, want):
        assert rows[k].dtype == np.float32 and rows[k].shape == w.shape
        np.testing.assert_allclose(rows[k], w, atol=1e-5, rtol=0)
    # --esm-dp 2: two CPU replicas of the encoder write the same rows
    root2 = tmp_path / "store2"
    shutil.copytree(stores["base"], root2)
    cli_preprocess.main(["esm", "--lmdb", str(root2), "--esm-weights", sd,
                         "--esm-batch", "2", "--esm-dp", "2", "--device",
                         "cpu"])
    with open_kv(str(root2 / "dataset" / "processed"
                     / "esm2_t33_650M_UR50D.lmdb")).begin() as txn:
        rows2 = {bytes(k): pickle.loads(v) for k, v in txn.cursor()}
    assert sorted(rows2) == sorted(rows)
    for k in rows:
        np.testing.assert_allclose(rows2[k], rows[k], atol=1e-5, rtol=0)


# ---- the drivers -------------------------------------------------------------

def _sets(extra=()):
    out = []
    for s in CLI_SETS + list(extra):
        out += ["--set", s]
    return out


def _train(data, out, preset_name, on_step=None, eval_every=1):
    argv = ["--preset", preset_name, "--data", data, "--output", str(out),
            "--epochs", "1", "--batch-size", "2", "--workers", "0",
            "--prefetch", "0", "--buckets", "none", "--eval-every",
            str(eval_every), "--device", "cpu", *_sets()]
    assert cli_train.main(argv, on_step=on_step) == 0


def _logged_count(out, prefix):
    """The number a driver's log line `prefix N complexes` states."""
    for line in (out / "log.txt").read_text().splitlines():
        if prefix in line:
            return int(line.split(prefix)[1].split()[0])
    raise AssertionError(f"no '{prefix}' in {out}/log.txt")


def test_drivers_on_the_store(stores, tmp_path):
    """Base cli.train from data.pt and FABind+ from data_new.pt on the
    reference's splits (the FABind+ batches carry the two-element groups),
    cli.evaluate --split test --unseen-index, cli.sample over the test
    split and cli.train_confidence on the train and valid rows."""
    base = JaxSource(stores["base"]).splits("fabind")
    steps = []
    _train(stores["base"], tmp_path / "base", "fabind",
           on_step=lambda s, m, meta: steps.append((m, meta)))
    log = (tmp_path / "base" / "log.txt").read_text()
    assert (f"splits: {({k: len(v) for k, v in base.items()})}" in log)
    assert len(steps) == 2 and all(
        np.isfinite(m["loss"]) and m["skipped_nan"] == 0 for m, _ in steps)
    assert sorted(p for _, meta in steps for p in meta["pdb"]) == \
        ["tr00", "tr01", "tr02", "tr03"]
    assert "valid_stage2" in log

    plus = []
    _train(stores["plus"], tmp_path / "plus", "fabind_plus", eval_every=0,
           on_step=lambda s, m, meta: plus.append(meta))
    groups = {p: len(x) for meta in plus for p, x in zip(meta["pdb"],
                                                          meta["iso"])}
    assert groups == {"tr00": 2, "tr01": 2, "tr02": 2, "tr03": 2,
                      "xxlig": 1}

    unseen = os.path.join(stores["base"], "split_pdb_id", "unseen_test_index")
    m = cli_evaluate.main(["--data", stores["base"], "--ckpt",
                           str(tmp_path / "base"), "--split", "test",
                           "--unseen-index", unseen, "--batch-size", "2",
                           "--workers", "0", "--prefetch", "0",
                           "--save-rmsd", str(tmp_path / "rmsd.txt"),
                           "--device", "cpu", *_sets()])
    assert m["n"] == 1 and np.isfinite(m["rmsd_mean"])
    assert (tmp_path / "rmsd.txt").read_text().split()[0] == "te00"

    m = cli_sample.main(["--ckpt", str(tmp_path / "plus"), "--data",
                         stores["plus"], "--sample-size", "2",
                         "--batch-size", "2", "--out",
                         str(tmp_path / "sample.json"), "--device", "cpu",
                         *_sets(["dropout=0.0", "use_clustering=false"])])
    assert m["n"] == len(JaxSource(stores["plus"]).splits(
        "fabind_plus")["test"]) == 2

    plus_splits = JaxSource(stores["plus"]).splits("fabind_plus")
    out = tmp_path / "conf"
    assert cli_conf.main(["--data", stores["plus"], "--output", str(out),
                          "--init-ckpt", str(tmp_path / "plus"),
                          "--epochs", "1", "--batch-size", "2",
                          "--num-copies", "2", "--device", "cpu",
                          *_sets()]) == 0
    assert _logged_count(out, "confidence train set: ") == \
        len(plus_splits["train"]) + len(plus_splits["valid"])


def test_cli_serve_buckets_auto_from_the_store(stores, monkeypatch):
    """cli.serve --buckets auto:2 --data STORE measures the store's test
    split and serves JAX's buckets (both engines and servers stubbed)."""
    import fabind_tpu.serve as jax_serve
    import fabind_tpu.serve_http as jax_http
    from fabind_tpu.cli import serve as jax_serve_cli

    import fabind_tpu_torch.serve as torch_serve
    import fabind_tpu_torch.serve_http as torch_http
    from fabind_tpu_torch.cli import serve as serve_cli
    got = {}

    def fake_engine(tag):
        def make(cfg, **kw):
            got[tag] = [(s.max_ligand, s.max_pocket, s.max_protein)
                        for s in kw["buckets"]]
            return object()
        return make

    monkeypatch.setattr(jax_serve, "DockingEngine", fake_engine("jax"))
    monkeypatch.setattr(torch_serve, "DockingEngine", fake_engine("torch"))
    for mod in (jax_http, torch_http):
        monkeypatch.setattr(mod, "serve_forever", lambda *a, **k: None)
    argv = ["--buckets", "auto:2", "--data", stores["base"], *_sets()]
    jax_serve_cli.main(argv)
    serve_cli.main(argv + ["--device", "cpu"])
    assert got["torch"] == got["jax"] and got["jax"]
