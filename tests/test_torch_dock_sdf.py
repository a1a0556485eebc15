"""The port's structure-file entry point against the JAX package's, on the
CPU in fp32 at toy width: `DockingEngine.dock_sdf` (with and without
randomize_init, a bad ligand in the middle), the /dock_sdf route of the
daemon, `cli.inference --ligand-sdf-dir` and `cli.preprocess` (esm and
inference).

Both engines get the same FABind weights (the JAX engine's init, carried
across by state_dict_from_flax) and the same ESM2 weights: the JAX
package's `featurize.extract_esm_feature` is patched to its flax encoder,
the port's engine gets its own encoder with the weights
`esm_state_dict_from_flax` carries across. The encoder is cut to one layer
and a 64-wide feed-forward but keeps the hidden width 1280: FABind's
protein input is 1280 wide. Proteins are written as PDB files and ligands
as V2000 SDF files with explicit hydrogens and rings (chip_smoke.py's
writers).
"""
from __future__ import annotations

import csv
import json
import os
import sys
import threading
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from chip_smoke import pdb_text
from common import TINY
from test_torch_featurize import synthetic_ligand

from fabind_tpu.cli import inference as jax_inference
from fabind_tpu.cli import preprocess as jax_preprocess
from fabind_tpu.config import preset as jax_preset
from fabind_tpu.data import featurize as JF
from fabind_tpu.models import esm2 as JE
from fabind_tpu.serve import DockingEngine as JaxEngine
from fabind_tpu.serve import Pose as JaxPose
from fabind_tpu.serve_http import make_server as jax_make_server

from fabind_tpu_torch import serve as port_serve
from fabind_tpu_torch.cli import inference as cli_inference
from fabind_tpu_torch.cli import preprocess as cli_preprocess
from fabind_tpu_torch.config import preset
from fabind_tpu_torch.data import featurize as F
from fabind_tpu_torch.data.dataset import open_source
from fabind_tpu_torch.models.esm2 import Esm2Config, Esm2Model
from fabind_tpu_torch.serve import DockingEngine, Pose
from fabind_tpu_torch.serve_http import make_server
from fabind_tpu_torch.train.convert import (esm_state_dict_from_flax,
                                            load_esm_state_dict,
                                            state_dict_from_flax)

# poses of two fp32 engines after two recycles (tests/test_golden_torch.py's
# convention); the ESM2 embeddings, 1e-6 apart, feed them
ATOL_A = 2e-4
ESM_ATOL = 1e-5
ESM_TOY = dict(hidden_size=1280, num_layers=1, num_heads=20,
               intermediate_size=64)
N_PROTEINS, N_LIGANDS = 3, 5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's torch work: its tensors are
    toy-sized, and the suite runs in parallel workers that would otherwise
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _write_files(root):
    """N_PROTEINS PDB files of 30-45 residues and N_LIGANDS ligand SDFs of
    8-14 heavy atoms (one or two rings, explicit H) placed at a protein's
    first residues; returns (pdb paths, sdf paths, pairs)."""
    rng = np.random.RandomState(7)
    pdbs, sdfs, pairs = [], [], []
    aas = sorted(F.THREE_TO_ONE.values())
    for i in range(N_PROTEINS):
        n = int(rng.randint(30, 46))
        seq = "".join(rng.choice(aas, n))
        ca = rng.randn(n, 3) * 2.5 + rng.randn(3) * 20
        ca[12:] += 60.0            # a pocket of 12 residues
        path = root / f"p{i}.pdb"
        path.write_text(pdb_text(seq, ca))
        pdbs.append((str(path), ca[:4].mean(0)))
    for k in range(N_LIGANDS):
        pdb, site = pdbs[k % N_PROTEINS]
        symbols, coords, bonds = synthetic_ligand(
            rng, int(rng.randint(8, 15)), n_rings=1 + k % 2, center=site)
        path = root / f"l{k}.sdf"
        F.write_sdf(str(path), symbols, coords, bonds, name=f"l{k}")
        sdfs.append(str(path))
        pairs.append((str(path), pdb))
    return [p for p, _ in pdbs], sdfs, pairs


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The JAX engine (its own fp32 init, one TINY bucket) with the flax
    encoder patched into its featurizer, the port engine with the same
    weights and its own encoder, and the structure files."""
    root = tmp_path_factory.mktemp("structures")
    pdbs, sdfs, pairs = _write_files(root)
    jesm = JE.Esm2Model(JE.Esm2Config(**ESM_TOY))
    ids = np.asarray([JE.tokenize("LAGV")])
    eparams = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda: jesm.init(jax.random.PRNGKey(1), ids, ids * 0 + 1))(
    )["params"])
    eparams["word_embeddings"]["embedding"] = np.random.RandomState(
        2).randn(33, 1280).astype(np.float32)
    esm = Esm2Model(Esm2Config(**ESM_TOY))
    load_esm_state_dict(esm, esm_state_dict_from_flax(eparams))

    def jax_esm(seq, **kw):
        return JE.embed_sequences(jesm, eparams, [seq])[0]

    mp = pytest.MonkeyPatch()
    mp.setattr(JF, "extract_esm_feature", jax_esm)
    mp.setitem(JF._ESM_CACHE, ("facebook/esm2_t33_650M_UR50D", "jax"),
               (jesm, eparams))
    jeng = JaxEngine(jax_preset("fabind", **TINY), batch_size=2, bf16=False)
    sd = state_dict_from_flax(jax.tree_util.tree_map(np.asarray,
                                                     jeng.params),
                              is_plus=False)
    eng = DockingEngine(preset("fabind", **TINY), state_dict=sd,
                        batch_size=2, bf16=False, device="cpu", esm=esm)
    yield dict(root=root, pdbs=pdbs, sdfs=sdfs, pairs=pairs, jeng=jeng,
               eng=eng, sd=sd, esm=esm, jesm=jesm, eparams=eparams)
    mp.undo()


def _assert_poses_match(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.error == w.error
        if w.error is not None:
            assert g.coords.shape == (0, 3)
            continue
        assert g.coords.dtype == np.float32
        assert g.coords.shape == w.coords.shape
        np.testing.assert_allclose(g.coords, w.coords, atol=ATOL_A, rtol=0)
        assert g.sdf_meta["symbols"] == w.sdf_meta["symbols"]
        assert g.sdf_meta["bonds"] == w.sdf_meta["bonds"]
        np.testing.assert_array_equal(g.sdf_meta["charges"],
                                      w.sdf_meta["charges"])


def test_dock_sdf_matches_jax(setup):
    """Path and text ligands, a molfile that does not parse and a missing
    file in the middle; then randomize_init with one seed (the same draws
    from one RandomState in request order: a failed request consumes
    nothing) and another seed. A second call embeds no protein again."""
    eng, jeng = setup["eng"], setup["jeng"]
    pairs = list(setup["pairs"])
    text = open(pairs[1][0]).read()
    reqs = (pairs[:1] + [(text, pairs[1][1]), ("no molfile\n", pairs[2][1]),
                         (str(setup["root"] / "missing.sdf"), pairs[2][1])]
            + pairs[2:])
    calls = []
    embed = eng.esm.embed_sequences
    eng.esm.embed_sequences = lambda *a, **k: calls.append(1) or embed(
        *a, **k)
    try:
        got = eng.dock_sdf(reqs)
        assert len(calls) == N_PROTEINS
        _assert_poses_match(got, jeng.dock_sdf(reqs))
        assert [p.error is None for p in got] == [True, True, False, False,
                                                  True, True, True]
        again = eng.dock_sdf(reqs)
        assert len(calls) == N_PROTEINS      # the protein LRU
        for a, b in zip(again, got):
            np.testing.assert_array_equal(a.coords, b.coords)
    finally:
        del eng.esm.embed_sequences
    rand = eng.dock_sdf(reqs, randomize_init=True, seed=3)
    _assert_poses_match(rand, jeng.dock_sdf(reqs, randomize_init=True,
                                            seed=3))
    other = eng.dock_sdf(reqs, randomize_init=True, seed=4)
    moved = [np.abs(a.coords - b.coords).max() for a, b, c in
             zip(rand, other, got) if c.error is None]
    assert min(moved) > 1e-3


def test_engine_without_encoder_and_smiles_requests(setup, monkeypatch):
    """Without an encoder a PDB request is an error Pose; a SMILES request
    fails with the JAX engine's error on a host without RDKit (RDKit made
    unimportable here: another test module may have stubbed it)."""
    eng = DockingEngine(preset("fabind", **TINY), state_dict=setup["sd"],
                        batch_size=2, bf16=False, device="cpu")
    poses = eng.dock_sdf(setup["pairs"][:2])
    assert all("no ESM2 encoder" in p.error for p in poses)
    smiles = [("CCO", setup["pdbs"][0]), ("c1ccccc1", setup["pdbs"][1])]
    monkeypatch.setitem(sys.modules, "rdkit", None)
    got, want = eng.dock_smiles(smiles), setup["jeng"].dock_smiles(smiles)
    assert [p.error for p in got] == [p.error for p in want]
    assert got[0].error.startswith("ImportError: RDKit is required")


# ------------------------------------------------------------- the daemon
def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 method="POST",
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _serve(make, engine, root):
    srv = make(engine, "127.0.0.1", 0, pdb_root=str(root))
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    return srv, t, f"http://127.0.0.1:{srv.server_address[1]}"


def test_http_dock_sdf_matches_jax(setup):
    """/dock_sdf over a socket on both daemons: the same JSON keys and
    errors, poses within ATOL_A, the sdf field parsed back equal to the
    pose to the writer's 1e-4 A; 400 for a bare ligand path and for a PDB
    path that leaves --pdb-root; ?randomize_init=1&seed=K as the engine."""
    root = setup["root"]
    body = [{"sdf": open(s).read(), "pdb": os.path.basename(p)}
            for s, p in setup["pairs"][:3]]
    body.insert(1, {"sdf": "no molfile\n", "pdb": "p0.pdb"})
    servers = [_serve(make_server, setup["eng"], root),
               _serve(jax_make_server, setup["jeng"], root)]
    try:
        (st, got), (jst, want) = (_post(b + "/dock_sdf", body)
                                  for _, _, b in servers)
        assert st == jst == 200
        assert [sorted(g) for g in got] == [sorted(w) for w in want]
        assert "sdf" in got[0] and "sdf" not in got[1]
        for g, w in zip(got, want):
            assert g["error"] == w["error"]
            if g["error"] is not None:
                continue
            c = np.asarray(g["coords"], np.float32)
            np.testing.assert_allclose(c, w["coords"], atol=ATOL_A)
            parsed, jparsed = (F.parse_sdf_text(d["sdf"]) for d in (g, w))
            np.testing.assert_allclose(parsed["coords"], c, atol=1e-4)
            assert parsed["symbols"] == jparsed["symbols"]
            assert parsed["bonds"] == jparsed["bonds"]
            np.testing.assert_array_equal(parsed["charges"],
                                          jparsed["charges"])
        direct = setup["eng"].dock_sdf(
            [(r["sdf"], str(root / r["pdb"])) for r in body],
            randomize_init=True, seed=5)
        st, rand = _post(servers[0][2] + "/dock_sdf?randomize_init=1&seed=5",
                         body)
        for r, d in zip(rand, direct):
            assert r["error"] == d.error
            if d.error is None:
                np.testing.assert_array_equal(
                    np.asarray(r["coords"], np.float32), d.coords)
        for _, _, base in servers:
            st, err = _post(base + "/dock_sdf", [
                {"sdf": setup["sdfs"][0], "pdb": "p0.pdb"}])
            assert st == 400 and "inline" in err["error"]
            st, err = _post(base + "/dock_sdf", [
                {"sdf": body[0]["sdf"], "pdb": "../p0.pdb"}])
            assert st == 400 and "escapes --pdb-root" in err["error"]
    finally:
        for srv, t, _ in servers:
            srv.shutdown()
            srv.server_close()
            t.join(timeout=30)
            assert not t.is_alive()


# ---------------------------------------------------------------- the CLIs
def _index(path, rows, fields):
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=fields)
        w.writeheader()
        w.writerows(rows)


def test_cli_inference_writes_what_jax_writes(setup, tmp_path, monkeypatch):
    """The same stub poses through both CLIs: byte-equal SDF files and
    index rows (names from the crc32 of the smiles or ligand id, `_r{k}`
    for repeats, skipped errors), then the port's CLI with its real engine
    on the CPU: each written SDF holds the engine's pose."""
    lig_dir = tmp_path / "ligs"
    lig_dir.mkdir()
    rows = []
    for k, sdf in enumerate(setup["sdfs"]):
        (lig_dir / f"l{k}.sdf").write_text(open(sdf).read())
        rows.append({"pdb_file": f"p{k % N_PROTEINS}", "ligand_id": f"l{k}",
                     "smiles": "" if k % 2 else f"C{k}"})
    rows.append(dict(rows[1]))                # a repeated name
    rows.append({"pdb_file": "p0", "ligand_id": "nothere", "smiles": ""})
    idx = tmp_path / "index.csv"
    _index(idx, rows, ["pdb_file", "ligand_id", "smiles"])
    pdb_dir = os.path.dirname(setup["pdbs"][0])

    def stub(pose_cls):
        class _Engine:
            def __init__(self, *a, **k):
                pass

            def dock_sdf(self, requests):
                out = []
                for i, (lig, _) in enumerate(requests):
                    if not os.path.exists(lig):
                        out.append(pose_cls(coords=np.zeros((0, 3)),
                                            confidence=0.0,
                                            error="FileNotFoundError"))
                        continue
                    f = F.featurize_sdf(lig)
                    out.append(pose_cls(
                        coords=f["coords"] + np.float32(i),
                        confidence=0.0, sdf_meta={
                            "symbols": f["symbols"],
                            "bonds": f["heavy_bonds"],
                            "charges": f["charges"]}))
                return out
        return _Engine

    common = ["--index", str(idx), "--pdb-dir", pdb_dir, "--ligand-sdf-dir",
              str(lig_dir)]
    monkeypatch.setattr("fabind_tpu.serve.DockingEngine", stub(JaxPose))
    jax_inference.main(["--ckpt", "unused.bin", "--output",
                        str(tmp_path / "jax")] + common)
    monkeypatch.setattr(port_serve, "DockingEngine", stub(Pose))
    monkeypatch.setattr("fabind_tpu_torch.models.esm2.load_esm2",
                        lambda path: None)
    monkeypatch.setattr("fabind_tpu_torch.train.checkpoints.load_weights",
                        lambda path: None)
    cli_inference.main(["--ckpt", "unused.bin", "--esm-weights", "unused",
                        "--device", "cpu", "--output",
                        str(tmp_path / "port")] + common)
    monkeypatch.undo()

    def read_index(d):
        with open(d / "index.csv") as f:
            return [dict(r, sdf=os.path.relpath(r["sdf"], d))
                    for r in csv.DictReader(f)]

    jrows, prows = read_index(tmp_path / "jax"), read_index(tmp_path / "port")
    assert prows == jrows and len(prows) == len(rows) - 1
    assert any(r["sdf"].endswith("_r2.sdf") for r in prows)
    for r in prows:
        assert ((tmp_path / "port" / r["sdf"]).read_bytes()
                == (tmp_path / "jax" / r["sdf"]).read_bytes())

    # the real engine: weights and encoder from files, on the CPU
    torch.save(setup["sd"], tmp_path / "fabind.pt")
    torch.save(setup["esm"].state_dict(), tmp_path / "esm.pt")
    sets = []
    for k, v in TINY.items():
        sets += ["--set", f"{k}={v}"]
    real = tmp_path / "real"
    cli_inference.main(["--ckpt", str(tmp_path / "fabind.pt"),
                        "--esm-weights", str(tmp_path / "esm.pt"),
                        "--device", "cpu", "--batch-size", "2",
                        "--output", str(real)] + common + sets)
    want = setup["eng"].dock_sdf(
        [(str(lig_dir / f"{r['ligand_id']}.sdf"),
          os.path.join(pdb_dir, r["pdb_file"] + ".pdb")) for r in rows])
    written = read_index(real)
    assert len(written) == len(rows) - 1
    for r, w in zip(written, [p for p in want if p.error is None]):
        np.testing.assert_allclose(F.sdf_coords(str(real / r["sdf"])),
                                   w.coords, atol=1e-4)


def test_cli_preprocess_esm_and_inference_match_jax(setup, tmp_path):
    """`esm`: FASTA -> .npy equal to embed_sequences at --esm-batch 2 and
    within ESM_ATOL of the JAX CLI's (its flax encoder); `inference` with
    sdf rows and a SMILES row (skipped on both sides): the NPZ files hold
    the JAX CLI's keys and values, and the directory is read back by
    NPZSource and docked; with --isomorphisms each file also holds the
    ligand's full automorphism group as JAX's VF2 enumerates it, in its
    order. --esm-dp 2 (two encoder replicas) writes dp=1's .npy files."""
    esm_pt = tmp_path / "esm.pt"
    torch.save(setup["esm"].state_dict(), esm_pt)
    seqs = {f"s{i}": F.parse_pdb_atoms(p)["seq"]
            for i, p in enumerate(setup["pdbs"])}
    seqs["short"] = "MKV"
    fasta = tmp_path / "seqs.fasta"
    fasta.write_text("".join(f">{k}\n{v[:20]}\n{v[20:]}\n"
                             for k, v in seqs.items()))
    port = ["--esm-weights", str(esm_pt), "--device", "cpu"]
    cli_preprocess.main(["esm", "--seqs", str(fasta), "--out",
                         str(tmp_path / "esm"), "--esm-batch", "2"] + port)
    jax_preprocess.main(["esm", "--seqs", str(fasta), "--out",
                         str(tmp_path / "jesm"), "--esm-device", "jax",
                         "--esm-batch", "2"])
    want = setup["esm"].embed_sequences(list(seqs.values()), batch_size=2)
    for (name, seq), w in zip(seqs.items(), want):
        got = np.load(tmp_path / "esm" / f"{name}.npy")
        assert got.shape == (len(seq), 1280)
        np.testing.assert_array_equal(got, w)
        np.testing.assert_allclose(
            got, np.load(tmp_path / "jesm" / f"{name}.npy"), atol=ESM_ATOL,
            rtol=0)

    rows = [{"name": f"c{k}", "sdf": sdf, "pdb_file": pdb, "smiles": ""}
            for k, (sdf, pdb) in enumerate(setup["pairs"])]
    rows.insert(2, {"name": "smi", "sdf": "", "pdb_file": setup["pdbs"][0],
                    "smiles": "CCO"})
    idx = tmp_path / "rows.csv"
    _index(idx, rows, ["name", "sdf", "pdb_file", "smiles"])
    cli_preprocess.main(["inference", "--index", str(idx), "--out",
                         str(tmp_path / "npz")] + port)
    jax_preprocess.main(["inference", "--index", str(idx), "--out",
                         str(tmp_path / "jnpz")])
    names = sorted(os.listdir(tmp_path / "npz"))
    assert names == sorted(os.listdir(tmp_path / "jnpz"))
    assert names == [f"c{k}.npz" for k in range(N_LIGANDS)]
    for n in names:
        with np.load(tmp_path / "npz" / n) as a, \
                np.load(tmp_path / "jnpz" / n) as b:
            assert sorted(a.files) == sorted(b.files)
            for k in a.files:
                assert a[k].dtype == b[k].dtype, k
                if k == "esm_feat":
                    np.testing.assert_allclose(a[k], b[k], atol=ESM_ATOL)
                else:
                    np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    src, names = open_source(str(tmp_path / "npz"))
    poses = setup["eng"].dock_raw([src.get(n) for n in names])
    assert all(p.error is None and np.isfinite(p.coords).all()
               for p in poses)

    from fabind_tpu.data.isomorphism import automorphisms_from_graph
    cli_preprocess.main(["inference", "--index", str(idx), "--out",
                         str(tmp_path / "iso"), "--isomorphisms"] + port)
    for n in names:
        with np.load(tmp_path / "iso" / f"{n}.npz") as a, \
                np.load(tmp_path / "jnpz" / f"{n}.npz") as b:
            assert sorted(a.files) == sorted(b.files + ["isomorphisms"])
            want = automorphisms_from_graph(
                b["lig_feats"].shape[0], b["bond_edges"], b["iso_labels"],
                max_iso=None)
            np.testing.assert_array_equal(a["isomorphisms"], want)
    cli_preprocess.main(["esm", "--seqs", str(fasta), "--out",
                         str(tmp_path / "esm_dp"), "--esm-batch", "2",
                         "--esm-dp", "2"] + port)
    for name, seq in seqs.items():
        got = np.load(tmp_path / "esm_dp" / f"{name}.npy")
        assert got.shape == (len(seq), 1280)
        np.testing.assert_allclose(
            got, np.load(tmp_path / "esm" / f"{name}.npy"), atol=1e-6,
            rtol=0)


def test_cli_serve_takes_an_encoder_and_a_pdb_root(setup, tmp_path,
                                                   monkeypatch):
    """cli.serve --esm-weights loads the encoder into the engine (on the
    engine's device, float32 whatever --no-bf16 says) and passes
    --pdb-root to the daemon; without --esm-weights there is none."""
    import fabind_tpu_torch.serve_http as sh
    from fabind_tpu_torch.cli import serve as cli_serve
    captured = {}
    monkeypatch.setattr(sh, "serve_forever", lambda engine, host, port,
                        pdb_root=None: captured.update(engine=engine,
                                                       pdb_root=pdb_root))
    torch.save(setup["esm"].state_dict(), tmp_path / "esm.pt")
    sets = [a for k, v in TINY.items() for a in ("--set", f"{k}={v}")]
    cli_serve.main(["--device", "cpu", "--esm-weights",
                    str(tmp_path / "esm.pt"), "--pdb-root",
                    str(setup["root"])] + sets)
    eng = captured["engine"]
    assert captured["pdb_root"] == str(setup["root"])
    assert eng.bf16 and next(eng.esm.parameters()).dtype == torch.float32
    for a, b in zip(eng.esm.state_dict().values(),
                    setup["esm"].state_dict().values()):
        assert torch.equal(a, b)
    poses = eng.dock_sdf(setup["pairs"][:2])
    assert all(p.error is None and np.isfinite(p.coords).all()
               for p in poses)
    cli_serve.main(["--device", "cpu"] + sets)
    assert captured["engine"].esm is None and captured["pdb_root"] is None
