"""The geometric protein features of the port against the JAX package on the
CPU: `protein_gvp_features`, `build_sample` with use_esm2_feat=False (15-d
features) and esm2_concat_raw ([esm 1280 ++ gvp 15]) and its KeyError
without backbone coordinates, a `use_esm2_feat=False` DockingEngine against
the JAX engine, and the two other numpy-only featurization helpers
(`select_chain_within_cutoff`, `compound_pair_dis_distribution`).

Inputs are made with numpy from seeds; the engines share the JAX engine's
init (state_dict_from_flax), fp32.
"""
from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from common import TINY
from test_serve import make_raw

from fabind_tpu.config import preset as jax_preset
from fabind_tpu.data import featurize as jax_featurize
from fabind_tpu.data.batching import build_sample as jax_build_sample
from fabind_tpu.serve import DockingEngine as JaxEngine

from fabind_tpu_torch.config import preset
from fabind_tpu_torch.data import featurize
from fabind_tpu_torch.data.batching import build_sample
from fabind_tpu_torch.serve import DockingEngine
from fabind_tpu_torch.train.convert import state_dict_from_flax

POSE_ATOL = 2e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's torch work: its tensors are
    toy-sized, and the suite runs in parallel workers that would otherwise
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _backbone(ca, seed):
    """N/CA/C/O [Nr, 4, 3] around each CA, seeded."""
    rng = np.random.RandomState(seed)
    offsets = np.array([[-1.2, 0.6, 0.0], [0.0, 0.0, 0.0], [1.3, 0.5, 0.2],
                        [1.8, 1.5, -0.4]], np.float32)
    return (ca[:, None, :] + offsets[None]
            + 0.3 * rng.randn(len(ca), 4, 3)).astype(np.float32)


def _gvp_raw(n, nr, seed):
    raw = make_raw(n=n, nr=nr, seed=seed)
    raw["protein_full_coords"] = _backbone(raw["protein_xyz"], seed + 100)
    return raw


def test_protein_gvp_features_match_jax():
    rng = np.random.RandomState(0)
    ca = np.cumsum(rng.randn(40, 3) * 2.0, axis=0).astype(np.float32)
    coords = _backbone(ca, 1)
    coords[7] = coords[6]          # a residue on top of another
    got = featurize.protein_gvp_features(coords)
    want = jax_featurize.protein_gvp_features(coords)
    assert got.shape == (40, 15) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got[0, [0, 3]], [1.0, 0.0])  # no phi


@pytest.mark.parametrize("flags,dim", [(dict(use_esm2_feat=False), 15),
                                       (dict(esm2_concat_raw=True), 1295)])
@pytest.mark.parametrize("group", ["train", "test"])
def test_build_sample_protein_features_match_jax(flags, dim, group):
    cfg = preset("fabind", **flags, **TINY)
    jcfg = jax_preset("fabind", **flags, **TINY)
    assert cfg.model.protein_feat_dim == dim
    raw = _gvp_raw(9, 30, 2)
    if not cfg.model.esm2_concat_raw:
        del raw["esm_feat"]
    got = build_sample(raw, cfg, group=group, rng=np.random.RandomState(4))
    want = jax_build_sample(raw, jcfg, group=group,
                            rng=np.random.RandomState(4))
    assert set(got) == set(want)
    assert got["prot_feat"].shape == (30, dim)
    for k, v in want.items():
        if isinstance(v, np.ndarray):
            np.testing.assert_array_equal(got[k], v, err_msg=k)
        else:
            assert got[k] == v, k


@pytest.mark.parametrize("flags", [dict(use_esm2_feat=False),
                                   dict(esm2_concat_raw=True)])
def test_build_sample_needs_backbone_like_jax(flags):
    raw = make_raw(n=5, nr=20, seed=1)
    with pytest.raises(KeyError, match="protein_full_coords"):
        build_sample(raw, preset("fabind", **flags, **TINY), group="test")
    with pytest.raises(KeyError, match="protein_full_coords"):
        jax_build_sample(raw, jax_preset("fabind", **flags, **TINY),
                         group="test")


def test_gvp_engine_matches_jax():
    """dock_raw of a use_esm2_feat=False engine (15-d protein input) on
    both sides, on the JAX engine's init."""
    cfg = preset("fabind", use_esm2_feat=False, **TINY)
    jcfg = jax_preset("fabind", use_esm2_feat=False, **TINY)
    jeng = JaxEngine(jcfg, batch_size=2, bf16=False)
    params = jax.tree_util.tree_map(np.asarray, jeng.params)
    raws = [_gvp_raw(5, 20, 1), _gvp_raw(7, 40, 2), _gvp_raw(12, 30, 3)]
    for r in raws:
        del r["esm_feat"]
    want = jeng.dock_raw(raws)
    eng = DockingEngine(cfg, state_dict=state_dict_from_flax(
        params, is_plus=False), batch_size=2, bf16=False, device="cpu")
    got = eng.dock_raw(raws)
    for g, w in zip(got, want):
        assert g.error is None and w.error is None
        np.testing.assert_allclose(g.coords, w.coords, rtol=0,
                                   atol=POSE_ATOL)
        assert g.pocket_truncated == w.pocket_truncated


def _pdb_line(serial, name, resname, chain, resseq, xyz, record="ATOM  "):
    return (f"{record}{serial:5d} {name:<4} {resname:>3} {chain}{resseq:4d}"
            f"    {xyz[0]:8.3f}{xyz[1]:8.3f}{xyz[2]:8.3f}  1.00  0.00"
            f"           {name[0]}\n")


def _three_chain_pdb(path, rng):
    """Chain A next to the ligand, chain B far away, chain C near it but
    only through a residue without CA (which does not count), a HETATM
    and TER records of each chain, and a short TER."""
    lines, serial = ["HEADER    TEST\n"], 1
    for chain, center, with_ca in (("A", 0.0, True), ("B", 80.0, True),
                                   ("C", 3.0, False)):
        for res in range(3):
            names = ("N", "CA", "C", "O") if with_ca else ("N", "C", "O")
            for name in names:
                xyz = center + rng.randn(3) * 1.5 + (0 if with_ca else 2.0)
                lines.append(_pdb_line(serial, name, "ALA", chain, res + 1,
                                       xyz))
                serial += 1
        lines.append(_pdb_line(serial, "O", "HOH", chain, 90, [center] * 3,
                               record="HETATM"))
        lines.append(f"TER   {serial + 1:5d}      ALA {chain}   3\n")
        serial += 2
    lines += ["TER\n", "END\n"]
    path.write_text("".join(lines))


def test_select_chain_within_cutoff_matches_jax(tmp_path):
    rng = np.random.RandomState(3)
    pdb = tmp_path / "in.pdb"
    _three_chain_pdb(pdb, rng)
    lig = rng.randn(6, 3).astype(np.float32)
    for cutoff in (4.0, 10.0, 200.0):
        got = featurize.select_chain_within_cutoff(
            str(pdb), lig, cutoff, str(tmp_path / "got.pdb"))
        want = jax_featurize.select_chain_within_cutoff(
            str(pdb), lig, cutoff, str(tmp_path / "want.pdb"))
        assert got == want
        assert ((tmp_path / "got.pdb").read_bytes()
                == (tmp_path / "want.pdb").read_bytes())
    assert got == ["A", "B"]


@pytest.mark.parametrize("las", [False, True])
def test_compound_pair_dis_distribution_matches_jax(las):
    rng = np.random.RandomState(5)
    coords = (rng.randn(11, 3) * 6.0).astype(np.float32)
    mask = rng.rand(11, 11) < 0.4 if las else None
    got = featurize.compound_pair_dis_distribution(coords, mask)
    want = jax_featurize.compound_pair_dis_distribution(coords, mask)
    assert got.shape == (11, 11, 16) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert (got.sum(-1) == 1).all()
