"""ctypes bindings for the port's native batch packer (csrc/collate.cc).

Counterpart of fabind_tpu/data/native.py. `collate_native` returns the same
dict of numpy arrays as the python collator `data.batching.collate`, so
`FABindBatch.from_numpy` takes either; C does the row copies, the bond
neighbour table and the LAS adjacency.

The library is built at first use with the host C++ compiler (`$CXX`, else
`g++`) into build/native/ at the root of the checkout, its file name
carrying a hash of the source and the flags, so an edited source rebuilds.
The build writes a temporary file and renames it into place, so concurrent
builders never load a half-written library. A failed build or load raises
with the compiler's output; nothing falls back to the python collator.

No runtime path calls it: the Loader, the engine and the CLIs use
`collate`, as the JAX package's do. Isomorphism tables are not packed
(samples that carry them raise NotImplementedError), the same limitation as
the JAX package's.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

from fabind_tpu_torch.data.batching import SampleTooLarge

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "collate.cc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ("-O3", "-shared", "-fPIC")

_LIB = None
_LOCK = threading.Lock()


def compiler() -> str:
    """The host C++ compiler: $CXX, else g++ on PATH."""
    cxx = os.environ.get("CXX") or "g++"
    found = shutil.which(cxx)
    if found is None:
        raise RuntimeError(f"C++ compiler {cxx!r} not found (set CXX or put "
                           f"g++ on PATH)")
    return found


def lib_path(out_dir: Optional[str] = None) -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return (Path(out_dir) if out_dir else BUILD_DIR) / \
        f"libfabind_collate-{h.hexdigest()[:16]}.so"


def build_library(out_dir: Optional[str] = None) -> str:
    """Compile csrc/collate.cc unless its library is already built; returns
    the library's path. Raises RuntimeError with the compiler's output when
    the build fails."""
    out = lib_path(out_dir)
    if out.exists():
        return str(out)
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(
        f"{out.stem}.{os.getpid()}.{threading.get_ident()}.tmp.so")
    cmd = [compiler(), *CXX_FLAGS, "-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building {SOURCE.name} failed ({' '.join(cmd)}):"
                           f"\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return str(out)


def get_lib() -> ctypes.CDLL:
    """The packer's library, built and loaded once per process. Array
    arguments pass as addresses (c_void_p; numpy's `a.ctypes.data`, or None
    for no mask): a typed ctypes pointer per argument would cost more than
    the copy of a ligand's rows."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(build_library())
            i64, i32, ptr = ctypes.c_int64, ctypes.c_int32, ctypes.c_void_p
            lib.pack_f32.argtypes = [ptr, i64, i64, ptr, ptr, i64, i64]
            lib.pack_f32.restype = i32
            lib.pack_bonds.argtypes = [ptr, i64, ptr, ptr, i64, i64, i64]
            lib.pack_bonds.restype = i64
            lib.pack_adj.argtypes = [ptr, i64, ptr, i64, i64]
            lib.pack_adj.restype = i32
            _LIB = lib
        return _LIB


def _rows(key: str, src, n: int, d: int) -> np.ndarray:
    """`src` as a contiguous float32 [n, d] array, or ValueError: a row
    count or feature dim that disagrees with the sample would have C copy
    past the source or into the next slot."""
    a = np.ascontiguousarray(src, np.float32)
    if a.ndim == 1 and d == 1:
        a = a[:, None]
    if a.shape != (n, d):
        raise ValueError(f"{key}: shape {a.shape} != ({n}, {d})")
    return a


def _edges(x: Dict, n: int) -> np.ndarray:
    """The sample's directed bond edges [e, 2] (int64), from `bond_edges`
    when present, else from the neighbour lists `bond_nbrs`; ValueError
    when an atom index lies outside the ligand."""
    if "bond_edges" in x:
        e = np.ascontiguousarray(
            np.asarray(x["bond_edges"], np.int64).reshape(-1, 2))
    else:
        e = _nbrs_to_edges(x["bond_nbrs"])
    if e.size and (e.min() < 0 or e.max() >= n):
        raise ValueError(f"bond_edges: atom index outside [0, {n})")
    return e


def collate_native(samples: Sequence[Dict], cfg, max_iso: int = 8,
                   n_valid: Optional[int] = None) -> Dict:
    """`data.batching.collate` with the packing done in C: the same dict of
    numpy arrays keyed by FABindBatch field. Raises SampleTooLarge when a
    sample exceeds the shape bucket (a bond degree above bond_k included),
    ValueError when a sample's arrays disagree in shape before any pointer
    goes to C, and NotImplementedError for samples that carry isomorphisms
    (`max_iso` is taken for the signature's sake)."""
    for x in samples:
        iso = x.get("isomorphisms")
        if iso is not None and len(iso):
            raise NotImplementedError(
                "collate_native does not pack isomorphism tables; use "
                "data.batching.collate for the FABind+ permutation loss")

    lib = get_lib()
    s = cfg.shapes
    B = len(samples)
    Nc, Np, Nr, Kb = s.max_ligand, s.max_pocket, s.max_protein, s.bond_k
    dc, dp = cfg.model.compound_feat_dim, cfg.model.protein_feat_dim

    def zeros(*shape, dtype=np.float32):
        return np.zeros(shape, dtype)

    out = dict(
        lig_feat=zeros(B, Nc, dc),
        lig_mask=zeros(B, Nc, dtype=bool),
        lig_coords=zeros(B, Nc, 3),
        lig_coords_init=zeros(B, Nc, 3),
        lig_rdkit_coords=zeros(B, Nc, 3),
        bond_idx=zeros(B, Nc, Kb, dtype=np.int32),
        bond_mask=zeros(B, Nc, Kb, dtype=bool),
        las_adj=zeros(B, Nc, Nc, dtype=bool),
        prot_feat=zeros(B, Nr, dp),
        prot_mask=zeros(B, Nr, dtype=bool),
        prot_xyz=zeros(B, Nr, 3),
        pocket_idx=zeros(B, Np, dtype=np.int32),
        pocket_mask=zeros(B, Np, dtype=bool),
        pocket_label=zeros(B, Nr),
        coords_center=zeros(B, 3),
        ligand_radius=zeros(B),
        pocket_residue_center=zeros(B, 3),
    )
    # the buffers' addresses; numpy bools are single bytes of 0 or 1, so C
    # sets them as uint8
    addr = {k: v.ctypes.data for k, v in out.items()}

    def pack(key, src, n, N, b, mask_key=None):
        rc = lib.pack_f32(src.ctypes.data, n, out[key].shape[2], addr[key],
                          addr[mask_key] if mask_key else None, b, N)
        if rc != 0:
            raise ValueError(f"pack_f32({key}) error {rc}")

    for b, x in enumerate(samples):
        n = np.shape(x["lig_feat"])[0]
        nr = np.shape(x["prot_xyz"])[0]
        if n > Nc:
            raise SampleTooLarge(f"ligand {n} > {Nc}")
        if nr > Nr:
            raise SampleTooLarge(f"protein {nr} > {Nr}")
        lig = {k: _rows(k, x[k], n, d) for k, d in (
            ("lig_feat", dc), ("lig_coords", 3), ("lig_coords_init", 3),
            ("lig_rdkit_coords", 3))}
        prot = {k: _rows(k, x[k], nr, d) for k, d in (
            ("prot_feat", dp), ("prot_xyz", 3), ("pocket_label", 1))}
        adj = np.ascontiguousarray(x["las_adj"], np.uint8)
        if adj.shape != (n, n):
            raise ValueError(f"las_adj: shape {adj.shape} != ({n}, {n})")
        edges = _edges(x, n)
        pidx = np.asarray(x["pocket_idx"], np.int32)[:Np]

        pack("lig_feat", lig["lig_feat"], n, Nc, b, "lig_mask")
        for k in ("lig_coords", "lig_coords_init", "lig_rdkit_coords"):
            pack(k, lig[k], n, Nc, b)
        pack("prot_feat", prot["prot_feat"], nr, Nr, b, "prot_mask")
        pack("prot_xyz", prot["prot_xyz"], nr, Nr, b)
        deg = lib.pack_bonds(edges.ctypes.data, edges.shape[0],
                             addr["bond_idx"], addr["bond_mask"], b, Nc, Kb)
        if deg < 0:
            raise ValueError(f"pack_bonds error {deg}")
        if deg > Kb:
            raise SampleTooLarge(f"bond degree {deg} > {Kb}")
        if lib.pack_adj(adj.ctypes.data, n, addr["las_adj"], b, Nc) != 0:
            raise SampleTooLarge(f"las_adj {n} > {Nc}")

        out["pocket_idx"][b, :len(pidx)] = pidx
        out["pocket_mask"][b, :len(pidx)] = True
        out["pocket_label"][b, :nr] = prot["pocket_label"][:, 0]
        out["coords_center"][b] = x["coords_center"]
        out["ligand_radius"][b] = x["ligand_radius"]
        out["pocket_residue_center"][b] = x["pocket_residue_center"]

    out["isomorphisms"] = None
    out["iso_mask"] = None
    out["sample_valid"] = (np.arange(B) < (B if n_valid is None else n_valid))
    return out


def _nbrs_to_edges(nbrs: List[List[int]]) -> np.ndarray:
    """Neighbour lists (build_sample's `bond_nbrs`) -> directed edges [e, 2]
    in list order, so C fills each row's slots in the python collator's
    order."""
    e = [(i, j) for i, js in enumerate(nbrs) for j in js]
    return np.ascontiguousarray(np.asarray(e, np.int64).reshape(-1, 2))
