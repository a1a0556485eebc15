"""HTTP serving daemon around the port's `DockingEngine` (stdlib only).

Own copy of fabind_tpu/serve_http.py: the weights load once, then requests
are served until shutdown.

Endpoints:
  GET  /health    -> {"status": "ok", "batch_size": N, "bf16": bool,
                      "buckets": [[lig, pocket, protein], ...],
                      "counters": {"serve.requests": n,
                                   "serve.requests_failed": n,
                                   "serve.batches": {"LxPxR": n, ...},
                                   "serve.padding_rows": {"LxPxR": n, ...},
                                   "serve.cells_real": n,
                                   "serve.cells_padded": n,
                                   "serve.prot_rows_hit": n,
                                   "serve.prot_rows_miss": n,
                                   "serve.graph_captures": {"LxPxR": n},
                                   "serve.graph_replays": {"LxPxR": n},
                                   "serve.graph_eager": {"LxPxR": n},
                                   "sample.passes": {"LxPxR": n},
                                   "sample.centers": {"cluster": n,
                                                      "default": n}}}
                     (the process's serving counters since it started,
                     utils/tracing.py; failed: requests that failed to
                     featurize or fit no bucket; padding rows: batch rows
                     that repeat the last request; cells: ligand atoms x
                     residues of the requests against rows x the bucket's
                     atoms x residues, so 1 - real/padded is the share of
                     the model's pair work spent on padding; graph
                     captures, replays and eager batches (best-of-N:
                     dock halves): how often the docking stage replayed
                     its bucket's CUDA graphs, graphs.py; sample passes:
                     best-of-N passes run;
                     sample centers: the rows of those passes docked at a
                     DBSCAN cluster's center or at the default one,
                     sample.py)
  POST /dock_raw  -> body: .npz bytes; the arrays of request i carry the
                     prefix "r{i}_" (r0_lig_coords, r0_lig_feats,
                     r0_bond_edges, r0_las_mask, r0_rdkit_coords,
                     r0_protein_xyz, r0_esm_feat); un-prefixed arrays are
                     shared by every request. Response: a JSON list of
                     {coords, confidence, error[, pocket_truncated]} in
                     request order; a flexible-docking engine (preset
                     fabflex) adds pocket_coords [[x, y, z], ...] and
                     pocket_residues (indices into the protein).
  POST /screen    -> body: .npz bytes; one protein under "protein_xyz" and
                     "esm_feat", the ligands under "r{i}_" prefixes. Same
                     response.
  POST /dock_best_of?sample_size=N&seed=K
                  -> the /dock_raw body; FABind+ best-of-N sampling (the
                     most confident of N poses per request; defaults N=40,
                     K=0). Needs an engine with a confidence head (preset
                     fabind_plus_sampling). Same response.
  POST /dock_sdf?randomize_init=0|1&seed=K
                  -> body: JSON [{"sdf": "<V2000 molfile text>", "pdb":
                     "path on the server"}, ...]; the ligands inline (never
                     a server path: a bare path answers 400), the proteins
                     under --pdb-root when it is set (a path that leaves it
                     answers 400). DockingEngine.dock_sdf, RDKit-free; a
                     docked pose adds an "sdf" field, the pose as molfile
                     text. Needs an engine with an ESM2 encoder.
Any other path answers 404. (/dock of the JAX daemon docks SMILES, which
needs RDKit.)

Run:  python -m fabind_tpu_torch.cli.serve --preset fabind --port 8400 \
          [--esm-weights DIR --pdb-root DIR]

npz keeps the 1280-d ESM features binary; responses are JSON because poses
are small. The server is a ThreadingHTTPServer and the engine's dock_*
methods are thread-safe, so concurrent requests interleave their device
batches; a semaphore bounds the engine calls in flight (default 4), which
bounds device memory, and a body-size limit refuses a request before it is
read.
"""
from __future__ import annotations

import io
import json
import os
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional
from urllib.parse import parse_qs, urlparse

import numpy as np

from fabind_tpu_torch.data.featurize import sdf_string
from fabind_tpu_torch.utils import tracing

_PREFIX = re.compile(r"^r(\d+)_(.+)$")
_PROTEIN_KEYS = ("protein_xyz", "esm_feat", "protein_full_coords")
# what GET /health reports of the tracing registry, and its empty value
_HEALTH_COUNTERS = {"serve.requests": 0, "serve.requests_failed": 0,
                    "serve.batches": {}, "serve.padding_rows": {},
                    "serve.cells_real": 0, "serve.cells_padded": 0,
                    "serve.prot_rows_hit": 0, "serve.prot_rows_miss": 0,
                    "serve.graph_captures": {}, "serve.graph_replays": {},
                    "serve.graph_eager": {}, "sample.passes": {},
                    "sample.centers": {}}


def _group_npz(data: bytes) -> List[Dict[str, np.ndarray]]:
    """Split "r{i}_{field}" npz entries into per-request dicts; un-prefixed
    entries are shared by every request."""
    z = np.load(io.BytesIO(data), allow_pickle=False)
    shared: Dict[str, np.ndarray] = {}
    per: Dict[int, Dict[str, np.ndarray]] = {}
    for k in z.files:
        m = _PREFIX.match(k)
        if m:
            per.setdefault(int(m.group(1)), {})[m.group(2)] = z[k]
        else:
            shared[k] = z[k]
    if not per:
        return [shared] if shared else []
    # the indices present, ascending: expanding to max(per) + 1 would let one
    # tiny entry named r4000000000_x allocate billions of dicts
    return [dict(shared, **per[i]) for i in sorted(per)]


def _finite_list(arr: np.ndarray):
    """tolist() with non-finite values as null: bare NaN/Infinity tokens
    are not JSON, and strict parsers reject the whole response."""
    arr = np.asarray(arr, np.float32)
    if np.isfinite(arr).all():
        return arr.tolist()
    return [[float(x) if np.isfinite(x) else None for x in row]
            for row in arr.reshape(arr.shape[0], -1)]


def _poses_json(poses) -> bytes:
    out = []
    for p in poses:
        conf = float(p.confidence)
        d = {"coords": _finite_list(p.coords),
             "confidence": conf if np.isfinite(conf) else None,
             "error": p.error}
        if p.pocket_truncated:
            # the predicted crop outgrew the bucket's Np: the caller may
            # re-dock with a larger bucket
            d["pocket_truncated"] = int(p.pocket_truncated)
        if p.pocket_coords is not None:   # flexible-docking engines
            d["pocket_coords"] = _finite_list(p.pocket_coords)
            d["pocket_residues"] = np.asarray(p.pocket_residues).tolist()
        if p.sdf_meta is not None and np.isfinite(p.coords).all():
            # /dock_sdf: the docked pose as molfile text, ready to save
            d["sdf"] = sdf_string(p.sdf_meta["symbols"], p.coords,
                                  p.sdf_meta["bonds"],
                                  charges=p.sdf_meta["charges"])
        out.append(d)
    return json.dumps(out).encode()


class _Server(ThreadingHTTPServer):
    """The daemon's server: holds the engine and the request limits."""

    def __init__(self, address, engine, max_inflight: int,
                 max_body_bytes: int, pdb_root: Optional[str]):
        super().__init__(address, _Handler)
        self.engine = engine
        self.pdb_root = pdb_root
        # the engine is thread-safe; the semaphore only bounds how many
        # requests hold device batches at once (memory, not safety)
        self.inflight = threading.Semaphore(max_inflight)
        self.max_body_bytes = max_body_bytes


class _Handler(BaseHTTPRequestHandler):
    # reads the engine from its server: a handler class made per server,
    # closing over the engine, would sit in a reference cycle and keep a
    # closed server's engine (and its device weights) alive until Python's
    # cyclic collector happened to run
    server: _Server

    def log_message(self, *a):   # quiet by default
        pass

    def _reply(self, code: int, body: bytes):
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _error(self, code: int, msg: str):
        self._reply(code, json.dumps({"error": msg}).encode())

    def do_GET(self):
        if self.path != "/health":
            return self._error(404, "not found")
        engine = self.server.engine
        counters = tracing.snapshot()["counters"]
        self._reply(200, json.dumps({
            "status": "ok", "batch_size": engine.batch_size,
            "bf16": engine.bf16,
            "buckets": [[c.shapes.max_ligand, c.shapes.max_pocket,
                         c.shapes.max_protein]
                        for c in engine.bucket_cfgs],
            "counters": {k: counters.get(k, v)
                         for k, v in _HEALTH_COUNTERS.items()}}).encode())

    def do_POST(self):
        engine, inflight = self.server.engine, self.server.inflight
        try:
            n = int(self.headers.get("Content-Length", "0"))
            if n > self.server.max_body_bytes:
                # refused before it is read: a runaway client must not
                # exhaust the host's memory
                return self._error(
                    413, f"body {n} bytes exceeds limit "
                         f"{self.server.max_body_bytes}")
            url = urlparse(self.path)
            if url.path not in ("/dock_raw", "/screen", "/dock_best_of",
                                "/dock_sdf"):
                return self._error(404, "not found")
            q = parse_qs(url.query)
            if url.path == "/dock_sdf":
                return self._dock_sdf(json.loads(self.rfile.read(n)), q)
            reqs = _group_npz(self.rfile.read(n))
            if url.path == "/dock_raw":
                with inflight:
                    poses = engine.dock_raw(reqs)
            elif url.path == "/dock_best_of":
                kw = {k: int(q[k][0]) for k in ("sample_size", "seed")
                      if k in q}
                with inflight:
                    poses = engine.dock_best_of(reqs, **kw)
            else:
                if not reqs or "protein_xyz" not in reqs[0]:
                    return self._error(
                        400, "screen needs a protein_xyz (+ esm_feat) "
                             "entry and r{i}_-prefixed ligand entries")
                protein = {k: reqs[0][k] for k in _PROTEIN_KEYS
                           if k in reqs[0]}
                ligs = [{k: v for k, v in r.items()
                         if k not in _PROTEIN_KEYS} for r in reqs]
                with inflight:
                    poses = engine.dock_screen(protein, ligs)
            self._reply(200, _poses_json(poses))
        except Exception as e:   # per-request fault isolation
            self._error(500, f"{type(e).__name__}: {e}")

    def _dock_sdf(self, reqs, q):
        """/dock_sdf: (inline molfile, PDB path) pairs; 400 for a ligand
        given as a path (it would read server files) or a protein path
        that leaves --pdb-root (it would probe the server's files through
        the error messages)."""
        root = self.server.pdb_root
        pairs = []
        for r in reqs:
            pdb = r["pdb"]
            if root is not None:
                pdb = os.path.realpath(os.path.join(root, pdb))
                if not pdb.startswith(os.path.realpath(root) + os.sep):
                    return self._error(
                        400, f"pdb path {r['pdb']!r} escapes --pdb-root")
            if "\n" not in r["sdf"]:
                return self._error(
                    400, "sdf must be inline molfile text, not a path")
            pairs.append((r["sdf"], pdb))
        with self.server.inflight:
            poses = self.server.engine.dock_sdf(
                pairs, randomize_init=bool(int(q.get("randomize_init",
                                                     [0])[0])),
                seed=int(q.get("seed", [0])[0]))
        self._reply(200, _poses_json(poses))


def make_server(engine, host: str = "127.0.0.1", port: int = 8400,
                max_inflight: int = 4,
                max_body_bytes: int = 256 * 1024 * 1024,
                pdb_root: Optional[str] = None) -> ThreadingHTTPServer:
    """A ThreadingHTTPServer for `engine` (not started; port 0 picks a free
    one). pdb_root: when set, /dock_sdf's "pdb" values are joined to it and
    must stay under it; without it they are any path on the server."""
    return _Server((host, port), engine, max_inflight, max_body_bytes,
                   pdb_root)


def serve_forever(engine, host: str = "127.0.0.1", port: int = 8400,
                  pdb_root: Optional[str] = None) -> None:
    srv = make_server(engine, host, port, pdb_root=pdb_root)
    print(f"fabind_tpu_torch serving on http://{host}:{srv.server_address[1]}"
          f" (buckets: {len(engine.bucket_cfgs)}, batch {engine.batch_size})",
          flush=True)
    try:
        srv.serve_forever()
    finally:
        srv.server_close()
