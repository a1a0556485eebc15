"""Dataset readers and the training loader.

Own copy of fabind_tpu/data/dataset.py for one process on one card:
- `PDBBindLMDBSource`: the reference's processed PDBbind store
  (`{root}/dataset/processed`: the index data.pt, or data_new.pt with
  FABind+'s `isomorphics` column, read without pandas by `data.frame`; the
  protein, compound and ESM2 LMDB stores through `data.kv`;
  compound_rdkit_coords.pt) with the reference's split filters;
- `NPZSource`: a directory of per-complex .npz files (cli.preprocess writes
  them); `open_source` opens either;
- `prefetch`: run a batch iterator in a background thread;
- `Loader`: shuffled, shape-bucketed, fixed-size batches of collated numpy
  arrays, with per-sample featurization on `workers` threads, `skip_batches`
  for an exact mid-epoch resume and a count of the samples too large for
  every bucket, and `host_shard=(rank, world)` for a data-parallel rank's
  share of each global batch. For one seed and source it yields the JAX
  Loader's batches bit for bit, per rank too.
"""
from __future__ import annotations

import itertools
import os
import pickle
import queue
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from fabind_tpu_torch.config import FABindConfig
from fabind_tpu_torch.data.batching import build_sample, collate
from fabind_tpu_torch.data.buckets import route_sample, sort_bucket_cfgs
from fabind_tpu_torch.data.frame import load_frame
from fabind_tpu_torch.data.kv import open_kv


class NPZSource:
    """Directory of {name}.npz with keys: protein_xyz, esm_feat, lig_coords,
    lig_feats, bond_edges, las_mask, rdkit_coords [, isomorphisms]."""

    def __init__(self, root: str):
        self.root = root
        self.names = sorted(
            f[:-4] for f in os.listdir(root) if f.endswith(".npz"))

    def __len__(self):
        return len(self.names)

    def get(self, name: str) -> Dict[str, np.ndarray]:
        with np.load(os.path.join(self.root, name + ".npz"),
                     allow_pickle=True) as z:
            return {k: z[k] for k in z.files}


# torchdrug relation ids of the compound store's edge list
# (feature_utils.py:170 edge_list[:, 2]: SINGLE, DOUBLE, TRIPLE, AROMATIC)
# -> bond orders
_RELATION_ORDER = {0: 1.0, 1: 2.0, 2: 3.0, 3: 1.5}


class PDBBindLMDBSource:
    """Reader of the reference's processed store (`{root}/dataset/processed`)
    with the keys the JAX source's `get` returns."""

    def __init__(self, root: str, use_esm2_feat: bool = True):
        p = os.path.join(root, "dataset", "processed")
        # FABind+ stores ship data_new.pt (adds the isomorphics column,
        # FABind_plus/fabind/data.py:62); prefer it when present
        idx_path = os.path.join(p, "data_new.pt")
        if not os.path.exists(idx_path):
            idx_path = os.path.join(p, "data.pt")
        self.index = load_frame(idx_path)   # rows are positions
        self.rdkit_coords = torch.load(
            os.path.join(p, "compound_rdkit_coords.pt"), weights_only=False)

        def kv(name):
            # max_readers sized for the Loader's worker threads (each
            # read-only transaction takes a reader slot)
            return open_kv(os.path.join(p, name), readonly=True,
                           max_readers=128, lock=False, readahead=False,
                           meminit=False)

        self.protein_db = kv("protein_1d_3d.lmdb")
        self.compound_db = kv("compound_LAS_edge_index.lmdb")
        self.esm_db = kv("esm2_t33_650M_UR50D.lmdb") if use_esm2_feat else None

    def __len__(self):
        return len(self.index)

    def splits(self, variant: str = "fabind",
               cut_protein_length: Optional[int] = None
               ) -> Dict[str, List[int]]:
        """The reference's split filters (data.py:110-119; FABind+
        data.py:128-138) as row positions in index order.

        FABind+ trains with cut_train_set (protein_length < 1500) and
        expand_clength_set (c_length < 150); cut_protein_length=0 disables
        the length cut."""
        d = self.index
        group = np.asarray(d["group"], object)
        use = np.asarray(d["use_compound_com"], bool)
        c_max = 100 if variant == "fabind" else 150
        if variant != "fabind" and cut_protein_length is None:
            cut_protein_length = 1500
        train = ((np.asarray(d["c_length"]) < c_max)
                 & (np.asarray(d["native_num_contact"]) > 5)
                 & (group == "train") & use)
        out = {"train": np.flatnonzero(train).tolist()}
        if cut_protein_length:
            names = d["protein_name"]
            lens = self._protein_lengths(
                dict.fromkeys(names[i] for i in out["train"]))
            out["train"] = [i for i in out["train"]
                            if lens[names[i]] < cut_protein_length]
        for g in ("valid", "test"):
            out[g] = np.flatnonzero((group == g) & use).tolist()
        return out

    def _protein_lengths(self, names) -> Dict[str, int]:
        """Sequence length per protein (FABind+ data.py:42-58 builds its
        protein_length column the same way, from the LMDB sequences)."""
        out = {}
        with self.protein_db.begin() as txn:
            for name in names:
                _, seq = pickle.loads(txn.get(str(name).encode()))
                out[str(name)] = len(seq)
        return out

    def get(self, idx: int) -> Dict[str, np.ndarray]:
        line = self.index.row(idx)
        pname = line["protein_name"]
        cname = line["compound_name"]
        with self.protein_db.begin() as txn:
            protein_xyz, _ = pickle.loads(txn.get(pname.encode()))
        esm_feat = None
        if self.esm_db is not None:
            with self.esm_db.begin() as txn:
                esm_feat = pickle.loads(txn.get(pname.encode()))
        with self.compound_db.begin() as txn:
            rec = pickle.loads(txn.get(cname.encode()))
        # (coords, node_feats, edge_list, edge_attr, pair_dis_distribution,
        #  LAS_edge_index)
        coords, feats, edge_list, _, _, las_edge_index = rec

        def npy(x):
            return np.asarray(x.numpy() if hasattr(x, "numpy") else x)

        n = npy(feats).shape[0]
        las = np.zeros((n, n), bool)
        las_e = npy(las_edge_index)
        las[las_e[0], las_e[1]] = True
        el = npy(edge_list)
        out = {
            "protein_xyz": npy(protein_xyz).astype(np.float32),
            "lig_coords": npy(coords).astype(np.float32),
            "lig_feats": npy(feats).astype(np.float32),
            "bond_edges": el[:, :2].astype(np.int64),
            "las_mask": las,
            "rdkit_coords": npy(self.rdkit_coords[cname]).astype(np.float32),
            "pdb": line.get("pdb", cname),
            "group": line.get("group", "train"),
        }
        if esm_feat is not None:   # absent when use_esm2_feat=False
            out["esm_feat"] = npy(esm_feat).astype(np.float32)
        if el.ndim == 2 and el.shape[1] >= 3:
            out["bond_orders"] = np.asarray(
                [_RELATION_ORDER.get(int(t), 0.0) for t in el[:, 2]],
                np.float32)
        # rows inject-iso skipped hold NaN (a float), not a list
        isos = line.get("isomorphics")
        if isinstance(isos, (list, tuple, np.ndarray)) and len(isos):
            out["isomorphisms"] = np.stack(
                [np.asarray(p, np.int32) for p in isos])
        return out


_SENTINEL = object()


def open_source(root: str, variant: str = "fabind",
                split: Optional[str] = None, use_esm2_feat: bool = True):
    """Open `root` as the reference's processed store if it holds one, else
    as a directory of .npz samples. Returns (source, indices): a store's
    rows of `split` under `variant`'s filters (None for split=None), or all
    of a directory's sample names (it has no splits)."""
    p = os.path.join(root, "dataset", "processed")
    if (os.path.exists(os.path.join(p, "data.pt"))
            or os.path.exists(os.path.join(p, "data_new.pt"))):
        src = PDBBindLMDBSource(root, use_esm2_feat=use_esm2_feat)
        if split is None:
            return src, None
        return src, src.splits(variant)[split]
    names = [f for f in os.listdir(root) if f.endswith(".npz")]
    if not names:
        raise FileNotFoundError(
            f"{root}: neither a processed store ({p}/data.pt missing) nor "
            f"a directory of .npz samples")
    src = NPZSource(root)
    return src, list(src.names)


def prefetch(it: Iterator, depth: int = 2) -> Iterator:
    """Run `it` in a background thread, buffering up to `depth` items, so
    host featurization and collation overlap the device's work. Exceptions
    from the producer re-raise in the consumer; a consumer that stops early
    stops the producer too."""
    q: "queue.Queue" = queue.Queue(maxsize=max(depth, 1))
    err: List[BaseException] = []
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def run():
        try:
            for item in it:
                if not put(item):
                    return
        except BaseException as e:
            err.append(e)
        finally:
            put(_SENTINEL)

    t = threading.Thread(target=run, daemon=True, name="fabind-prefetch")
    t.start()
    try:
        while True:
            item = q.get()
            if item is _SENTINEL:
                if err:
                    raise err[0]
                return
            yield item
    finally:
        stop.set()


def _bounded_map(ex: ThreadPoolExecutor, fn, items, window: int) -> Iterator:
    """Ordered executor map with at most `window` tasks in flight."""
    items = iter(items)
    futs = deque(ex.submit(fn, x) for x in itertools.islice(items, window))
    while futs:
        f = futs.popleft()
        nxt = next(items, _SENTINEL)
        if nxt is not _SENTINEL:
            futs.append(ex.submit(fn, nxt))
        yield f.result()


class Loader:
    """Host batching with size routing and deterministic shuffling.

    With `buckets` (ShapeConfigs; the largest covers cfg.shapes) each sample
    goes to the smallest bucket it fits and batches are cut per bucket; a
    sample that fits none is dropped and counted in `n_dropped`. The
    trailing batch of each bucket is padded with copies of its last sample,
    marked in sample_valid. `workers` featurizes on a thread pool (each
    sample with its own seed drawn from the epoch's stream, so the batches
    are the same for any worker count); `prefetch_depth` runs the loop in a
    background thread.

    `host_shard=(rank, world)`: a data-parallel rank's loader. Every rank
    shuffles the same epoch order and takes global slots rank, rank +
    world, ... of it, `batch_size` rows per batch (the global batch is
    world x batch_size); with several buckets, every rank cuts the same
    global schedule (`_epoch_global_schedule`). Every rank yields the same
    number of batches in the same buckets, as the collective training step
    needs: with one bucket an oversize sample is replaced by the rank's
    last valid one instead of being dropped."""

    def __init__(self, source, indices: Sequence, cfg: FABindConfig,
                 group: str = "train", batch_size: Optional[int] = None,
                 seed: int = 0, buckets: Optional[Sequence] = None,
                 workers: int = 0, prefetch_depth: int = 0,
                 host_shard: Optional[Tuple[int, int]] = None):
        self.source = source
        self.indices = list(indices)
        self.host_shard = host_shard
        self.cfg = cfg
        self.group = group
        self.batch_size = batch_size or cfg.train.batch_size
        self.seed = seed
        self.workers = workers
        self.prefetch_depth = prefetch_depth
        self.n_dropped = 0
        self.bucket_cfgs = sort_bucket_cfgs(cfg, buckets)
        self._route_table = None   # host_shard's static routing

    def __len__(self):
        """Batches per epoch with one bucket, per rank under host_shard (a
        lower bound with several: each bucket pads its own trailing
        batch)."""
        n = len(self.indices)
        if self.host_shard is not None:
            n = -(-n // self.host_shard[1])
        return -(-n // self.batch_size)

    def epoch(self, epoch: int = 0, with_meta: bool = False,
              skip_batches: int = 0) -> Iterator:
        """Collated batches (dicts of numpy arrays, `FABindBatch.from_numpy`
        moves them to a device); with_meta yields (batch, meta), meta =
        {"pdb": names of the real rows, "n_valid", "cfg": the bucket's
        FABindConfig, "iso": the real rows' full automorphism lists}.

        `skip_batches` resumes mid-epoch: the epoch's first k batches are
        not yielded, so the rest equals the unbroken epoch's batches [k:].
        Their samples are still featurized (the bucket and the noisy crop
        depend on the epoch's draws), not collated."""
        gen = self._epoch_impl(epoch, with_meta, skip_batches)
        if self.prefetch_depth:
            return prefetch(gen, self.prefetch_depth)
        return gen

    def _samples(self, order: List, rng: np.random.RandomState) -> Iterator:
        """(idx, raw, sample) stream; threaded when self.workers > 0."""
        if not self.workers:
            for idx in order:
                raw = self.source.get(idx)
                yield idx, raw, build_sample(
                    raw, self.cfg, group=self.group, rng=rng,
                    isomorphisms=raw.get("isomorphisms"))
            return
        seeds = rng.randint(0, 2 ** 31 - 1, size=len(order))

        def build(i_idx):
            i, idx = i_idx
            raw = self.source.get(idx)
            s = build_sample(raw, self.cfg, group=self.group,
                             rng=np.random.RandomState(seeds[i]),
                             isomorphisms=raw.get("isomorphisms"))
            return idx, raw, s

        ex = ThreadPoolExecutor(self.workers, thread_name_prefix="fabind-data")
        try:
            yield from _bounded_map(ex, build, enumerate(order),
                                    window=2 * self.workers)
        finally:
            ex.shutdown(wait=False, cancel_futures=True)

    def _static_bucket_of(self) -> dict:
        """idx -> bucket config (None: oversize), computed once from the
        noise-free build (group 'test': no crop noise, no rotation), the
        same on every rank. Routing then does not depend on an epoch's crop
        noise; a noisy crop that keeps more pocket residues than its
        bucket's max_pocket truncates and counts in pocket_overflow, as
        one-process bucketed training can."""
        if self._route_table is not None:
            return self._route_table

        def route_one(idx):
            raw = self.source.get(idx)
            s = build_sample(raw, self.cfg, group="test",
                             rng=np.random.RandomState(0),
                             isomorphisms=raw.get("isomorphisms"))
            return idx, route_sample(s, self.bucket_cfgs)

        if self.workers:
            ex = ThreadPoolExecutor(self.workers,
                                    thread_name_prefix="fabind-route")
            try:
                table = dict(ex.map(route_one, self.indices))
            finally:
                ex.shutdown(wait=False, cancel_futures=True)
        else:
            table = dict(route_one(idx) for idx in self.indices)
        self._route_table = table
        return table

    def _epoch_global_schedule(self, epoch: int, with_meta: bool,
                               skip_batches: int) -> Iterator:
        """host_shard with several buckets: every rank computes the same
        schedule (the shared shuffle, each sample routed by the static
        table, global batches of batch_size x world cut per bucket in
        stream order, each bucket's trailing one padded by repeating its
        last sample) and yields its stride of each global batch. Batch
        counts, buckets and sample_valid agree across ranks by
        construction; oversize samples are dropped by every rank alike.
        Each sample's featurization is seeded by (seed, epoch, global
        batch, global slot), so a resume skips whole batches without
        featurizing them."""
        pi, pc = self.host_shard
        G = self.batch_size * pc
        rng = np.random.RandomState(self.seed + epoch)
        order = list(self.indices)
        if self.group == "train":
            rng.shuffle(order)
        table = self._static_bucket_of()

        queues = {id(c): [] for c in self.bucket_cfgs}
        sched = []                       # (cfg_b, [idx] * G, n_real_global)
        for idx in order:
            cfg_b = table[idx]
            if cfg_b is None:
                self.n_dropped += 1
                continue
            q = queues[id(cfg_b)]
            q.append(idx)
            if len(q) == G:
                sched.append((cfg_b, list(q), G))
                q.clear()
        for c in self.bucket_cfgs:
            q = queues[id(c)]
            if q:
                n_real = len(q)
                while len(q) < G:
                    q.append(q[-1])
                sched.append((c, list(q), n_real))
        srng = np.random.RandomState((self.seed + 77977 + epoch) % 2 ** 31)
        seeds = srng.randint(0, 2 ** 31 - 1, size=(max(len(sched), 1), G))

        def build(bi, j_idx):
            j, idx = j_idx
            raw = self.source.get(idx)
            s = build_sample(raw, self.cfg, group=self.group,
                             rng=np.random.RandomState(seeds[bi][j]),
                             isomorphisms=raw.get("isomorphisms"))
            return idx, raw, s

        ex = (ThreadPoolExecutor(self.workers, thread_name_prefix="fabind-data")
              if self.workers else None)
        try:
            for bi, (cfg_b, idxs, n_real) in enumerate(sched):
                if bi < skip_batches:
                    continue
                mine = [(j, idxs[j]) for j in range(pi, G, pc)]
                built = (list(ex.map(lambda x, bi=bi: build(bi, x), mine))
                         if ex else [build(bi, x) for x in mine])
                # the padding sits at the global tail and the stride keeps
                # order, so this rank's real rows are a prefix
                n_valid = sum(1 for j, _ in mine if j < n_real)
                buf = [s for _, _, s in built]
                batch = collate(buf, cfg_b, n_valid=n_valid)
                if not with_meta:
                    yield batch
                    continue
                pdbs = [str(raw.get("pdb", idx)) for idx, raw, _ in built]
                yield batch, {"pdb": pdbs[:n_valid], "n_valid": n_valid,
                              "cfg": cfg_b,
                              "iso": [s.get("isomorphisms")
                                      for s in buf[:n_valid]]}
        finally:
            if ex is not None:
                ex.shutdown(wait=False, cancel_futures=True)

    def _epoch_impl(self, epoch: int, with_meta: bool,
                    skip_batches: int) -> Iterator:
        if self.host_shard is not None and len(self.bucket_cfgs) > 1:
            yield from self._epoch_global_schedule(epoch, with_meta,
                                                   skip_batches)
            return
        rng = np.random.RandomState(self.seed + epoch)
        order = list(self.indices)
        if self.group == "train":
            rng.shuffle(order)
        if self.host_shard is not None:
            # every rank runs the same number of steps: each takes
            # ceil(len / world) slots, wrapping around the order
            pi, pc = self.host_shard
            per = -(-len(order) // pc)
            order = [order[(pi + k * pc) % len(order)] for k in range(per)]
        bufs = {id(c): ([], []) for c in self.bucket_cfgs}
        n_emitted = 0
        last_valid = None
        deficit = 0

        def emit(buf, pdbs, cfg_b, n_real):
            batch = collate(buf, cfg_b, n_valid=n_real)
            if not with_meta:
                return batch
            return batch, {"pdb": pdbs[:n_real], "n_valid": n_real,
                           "cfg": cfg_b,
                           "iso": [x.get("isomorphisms")
                                   for x in buf[:n_real]]}

        def feed(cfg_b, raw, s, idx) -> bool:
            buf, pdbs = bufs[id(cfg_b)]
            buf.append(s)
            pdbs.append(str(raw.get("pdb", idx)))
            return len(buf) == self.batch_size

        for idx, raw, s in self._samples(order, rng):
            cfg_b = route_sample(s, self.bucket_cfgs)
            if cfg_b is None:
                self.n_dropped += 1
                if self.host_shard is None:
                    continue
                # a rank that drops a sample would run one step fewer than
                # its peers: it repeats its last valid sample instead (or,
                # before it has one, owes the first valid one)
                if last_valid is None:
                    deficit += 1
                    continue
                cfg_b, raw, s, idx = last_valid
            else:
                if last_valid is None and deficit:
                    for _ in range(deficit):
                        if feed(cfg_b, raw, s, idx):
                            if n_emitted >= skip_batches:
                                yield emit(*bufs[id(cfg_b)], cfg_b,
                                           self.batch_size)
                            n_emitted += 1
                            bufs[id(cfg_b)] = ([], [])
                    deficit = 0
                last_valid = (cfg_b, raw, s, idx)
            if feed(cfg_b, raw, s, idx):
                buf, pdbs = bufs[id(cfg_b)]
                if n_emitted >= skip_batches:
                    yield emit(buf, pdbs, cfg_b, self.batch_size)
                n_emitted += 1
                bufs[id(cfg_b)] = ([], [])
        if deficit:
            # the whole epoch had no valid sample to repeat, and yielding
            # fewer batches than the other ranks would hang their step
            raise RuntimeError(
                f"host_shard epoch has no valid sample to substitute for "
                f"{deficit} oversize samples: every sample of this rank "
                f"exceeds the buckets")
        for cfg_b in self.bucket_cfgs:
            buf, pdbs = bufs[id(cfg_b)]
            if not buf:
                continue
            n_real = len(buf)
            while len(buf) < self.batch_size:
                buf.append(buf[-1])
            if n_emitted >= skip_batches:
                yield emit(buf, pdbs, cfg_b, n_real)
            n_emitted += 1
