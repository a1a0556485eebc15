"""Dataset reader and the training loader.

Own copy of the parts of fabind_tpu/data/dataset.py that one process on one
card needs:
- `NPZSource`: a directory of per-complex .npz files (fabind_tpu.cli.
  preprocess writes them); `open_source` opens one;
- `prefetch`: run a batch iterator in a background thread;
- `Loader`: shuffled, shape-bucketed, fixed-size batches of collated numpy
  arrays, with per-sample featurization on `workers` threads, `skip_batches`
  for an exact mid-epoch resume and a count of the samples too large for
  every bucket. For one seed and source it yields the JAX Loader's batches
  bit for bit.

Not here yet: the reference's processed-LMDB store (`PDBBindLMDBSource`,
with data/kv.py and data/mdb.py) and the multi-process sharding
(`host_shard` and its global bucket schedule), which come with data-parallel
training.
"""
from __future__ import annotations

import itertools
import os
import queue
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from fabind_tpu_torch.config import FABindConfig
from fabind_tpu_torch.data.batching import build_sample, collate
from fabind_tpu_torch.data.buckets import route_sample, sort_bucket_cfgs


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


_SENTINEL = object()


def open_source(root: str):
    """A directory of .npz samples: (NPZSource, its sample names). The
    reference's processed-LMDB layout is not read yet, and raises."""
    p = os.path.join(root, "dataset", "processed")
    if (os.path.exists(os.path.join(p, "data.pt"))
            or os.path.exists(os.path.join(p, "data_new.pt"))):
        raise NotImplementedError(
            f"{root}: the reference's processed-LMDB dataset is not read by "
            f"the port yet; convert it to an NPZ directory")
    names = [f for f in os.listdir(root) if f.endswith(".npz")]
    if not names:
        raise FileNotFoundError(f"{root}: no .npz samples")
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
    background thread."""

    def __init__(self, source, indices: Sequence, cfg: FABindConfig,
                 group: str = "train", batch_size: Optional[int] = None,
                 seed: int = 0, buckets: Optional[Sequence] = None,
                 workers: int = 0, prefetch_depth: int = 0):
        self.source = source
        self.indices = list(indices)
        self.cfg = cfg
        self.group = group
        self.batch_size = batch_size or cfg.train.batch_size
        self.seed = seed
        self.workers = workers
        self.prefetch_depth = prefetch_depth
        self.n_dropped = 0
        self.bucket_cfgs = sort_bucket_cfgs(cfg, buckets)

    def __len__(self):
        """Batches per epoch with one bucket (a lower bound with several:
        each bucket pads its own trailing batch)."""
        return -(-len(self.indices) // self.batch_size)

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

    def _epoch_impl(self, epoch: int, with_meta: bool,
                    skip_batches: int) -> Iterator:
        rng = np.random.RandomState(self.seed + epoch)
        order = list(self.indices)
        if self.group == "train":
            rng.shuffle(order)
        bufs = {id(c): ([], []) for c in self.bucket_cfgs}
        n_emitted = 0

        def emit(buf, pdbs, cfg_b, n_real):
            batch = collate(buf, cfg_b, n_valid=n_real)
            if not with_meta:
                return batch
            return batch, {"pdb": pdbs[:n_real], "n_valid": n_real,
                           "cfg": cfg_b,
                           "iso": [x.get("isomorphisms")
                                   for x in buf[:n_real]]}

        for idx, raw, s in self._samples(order, rng):
            cfg_b = route_sample(s, self.bucket_cfgs)
            if cfg_b is None:
                self.n_dropped += 1
                continue
            buf, pdbs = bufs[id(cfg_b)]
            buf.append(s)
            pdbs.append(str(raw.get("pdb", idx)))
            if len(buf) == self.batch_size:
                if n_emitted >= skip_batches:
                    yield emit(buf, pdbs, cfg_b, self.batch_size)
                n_emitted += 1
                bufs[id(cfg_b)] = ([], [])
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
