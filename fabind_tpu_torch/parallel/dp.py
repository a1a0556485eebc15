"""Data parallelism on one host: ranks in processes for training, model
replicas in threads for serving and embedding.

Counterpart of fabind_tpu/parallel/mesh.py, whose 1-D "dp" mesh keeps the
weights replicated and shards a batch on its leading axis. The contract is
the mesh's: N parts compute what one process computes on the same global
batch.

- `dp_devices(device, n)`: cuda:0..n-1 (n = 0: every visible card; raises
  when fewer are present), or n replicas on the CPU.
- Training: `launch(fn, args, devices)` starts one process per entry of
  `devices` (start method `spawn`: CUDA does not survive `fork`), joined in
  a process group through a file store in a temporary directory (no TCP
  port to race for), nccl on cards and gloo on the CPU unless the caller
  names a backend. Each rank calls `fn(rank, world, device, *args)`; its
  `DPGroup` sums tensors over the ranks with `all_reduce` and copies them
  from rank 0 with `broadcast`, the two collectives gloo also runs on CUDA
  tensors. Rank r holds the global batch's rows r, r + N, ...
  (`strided_rows`; data.dataset.Loader(host_shard=(r, N)) cuts the same),
  so its row map is (N, r). The launcher forwards SIGTERM and SIGINT to
  the ranks and raises when a rank fails or the time limit passes.
- Serving: `ReplicaSet` keeps one copy of a module per device, splits a
  batch's rows into contiguous blocks of B / N (row map (1, r B / N)), runs
  each block in a host thread of its replica (a served batch launches
  thousands of kernels from the host), and gathers the outputs in row
  order on the first replica's device. One replica runs inline in the
  caller's thread.
"""
from __future__ import annotations

import dataclasses
import datetime
import multiprocessing as mp
import os
import pickle
import queue
import shutil
import signal
import tempfile
import threading
import time
import traceback
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from fabind_tpu_torch.models.layers import RowMap

Tensor = torch.Tensor


def dp_devices(device, n: int) -> List[torch.device]:
    """The devices of `n` data-parallel parts on `device`'s type: cuda:0
    .. cuda:n-1 (n = 0: every visible card), raising when CUDA is missing
    or fewer than n cards are visible; or n CPU replicas (n = 0: one, the
    one CPU device)."""
    if n < 0:
        raise ValueError(f"dp {n} < 0")
    device = torch.device("cuda" if device is None else device)
    if device.type == "cpu":
        return [device] * max(n, 1)
    if device.type != "cuda":
        raise ValueError(f"data parallelism on {device}: cuda or cpu only")
    if not torch.cuda.is_available():
        raise RuntimeError("data parallelism: CUDA is not available; pass "
                           "device cpu to run on the CPU")
    count = torch.cuda.device_count()
    n = n or count
    if n > count:
        raise RuntimeError(f"dp {n} needs {n} cards; {count} visible")
    return [torch.device("cuda", i) for i in range(n)]


def default_backend(devices: Sequence[torch.device]) -> str:
    """nccl on cards, gloo on the CPU."""
    return "nccl" if torch.device(devices[0]).type == "cuda" else "gloo"


# ---------------------------------------------------------------- batches
def strided_rows(arrays: Dict[str, Any], rank: int, world: int) -> Dict:
    """Rank `rank`'s rows r, r + N, ... of a collated global batch (a dict
    of arrays with the batch on the leading axis; None stays None)."""
    return {k: None if v is None else v[rank::world]
            for k, v in arrays.items()}


def interleave_rows(parts: Sequence[Dict[str, Any]]) -> Dict:
    """The global batch whose row j * N + r is row j of parts[r]: the
    inverse of strided_rows over N parts of equal size."""
    out = {}
    for k in parts[0]:
        if parts[0][k] is None:
            out[k] = None
            continue
        stacked = np.stack([np.asarray(p[k]) for p in parts], 1)
        out[k] = stacked.reshape(-1, *stacked.shape[2:])
    return out


def map_batch(batch, fn: Callable[[Tensor], Tensor]):
    """A dataclass batch (FABindBatch) with fn applied to every tensor
    field."""
    return dataclasses.replace(batch, **{
        f.name: fn(getattr(batch, f.name)) for f in dataclasses.fields(batch)
        if isinstance(getattr(batch, f.name), Tensor)})


# --------------------------------------------------------------- training
class DPGroup:
    """A rank's view of the default process group: its rank, the world
    size, its device, and the two collectives the training step uses."""

    def __init__(self, rank: int, world: int, device):
        self.rank = rank
        self.world = world
        self.device = torch.device(device)

    def all_sum(self, t: Tensor) -> Tensor:
        """The sum of t over every rank (a new tensor)."""
        out = t.detach().clone()
        dist.all_reduce(out)
        return out

    def all_max(self, value: float) -> float:
        """The largest of a host value over every rank."""
        t = torch.tensor([float(value)], device=self.device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return float(t[0])

    def sum_flat_(self, tensors: List[Tensor]) -> None:
        """Sum equal-dtype tensors over every rank in place, as one
        collective over their flat concatenation."""
        flat = torch.cat([t.reshape(-1) for t in tensors])
        dist.all_reduce(flat)
        with torch.no_grad():
            torch._foreach_copy_(tensors, [
                v.view_as(t) for v, t in zip(
                    flat.split([t.numel() for t in tensors]), tensors)])

    def broadcast_flat_(self, tensors: List[Tensor]) -> None:
        """Copy rank 0's tensors to every rank in place (one collective per
        dtype)."""
        by_dtype: Dict[torch.dtype, List[Tensor]] = {}
        for t in tensors:
            by_dtype.setdefault(t.dtype, []).append(t)
        for group in by_dtype.values():
            flat = torch.cat([t.detach().reshape(-1) for t in group])
            dist.broadcast(flat, 0)
            with torch.no_grad():
                torch._foreach_copy_(group, [
                    v.view_as(t) for v, t in zip(
                        flat.split([t.numel() for t in group]), group)])

    def row_map(self, local_rows: int) -> RowMap:
        """Rank r's strided rows of a global batch of world x local_rows,
        with the sum over the ranks."""
        return RowMap(self.world, self.rank, self.world * local_rows,
                      self.all_sum)


def _rank_entry(fn, rank: int, devices, backend: str, store: str,
                group_timeout: float, threads: Optional[int], args,
                results) -> None:
    """A spawned rank: bind its device, join the group, run fn, report."""
    device = torch.device(devices[rank])
    if threads:
        torch.set_num_threads(threads)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(
        backend, init_method=f"file://{store}", rank=rank,
        world_size=len(devices),
        timeout=datetime.timedelta(seconds=group_timeout))
    try:
        out = fn(rank, len(devices), device, *args)
        # as bytes: a queue would share a tensor's storage through a file
        # descriptor that dies with this process
        results.put((rank, True, pickle.dumps(out)))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        dist.destroy_process_group()


def launch(fn: Callable, args: Sequence = (),
           devices: Sequence = ("cpu",), backend: Optional[str] = None,
           timeout: Optional[float] = None, group_timeout: float = 1800.0,
           threads: Optional[int] = None) -> List[Any]:
    """Run fn(rank, world, device, *args) in one spawned process per entry
    of `devices` (a device may repeat: two ranks can share one card under
    gloo), in one process group, and return the ranks' results in rank
    order. `fn` and `args` must pickle (fn by its import path). Raises when
    a rank fails (after stopping the others) or when `timeout` seconds pass
    (None: no limit; a collective still fails after `group_timeout`).
    SIGTERM and SIGINT sent to this process are forwarded to the ranks.
    `threads` sets each rank's intra-op threads."""
    devices = [torch.device(d) for d in devices]
    backend = backend or default_backend(devices)
    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="fabind-dp-")
    results = ctx.Queue()
    procs = [ctx.Process(
        target=_rank_entry, name=f"fabind-dp-rank{r}",
        args=(fn, r, devices, backend, os.path.join(tmp, "store"),
              group_timeout, threads, tuple(args), results))
        for r in range(len(devices))]

    def forward(signum, frame):
        for p in procs:
            if p.pid is not None and p.is_alive():
                os.kill(p.pid, signum)

    handlers = {}
    if threading.current_thread() is threading.main_thread():
        handlers = {s: signal.signal(s, forward)
                    for s in (signal.SIGTERM, signal.SIGINT)}
    out: Dict[int, Any] = {}
    errors: Dict[int, str] = {}
    deadline = None if timeout is None else time.monotonic() + timeout
    try:
        for p in procs:
            p.start()
        # drain the results while waiting: a rank's report may still be in
        # the pipe when its exit code is already 0
        while len(out) < len(procs):
            try:
                rank, ok, value = results.get(timeout=0.2)
                if ok:
                    out[rank] = pickle.loads(value)
                else:
                    errors[rank] = value
                continue
            except queue.Empty:
                pass
            codes = [p.exitcode for p in procs]
            failed = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if failed or errors:
                raise RuntimeError(
                    f"data-parallel rank(s) {sorted(set(failed) | set(errors))}"
                    f" failed (exit codes {codes}):\n"
                    + "\n".join(errors.values()))
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(
                    f"data-parallel ranks did not finish in {timeout} s "
                    f"(exit codes {codes})")
        for p in procs:
            p.join(None if deadline is None
                   else max(deadline - time.monotonic(), 1.0))
        return [out[r] for r in range(len(procs))]
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            if p.pid is not None:
                p.join(10)
                if p.is_alive():
                    p.kill()
                    p.join(10)
        for s, h in handlers.items():
            signal.signal(s, h)
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------- serving
def _bind(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.set_device(device)


class ReplicaSet:
    """One copy of `module` per entry of `devices` (the first is `module`
    itself, moved there), each with a host thread of its own.

    `split` cuts a batch of B rows into N contiguous blocks of B / N (B must
    divide), one on each replica's device; `row_map(r, B)` is block r's
    RowMap; `submit(r, fn, *args)` runs fn in replica r's thread (in order
    of submission, under the caller's grad and inference mode) and returns
    a Future; `map` runs one call per replica and waits; `gather`
    concatenates per-replica outputs in row order on the first device. With
    one replica everything runs inline in the caller's thread."""

    def __init__(self, module: Optional[torch.nn.Module],
                 devices: Sequence):
        import copy

        self.devices = [torch.device(d) for d in devices]
        self.modules: List[Optional[torch.nn.Module]] = [None] * len(
            self.devices)
        if module is not None:
            for r, d in enumerate(self.devices):
                self.modules[r] = (module if r == 0
                                   else copy.deepcopy(module)).to(d)
        self._pools = ([ThreadPoolExecutor(1, f"fabind-replica{r}", _bind,
                                           (d,))
                        for r, d in enumerate(self.devices)]
                       if len(self.devices) > 1 else [])

    def __len__(self) -> int:
        return len(self.devices)

    def blocks(self, rows: int) -> List[slice]:
        """The contiguous row blocks of a batch of `rows`."""
        n = len(self.devices)
        if rows % n:
            raise ValueError(f"batch of {rows} rows not divisible by dp {n}")
        k = rows // n
        return [slice(r * k, (r + 1) * k) for r in range(n)]

    def row_map(self, r: int, rows: int) -> RowMap:
        """Block r's row map in a batch of `rows`."""
        if len(self.devices) == 1:
            return RowMap()
        return RowMap(1, self.blocks(rows)[r].start, rows)

    def split(self, batch) -> list:
        """A batch (FABindBatch) on any device as one block per replica, on
        the replicas' devices."""
        if len(self.devices) == 1:
            return [batch]
        return [map_batch(batch, lambda t, s=s, d=d: t[s].to(d))
                for s, d in zip(self.blocks(batch.batch_size), self.devices)]

    def submit(self, r: int, fn: Callable, *args) -> Future:
        """fn(*args) in replica r's thread, under the caller's autograd
        modes."""
        if not self._pools:
            f: Future = Future()
            try:
                f.set_result(fn(*args))
            except Exception as e:   # raised when the future is read
                f.set_exception(e)
            return f
        grad = torch.is_grad_enabled()
        inference = torch.is_inference_mode_enabled()

        def run():
            with torch.inference_mode(inference), \
                    torch.set_grad_enabled(grad):
                return fn(*args)

        return self._pools[r].submit(run)

    def map(self, fn: Callable, *per_replica) -> list:
        """[fn(r, *(a[r] for a in per_replica)) for every replica], each
        in its replica's thread; waits for all."""
        futs = [self.submit(r, fn, r, *(a[r] for a in per_replica))
                for r in range(len(self.devices))]
        return [f.result() for f in futs]

    def gather(self, outs: list):
        """Per-replica outputs (tuples of tensors or None, or tensors)
        concatenated along the rows on the first device; one replica's as
        they are."""
        if len(outs) == 1:
            return outs[0]
        first = outs[0]
        if isinstance(first, Tensor):
            return torch.cat([o.to(self.devices[0]) for o in outs])
        return type(first)(
            None if parts[0] is None else
            torch.cat([t.to(self.devices[0]) for t in parts])
            for parts in zip(*outs))

    def close(self) -> None:
        for p in self._pools:
            p.shutdown(wait=True)
