"""CUDA graphs of the docking stage, for serving and best-of-N sampling.

A live DockingEngine with one replica on a CUDA device (serve.py) docks
each batch's predicted pocket, and each best-of-N pass's dock half, by
replaying its bucket's graphs instead of launching every kernel of the
docking stage one by one from Python. The pocket stage (a pass's pocket
half), the pocket center and the crop stay eager, called through their
usual names (models/fabind.py, sample.py), and so does post-optimization.

- Segments. The docking stage (`FABind._dock`) is captured as a chain of
  graphs split at each call of a matrix product (aten::mm, addmm, bmm,
  baddbmm), of the edge gate (`fabind_tpu_torch::edge_gate_pair`) and of
  dropout (`fabind_tpu_torch::dropout`). Those calls run eagerly between
  the segments, through their registered operators, so each keeps its
  operator record and its launch as on the eager path: a product writes
  into the output it returned at capture through its out= overload, the
  gate's two outputs are copied there, dropout's kernel writes there
  (ops/dropout.py `writing_into`; the plain version's output is copied).
  A dispatch mode (`_Segmenter`) makes the split while the chain captures:
  it runs composite operations (linear, matmul, einsum) as eager dispatch
  does, so the products inside them are the ones it sees, and opens a
  segment at the first operation after an eager call that is not a view.
- The recycle round is the unit of replay. The chain holds the steps
  before the recycle loop, ONE round (`_Rounds`, the loop's `rounds` hook
  in models/att_model.py, between two marks of the chain) and the heads.
  A replay at recycle count k runs the round k times, keyed 0..k-2 and
  then n_iter - 1 as the Python loop keys them, copying each round's
  output coordinates into its input between rounds; so one capture serves
  every count, the count an input of the replay.
- Static inputs. A bucket's chain reads fixed tensors: the batch fields
  the docking stage reads (found at capture), the pocket stage's node
  embeddings and the crop's indices and mask, and in a stochastic chain
  the pass's seed and the dropout's round (the loop's, and 0 outside it),
  int64 tensors made before the capture. Each batch copies its own into
  them before the replay (the seed as the eager forward uploads it), so a
  capture uploads nothing and bakes no seed in.
- Capture. A bucket's first batch captures the bucket from copies of its
  inputs on a side stream, into a memory pool of its own, and is the
  first replay; every later batch replays. At capture an eager call
  launches nothing: its outputs are allocated in the pool at its output
  shapes, and it keeps its tensors without owning their memory, so the
  pool reuses what the capture frees as the eager path's allocator would
  (the memory stays near the eager path's). A bucket is a shape bucket at
  one batch size and a kind of forward: deterministic, or stochastic (the
  dock half of a best-of-N pass, on the whole batch), a chain each,
  captured for the use_stage2 and ctx_k of its first batch; a batch with
  others, a forward of the other kind or a recycle count given as a
  tensor docks eagerly. A capture that fails leaves its bucket eager, with
  a warning.
- Concurrency. Replays of one bucket are serialized by the bucket's lock,
  held from the copies in through the copies of its outputs out of the
  graph's memory, so batches (and passes) launched before any is read
  back keep their own results; on the card the next replay's stream waits
  for the last one's copies out, so callers on other streams keep theirs
  too. A capture runs in CUDA's thread-local capture mode, so other
  threads keep serving other buckets meanwhile.

The capture step is a backend made per chain: `CudaGraphs` on the card
(`backend_for`), or `Rerun`, which keeps each segment's ATen operations
and re-runs them in place, so the segment runner runs off the card (the
CPU tests use it).
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import threading
import warnings
from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_map

from fabind_tpu_torch.models.layers import (RowMap, StochasticKeys,
                                            active_stochastic,
                                            enter_stochastic, recycle_round)
from fabind_tpu_torch.ops import dropout
from fabind_tpu_torch.ops import edge_gate  # noqa: F401  (the gate operator)
from fabind_tpu_torch.utils import tracing

Tensor = torch.Tensor
aten = torch.ops.aten


# ---------------------------------------------------------------- backends
class CudaGraphs:
    """Capture on the card: each segment a torch.cuda.CUDAGraph captured
    on a side stream into one memory pool, in thread-local mode."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.pool = torch.cuda.graph_pool_handle()
        self.stream = torch.cuda.Stream(self.device)
        self._aliases: Dict[tuple, Tensor] = {}

    @contextlib.contextmanager
    def capturing(self):
        """While a chain captures: the side stream is current, with its
        cuBLAS workspace (a product there) and the inputs' copies done; a
        graph of one kernel holds the pool from the start, so the eager
        calls' outputs can go there before the first segment."""
        with torch.cuda.device(self.device), torch.cuda.stream(self.stream):
            a = torch.ones(8, 8, device=self.device)
            torch.addmm(a[0], a, a)
            torch.cuda.synchronize(self.device)
            self._hold = torch.cuda.CUDAGraph()
            self._hold.capture_begin(pool=self.pool,
                                     capture_error_mode="thread_local")
            torch.zeros(1, device=self.device)
            self._hold.capture_end()
            yield

    @contextlib.contextmanager
    def allocating(self):
        """Between segments: this thread's allocations go to the pool, so a
        tensor the capture frees leaves its memory to later segments, as
        the eager path's would."""
        index = torch.cuda.current_device()
        begin = getattr(torch._C, "_cuda_beginAllocateCurrentThreadToPool",
                        None) or torch._C._cuda_beginAllocateCurrentStreamToPool
        begin(index, self.pool)
        try:
            yield
        finally:
            torch._C._cuda_endAllocateToPool(index, self.pool)
            torch._C._cuda_releasePool(index, self.pool)

    def begin(self) -> None:
        self._graph = torch.cuda.CUDAGraph()
        self._graph.capture_begin(pool=self.pool,
                                  capture_error_mode="thread_local")

    def record(self, func, args, kwargs, out) -> None:
        """The graph holds what the operation launched."""

    def end(self) -> "torch.cuda.CUDAGraph":
        graph, self._graph = self._graph, None
        graph.capture_end()
        return graph

    def alias(self, t: Tensor) -> Tensor:
        """t at its address without owning its memory: an eager call keeps
        its tensors so, and the pool reuses their memory where the capture
        freed them, which later segments overwrite only after the call.
        One alias serves every call that reads the same address and layout
        (the weights, each recycle)."""
        st = t.untyped_storage()
        key = (st.data_ptr(), st.nbytes(), t.storage_offset(), t.shape,
               t.stride(), t.dtype)
        a = self._aliases.get(key)
        if a is None:
            view = torch._C._construct_storage_from_data_pointer(
                st.data_ptr(), t.device, st.nbytes())
            a = self._aliases[key] = torch.empty(
                0, dtype=t.dtype, device=t.device).set_(
                    view, t.storage_offset(), t.shape, t.stride())
        return a


class _Recorder:
    """One segment's ATen operations, kept to run again: an operation that
    writes its inputs is re-run as it is; one with fresh outputs is re-run
    and its results copied into the recorded outputs; an output that
    shares an input's storage (a view) needs nothing."""

    def __init__(self):
        self.ops: List[Tuple] = []

    def add(self, func, args, kwargs, out) -> None:
        if func._schema.is_mutable:
            self.ops.append((func, args, kwargs, ()))
            return
        inputs = {t.untyped_storage().data_ptr()
                  for t in _tensors(args, kwargs)}
        fresh = tuple((i, t) for i, t in enumerate(_leaves(out))
                      if isinstance(t, Tensor)
                      and t.untyped_storage().data_ptr() not in inputs)
        if fresh:
            self.ops.append((func, args, kwargs, fresh))

    def replay(self) -> None:
        for func, args, kwargs, fresh in self.ops:
            res = func(*args, **kwargs)
            if fresh:
                leaves = _leaves(res)
                for i, dst in fresh:
                    dst.copy_(leaves[i])


class Rerun:
    """Stands in for CudaGraphs off the card: each segment keeps the ATen
    operations it runs (_Recorder) and replays them on the same tensors,
    so a segment reads and writes fixed tensors as a graph does; it owns
    every tensor it keeps."""

    def __init__(self, device=None):
        self._open: Optional[_Recorder] = None

    def capturing(self):
        return contextlib.nullcontext()

    def allocating(self):
        return contextlib.nullcontext()

    def begin(self) -> None:
        self._open = _Recorder()

    def record(self, func, args, kwargs, out) -> None:
        self._open.add(func, args, kwargs, out)

    def end(self) -> _Recorder:
        seg, self._open = self._open, None
        return seg

    @staticmethod
    def alias(t: Tensor) -> Tensor:
        return t.view(t.shape)


def backend_for(device) -> Optional[Callable[[torch.device], object]]:
    """The capture backend of an engine on `device` (a class called with
    the device, once per bucket), None where docking stays eager: off the
    card."""
    return CudaGraphs if torch.device(device).type == "cuda" else None


# ----------------------------------------------------------- segment chain
# the matrix products, run between segments into the outputs they returned
# at capture through their out= overloads
_PRODUCTS = {aten.mm.default: aten.mm.out, aten.addmm.default: aten.addmm.out,
             aten.bmm.default: aten.bmm.out,
             aten.baddbmm.default: aten.baddbmm.out}
# operations that launch nothing besides the views and the in-place
# changes of a view's shape (aten::_unsafe_view returns a tensor on its
# input's storage without the view annotation): they open no segment
_METADATA = {aten._unsafe_view.default}
_INDEX_OPS = ("aten::index.Tensor", "aten::index_put",
              "aten::index_put_", "aten::_index_put_impl_")
_COMPOSITE = torch._C.DispatchKey.CompositeImplicitAutograd


def _gate_op():
    return torch.ops.fabind_tpu_torch.edge_gate_pair.default


def _dropout_op():
    return torch.ops.fabind_tpu_torch.dropout.default


def _leaves(x) -> list:
    """The leaves of an operator's arguments or outputs: a value, or a
    tuple or list of values and tuples or lists of them."""
    if not isinstance(x, (tuple, list)):
        return [x]
    out = []
    for y in x:
        if isinstance(y, (tuple, list)):
            out.extend(y)
        else:
            out.append(y)
    return out


def _tensors(args, kwargs=None) -> list:
    """The tensors among an operator's arguments (or outputs)."""
    out = [t for t in _leaves(args) if isinstance(t, Tensor)]
    if kwargs:
        out += [t for t in _leaves(list(kwargs.values()))
                if isinstance(t, Tensor)]
    return out


# how the mode treats an operator (per operator and device type)
_PASS, _EAGER, _COMPOSITE_KERNEL, _REFUSED, _INDEX, _METADATA_OP, \
    _KERNEL = range(7)
_KINDS: Dict[tuple, int] = {}


def _kind(func, device_type: str) -> int:
    key = (func, device_type)
    kind = _KINDS.get(key)
    if kind is None:
        name, tags = func.name(), func.tags
        backend = getattr(torch._C.DispatchKey, device_type.upper())
        if func.namespace == "profiler":          # a span's range, host only
            kind = _PASS
        elif func in _PRODUCTS or func in (_gate_op(), _dropout_op()):
            kind = _EAGER
        elif (torch._C._dispatch_has_kernel_for_dispatch_key(name, _COMPOSITE)
              and not torch._C._dispatch_has_kernel_for_dispatch_key(
                  name, backend)):
            # eager dispatch runs its composite kernel, which calls other
            # operators (linear's addmm)
            kind = _COMPOSITE_KERNEL
        elif (torch.Tag.data_dependent_output in tags
              or torch.Tag.nondeterministic_seeded in tags
              or torch.Tag.dynamic_output_shape in tags
              and name not in _INDEX_OPS):
            # a read-back to the host, a random draw, a shape set by data
            kind = _REFUSED
        elif name in _INDEX_OPS:
            kind = _INDEX
        elif (func.is_view or func in _METADATA
              or torch.Tag.inplace_view in tags):
            kind = _METADATA_OP
        else:
            kind = _KERNEL
        _KINDS[key] = kind
    return kind


def _product_out(func, args) -> Optional[tuple]:
    """(shape, dtype) of a matrix product's (contiguous) output, None for
    another operator."""
    if func not in _PRODUCTS:
        return None
    a, b = (args[1], args[2]) if func in (aten.addmm.default,
                                          aten.baddbmm.default) else args[:2]
    return (*a.shape[:-1], b.shape[-1]), a.dtype


def _on_meta(x):
    if isinstance(x, Tensor):
        return torch.empty_strided(x.shape, x.stride(), dtype=x.dtype,
                                   device="meta")
    return x


def _keep_requires_grad(out) -> None:
    """A view of a tensor that requires grad requires grad, as on the
    eager path under inference mode, where autograd's view layer marks it;
    inside a composite kernel the mode runs, that layer is passed over.
    Composite kernels branch on it (matmul folds a batch into one product
    when an operand requires grad)."""
    for t in _tensors(out):
        if not t.requires_grad and (t.is_floating_point() or t.is_complex()):
            t.requires_grad_(True)


class _Segmenter(TorchDispatchMode):
    """Entered while a chain captures: hands each product, gate and
    dropout call to the chain, which runs it eagerly between segments;
    runs a composite operation's kernel with the mode entered, so its
    parts are the operations seen, as on the eager path; opens a segment
    at an operation that is not a view; refuses what a graph cannot hold
    (a read-back to the host, an output shape that depends on the data, a
    random draw)."""

    def __init__(self, chain: "SegmentChain"):
        super().__init__()
        self.chain = chain
        self._inside = 0          # composite kernels being run

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        tensors = _tensors(args, kwargs)
        kind = _kind(func, tensors[0].device.type if tensors else "cpu")
        if kind == _PASS:
            return func(*args, **kwargs)
        if kind == _EAGER:
            return self.chain.eager(func, args, kwargs)
        if kind == _COMPOSITE_KERNEL:
            self._inside += 1
            try:
                with self:
                    return func._op_dk(_COMPOSITE, *args, **kwargs)
            finally:
                self._inside -= 1
        if kind == _REFUSED or kind == _INDEX and any(
                isinstance(t, Tensor) and t.dtype in (torch.bool, torch.uint8)
                for t in _leaves(args[1])):
            raise RuntimeError(f"{func} cannot run inside a graph segment")
        if kind != _METADATA_OP:
            self.chain.open()
        out = func(*args, **kwargs)
        if not isinstance(out, Tensor) and any(
                not isinstance(t, Tensor) for t in _leaves(out)
                if t is not None):
            raise RuntimeError(f"{func} returns to the host inside a graph "
                               f"segment")
        if kind == _METADATA_OP:
            if self._inside and func.is_view and any(
                    t.requires_grad for t in tensors):
                _keep_requires_grad(out)
        elif self.chain.is_open:
            self.chain.backend.record(func, args, kwargs, out)
        return out


class SegmentChain:
    """fn(*args) captured once as graph segments split at each product,
    gate and dropout call, and replayed with those calls launched eagerly
    between the segments. `outputs` are fn's outputs at fixed addresses,
    rewritten by each replay; `segments` the captured segments and `calls`
    the operators called between them, in order. Without fn the chain is
    empty until `capture`; fn may `mark` the chain while it captures, and
    the steps between two marks replay on their own (`replay(start,
    stop)`)."""

    def __init__(self, backend, fn: Optional[Callable] = None, *args):
        self.backend = backend
        self.segments: List = []
        self.calls: List = []
        self._steps: List[Callable[[], None]] = []
        self.is_open = False
        self.outputs = None
        if fn is not None:
            self.capture(fn, *args)

    def capture(self, fn: Callable, *args) -> None:
        backend = self.backend
        with backend.capturing():
            try:
                with _Segmenter(self):
                    self.outputs = fn(*args)
                self._close()
            except BaseException:
                if self.is_open:
                    self.is_open = False
                    # the capture's own error is the one to see
                    with contextlib.suppress(Exception):
                        backend.end()
                raise

    def mark(self) -> int:
        """Ends the open segment, so that the steps before and after this
        point replay apart; returns the index of the next step."""
        self._close()
        return len(self._steps)

    @property
    def gates(self) -> List:
        """The gate calls between segments."""
        return [c for c in self.calls if c is _gate_op()]

    def open(self) -> None:
        if not self.is_open:
            self.backend.begin()
            self.is_open = True

    def _close(self) -> None:
        if self.is_open:
            self.is_open = False
            seg = self.backend.end()
            self.segments.append(seg)
            self._steps.append(seg.replay)

    def eager(self, func, args, kwargs):
        """A product, gate or dropout call at capture: ends the open
        segment and returns outputs allocated at the shapes of func's meta
        kernel, which the call writes at replay and later segments read."""
        self._close()
        device = _tensors(args, kwargs)[0].device
        product = _product_out(func, args)
        if product is None:
            meta = func(*tree_map(_on_meta, args),
                        **tree_map(_on_meta, kwargs))
        with self.backend.allocating():
            if product is not None:
                out = torch.empty(product[0], dtype=product[1], device=device)
            else:
                out = tree_map(lambda m: torch.empty_strided(
                    m.shape, m.stride(), dtype=m.dtype, device=device), meta)
        # the call keeps aliases of its own (the backend's: on the card
        # they do not own the memory), so a later in-place change of the
        # outputs' shape (matmul's squeeze_) leaves them be
        keep = functools.partial(tree_map, lambda t: self.backend.alias(t)
                                 if isinstance(t, Tensor) else t)
        args, kwargs, dst = keep(args), keep(kwargs), keep(out)
        into = _PRODUCTS.get(func)
        if into is not None:
            self._steps.append(functools.partial(into, *args, out=dst,
                                                 **kwargs))
        else:
            outs = _tensors(dst)
            # a dropout launch on the card writes its output in place
            into = (functools.partial(dropout.writing_into, outs[0])
                    if func is _dropout_op() else contextlib.nullcontext)

            def call():
                with into():
                    res = _tensors(func(*args, **kwargs))
                for o, r in zip(outs, res):
                    if r.data_ptr() != o.data_ptr():
                        o.copy_(r)
            self._steps.append(call)
        self.calls.append(func)
        return out

    def replay(self, start: int = 0, stop: Optional[int] = None) -> None:
        """Replays steps start..stop (default: all of them)."""
        for step in self._steps[start:stop]:
            step()


# ---------------------------------------------------------- docking stage
# FABind._dock's outputs that the inference reads (models/fabind.py
# inference_flexible_diag): coordinates, confidence, pocket coordinates
READ = (0, 5, 7)


def _static(t: Tensor) -> Tensor:
    """A copy of t with t's strides (a slice's too, where clone() would
    make it contiguous), so the captured kernels are the eager ones."""
    return torch.empty_strided(t.shape, t.stride(), dtype=t.dtype,
                               device=t.device).copy_(t)


class _ReadFields:
    """A batch whose tensor fields are copies, recording which ones are
    read (attribute access); anything else is the batch's."""

    def __init__(self, batch):
        self._batch = batch
        self.copies = {f.name: _static(getattr(batch, f.name))
                       for f in dataclasses.fields(batch)
                       if isinstance(getattr(batch, f.name), Tensor)}
        self.read: List[str] = []

    def __getattr__(self, name):
        if name in self.copies:
            if name not in self.read:
                self.read.append(name)
            return self.copies[name]
        return getattr(self._batch, name)


def _copy_in(dst: Tensor, src: Tensor, what: str) -> None:
    if (src.shape, src.stride(), src.dtype) != (dst.shape, dst.stride(),
                                                 dst.dtype):
        raise ValueError(f"graph input {what}: {tuple(src.shape)} "
                         f"{src.stride()} {src.dtype}, captured "
                         f"{tuple(dst.shape)} {dst.stride()} {dst.dtype}")
    dst.copy_(src)


class _Rounds:
    """The recycle loop while a chain captures (EfficientMCAttModel.forward's
    `rounds`): one round between two marks of the chain, its dropout keyed
    by the round tensor `key` (None in a deterministic forward), so that a
    replay runs those steps once per round of any count. Keeps the round's
    coordinates in (`x_in`) and out (`x_out`), which a replay carries from
    one round to the next."""

    def __init__(self, chain: SegmentChain, key: Optional[Tensor]):
        self.chain = chain
        self.key = key

    def __call__(self, step: Callable, x: Tensor):
        self.start = self.chain.mark()
        with recycle_round(self.key):
            out = step(x)
        self.stop = self.chain.mark()
        self.x_in, self.x_out = x, out[1]
        return out


class _Bucket:
    """One bucket's docking stage, for deterministic forwards or, with
    `stochastic`, for a thread's stochastic one (the dock half of a
    best-of-N pass): captured at its first batch and replayed for it and
    every later one, at any recycle count."""

    def __init__(self, model, backend: Callable, device, label: str,
                 stochastic: bool = False):
        self.model = model
        self.backend = backend
        self.device = torch.device(device)
        self.label = label
        self.stochastic = stochastic
        self.n_iter = model.complex_model.n_iter
        self.lock = threading.Lock()
        self.chain: Optional[SegmentChain] = None
        self.rounds: Optional[_Rounds] = None
        self.consts: Optional[tuple] = None
        self.failed = False
        self.fields: Dict[str, Tensor] = {}
        self.inputs: Tuple[Tensor, ...] = ()
        # stochastic: the pass's seed and the dropout's round outside the
        # loop (0) and in it, int64 on the device
        self.seed = self.zero = self.round = None
        self._done = None         # on the card: the last replay's copies out

    def _fits(self, count) -> bool:
        """Whether this thread's forward can replay the bucket: deterministic
        or stochastic as the bucket, on the whole batch (no row map), at a
        recycle count the host knows."""
        state = active_stochastic()
        return ((state is not None) == self.stochastic
                and not isinstance(count, Tensor)
                and (state is None or state.rows == RowMap()))

    def __call__(self, batch, compound_out: Tensor, protein_out: Tensor,
                 pkt_idx: Tensor, pkt_mask: Tensor, use_stage2: bool,
                 ctx_k: int, count=None):
        """FABind._dock's outputs for this batch: the ones the inference
        reads (READ) are copies, the caller's to keep; on a replay the
        others are None."""
        tensors = (compound_out, protein_out, pkt_idx, pkt_mask)
        consts = (use_stage2, ctx_k)
        fits = self._fits(count)
        with self.lock:
            if fits and self.chain is None and not self.failed:
                self._capture(batch, tensors, consts)
            if not fits or self.chain is None or consts != self.consts:
                tracing.count("serve.graph_eager", key=self.label)
                return self.model._dock(batch, *tensors, *consts, count)
            if count is None:
                count = self.model.complex_model.draw_count()
            tracing.count("serve.graph_replays", key=self.label)
            with tracing.span("model.dock", graph="replay"):
                if self._done is not None:
                    torch.cuda.current_stream(self.device).wait_event(
                        self._done)
                for name, dst in self.fields.items():
                    _copy_in(dst, getattr(batch, name), name)
                for i, (dst, src) in enumerate(zip(self.inputs, tensors)):
                    _copy_in(dst, src, f"argument {i}")
                if self.stochastic:
                    # uploaded outside any capture, as the eager pass does
                    self.seed.copy_(active_stochastic().seed_tensor(
                        self.device))
                self._replay(count)
                out = tuple(t.clone() if i in READ else None
                            for i, t in enumerate(self.chain.outputs))
                if self.device.type == "cuda":
                    self._done = torch.cuda.Event()
                    self._done.record(torch.cuda.current_stream(self.device))
                return out

    def _replay(self, count: int) -> None:
        """The chain at recycle count `count`: the steps before the round,
        the round once per round of the Python loop (keyed 0..count - 2,
        then n_iter - 1, its coordinates carried), the steps after it."""
        chain, r = self.chain, self.rounds
        chain.replay(0, r.start)
        for i, key in enumerate([*range(count - 1), self.n_iter - 1]):
            if i:
                r.x_in.copy_(r.x_out)
            if self.stochastic:
                self.round.fill_(key)
            chain.replay(r.start, r.stop)
        chain.replay(r.stop)

    def _capture(self, batch, tensors, consts) -> None:
        static = _ReadFields(batch)
        inputs = tuple(_static(t) for t in tensors)
        keys = None
        if self.stochastic:
            # on the device before the capture: a capture uploads nothing
            self.seed, self.zero, self.round = (
                torch.zeros((), dtype=torch.int64, device=self.device)
                for _ in range(3))
            keys = StochasticKeys(seed_tensor=self.seed, rnd=self.zero)
        chain = SegmentChain(self.backend(self.device))
        rounds = _Rounds(chain, self.round)
        try:
            with enter_stochastic(keys):
                chain.capture(self.model._dock, static, *inputs, *consts,
                              None, rounds)
        except Exception as e:
            self.failed = True
            warnings.warn(f"docking graphs of bucket {self.label} not "
                          f"captured, it docks eagerly: {e!r}")
            return
        self.chain, self.rounds, self.consts = chain, rounds, consts
        self.fields = {f: static.copies[f] for f in static.read}
        self.inputs = inputs
        tracing.count("serve.graph_captures", key=self.label)


class DockGraphs:
    """One module's docking stage as graphs, a chain per bucket (its
    shapes and batch size) and kind of forward (deterministic or
    stochastic); `docking(...)` stands in for FABind._dock."""

    def __init__(self, model, backend: Callable, device):
        self.model = model
        self.backend = backend
        self.device = device
        self._lock = threading.Lock()
        self._buckets: Dict[tuple, _Bucket] = {}

    def docking(self, shapes, batch_size: int, label: str,
                stochastic: bool = False) -> _Bucket:
        """The bucket's docking stage for deterministic forwards, or with
        `stochastic` for stochastic ones: a callable with FABind._dock's
        arguments and outputs."""
        key = (shapes, batch_size, stochastic)
        with self._lock:
            b = self._buckets.get(key)
            if b is None:
                b = self._buckets[key] = _Bucket(self.model, self.backend,
                                                 self.device, label,
                                                 stochastic)
            return b

    @property
    def captured(self) -> int:
        """Chains captured so far."""
        return sum(b.chain is not None for b in self._buckets.values())
