"""The processed store's index (`data.pt`, `data_new.pt`) without pandas.

The reference saves the index of its processed PDBbind store as a pandas
DataFrame through `torch.save` (FABind/fabind/data.py:42-96), and the JAX
package reads it with `torch.load`. The port does not need pandas:

- `load_frame(path)` reads such a file through `torch.load` with a
  restricted unpickler. Its `find_class` maps an allowlist of pandas,
  pyarrow and numpy globals to small stand-ins, which assemble the columns
  in row order from each layout pandas writes: pandas >= 2 blocks
  (`_unpickle_block`, `BlockManager(blocks, axes)`) over numpy arrays or
  pyarrow string arrays (`ArrowStringArray` over `_restore_array`), and the
  pandas 1.x `BlockManager` state (`{"0.14.1": {"axes", "blocks"}}`, numpy
  or object arrays, `Int64Index` axes). A global outside the allowlist
  raises, naming it and the file.
- `save_frame(path, columns)` writes `GLOBAL 'pandas DataFrame'` applied to
  a dict of columns, which every pandas version loads as a DataFrame, so
  the JAX package reads what the port writes.

A `Frame` holds the columns (numpy arrays for numeric and bool columns,
lists for object and string ones) with positional rows, as the JAX source's
`reset_index(drop=True)` leaves them.
"""
from __future__ import annotations

import codecs
import pickle
import types
from typing import Dict, List, Sequence

import numpy as np
import torch


class Frame:
    """Named columns of equal length; rows are positions 0..n-1."""

    def __init__(self, columns: Dict[str, Sequence]):
        self.columns = {str(k): _column(v) for k, v in columns.items()}
        lengths = {len(v) for v in self.columns.values()}
        if len(lengths) > 1:
            raise ValueError(f"columns of unequal length: "
                             f"{ {k: len(v) for k, v in self.columns.items()} }")
        self.n_rows = lengths.pop() if lengths else 0

    def __len__(self) -> int:
        return self.n_rows

    def __contains__(self, name) -> bool:
        return name in self.columns

    def __getitem__(self, name):
        return self.columns[name]

    @property
    def names(self) -> List[str]:
        return list(self.columns)

    def row(self, i: int) -> dict:
        return {k: v[i] for k, v in self.columns.items()}


def _column(values):
    """A column as the Frame keeps it: a 1-D numeric or bool ndarray, or a
    list of Python objects."""
    if isinstance(values, _Strings):
        return list(values.items)
    if isinstance(values, np.ndarray) and values.dtype != object:
        return np.ascontiguousarray(values.reshape(-1))
    return list(values)


# ---- stand-ins for the globals a pickled DataFrame names ------------------

class _DataFrame:
    """`pandas DataFrame`: NEWOBJ then BUILD with its state (a pickled
    DataFrame), or called with a dict of columns (save_frame's form)."""

    def __init__(self, data=None):
        self.frame = None if data is None else Frame(data)

    def __setstate__(self, state):
        mgr = state
        if isinstance(state, dict):
            mgr = state["_mgr"] if "_mgr" in state else state["_data"]
        if not isinstance(mgr, _BlockManager):
            raise pickle.UnpicklingError(
                f"a DataFrame whose state holds {type(mgr).__name__}, "
                f"not a BlockManager")
        self.frame = mgr.frame()


class _Block:
    """`pandas._libs.internals _unpickle_block(values, placement, ndim)`,
    and a pandas 1.x state's {"values", "mgr_locs"}."""

    def __init__(self, values, placement, ndim=2):
        self.values, self.placement = values, placement


class _BlockManager:
    """`BlockManager(blocks, axes)` (pandas >= 2), or NEWOBJ then BUILD
    with the pandas 1.x state (axes, values, items, {"0.14.1": ...})."""

    def __init__(self, blocks=(), axes=()):
        self.blocks, self.axes = list(blocks), list(axes)

    def __setstate__(self, state):
        if not (isinstance(state, tuple) and len(state) >= 4
                and "0.14.1" in state[3]):
            raise pickle.UnpicklingError(
                "a BlockManager state older than pandas 0.14.1")
        s = state[3]["0.14.1"]
        self.axes = list(s["axes"])
        self.blocks = [_Block(b["values"], b["mgr_locs"]) for b in s["blocks"]]

    def frame(self) -> Frame:
        names, rows = (list(_column(a)) for a in self.axes)
        cols: List = [None] * len(names)
        for b in self.blocks:
            p = b.placement
            locs = (range(*p.indices(len(names))) if isinstance(p, slice)
                    else np.asarray(p).reshape(-1).tolist())
            v = b.values
            parts = (list(v) if isinstance(v, np.ndarray) and v.ndim == 2
                     else [v])
            if len(parts) != len(locs):
                raise pickle.UnpicklingError(
                    f"a block of {len(parts)} columns placed at "
                    f"{len(locs)} positions")
            for loc, part in zip(locs, parts):
                cols[loc] = part
        missing = [n for n, c in zip(names, cols) if c is None]
        if missing:
            raise pickle.UnpicklingError(f"columns without a block: {missing}")
        frame = Frame(dict(zip(names, cols)))
        if len(names) and len(frame) != len(rows):
            raise pickle.UnpicklingError(
                f"{len(frame)} rows under an index of {len(rows)}")
        return frame


class _IndexKind:
    """An Index class passed to `_new_Index`: only RangeIndex matters."""

    def __init__(self, name):
        self.name = name


def _new_index(kind: _IndexKind, d: dict):
    if kind.name == "RangeIndex":
        return np.arange(d["start"], d["stop"], d["step"])
    return _column(d["data"])


class _Strings:
    """A pyarrow string array's values (None where null)."""

    def __init__(self, items=()):
        self.items = list(items)


class _ArrowStringArray(_Strings):
    """`pandas.arrays ArrowStringArray`: NEWOBJ, then BUILD with
    {"_pa_array": <_restore_array>, "_dtype": ...}."""

    def __setstate__(self, state):
        arr = state["_pa_array"]
        if not isinstance(arr, _Strings):
            raise pickle.UnpicklingError(
                "an ArrowStringArray without a string array")
        # pandas' str dtype reads a null as NaN
        self.items = [float("nan") if s is None else s for s in arr.items]


_OFFSET_DTYPE = {"string": np.int32, "utf8": np.int32,
                 "large_string": np.int64, "large_utf8": np.int64}


def _restore_array(data):
    """`pyarrow.lib _restore_array((type, length, null_count, offset,
    buffers, children, dictionary))` for a string array: validity bitmap
    (or None), offsets, UTF-8 bytes."""
    kind, length, _, offset, buffers, _, _ = data
    if kind not in _OFFSET_DTYPE:
        raise pickle.UnpicklingError(
            f"a pyarrow array of type {kind!r}; the port reads string "
            f"arrays only")
    valid_bits, offs, chars = buffers
    offs = np.frombuffer(offs, _OFFSET_DTYPE[kind])[offset:offset + length + 1]
    chars = bytes(chars) if chars is not None else b""
    valid = np.ones(length, bool)
    if valid_bits is not None:
        bits = np.unpackbits(np.frombuffer(valid_bits, np.uint8),
                             bitorder="little")
        valid = bits[offset:offset + length].astype(bool)
    return _Strings(chars[offs[i]:offs[i + 1]].decode("utf-8") if valid[i]
                    else None for i in range(length))


def _ignored(*args):
    return None


_RECONSTRUCT = np.zeros(1).__reduce__()[0]
_SCALAR = np.float64(0).__reduce__()[0]
_INDEX_CLASSES = ("Index", "RangeIndex", "Int64Index")

_ALLOWED = {
    ("numpy", "ndarray"): np.ndarray,
    ("numpy", "dtype"): np.dtype,
    ("_codecs", "encode"): codecs.encode,
    ("pandas", "DataFrame"): _DataFrame,
    ("pandas.core.frame", "DataFrame"): _DataFrame,
    ("pandas.core.internals.managers", "BlockManager"): _BlockManager,
    ("pandas._libs.internals", "_unpickle_block"): _Block,
    ("pandas.core.indexes.base", "_new_Index"): _new_index,
    ("pandas.arrays", "ArrowStringArray"): _ArrowStringArray,
    ("pandas", "StringDtype"): _ignored,
    ("pyarrow.lib", "type_for_alias"): str,
    ("pyarrow.lib", "py_buffer"): bytes,
    ("pyarrow.lib", "_restore_array"): _restore_array,
}
for _m in ("numpy._core.multiarray", "numpy.core.multiarray"):
    _ALLOWED[(_m, "_reconstruct")] = _RECONSTRUCT
    _ALLOWED[(_m, "scalar")] = _SCALAR
for _m in ("builtins", "__builtin__"):
    for _f in (slice, bytearray):
        _ALLOWED[(_m, _f.__name__)] = _f
for _m in ("pandas", "pandas.core.indexes.base", "pandas.core.indexes.range",
           "pandas.core.indexes.numeric"):
    for _c in _INDEX_CLASSES:
        _ALLOWED[(_m, _c)] = _IndexKind(_c)


def _reader_module(path: str):
    """A pickle module for torch.load whose Unpickler resolves only the
    allowlisted globals."""

    class Unpickler(pickle.Unpickler):
        def find_class(self, module, name):
            try:
                return _ALLOWED[(module, name)]
            except KeyError:
                raise pickle.UnpicklingError(
                    f"{path}: {module}.{name} is not among the classes the "
                    f"port reads from a store index") from None

    def load(f, **kw):
        return Unpickler(f, **kw).load()

    return types.SimpleNamespace(__name__="fabind_frame_reader",
                                 Unpickler=Unpickler, load=load)


def load_frame(path: str) -> Frame:
    """The DataFrame pickled at `path` (data.pt / data_new.pt) as a Frame."""
    obj = torch.load(path, weights_only=False,
                     pickle_module=_reader_module(path))
    if not isinstance(obj, _DataFrame) or obj.frame is None:
        raise pickle.UnpicklingError(
            f"{path}: holds {type(obj).__name__}, not a DataFrame")
    return obj.frame


# ---- the writer -------------------------------------------------------------

class _GlobalRef:
    """A global written by name, never imported (the writer's host may not
    have its module)."""

    def __init__(self, module: str, name: str):
        self.module, self.name = module, name

    def __call__(self, *a):
        raise TypeError(f"{self.module}.{self.name} is written, not called")


class _Reduce:
    """An object pickled as `func(*args)`."""

    def __init__(self, func: _GlobalRef, args: tuple):
        self.func, self.args = func, args

    def __reduce__(self):
        return self.func, self.args


class Pickler(pickle._Pickler):
    """The pure-Python pickler, which writes a `_GlobalRef` as GLOBAL."""

    dispatch = dict(pickle._Pickler.dispatch)

    def save_global_ref(self, obj):
        self.write(pickle.GLOBAL + f"{obj.module}\n{obj.name}\n".encode())
        self.memoize(obj)

    dispatch[_GlobalRef] = save_global_ref


_WRITER = types.SimpleNamespace(__name__="fabind_frame_writer",
                                Pickler=Pickler)
_PANDAS_DATAFRAME = _GlobalRef("pandas", "DataFrame")


def _pandas_column(values) -> np.ndarray:
    """A 1-D array pandas takes as one column: numeric arrays as they are,
    anything else as an object array with one element per row."""
    if isinstance(values, np.ndarray) and values.dtype != object:
        if values.ndim != 1:
            raise ValueError(f"a column of shape {values.shape}")
        return values
    out = np.empty(len(values), object)
    for i, v in enumerate(values):
        out[i] = v
    return out


def save_frame(path: str, columns: Dict[str, Sequence]) -> None:
    """Write `columns` as `pandas.DataFrame(columns)` through torch.save."""
    Frame(columns)   # equal lengths
    cols = {str(k): _pandas_column(v) for k, v in columns.items()}
    torch.save(_Reduce(_PANDAS_DATAFRAME, (cols,)), path,
               pickle_module=_WRITER)
