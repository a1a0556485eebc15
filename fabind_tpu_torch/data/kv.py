"""KV-store entry point: the `lmdb` binding when it imports, else the
pure-Python LMDB codec (`data.mdb`).

Own copy of fabind_tpu/data/kv.py. Both backends expose the `lmdb.open(...)`
subset the port uses: begin() transactions with get/put/cursor. The
reference needs the C binding (FABind/fabind/data.py:6); here it is
optional, so a processed store is read and written on a host without
liblmdb.
"""
from __future__ import annotations


def have_lmdb() -> bool:
    try:
        import lmdb  # noqa: F401
        return True
    except ImportError:
        return False


def open_kv(path: str, readonly: bool = True, **kw):
    """Open an LMDB environment (a directory holding data.mdb)."""
    try:
        import lmdb
        return lmdb.open(path, readonly=readonly, **kw)
    except ImportError:
        from fabind_tpu_torch.data import mdb
        return mdb.open(path, readonly=readonly, **kw)


def write_kv(path: str, items) -> None:
    """Put `items` (dict[bytes, bytes]) into the environment at `path`,
    creating it if needed. Both backends MERGE into existing contents
    (lmdb txn.put semantics); the pure-Python codec reads the existing
    entries before it rebuilds the file."""
    try:
        import lmdb
        env = lmdb.open(path, map_size=1 << 34)
        with env.begin(write=True) as txn:
            for k, v in items.items():
                txn.put(k, v)
        env.sync()
        env.close()
    except ImportError:
        from fabind_tpu_torch.data import mdb
        env = mdb.Env(path, readonly=False)
        with env.begin(write=True) as txn:
            for k, v in items.items():
                txn.put(k, v)
        env.close()
