"""Pure-Python LMDB file-format codec (read and write, one main DB).

Own copy of fabind_tpu/data/mdb.py. The reference's preprocessed PDBbind
store keeps its features in LMDB environments (FABind/fabind/data.py:22-25).
The `lmdb` C binding is optional: this module reads and writes enough of
the on-disk format (liblmdb 0.9, MDB_DATA_VERSION=1) for real `data.mdb`
files without it. `data.kv` prefers the C binding when it imports and falls
back here.

Format notes (liblmdb mdb.c):
- 4096-byte pages; pages 0/1 are meta pages (magic 0xBEEFC0DE, version 1);
  the valid meta with the larger txnid wins.
- The page size lives in meta.mm_dbs[FREE].md_pad, env flags in
  mm_dbs[FREE].md_flags.
- Leaf/branch pages: 16-byte header, uint16 node-offset array sorted by key
  (memcmp order), nodes packed downward from the page end. Node header:
  mn_lo, mn_hi (leaf: data size; branch: child pgno), mn_flags, mn_ksize.
- Large values use F_BIGDATA nodes whose 8-byte payload is the first
  overflow page number; overflow data is contiguous after that page's
  header.

Writer restrictions: a commit rebuilds the whole environment, holding the
merged store in memory once (a store larger than memory needs the C
binding); no dupsort/LEAF2; no free-list persistence (freshly built files
have none anyway).
"""
from __future__ import annotations

import builtins
import os
import struct
from typing import Dict, Iterator, List, Optional, Tuple

PAGESIZE = 4096
PAGEHDRSZ = 16
NODESZ = 8
MAGIC = 0xBEEFC0DE
VERSION = 1
P_INVALID = 0xFFFFFFFFFFFFFFFF

P_BRANCH = 0x01
P_LEAF = 0x02
P_OVERFLOW = 0x04
P_META = 0x08

F_BIGDATA = 0x01

# value size above which the writer spills to overflow pages; liblmdb uses
# me_nodemax = (pagesize - PAGEHDRSZ) / MDB_MINKEYS & -2 = 2040 for 4K pages
NODEMAX = 2040


def _even(x: int) -> int:
    return (x + 1) & ~1


class _Page:
    __slots__ = ("pgno", "flags", "data")

    def __init__(self, pgno: int, flags: int, data: bytes):
        self.pgno = pgno
        self.flags = flags
        self.data = data


def _pack_node_page(pgno: int, flags: int,
                    nodes: List[bytes]) -> bytes:
    """Assemble a leaf/branch page from pre-packed node byte strings (in key
    order)."""
    n = len(nodes)
    lower = PAGEHDRSZ + 2 * n
    page = bytearray(PAGESIZE)
    ofs = PAGESIZE
    ptrs = []
    for nb in nodes:
        size = _even(len(nb))
        ofs -= size
        page[ofs:ofs + len(nb)] = nb
        ptrs.append(ofs)
    assert ofs >= lower, "page overflow"
    struct.pack_into("<Q", page, 0, pgno)
    struct.pack_into("<HH", page, 8, 0, flags)
    struct.pack_into("<HH", page, 12, lower, ofs)
    for i, p in enumerate(ptrs):
        struct.pack_into("<H", page, PAGEHDRSZ + 2 * i, p)
    return bytes(page)


def _leaf_node(key: bytes, value: bytes,
               ov_pgno: Optional[int]) -> bytes:
    if ov_pgno is None:
        dsz = len(value)
        return (struct.pack("<HHHH", dsz & 0xFFFF, dsz >> 16, 0, len(key))
                + key + value)
    dsz = len(value)
    return (struct.pack("<HHHH", dsz & 0xFFFF, dsz >> 16, F_BIGDATA,
                        len(key)) + key + struct.pack("<Q", ov_pgno))


def _branch_node(key: bytes, child_pgno: int) -> bytes:
    lo = child_pgno & 0xFFFF
    hi = (child_pgno >> 16) & 0xFFFF
    fl = (child_pgno >> 32) & 0xFFFF
    return struct.pack("<HHHH", lo, hi, fl, len(key)) + key


def _node_room(nb: bytes) -> int:
    return _even(len(nb)) + 2  # node bytes + ptr slot


def write_env(path: str, items: Dict[bytes, bytes],
              map_size: Optional[int] = None,
              data_file: Optional[str] = None) -> None:
    """Write a fresh LMDB environment holding `items` in the main DB.

    `path` is the environment directory (data.mdb inside) unless
    `data_file` overrides the target file (subdir=False style envs).

    Streams to disk page-by-page in pgno order (metas, overflow chains,
    leaves, branches are laid out ascending) — peak extra memory is the
    leaf/branch node metadata plus one value, NOT the whole file; values
    themselves are only referenced from `items`."""
    os.makedirs(path, exist_ok=True)
    target = data_file or os.path.join(path, "data.mdb")
    kv = sorted(items.items())
    next_pg = 2

    # pass 1: plan overflow chains + leaf nodes (no page buffers yet)
    n_overflow = 0
    overflows: List[Tuple[int, int, bytes]] = []   # (pgno, npages, value)
    leaf_nodes: List[Tuple[bytes, bytes]] = []     # (key, packed node)
    for k, v in kv:
        if len(k) > 511:
            raise ValueError(f"key too long for LMDB default: {len(k)}")
        if NODESZ + len(k) + len(v) > NODEMAX:
            npg = (PAGEHDRSZ + len(v) + PAGESIZE - 1) // PAGESIZE
            overflows.append((next_pg, npg, v))
            leaf_nodes.append((k, _leaf_node(k, v, next_pg)))
            next_pg += npg
            n_overflow += npg
        else:
            leaf_nodes.append((k, _leaf_node(k, v, None)))

    # pass 2: pack leaves then branch levels (small page buffers only)
    capacity = PAGESIZE - PAGEHDRSZ
    pages: List[_Page] = []

    def alloc(flags: int, nodes: List[bytes]) -> int:
        nonlocal next_pg
        pg = next_pg
        pages.append(_Page(pg, flags, _pack_node_page(pg, flags, nodes)))
        next_pg += 1
        return pg

    leaves: List[Tuple[bytes, int]] = []   # (first key, pgno)
    cur: List[bytes] = []
    cur_keys: List[bytes] = []
    cur_room = 0
    for k, nb in leaf_nodes:
        if cur and cur_room + _node_room(nb) > capacity:
            leaves.append((cur_keys[0], alloc(P_LEAF, cur)))
            cur, cur_keys, cur_room = [], [], 0
        cur.append(nb)
        cur_keys.append(k)
        cur_room += _node_room(nb)
    if cur or not leaves:
        leaves.append((cur_keys[0] if cur_keys else b"",
                       alloc(P_LEAF, cur)))
    n_leaf = len(leaves)

    depth = 1
    n_branch = 0
    level = leaves
    while len(level) > 1:
        nxt: List[Tuple[bytes, int]] = []
        i = 0
        while i < len(level):
            group: List[bytes] = []
            gkeys: List[bytes] = []
            room = 0
            while i < len(level):
                fk, cpg = level[i]
                nb = _branch_node(fk, cpg)
                if group and room + _node_room(nb) > capacity:
                    break
                group.append(nb)
                gkeys.append(fk)
                room += _node_room(nb)
                i += 1
            n_branch += 1
            nxt.append((gkeys[0], alloc(P_BRANCH, group)))
        level = nxt
        depth += 1

    root = level[0][1] if kv else P_INVALID
    if not kv:
        depth = 0
        n_leaf = 0
        pages.clear()
        next_pg = 2

    last_pg = next_pg - 1
    fsize = next_pg * PAGESIZE
    if map_size is None:
        map_size = max(1 << 20, ((fsize + PAGESIZE - 1) // PAGESIZE)
                       * PAGESIZE)

    def db_rec(pad, flags, dep, branch, leaf, overflow, entries, rt):
        return struct.pack("<IHHQQQQQ", pad, flags, dep, branch, leaf,
                           overflow, entries, rt)

    def meta_page(pgno: int, txnid: int) -> bytes:
        page = bytearray(PAGESIZE)
        struct.pack_into("<Q", page, 0, pgno)
        struct.pack_into("<HH", page, 8, 0, P_META)
        body = struct.pack("<IIQQ", MAGIC, VERSION, 0, map_size)
        body += db_rec(PAGESIZE, 0, 0, 0, 0, 0, 0, P_INVALID)   # FREE db
        body += db_rec(0, 0, depth, n_branch, n_leaf, n_overflow,
                       len(kv), root)                            # MAIN db
        body += struct.pack("<QQ", last_pg, txnid)
        page[PAGEHDRSZ:PAGEHDRSZ + len(body)] = body
        return bytes(page)

    # pass 3: stream everything in ascending pgno order
    tmp = target + ".tmp"
    with builtins.open(tmp, "wb") as f:
        f.write(meta_page(0, 1))
        f.write(meta_page(1, 1))
        write_order = sorted(
            [(_pg, ("ov", npg, v)) for _pg, npg, v in overflows]
            + [(p.pgno, ("node", p.data)) for p in pages])
        hdr = bytearray(PAGEHDRSZ)
        for pg, item in write_order:
            if item[0] == "ov":
                _, npg, v = item
                hdr[:] = bytes(PAGEHDRSZ)
                struct.pack_into("<Q", hdr, 0, pg)
                struct.pack_into("<HHI", hdr, 8, 0, P_OVERFLOW, npg)
                f.write(hdr)
                f.write(v)
                pad = npg * PAGESIZE - PAGEHDRSZ - len(v)
                f.write(bytes(pad))
            else:
                f.write(item[1])
        assert f.tell() == fsize, (f.tell(), fsize)
    os.replace(tmp, target)


class _Txn:
    def __init__(self, env: "Env"):
        self._env = env

    def get(self, key: bytes) -> Optional[bytes]:
        return self._env._get(key)

    def cursor(self) -> Iterator[Tuple[bytes, bytes]]:
        return self._env._iter()

    def put(self, key: bytes, value: bytes) -> bool:
        self._env._put(key, value)
        return True

    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


class Env:
    """Read/write handle over an LMDB environment directory.

    API subset of `lmdb.Environment`: begin(write=...) as a context manager
    with txn.get / txn.put / txn.cursor, plus stat()/close(). Writes are
    buffered and the whole file is rebuilt on sync/close."""

    def __init__(self, path: str, readonly: bool = True,
                 map_size: int = 0, subdir: bool = True, **_ignored):
        self.path = path
        self.readonly = readonly
        self._pending: Optional[Dict[bytes, bytes]] = None
        self._dirty = False
        self._mmap = None
        data = os.path.join(path, "data.mdb")
        # subdir=False (lmdb.open parity): `path` IS the data file — also
        # honored for NEW files, where isfile() alone can't tell (writing a
        # path/data.mdb directory there would diverge from the format the
        # real binding expects)
        if os.path.isfile(path) or not subdir:
            data = path
            self.path = os.path.dirname(path)
        self._file = data          # sync() must rewrite THIS file
        if os.path.exists(data):
            self._load(data)
            self._parse_meta()
        elif readonly:
            raise FileNotFoundError(data)
        else:
            self._buf = b""
            self._root = P_INVALID
            self._entries = 0

    def _load(self, data: str) -> None:
        """Map the store instead of slurping it: the multi-GB protein/ESM2
        LMDBs would otherwise be copied into RAM once per open (3 stores
        open simultaneously in dataset.py) on hosts without the C lmdb
        binding. mmap supports the same slicing/unpack_from access."""
        if self._mmap is not None:
            self._mmap.close()
            self._mmap = None
        with builtins.open(data, "rb") as f:
            try:
                import mmap
                self._mmap = mmap.mmap(f.fileno(), 0,
                                       access=mmap.ACCESS_READ)
                self._buf = self._mmap
            except (ValueError, OSError):   # zero-length file
                self._buf = f.read()

    # -- metadata ----------------------------------------------------------
    def _parse_meta(self):
        best = None
        for mp in (0, 1):
            off = mp * PAGESIZE + PAGEHDRSZ
            magic, version = struct.unpack_from("<II", self._buf, off)
            if magic != MAGIC:
                continue
            # MAIN db record at +24(header)... layout: magic,version,
            # address(8), mapsize(8) = 24 bytes, FREE db 48, MAIN db 48
            main = off + 24 + 48
            (pad, flags, depth, nb, nl, no, entries,
             root) = struct.unpack_from("<IHHQQQQQ", self._buf, main)
            txnid = struct.unpack_from("<Q", self._buf, main + 48 + 8)[0]
            psize = struct.unpack_from("<I", self._buf, off + 24)[0]
            if psize != PAGESIZE:
                raise ValueError(f"unsupported LMDB page size {psize}")
            if best is None or txnid > best[0]:
                best = (txnid, root, entries)
        if best is None:
            raise ValueError(f"{self.path}: not an LMDB data file")
        self._root = best[1]
        self._entries = best[2]

    # -- page access -------------------------------------------------------
    def _page(self, pgno: int) -> Tuple[int, bytes]:
        off = pgno * PAGESIZE
        flags = struct.unpack_from("<H", self._buf, off + 10)[0]
        return flags, self._buf[off:off + PAGESIZE]

    def _nodes(self, page: bytes) -> List[int]:
        lower = struct.unpack_from("<H", page, 12)[0]
        n = (lower - PAGEHDRSZ) >> 1
        return [struct.unpack_from("<H", page, PAGEHDRSZ + 2 * i)[0]
                for i in range(n)]

    def _node(self, page: bytes, ofs: int):
        lo, hi, fl, ksz = struct.unpack_from("<HHHH", page, ofs)
        key = page[ofs + NODESZ:ofs + NODESZ + ksz]
        return lo, hi, fl, key, ofs + NODESZ + ksz

    def _leaf_value(self, pgno_page: bytes, ofs: int) -> bytes:
        lo, hi, fl, key, dofs = self._node(pgno_page, ofs)
        dsz = lo | (hi << 16)
        if fl & F_BIGDATA:
            ov = struct.unpack_from("<Q", pgno_page, dofs)[0]
            start = ov * PAGESIZE + PAGEHDRSZ
            return self._buf[start:start + dsz]
        return pgno_page[dofs:dofs + dsz]

    # -- lookups -----------------------------------------------------------
    def _get(self, key: bytes) -> Optional[bytes]:
        if self._pending is not None and key in self._pending:
            return self._pending[key]
        if not self._buf or self._root == P_INVALID:
            return None
        pgno = self._root
        while True:
            flags, page = self._page(pgno)
            ptrs = self._nodes(page)
            if flags & P_LEAF:
                for ofs in ptrs:
                    lo, hi, fl, k, _ = self._node(page, ofs)
                    if k == key:
                        return self._leaf_value(page, ofs)
                return None
            # branch: rightmost child whose separator key <= target
            # (node 0's key is ignored, liblmdb convention)
            child = None
            for i, ofs in enumerate(ptrs):
                lo, hi, fl, k, _ = self._node(page, ofs)
                cpg = lo | (hi << 16) | (fl << 32)
                if i == 0 or k <= key:
                    child = cpg
                else:
                    break
            pgno = child

    def _iter(self) -> Iterator[Tuple[bytes, bytes]]:
        if self._pending is not None:
            merged = dict(self._read_all())
            merged.update(self._pending)
            yield from sorted(merged.items())
            return
        yield from self._read_all()

    def _read_all(self) -> Iterator[Tuple[bytes, bytes]]:
        if not self._buf or self._root == P_INVALID:
            return
        stack = [self._root]
        out = []

        def walk(pgno):
            flags, page = self._page(pgno)
            ptrs = self._nodes(page)
            if flags & P_LEAF:
                for ofs in ptrs:
                    _, _, _, k, _ = self._node(page, ofs)
                    out.append((k, self._leaf_value(page, ofs)))
            else:
                for ofs in ptrs:
                    lo, hi, fl, _, _ = self._node(page, ofs)
                    walk(lo | (hi << 16) | (fl << 32))

        for pg in stack:
            walk(pg)
        yield from out

    # -- writes ------------------------------------------------------------
    def _put(self, key: bytes, value: bytes):
        if self.readonly:
            raise PermissionError("readonly environment")
        if self._pending is None:
            self._pending = {}
        self._pending[bytes(key)] = bytes(value)
        self._dirty = True

    def sync(self, force: bool = True):
        """Commit pending writes: whole-env rebuild (see module docstring;
        the pure-Python writer holds the merged store in memory once — use
        the C binding for stores larger than RAM)."""
        if not self._dirty:
            return
        merged = dict(self._read_all())
        merged.update(self._pending or {})
        if self._mmap is not None:   # unmap before rewriting the file
            self._mmap.close()
            self._mmap = None
            self._buf = b""
        write_env(self.path, merged, data_file=self._file)
        self._load(self._file)
        self._parse_meta()
        self._pending = None
        self._dirty = False

    # -- lmdb API subset ---------------------------------------------------
    def begin(self, write: bool = False, **_kw) -> _Txn:
        if write and self.readonly:
            raise PermissionError("readonly environment")
        return _Txn(self)

    def stat(self) -> Dict[str, int]:
        n = self._entries if self._pending is None else \
            len(dict(self._iter()))
        return {"entries": n, "psize": PAGESIZE}

    def close(self):
        if self._dirty:
            self.sync()
        if self._mmap is not None:
            self._mmap.close()
            self._mmap = None
            self._buf = b""
            self._root = P_INVALID

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()
        return False


def open(path: str, readonly: bool = True, **kw) -> Env:  # lmdb.open parity
    return Env(path, readonly=readonly, **kw)
