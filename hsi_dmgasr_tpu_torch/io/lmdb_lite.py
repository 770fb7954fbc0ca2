"""Dependency-free LMDB file reader/writer (the SR3 face-SR data path): a
copy of ``hsi_dmgasr_tpu/io/lmdb_lite.py``.

The reference's LRHR lmdb mode (data/LRHR_dataset.py:28-38, 68-102) and
its dataset builder (data/prepare_data.py:83-92) require the ``lmdb``
package. This module speaks the LMDB *file format* directly:

  * ``LmdbReader`` — mmap-based read-only access to a standard
    ``data.mdb``: picks the live meta page by txnid, walks the main
    B+tree (branch/leaf pages), and follows overflow pages for big
    values. Enough of the format for get()/items() on the main DB,
    which is all the datasets need.
  * ``LmdbWriter`` — builds a valid single-snapshot LMDB file from
    sorted key/value pairs (leaf pages packed bottom-up, one branch
    level per depth step, overflow pages for large values, twin meta
    pages). Used by data/prepare_data.py to CREATE lmdb datasets.

Format references: the canonical mdb.c layout — 16-byte page header
(pgno u64, pad u16, flags u16, lower/upper u16 pair or overflow page
count u32); 8-byte node header (value-size lo/hi u16, flags u16, ksize
u16); meta page = header + MDB_meta {magic 0xBEEFC0DE, version 1,
address, mapsize, dbs[2], last_pg, txnid} with the page size stowed in
dbs[0].md_pad. 64-bit little-endian fields throughout (the on-disk
layout of x86-64 LMDB, which is what py-lmdb writes).
"""

from __future__ import annotations

import mmap
import os
import struct

MAGIC = 0xBEEFC0DE
VERSION = 1

P_BRANCH = 0x01
P_LEAF = 0x02
P_OVERFLOW = 0x04
P_META = 0x08

F_BIGDATA = 0x01

PAGEHDRSZ = 16
NODEHDRSZ = 8
P_INVALID = 0xFFFFFFFFFFFFFFFF

# MDB_db: pad u32, flags u16, depth u16, branch/leaf/overflow pgno u64,
# entries u64, root u64  -> 48 bytes
_DB = struct.Struct("<IHHQQQQQ")
# MDB_meta prefix: magic u32, version u32, address u64, mapsize u64
_META_PRE = struct.Struct("<IIQQ")
_META_TAIL = struct.Struct("<QQ")  # last_pg, txnid


class LmdbReader:
    """Read-only main-DB access to an LMDB data file."""

    def __init__(self, path):
        # accept either the environment directory or the data file
        if os.path.isdir(path):
            path = os.path.join(path, "data.mdb")
        self._f = open(path, "rb")
        self._mm = mmap.mmap(self._f.fileno(), 0, access=mmap.ACCESS_READ)
        meta = max((self._meta(0), self._meta(1)), key=lambda m: m["txnid"])
        self.psize = meta["psize"]
        self._main = meta["main"]

    # ------------------------------------------------------------- pages

    def _meta(self, pgno):
        off = pgno * 4096  # meta pages are written before psize is known;
        # both live in the first OS page pair, and lmdb uses >= 4096
        flags = struct.unpack_from("<H", self._mm, off + 10)[0]
        if not flags & P_META:
            raise ValueError("not an LMDB file (meta page flag missing)")
        magic, version, _, _ = _META_PRE.unpack_from(self._mm, off + PAGEHDRSZ)
        if magic != MAGIC:
            raise ValueError("not an LMDB file (bad magic)")
        if version != VERSION:
            raise ValueError(f"unsupported LMDB data version {version}")
        dbs_off = off + PAGEHDRSZ + _META_PRE.size
        db0 = _DB.unpack_from(self._mm, dbs_off)
        db1 = _DB.unpack_from(self._mm, dbs_off + _DB.size)
        last_pg, txnid = _META_TAIL.unpack_from(
            self._mm, dbs_off + 2 * _DB.size
        )
        return {
            "psize": db0[0] or 4096,
            "txnid": txnid,
            "main": {"root": db1[7], "entries": db1[6], "depth": db1[2]},
        }

    def _page(self, pgno):
        off = pgno * self.psize
        flags, lower, upper = struct.unpack_from("<HHH", self._mm, off + 10)
        return off, flags, lower, upper

    def _nodes(self, pgno):
        off, flags, lower, upper = self._page(pgno)
        n = (lower - PAGEHDRSZ) // 2
        ptrs = struct.unpack_from(f"<{n}H", self._mm, off + PAGEHDRSZ)
        return off, flags, ptrs

    def _node(self, page_off, ptr):
        o = page_off + ptr
        lo, hi, flags, ksize = struct.unpack_from("<HHHH", self._mm, o)
        key = self._mm[o + NODEHDRSZ:o + NODEHDRSZ + ksize]
        return lo, hi, flags, ksize, key, o + NODEHDRSZ + ksize

    # -------------------------------------------------------------- API

    def __len__(self):
        return self._main["entries"]

    def _leaf_value(self, lo, hi, flags, data_off):
        size = lo | (hi << 16)
        if flags & F_BIGDATA:
            ovpg = struct.unpack_from("<Q", self._mm, data_off)[0]
            ov_off = ovpg * self.psize
            return bytes(
                self._mm[ov_off + PAGEHDRSZ:ov_off + PAGEHDRSZ + size]
            )
        return bytes(self._mm[data_off:data_off + size])

    def get(self, key):
        """Value bytes for key (bytes/str) in the main DB, or None."""
        if isinstance(key, str):
            key = key.encode("utf-8")
        pgno = self._main["root"]
        if pgno == P_INVALID:
            return None
        while True:
            off, flags, ptrs = self._nodes(pgno)
            if flags & P_BRANCH:
                # descend into the last child whose separator <= key
                # (the first branch key is implicit -inf)
                child = None
                for i, p in enumerate(ptrs):
                    lo, hi, nf, ksize, k, _ = self._node(off, p)
                    if i > 0 and k > key:
                        break
                    child = lo | (hi << 16) | (nf << 32)
                pgno = child
            elif flags & P_LEAF:
                for p in ptrs:
                    lo, hi, nf, ksize, k, data_off = self._node(off, p)
                    if k == key:
                        return self._leaf_value(lo, hi, nf, data_off)
                return None
            else:
                raise ValueError(f"unexpected page flags {flags:#x}")

    def items(self):
        """Iterate (key, value) over the main DB in key order."""
        root = self._main["root"]
        if root == P_INVALID:
            return
        stack = [root]
        while stack:
            pgno = stack.pop()
            off, flags, ptrs = self._nodes(pgno)
            if flags & P_BRANCH:
                for p in reversed(ptrs):
                    lo, hi, nf, _, _, _ = self._node(off, p)
                    stack.append(lo | (hi << 16) | (nf << 32))
            else:
                for p in ptrs:
                    lo, hi, nf, ksize, k, data_off = self._node(off, p)
                    yield bytes(k), self._leaf_value(lo, hi, nf, data_off)

    def keys(self):
        return (k for k, _ in self.items())

    def close(self):
        self._mm.close()
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


class LmdbWriter:
    """Build a single-snapshot LMDB file from key/value pairs.

    Not a general transactional writer — it lays out the whole B+tree
    in one pass, which is exactly what a dataset builder needs.
    """

    def __init__(self, path, psize=4096):
        # mirror lmdb.open(dir) layout: <dir>/data.mdb
        if not os.path.splitext(path)[1]:
            os.makedirs(path, exist_ok=True)
            path = os.path.join(path, "data.mdb")
        self.path = path
        self.psize = psize
        self._kv = {}

    def put(self, key, value):
        if isinstance(key, str):
            key = key.encode("utf-8")
        if isinstance(value, str):
            value = value.encode("utf-8")
        self._kv[key] = bytes(value)

    # ------------------------------------------------------------ layout

    def _node_bytes(self, key, value, overflow_pgno=None):
        size = len(value)
        if overflow_pgno is not None:
            hdr = struct.pack("<HHHH", size & 0xFFFF, size >> 16,
                              F_BIGDATA, len(key))
            body = key + struct.pack("<Q", overflow_pgno)
        else:
            hdr = struct.pack("<HHHH", size & 0xFFFF, size >> 16,
                              0, len(key))
            body = key + value
        node = hdr + body
        return node + b"\x00" * (len(node) & 1)  # 2-byte alignment

    def _branch_node(self, key, child_pgno):
        hdr = struct.pack("<HHHH", child_pgno & 0xFFFF,
                          (child_pgno >> 16) & 0xFFFF,
                          (child_pgno >> 32) & 0xFFFF, len(key))
        node = hdr + key
        return node + b"\x00" * (len(node) & 1)

    def _pack_page(self, pgno, flags, nodes):
        ptrs, upper = [], self.psize
        for node in reversed(nodes):
            upper -= len(node)
            ptrs.append(upper)
        ptrs.reverse()
        lower = PAGEHDRSZ + 2 * len(nodes)
        assert lower <= upper, "page overflow"
        page = bytearray(self.psize)
        struct.pack_into("<QHHHH", page, 0, pgno, 0, flags, lower, upper)
        struct.pack_into(f"<{len(nodes)}H", page, PAGEHDRSZ, *ptrs)
        for node, p in zip(nodes, ptrs):
            page[p:p + len(node)] = node
        return bytes(page)

    def _overflow_pages(self, pgno, value):
        npages = -(-(PAGEHDRSZ + len(value)) // self.psize)
        buf = bytearray(npages * self.psize)
        struct.pack_into("<QHHI", buf, 0, pgno, 0, P_OVERFLOW, npages)
        buf[PAGEHDRSZ:PAGEHDRSZ + len(value)] = value
        return bytes(buf), npages

    def close(self):
        psize = self.psize
        space = psize - PAGEHDRSZ
        max_inline = space // 2 - NODEHDRSZ  # conservative inline cap
        items = sorted(self._kv.items())

        pages = {}          # pgno -> bytes (may span multiple for ovf)
        next_pg = 2         # 0, 1 are meta
        n_overflow = 0

        # ---- overflow values first (assign pages), then leaves
        staged = []
        for k, v in items:
            if NODEHDRSZ + len(k) + len(v) > max_inline:
                ov, npg = self._overflow_pages(next_pg, v)
                pages[next_pg] = ov
                staged.append((k, v, next_pg))
                next_pg += npg
                n_overflow += npg
            else:
                staged.append((k, v, None))

        # ---- pack leaves
        leaves = []         # (first_key, pgno)
        cur_nodes, cur_first, cur_used = [], None, 0
        def flush_leaf():
            nonlocal cur_nodes, cur_first, cur_used, next_pg
            if cur_nodes:
                pages[next_pg] = self._pack_page(next_pg, P_LEAF, cur_nodes)
                leaves.append((cur_first, next_pg))
                next_pg += 1
                cur_nodes, cur_first, cur_used = [], None, 0

        for k, v, ovpg in staged:
            node = self._node_bytes(k, v, ovpg)
            if cur_nodes and cur_used + len(node) + 2 > space:
                flush_leaf()
            if not cur_nodes:
                cur_first = k
            cur_nodes.append(node)
            cur_used += len(node) + 2
        flush_leaf()

        # ---- branch levels
        level = leaves
        depth = 1
        n_branch = 0
        while len(level) > 1:
            nxt = []
            cur_nodes, cur_first, cur_used = [], None, 0

            def flush_branch():
                nonlocal cur_nodes, cur_first, cur_used, next_pg, n_branch
                if cur_nodes:
                    pages[next_pg] = self._pack_page(
                        next_pg, P_BRANCH, cur_nodes
                    )
                    nxt.append((cur_first, next_pg))
                    next_pg += 1
                    n_branch += 1
                    cur_nodes, cur_first, cur_used = [], None, 0

            for first_key, child in level:
                # the first separator of every branch page is implicit
                # -inf (empty key), as in mdb.c
                key = b"" if not cur_nodes else first_key
                node = self._branch_node(key, child)
                if cur_nodes and cur_used + len(node) + 2 > space:
                    flush_branch()
                    node = self._branch_node(b"", child)
                if not cur_nodes:
                    cur_first = first_key
                cur_nodes.append(node)
                cur_used += len(node) + 2
            flush_branch()
            level = nxt
            depth += 1

        root = level[0][1] if level else P_INVALID
        last_pg = next_pg - 1
        n_leaf = len(leaves)

        # ---- meta pages
        def meta_page(pgno, txnid):
            page = bytearray(psize)
            struct.pack_into("<QHHHH", page, 0, pgno, 0, P_META, 0, 0)
            _META_PRE.pack_into(page, PAGEHDRSZ, MAGIC, VERSION, 0,
                                max((last_pg + 1) * psize, 1 << 20))
            dbs_off = PAGEHDRSZ + _META_PRE.size
            _DB.pack_into(page, dbs_off, psize, 0, 0, 0, 0, 0, 0,
                          P_INVALID)  # FREE_DBI (psize in md_pad)
            _DB.pack_into(page, dbs_off + _DB.size, 0, 0,
                          depth if root != P_INVALID else 0,
                          n_branch, n_leaf, n_overflow,
                          len(items), root)
            _META_TAIL.pack_into(page, dbs_off + 2 * _DB.size,
                                 last_pg, txnid)
            return bytes(page)

        with open(self.path, "wb") as f:
            f.write(meta_page(0, 1))
            f.write(meta_page(1, 2))
            for pgno in sorted(pages):
                f.write(pages[pgno])

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()
