"""A read-only reader of the subset of HDF5 that Keras model files use.

It takes the role h5py plays in the JAX package's importer
(deeplearning4j_tpu/modelimport/keras.py `_read_archive`), so the port
imports Keras files where h5py is absent. The surface is h5py's:
`File(path)`, groups as mappings of names to groups and datasets,
`.attrs` on each, and datasets read as numpy arrays.

The subset (HDF5 file format specification, version 3.0, sections II-IV):
- superblock version 0, any size of offsets and lengths;
- version 1 object headers, with continuation messages (0x0010);
- groups stored as a symbol table (0x0011): a version 1 B-tree of group
  nodes ("TREE") over symbol table nodes ("SNOD"), names in a local heap
  ("HEAP");
- the dataspace (0x0001), datatype (0x0003), data layout (0x0008,
  version 3) and attribute (0x000C, version 1) messages;
- datatypes: fixed-point and IEEE floating-point numbers, fixed-length
  strings, and variable-length strings held in the global heap ("GCOL");
- contiguous, uncompressed datasets. One is read with one `np.fromfile`
  at its offset.

Anything else (a chunked, compact or compressed layout, version 2 object
headers, superblock versions 1-3, shared messages, new-style groups, soft
links, compound or other datatypes) raises a KerasImportError that names
what was found. The reader never guesses.
"""

from __future__ import annotations

import mmap
import os
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

SIGNATURE = b"\x89HDF\r\n\x1a\n"

# object header message types
MSG_DATASPACE = 0x0001
MSG_LINK_INFO = 0x0002
MSG_DATATYPE = 0x0003
MSG_LINK = 0x0006
MSG_LAYOUT = 0x0008
MSG_FILTERS = 0x000B
MSG_ATTRIBUTE = 0x000C
MSG_CONTINUATION = 0x0010
MSG_SYMBOL_TABLE = 0x0011
MSG_ATTRIBUTE_INFO = 0x0015
# messages a new-style (link-based) group carries
_NEW_STYLE_GROUP = {MSG_LINK_INFO: "link info", MSG_LINK: "link",
                    MSG_ATTRIBUTE_INFO: "attribute info (dense attributes)"}

# datatype classes
DT_FIXED, DT_FLOAT, DT_STRING, DT_VLEN = 0, 1, 3, 9
_DT_NAMES = {0: "fixed-point", 1: "floating-point", 2: "time", 3: "string",
             4: "bitfield", 5: "opaque", 6: "compound", 7: "reference",
             8: "enumerated", 9: "variable-length", 10: "array"}
# IEEE layouts: size -> (exponent location, exponent size, mantissa
# location, mantissa size, exponent bias)
_IEEE = {2: (10, 5, 0, 10, 15), 4: (23, 8, 0, 23, 127),
         8: (52, 11, 0, 52, 1023)}


class KerasImportError(ValueError):
    """Unsupported or malformed Keras model file (ref:
    InvalidKerasConfigurationException /
    UnsupportedKerasConfigurationException)."""


def _unsupported(path: str, what: str) -> KerasImportError:
    return KerasImportError(
        f"{path}: {what} is outside the HDF5 subset this reader supports "
        "(superblock v0, v1 object headers, symbol-table groups, contiguous "
        "datasets of numbers or strings)")


class _VlenString:
    """The datatype of a variable-length string: each element is a
    (length, global heap collection, object index) triple."""

    def __init__(self, size: int, encoding: str):
        self.itemsize = size
        self.encoding = encoding


class _Reader:
    """The open file: its superblock's sizes, a read-only map of it for
    the metadata, and the global heap collections read so far."""

    def __init__(self, path: str):
        self.path = os.fspath(path)
        self._fh = open(self.path, "rb")
        try:
            self._map = mmap.mmap(self._fh.fileno(), 0,
                                  access=mmap.ACCESS_READ)
        except ValueError:     # an empty file cannot be mapped
            self._fh.close()
            raise KerasImportError(f"{self.path}: empty file, not HDF5")
        self._heaps: Dict[int, Dict[int, bytes]] = {}
        self.root_address = self._superblock()

    def close(self):
        if self._map is not None:
            self._map.close()
            self._fh.close()
            self._map = None

    # ------------------------------------------------------------ raw reads
    def bytes(self, addr: int, n: int) -> bytes:
        if addr < 0 or addr + n > len(self._map):
            raise KerasImportError(
                f"{self.path}: a structure at {addr}+{n} lies past the end "
                f"of the file ({len(self._map)} bytes): truncated?")
        return self._map[addr:addr + n]

    def uint(self, addr: int, n: int) -> int:
        return int.from_bytes(self.bytes(addr, n), "little")

    def undefined(self, addr: int, n: int) -> bool:
        return self.bytes(addr, n) == b"\xff" * n

    def cstring(self, addr: int) -> str:
        end = self._map.find(b"\0", addr)
        if end < 0:
            raise KerasImportError(f"{self.path}: unterminated name at {addr}")
        return self._map[addr:end].decode("utf-8")

    # ----------------------------------------------------------- superblock
    def _superblock(self) -> int:
        """Find the signature (at 0 or a power of two from 512 on, past a
        user block), read superblock v0 and return the root group's object
        header address."""
        base = 0
        while self._map[base:base + 8] != SIGNATURE:
            base = 512 if base == 0 else base * 2
            if base + 8 > len(self._map):
                raise KerasImportError(f"{self.path}: not an HDF5 file (no "
                                       "format signature)")
        version = self._map[base + 8]
        if version != 0:
            raise _unsupported(self.path, f"superblock version {version}")
        self.so, self.sl = self._map[base + 13], self._map[base + 14]
        if self.so not in (2, 4, 8) or self.sl not in (2, 4, 8):
            raise KerasImportError(
                f"{self.path}: size of offsets {self.so} / lengths "
                f"{self.sl} is not 2, 4 or 8")
        self.leaf_k = self.uint(base + 16, 2)
        self.internal_k = self.uint(base + 18, 2)
        if not self.leaf_k or not self.internal_k:
            raise KerasImportError(f"{self.path}: group K of 0 in the "
                                   "superblock")
        p = base + 24
        self.base = self.uint(p, self.so)
        root_entry = p + 4 * self.so
        _, header, _ = self._symbol_entry(root_entry)
        return header

    def addr(self, rel: int) -> int:
        return self.base + rel

    def _symbol_entry(self, p: int) -> Tuple[int, int, int]:
        """A symbol table entry: (name offset in the local heap, object
        header address, cache type)."""
        name = self.uint(p, self.so)
        header = self.addr(self.uint(p + self.so, self.so))
        cache = self.uint(p + 2 * self.so, 4)
        return name, header, cache

    # -------------------------------------------------------- object header
    def messages(self, addr: int) -> List[Tuple[int, int, int]]:
        """The (type, data address, size) of every message of the version 1
        object header at `addr`, continuation blocks followed."""
        head = self.bytes(addr, 4)
        if head == b"OHDR":
            raise _unsupported(self.path, f"a version 2 object header at "
                               f"{addr}")
        if head[0] != 1:
            raise _unsupported(self.path, f"object header version {head[0]} "
                               f"at {addr}")
        count = self.uint(addr + 2, 2)
        blocks = [(addr + 16, self.uint(addr + 8, 4))]
        out = []
        while blocks:
            p, size = blocks.pop(0)
            end = p + size
            while p + 8 <= end and len(out) < count:
                mtype, msize = self.uint(p, 2), self.uint(p + 2, 2)
                flags = self._map[p + 4]
                data = p + 8
                if data + msize > end:
                    raise KerasImportError(
                        f"{self.path}: header message at {p} overruns its "
                        "block")
                if flags & 0x02:
                    raise _unsupported(self.path, f"a shared message (type "
                                       f"0x{mtype:04x}) at {p}")
                if mtype == MSG_CONTINUATION:
                    blocks.append((self.addr(self.uint(data, self.so)),
                                   self.uint(data + self.so, self.sl)))
                out.append((mtype, data, msize))
                p = data + msize
        return out

    # ------------------------------------------------------------ datatypes
    def datatype(self, p: int):
        """The datatype message at `p`: a numpy dtype, or _VlenString."""
        cls, version = self._map[p] & 0x0F, self._map[p] >> 4
        bits = self.uint(p + 1, 3)
        size = self.uint(p + 4, 4)
        if version not in (1, 2, 3):
            raise _unsupported(self.path, f"datatype version {version}")
        order = ">" if bits & 1 else "<"
        if cls == DT_FIXED:
            precision = self.uint(p + 10, 2)
            if size not in (1, 2, 4, 8) or precision != 8 * size \
                    or self.uint(p + 8, 2):
                raise _unsupported(self.path, f"a {precision}-bit integer "
                                   f"in {size} bytes")
            kind = "i" if bits & 0x08 else "u"
            return np.dtype(f"{order}{kind}{size}")
        if cls == DT_FLOAT:
            layout = (self._map[p + 12], self._map[p + 13], self._map[p + 14],
                      self._map[p + 15], self.uint(p + 16, 4))
            if bits & 0x40 or _IEEE.get(size) != layout \
                    or self.uint(p + 10, 2) != 8 * size:
                raise _unsupported(self.path, f"a non-IEEE {size}-byte "
                                   f"float {layout}")
            return np.dtype(f"{order}f{size}")
        if cls == DT_STRING:
            return np.dtype(f"S{size}")
        if cls == DT_VLEN:
            if bits & 0x0F != 1:
                raise _unsupported(self.path, "a variable-length sequence "
                                   "(not a string)")
            charset = (bits >> 8) & 0x0F
            return _VlenString(size, "utf-8" if charset else "ascii")
        raise _unsupported(self.path, f"the {_DT_NAMES.get(cls, cls)} "
                           "datatype")

    # ----------------------------------------------------------- dataspace
    def dataspace(self, p: int) -> Tuple[int, ...]:
        """The shape of the dataspace message at `p` (() for a scalar)."""
        version, rank, flags = self._map[p], self._map[p + 1], self._map[p + 2]
        if version == 1:
            q = p + 8
        elif version == 2:
            if self._map[p + 3] == 2:
                raise _unsupported(self.path, "a null dataspace")
            q = p + 4
        else:
            raise _unsupported(self.path, f"dataspace version {version}")
        if version == 1 and flags & 2:
            raise _unsupported(self.path, "a permuted dataspace")
        return tuple(self.uint(q + i * self.sl, self.sl) for i in range(rank))

    # ----------------------------------------------------------- values
    def global_object(self, collection: int, index: int) -> bytes:
        heap = self._heaps.get(collection)
        if heap is None:
            heap = self._heaps[collection] = self._collection(collection)
        if index not in heap:
            raise KerasImportError(f"{self.path}: global heap object "
                                   f"{index} missing at {collection}")
        return heap[index]

    def _collection(self, addr: int) -> Dict[int, bytes]:
        if self.bytes(addr, 4) != b"GCOL":
            raise KerasImportError(f"{self.path}: no global heap at {addr}")
        size = self.uint(addr + 8, self.sl)
        p, end, out = addr + 8 + self.sl, addr + size, {}
        while p + 8 + self.sl <= end:
            index = self.uint(p, 2)
            if index == 0:          # free space: the rest of the collection
                break
            n = self.uint(p + 8, self.sl)
            data = p + 8 + self.sl
            out[index] = self.bytes(data, n)
            p = data + (n + 7) // 8 * 8
        return out

    def values(self, dtype, shape, raw: bytes, decode: bool = True):
        """Decode an attribute's or a string dataset's elements: a numpy
        scalar or array (bytes for fixed-length strings), or, for
        variable-length strings, str / an object array of str (`decode`,
        as h5py reads attributes) or of bytes (as it reads datasets)."""
        if isinstance(dtype, _VlenString):
            items = []
            for i in range(int(np.prod(shape, dtype=np.int64))):
                q = i * dtype.itemsize
                n = int.from_bytes(raw[q:q + 4], "little")
                coll = self.addr(int.from_bytes(raw[q + 4:q + 4 + self.so],
                                                "little"))
                idx = int.from_bytes(raw[q + 4 + self.so:q + 8 + self.so],
                                     "little")
                b = self.global_object(coll, idx)[:n] if n else b""
                items.append(b.decode(dtype.encoding) if decode else b)
            if not shape:
                return items[0]
            arr = np.empty(len(items), object)
            arr[:] = items
            return arr.reshape(shape)
        arr = np.frombuffer(raw, dtype, count=int(np.prod(shape,
                                                          dtype=np.int64)))
        arr = arr.reshape(shape).copy()
        return arr[()] if not shape else arr

    def attributes(self, header: int) -> Dict[str, object]:
        """The attributes of the object at `header`, in name order (as
        h5py lists them)."""
        out = {}
        for mtype, p, size in self.messages(header):
            if mtype == MSG_ATTRIBUTE:
                name, value = self._attribute(p)
                out[name] = value
            elif mtype in _NEW_STYLE_GROUP:
                raise _unsupported(self.path, f"a {_NEW_STYLE_GROUP[mtype]} "
                                   f"message at {p}")
        return dict(sorted(out.items()))

    def _attribute(self, p: int):
        version = self._map[p]
        if version != 1:
            raise _unsupported(self.path, f"attribute message version "
                               f"{version}")
        pad = lambda n: (n + 7) // 8 * 8
        name_len, dt_len, ds_len = (self.uint(p + 2, 2), self.uint(p + 4, 2),
                                    self.uint(p + 6, 2))
        q = p + 8
        name = self.bytes(q, name_len).rstrip(b"\0").decode("utf-8")
        q += pad(name_len)
        dtype = self.datatype(q)
        q += pad(dt_len)
        shape = self.dataspace(q)
        q += pad(ds_len)
        n = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
        return name, self.values(dtype, shape, self.bytes(q, n))


class AttributeManager:
    """`obj.attrs`: the attributes of one object, read when first asked
    for, as a read-only mapping."""

    def __init__(self, reader: _Reader, header: int):
        self._reader = reader
        self._header = header
        self._cache: Optional[Dict[str, object]] = None

    def _all(self) -> Dict[str, object]:
        if self._cache is None:
            self._cache = self._reader.attributes(self._header)
        return self._cache

    def __getitem__(self, name):
        return self._all()[name]

    def get(self, name, default=None):
        return self._all().get(name, default)

    def __contains__(self, name):
        return name in self._all()

    def __iter__(self):
        return iter(self._all())

    def __len__(self):
        return len(self._all())

    def keys(self):
        return self._all().keys()

    def items(self):
        return self._all().items()

    def values(self):
        return self._all().values()


class _Object:
    def __init__(self, reader: _Reader, header: int, name: str):
        self._reader = reader
        self._header = header
        self.name = name
        self.attrs = AttributeManager(reader, header)

    def __bool__(self):            # as h5py's: an open object is true
        return True


class Dataset(_Object):
    """A contiguous dataset; `np.asarray(ds)`, `ds[()]` or `ds[...]` read
    it (one `np.fromfile` at its offset)."""

    def __init__(self, reader, header, name, msgs):
        super().__init__(reader, header, name)
        layout = None
        for mtype, p, size in msgs:
            if mtype == MSG_DATASPACE:
                self.shape = reader.dataspace(p)
            elif mtype == MSG_DATATYPE:
                self._dtype = reader.datatype(p)
            elif mtype == MSG_LAYOUT:
                layout = p
            elif mtype == MSG_FILTERS:
                raise _unsupported(reader.path, f"a filter pipeline "
                                   f"(compression) on dataset {name}")
        version, cls = reader._map[layout], reader._map[layout + 1]
        if version != 3:
            raise _unsupported(reader.path, f"data layout version {version} "
                               f"of dataset {name}")
        if cls != 1:
            kind = {0: "compact", 2: "chunked", 3: "virtual"}.get(cls, cls)
            raise _unsupported(reader.path, f"the {kind} layout of dataset "
                               f"{name}")
        self._offset = (None if reader.undefined(layout + 2, reader.so)
                        else reader.addr(reader.uint(layout + 2, reader.so)))
        self._nbytes = reader.uint(layout + 2 + reader.so, reader.sl)

    @property
    def dtype(self):
        return (np.dtype(object) if isinstance(self._dtype, _VlenString)
                else self._dtype)

    @property
    def size(self) -> int:
        return int(np.prod(self.shape, dtype=np.int64))

    def read(self) -> np.ndarray:
        r, n = self._reader, self.size * self._dtype.itemsize
        if n == 0:
            return np.zeros(self.shape, self.dtype)
        if self._offset is None:
            raise KerasImportError(f"{r.path}: dataset {self.name} has no "
                                   "storage allocated (never written)")
        if self._nbytes != n:
            raise KerasImportError(
                f"{r.path}: dataset {self.name} stores {self._nbytes} bytes "
                f"where shape {self.shape} x {self._dtype.itemsize} needs {n}")
        if isinstance(self._dtype, _VlenString):
            return np.asarray(r.values(self._dtype, self.shape,
                                       r.bytes(self._offset, n), False),
                              object)
        if self._offset + n > os.path.getsize(r.path):
            raise KerasImportError(f"{r.path}: dataset {self.name} lies past "
                                   "the end of the file: truncated?")
        return np.fromfile(r.path, self._dtype, count=self.size,
                           offset=self._offset).reshape(self.shape)

    def __getitem__(self, key):
        return self.read()[key]

    def __array__(self, dtype=None, copy=None):
        a = self.read()
        return a if dtype is None else a.astype(dtype, copy=False)

    def __repr__(self):
        return f"<Dataset {self.name!r}: shape {self.shape}, {self.dtype}>"


class Group(_Object):
    """A symbol-table group: a mapping of member names (in name order, as
    the B-tree stores them) to Groups and Datasets. Paths with "/" reach
    into subgroups; a leading "/" starts at the file's root."""

    def __init__(self, reader, header, name, table: Tuple[int, int], root):
        super().__init__(reader, header, name)
        self._table = table
        self._root = root or self
        self._members: Optional[Dict[str, int]] = None

    def _links(self) -> Dict[str, int]:
        if self._members is None:
            r = self._reader
            btree, heap = self._table
            if r.bytes(heap, 4) != b"HEAP":
                raise KerasImportError(f"{r.path}: no local heap at {heap} "
                                       f"for group {self.name}")
            names_at = r.addr(r.uint(heap + 8 + 2 * r.sl, r.so))
            members: Dict[str, int] = {}
            for node in self._leaf_nodes(btree):
                if r.bytes(node, 4) != b"SNOD":
                    raise KerasImportError(f"{r.path}: no symbol table node "
                                           f"at {node}")
                count = r.uint(node + 6, 2)
                if count > 2 * r.leaf_k:
                    raise KerasImportError(
                        f"{r.path}: symbol table node at {node} holds "
                        f"{count} entries, over 2K = {2 * r.leaf_k}")
                entry = node + 8
                for _ in range(count):
                    off, header, cache = r._symbol_entry(entry)
                    name = r.cstring(names_at + off)
                    if cache == 2:
                        raise _unsupported(r.path, f"the soft link {name} in "
                                           f"{self.name}")
                    members[name] = header
                    entry += 2 * r.so + 24
            self._members = members
        return self._members

    def _leaf_nodes(self, node: int) -> Iterator[int]:
        """The symbol table nodes under the group B-tree node at `node`,
        in key (name) order."""
        r = self._reader
        if r.bytes(node, 4) != b"TREE":
            raise KerasImportError(f"{r.path}: no B-tree node at {node}")
        kind, level, used = r._map[node + 4], r._map[node + 5], \
            r.uint(node + 6, 2)
        if kind != 0:
            raise KerasImportError(f"{r.path}: B-tree node at {node} has "
                                   f"type {kind}, not a group node")
        if used > 2 * r.internal_k:
            raise KerasImportError(
                f"{r.path}: B-tree node at {node} has {used} children, over "
                f"2K = {2 * r.internal_k}")
        p = node + 8 + 2 * r.so + r.sl      # past the header and key 0
        for _ in range(used):
            child = r.addr(r.uint(p, r.so))
            if level == 0:
                yield child
            else:
                yield from self._leaf_nodes(child)
            p += r.so + r.sl

    def _open(self, name: str, header: int):
        r = self._reader
        msgs = r.messages(header)
        kinds = {m[0] for m in msgs}
        path = (self.name.rstrip("/") + "/" + name)
        for mtype in kinds & set(_NEW_STYLE_GROUP):
            raise _unsupported(r.path, f"a {_NEW_STYLE_GROUP[mtype]} message "
                               f"in {path}")
        if MSG_SYMBOL_TABLE in kinds:
            p = next(d for t, d, _ in msgs if t == MSG_SYMBOL_TABLE)
            table = (r.addr(r.uint(p, r.so)), r.addr(r.uint(p + r.so, r.so)))
            return Group(r, header, path, table, self._root)
        if MSG_LAYOUT in kinds:
            return Dataset(r, header, path, msgs)
        raise _unsupported(r.path, f"object {path} (neither a symbol-table "
                           "group nor a dataset)")

    def __getitem__(self, path: str):
        if path.startswith("/"):
            return self._root[path.lstrip("/")] if path.strip("/") \
                else self._root
        head, _, rest = path.partition("/")
        links = self._links()
        if head not in links:
            raise KeyError(f"{head!r} not in group {self.name!r}")
        obj = self._open(head, links[head])
        if rest:
            if not isinstance(obj, Group):
                raise KeyError(f"{obj.name!r} is a dataset, not a group")
            return obj[rest]
        return obj

    def get(self, path: str, default=None):
        try:
            return self[path]
        except KeyError:
            return default

    def __contains__(self, path) -> bool:
        return self.get(path) is not None

    def __iter__(self):
        return iter(self._links())

    def __len__(self):
        return len(self._links())

    def keys(self):
        return list(self._links())

    def values(self):
        return [self[k] for k in self._links()]

    def items(self):
        return [(k, self[k]) for k in self._links()]

    def __repr__(self):
        return f"<Group {self.name!r} ({len(self)} members)>"


class File(Group):
    """An HDF5 file opened for reading; the root group. Close it, or use
    it as a context manager."""

    def __init__(self, path):
        reader = _Reader(path)
        try:
            msgs = reader.messages(reader.root_address)
            p = next((d for t, d, _ in msgs if t == MSG_SYMBOL_TABLE), None)
            if p is None:
                raise _unsupported(reader.path, "a root group without a "
                                   "symbol table")
            table = (reader.addr(reader.uint(p, reader.so)),
                     reader.addr(reader.uint(p + reader.so, reader.so)))
        except Exception:
            reader.close()
            raise
        super().__init__(reader, reader.root_address, "/", table, None)
        self.filename = reader.path

    def close(self):
        self._reader.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
