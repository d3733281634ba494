"""A small HDF5 reader and writer in numpy, for the port's output files.

The port writes and reads its outputs with this module, so it needs no
h5py.  It covers the subset of the format that h5py writes by default
(libver "earliest") for pyro's files, and that the JAX package's outputs
use: the version 0 superblock, version 1 object headers, groups as symbol
tables (a v1 B-tree over symbol-table nodes, names in a local heap),
contiguous and compact datasets, attributes in the object header, and
these datatypes: little-endian integers and IEEE floats, fixed-length
strings, enums (h5py's bool is the enum FALSE=0, TRUE=1) and
variable-length strings (in a global heap).  Anything else (chunked or
filtered data, version 2 object headers, dense attribute storage) raises
NotImplementedError.  Files it writes are read by h5py.

The API is the part of h5py's that pyro uses::

    with File("out.h5", "w") as f:
        f.attrs["solver"] = "advection"
        g = f.create_group("state")
        g.create_dataset("data", data=array)
    with File("out.h5") as f:
        names = list(f["state"])          # sorted, as h5py iterates
        a = f["state/data"][...]
"""

import struct

import numpy as np

__all__ = ["File", "Group", "Dataset"]

_SIG = b"\x89HDF\r\n\x1a\n"
_UNDEF = 0xFFFFFFFFFFFFFFFF
_LEAF_K = 32          # group leaf-node K: one symbol node holds 2K names
_INTERNAL_K = 16


def _pad8(n):
    return (n + 7) & ~7


class Dataset:
    """An n-d array with attributes.  Like h5py's, a Dataset is truthy
    whatever it holds (pyro's BC records rely on that)."""

    def __init__(self, data, attrs=None):
        self._data = data
        self.attrs = dict(attrs or {})

    @property
    def shape(self):
        return self._data.shape

    @property
    def dtype(self):
        return self._data.dtype

    def __getitem__(self, key):
        out = self._data[key]
        return out.copy() if isinstance(out, np.ndarray) else out

    def __bool__(self):
        return True


class Group:
    """Named members (groups and datasets) and attributes."""

    def __init__(self):
        self._members = {}
        self.attrs = {}

    def __getitem__(self, path):
        node = self
        for part in path.strip("/").split("/"):
            if not isinstance(node, Group) or part not in node._members:
                raise KeyError(f"no member '{path}'")
            node = node._members[part]
        return node

    def __contains__(self, path):
        try:
            self[path]
        except KeyError:
            return False
        return True

    def __iter__(self):
        return iter(self.keys())

    def __len__(self):
        return len(self._members)

    def keys(self):
        return sorted(self._members, key=lambda s: s.encode())

    def create_group(self, name):
        if name in self._members:
            raise ValueError(f"'{name}' exists")
        self._members[name] = Group()
        return self._members[name]

    def create_dataset(self, name, data):
        if name in self._members:
            raise ValueError(f"'{name}' exists")
        arr = np.array(data)
        if arr.dtype.kind not in "biuf":
            raise NotImplementedError(f"dataset dtype {arr.dtype}")
        self._members[name] = Dataset(arr)
        return self._members[name]


class File(Group):
    """An HDF5 file opened for reading ("r", read whole at open) or
    writing ("w", written at close)."""

    def __init__(self, filename, mode="r"):
        super().__init__()
        if mode not in ("r", "w"):
            raise ValueError(f"mode '{mode}' (r or w)")
        self.filename = str(filename)
        self.mode = mode
        if mode == "r":
            with open(self.filename, "rb") as fh:
                root = _Reader(fh.read()).root()
            self._members, self.attrs = root._members, root.attrs

    def close(self):
        if self.mode == "w":
            with open(self.filename, "wb") as fh:
                fh.write(_Writer().file_image(self))
            self.mode = "closed"

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            self.close()


# ---------------------------------------------------------------------------
# reading
# ---------------------------------------------------------------------------

class _Reader:

    def __init__(self, buf):
        self.b = buf
        if buf[:8] != _SIG:
            raise OSError("not an HDF5 file")
        if buf[8] not in (0, 1):
            raise NotImplementedError(
                f"HDF5 superblock version {buf[8]} (0 and 1 are read)")
        if buf[13] != 8 or buf[14] != 8:
            raise NotImplementedError("HDF5 offsets and lengths of 8 bytes")
        # the root group's symbol-table entry follows 4 addresses
        root_at = (24 if buf[8] == 0 else 28) + 4 * 8
        self.root_header = self.u64(root_at + 8)

    def u8(self, at):
        return self.b[at]

    def u16(self, at):
        return struct.unpack_from("<H", self.b, at)[0]

    def u32(self, at):
        return struct.unpack_from("<I", self.b, at)[0]

    def u64(self, at):
        return struct.unpack_from("<Q", self.b, at)[0]

    def cstr(self, at):
        return self.b[at:self.b.index(b"\0", at)].decode()

    def root(self):
        return self.node(self.root_header)

    # -- object headers ------------------------------------------------------
    def messages(self, at):
        """[(type, data offset, size)] of a version 1 object header."""
        if self.b[at:at + 4] == b"OHDR":
            raise NotImplementedError("HDF5 version 2 object headers")
        if self.u8(at) != 1:
            raise OSError(f"bad object header at {at}")
        nmsg = self.u16(at + 2)
        blocks = [(at + 16, self.u32(at + 8))]
        out = []
        while blocks and len(out) < nmsg:
            p, size = blocks.pop(0)
            end = p + size
            while p + 8 <= end and len(out) < nmsg:
                mtype, msize = self.u16(p), self.u16(p + 2)
                if mtype == 0x10:                      # continuation
                    blocks.append((self.u64(p + 8), self.u64(p + 16)))
                out.append((mtype, p + 8, msize))
                p += 8 + msize
        return out

    def node(self, at):
        msgs = self.messages(at)
        attrs = {}
        for mtype, p, _ in msgs:
            if mtype == 0x0C:
                name, value = self.attribute(p)
                attrs[name] = value
            elif mtype in (0x02, 0x06, 0x15):
                raise NotImplementedError(
                    "HDF5 link messages and dense attributes (files "
                    "written with libver 'latest')")
        types = {m[0] for m in msgs}
        if 0x11 in types:
            g = Group()
            p = next(m[1] for m in msgs if m[0] == 0x11)
            heap = self.local_heap(self.u64(p + 8))
            for name, child in self.btree_entries(self.u64(p), heap):
                g._members[name] = self.node(child)
            g.attrs = attrs
            return g
        space = dtype = layout = None
        for mtype, p, _ in msgs:
            if mtype == 0x01:
                space = self.dataspace(p)
            elif mtype == 0x03:
                dtype = self.datatype(p)
            elif mtype == 0x08:
                layout = p
            elif mtype == 0x0B:
                raise NotImplementedError("filtered HDF5 datasets")
        if space is None or dtype is None or layout is None:
            raise OSError(f"object at {at} is neither group nor dataset")
        return Dataset(self.layout_data(layout, space, dtype), attrs)

    # -- groups ---------------------------------------------------------------
    def local_heap(self, at):
        if self.b[at:at + 4] != b"HEAP":
            raise OSError(f"bad local heap at {at}")
        return self.u64(at + 24)

    def btree_entries(self, at, heap):
        if self.b[at:at + 4] != b"TREE" or self.u8(at + 4) != 0:
            raise OSError(f"bad group B-tree node at {at}")
        level, used = self.u8(at + 5), self.u16(at + 6)
        out = []
        for i in range(used):
            child = self.u64(at + 24 + 8 + 16 * i)
            if level > 0:
                out += self.btree_entries(child, heap)
            else:
                out += self.symbol_node(child, heap)
        return out

    def symbol_node(self, at, heap):
        if self.b[at:at + 4] != b"SNOD":
            raise OSError(f"bad symbol table node at {at}")
        out = []
        for i in range(self.u16(at + 6)):
            e = at + 8 + 40 * i
            out.append((self.cstr(heap + self.u64(e)), self.u64(e + 8)))
        return out

    # -- messages -------------------------------------------------------------
    def dataspace(self, p):
        version, ndims = self.u8(p), self.u8(p + 1)
        if version == 1:
            dims_at = p + 8
        elif version == 2:
            if self.u8(p + 3) == 2:
                raise NotImplementedError("null HDF5 dataspaces")
            dims_at = p + 4
        else:
            raise NotImplementedError(f"dataspace version {version}")
        return tuple(self.u64(dims_at + 8 * i) for i in range(ndims))

    def datatype(self, p):
        """(kind, numpy dtype, extra): kind is 'num', 'enum-bool',
        'vlen-str' or 'fixed-str'."""
        cls = self.u8(p) & 0x0F
        bits = self.u8(p + 1) | self.u8(p + 2) << 8
        size = self.u32(p + 4)
        if cls in (0, 1):
            if bits & 1:
                raise NotImplementedError("big-endian HDF5 data")
            if cls == 1:
                kind = "f"
            else:
                kind = "i" if bits & 8 else "u"
            return "num", np.dtype(f"<{kind}{size}"), None
        if cls == 3:
            return "fixed-str", np.dtype(f"S{size}"), None
        if cls == 8:
            _, base, _ = self.datatype(p + 8)
            nmemb = bits
            q = p + 8 + self.datatype_size(p + 8)
            names = []
            for _ in range(nmemb):
                name = self.cstr(q)
                names.append(name)
                q += _pad8(len(name) + 1)
            values = np.frombuffer(self.b, base, nmemb, q).tolist()
            if dict(zip(names, values)) == {"FALSE": 0, "TRUE": 1}:
                return "enum-bool", base, None
            return "num", base, None
        if cls == 9 and bits & 0x0F == 1:
            return "vlen-str", np.dtype(object), None
        raise NotImplementedError(f"HDF5 datatype class {cls}")

    def datatype_size(self, p):
        """The encoded size of the datatype message at p (enum bases)."""
        cls = self.u8(p) & 0x0F
        if cls == 0:
            return 12
        if cls == 1:
            return 20
        raise NotImplementedError(f"HDF5 enum base of class {cls}")

    def values(self, at, shape, dtype):
        kind, npdt, _ = dtype
        count = int(np.prod(shape, dtype=np.int64))
        if kind == "vlen-str":
            out = np.empty(count, dtype=object)
            for i in range(count):
                e = at + 16 * i
                n, heap, idx = self.u32(e), self.u64(e + 4), self.u32(e + 12)
                out[i] = self.global_object(heap, idx)[:n].decode()
        else:
            out = np.frombuffer(self.b, npdt, count, at).copy()
            if kind == "enum-bool":
                out = out.astype(np.bool_)
        return out.reshape(shape)

    def global_object(self, at, index):
        if self.b[at:at + 4] != b"GCOL":
            raise OSError(f"bad global heap at {at}")
        end = at + self.u64(at + 8)
        p = at + 16
        while p + 16 <= end:
            idx, size = self.u16(p), self.u64(p + 8)
            if idx == 0:
                break
            if idx == index:
                return self.b[p + 16:p + 16 + size]
            p += 16 + _pad8(size)
        raise OSError(f"no object {index} in the global heap at {at}")

    def layout_data(self, p, shape, dtype):
        version, cls = self.u8(p), self.u8(p + 1)
        if version != 3:
            raise NotImplementedError(f"HDF5 data layout version {version}")
        if cls == 0:
            at = p + 4
        elif cls == 1:
            at = self.u64(p + 2)
            if at == _UNDEF:
                return np.zeros(shape, dtype[1])
        else:
            raise NotImplementedError("chunked HDF5 datasets")
        return self.values(at, shape, dtype)

    def attribute(self, p):
        version = self.u8(p)
        if version not in (1, 2, 3):
            raise NotImplementedError(f"attribute version {version}")
        nlen, tlen, slen = self.u16(p + 2), self.u16(p + 4), self.u16(p + 6)
        pad = _pad8 if version == 1 else (lambda n: n)
        q = p + 8 + (1 if version == 3 else 0)
        name = self.cstr(q)
        q += pad(nlen)
        dtype = self.datatype(q)
        q += pad(tlen)
        shape = self.dataspace(q)
        q += pad(slen)
        value = self.values(q, shape, dtype)
        return name, (value[()] if shape == () else value)


# ---------------------------------------------------------------------------
# writing
# ---------------------------------------------------------------------------

def _dtype_message(arr):
    """The datatype message of a numpy array (or 'vlen-str')."""
    if isinstance(arr, str):
        # variable-length UTF-8 string over 1-byte characters
        return struct.pack("<BBBBI", 0x19, 0x01, 0x01, 0, 16) + \
            struct.pack("<BBBBIHH", 0x10, 0, 0, 0, 1, 0, 8)
    dt = arr.dtype
    if dt.kind == "b":
        base = struct.pack("<BBBBIHH", 0x10, 0x08, 0, 0, 1, 0, 8)
        return (struct.pack("<BBBBI", 0x18, 2, 0, 0, 1) + base +
                b"FALSE\0\0\0" + b"TRUE\0\0\0\0" + b"\x00\x01")
    if dt.kind in "iu":
        return struct.pack("<BBBBIHH", 0x10, 0x08 if dt.kind == "i" else 0,
                           0, 0, dt.itemsize, 0, 8 * dt.itemsize)
    if dt == np.float64:
        return struct.pack("<BBBBIHHBBBBI", 0x11, 0x20, 63, 0, 8, 0, 64,
                           52, 11, 0, 52, 1023)
    if dt == np.float32:
        return struct.pack("<BBBBIHHBBBBI", 0x11, 0x20, 31, 0, 4, 0, 32,
                           23, 8, 0, 23, 127)
    raise NotImplementedError(f"HDF5 output of dtype {dt}")


def _space_message(shape):
    return struct.pack("<BBBBI", 1, len(shape), 0, 0, 0) + \
        b"".join(struct.pack("<Q", n) for n in shape)


def _attr_value(value):
    """A numpy array (or str) for an attribute value."""
    if isinstance(value, (str, np.str_)):
        return str(value)
    if isinstance(value, bytes):
        raise NotImplementedError("byte-string attributes")
    arr = np.asarray(value)
    if arr.dtype.kind == "U" and arr.ndim == 0:
        return str(arr)
    return arr


class _Writer:

    def __init__(self):
        self.buf = bytearray(96)
        self.strings = {}        # str -> (global heap index)
        self.heap_at = None

    def put(self, data):
        self.buf += b"\0" * (_pad8(len(self.buf)) - len(self.buf))
        at = len(self.buf)
        self.buf += data
        return at

    def file_image(self, root):
        self.collect_strings(root)
        if self.strings:
            self.heap_at = self.put(self.global_heap())
        header, btree, heap = self.group(root)
        sb = struct.pack("<8sBBBBBBBBHHI", _SIG, 0, 0, 0, 0, 0, 8, 8, 0,
                         _LEAF_K, _INTERNAL_K, 0)
        sb += struct.pack("<QQQQ", 0, _UNDEF, len(self.buf), _UNDEF)
        sb += struct.pack("<QQII", 0, header, 1, 0) + \
            struct.pack("<QQ", btree, heap)
        self.buf[:96] = sb
        return bytes(self.buf)

    # -- strings --------------------------------------------------------------
    def collect_strings(self, node):
        for value in node.attrs.values():
            v = _attr_value(value)
            if isinstance(v, str) and v not in self.strings:
                self.strings[v] = len(self.strings) + 1
        if isinstance(node, Group):
            for child in node._members.values():
                self.collect_strings(child)

    def global_heap(self):
        body = b""
        for s, idx in self.strings.items():
            raw = s.encode()
            body += struct.pack("<HHIQ", idx, 1, 0, len(raw)) + raw + \
                b"\0" * (_pad8(len(raw)) - len(raw))
        size = max(4096, 16 + len(body) + 16)
        free = size - 16 - len(body)
        return (b"GCOL" + struct.pack("<BxxxQ", 1, size) + body +
                struct.pack("<HHIQ", 0, 0, 0, free) + b"\0" * (free - 16))

    # -- objects --------------------------------------------------------------
    def header(self, messages):
        """A version 1 object header of (type, data) messages."""
        body = b""
        for mtype, data in messages:
            data += b"\0" * (_pad8(len(data)) - len(data))
            body += struct.pack("<HHBxxx", mtype, len(data), 0) + data
        return self.put(struct.pack("<BxHII", 1, len(messages), 1,
                                    len(body)) + b"\0" * 4 + body)

    def attributes(self, attrs):
        msgs = []
        for name, value in attrs.items():
            v = _attr_value(value)
            raw_name = name.encode() + b"\0"
            dt = _dtype_message(v)
            if isinstance(v, str):
                sp = _space_message(())
                raw = v.encode()
                data = struct.pack("<IQI", len(raw), self.heap_at,
                                   self.strings[v])
            else:
                sp = _space_message(v.shape)
                data = v.astype(v.dtype.newbyteorder("<")).tobytes()
            msg = struct.pack("<BxHHH", 1, len(raw_name), len(dt), len(sp))
            for part in (raw_name, dt, sp):
                msg += part + b"\0" * (_pad8(len(part)) - len(part))
            msgs.append((0x0C, msg + data))
        return msgs

    def dataset(self, ds):
        arr = ds._data
        raw = arr.astype(arr.dtype.newbyteorder("<")).tobytes()
        data_at = self.put(raw) if raw else _UNDEF
        layout = struct.pack("<BBQQ", 3, 1, data_at, len(raw))
        return self.header([(0x01, _space_message(arr.shape)),
                            (0x03, _dtype_message(arr)),
                            (0x05, b"\x02\x02\x02\x01\0\0\0\0"),
                            (0x08, layout)] + self.attributes(ds.attrs))

    def group(self, g):
        """Write g's members, heap, symbol node, B-tree and header;
        returns (header, btree, heap) addresses."""
        names = g.keys()
        if len(names) > 2 * _LEAF_K:
            raise NotImplementedError(
                f"groups of more than {2 * _LEAF_K} members")
        entries = []
        for name in names:
            child = g._members[name]
            if isinstance(child, Group):
                entries.append((name, *self.group(child)))
            else:
                entries.append((name, self.dataset(child), None, None))

        data = b"\0" * 8
        offsets = []
        for name in names:
            offsets.append(len(data))
            raw = name.encode() + b"\0"
            data += raw + b"\0" * (_pad8(len(raw)) - len(raw))
        heap = self.put(b"HEAP" + struct.pack("<BxxxQQQ", 0, len(data), 1,
                                             0))
        struct.pack_into("<Q", self.buf, heap + 24, self.put(data))

        snod = b"SNOD" + struct.pack("<BxH", 1, len(entries))
        for off, (_, header, btree, lheap) in zip(offsets, entries):
            if btree is None:
                snod += struct.pack("<QQII", off, header, 0, 0) + b"\0" * 16
            else:
                snod += struct.pack("<QQIIQQ", off, header, 1, 0, btree,
                                    lheap)
        snod += b"\0" * (8 + 2 * _LEAF_K * 40 - len(snod))
        snod_at = self.put(snod)

        tree = b"TREE" + struct.pack("<BBHQQ", 0, 0, 1 if names else 0,
                                     _UNDEF, _UNDEF)
        if names:
            tree += struct.pack("<QQQ", 0, snod_at, offsets[-1])
        tree += b"\0" * (24 + 2 * _INTERNAL_K * 8 + (2 * _INTERNAL_K + 1) * 8
                         - len(tree))
        btree = self.put(tree)

        header = self.header([(0x11, struct.pack("<QQ", btree, heap))] +
                             self.attributes(g.attrs))
        return header, btree, heap
