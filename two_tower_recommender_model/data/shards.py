"""TTRS: a columnar shard format for streaming training data.

The role of Mosaic MDS shards (`workshop/01-mosaic-streaming.py:175-192`,
`dataframe_to_mds` with zstd compression, per-shard size limits and a merged
index): a dataset directory holds `index.json` plus N shard files, each a
self-describing binary blob of per-column contiguous arrays (optionally
zlib-compressed per column).

Layout of one shard file:

    magic   b"TTRS1\\n"
    u64     header length (little-endian)
    header  JSON: {"rows": R, "columns": [{"name", "dtype", "shape",
                                           "compressed", "stored_bytes"}]}
    payload per-column bytes, in header order

The payload is raw C-order little-endian array data — deliberately trivial to
parse from C++ (the native reader in `native/`) and to mmap when uncompressed.
"""

from __future__ import annotations

import json
import os
import zlib
from typing import Iterator, Mapping, Sequence

import numpy as np

MAGIC = b"TTRS1\n"
INDEX_NAME = "index.json"


def write_shard(path: str, columns: Mapping[str, np.ndarray], compress: bool = True) -> int:
    cols = {k: np.ascontiguousarray(v) for k, v in columns.items()}
    rows = {len(v) for v in cols.values()}
    if len(rows) != 1:
        raise ValueError(f"ragged columns: {[(k, len(v)) for k, v in cols.items()]}")
    (nrows,) = rows
    header_cols = []
    payloads = []
    for name, arr in cols.items():
        raw = arr.tobytes()
        stored = zlib.compress(raw, 6) if compress else raw
        if compress and len(stored) >= len(raw):
            stored, comp = raw, False
        else:
            comp = compress
        header_cols.append(
            {
                "name": name,
                "dtype": arr.dtype.str,
                "shape": list(arr.shape),
                "compressed": comp,
                "stored_bytes": len(stored),
            }
        )
        payloads.append(stored)
    header = json.dumps({"rows": nrows, "columns": header_cols}).encode()
    with open(path, "wb") as f:
        f.write(MAGIC)
        f.write(len(header).to_bytes(8, "little"))
        f.write(header)
        for p in payloads:
            f.write(p)
    return nrows


def read_shard(
    path: str, columns: Sequence[str] | None = None, mmap: bool = False
) -> dict[str, np.ndarray]:
    """`mmap=True` maps uncompressed columns straight from the page cache
    (zero-copy until touched) — the fast path for pre-packed uncompressed
    datasets (`data/prepacked.py`). Compressed columns always inflate.
    Unrequested columns are seeked past, never read."""
    with open(path, "rb") as f:
        if f.read(len(MAGIC)) != MAGIC:
            raise ValueError(f"{path}: bad magic")
        hlen = int.from_bytes(f.read(8), "little")
        header = json.loads(f.read(hlen))
        out = {}
        off = len(MAGIC) + 8 + hlen
        for col in header["columns"]:
            if columns is not None and col["name"] not in columns:
                f.seek(col["stored_bytes"], 1)
                off += col["stored_bytes"]
                continue
            dtype = np.dtype(col["dtype"])
            shape = tuple(col["shape"])
            if mmap and not col["compressed"]:
                arr = np.memmap(path, dtype=dtype, mode="r", offset=off, shape=shape)
                f.seek(col["stored_bytes"], 1)
            else:
                stored = f.read(col["stored_bytes"])
                raw = zlib.decompress(stored) if col["compressed"] else stored
                arr = np.frombuffer(raw, dtype=dtype).reshape(shape)
            off += col["stored_bytes"]
            out[col["name"]] = arr
    return out


def shard_rows(path: str) -> int:
    with open(path, "rb") as f:
        f.read(len(MAGIC))
        hlen = int.from_bytes(f.read(8), "little")
        return json.loads(f.read(hlen))["rows"]


def read_schema(path: str) -> dict[str, tuple[np.dtype, tuple[int, ...]]]:
    """Column schema {name: (dtype, trailing_shape)} from a shard header only
    (no payload IO). Lets a host that owns zero shards of a dataset still
    construct correctly-typed empty batches (`loader.py` align_hosts="pad")."""
    with open(path, "rb") as f:
        if f.read(len(MAGIC)) != MAGIC:
            raise ValueError(f"{path}: bad magic")
        hlen = int.from_bytes(f.read(8), "little")
        header = json.loads(f.read(hlen))
    return {
        c["name"]: (np.dtype(c["dtype"]), tuple(c["shape"][1:]))
        for c in header["columns"]
    }


class ShardWriter:
    """Stream rows into a shard directory with a row limit per shard (the
    `size_limit` role of `dataframe_to_mds`), writing `index.json` on close."""

    def __init__(self, out_dir: str, rows_per_shard: int = 1 << 18, compress: bool = True,
                 extra_index: Mapping | None = None):
        self.out_dir = out_dir
        self.rows_per_shard = rows_per_shard
        self.compress = compress
        self.extra_index = dict(extra_index) if extra_index else None
        self._buf: dict[str, list[np.ndarray]] = {}
        self._buf_rows = 0
        self._shards: list[dict] = []
        os.makedirs(out_dir, exist_ok=True)

    def write(self, columns: Mapping[str, np.ndarray]) -> None:
        cols = {k: np.asarray(v) for k, v in columns.items()}
        n = len(next(iter(cols.values())))
        start = 0
        while start < n:
            take = min(self.rows_per_shard - self._buf_rows, n - start)
            for k, v in cols.items():
                self._buf.setdefault(k, []).append(v[start : start + take])
            self._buf_rows += take
            start += take
            if self._buf_rows >= self.rows_per_shard:
                self._flush()

    def _flush(self) -> None:
        if not self._buf_rows:
            return
        name = f"shard_{len(self._shards):06d}.ttrs"
        cols = {k: np.concatenate(v) for k, v in self._buf.items()}
        rows = write_shard(os.path.join(self.out_dir, name), cols, self.compress)
        self._shards.append({"file": name, "rows": rows})
        self._buf, self._buf_rows = {}, 0

    def close(self) -> dict:
        if getattr(self, "_index", None) is not None:
            return self._index  # idempotent: write_dataset closes via both
            # the context manager and the explicit call
        self._flush()
        index = {
            "format": "ttrs",
            "version": 1,
            "total_rows": sum(s["rows"] for s in self._shards),
            "shards": self._shards,
        }
        if getattr(self, "extra_index", None):
            index.update(self.extra_index)
        with open(os.path.join(self.out_dir, INDEX_NAME), "w") as f:
            json.dump(index, f, indent=1)
        self._index = index
        return index

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def write_dataset(
    out_dir: str,
    batches: Iterator[Mapping[str, np.ndarray]] | Mapping[str, np.ndarray],
    rows_per_shard: int = 1 << 18,
    compress: bool = True,
    extra_index: Mapping | None = None,
) -> dict:
    """Write a full dataset dir from one dict-of-columns or an iterator of them."""
    if isinstance(batches, Mapping):
        batches = [batches]
    extra = dict(extra_index or {})
    if not compress:
        extra.setdefault("uncompressed", True)
    with ShardWriter(out_dir, rows_per_shard, compress, extra_index=extra) as w:
        for b in batches:
            w.write(b)
    return w.close()


class ShardedDataset:
    """A TTRS dataset directory: index + lazy shard reads.

    Reads go through the native C++ reader (`native/ttrs_reader.cpp`,
    parallel zlib inflate — the mosaicml-streaming C-extension role) when it
    builds on this machine; `use_native=False` forces the pure-Python path.
    """

    def __init__(self, path: str, use_native: bool | None = None, mmap: bool | None = None):
        self.path = path
        with open(os.path.join(path, INDEX_NAME)) as f:
            self.index = json.load(f)
        if self.index.get("format") != "ttrs":
            raise ValueError(f"{path}: not a ttrs dataset")
        self.shard_files = [s["file"] for s in self.index["shards"]]
        self.shard_row_counts = [s["rows"] for s in self.index["shards"]]
        # pre-packed uncompressed datasets default to the zero-copy mmap
        # reader; the native reader's parallel inflate only pays off when
        # there is something to inflate
        if mmap is None:
            mmap = bool(self.index.get("uncompressed"))
        self.mmap = mmap
        if use_native is None:
            from two_tower_recommender_model.native.ttrs import native_available

            use_native = not mmap and native_available()
        self.use_native = use_native

    @property
    def total_rows(self) -> int:
        return self.index["total_rows"]

    @property
    def num_shards(self) -> int:
        return len(self.shard_files)

    def schema(self, columns: Sequence[str] | None = None):
        """{name: (dtype, trailing_shape)} from the first shard's header."""
        if not self.shard_files:
            raise ValueError(f"{self.path}: empty dataset has no schema")
        sch = read_schema(os.path.join(self.path, self.shard_files[0]))
        if columns is not None:
            sch = {k: v for k, v in sch.items() if k in columns}
        return sch

    def read_shard(self, i: int, columns: Sequence[str] | None = None) -> dict[str, np.ndarray]:
        path = os.path.join(self.path, self.shard_files[i])
        if self.use_native and not self.mmap:
            from two_tower_recommender_model.native.ttrs import native_read_shard

            return native_read_shard(path, list(columns) if columns is not None else None)
        return read_shard(path, columns, mmap=self.mmap)
