"""Python face of the native TTRS reader (ctypes wrapper).

`native_read_shard` is API-compatible with `data.shards.read_shard`; the
streaming loader uses it automatically when the native library builds
(`data/shards.py: ShardedDataset.read_shard`).
"""

from __future__ import annotations

import ctypes

import numpy as np

from two_tower_recommender_model.native.build import load_ttrs_reader


class NativeShardReader:
    def __init__(self, path: str):
        lib = load_ttrs_reader()
        if lib is None:
            raise RuntimeError("native ttrs reader unavailable")
        self._lib = lib
        self._h = lib.ttrs_open(path.encode())
        if not self._h:
            raise IOError(f"ttrs_open failed for {path}")
        self.path = path

    @property
    def rows(self) -> int:
        return self._lib.ttrs_rows(self._h)

    def columns(self) -> list[str]:
        n = self._lib.ttrs_num_columns(self._h)
        return [self._lib.ttrs_column_name(self._h, i).decode() for i in range(n)]

    def _col_info(self, i: int):
        dtype = np.dtype(self._lib.ttrs_column_dtype(self._h, i).decode())
        ndim = self._lib.ttrs_column_ndim(self._h, i)
        shape = tuple(self._lib.ttrs_column_dim(self._h, i, d) for d in range(ndim))
        nbytes = self._lib.ttrs_column_nbytes(self._h, i)
        return dtype, shape, nbytes

    def read(self, columns: list[str] | None = None) -> dict[str, np.ndarray]:
        names = self.columns()
        want = [i for i, n in enumerate(names) if columns is None or n in columns]
        outs = {}
        bufs = []
        caps = []
        for i in want:
            dtype, shape, nbytes = self._col_info(i)
            arr = np.empty(shape, dtype=dtype)
            outs[names[i]] = arr
            bufs.append(arr.ctypes.data_as(ctypes.c_void_p))
            caps.append(nbytes)
        if not want:
            return outs
        idx_arr = (ctypes.c_int * len(want))(*want)
        out_arr = (ctypes.c_void_p * len(want))(*bufs)
        cap_arr = (ctypes.c_int64 * len(want))(*caps)
        rc = self._lib.ttrs_read_columns_parallel(
            self._h, idx_arr, len(want), out_arr, cap_arr
        )
        if rc != 0:
            raise IOError(f"ttrs read failed rc={rc} for {self.path}")
        return outs

    def close(self) -> None:
        if self._h:
            self._lib.ttrs_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def native_available() -> bool:
    return load_ttrs_reader() is not None


def native_read_shard(path: str, columns: list[str] | None = None) -> dict[str, np.ndarray]:
    r = NativeShardReader(path)
    try:
        return r.read(columns)
    finally:
        r.close()
