"""Wire cache: pre-encoded compact batches, mmap-streamed per epoch.

The round-2 prepacked format (`data/prepacked.py`) eliminated per-epoch id
repacking, but the remaining per-batch host work — the `sort_feature` row
sort plus the compact-wire bit-packing — still costs ~15 ms per 262k-row
batch (measured; it was 51 ms before the combined-key sort). At flagship
shapes that is ~1.2x the DEVICE time of the same batch, so the from-disk
epoch runs at roughly half the chip's capacity even with featurize worker
threads (the work is GIL-bound numpy).

This module moves that featurization to WRITE time, the same trade
`pack_dataset` makes one level down the stack: a wire cache stores the
exact `CompactBatch` payload bytes of every batch — sorted, delta-encoded,
bit-packed, label-packed — as flat mmap-able planes. The per-epoch host path
collapses to:

    mmap batch planes (zero-copy page-cache views)
    -> np.stack K views into the macro transfer buffer (the single memcpy)
    -> device_put

Quality (measured at full scale — replica, BCE, 3 epochs, bs=16k): the
batch ORDER matters, the composition freeze does not. Loader order on a
fresh generation replays the dynamic path's exact sequence (bitwise-identical
params, verified); seeded ROTATION on generation reuse preserved recall@100
even with ONE frozen composition for all epochs. A UNIFORM batch
permutation, by contrast, systematically cost recall across three seeds
— don't use `order mode="shuffle"` for multi-epoch quality runs. The CLI's
`--wire-cache-order auto` picks loader/rotate; `--wire-cache-generations N`
additionally re-rolls compositions (N one-time builds, each costing about
one dynamic epoch's featurization) if composition variety is wanted.

Layout of a cache directory:

    meta.json         format/version, batch count + size, scheme fingerprint
    wire.bin          [NB, W8, B]   uint8
    rem.bin           [NB, R, B//8] uint8   (bit-packed remainder; optional)
    labels.bin        [NB, B]       int32   (absent when the label rides the wire)
    dense.bin         [NB, B, D]    float32 (optional)
    delta_pos.bin     [NB, K]       int32   (delta-slot exceptions; optional)
    delta_extra.bin   [NB, K]       int32
"""

from __future__ import annotations

import dataclasses
import json
import os
import zlib
from typing import Iterable, Iterator, Mapping

import numpy as np

from two_tower_recommender_model.data.compact import CompactBatch, CompactScheme

_FORMAT = "ttrm-wirecache-v1"


def _scheme_fingerprint(scheme: CompactScheme) -> dict:
    """JSON-normalized CompactScheme (tuples -> lists) for exact compatibility
    checks between build time and read time."""
    return json.loads(json.dumps(dataclasses.asdict(scheme)))


def build_wire_cache(
    out_dir: str,
    column_batches: Iterable[Mapping[str, np.ndarray]],
    featurizer,
    *,
    drop_ragged_tail: bool = True,
    fingerprint: Mapping | None = None,
) -> dict:
    """Encode every batch of `column_batches` through `featurizer` (a
    `CompactFeaturizer`, including any inner sort) and store the resulting
    wire payloads. One-time cost ~= one dynamic epoch's featurization.

    All batches must share the first batch's size; a smaller FINAL batch is
    dropped (recorded in the meta) when `drop_ragged_tail`, else it raises —
    macro-scan training needs static shapes anyway. Returns the meta dict."""
    scheme: CompactScheme = featurizer.scheme
    os.makedirs(out_dir, exist_ok=True)
    files: dict[str, object] = {}
    shapes: dict[str, list[int]] = {}
    nb = 0
    dropped_rows = 0
    batch_size = None

    def sink(name: str, arr: np.ndarray | None):
        if arr is None:
            return
        arr = np.ascontiguousarray(arr)
        if name not in files:
            files[name] = open(os.path.join(out_dir, f"{name}.bin"), "wb")
            shapes[name] = [*arr.shape]
        elif shapes[name] != [*arr.shape]:
            raise ValueError(
                f"wire cache {name}: batch shape {[*arr.shape]} != first "
                f"batch's {shapes[name]}"
            )
        files[name].write(arr.tobytes())

    try:
        for cols in column_batches:
            cb: CompactBatch = featurizer(cols)
            if cb.weights is not None:
                raise ValueError("wire cache stores training batches; weights "
                                 "(eval padding) are not supported")
            b = cb.batch_size
            if batch_size is None:
                batch_size = b
            elif b != batch_size:
                if drop_ragged_tail and b < batch_size:
                    dropped_rows += b
                    continue
                raise ValueError(f"batch size changed {batch_size} -> {b}")
            sink("wire", cb.wire)
            sink("rem", cb.rem)
            sink("labels", cb.labels if cb.labels.size else None)
            sink("dense", cb.dense)
            sink("delta_pos", cb.delta_pos)
            sink("delta_extra", cb.delta_extra)
            nb += 1
    finally:
        for f in files.values():
            f.close()
    if nb == 0:
        raise ValueError("wire cache: no batches")
    meta = {
        "format": _FORMAT,
        "num_batches": nb,
        "batch_size": batch_size,
        "dropped_tail_rows": dropped_rows,
        "planes": {name: shapes[name] for name in files},
        "scheme": _scheme_fingerprint(scheme),
        # caller-supplied dataset identity (e.g. data dir + row counts) —
        # checked at read time so a stale cache can't silently train old
        # data or a different batch size
        "fingerprint": json.loads(json.dumps(fingerprint)) if fingerprint else None,
    }
    with open(os.path.join(out_dir, "meta.json"), "w") as f:
        json.dump(meta, f, indent=1)
    return meta


class WireCache:
    """Reader half: mmap the planes, stream seeded per-epoch batch orders.

    `batches(epoch)` yields `CompactBatch` objects whose leaves are views into
    the page cache — zero host compute; `np.stack` in the macro assembler does
    the one copy into the transfer buffer."""

    def __init__(self, path: str, scheme: CompactScheme | None = None,
                 seed: int = 0, batch_size: int | None = None,
                 fingerprint: Mapping | None = None):
        self.path = path
        with open(os.path.join(path, "meta.json")) as f:
            self.meta = json.load(f)
        if self.meta.get("format") != _FORMAT:
            raise ValueError(f"{path}: not a wire cache (format={self.meta.get('format')!r})")
        if scheme is not None:
            want = _scheme_fingerprint(scheme)
            if self.meta["scheme"] != want:
                raise ValueError(
                    f"{path}: cache was built with a different wire scheme — "
                    "rebuild it for this model/config"
                )
        if batch_size is not None and int(self.meta["batch_size"]) != batch_size:
            raise ValueError(
                f"{path}: cache was built at batch_size="
                f"{self.meta['batch_size']}, run wants {batch_size} — rebuild it"
            )
        if fingerprint is not None and self.meta.get("fingerprint") is not None:
            want = json.loads(json.dumps(fingerprint))
            if self.meta["fingerprint"] != want:
                raise ValueError(
                    f"{path}: cache was built from a different dataset "
                    f"({self.meta['fingerprint']} != {want}) — rebuild it"
                )
        self.num_batches = int(self.meta["num_batches"])
        self.batch_size = int(self.meta["batch_size"])
        self.seed = seed
        self._planes = {}
        for name, shape in self.meta["planes"].items():
            dtype = {"wire": np.uint8, "rem": np.uint8, "labels": np.int32,
                     "dense": np.float32, "delta_pos": np.int32,
                     "delta_extra": np.int32}[name]
            self._planes[name] = np.memmap(
                os.path.join(self.path, f"{name}.bin"), dtype=dtype, mode="r",
            ).reshape(self.num_batches, *shape)

    def order(self, epoch: int, mode: str = "shuffle") -> np.ndarray:
        """Batch order for `epoch` (identical on every host):

        - "loader": build (= StreamLoader) order — replays the dynamic path's
          exact batch sequence (bitwise-identical training, measured);
        - "rotate": loader order cyclically rotated by a seeded offset —
          varies the phase on generation REUSE while preserving the stream's
          local structure (a uniform permutation measurably cost recall at
          full scale);
        - "shuffle": seeded uniform permutation.
        """
        if mode == "loader":
            return np.arange(self.num_batches)
        key = zlib.crc32(f"wirecache:{self.seed}:{epoch}".encode())
        if mode == "rotate":
            off = key % max(self.num_batches, 1)
            return np.roll(np.arange(self.num_batches), -int(off))
        if mode != "shuffle":
            raise ValueError(f"order mode must be loader|rotate|shuffle, got {mode!r}")
        return np.random.default_rng(key).permutation(self.num_batches)

    def _batch(self, i: int) -> CompactBatch:
        p = self._planes
        labels = p["labels"][i] if "labels" in p else np.zeros(0, np.int32)
        return CompactBatch(
            wire=p["wire"][i],
            rem=p["rem"][i] if "rem" in p else None,
            labels=labels,
            dense=p["dense"][i] if "dense" in p else None,
            weights=None,
            delta_pos=p["delta_pos"][i] if "delta_pos" in p else None,
            delta_extra=p["delta_extra"][i] if "delta_extra" in p else None,
        )

    def batches(
        self,
        epoch: int = 0,
        host_index: int = 0,
        host_count: int = 1,
        skip_batches: int = 0,
        limit_batches: int | None = None,
        order_mode: str = "shuffle",
    ) -> Iterator[CompactBatch]:
        """This host's slice of the epoch: disjoint, equal-count contiguous
        runs of the shuffled order (same alignment contract as
        `StreamLoader`); `skip_batches` supports mid-epoch resume.

        `limit_batches` truncates the slice AFTER host slicing — multi-host
        runs with one cache PER PROCESS (each built from that host's loader
        slice) pass the global-min batch count here so every host takes the
        same number of steps (the lockstep contract collectives require)."""
        if not (0 <= host_index < host_count):
            raise ValueError(f"host_index {host_index} out of range {host_count}")
        per_host = self.num_batches // host_count
        order = self.order(epoch, order_mode)[
            host_index * per_host : (host_index + 1) * per_host]
        if limit_batches is not None:
            order = order[:limit_batches]
        for i in order[skip_batches:]:
            yield self._batch(int(i))
