"""Pre-packed datasets: do the host featurization ONCE, at shard-write time.

The round-1 pipeline paid, per epoch per batch: zlib inflate -> per-column
buffer assembly -> PackedFeaturizer repack (several passes over the id bytes).
That host path — not the chip — was the measured throughput floor (DESIGN
§6b). The reference has the same disease in worse form: its per-element KJT
builder runs per batch forever (`transform_to_torchrec_batch`,
`03_model_training.py:353-380`).

Here, `pack_dataset` stores shard columns in EXACTLY the `PackedBatch` device
layout (`packed_ids` [rows, total_slots] int32, label bit-packed; optional
`dense` [rows, D] f32), uncompressed. The epoch hot path becomes:

    mmap shard (zero-copy page-cache read)
    -> StreamLoader row-cursor slice (view)
    -> PrepackedFeaturizer (shape check only)
    -> np.stack into the macro transfer buffer (the single memcpy)

Hashing/masking still happen on-device in `unpack_batch`, fused into the
train step; numerics are identical to the online `PackedFeaturizer` path
(tested).
"""

from __future__ import annotations

from typing import Iterator, Mapping

import numpy as np

from two_tower_recommender_model.config import ModelConfig
from two_tower_recommender_model.data.device_featurizer import (
    PackedBatch,
    PackedFeaturizer,
)
from two_tower_recommender_model.data.shards import write_dataset

PACKED_IDS = "packed_ids"
PACKED_DENSE = "dense"
PACKED_LABELS = "labels"


def pack_columns(
    featurizer: PackedFeaturizer, columns: Mapping[str, np.ndarray]
) -> dict[str, np.ndarray]:
    """Raw id columns -> storable packed columns (the write-time half)."""
    pb = featurizer(columns)
    out = {PACKED_IDS: pb.ids_raw}
    if pb.labels.size:
        out[PACKED_LABELS] = pb.labels
    if pb.dense is not None:
        out[PACKED_DENSE] = pb.dense
    return out


def pack_dataset(
    out_dir: str,
    model_cfg: ModelConfig,
    batches: Iterator[Mapping[str, np.ndarray]] | Mapping[str, np.ndarray],
    pack_label: bool = True,
    dense_cols: tuple[str, ...] = (),
    rows_per_shard: int = 1 << 19,
    compress: bool = False,
) -> dict:
    """Write a pre-packed TTRS dataset (device-layout columns, uncompressed by
    default so the reader mmaps). The index records the packing config so
    `PrepackedFeaturizer.for_dataset` can validate compatibility at load."""
    featurizer = PackedFeaturizer(model_cfg, dense_cols=dense_cols, pack_label=pack_label)
    if isinstance(batches, Mapping):
        batches = [batches]
    packed = (pack_columns(featurizer, b) for b in batches)
    extra = {
        "packed": {
            "pack_label": pack_label,
            "total_slots": featurizer.total_slots,
            "slots": [[name, L, n] for name, L, n in featurizer.slots],
            "dense": bool(dense_cols),
        }
    }
    return write_dataset(out_dir, packed, rows_per_shard, compress, extra_index=extra)


class PrepackedFeaturizer:
    """Read-time half: packed columns -> PackedBatch. No per-batch id work —
    a contiguity fix-up at most (row-shuffled slices are already contiguous
    copies; sequential slices are views)."""

    def __init__(self, model_cfg: ModelConfig, pack_label: bool = True, dense: bool = False,
                 sort_feature: str | None = None):
        ref = PackedFeaturizer(model_cfg, pack_label=pack_label, sort_feature=sort_feature)
        self.total_slots = ref.total_slots
        self.slots = ref.slots
        self.pack_label = pack_label
        self.dense = dense
        self.sort_feature = sort_feature
        self._sort = ref._sort

    @classmethod
    def for_dataset(
        cls, dataset, model_cfg: ModelConfig, sort_feature: str | None = None
    ) -> "PrepackedFeaturizer":
        """Build from a ShardedDataset's recorded packing config, validating
        it matches the model's slot layout. `sort_feature` applies the
        per-batch row sort at read time (the loader's row shuffle destroys any
        write-time order, so sorting must happen after batch materialization)."""
        meta = dataset.index.get("packed")
        if not meta:
            raise ValueError(f"{dataset.path}: not a pre-packed dataset")
        self = cls(model_cfg, pack_label=meta["pack_label"], dense=meta.get("dense", False),
                   sort_feature=sort_feature)
        want = [[name, L, n] for name, L, n in self.slots]
        if meta["slots"] != want:
            raise ValueError(
                f"packed dataset slot layout {meta['slots']} != model layout {want}"
            )
        return self

    def __call__(self, columns: Mapping[str, np.ndarray]) -> PackedBatch:
        ids = np.ascontiguousarray(columns[PACKED_IDS])
        if ids.ndim != 2 or ids.shape[1] != self.total_slots:
            raise ValueError(f"packed_ids {ids.shape} != [B, {self.total_slots}]")
        if self.pack_label:
            labels = np.zeros(0, np.int32)
        else:
            labels = np.ascontiguousarray(columns[PACKED_LABELS])
        dense = np.ascontiguousarray(columns[PACKED_DENSE]) if self.dense else None
        pb = PackedBatch(ids_raw=ids, labels=labels, dense=dense)
        if self._sort is not None:
            from two_tower_recommender_model.data.device_featurizer import (
                sort_packed_batch,
            )

            pb = sort_packed_batch(pb, *self._sort, self.pack_label)
        return pb
