"""Vectorized featurizer: columnar batches -> fixed-shape device batches.

The vectorized replacement for the reference's per-element Python KJT builder
`transform_to_torchrec_batch` (reference `03_model_training.py:353-380`) — the
known CPU hotspot of the reference hot loop (SURVEY §3.1). Semantics preserved:

- each categorical id is hashed into its table with `value % num_embeddings`
  (`03_model_training.py:360-362`);
- a falsy (0) id yields a zero-length bag — the id is *dropped*, the pooled
  embedding for that sample/feature is zero (`03_model_training.py:358-365`);
  disable with `drop_zero_ids=False` for the "id 0 is a real id" mode;
- labels become int32 (`03_model_training.py:375`).

Instead of jagged (values, lengths) CSR, batches are fixed-shape `[B, L]`
id + mask arrays — XLA-static shapes so the whole train step stays inside one
compiled program. Multi-id bags (lists per row) are padded/truncated to the
feature's `max_ids_per_sample`.
"""

from __future__ import annotations

from typing import Any, Mapping, Sequence

import jax
import numpy as np

from two_tower_recommender_model.config import ModelConfig
from two_tower_recommender_model.utils.pytree import pytree_dataclass


@pytree_dataclass
class SparseFeature:
    """A fixed-shape pooled-bag feature: ids `[B, L]` int32, mask `[B, L]` f32.

    mask[b, l] = 1.0 where ids[b, l] is a real id; padded / dropped slots are 0
    (ids there are forced to 0 and masked out). The dense-shape stand-in for
    the reference's `KeyedJaggedTensor` lengths (`03_model_training.py:363-371`).
    """

    ids: jax.Array
    mask: jax.Array


@pytree_dataclass
class Batch:
    """One training batch (the role of `torchrec.datasets.utils.Batch`,
    reference `03_model_training.py:376-380`).

    `weights` (optional, [B]) marks per-sample validity/importance — padding
    rows carry weight 0 so metrics ignore them (see `pad_batch`)."""

    features: dict[str, SparseFeature]
    labels: jax.Array  # [B] int32
    dense: jax.Array | None = None  # [B, dense_dim] float32 side features
    weights: jax.Array | None = None  # [B] float32 sample weights

    @property
    def batch_size(self) -> int:
        return self.labels.shape[0]


def pad_batch(batch: Batch, multiple: int) -> Batch:
    """Pad to a multiple of `multiple` rows with zero-weight samples, so a
    ragged tail batch can shard across devices without skewing metrics (the
    clean alternative to dropping it). Accepts `Batch` or `PackedBatch`
    (packed rows pad with id 0 = the missing sentinel; `labels` may be the
    empty bit-packed placeholder)."""
    return _pad_rows(batch, (-batch.batch_size) % multiple)


def pad_batch_to(batch: Batch, rows: int) -> Batch:
    """Pad to EXACTLY `rows` rows with zero-weight samples. Unlike `pad_batch`
    this also grows a 0-row batch, which is what multi-host aligned eval needs:
    a host whose data ran out still dispatches all-padding batches of the
    common shape so cross-host collectives line up (`data/loader.py`
    align_hosts="pad")."""
    pad = rows - batch.batch_size
    if pad < 0:
        raise ValueError(f"batch has {batch.batch_size} rows > pad_to={rows}")
    return _pad_rows(batch, pad)


def _pad_rows(batch: Batch, pad: int) -> Batch:
    b = batch.batch_size
    if hasattr(batch, "ids_raw"):  # PackedBatch
        weights = batch.weights
        if weights is None:
            weights = np.ones(b, np.float32)
        if pad == 0:
            return batch.replace(weights=weights)

        def padrows(x):
            return np.concatenate([np.asarray(x), np.zeros((pad,) + x.shape[1:], x.dtype)])

        return batch.replace(
            ids_raw=padrows(batch.ids_raw),
            labels=batch.labels if batch.labels.size == 0 else padrows(batch.labels),
            dense=None if batch.dense is None else padrows(batch.dense),
            weights=padrows(weights),
        )
    if pad == 0 and batch.weights is not None:
        return batch
    weights = batch.weights
    if weights is None:
        weights = np.ones(b, np.float32)
    if pad == 0:
        return batch.replace(weights=weights)

    def padrows(x):
        return np.concatenate([np.asarray(x), np.zeros((pad,) + x.shape[1:], x.dtype)])

    return Batch(
        features={
            k: SparseFeature(ids=padrows(v.ids), mask=padrows(v.mask))
            for k, v in batch.features.items()
        },
        labels=padrows(batch.labels),
        dense=None if batch.dense is None else padrows(batch.dense),
        weights=padrows(weights),
    )


class Featurizer:
    """Builds `Batch`es from dict-of-columns with numpy-vectorized hashing."""

    def __init__(self, model_config: ModelConfig, drop_zero_ids: bool = True,
                 dense_cols: Sequence[str] = (), label_col: str = "label"):
        self.config = model_config
        self.drop_zero_ids = drop_zero_ids
        self.dense_cols = tuple(dense_cols)
        self.label_col = label_col

    def __call__(self, columns: Mapping[str, Any]) -> Batch:
        feats: dict[str, SparseFeature] = {}
        for fc in self.config.features:
            table = self.config.table(fc.table)
            col = np.asarray(columns[fc.name])
            if col.ndim == 1:
                ids = col.reshape(-1, 1)
            elif col.ndim == 2:
                ids = col
            else:
                raise ValueError(f"feature {fc.name!r}: expected 1D or 2D column, got {col.shape}")
            L = fc.max_ids_per_sample
            if ids.shape[1] > L:
                ids = ids[:, :L]
            elif ids.shape[1] < L:
                pad = np.zeros((ids.shape[0], L - ids.shape[1]), dtype=ids.dtype)
                ids = np.concatenate([ids, pad], axis=1)
            ids = ids.astype(np.int64)
            if self.drop_zero_ids:
                mask = (ids != 0).astype(np.float32)
            else:
                mask = np.ones(ids.shape, dtype=np.float32)
            hashed = (ids % table.num_embeddings).astype(np.int32)
            hashed = np.where(mask > 0, hashed, 0).astype(np.int32)
            feats[fc.name] = SparseFeature(ids=hashed, mask=mask)

        labels = np.asarray(columns[self.label_col]).astype(np.int32).reshape(-1)

        dense = None
        if self.dense_cols:
            dense = np.stack(
                [np.asarray(columns[c]).astype(np.float32) for c in self.dense_cols], axis=1
            )
        return Batch(features=feats, labels=labels, dense=dense)

    def ragged(self, feature: str, values: Sequence[Sequence[int]]) -> np.ndarray:
        """Pad a list-of-lists bag column to the feature's `[B, L]` shape.
        (Ragged ingestion helper; jagged lengths become the mask.)"""
        fc = self.config.feature(feature)
        L = fc.max_ids_per_sample
        out = np.zeros((len(values), L), dtype=np.int64)
        for i, row in enumerate(values):
            row = list(row)[:L]
            out[i, : len(row)] = row
        return out
