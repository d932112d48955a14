"""Device-side featurization: host packs raw ids, the device does the rest.

The reference's batch transform runs per-element Python on the host and is its
known CPU bottleneck (`transform_to_torchrec_batch`, `03_model_training.py:
353-380`; SURVEY §3.1). The numpy `Featurizer` already vectorizes it; this
module removes the host from the picture almost entirely:

- host side (`PackedFeaturizer`): stack the raw id columns into ONE int32
  array `[B, total_slots]` (+ labels, + optional dense) — a memcpy, one
  device transfer;
- device side (`unpack_batch`): hashing (`id % num_embeddings`), the
  falsy-id drop mask, and dtype casts trace into the same jit program as the
  train step, where they fuse to ~zero cost on the VPU.

`make_packed_train_step` / `make_packed_eval_step` wrap the standard steps
with the unpack. Same numerics as the host featurizer (tested equal).
"""

from __future__ import annotations

from typing import Mapping

import jax
import jax.numpy as jnp
import numpy as np

from two_tower_recommender_model.config import ModelConfig
from two_tower_recommender_model.data.featurizer import Batch, SparseFeature
from two_tower_recommender_model.utils.pytree import pytree_dataclass


@pytree_dataclass
class PackedBatch:
    """Transfer-optimal batch: one id tensor, one label tensor."""

    ids_raw: jax.Array  # [B, total_slots] int32 raw (unhashed) ids
    labels: jax.Array  # [B] int32 ([0] when the label bit is packed into ids_raw)
    dense: jax.Array | None = None
    weights: jax.Array | None = None  # [B] f32; zero-weight rows are padding

    @property
    def batch_size(self) -> int:
        return self.ids_raw.shape[0]


def _sort_slot_offset(model_cfg: ModelConfig, sort_feature: str) -> tuple[int, int]:
    """(slot offset, num_embeddings) of a single-slot sort feature."""
    off = 0
    for fc in model_cfg.features:
        if fc.name == sort_feature:
            if fc.max_ids_per_sample != 1:
                raise ValueError(f"sort_feature {sort_feature!r} must be single-slot")
            return off, model_cfg.feature_table(sort_feature).num_embeddings
        off += fc.max_ids_per_sample
    raise ValueError(f"sort_feature {sort_feature!r}: no such feature")


def sort_packed_batch(
    pb: PackedBatch, slot_off: int, num_embeddings: int, pack_label: bool
) -> PackedBatch:
    """Reorder batch rows so the designated slot's HASHED ids are
    non-decreasing, with missing ids (raw==0) last — exactly the flat-id key
    the update path sees (`row_grad_flatten` maps masked slots to sentinel N).
    Row order within a batch is loss-invariant (the losses reduce over rows;
    the in-batch softmax permutes both towers consistently), so this only
    buys the `indices_are_sorted` scatter fast path (DESIGN §6c)."""
    col = np.asarray(pb.ids_raw[:, slot_off])
    if pack_label and slot_off == 0:
        col = col & ((1 << 30) - 1)
    key = col % num_embeddings
    key = np.where(col == 0, num_embeddings, key)
    # stable argsort via one int64 sort of (key << 32 | row): ~3 ms at
    # B=262k vs ~30 ms for np.argsort(kind="stable") on int32 keys — ties
    # break by row index, so the order is stable by construction (key fits
    # 31 bits: num_embeddings < 2^30)
    comb = key.astype(np.int64) << 32
    comb |= np.arange(key.shape[0], dtype=np.int64)
    comb.sort()
    order = comb.astype(np.int32)  # low 32 bits = original row index
    return PackedBatch(
        ids_raw=np.ascontiguousarray(pb.ids_raw[order]),
        labels=pb.labels[order] if pb.labels.size else pb.labels,
        dense=None if pb.dense is None else np.ascontiguousarray(pb.dense[order]),
        weights=None if pb.weights is None else pb.weights[order],
    )


class PackedFeaturizer:
    """Host half: dict-of-columns -> PackedBatch (no hashing, no masks).

    `sort_feature` names a single-slot feature to sort each batch's rows by
    (hashed key, missing last) — see `sort_packed_batch`."""

    def __init__(self, model_cfg: ModelConfig, dense_cols: tuple[str, ...] = (),
                 label_col: str = "label", pack_label: bool = False,
                 sort_feature: str | None = None):
        """`pack_label=True` steals bit 30 of slot 0 for the binary label, so
        the whole batch ships as ONE int32 array (8B/example for the flagship
        two-feature model instead of 12B — worthwhile when H2D bandwidth, not
        the chip, bounds throughput). Requires every table < 2^30 rows and
        binary labels; `unpack_batch` must be called with the same flag."""
        self.config = model_cfg
        self.dense_cols = tuple(dense_cols)
        self.label_col = label_col
        self.pack_label = pack_label
        if pack_label:
            for t in model_cfg.tables:
                if t.num_embeddings >= (1 << 30):
                    raise ValueError(f"pack_label needs tables < 2^30 rows; {t.name} too big")
        self.slots: list[tuple[str, int, int]] = [
            (fc.name, fc.max_ids_per_sample, model_cfg.feature_table(fc.name).num_embeddings)
            for fc in model_cfg.features
        ]
        self.total_slots = sum(s for _, s, _ in self.slots)
        self.sort_feature = sort_feature
        self._sort = (
            _sort_slot_offset(model_cfg, sort_feature) if sort_feature else None
        )

    @staticmethod
    def _fit_int32(
        col: np.ndarray, num_embeddings: int, lo: int | None = None, hi: int | None = None
    ) -> np.ndarray:
        """Raw ids outside the representable window [lo, hi] are pre-hashed on
        host into a value that preserves both semantics the device recomputes:
        the modulo hash (`v % N == raw % N`) and the missing-id mask
        (`v == 0  <=>  raw == 0`, using N itself — which hashes to 0 — as the
        nonzero stand-in). The window is checked by VALUE for every dtype:
        unsigned 32-bit ids >= 2^31 would wrap negative on int32 assignment,
        and 64-bit ids can exceed either side."""
        info = np.iinfo(np.int32)
        lo = info.min if lo is None else lo
        hi = info.max if hi is None else hi
        if not col.size or (col.min(initial=0) >= lo and col.max(initial=0) <= hi):
            return col
        v = col % num_embeddings
        return np.where((col != 0) & (v == 0), num_embeddings, v)

    def __call__(self, columns: Mapping[str, np.ndarray]) -> PackedBatch:
        first = np.asarray(columns[self.label_col])
        b = len(first)
        ids = np.zeros((b, self.total_slots), np.int32)
        off = 0
        for name, L, num_embeddings in self.slots:
            # pack_label steals bit 30 of the FIRST feature's ids; raw ids in
            # [2^30, 2^31) (legal under id % N hashing) would corrupt the
            # label bit, so pre-hash that feature into [0, 2^30) at pack time
            lo, hi = (0, (1 << 30) - 1) if self.pack_label and off == 0 else (None, None)
            col = self._fit_int32(np.asarray(columns[name]), num_embeddings, lo, hi)
            if col.ndim == 1:
                ids[:, off] = col
            else:
                take = min(col.shape[1], L)
                ids[:, off : off + take] = col[:, :take]
            off += L
        dense = None
        if self.dense_cols:
            dense = np.stack(
                [np.asarray(columns[c]).astype(np.float32) for c in self.dense_cols], axis=1
            )
        labels = first.astype(np.int32)
        if self.pack_label:
            np.bitwise_or(ids[:, 0], labels << 30, out=ids[:, 0])
            labels = np.zeros(0, np.int32)  # carried inside ids_raw
        pb = PackedBatch(ids_raw=ids, labels=labels, dense=dense)
        if self._sort is not None:
            pb = sort_packed_batch(pb, *self._sort, self.pack_label)
        return pb


def unpack_batch(packed: PackedBatch, model_cfg: ModelConfig,
                 drop_zero_ids: bool = True, pack_label: bool = False) -> Batch:
    """Device half (jit-traceable): slices + hash + mask, fusing into the
    consumer program."""
    ids_raw = packed.ids_raw
    labels = packed.labels
    if pack_label:
        labels = (ids_raw[:, 0] >> 30) & 1
        ids_raw = ids_raw.at[:, 0].set(ids_raw[:, 0] & ((1 << 30) - 1))
    feats: dict[str, SparseFeature] = {}
    off = 0
    for fc in model_cfg.features:
        L = fc.max_ids_per_sample
        raw = jax.lax.slice_in_dim(ids_raw, off, off + L, axis=1)
        table = model_cfg.table(fc.table)
        hashed = (raw % table.num_embeddings).astype(jnp.int32)
        if drop_zero_ids:
            mask = (raw != 0).astype(jnp.float32)
            hashed = jnp.where(raw != 0, hashed, 0)
        else:
            mask = jnp.ones(raw.shape, jnp.float32)
        feats[fc.name] = SparseFeature(ids=hashed, mask=mask)
        off += L
    return Batch(features=feats, labels=labels, dense=packed.dense,
                 weights=packed.weights)


def make_packed_train_step(train_step, model_cfg: ModelConfig, drop_zero_ids: bool = True,
                           pack_label: bool = False):
    """Wrap a (state, Batch) train step to take PackedBatch."""
    import functools

    @functools.wraps(train_step)
    def step(state, packed: PackedBatch):
        return train_step(state, unpack_batch(packed, model_cfg, drop_zero_ids, pack_label))

    return jax.jit(step, donate_argnums=(0,))


def make_packed_eval_step(eval_step, model_cfg: ModelConfig, drop_zero_ids: bool = True,
                          pack_label: bool = False):
    @jax.jit
    def step(state, eval_state, packed: PackedBatch):
        return eval_step(
            state, eval_state, unpack_batch(packed, model_cfg, drop_zero_ids, pack_label)
        )

    return step
