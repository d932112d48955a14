"""Int8 quantized embedding tables: 4x less HBM per gather.

Production embedding tables are HBM-bound; storing rows as int8 with a
per-row scale quarters both the memory footprint and the gather traffic
(the same motivation as fbgemm's int8/int4 `EmbeddingBag` variants, which the
reference's stack supports via TorchRec quantized inference). Scheme:

    row_f32 ≈ values_int8 * (scale_row / 127),  scale_row = max|row|

- lookup: gather int8 rows + f32 scales, dequantize, pool;
- training update: dequantize the touched rows, apply row-wise Adagrad in
  f32 (accumulators stay f32, as in the bf16-storage mode), re-quantize with
  a fresh per-row absmax, scatter back. Quantization error behaves as
  stochastic-rounding-free PTQ; for dim-128 rows the per-step SNR is high
  enough that short-horizon training tracks f32 closely (tested).

`ModelConfig.table_dtype="int8"` switches the whole stack over; tables inside
`TrainState` become `QuantizedTable` pytrees, so checkpointing/donation work
unchanged. Export dequantizes to f32 for the portable saved-model.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from two_tower_recommender_model.utils.pytree import pytree_dataclass, static_field


@pytree_dataclass
class QuantizedTable:
    """int8 rows + per-row scales. `packed=True` stores the SAME bytes as
    int32 words `[N, D/4]` (4 int8 per word), so row gathers and scatters
    move whole 32-bit words; un/packing happens only at [M]-batch scale.
    `shape`/`dtype` report the LOGICAL [N, D] int8 table either way. Packed
    engages automatically past PACKED_STORAGE_MIN_ROWS (single-device path;
    the sharded state builder requires the unpacked format and gates on
    `.packed`)."""

    values: jax.Array  # [N, D] int8, or [N, D//4] int32 when packed
    scales: jax.Array  # [N] f32 (absmax of the row)
    packed: bool = static_field(default=False)

    @property
    def shape(self):
        n, w = self.values.shape
        return (n, w * 4) if self.packed else (n, w)

    @property
    def dtype(self):
        return jnp.dtype(jnp.int8)  # logical storage dtype


# int8 tables at least this large store packed (int32 words). The threshold
# answers a compile-time memory wall of the accelerator this code was first
# written for (its s8 row gather and scatter went through table-sized
# temporaries); it has not been re-derived on the GPU. Kept above every size
# the sharded path supports today.
PACKED_STORAGE_MIN_ROWS = 16_000_000


def pack_int8_values(values: jax.Array) -> jax.Array:
    """[N, D] int8 -> [N, D//4] int32 words (same bytes)."""
    n, d = values.shape
    assert d % 4 == 0, d
    return jax.lax.bitcast_convert_type(values.reshape(n, d // 4, 4), jnp.int32)


def unpack_int8_values(words: jax.Array, d: int) -> jax.Array:
    """[..., D//4] int32 words -> [..., D] int8 (same bytes)."""
    return jax.lax.bitcast_convert_type(words, jnp.int8).reshape(
        *words.shape[:-1], d)


def qt_gather_rows_scales(qt: QuantizedTable, ids: jax.Array):
    """(values[ids] int8, scales[ids]) for either storage format; the
    packed arm's word gather is a native s32 take (no u32 emulation),
    unpacked at [M] scale only."""
    if qt.packed:
        d = qt.shape[1]
        words = jnp.take(qt.values, ids.reshape(-1), axis=0)
        return (unpack_int8_values(words, d).reshape(*ids.shape, d),
                jnp.take(qt.scales, ids, axis=0))
    return gather_int8_rows_scales(qt.values, qt.scales, ids)


def qt_scatter_rows(qt: QuantizedTable, scatter_idx: jax.Array,
                    new_rows: jax.Array) -> jax.Array:
    """New `values` array with rows replaced (out-of-range idx dropped),
    for either storage format."""
    if qt.packed:
        d = qt.shape[1]
        rows_w = jax.lax.bitcast_convert_type(
            new_rows.reshape(-1, d // 4, 4), jnp.int32)
        return qt.values.at[scatter_idx].set(rows_w, mode="drop")
    return scatter_int8_rows(qt.values, scatter_idx, new_rows)


def _quantize_rows(rows: jax.Array) -> tuple[jax.Array, jax.Array]:
    """(int8 values, f32 absmax scales) for a row block."""
    scales = jnp.max(jnp.abs(rows), axis=1)
    denom = jnp.where(scales > 0, scales, 1.0)
    q = jnp.clip(jnp.round(rows / denom[:, None] * 127.0), -127, 127).astype(jnp.int8)
    return q, scales


def quantize_table(table: jax.Array, row_chunk: int = 1 << 21,
                   packed: bool = False) -> QuantizedTable:
    """Row-local quantization, CHUNKED past `row_chunk` rows: one-shot
    `_quantize_rows` materializes f32 temporaries the size of the table
    (abs / the division), which at 20M x 128 means another ~10 GB on top of
    the f32 input. Chunking
    bounds the transient to `row_chunk` rows with identical results (the
    quantization is per-row)."""
    n = table.shape[0]
    maybe_pack = pack_int8_values if packed else (lambda q: q)
    if n <= row_chunk:
        q, scales = _quantize_rows(table.astype(jnp.float32))
        return QuantizedTable(values=maybe_pack(q), scales=scales, packed=packed)
    qs, ss = [], []
    for start in range(0, n, row_chunk):
        stop = min(start + row_chunk, n)
        q, s = _quantize_rows(
            jax.lax.slice_in_dim(table, start, stop).astype(jnp.float32))
        qs.append(maybe_pack(q))
        ss.append(s)
    return QuantizedTable(values=jnp.concatenate(qs), scales=jnp.concatenate(ss),
                          packed=packed)


def init_quantized_table(rng: jax.Array, num_embeddings: int, dim: int,
                         row_chunk: int = 1 << 21,
                         packed: bool = False) -> QuantizedTable:
    """Direct int8 init for beyond-f32-capacity tables: per chunk, draw the
    EmbeddingBag-style U(-sqrt(1/N), sqrt(1/N)) rows in f32 and quantize —
    only one f32 chunk is ever live, so a 40M-row int8 table (5.1 GB)
    initializes without the 20 GB full f32 intermediate
    (`models/two_tower.py: init_params` skips these; `create_train_state`
    calls here). Chunk keys fold the chunk index, so values differ from a
    hypothetical full-table draw — irrelevant at this scale (both are the
    same iid distribution)."""
    bound = (1.0 / num_embeddings) ** 0.5
    maybe_pack = pack_int8_values if packed else (lambda q: q)
    qs, ss = [], []
    for i, start in enumerate(range(0, num_embeddings, row_chunk)):
        rows = min(row_chunk, num_embeddings - start)
        chunk = jax.random.uniform(
            jax.random.fold_in(rng, i), (rows, dim), jnp.float32, -bound, bound)
        q, s = _quantize_rows(chunk)
        qs.append(maybe_pack(q))
        ss.append(s)
    return QuantizedTable(values=jnp.concatenate(qs) if len(qs) > 1 else qs[0],
                          scales=jnp.concatenate(ss) if len(ss) > 1 else ss[0],
                          packed=packed)


def dequantize_table(qt: QuantizedTable) -> jax.Array:
    vals = (unpack_int8_values(qt.values, qt.shape[1]) if qt.packed
            else qt.values)
    return vals.astype(jnp.float32) * (qt.scales[:, None] / 127.0)


# tables at least this large skip the packed rows+scales gather (its packed
# int32 view is a table-sized copy per call; see gather_int8_rows_scales)
PACK_GATHER_MAX_ROWS = 1_000_000


def gather_int8_rows(values: jax.Array, ids: jax.Array) -> jax.Array:
    """`jnp.take(values, ids, axis=0)` for an int8 [N, D] table, gathering
    through an int32 bitcast view when D % 4 == 0 (byte-identical)."""
    n, d = values.shape
    if d % 4:
        return jnp.take(values, ids, axis=0)
    packed = jax.lax.bitcast_convert_type(
        values.reshape(n, d // 4, 4), jnp.int32
    )  # [N, D/4] int32
    rows = jnp.take(packed, ids, axis=0)  # [..., D/4] int32
    return jax.lax.bitcast_convert_type(rows, jnp.int8).reshape(*ids.shape, d)


def gather_int8_rows_scales(
    values: jax.Array,  # [N, D] int8
    scales: jax.Array,  # [N] f32
    ids: jax.Array,  # any int shape
) -> tuple[jax.Array, jax.Array]:  # ([..., D] int8, [...] f32)
    """(values[ids], scales[ids]) as ONE fused row gather.

    A separate per-id scale gather is an elementwise random gather of 4-byte
    values; packing values+scale into a [N, D/4+1] int32 view lets the
    scale ride in the gathered row, at the cost of one sequential stream
    over the table (~7 MB at the flagship item table). Which one wins on
    the GPU has not been measured. Byte-identical values/scales; D % 4 != 0
    falls back to the two plain takes."""
    n, d = values.shape
    if d % 4:
        return jnp.take(values, ids, axis=0), jnp.take(scales, ids, axis=0)
    if n >= PACK_GATHER_MAX_ROWS:
        # the packed view is a TABLE-SIZED int32 copy (concat defeats the
        # free bitcast) rebuilt every step inside a scan whose carry is the
        # table — at 20M rows it double-buffers to ~5 GB. Past this
        # threshold the row
        # bitcast-gather (no materialization) + a separate scale take wins
        # on memory and on the copy's ~2x-table traffic per step.
        return gather_int8_rows(values, ids), jnp.take(scales, ids, axis=0)
    packed = jnp.concatenate(
        [
            jax.lax.bitcast_convert_type(values.reshape(n, d // 4, 4), jnp.int32),
            jax.lax.bitcast_convert_type(scales[:, None].astype(jnp.float32), jnp.int32),
        ],
        axis=1,
    )  # [N, D/4 + 1] int32
    rows = jnp.take(packed, ids.reshape(-1), axis=0)
    vals = jax.lax.bitcast_convert_type(rows[:, : d // 4], jnp.int8)
    scl = jax.lax.bitcast_convert_type(rows[:, d // 4], jnp.float32)
    return vals.reshape(*ids.shape, d), scl.reshape(ids.shape)


def scatter_int8_rows(
    values: jax.Array,  # [N, D] int8
    scatter_idx: jax.Array,  # [M] (out-of-range -> dropped)
    new_rows: jax.Array,  # [M, D] int8
) -> jax.Array:
    """`values.at[idx].set(rows, mode="drop")` through an int32 bitcast view
    when D % 4 == 0 — byte-identical: the scatter moves whole 32-bit words
    and the bitcasts are free reinterpretation."""
    n, d = values.shape
    if d % 4:
        return values.at[scatter_idx].set(new_rows, mode="drop")
    packed = jax.lax.bitcast_convert_type(values.reshape(n, d // 4, 4), jnp.int32)
    rows_p = jax.lax.bitcast_convert_type(
        new_rows.reshape(-1, d // 4, 4), jnp.int32)
    out = packed.at[scatter_idx].set(rows_p, mode="drop")
    return jax.lax.bitcast_convert_type(out, jnp.int8).reshape(n, d)


def quantized_pooled_lookup(
    qt: QuantizedTable,
    ids: jax.Array,  # [B, L]
    w: jax.Array,  # [B, L] weights (0 = dead slot)
) -> jax.Array:  # [B, D] f32
    rows_q, scales = qt_gather_rows_scales(qt, ids)
    rows = rows_q.astype(jnp.float32) * (scales / 127.0)[..., None]  # [B, L, D]
    return (rows * w[..., None]).sum(axis=1)


def quantized_rowwise_adagrad(
    qt: QuantizedTable,
    acc: jax.Array,  # [N] f32
    flat_ids: jax.Array,  # [M] (sentinel N for dead)
    flat_grads: jax.Array,  # [M, D]
    lr: float,
    eps: float = 1e-10,
) -> tuple[QuantizedTable, jax.Array]:
    """Row-wise Adagrad on int8 storage: dequantize touched rows, f32 update,
    re-quantize. Same sorted-segment aggregation as the f32 path."""
    from two_tower_recommender_model.train.optimizer import aggregate_grads_by_row

    n, d = qt.shape
    g_seg, rep, valid, safe = aggregate_grads_by_row(flat_ids, flat_grads, n)

    rows_q, row_scales = qt_gather_rows_scales(qt, safe)
    rows_q = rows_q.astype(jnp.float32)
    rows = rows_q * (row_scales[:, None] / 127.0)
    acc_rows = acc[safe]
    g2 = jnp.mean(g_seg * g_seg, axis=1)
    new_acc_rows = acc_rows + g2
    new_rows = rows - lr * g_seg / (jnp.sqrt(new_acc_rows) + eps)[:, None]

    new_q, new_scales = _quantize_rows(new_rows)

    scatter_idx = jnp.where(valid, rep, n)
    return (
        QuantizedTable(
            values=qt_scatter_rows(qt, scatter_idx, new_q),
            scales=qt.scales.at[scatter_idx].set(new_scales, mode="drop"),
            packed=qt.packed,
        ),
        acc.at[scatter_idx].set(new_acc_rows, mode="drop"),
    )


def quantized_dense_rowwise_adagrad(
    qt: QuantizedTable,
    acc: jax.Array,
    flat_ids: jax.Array,
    flat_grads: jax.Array,
    lr: float,
    eps: float = 1e-10,
    *,
    ids_sorted: bool = False,
    buffer_dtype: jnp.dtype | None = None,
) -> tuple[QuantizedTable, jax.Array]:
    """Transient-dense variant (the int8 form of
    `train.optimizer.dense_rowwise_adagrad`): scatter-add the batch grads
    into an [N, D] buffer, dequantize/update/requantize with a touched-row
    mask — no sorts. Untouched rows keep their exact stored bytes. Wins when
    the batch touches a sizable table fraction (same crossover as f32).
    `ids_sorted`/`buffer_dtype` mirror the f32 sorted-scatter fast path."""
    assert not qt.packed, (
        "the transient-dense quantized update materializes [N, D] — only "
        "small tables pick it, never packed storage (pick_quantized_update)"
    )
    from two_tower_recommender_model.train.optimizer import scatter_aggregate

    g, touched = scatter_aggregate(flat_ids, flat_grads, qt.values.shape[0],
                                   ids_sorted=ids_sorted, buffer_dtype=buffer_dtype)
    g2 = jnp.mean(g * g, axis=1)
    new_acc = jnp.where(touched, acc + g2, acc)
    rows = qt.values.astype(jnp.float32) * (qt.scales[:, None] / 127.0)
    new_rows = rows - lr * g / (jnp.sqrt(new_acc) + eps)[:, None]
    q, scales = _quantize_rows(new_rows)
    return (
        QuantizedTable(
            values=jnp.where(touched[:, None], q, qt.values),
            scales=jnp.where(touched, scales, qt.scales),
        ),
        new_acc,
    )


def pick_quantized_update(num_rows: int, batch_slots: int):
    """Same policy as `train.optimizer.pick_sparse_update`, int8 storage."""
    return (
        quantized_dense_rowwise_adagrad
        if num_rows <= 8 * batch_slots
        else quantized_rowwise_adagrad
    )
