"""Optimizers: fused row-wise Adagrad for embedding tables, Adam for towers.

The reference splits optimization the same way (SURVEY §2.5): sparse tables get
fbgemm's fused `RowWiseAdagrad` applied *in the backward* with no dense table
gradient (`apply_optimizer_in_backward`, `03_model_training.py:791-795`); dense
towers get Adam via `KeyedOptimizerWrapper` (`03_model_training.py:826-829`).

Row-wise Adagrad semantics (fbgemm): per-row accumulator
    acc_row += mean(g_row^2);  row -= lr * g_row / (sqrt(acc_row) + eps)
where g_row is the *aggregated* gradient over duplicate occurrences of the row
in the batch.

Two implementations:
- `sparse_rowwise_adagrad` (default): sort ids, aggregate duplicates with
  segment ops, gather/update/scatter only touched rows — O(B·D) HBM traffic,
  independent of table size. Dead slots carry an out-of-range sentinel id and
  are dropped by `mode="drop"` scatters.
- `dense_rowwise_adagrad`: transient dense-gradient variant (scatter-add into
  a table-shaped buffer). O(N·D) traffic; test oracle + small-table path.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import optax


def row_grad_flatten(
    ids: jax.Array,  # [B, L]
    mask: jax.Array,  # [B, L]
    row_grads: jax.Array,  # [B, L, D]
    num_rows: int,
) -> tuple[jax.Array, jax.Array]:
    """Flatten per-slot grads to ([M] ids, [M, D] grads); dead slots get the
    sentinel id `num_rows` (dropped downstream)."""
    flat_ids = jnp.where(mask.reshape(-1) > 0, ids.reshape(-1), num_rows).astype(jnp.int32)
    flat_g = row_grads.reshape(-1, row_grads.shape[-1])
    return flat_ids, flat_g


def aggregate_grads_by_row(
    flat_ids: jax.Array,  # [M] (sentinel >= n for dead slots)
    flat_grads: jax.Array,  # [M, D]
    n: int,
) -> tuple[jax.Array, jax.Array, jax.Array, jax.Array]:
    """Sort ids and segment-sum duplicate occurrences (fbgemm gradient-
    aggregation semantics). Returns (g_seg [M, D], rep [M] row id per segment,
    valid [M], safe [M] in-range gather index) — shared prologue of every
    fused sparse-update variant."""
    m = flat_ids.shape[0]
    order = jnp.argsort(flat_ids)
    sids = flat_ids[order]
    sg = flat_grads[order].astype(jnp.float32)
    starts = jnp.concatenate([jnp.ones(1, bool), sids[1:] != sids[:-1]])
    seg = jnp.cumsum(starts) - 1  # [M], values in [0, M)
    g_seg = jax.ops.segment_sum(sg, seg, num_segments=m)  # [M, D]
    rep = jax.ops.segment_max(sids, seg, num_segments=m)  # row id (or int min for empty)
    valid = (rep >= 0) & (rep < n)
    safe = jnp.where(valid, rep, 0)
    return g_seg, rep, valid, safe


def sparse_rowwise_adagrad(
    table: jax.Array,  # [N, D]
    acc: jax.Array,  # [N]
    flat_ids: jax.Array,  # [M] (sentinel N for dead)
    flat_grads: jax.Array,  # [M, D]
    lr: float,
    eps: float = 1e-10,
) -> tuple[jax.Array, jax.Array]:
    n, d = table.shape
    g_seg, rep, valid, safe = aggregate_grads_by_row(flat_ids, flat_grads, n)

    rows = table[safe].astype(jnp.float32)
    acc_rows = acc[safe].astype(jnp.float32)
    g2 = jnp.mean(g_seg * g_seg, axis=1)
    new_acc_rows = acc_rows + g2
    denom = jnp.sqrt(new_acc_rows) + eps
    new_rows = rows - lr * g_seg / denom[:, None]

    scatter_idx = jnp.where(valid, rep, n)  # out-of-range => dropped
    new_table = table.at[scatter_idx].set(new_rows.astype(table.dtype), mode="drop")
    new_acc = acc.at[scatter_idx].set(new_acc_rows.astype(acc.dtype), mode="drop")
    return new_table, new_acc


def pick_sparse_update(num_rows: int, batch_slots: int):
    """Update-path policy: the sorted-segment path pays a sort of the batch's
    ids plus segment ops and a scatter, O(B log B + B*D); the transient-dense
    path pays O(N*D) streaming traffic but no sort, so it wins while the batch
    touches a sizable fraction of the table. The crossover N ~ 8*B is
    inherited and has not been measured on the GPU."""
    return dense_rowwise_adagrad if num_rows <= 8 * batch_slots else sparse_rowwise_adagrad


def masked_rowwise_adagrad_epilogue(
    table: jax.Array,  # [N, D]
    acc: jax.Array,  # [N]
    g: jax.Array,  # [N, D] f32 dense aggregated gradient
    touched: jax.Array,  # [N] bool — rows to update
    lr: float,
    eps: float,
) -> tuple[jax.Array, jax.Array]:
    """Row-wise Adagrad over a dense aggregated gradient, applied only to
    `touched` rows — the epilogue of the transient-dense scatter path."""
    g2 = jnp.mean(g * g, axis=1)
    new_acc = jnp.where(touched, acc.astype(jnp.float32) + g2, acc.astype(jnp.float32))
    denom = jnp.sqrt(new_acc) + eps
    new_table = jnp.where(
        touched[:, None], table.astype(jnp.float32) - lr * g / denom[:, None], table
    )
    return new_table.astype(table.dtype), new_acc.astype(acc.dtype)


def dense_rowwise_adagrad(
    table: jax.Array,
    acc: jax.Array,
    flat_ids: jax.Array,
    flat_grads: jax.Array,
    lr: float,
    eps: float = 1e-10,
    *,
    ids_sorted: bool = False,
    buffer_dtype: jnp.dtype | None = None,
) -> tuple[jax.Array, jax.Array]:
    """`ids_sorted=True` asserts `flat_ids` is non-decreasing (host-sorted
    batch, see `TrainConfig.sorted_feature`) and passes the
    `indices_are_sorted` hint to the scatter-adds, the dominant cost of this
    path. `buffer_dtype=bfloat16` additionally aggregates the transient
    gradient buffer in bf16 (opt-in — duplicate-row gradients accumulate at
    reduced precision)."""
    g, touched = scatter_aggregate(flat_ids, flat_grads, table.shape[0],
                                   ids_sorted=ids_sorted, buffer_dtype=buffer_dtype)
    return masked_rowwise_adagrad_epilogue(table, acc, g, touched, lr, eps)


def scatter_aggregate(
    flat_ids: jax.Array,  # [M] (sentinel >= n for dead slots)
    flat_grads: jax.Array,  # [M, D]
    n: int,
    *,
    ids_sorted: bool = False,
    buffer_dtype: jnp.dtype | None = None,
) -> tuple[jax.Array, jax.Array]:
    """Scatter-add duplicate occurrences into a transient [n, D] buffer —
    the prologue of the transient-dense updates. Returns (g [n, D] f32,
    touched [n] bool)."""
    buf_dtype = jnp.float32 if buffer_dtype is None else buffer_dtype
    g = (
        jnp.zeros((n, flat_grads.shape[-1]), buf_dtype)
        .at[flat_ids]
        .add(flat_grads.astype(buf_dtype), mode="drop", indices_are_sorted=ids_sorted)
        .astype(jnp.float32)
    )
    touched = (
        jnp.zeros((n,), bool)
        .at[flat_ids]
        .set(True, mode="drop", indices_are_sorted=ids_sorted)
    )
    return g, touched


def sparse_rowwise_adagrad_columns(
    table_cols: jax.Array,  # [N, D_local] — this device's column slice
    acc: jax.Array,  # [N] row accumulators (replicated across column shards)
    flat_ids: jax.Array,  # [M] (sentinel N for dead)
    flat_grads_cols: jax.Array,  # [M, D_local] grads for the local columns
    lr: float,
    eps: float,
    full_dim: int,
    psum_axis=None,
) -> tuple[jax.Array, jax.Array]:
    """Row-wise Adagrad for a column-sharded table: the accumulator is per
    FULL row, so the squared-gradient reduction spans all column shards
    (psum over `psum_axis`); the weight update touches only local columns.
    Deterministic given sorted ids, so the replicated accumulator stays in
    sync across shards."""
    n, d_local = table_cols.shape
    g_seg, rep, valid, safe = aggregate_grads_by_row(flat_ids, flat_grads_cols, n)

    g2_local = jnp.sum(g_seg * g_seg, axis=1)  # partial sum over local columns
    if psum_axis is not None:
        g2 = jax.lax.psum(g2_local, psum_axis) / full_dim
    else:
        g2 = g2_local / full_dim

    rows = table_cols[safe].astype(jnp.float32)
    acc_rows = acc[safe].astype(jnp.float32)
    new_acc_rows = acc_rows + g2
    denom = jnp.sqrt(new_acc_rows) + eps
    new_rows = rows - lr * g_seg / denom[:, None]

    scatter_idx = jnp.where(valid, rep, n)
    new_table = table_cols.at[scatter_idx].set(new_rows.astype(table_cols.dtype), mode="drop")
    new_acc = acc.at[scatter_idx].set(new_acc_rows.astype(acc.dtype), mode="drop")
    return new_table, new_acc


def dense_optimizer(
    learning_rate: float,
    schedule: str = "constant",
    total_steps: int | None = None,
    warmup_steps: int = 0,
    end_factor: float = 0.0,
    weight_decay: float = 0.0,
) -> optax.GradientTransformation:
    """Adam for the dense towers (`03_model_training.py:826-829`), with the
    Composer stack's LR-schedule options (`DecoupledAdamW` + `LinearLR`,
    `pytorch-model-training.py:563-575`):

    - "constant": plain Adam (reference default)
    - "linear": linear decay from lr to lr*end_factor over total_steps
    - "cosine": cosine decay, optional warmup
    """
    if schedule == "constant":
        lr = optax.constant_schedule(learning_rate) if warmup_steps else learning_rate
    elif schedule == "linear":
        if total_steps is None:
            raise ValueError("linear schedule requires total_steps")
        lr = optax.linear_schedule(learning_rate, learning_rate * end_factor,
                                   total_steps - warmup_steps)
    elif schedule == "cosine":
        if total_steps is None:
            raise ValueError("cosine schedule requires total_steps")
        lr = optax.cosine_decay_schedule(learning_rate, total_steps - warmup_steps,
                                         alpha=end_factor)
    else:
        raise ValueError(f"unknown schedule {schedule!r}")
    if warmup_steps:
        lr = optax.join_schedules(
            [optax.linear_schedule(0.0, learning_rate, warmup_steps), lr], [warmup_steps]
        )
    if weight_decay:
        return optax.adamw(lr, weight_decay=weight_decay)  # DecoupledAdamW role
    return optax.adam(lr)
