"""Pooled embedding lookup + sparse backward, XLA reference path.

The compute behind the reference's `EmbeddingBagCollection` forward
(`03_model_training.py:417`, fbgemm-gpu CUDA kernels) re-expressed for XLA:
gather rows, mask, segment-pool over the bag axis. Shapes are static
(`[B, L]` ids + mask from the featurizer) so everything fuses under jit.

The backward is *not* taken through autodiff: `row_grads_from_pooled` converts
the gradient w.r.t. pooled outputs into per-slot row gradients, which the
sparse optimizer scatters into the table — the functional equivalent of
TorchRec's `apply_optimizer_in_backward` fused sparse update
(`03_model_training.py:791-795`) that never materializes a dense table grad in
the autodiff graph.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def pooled_lookup(
    table: jax.Array,  # [N, D]
    ids: jax.Array,  # [B, L] int32, already hashed into [0, N)
    mask: jax.Array,  # [B, L] float
    pooling: str = "sum",
    compute_dtype: jnp.dtype | None = None,
) -> jax.Array:  # [B, D]
    """Gather + masked pool. `mean` divides by the live-slot count (0-length
    bags pool to zero, matching the reference's dropped falsy ids,
    `03_model_training.py:358-365`). Accepts int8 `QuantizedTable` storage
    transparently."""
    from two_tower_recommender_model.ops.quantized import (
        QuantizedTable,
        quantized_pooled_lookup,
    )

    if isinstance(table, QuantizedTable):
        w = mask.astype(jnp.float32)
        if pooling == "mean":
            counts = w.sum(axis=1, keepdims=True)
            w = w / jnp.maximum(counts, 1.0)
        elif pooling != "sum":
            raise ValueError(f"unknown pooling {pooling!r}")
        out = quantized_pooled_lookup(table, ids, w)
        return out.astype(compute_dtype) if compute_dtype is not None else out
    emb = jnp.take(table, ids, axis=0)  # [B, L, D]
    if compute_dtype is not None:
        emb = emb.astype(compute_dtype)
    emb = emb * mask[..., None].astype(emb.dtype)
    pooled = emb.sum(axis=1)
    if pooling == "mean":
        counts = mask.sum(axis=1, keepdims=True).astype(pooled.dtype)
        pooled = pooled / jnp.maximum(counts, 1.0)
    elif pooling != "sum":
        raise ValueError(f"unknown pooling {pooling!r}")
    return pooled


def row_grads_from_pooled(
    pooled_grad: jax.Array,  # [B, D]
    mask: jax.Array,  # [B, L]
    pooling: str = "sum",
) -> jax.Array:  # [B, L, D]
    """Distribute the pooled-output gradient back to each live bag slot.

    d pooled[b] / d row[b, l] = mask[b, l]       (sum pooling)
                              = mask[b, l] / n_b (mean pooling)

    Single-slot fast path: with L == 1 the mask multiply only zeroes DEAD
    slots, and every consumer drops dead slots by the sentinel id anyway
    (`row_grad_flatten` maps mask==0 to id N; the scatter paths drop it)
    — so the [B, D]
    read+write pass the multiply costs is pure overhead (mean pooling's
    n_b is 1 on live single-slot rows). Dead-slot grad VALUES are then
    garbage-but-unused by contract.
    """
    if mask.shape[1] == 1 and pooling in ("sum", "mean"):
        return pooled_grad[:, None, :]
    g = pooled_grad[:, None, :] * mask[..., None].astype(pooled_grad.dtype)
    if pooling == "mean":
        counts = mask.sum(axis=1)[:, None, None].astype(g.dtype)
        g = g / jnp.maximum(counts, 1.0)
    return g


def scatter_add_rows(
    zeros_like_table: jax.Array,  # [N, D]
    ids: jax.Array,  # [B, L]
    row_grads: jax.Array,  # [B, L, D]
) -> jax.Array:
    """Aggregate per-slot gradients by row id (duplicate ids sum — the
    gradient-aggregation semantics of the fused fbgemm backward)."""
    flat_ids = ids.reshape(-1)
    flat_g = row_grads.reshape(-1, row_grads.shape[-1]).astype(zeros_like_table.dtype)
    return zeros_like_table.at[flat_ids].add(flat_g)
