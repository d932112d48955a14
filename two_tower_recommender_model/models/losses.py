"""Losses.

- `bce_with_logits` — parity with the reference training objective
  (`nn.BCEWithLogitsLoss` over dot-product logits, `03_model_training.py:444-453`).
- `weighted_bce_with_logits` — the per-interaction-type weighted variant
  (`ray_tune_optuna_tuning_alex_test.py:308-318`).
- `in_batch_sampled_softmax` — the retrieval objective: every other
  positive item in the batch is a negative (one `[B, B]` matmul instead of
  offline negative mining), with optional logQ sampling-bias correction and
  accidental-hit masking. This is the north-star loss (BASELINE.json) — the
  offline-negative BCE mode remains the parity default.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def bce_per_example(logits: jax.Array, labels: jax.Array) -> jax.Array:
    """Element-wise binary cross-entropy on logits (numerically stable form)."""
    labels = labels.astype(logits.dtype)
    return jnp.maximum(logits, 0) - logits * labels + jnp.log1p(jnp.exp(-jnp.abs(logits)))


def bce_with_logits(logits: jax.Array, labels: jax.Array, weights: jax.Array | None = None) -> jax.Array:
    """Mean binary cross-entropy on logits (numerically stable form)."""
    per = bce_per_example(logits, labels)
    if weights is not None:
        per = per * weights.astype(per.dtype)
        return per.sum() / jnp.maximum(weights.sum(), 1.0)
    return per.mean()


def weighted_bce_with_logits(
    logits: jax.Array, labels: jax.Array, type_onehot: jax.Array, type_weights: jax.Array
) -> jax.Array:
    """BCE weighted per interaction type, types given as one-hot dense columns
    (`ray_tune_optuna_tuning_alex_test.py:308-318`)."""
    weights = type_onehot.astype(logits.dtype) @ type_weights.astype(logits.dtype)
    return bce_with_logits(logits, labels, weights)


def in_batch_sampled_softmax(
    query_emb: jax.Array,  # [B, D]
    cand_emb: jax.Array,  # [B, D]
    labels: jax.Array,  # [B] — only rows with label==1 contribute (their item is the positive)
    item_ids: jax.Array | None = None,  # [B] raw ids for accidental-hit masking
    log_q: jax.Array | None = None,  # [B] log sampling probability of each in-batch item
    temperature: float = 1.0,
) -> jax.Array:
    """Sampled softmax over in-batch negatives.

    scores[i, j] = <q_i, c_j> / T; row i's positive is column i. Rows whose
    label is 0 (offline negatives, if present in the batch) are dropped from
    the loss but still serve as negatives columns. logQ correction subtracts
    the (estimated) log-probability that item j appears in the batch, removing
    popular-item bias. Columns with the same item id as the row's positive are
    masked out (accidental hits).
    """
    b = query_emb.shape[0]
    chunk = _auto_row_chunk(b)
    if chunk is not None:
        return _chunked_sampled_softmax(
            query_emb, cand_emb, labels, item_ids, log_q, temperature, chunk
        )
    if b > 4096:
        # no usable divisor (odd large batch): pad to a chunkable size and
        # mask the pad columns out of every denominator — NEVER fall back to
        # the dense [B, B] matrix at sizes where it would blow HBM
        r = 512
        pad = (-b) % r
        zpad = lambda x, w: jnp.pad(x, ((0, w),) + ((0, 0),) * (x.ndim - 1))  # noqa: E731
        return _chunked_sampled_softmax(
            zpad(query_emb, pad), zpad(cand_emb, pad), zpad(labels, pad),
            None if item_ids is None else jnp.pad(item_ids, (0, pad),
                                                  constant_values=-1),
            None if log_q is None else zpad(log_q, pad),
            temperature, r, n_valid=b,
        )
    scores = jnp.dot(query_emb, cand_emb.T, preferred_element_type=jnp.float32) / temperature
    if log_q is not None:
        scores = scores - log_q[None, :].astype(scores.dtype)
    eye = jnp.eye(b, dtype=bool)
    if item_ids is not None:
        dup = item_ids[None, :] == item_ids[:, None]
        mask = dup & ~eye
        scores = jnp.where(mask, -1e9, scores)
    logprobs = jax.nn.log_softmax(scores, axis=1)
    per_row = -jnp.diagonal(logprobs)
    w = labels.astype(per_row.dtype)
    return (per_row * w).sum() / jnp.maximum(w.sum(), 1.0)


def _auto_row_chunk(b: int, target_block: int = 1 << 24) -> int | None:
    """Row-chunk size for the blockwise softmax: keep each [R, B] score block
    near `target_block` f32 elements (~64MB). None = the dense path (small
    batches, or no power-of-2 divisor)."""
    if b <= 4096:
        return None
    r = max(8, target_block // b)
    r = 1 << (r.bit_length() - 1)  # floor to a power of 2
    while r > 1 and b % r:
        r >>= 1
    return r if 1 < r < b and b % r == 0 else None


def _chunked_sampled_softmax(q, c, labels, item_ids, log_q, temperature, r,
                             n_valid: int | None = None):
    """Blockwise in-batch softmax: scan over [R, B] row blocks of the score
    matrix with per-block rematerialization, so the O(B^2) scores never
    materialize (1 GB at bs=16k; 275 GB — impossible — at the bs=262k
    flagship batch). Each row's logsumexp is computed whole within its block,
    so the math is IDENTICAL to the dense path (only the final sum over
    blocks reorders f32 additions)."""
    b, d = q.shape
    nch = b // r
    ct = c.T.astype(q.dtype)  # [D, B], shared by every block
    adj = None if log_q is None else log_q.astype(jnp.float32)
    cols = jnp.arange(b, dtype=jnp.int32)

    def block_loss(qc, lab_c, ids_c, base):
        scores = jnp.dot(qc, ct, preferred_element_type=jnp.float32) / temperature
        if adj is not None:
            scores = scores - adj[None, :]
        if n_valid is not None and n_valid < b:
            # pad columns must not act as in-batch negatives
            scores = jnp.where((cols >= n_valid)[None, :], -1e9, scores)
        rows = base + jnp.arange(r, dtype=jnp.int32)
        eye = rows[:, None] == cols[None, :]
        if item_ids is not None:
            dup = item_ids[None, :] == ids_c[:, None]
            scores = jnp.where(dup & ~eye, -1e9, scores)
        lse = jax.nn.logsumexp(scores, axis=1)
        pos = jnp.sum(jnp.where(eye, scores, 0.0), axis=1)  # s_ii
        w = lab_c.astype(jnp.float32)
        return ((lse - pos) * w).sum(), w.sum()

    block_loss = jax.checkpoint(block_loss)  # bwd recomputes each block

    ids_chunks = (
        jnp.zeros((nch, r), jnp.int32) if item_ids is None
        else item_ids.reshape(nch, r)
    )

    def body(carry, xs):
        tot, cnt = carry
        s, n = block_loss(*xs)
        return (tot + s, cnt + n), None

    (tot, cnt), _ = jax.lax.scan(
        body, (jnp.float32(0.0), jnp.float32(0.0)),
        (q.reshape(nch, r, d), labels.reshape(nch, r), ids_chunks,
         jnp.arange(nch, dtype=jnp.int32) * r),
    )
    return tot / jnp.maximum(cnt, 1.0)


def item_log_q_from_counts(counts: jax.Array, item_ids: jax.Array) -> jax.Array:
    """logQ per in-batch item from a corpus count table (empirical sampling
    probability) — the standard popularity-bias correction for in-batch
    negatives. `counts` is [num_items] occurrence counts (offline or
    streaming); returns log(count_i / total) for each batch item."""
    counts = counts.astype(jnp.float32)
    total = jnp.maximum(counts.sum(), 1.0)
    c = jnp.maximum(counts[item_ids], 1.0)
    return jnp.log(c / total)


def make_loss_fn(
    name: str,
    candidate_id_feature: str | None = None,
    type_weights: tuple[float, ...] | None = None,
    type_onehot_start: int = 0,
    temperature: float = 1.0,
):
    """Loss factory. For "sampled_softmax", `candidate_id_feature` names the
    batch feature whose first-slot ids identify the in-batch items (enables
    accidental-hit masking; defaults to the model's candidate-side id).
    For "weighted_bce", `type_weights` gives one weight per interaction type
    and the types arrive as one-hot dense columns
    `batch.dense[:, type_onehot_start : type_onehot_start + len(type_weights)]`
    (the reference's WeightedBCELoss wiring,
    `ray_tune_optuna_tuning_alex_test.py:308-318`, `:359-376`)."""
    if name == "bce":
        def loss_fn(q, c, batch, log_q=None):
            logits = jnp.sum(q * c, axis=1)
            return bce_with_logits(logits, batch.labels), logits
        return loss_fn
    if name == "weighted_bce":
        if not type_weights:
            raise ValueError('loss="weighted_bce" requires non-empty type_weights')
        tw = jnp.asarray(type_weights, jnp.float32)
        lo, hi = type_onehot_start, type_onehot_start + len(type_weights)

        def loss_fn(q, c, batch, log_q=None):
            logits = jnp.sum(q * c, axis=1)
            if batch.dense is None:
                raise ValueError(
                    "weighted_bce needs dense one-hot type columns in the batch "
                    "(configure the featurizer's dense_cols)"
                )
            onehot = batch.dense[:, lo:hi]
            return weighted_bce_with_logits(logits, batch.labels, onehot, tw), logits
        return loss_fn
    if name == "sampled_softmax":
        def loss_fn(q, c, batch, log_q=None):
            logits = jnp.sum(q * c, axis=1)
            item_ids = None
            if candidate_id_feature is not None and candidate_id_feature in batch.features:
                item_ids = batch.features[candidate_id_feature].ids[:, 0]
            loss = in_batch_sampled_softmax(
                q, c, batch.labels, item_ids, log_q, temperature=temperature
            )
            return loss, logits
        return loss_fn
    raise ValueError(f"unknown loss {name!r}")


def loss_fn_from_config(train_cfg, model_cfg):
    """Build the training loss from TrainConfig + ModelConfig — the single
    selection point the single-device and sharded train steps share
    (reference wires its loss into the train task at
    `ray_tune_optuna_tuning_alex_test.py:359-376`). Under the sharded step
    GSPMD partitions the same code along the data-sharded batch."""
    return make_loss_fn(
        train_cfg.loss,
        candidate_id_feature=model_cfg.candidate_tower.features[0],
        type_weights=train_cfg.loss_type_weights,
        type_onehot_start=train_cfg.loss_type_onehot_start,
        temperature=train_cfg.softmax_temperature,
    )
