"""Streaming metrics, jit-compatible.

The role of `torchmetrics.AUROC` with distributed sync in the reference eval
loop (`03_model_training.py:504-566`): a fixed-bin histogram AUROC whose state
is two `[bins]` count vectors — update is pure (psum-able across a mesh axis
for multi-host eval), compute is a trapezoidal integral over the binned ROC.
With the default 8192 bins on sigmoid scores, agreement with exact AUROC is
~1e-4. An exact (sort-based) implementation is provided for tests.

Also `MeanLoss` — the running loss-sum / sample-count average of the reference
evaluate loop (`03_model_training.py:546-556`).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from two_tower_recommender_model.utils.pytree import pytree_dataclass


@pytree_dataclass
class AUROCState:
    pos: jax.Array  # [bins] float32 counts of positive scores
    neg: jax.Array  # [bins] float32


def auroc_init(bins: int = 8192) -> AUROCState:
    return AUROCState(pos=jnp.zeros(bins, jnp.float32), neg=jnp.zeros(bins, jnp.float32))


def auroc_update(state: AUROCState, logits: jax.Array, labels: jax.Array,
                 weights: jax.Array | None = None) -> AUROCState:
    bins = state.pos.shape[0]
    scores = jax.nn.sigmoid(logits.astype(jnp.float32))
    idx = jnp.clip((scores * bins).astype(jnp.int32), 0, bins - 1)
    w = jnp.ones_like(scores) if weights is None else weights.astype(jnp.float32)
    lab = labels.astype(jnp.float32)
    pos = state.pos.at[idx].add(w * lab)
    neg = state.neg.at[idx].add(w * (1.0 - lab))
    return AUROCState(pos=pos, neg=neg)


def auroc_compute(state: AUROCState) -> jax.Array:
    """AUC via the Mann-Whitney statistic on binned counts: every pos/neg pair
    in distinct bins is ordered by bin; same-bin pairs count 1/2 (tie rule —
    matches the trapezoidal ROC integral)."""
    pos, neg = state.pos, state.neg
    # negs strictly below each bin
    neg_below = jnp.concatenate([jnp.zeros(1, neg.dtype), jnp.cumsum(neg)[:-1]])
    correct = jnp.sum(pos * (neg_below + 0.5 * neg))
    total = jnp.sum(pos) * jnp.sum(neg)
    return jnp.where(total > 0, correct / total, jnp.float32(0.5))


def auroc_merge(a: AUROCState, b: AUROCState) -> AUROCState:
    return AUROCState(pos=a.pos + b.pos, neg=a.neg + b.neg)


def exact_auroc(logits: np.ndarray, labels: np.ndarray) -> float:
    """Exact AUROC (rank statistic with midrank ties) — test oracle."""
    scores = np.asarray(logits, dtype=np.float64)
    labels = np.asarray(labels).astype(bool)
    order = np.argsort(scores, kind="mergesort")
    ranks = np.empty(len(scores), dtype=np.float64)
    sorted_scores = scores[order]
    i = 0
    r = 1.0
    while i < len(scores):
        j = i
        while j + 1 < len(scores) and sorted_scores[j + 1] == sorted_scores[i]:
            j += 1
        midrank = 0.5 * (r + r + (j - i))
        ranks[order[i : j + 1]] = midrank
        r += j - i + 1
        i = j + 1
    n_pos = labels.sum()
    n_neg = (~labels).sum()
    if n_pos == 0 or n_neg == 0:
        return 0.5
    return float((ranks[labels].sum() - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg))


@pytree_dataclass
class MeanState:
    total: jax.Array
    count: jax.Array


def mean_init() -> MeanState:
    return MeanState(total=jnp.zeros((), jnp.float32), count=jnp.zeros((), jnp.float32))


def mean_update(state: MeanState, value: jax.Array, n: jax.Array | float) -> MeanState:
    return MeanState(
        total=state.total + value.astype(jnp.float32) * n, count=state.count + n
    )


def mean_compute(state: MeanState) -> jax.Array:
    return jnp.where(state.count > 0, state.total / state.count, jnp.float32(0.0))
