"""Kernel-level tests: pooled lookup, row-grad distribution, chunked top-k."""

import jax
import jax.numpy as jnp
import numpy as np

from two_tower_recommender_model.ops.embedding_ops import (
    pooled_lookup,
    row_grads_from_pooled,
    scatter_add_rows,
)
from two_tower_recommender_model.ops.topk import chunked_topk


def _rand(rng, *shape):
    return jnp.asarray(rng.normal(size=shape), jnp.float32)


def test_pooled_lookup_sum_mean(rng):
    table = _rand(rng, 20, 8)
    ids = jnp.asarray(rng.integers(0, 20, size=(5, 3)), jnp.int32)
    mask = jnp.asarray((rng.random((5, 3)) > 0.4), jnp.float32)
    got_sum = pooled_lookup(table, ids, mask, "sum")
    got_mean = pooled_lookup(table, ids, mask, "mean")
    tn, idn, mn = map(np.asarray, (table, ids, mask))
    want = (tn[idn] * mn[..., None]).sum(1)
    np.testing.assert_allclose(got_sum, want, rtol=1e-6)
    counts = np.maximum(mn.sum(1, keepdims=True), 1.0)
    np.testing.assert_allclose(got_mean, want / counts, rtol=1e-6)


def test_zero_length_bag_pools_to_zero(rng):
    table = _rand(rng, 10, 4)
    ids = jnp.zeros((2, 2), jnp.int32)
    mask = jnp.zeros((2, 2), jnp.float32)
    for pooling in ("sum", "mean"):
        np.testing.assert_array_equal(pooled_lookup(table, ids, mask, pooling), 0.0)


def test_row_grads_match_autodiff(rng):
    """row_grads_from_pooled must equal the autodiff jacobian contraction of
    pooled_lookup w.r.t. the gathered rows."""
    table = _rand(rng, 30, 6)
    ids = jnp.asarray(rng.integers(0, 30, size=(4, 3)), jnp.int32)
    mask = jnp.asarray((rng.random((4, 3)) > 0.3), jnp.float32)
    g_pooled = _rand(rng, 4, 6)
    for pooling in ("sum", "mean"):
        def f(t):
            return jnp.vdot(pooled_lookup(t, ids, mask, pooling), g_pooled)
        want_table_grad = jax.grad(f)(table)
        rg = row_grads_from_pooled(g_pooled, mask, pooling)
        got = scatter_add_rows(jnp.zeros_like(table), ids, rg)
        np.testing.assert_allclose(got, want_table_grad, rtol=1e-5, atol=1e-6)


def test_chunked_topk_exact(rng):
    q = _rand(rng, 37, 16)
    corpus = _rand(rng, 513, 16)  # non-multiple of chunk => padding path
    vals, idx = chunked_topk(q, corpus, k=10, corpus_chunk=128, query_chunk=8)
    scores = np.asarray(q) @ np.asarray(corpus).T
    want_idx = np.argsort(-scores, axis=1)[:, :10]
    want_vals = np.take_along_axis(scores, want_idx, 1)
    np.testing.assert_allclose(vals, want_vals, rtol=1e-5, atol=1e-6)
    # indices may differ on exact ties; compare scores at returned indices
    got_scores = np.take_along_axis(scores, np.asarray(idx), 1)
    np.testing.assert_allclose(got_scores, want_vals, rtol=1e-5, atol=1e-6)


def test_chunked_topk_k_larger_than_chunks(rng):
    q = _rand(rng, 3, 4)
    corpus = _rand(rng, 50, 4)
    vals, idx = chunked_topk(q, corpus, k=50, corpus_chunk=16, query_chunk=4)
    scores = np.asarray(q) @ np.asarray(corpus).T
    want = -np.sort(-scores, axis=1)
    np.testing.assert_allclose(vals, want, rtol=1e-5, atol=1e-6)
