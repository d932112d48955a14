"""Fused row-wise Adagrad: sparse path == dense oracle == numpy reference."""

import jax.numpy as jnp
import numpy as np
import pytest

from two_tower_recommender_model.train.optimizer import (
    dense_rowwise_adagrad,
    row_grad_flatten,
    sparse_rowwise_adagrad,
)


def numpy_rowwise_adagrad(table, acc, ids, grads, lr, eps):
    """fbgemm semantics: aggregate duplicate-row grads, then
    acc += mean(g^2); row -= lr*g/(sqrt(acc)+eps)."""
    table, acc = table.copy(), acc.copy()
    n = table.shape[0]
    agg = {}
    for i, g in zip(ids, grads):
        if i >= n:
            continue
        agg.setdefault(int(i), np.zeros(table.shape[1])).__iadd__(g)
    for i, g in agg.items():
        acc[i] += np.mean(g * g)
        table[i] -= lr * g / (np.sqrt(acc[i]) + eps)
    return table, acc


@pytest.mark.parametrize("impl", [sparse_rowwise_adagrad, dense_rowwise_adagrad])
def test_vs_numpy_oracle(rng, impl):
    n, d, m = 40, 8, 100
    table = rng.normal(size=(n, d)).astype(np.float32)
    acc = rng.random(n).astype(np.float32)
    # heavy duplication + sentinel (dead) slots
    ids = np.concatenate([rng.integers(0, n, m - 20), np.full(20, n)]).astype(np.int32)
    grads = rng.normal(size=(m, d)).astype(np.float32)
    want_t, want_a = numpy_rowwise_adagrad(table, acc, ids, grads, 0.1, 1e-10)
    got_t, got_a = impl(jnp.asarray(table), jnp.asarray(acc), jnp.asarray(ids), jnp.asarray(grads), 0.1, 1e-10)
    np.testing.assert_allclose(got_t, want_t, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got_a, want_a, rtol=1e-5, atol=1e-6)


def test_dense_sorted_hint_exact(rng):
    """Host-sorted ids + `ids_sorted=True` must give the identical update —
    the `indices_are_sorted` fast path changes scheduling, not math."""
    n, d, m = 40, 8, 100
    table = rng.normal(size=(n, d)).astype(np.float32)
    acc = rng.random(n).astype(np.float32)
    ids = np.sort(
        np.concatenate([rng.integers(0, n, m - 20), np.full(20, n)]).astype(np.int32)
    )
    grads = rng.normal(size=(m, d)).astype(np.float32)
    want_t, want_a = numpy_rowwise_adagrad(table, acc, ids, grads, 0.1, 1e-10)
    got_t, got_a = dense_rowwise_adagrad(
        jnp.asarray(table), jnp.asarray(acc), jnp.asarray(ids), jnp.asarray(grads),
        0.1, 1e-10, ids_sorted=True,
    )
    np.testing.assert_allclose(got_t, want_t, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got_a, want_a, rtol=1e-5, atol=1e-6)


def test_dense_bf16_buffer_close(rng):
    """bf16 aggregation buffer: same update within bf16 tolerance."""
    n, d, m = 40, 8, 100
    table = rng.normal(size=(n, d)).astype(np.float32)
    acc = rng.random(n).astype(np.float32)
    ids = np.sort(rng.integers(0, n, m).astype(np.int32))
    grads = rng.normal(size=(m, d)).astype(np.float32)
    want_t, want_a = numpy_rowwise_adagrad(table, acc, ids, grads, 0.1, 1e-10)
    got_t, got_a = dense_rowwise_adagrad(
        jnp.asarray(table), jnp.asarray(acc), jnp.asarray(ids), jnp.asarray(grads),
        0.1, 1e-10, ids_sorted=True, buffer_dtype=jnp.bfloat16,
    )
    np.testing.assert_allclose(got_t, want_t, rtol=0.05, atol=0.02)
    np.testing.assert_allclose(got_a, want_a, rtol=0.05, atol=0.02)


def test_all_dead_slots_noop(rng):
    n, d = 10, 4
    table = jnp.asarray(rng.normal(size=(n, d)), jnp.float32)
    acc = jnp.zeros(n, jnp.float32)
    ids = jnp.full((8,), n, jnp.int32)
    grads = jnp.ones((8, d), jnp.float32)
    t, a = sparse_rowwise_adagrad(table, acc, ids, grads, 0.1)
    np.testing.assert_array_equal(t, table)
    np.testing.assert_array_equal(a, acc)


def test_row_grad_flatten_marks_masked_slots(rng):
    ids = jnp.asarray([[1, 2], [3, 4]], jnp.int32)
    mask = jnp.asarray([[1, 0], [1, 1]], jnp.float32)
    rg = jnp.ones((2, 2, 3), jnp.float32)
    fid, fg = row_grad_flatten(ids, mask, rg, num_rows=100)
    np.testing.assert_array_equal(fid, [1, 100, 3, 4])
    assert fg.shape == (4, 3)
