"""Oracle grids for the XLA routes that carry all embedding-table traffic.

`pooled_lookup` (f32 rows, bf16 output, int8 and packed-int8 storage) is
checked against a numpy gather, and every row-wise Adagrad update route the
train step can pick (`pick_table_update_fn`) against a float64 numpy
reference, over the id layouts that stress them: sorted and unsorted ids,
dead-slot sentinels, ids clustered at both ends of the table, one id
repeated across the whole batch, an all-dead batch, and multi-slot bags; on
a ragged table size (220) and a multiple of 16 (176).
"""

from __future__ import annotations

import zlib

import jax.numpy as jnp
import numpy as np
import pytest

from two_tower_recommender_model.ops.embedding_ops import pooled_lookup
from two_tower_recommender_model.ops.quantized import (
    dequantize_table,
    quantize_table,
    quantized_dense_rowwise_adagrad,
    quantized_rowwise_adagrad,
)
from two_tower_recommender_model.train.optimizer import (
    aggregate_grads_by_row,
    dense_rowwise_adagrad,
    scatter_aggregate,
    sparse_rowwise_adagrad,
)

D = 128
M = 384  # flat ids per case
LR, EPS = 0.05, 1e-10

KINDS = ["uniform", "sentinels", "clustered", "one_hot_row", "all_sentinel", "bag3_mean"]
SIZES = [220, 16 * 11]  # ragged + multiple of 16


def _seed(*parts) -> int:
    return zlib.crc32("/".join(map(str, parts)).encode()) % 2**31


def _flat_ids(kind: str, rng, n: int, m: int) -> np.ndarray:
    """[m] ids in [0, n]; the sentinel n marks a dead slot."""
    if kind in ("uniform", "bag3_mean"):
        ids = rng.integers(0, n, size=m)
        if kind == "bag3_mean":
            ids[rng.random(m) < 0.3] = n  # ragged bags
    elif kind == "sentinels":
        ids = np.concatenate([rng.integers(0, n, size=m // 2), np.full(m - m // 2, n)])
    elif kind == "clustered":  # both ends of the table, middle untouched
        ids = np.concatenate(
            [rng.integers(0, 16, size=m // 2), rng.integers(n - 3, n, size=m - m // 2)])
    elif kind == "one_hot_row":
        ids = np.full(m, 7)
    elif kind == "all_sentinel":
        ids = np.full(m, n)
    else:
        raise AssertionError(kind)
    return ids.astype(np.int32)


def _order(ids: np.ndarray, order: str, rng) -> np.ndarray:
    if order == "sorted":
        return np.sort(ids)
    out = ids.copy()
    rng.shuffle(out)
    return out


# ----------------------------------------------------------------- lookups


def _lookup_case(kind, order, n):
    rng = np.random.default_rng(_seed("lookup", kind, order, n))
    flat = _order(_flat_ids(kind, rng, n, M), order, rng)
    slots = 3 if kind == "bag3_mean" else 1
    pooling = "mean" if kind == "bag3_mean" else "sum"
    mask = (flat < n).astype(np.float32).reshape(-1, slots)
    ids = np.where(flat < n, flat, 0).reshape(-1, slots)  # dead slots carry id 0
    table = rng.normal(size=(n, D)).astype(np.float32)
    return table, ids, mask, pooling


def _pool_ref(rows, mask, pooling):
    """numpy pooling of gathered [B, L, D] rows (float64 accumulation)."""
    pooled = (rows.astype(np.float64) * mask[..., None]).sum(axis=1)
    if pooling == "mean":
        pooled = pooled / np.maximum(mask.sum(axis=1, keepdims=True), 1.0)
    return pooled


@pytest.mark.parametrize("storage", ["float32", "bf16_out", "int8", "int8_packed"])
@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("order", ["sorted", "unsorted"])
@pytest.mark.parametrize("kind", KINDS)
def test_pooled_lookup_oracle(kind, order, n, storage):
    table, ids, mask, pooling = _lookup_case(kind, order, n)
    single = ids.shape[1] == 1
    if storage == "float32":
        got = np.asarray(pooled_lookup(jnp.asarray(table), jnp.asarray(ids),
                                       jnp.asarray(mask), pooling))
        want = _pool_ref(table[ids], mask, pooling)
        if single:  # one live contribution per row: the gather is exact
            np.testing.assert_array_equal(got, want.astype(np.float32))
        else:
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    elif storage == "bf16_out":
        got = pooled_lookup(jnp.asarray(table), jnp.asarray(ids), jnp.asarray(mask),
                            pooling, compute_dtype=jnp.bfloat16)
        assert got.dtype == jnp.bfloat16
        rows_bf16 = np.asarray(jnp.asarray(table[ids]).astype(jnp.bfloat16)
                               .astype(jnp.float32))
        want = _pool_ref(rows_bf16, mask, pooling)
        if single:  # rounding commutes with a single live contribution
            np.testing.assert_array_equal(np.asarray(got.astype(jnp.float32)),
                                          want.astype(np.float32))
        else:  # bf16 sums: 8 mantissa bits
            np.testing.assert_allclose(np.asarray(got.astype(jnp.float32)), want,
                                       rtol=2e-2, atol=2e-2)
    else:
        qt = quantize_table(jnp.asarray(table), packed=storage == "int8_packed")
        got = np.asarray(pooled_lookup(qt, jnp.asarray(ids), jnp.asarray(mask), pooling))
        deq = np.asarray(dequantize_table(qt))
        want = _pool_ref(deq[ids], mask, pooling)
        # XLA may turn the /127 into a reciprocal multiply: 1-2 ulp of f32
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
        np.testing.assert_array_equal(got[mask.sum(axis=1) == 0], 0.0)
        if storage == "int8_packed":
            plain = pooled_lookup(quantize_table(jnp.asarray(table)), jnp.asarray(ids),
                                  jnp.asarray(mask), pooling)
            np.testing.assert_array_equal(got, np.asarray(plain))  # same bytes


# ----------------------------------------------------------------- updates


def rowwise_adagrad_f64(table, acc, ids, grads, lr, eps):
    """float64 fbgemm row-wise Adagrad: aggregate duplicate-row grads, then
    acc += mean(g^2); row -= lr * g / (sqrt(acc) + eps). Returns (table, acc,
    touched)."""
    n = table.shape[0]
    t = table.astype(np.float64)
    a = acc.astype(np.float64)
    live = ids < n
    g = np.zeros_like(t)
    np.add.at(g, ids[live], grads[live].astype(np.float64))
    touched = np.zeros(n, bool)
    touched[ids[live]] = True
    a[touched] += (g[touched] ** 2).mean(axis=1)
    t[touched] -= lr * g[touched] / (np.sqrt(a[touched]) + eps)[:, None]
    return t, a, touched


F32_ROUTES = {
    "dense": ("unsorted", lambda *a: dense_rowwise_adagrad(*a)),
    "sparse": ("unsorted", lambda *a: sparse_rowwise_adagrad(*a)),
    "dense_sorted": ("sorted", lambda *a: dense_rowwise_adagrad(*a, ids_sorted=True)),
    "dense_sorted_bf16buf": (
        "sorted",
        lambda *a: dense_rowwise_adagrad(*a, ids_sorted=True, buffer_dtype=jnp.bfloat16),
    ),
}
INT8_ROUTES = {
    "quantized_sparse": ("unsorted", lambda *a: quantized_rowwise_adagrad(*a)),
    "quantized_dense": ("unsorted", lambda *a: quantized_dense_rowwise_adagrad(*a)),
    "quantized_dense_sorted": (
        "sorted", lambda *a: quantized_dense_rowwise_adagrad(*a, ids_sorted=True)),
}


def _update_case(kind, order, n, route):
    rng = np.random.default_rng(_seed("update", kind, order, n, route))
    ids = _order(_flat_ids(kind, rng, n, M), order, rng)
    grads = rng.normal(size=(M, D)).astype(np.float32)
    table = rng.normal(size=(n, D)).astype(np.float32)
    acc = np.abs(rng.normal(size=(n,))).astype(np.float32)
    return table, acc, ids, grads


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("route", list(F32_ROUTES))
def test_float_update_oracle(route, kind, n):
    order, fn = F32_ROUTES[route]
    table, acc, ids, grads = _update_case(kind, order, n, route)
    got_t, got_a = fn(jnp.asarray(table), jnp.asarray(acc), jnp.asarray(ids),
                      jnp.asarray(grads), LR, EPS)
    want_t, want_a, touched = rowwise_adagrad_f64(table, acc, ids, grads, LR, EPS)
    if route.endswith("bf16buf"):
        # duplicate-row grads sum in bf16: up to 384 terms at 8 mantissa
        # bits is ~2^-8 * sqrt(384) ~ 8% relative error in g, and a step
        # element is lr * g_i / rms(g) with |g_i| / rms(g) up to ~4 over
        # 128 normal draws, so the table moves within 0.05 * 0.08 * 4
        t_tol, a_tol = dict(rtol=0, atol=2e-2), dict(rtol=5e-2, atol=1e-3)
    else:
        t_tol, a_tol = dict(rtol=1e-5, atol=1e-6), dict(rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(got_a), want_a, **a_tol)
    np.testing.assert_allclose(np.asarray(got_t), want_t, **t_tol)
    # untouched rows are not rewritten at all
    np.testing.assert_array_equal(np.asarray(got_t)[~touched], table[~touched])
    np.testing.assert_array_equal(np.asarray(got_a)[~touched], acc[~touched])


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("route", list(INT8_ROUTES))
def test_quantized_update_oracle(route, kind, n):
    """int8 storage: dequantize, float64 row-wise Adagrad, requantize. The
    accumulators and the new per-row scales match to f32 tolerance; int8
    values sit within one quantization step (f32 vs f64 can flip a
    round-to-nearest boundary); untouched rows keep their exact bytes."""
    order, fn = INT8_ROUTES[route]
    table, acc, ids, grads = _update_case(kind, order, n, route)
    qt = quantize_table(jnp.asarray(table))
    got_qt, got_a = fn(qt, jnp.asarray(acc), jnp.asarray(ids), jnp.asarray(grads),
                       LR, EPS)
    deq = np.asarray(dequantize_table(qt))
    want_t, want_a, touched = rowwise_adagrad_f64(deq, acc, ids, grads, LR, EPS)
    np.testing.assert_allclose(np.asarray(got_a), want_a, rtol=1e-5, atol=1e-6)
    want_scales = np.abs(want_t).max(axis=1)
    got_scales = np.asarray(got_qt.scales)
    np.testing.assert_allclose(got_scales[touched], want_scales[touched],
                               rtol=1e-5, atol=1e-6)
    got_v = np.asarray(got_qt.values).astype(np.int32)
    want_v = np.round(want_t / (want_scales[:, None] / 127.0))
    assert np.abs(got_v[touched] - want_v[touched]).max(initial=0) <= 1
    np.testing.assert_array_equal(got_v[~touched], np.asarray(qt.values)[~touched])
    np.testing.assert_array_equal(got_scales[~touched], np.asarray(qt.scales)[~touched])
    np.testing.assert_array_equal(np.asarray(got_a)[~touched], acc[~touched])


@pytest.mark.parametrize("order", ["sorted", "unsorted"])
@pytest.mark.parametrize("kind", KINDS)
def test_aggregation_routes_oracle(kind, order):
    """Both prologues the updates share, the transient-buffer scatter-add and
    the sorted segment sum, give each touched row its float64 summed slot
    gradients; sentinel slots touch nothing."""
    n = SIZES[0]
    table, _, ids, grads = _update_case(kind, order, n, "aggregate")
    live = ids < n
    want = np.zeros(table.shape)
    np.add.at(want, ids[live], grads[live].astype(np.float64))
    touched = np.zeros(n, bool)
    touched[ids[live]] = True

    g, got_touched = scatter_aggregate(jnp.asarray(ids), jnp.asarray(grads), n,
                                       ids_sorted=order == "sorted")
    np.testing.assert_array_equal(np.asarray(got_touched), touched)
    np.testing.assert_allclose(np.asarray(g), want, rtol=1e-5, atol=1e-5)

    g_seg, rep, valid, _ = aggregate_grads_by_row(jnp.asarray(ids), jnp.asarray(grads), n)
    rep, valid = np.asarray(rep), np.asarray(valid)
    assert sorted(rep[valid].tolist()) == np.flatnonzero(touched).tolist()
    np.testing.assert_allclose(np.asarray(g_seg)[valid], want[rep[valid]],
                               rtol=1e-5, atol=1e-5)
