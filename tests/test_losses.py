"""Losses: BCE parity, weighted BCE, in-batch sampled softmax properties."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from two_tower_recommender_model.models.losses import (
    bce_with_logits,
    in_batch_sampled_softmax,
    weighted_bce_with_logits,
)


def test_bce_matches_optax(rng):
    logits = jnp.asarray(rng.normal(size=64) * 3, jnp.float32)
    labels = jnp.asarray(rng.integers(0, 2, 64), jnp.int32)
    want = optax.sigmoid_binary_cross_entropy(logits, labels.astype(jnp.float32)).mean()
    got = bce_with_logits(logits, labels)
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_bce_extreme_logits_stable():
    logits = jnp.asarray([100.0, -100.0, 0.0])
    labels = jnp.asarray([1, 0, 1])
    assert np.isfinite(float(bce_with_logits(logits, labels)))


def test_weighted_bce(rng):
    logits = jnp.asarray(rng.normal(size=10), jnp.float32)
    labels = jnp.asarray(rng.integers(0, 2, 10), jnp.int32)
    onehot = jax.nn.one_hot(jnp.asarray(rng.integers(0, 3, 10)), 3)
    tw = jnp.asarray([1.0, 2.0, 0.5])
    got = weighted_bce_with_logits(logits, labels, onehot, tw)
    w = np.asarray(onehot) @ np.asarray(tw)
    per = np.maximum(logits, 0) - np.asarray(logits) * np.asarray(labels) + np.log1p(
        np.exp(-np.abs(np.asarray(logits)))
    )
    np.testing.assert_allclose(got, (per * w).sum() / w.sum(), rtol=1e-5)


def test_sampled_softmax_prefers_matching_pairs(rng):
    # aligned q/c pairs should have lower loss than shuffled ones
    d = 8
    q = jnp.asarray(rng.normal(size=(16, d)), jnp.float32)
    labels = jnp.ones(16, jnp.int32)
    aligned = in_batch_sampled_softmax(q, q * 2.0, labels)
    shuffled = in_batch_sampled_softmax(q, jnp.roll(q * 2.0, 5, axis=0), labels)
    assert float(aligned) < float(shuffled)


def test_sampled_softmax_ignores_label0_rows(rng):
    q = jnp.asarray(rng.normal(size=(8, 4)), jnp.float32)
    c = jnp.asarray(rng.normal(size=(8, 4)), jnp.float32)
    labels = jnp.asarray([1, 1, 0, 0, 1, 0, 1, 1], jnp.int32)
    full = in_batch_sampled_softmax(q, c, labels)
    # zeroing q-rows of negative-label rows must not change the loss value
    q2 = q.at[jnp.asarray([2, 3, 5])].set(123.0)
    # (their columns still act as negatives; only their row-loss is excluded)
    full2 = in_batch_sampled_softmax(q2, c, labels)
    # rows 2,3,5 excluded from the mean -> changing their q changes nothing
    np.testing.assert_allclose(full, full2, rtol=1e-6)


def test_sampled_softmax_logq_correction(rng):
    q = jnp.asarray(rng.normal(size=(8, 4)), jnp.float32)
    c = jnp.asarray(rng.normal(size=(8, 4)), jnp.float32)
    labels = jnp.ones(8, jnp.int32)
    logq = jnp.asarray(rng.normal(size=8), jnp.float32)
    a = in_batch_sampled_softmax(q, c, labels, log_q=logq)
    b = in_batch_sampled_softmax(q, c, labels)
    assert not np.allclose(float(a), float(b))


def test_sampled_softmax_accidental_hit_masking(rng):
    q = jnp.asarray(rng.normal(size=(4, 4)), jnp.float32)
    c = jnp.asarray(rng.normal(size=(4, 4)), jnp.float32)
    labels = jnp.ones(4, jnp.int32)
    ids_dup = jnp.asarray([7, 7, 8, 9], jnp.int32)  # rows 0,1 share an item
    loss_masked = in_batch_sampled_softmax(q, c, labels, item_ids=ids_dup)
    loss_plain = in_batch_sampled_softmax(q, c, labels)
    # with duplicates masked the softmax has fewer negatives -> lower-or-equal loss
    assert float(loss_masked) <= float(loss_plain) + 1e-6


def test_chunked_sampled_softmax_matches_dense():
    """The blockwise (flash-style) in-batch softmax must match the dense path
    exactly in value AND gradients — same per-row logsumexp, only the final
    reduction order differs."""
    import jax
    import jax.numpy as jnp

    from two_tower_recommender_model.models.losses import (
        _chunked_sampled_softmax,
        in_batch_sampled_softmax,
    )

    rng = np.random.default_rng(0)
    b, d = 512, 16
    q = jnp.asarray(rng.normal(size=(b, d)).astype(np.float32))
    c = jnp.asarray(rng.normal(size=(b, d)).astype(np.float32))
    labels = jnp.asarray(rng.integers(0, 2, b).astype(np.int32))
    item_ids = jnp.asarray(rng.integers(0, 40, b).astype(np.int32))  # many dups
    log_q = jnp.asarray(rng.normal(size=b).astype(np.float32) * 0.1)

    def dense(q, c):
        return in_batch_sampled_softmax(q, c, labels, item_ids, log_q,
                                        temperature=0.7)

    def chunked(q, c):
        return _chunked_sampled_softmax(q, c, labels, item_ids, log_q, 0.7, r=64)

    lv_d, g_d = jax.value_and_grad(lambda a: dense(a, c))(q)
    lv_c, g_c = jax.value_and_grad(lambda a: chunked(a, c))(q)
    np.testing.assert_allclose(float(lv_c), float(lv_d), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(g_c), np.asarray(g_d), rtol=1e-5, atol=1e-7)
    # candidate-side grads too (flow through every block's columns)
    _, gc_d = jax.value_and_grad(lambda a: dense(q, a))(c)
    _, gc_c = jax.value_and_grad(lambda a: chunked(q, a))(c)
    np.testing.assert_allclose(np.asarray(gc_c), np.asarray(gc_d), rtol=1e-5, atol=1e-7)


def test_chunked_sampled_softmax_no_ids_no_logq():
    import jax
    import jax.numpy as jnp

    from two_tower_recommender_model.models.losses import (
        _chunked_sampled_softmax,
        in_batch_sampled_softmax,
    )

    rng = np.random.default_rng(1)
    b, d = 256, 8
    q = jnp.asarray(rng.normal(size=(b, d)).astype(np.float32))
    c = jnp.asarray(rng.normal(size=(b, d)).astype(np.float32))
    labels = jnp.ones(b, jnp.int32)
    dense_v = in_batch_sampled_softmax(q, c, labels)
    chunk_v = _chunked_sampled_softmax(q, c, labels, None, None, 1.0, r=32)
    np.testing.assert_allclose(float(chunk_v), float(dense_v), rtol=1e-6)


def test_auto_row_chunk_policy():
    from two_tower_recommender_model.models.losses import _auto_row_chunk

    assert _auto_row_chunk(1024) is None           # small: dense
    assert _auto_row_chunk(8192) == 2048           # 16.7M-element blocks
    assert _auto_row_chunk(262144) == 64
    assert _auto_row_chunk(5000) == 8              # non-power-of-2: small divisor


def _sampled_softmax_f64(q, c, labels, item_ids, log_q, temperature, rows=512):
    """float64 in-batch sampled softmax with its gradients, in row blocks so
    the [B, B] score matrix never exists whole. Returns (loss, dq, dc)."""
    q, c = q.astype(np.float64), c.astype(np.float64)
    b = q.shape[0]
    w = labels.astype(np.float64)
    wsum = max(w.sum(), 1.0)
    tot, dq, dc = 0.0, np.zeros_like(q), np.zeros_like(c)
    for lo in range(0, b, rows):
        hi = min(lo + rows, b)
        s = q[lo:hi] @ c.T / temperature
        if log_q is not None:
            s = s - log_q[None, :].astype(np.float64)
        eye = np.arange(lo, hi)[:, None] == np.arange(b)[None, :]
        if item_ids is not None:
            s = np.where((item_ids[lo:hi, None] == item_ids[None, :]) & ~eye, -np.inf, s)
        mx = s.max(axis=1, keepdims=True)
        p = np.exp(s - mx)
        lse = np.log(p.sum(axis=1)) + mx[:, 0]
        p /= p.sum(axis=1, keepdims=True)
        tot += ((lse - s[eye]) * w[lo:hi]).sum()
        ds = (p - eye) * (w[lo:hi] / wsum)[:, None] / temperature
        dq[lo:hi] = ds @ c
        dc += ds.T @ q[lo:hi]
    return tot / wsum, dq, dc


@pytest.mark.parametrize("b", [4608, 4099])  # chunked scan; padded scan (prime b)
@pytest.mark.parametrize("d,temperature", [(16, 1.0), (5, 0.7)])
@pytest.mark.parametrize("use_ids,use_logq",
                         [(False, False), (True, False), (False, True), (True, True)])
def test_scan_sampled_softmax_oracle(b, d, temperature, use_ids, use_logq):
    """Past 4096 rows the loss runs as a scan over [R, B] row chunks (or, for
    a batch with no usable divisor, over a padded batch whose pad columns are
    masked); value and both gradients match a float64 dense reference, with
    logQ correction, accidental-hit masking, unlabeled rows, an odd dim and a
    temperature."""
    from two_tower_recommender_model.models.losses import _auto_row_chunk

    assert (_auto_row_chunk(b) is None) == (b == 4099)
    rng = np.random.default_rng(b * 10 + d)
    q = rng.normal(size=(b, d)).astype(np.float32) * 0.5
    c = rng.normal(size=(b, d)).astype(np.float32) * 0.5
    labels = (rng.random(b) < 0.8).astype(np.int32)
    item_ids = rng.integers(0, 300, b).astype(np.int32) if use_ids else None
    log_q = (rng.normal(size=b) * 0.3).astype(np.float32) if use_logq else None

    def loss(q_, c_):
        return in_batch_sampled_softmax(
            q_, c_, jnp.asarray(labels),
            None if item_ids is None else jnp.asarray(item_ids),
            None if log_q is None else jnp.asarray(log_q),
            temperature=temperature)

    val, (dq, dc) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1)))(
        jnp.asarray(q), jnp.asarray(c))
    want, want_dq, want_dc = _sampled_softmax_f64(
        q, c, labels, item_ids, log_q, temperature)
    np.testing.assert_allclose(float(val), want, rtol=1e-5)
    np.testing.assert_allclose(np.asarray(dq), want_dq, rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(np.asarray(dc), want_dc, rtol=1e-4, atol=1e-7)
