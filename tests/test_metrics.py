"""Binned streaming AUROC vs exact rank-statistic oracle; mean-loss state."""

import jax.numpy as jnp
import numpy as np

from two_tower_recommender_model.models.metrics import (
    auroc_compute,
    auroc_init,
    auroc_merge,
    auroc_update,
    exact_auroc,
    mean_compute,
    mean_init,
    mean_update,
)


def test_binned_auroc_close_to_exact(rng):
    logits = rng.normal(size=5000) + rng.integers(0, 2, 5000) * 1.2
    labels = rng.integers(0, 2, 5000)
    want = exact_auroc(logits, labels)
    st = auroc_init()
    # stream in 5 chunks
    for chunk in range(5):
        sl = slice(chunk * 1000, (chunk + 1) * 1000)
        st = auroc_update(st, jnp.asarray(logits[sl], jnp.float32), jnp.asarray(labels[sl]))
    got = float(auroc_compute(st))
    assert abs(got - want) < 2e-3


def test_auroc_perfect_and_inverted():
    logits = jnp.asarray([-5.0, -4.0, 4.0, 5.0])
    labels = jnp.asarray([0, 0, 1, 1])
    st = auroc_update(auroc_init(), logits, labels)
    assert float(auroc_compute(st)) > 0.99
    st = auroc_update(auroc_init(), -logits, labels)
    assert float(auroc_compute(st)) < 0.01


def test_auroc_merge_equals_single_pass(rng):
    logits = rng.normal(size=2000)
    labels = rng.integers(0, 2, 2000)
    full = auroc_update(auroc_init(), jnp.asarray(logits, jnp.float32), jnp.asarray(labels))
    a = auroc_update(auroc_init(), jnp.asarray(logits[:1000], jnp.float32), jnp.asarray(labels[:1000]))
    b = auroc_update(auroc_init(), jnp.asarray(logits[1000:], jnp.float32), jnp.asarray(labels[1000:]))
    np.testing.assert_allclose(
        float(auroc_compute(full)), float(auroc_compute(auroc_merge(a, b))), rtol=1e-6
    )


def test_degenerate_single_class():
    st = auroc_update(auroc_init(), jnp.asarray([1.0, 2.0]), jnp.asarray([1, 1]))
    assert float(auroc_compute(st)) == 0.5


def test_mean_loss_weighted():
    st = mean_init()
    st = mean_update(st, jnp.float32(2.0), 10)
    st = mean_update(st, jnp.float32(4.0), 30)
    np.testing.assert_allclose(float(mean_compute(st)), 3.5)
