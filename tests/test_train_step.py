"""Train-step correctness: the two-stage (pooled-grad) backward must equal
full autodiff + manual row-wise Adagrad on the tables and Adam on the towers."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from two_tower_recommender_model import config as cfg_lib
from two_tower_recommender_model.data import Featurizer, SyntheticClickstream
from two_tower_recommender_model.models import two_tower as tt
from two_tower_recommender_model.models.losses import bce_with_logits
from two_tower_recommender_model.train.step import (
    create_train_state,
    make_apply_gradients,
    make_eval_step,
    make_train_step,
    eval_state_init,
)


def _setup(loss="bce"):
    mcfg = cfg_lib.two_tower_model_config(num_users=40, num_items=25, embedding_dim=8,
                                          layer_sizes=(16, 4))
    tcfg = cfg_lib.TrainConfig(loss=loss, sparse_learning_rate=0.05, learning_rate=1e-3)
    ds = SyntheticClickstream(40, 25, seed=1)
    feat = Featurizer(mcfg)
    batch = jax.tree.map(jnp.asarray, feat(ds.sample(32)))
    return mcfg, tcfg, batch


def reference_full_autodiff_step(state, batch, mcfg, tcfg, dense_opt):
    """Oracle: dense autodiff through everything + manual fbgemm-style
    row-wise Adagrad applied to the (dense) table grads."""
    params = {"tables": state.tables, **state.dense_params}

    def loss_of(p):
        q, c = tt.forward(p, batch, mcfg)
        return bce_with_logits(jnp.sum(q * c, axis=1), batch.labels)

    loss, grads = jax.value_and_grad(loss_of)(params)

    d_dense = {k: grads[k] for k in ("query_tower", "candidate_tower")}
    dense_params = {k: params[k] for k in ("query_tower", "candidate_tower")}
    updates, _ = dense_opt.update(d_dense, state.dense_opt_state, dense_params)
    new_dense = optax.apply_updates(dense_params, updates)

    new_tables, new_acc = {}, {}
    for name, table in state.tables.items():
        g = np.asarray(grads["tables"][name])
        t = np.asarray(table).copy()
        a = np.asarray(state.adagrad_acc[name]).copy()
        touched = np.abs(g).sum(axis=1) > 0
        g2 = (g * g).mean(axis=1)
        a[touched] += g2[touched]
        t[touched] -= tcfg.sparse_learning_rate * g[touched] / (
            np.sqrt(a[touched])[:, None] + tcfg.adagrad_eps
        )
        new_tables[name], new_acc[name] = t, a
    return loss, new_tables, new_acc, new_dense


def test_two_stage_equals_full_autodiff():
    mcfg, tcfg, batch = _setup()
    state, dense_opt = create_train_state(jax.random.key(0), mcfg, tcfg)
    want_loss, want_tables, want_acc, want_dense = reference_full_autodiff_step(
        state, batch, mcfg, tcfg, dense_opt
    )
    step = make_train_step(mcfg, tcfg, dense_opt, donate=False)
    new_state, out = step(state, batch)
    np.testing.assert_allclose(float(out["loss"]), float(want_loss), rtol=1e-6)
    for name in state.tables:
        np.testing.assert_allclose(new_state.tables[name], want_tables[name], rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(new_state.adagrad_acc[name], want_acc[name], rtol=1e-5, atol=1e-7)
    for tower in ("query_tower", "candidate_tower"):
        for lname, layer in want_dense[tower].items():
            for p in ("kernel", "bias"):
                np.testing.assert_allclose(
                    new_state.dense_params[tower][lname][p], layer[p], rtol=1e-5, atol=1e-7
                )


@pytest.mark.parametrize("loss", ["bce", "sampled_softmax"])
def test_step_returns_the_gradients_it_applies(loss):
    """`with_grads=True` returns the gradients the step applied: the dense
    gradient and, summed per row, each table's full-autodiff gradient; and
    `make_apply_gradients` applied to them gives the step's new state."""
    from two_tower_recommender_model.models import losses as losses_lib
    from two_tower_recommender_model.train.optimizer import scatter_aggregate

    mcfg, tcfg, batch = _setup(loss)
    state, dense_opt = create_train_state(jax.random.key(0), mcfg, tcfg)
    loss_fn = losses_lib.loss_fn_from_config(tcfg, mcfg)

    def loss_of(p):
        q, c = tt.forward(p, batch, mcfg)
        return loss_fn(q, c, batch)[0]

    want = jax.grad(loss_of)({"tables": state.tables, **state.dense_params})
    new_state, out = make_train_step(mcfg, tcfg, dense_opt, donate=False,
                                     with_grads=True)(state, batch)
    _, plain = make_train_step(mcfg, tcfg, dense_opt, donate=False)(state, batch)
    assert set(plain) == {"loss", "logits"}
    np.testing.assert_array_equal(out["loss"], plain["loss"])
    grads = out["grads"]
    for tower in ("query_tower", "candidate_tower"):
        for a, b in zip(jax.tree.leaves(grads["d_dense"][tower]),
                        jax.tree.leaves(want[tower])):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-7)
    for name, (ids, g) in grads["table_grads"].items():
        agg, _ = scatter_aggregate(ids, g, state.tables[name].shape[0])
        np.testing.assert_allclose(agg, want["tables"][name], rtol=1e-5, atol=1e-7)
    applied = jax.jit(make_apply_gradients(mcfg, tcfg, dense_opt))(state, grads)
    for a, b in zip(jax.tree.leaves(applied), jax.tree.leaves(new_state)):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)


def test_train_step_sampled_softmax_runs():
    mcfg, tcfg, batch = _setup(loss="sampled_softmax")
    state, dense_opt = create_train_state(jax.random.key(0), mcfg, tcfg)
    step = make_train_step(mcfg, tcfg, dense_opt, donate=False)
    new_state, out = step(state, batch)
    assert np.isfinite(float(out["loss"]))
    assert int(new_state.step) == 1


def test_eval_step_accumulates():
    mcfg, tcfg, batch = _setup()
    state, _ = create_train_state(jax.random.key(0), mcfg, tcfg)
    estep = make_eval_step(mcfg, tcfg)
    es = eval_state_init()
    es = estep(state, es, batch)
    es = estep(state, es, batch)
    assert float(es.loss.count) == 64.0


def test_explicit_sparse_update_overrides_block_kernels():
    """An explicit `sparse_update` must win over the per-table routing,
    including the sorted table's hinted update: a no-op update leaves every
    table and accumulator untouched."""
    mcfg = cfg_lib.two_tower_model_config(num_users=40, num_items=25,
                                          embedding_dim=128, layer_sizes=(16, 4))
    tcfg = cfg_lib.TrainConfig(sparse_learning_rate=0.05, learning_rate=1e-3,
                               sorted_feature="user_id")
    ds = SyntheticClickstream(40, 25, seed=1)
    batch = jax.tree.map(jnp.asarray, Featurizer(mcfg)(ds.sample(128)))
    state, dense_opt = create_train_state(jax.random.key(0), mcfg, tcfg)
    noop = lambda t, a, ids, g, lr, eps: (t, a)
    step = make_train_step(mcfg, tcfg, dense_opt, sparse_update=noop, donate=False)
    new_state, out = step(state, batch)
    assert np.isfinite(float(out["loss"]))
    for name in state.tables:
        np.testing.assert_array_equal(
            np.asarray(new_state.tables[name]), np.asarray(state.tables[name]))
        np.testing.assert_array_equal(
            np.asarray(new_state.adagrad_acc[name]),
            np.asarray(state.adagrad_acc[name]))
