"""Quality/golden tests: sampled-softmax retrieval beats BCE retrieval on the
synthetic task; fixed-seed golden regression values."""

import dataclasses

import jax
import numpy as np
import pytest

from two_tower_recommender_model import config as cfg_lib
from two_tower_recommender_model.data import Featurizer, SyntheticClickstream
from two_tower_recommender_model.evaluation.retrieval import evaluate_retrieval
from two_tower_recommender_model.train.pipeline import prefetch_to_device
from two_tower_recommender_model.train.loop import evaluate
from two_tower_recommender_model.train.step import (
    create_train_state,
    make_eval_step,
    make_train_step,
)


def _train(loss, steps=250, seed=4):
    mcfg = cfg_lib.two_tower_model_config(num_users=120, num_items=60, embedding_dim=16,
                                          layer_sizes=(32, 16))
    mcfg = dataclasses.replace(
        mcfg,
        query_tower=dataclasses.replace(mcfg.query_tower, final_activation=False),
        candidate_tower=dataclasses.replace(mcfg.candidate_tower, final_activation=False),
    )
    tcfg = cfg_lib.TrainConfig(loss=loss, sparse_learning_rate=0.1, learning_rate=3e-3)
    ds = SyntheticClickstream(120, 60, seed=seed, noise=0.05, latent_dim=4)
    feat = Featurizer(mcfg)
    state, dense_opt = create_train_state(jax.random.key(0), mcfg, tcfg)
    tstep = make_train_step(mcfg, tcfg, dense_opt)
    for batch in prefetch_to_device(ds.batches(512, steps), feat):
        state, _ = tstep(state, batch)
    params = {"tables": state.tables, **state.dense_params}
    users = np.arange(1, 121)
    truth = ds.ground_truth_topk(users, k=10)
    positives = {int(u): truth[i].tolist() for i, u in enumerate(users)}
    m = evaluate_retrieval(params, mcfg, positives, k=20, ks=(10,))
    return m


def test_sampled_softmax_retrieval_competitive():
    """The north-star loss (in-batch sampled softmax) must produce retrieval
    quality at least in the BCE ballpark on the synthetic task (BASELINE.json
    requires matching recall with the loss swapped)."""
    m_soft = _train("sampled_softmax")
    m_bce = _train("bce")
    assert m_soft["recall_at_10"] > 0.35, (m_soft, m_bce)
    assert m_soft["recall_at_10"] > 0.8 * m_bce["recall_at_10"], (m_soft, m_bce)


def _numpy_init_state(mcfg, tcfg, seed=7):
    """Params from numpy RNG: jax.random output varies with which backend
    plugins are registered, so goldens pin a backend-independent init."""
    import jax.numpy as jnp
    from two_tower_recommender_model.train.step import TrainState
    from two_tower_recommender_model.train import optimizer as opt_lib

    rng = np.random.default_rng(seed)
    tables = {}
    for t in mcfg.tables:
        bound = (1.0 / t.num_embeddings) ** 0.5
        tables[t.name] = jnp.asarray(
            rng.uniform(-bound, bound, (t.num_embeddings, t.embedding_dim)), jnp.float32
        )
    def mlp(in_size, sizes):
        params, fan = {}, in_size
        for i, out in enumerate(sizes):
            b = 1.0 / np.sqrt(fan)
            params[f"layer_{i}"] = {
                "kernel": jnp.asarray(rng.uniform(-b, b, (fan, out)), jnp.float32),
                "bias": jnp.asarray(rng.uniform(-b, b, (out,)), jnp.float32),
            }
            fan = out
        return params
    from two_tower_recommender_model.models.two_tower import tower_in_dim
    dense_params = {
        "query_tower": mlp(tower_in_dim(mcfg, mcfg.query_tower), mcfg.query_tower.layer_sizes),
        "candidate_tower": mlp(tower_in_dim(mcfg, mcfg.candidate_tower),
                               mcfg.candidate_tower.layer_sizes),
    }
    dense_opt = opt_lib.dense_optimizer(tcfg.learning_rate)
    import jax.numpy as jnp2
    state = TrainState(
        step=jnp2.zeros((), np.int32),
        tables=tables,
        adagrad_acc={k: jnp2.zeros((v.shape[0],), np.float32) for k, v in tables.items()},
        dense_params=dense_params,
        dense_opt_state=dense_opt.init(dense_params),
    )
    return state, dense_opt


def test_golden_training_regression():
    """Fixed-seed short run pins loss/AUROC so silent numerical regressions
    surface. Tolerances allow for float drift only; init is numpy-seeded so
    the values are backend-independent."""
    mcfg = cfg_lib.two_tower_model_config(num_users=80, num_items=40, embedding_dim=8,
                                          layer_sizes=(16, 8))
    tcfg = cfg_lib.TrainConfig(sparse_learning_rate=0.05, learning_rate=1e-3)
    ds = SyntheticClickstream(80, 40, seed=123)
    feat = Featurizer(mcfg)
    state, dense_opt = _numpy_init_state(mcfg, tcfg)
    tstep = make_train_step(mcfg, tcfg, dense_opt, donate=False)
    losses = []
    for batch in prefetch_to_device(ds.batches(256, 20), feat):
        state, out = tstep(state, batch)
        losses.append(float(out["loss"]))
    metrics = evaluate(state, make_eval_step(mcfg, tcfg), ds.batches(256, 4, "val"), feat)
    # golden values captured 2026-08-17 (jax 0.9.0, CPU f32, highest matmul precision)
    np.testing.assert_allclose(losses[0], GOLDEN["first_loss"], rtol=1e-4)
    np.testing.assert_allclose(losses[-1], GOLDEN["last_loss"], rtol=1e-3)
    np.testing.assert_allclose(metrics["val_loss"], GOLDEN["val_loss"], rtol=1e-3)
    np.testing.assert_allclose(metrics["val_auroc"], GOLDEN["val_auroc"], rtol=5e-3)


GOLDEN = {
    "first_loss": 0.69946700,
    "last_loss": 0.69446814,
    "val_loss": 0.69243598,
    "val_auroc": 0.53349304,
}


def test_bfloat16_compute_close_to_f32():
    """compute_dtype=bfloat16 runs and stays numerically close over a short
    train (params remain f32; tower matmuls in bf16)."""
    results = {}
    for cd in ("float32", "bfloat16"):
        mcfg = cfg_lib.two_tower_model_config(num_users=80, num_items=40, embedding_dim=8,
                                              layer_sizes=(16, 8), compute_dtype=cd)
        tcfg = cfg_lib.TrainConfig()
        ds = SyntheticClickstream(80, 40, seed=5)
        feat = Featurizer(mcfg)
        state, dense_opt = create_train_state(jax.random.key(0), mcfg, tcfg)
        tstep = make_train_step(mcfg, tcfg, dense_opt, donate=False)
        for batch in prefetch_to_device(ds.batches(256, 10), feat):
            state, out = tstep(state, batch)
        assert state.tables["t_user_id"].dtype == np.float32  # params stay f32
        results[cd] = float(out["loss"])
    assert abs(results["bfloat16"] - results["float32"]) < 0.02, results


def test_bfloat16_table_storage():
    """table_dtype=bfloat16 stores tables in bf16 (halving gather HBM traffic
    at production scale) while towers and Adagrad accumulators stay f32;
    training numerics stay close to the f32 reference."""
    import dataclasses
    import jax.numpy as jnp

    results = {}
    for pd in ("float32", "bfloat16"):
        mcfg = cfg_lib.two_tower_model_config(100, 60, 16, (32, 16))
        mcfg = dataclasses.replace(mcfg, table_dtype=pd)
        tcfg = cfg_lib.TrainConfig()
        ds = SyntheticClickstream(100, 60, seed=0)
        feat = Featurizer(mcfg)
        state, dense_opt = create_train_state(jax.random.key(0), mcfg, tcfg)
        step = make_train_step(mcfg, tcfg, dense_opt, donate=False)
        for batch in prefetch_to_device(ds.batches(128, 10), feat):
            state, out = step(state, batch)
        assert state.tables["t_user_id"].dtype == jnp.dtype(pd)
        assert state.adagrad_acc["t_user_id"].dtype == np.float32
        results[pd] = float(out["loss"])
    assert abs(results["bfloat16"] - results["float32"]) < 0.01, results
