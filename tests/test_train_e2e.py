"""End-to-end: synthetic data -> train -> eval quality, plus the
train_val_test loop contract (baseline eval, epoch metrics, limits)."""

import dataclasses

import jax
import numpy as np

from two_tower_recommender_model import config as cfg_lib
from two_tower_recommender_model.data import Featurizer, SyntheticClickstream
from two_tower_recommender_model.train.loop import evaluate, train_val_test
from two_tower_recommender_model.train.pipeline import prefetch_to_device
from two_tower_recommender_model.train.step import (
    create_train_state,
    make_eval_step,
    make_train_step,
)


def _linear_head(mcfg):
    return dataclasses.replace(
        mcfg,
        query_tower=dataclasses.replace(mcfg.query_tower, final_activation=False),
        candidate_tower=dataclasses.replace(mcfg.candidate_tower, final_activation=False),
    )


def test_learns_above_chance():
    mcfg = _linear_head(
        cfg_lib.two_tower_model_config(num_users=300, num_items=120, embedding_dim=16,
                                       layer_sizes=(32, 16))
    )
    tcfg = cfg_lib.TrainConfig(sparse_learning_rate=0.1, learning_rate=3e-3)
    ds = SyntheticClickstream(300, 120, seed=3, noise=0.05, latent_dim=4)
    feat = Featurizer(mcfg)
    state, dense_opt = create_train_state(jax.random.key(0), mcfg, tcfg)
    tstep = make_train_step(mcfg, tcfg, dense_opt)
    estep = make_eval_step(mcfg, tcfg)
    base = evaluate(state, estep, ds.batches(512, 8, "val"), feat)
    for batch in prefetch_to_device(ds.batches(512, 300), feat):
        state, _ = tstep(state, batch)
    final = evaluate(state, estep, ds.batches(512, 8, "val"), feat)
    assert final["val_auroc"] > 0.75, (base, final)
    assert final["val_loss"] < base["val_loss"]


def test_train_val_test_contract():
    mcfg = cfg_lib.two_tower_model_config(num_users=50, num_items=30, embedding_dim=8,
                                          layer_sizes=(16, 8))
    tcfg = cfg_lib.TrainConfig(
        epochs=2, limit_train_batches=5, limit_val_batches=2, limit_test_batches=2,
        validation_freq=3,
    )
    ds = SyntheticClickstream(50, 30, seed=0)
    feat = Featurizer(mcfg)
    state, dense_opt = create_train_state(jax.random.key(0), mcfg, tcfg)
    tstep = make_train_step(mcfg, tcfg, dense_opt)
    estep = make_eval_step(mcfg, tcfg)

    logged = []

    class Logger:
        def log_metrics(self, m, step=None):
            logged.append((step, m))

    state, results = train_val_test(
        state, tstep, estep, mcfg, tcfg, feat,
        train_batches_factory=lambda ep: ds.batches(64, 10, split=f"e{ep}"),
        val_batches_factory=lambda: ds.batches(64, 4, split="val"),
        test_batches_factory=lambda: ds.batches(64, 4, split="test"),
        logger=Logger(),
    )
    # reference contract: baseline val, per-epoch val, final test (03_model_training.py:632-685)
    for key in ("baseline_val_loss", "baseline_val_auroc", "val_loss", "val_auroc",
                "test_loss", "test_auroc", "train_steps", "examples_per_sec"):
        assert key in results, key
    assert int(state.step) == 10  # 2 epochs x limit_train_batches=5
    assert results["train_steps"] == 5
    assert len(logged) >= 3
    assert all(np.isfinite(v) for v in results.values() if isinstance(v, float))


def test_determinism_same_seed():
    mcfg = cfg_lib.two_tower_model_config(num_users=40, num_items=20, embedding_dim=8)
    tcfg = cfg_lib.TrainConfig()
    ds = SyntheticClickstream(40, 20, seed=7)
    feat = Featurizer(mcfg)

    def run():
        state, dense_opt = create_train_state(jax.random.key(5), mcfg, tcfg)
        tstep = make_train_step(mcfg, tcfg, dense_opt, donate=False)
        for batch in prefetch_to_device(ds.batches(64, 5), feat):
            state, out = tstep(state, batch)
        return np.asarray(state.tables["t_user_id"]), float(out["loss"])

    t1, l1 = run()
    t2, l2 = run()
    np.testing.assert_array_equal(t1, t2)
    assert l1 == l2


def test_select_best_returns_best_epoch_state():
    """select_best: the returned state is the BEST-val-epoch state (compared
    against per-epoch snapshots captured via checkpoint_fn on an identical
    run), donation-safe, and the test metrics come from it."""
    mcfg = cfg_lib.two_tower_model_config(num_users=50, num_items=30, embedding_dim=8,
                                          layer_sizes=(16, 8))
    tcfg = cfg_lib.TrainConfig(epochs=3, limit_val_batches=2, limit_test_batches=2,
                               checkpoint_every_epochs=1)
    ds = SyntheticClickstream(50, 30, seed=0)
    feat = Featurizer(mcfg)

    def run(select_best, snapshots=None):
        state, dense_opt = create_train_state(jax.random.key(0), mcfg, tcfg)
        tstep = make_train_step(mcfg, tcfg, dense_opt)
        estep = make_eval_step(mcfg, tcfg)
        ckpt = None
        if snapshots is not None:
            def ckpt(s, epoch):
                snapshots.append(jax.tree.map(lambda x: np.asarray(x), s))
        return train_val_test(
            state, tstep, estep, mcfg, tcfg, feat,
            train_batches_factory=lambda ep: ds.batches(64, 6, split=f"e{ep}"),
            val_batches_factory=lambda: ds.batches(64, 4, split="val"),
            test_batches_factory=lambda: ds.batches(64, 4, split="test"),
            checkpoint_fn=ckpt, select_best=select_best,
        )

    snaps = []
    _, ref_results = run(None, snaps)
    assert len(snaps) == 3
    state, results = run("val_auroc")
    assert "best_epoch" in results
    best = int(results["best_epoch"])
    for name in state.tables:
        np.testing.assert_array_equal(
            np.asarray(state.tables[name]), snaps[best].tables[name])
    # with identical training, test metrics differ from the final-epoch run
    # unless the final epoch IS the best
    if best != 2:
        assert results["test_auroc"] != ref_results["test_auroc"]


def test_select_best_on_retrieval_metric():
    """retrieval_eval_fn merges per-epoch retrieval metrics into val metrics
    and select_best can consume them — the state kept is the epoch whose
    RECALL was best (AUROC misleads for the in-batch objective; the r2c
    finding this hook exists for). Uses a scripted eval fn to pin selection
    semantics, then the real make_retrieval_eval_fn for the metric surface."""
    from two_tower_recommender_model.evaluation.retrieval import (
        make_retrieval_eval_fn,
    )

    mcfg = cfg_lib.two_tower_model_config(num_users=50, num_items=30, embedding_dim=8,
                                          layer_sizes=(16, 8))
    tcfg = cfg_lib.TrainConfig(epochs=3, limit_val_batches=2, limit_test_batches=2,
                               checkpoint_every_epochs=1)
    ds = SyntheticClickstream(50, 30, seed=0)
    feat = Featurizer(mcfg)

    # scripted recall trajectory: best at epoch 1 (calls: baseline + 3 epochs)
    recalls = iter([0.05, 0.10, 0.30, 0.20])

    def scripted_eval(state):
        return {"val_recall_at_100": next(recalls)}

    snaps = []

    def ckpt(s, epoch):
        snaps.append(jax.tree.map(lambda x: np.asarray(x), s))

    state, dense_opt = create_train_state(jax.random.key(0), mcfg, tcfg)
    tstep = make_train_step(mcfg, tcfg, dense_opt)
    estep = make_eval_step(mcfg, tcfg)
    state, results = train_val_test(
        state, tstep, estep, mcfg, tcfg, feat,
        train_batches_factory=lambda ep: ds.batches(64, 6, split=f"e{ep}"),
        val_batches_factory=lambda: ds.batches(64, 4, split="val"),
        test_batches_factory=lambda: ds.batches(64, 4, split="test"),
        checkpoint_fn=ckpt, select_best="val_recall_at_100",
        retrieval_eval_fn=scripted_eval,
    )
    assert results["baseline_val_recall_at_100"] == 0.05
    assert results["best_epoch"] == 1.0
    for name in state.tables:
        np.testing.assert_array_equal(
            np.asarray(state.tables[name]), snaps[1].tables[name])

    # the real hook: finite metrics with the val_ prefix from a TrainState
    fn = make_retrieval_eval_fn(
        mcfg, {1: [3, 4], 2: [5]}, k=10, ks=(10,), max_users=10)
    m = fn(state)
    assert set(m) == {"val_recall_at_10", "val_num_users"} or "val_recall_at_10" in m
    assert np.isfinite(m["val_recall_at_10"])
