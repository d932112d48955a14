"""Resilient training: restart-on-failure with checkpoint resume produces the
same final state as an uninterrupted run; logQ streaming counts; ratings
binarization."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from two_tower_recommender_model import config as cfg_lib
from two_tower_recommender_model.data import Featurizer, SyntheticClickstream
from two_tower_recommender_model.data.feature_engineering import binarize_ratings
from two_tower_recommender_model.train.resilient import TrainingFailure, resilient_fit
from two_tower_recommender_model.train.step import create_train_state, make_train_step
from two_tower_recommender_model.utils.checkpoint import Checkpointer


def test_resilient_fit_retries_and_reports():
    calls = []

    def attempt(restart):
        calls.append(restart)
        if restart < 2:
            raise OSError(f"boom {restart}")  # transient class: retried
        return {"ok": 1.0}

    out = resilient_fit(attempt, max_restarts=3, backoff_s=0.0)
    assert out["ok"] == 1.0 and out["restarts"] == 2
    assert len(out["failures"]) == 2
    assert calls == [0, 1, 2]


def test_resilient_fit_exhausts():
    with pytest.raises(TrainingFailure, match="after 2 restarts"):
        resilient_fit(lambda r: (_ for _ in ()).throw(ConnectionError("x")),
                      max_restarts=2, backoff_s=0.0)


def test_resilient_fit_bug_raises_immediately():
    """Programming bugs are NOT transient: the default retry set must let
    them surface on the first attempt instead of 'recovering' max_restarts
    times."""
    calls = []

    def buggy(restart):
        calls.append(restart)
        raise ValueError("shape mismatch")  # bug class

    with pytest.raises(ValueError, match="shape mismatch"):
        resilient_fit(buggy, max_restarts=3, backoff_s=0.0)
    assert calls == [0]  # no retry


def test_resilient_fit_transient_types_cover_xla_runtime():
    from two_tower_recommender_model.train.resilient import (
        transient_error_types,
    )

    types = transient_error_types()
    assert OSError in types and TimeoutError in types
    import jax.errors

    assert jax.errors.JaxRuntimeError in types
    # but plain RuntimeError (bug class) is not retried by default
    assert not issubclass(RuntimeError, types)


def test_resilient_fit_optin_retry_everything():
    """retry_on=(Exception,) restores the old babysitting behavior."""
    calls = []

    def attempt(restart):
        calls.append(restart)
        if restart == 0:
            raise RuntimeError("flaky bug")
        return {"ok": 1.0}

    out = resilient_fit(attempt, max_restarts=1, backoff_s=0.0,
                        retry_on=(Exception,))
    assert out["restarts"] == 1 and calls == [0, 1]


def test_resilient_fit_logs_traceback(caplog):
    """The full stack must land in the log — only str(e) survives in the
    failure list, and a recurring transient needs its stack diagnosable."""
    import logging

    def attempt(restart):
        if restart == 0:
            raise OSError("shard read failed")
        return {"ok": 1.0}

    with caplog.at_level(logging.WARNING,
                         logger="two_tower_recommender_model.train.resilient"):
        resilient_fit(attempt, max_restarts=1, backoff_s=0.0)
    joined = "\n".join(r.getMessage() for r in caplog.records)
    assert "Traceback" in joined and "shard read failed" in joined


def test_crash_resume_equals_uninterrupted(tmp_path):
    """Kill training mid-run (injected); the resumed run must land on the
    same final state as a run that never crashed."""
    mcfg = cfg_lib.two_tower_model_config(num_users=50, num_items=30, embedding_dim=8,
                                          layer_sizes=(16, 8))
    tcfg = cfg_lib.TrainConfig()
    ds = SyntheticClickstream(50, 30, seed=0)
    feat = Featurizer(mcfg)
    batches = [jax.tree.map(jnp.asarray, feat(ds.sample(64, start=i))) for i in range(10)]

    # uninterrupted reference
    ref_state, dense_opt = create_train_state(jax.random.key(0), mcfg, tcfg)
    step_fn = make_train_step(mcfg, tcfg, dense_opt, donate=False)
    for b in batches:
        ref_state, _ = step_fn(ref_state, b)

    ckpt = Checkpointer(str(tmp_path / "c"))
    crash_at = 6

    def attempt(restart):
        state, _ = create_train_state(jax.random.key(0), mcfg, tcfg)
        start = 0
        if ckpt.latest_step() is not None:
            state, loader_state, _ = ckpt.restore(state)
            start = loader_state["batches_yielded"]
        for i in range(start, len(batches)):
            state, _ = step_fn(state, batches[i])
            ckpt.save(int(state.step), state,
                      loader_state={"batches_yielded": i + 1}, wait=True)
            if restart == 0 and i + 1 == crash_at:
                raise OSError("injected crash")  # transient class
        attempt.final_state = state
        return {"done": 1.0}

    out = resilient_fit(attempt, max_restarts=1, backoff_s=0.0)
    assert out["restarts"] == 1
    got = attempt.final_state
    for name in ref_state.tables:
        np.testing.assert_array_equal(np.asarray(got.tables[name]),
                                      np.asarray(ref_state.tables[name]))
    assert int(got.step) == int(ref_state.step) == 10
    ckpt.close()


def test_streaming_logq_counts():
    mcfg = cfg_lib.two_tower_model_config(num_users=50, num_items=30, embedding_dim=8,
                                          layer_sizes=(16, 8))
    tcfg = cfg_lib.TrainConfig(loss="sampled_softmax", logq_correction=True)
    ds = SyntheticClickstream(50, 30, seed=0)
    feat = Featurizer(mcfg)
    state, dense_opt = create_train_state(jax.random.key(0), mcfg, tcfg)
    assert state.item_counts is not None and state.item_counts.shape == (30,)
    step = make_train_step(mcfg, tcfg, dense_opt, donate=False)
    total = 0
    for i in range(3):
        b = jax.tree.map(jnp.asarray, feat(ds.sample(64, start=i)))
        state, out = step(state, b)
        total += 64
    assert float(state.item_counts.sum()) == total
    assert np.isfinite(float(out["loss"]))
    # disabled when logq off
    tcfg2 = cfg_lib.TrainConfig(loss="sampled_softmax", logq_correction=False)
    s2, _ = create_train_state(jax.random.key(0), mcfg, tcfg2)
    assert s2.item_counts is None


def test_binarize_ratings():
    r = np.array([1.0, 2.0, 3.0, 4.0, 5.0])
    np.testing.assert_array_equal(binarize_ratings(r), [0, 0, 1, 1, 1])  # mean=3
    np.testing.assert_array_equal(binarize_ratings(r, threshold=4.5), [0, 0, 0, 0, 1])
