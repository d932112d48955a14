"""Sweeps: space sampling determinism, ranking, failure handling, grid
search, vmapped multi-seed trials."""

import numpy as np
import pytest

from two_tower_recommender_model import config as cfg_lib
from two_tower_recommender_model.data import Featurizer, SyntheticClickstream
from two_tower_recommender_model.tuning import (
    Choice,
    LogUniform,
    Uniform,
    multi_seed_train,
    run_sweep,
    sample_space,
)
from two_tower_recommender_model.tuning.sweep import grid_space


SPACE = {
    "layer_sizes": Choice(((128, 64), (128, 64, 32))),
    "mlp_lr": LogUniform(1e-4, 1e-2),
    "dropout": Uniform(0.0, 0.5),
    "batch_size": Choice((128, 256)),
    "fixed": "constant",
}


def test_sampling_deterministic():
    rng1 = np.random.default_rng(np.random.SeedSequence([0, 1]))
    rng2 = np.random.default_rng(np.random.SeedSequence([0, 1]))
    assert sample_space(SPACE, rng1) == sample_space(SPACE, rng2)
    s = sample_space(SPACE, np.random.default_rng(0))
    assert 1e-4 <= s["mlp_lr"] <= 1e-2
    assert s["fixed"] == "constant"


def test_grid_space_cartesian():
    grid = grid_space({"a": Choice((1, 2)), "b": Choice((10, 20, 30)), "c": "x"})
    assert len(grid) == 6
    assert {"a": 1, "b": 20, "c": "x"} in grid


def test_sweep_ranks_and_best():
    def trial(config):
        return {"val_loss": (config["x"] - 0.3) ** 2}

    res = run_sweep(trial, {"x": Uniform(0, 1)}, num_trials=20, metric="val_loss", seed=1)
    assert len(res.completed()) == 20
    best = res.best()
    assert abs(best.config["x"] - 0.3) < 0.15
    ranked = res.ranked()
    vals = [t.metrics["val_loss"] for t in ranked]
    assert vals == sorted(vals)
    assert "val_loss" in res.table()


def test_sweep_mode_max():
    res = run_sweep(lambda c: {"auroc": c["x"]}, {"x": Uniform(0, 1)},
                    num_trials=5, metric="auroc", mode="max", seed=0)
    assert res.best().metrics["auroc"] == max(t.metrics["auroc"] for t in res.trials)


def test_sweep_failures_recorded(tmp_path):
    def trial(config):
        if config["x"] > 0.5:
            raise RuntimeError("boom")
        return {"val_loss": config["x"]}

    res = run_sweep(trial, {"x": Uniform(0, 1)}, num_trials=10, seed=3,
                    logger_root=str(tmp_path / "runs"))
    failed = [t for t in res.trials if t.error]
    assert failed and len(res.completed()) + len(failed) == 10
    assert "FAILED" in res.table()
    from two_tower_recommender_model.utils.tracking import list_runs
    assert len(list_runs(str(tmp_path / "runs"))) == 10


def test_sweep_reproducible():
    logged = []
    def trial(c):
        logged.append(c)
        return {"val_loss": c["x"]}
    run_sweep(trial, {"x": Uniform(0, 1)}, num_trials=4, seed=9)
    first = list(logged); logged.clear()
    run_sweep(trial, {"x": Uniform(0, 1)}, num_trials=4, seed=9)
    assert first == logged


def test_multi_seed_train_varies_by_seed():
    mcfg = cfg_lib.two_tower_model_config(num_users=40, num_items=25, embedding_dim=8,
                                          layer_sizes=(16, 8))
    tcfg = cfg_lib.TrainConfig()
    ds = SyntheticClickstream(40, 25, seed=0)
    out = multi_seed_train(
        mcfg, tcfg, seeds=[0, 1, 2],
        train_batches=ds.batches(64, 8),
        eval_batch=ds.sample(256, "val"),
    )
    assert out["final_train_loss"].shape == (3,)
    assert out["eval_auroc"].shape == (3,)
    assert np.isfinite(out["final_train_loss"]).all()
    # different seeds -> different models
    assert len(np.unique(out["final_train_loss"].round(8))) > 1
