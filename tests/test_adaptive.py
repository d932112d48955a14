"""Adaptive search (TPE, ASHA) + multiprocess trial driver — the Ray Tune /
Optuna role (`ray_tune_optuna_tuning_alex_test.py:636-669`)."""

import time

import numpy as np
import pytest

from two_tower_recommender_model.tuning.adaptive import (
    TPESampler,
    asha_best,
    asha_total_resource,
    run_adaptive_sweep,
    run_asha,
)
from two_tower_recommender_model.tuning.sweep import (
    Choice,
    LogUniform,
    Uniform,
    run_sweep,
)

SPACE = {
    "lr": LogUniform(1e-4, 1.0),
    "width": Uniform(-2.0, 2.0),
    "arch": Choice(("a", "b", "c")),
}


def objective(cfg):
    """Minimum near lr=0.03, width=0.5, arch='b'."""
    val = (
        (np.log10(cfg["lr"]) - np.log10(0.03)) ** 2
        + (cfg["width"] - 0.5) ** 2
        + (0.0 if cfg["arch"] == "b" else 0.6)
    )
    return {"val_loss": float(val)}


def test_tpe_beats_random_at_equal_budget():
    budget = 40
    rnd = run_sweep(objective, SPACE, num_trials=budget, search="random", seed=7)
    tpe = run_sweep(objective, SPACE, num_trials=budget, search="tpe", seed=7)
    best_rnd = rnd.best().metrics["val_loss"]
    best_tpe = tpe.best().metrics["val_loss"]
    assert best_tpe <= best_rnd, (best_tpe, best_rnd)
    # and TPE concentrates: its mean top-5 is strictly better
    top5 = lambda r: np.mean([t.metrics["val_loss"] for t in r.ranked()[:5]])  # noqa: E731
    assert top5(tpe) < top5(rnd), (top5(tpe), top5(rnd))


def test_tpe_sampler_concentrates_on_good_region():
    s = TPESampler(SPACE, seed=0, n_startup=8)
    rng = np.random.default_rng(0)
    for _ in range(40):
        cfg = s.suggest()
        s.observe(cfg, objective(cfg)["val_loss"])
        _ = rng  # determinism handled inside the sampler
    late = [s.suggest() for _ in range(20)]
    # most late suggestions pick the best categorical arm
    assert sum(1 for c in late if c["arch"] == "b") >= 12
    lrs = np.array([c["lr"] for c in late])
    assert np.median(np.abs(np.log10(lrs) - np.log10(0.03))) < 1.2


def test_asha_early_stops_and_finds_optimum():
    """Trials whose config is bad must be cut at low rungs; the total
    resource must be well below num_trials * max_resource; the survivor must
    be near-optimal. make_trial simulates a loss that improves with resource
    toward the config's asymptote."""
    calls = []

    def make_trial(cfg, grow, state):
        asymptote = objective(cfg)["val_loss"]
        used = (state or 0) + grow
        calls.append((cfg["arch"], grow))
        return used, {"val_loss": asymptote + 2.0 / used}

    trials = run_asha(make_trial, SPACE, num_trials=24, min_resource=1,
                      max_resource=8, eta=2, seed=3)
    total = asha_total_resource(trials)
    assert total < 24 * 8 * 0.6, total  # early stopping saved >40% resource
    best = asha_best(trials)
    assert best.resource == 8  # the winner ran the full budget
    assert objective(best.config)["val_loss"] < 1.0
    stopped_early = [t for t in trials if t.stopped]
    assert len(stopped_early) >= 8  # plenty of trials cut at low rungs
    # history records every rung the trial reached
    assert all(len(t.history) >= 1 for t in trials if t.error is None)


def _slow_trial(cfg):
    t0 = time.time()
    time.sleep(1.5)
    return {"val_loss": cfg["width"] ** 2, "t_start": t0, "t_end": time.time()}


@pytest.mark.slow
def test_parallel_trials_run_concurrently(tmp_path):
    space = {"width": Uniform(-1, 1)}
    res = run_sweep(_slow_trial, space, num_trials=4, search="random",
                    max_workers=4, logger_root=str(tmp_path))
    done = res.completed()
    assert len(done) == 4
    # concurrency proof: trial wall-time intervals overlap (worker process
    # startup cost makes total wall-clock an unreliable bound)
    starts = [t.metrics["t_start"] for t in done]
    ends = [t.metrics["t_end"] for t in done]
    overlaps = sum(
        1
        for i in range(4)
        for j in range(i + 1, 4)
        if starts[i] < ends[j] and starts[j] < ends[i]
    )
    assert overlaps >= 3, (starts, ends)
    # per-trial logger dirs exist
    assert len(list(tmp_path.glob("trial_*"))) == 4


@pytest.mark.slow
def test_adaptive_sweep_parallel_driver():
    res = run_adaptive_sweep(_slow_trial, {"width": Uniform(-1, 1)},
                             num_trials=5, max_workers=3, n_startup=2)
    assert len(res.completed()) == 5
    assert res.best().metrics["val_loss"] <= min(
        t.metrics["val_loss"] for t in res.completed()
    )


def test_tpe_never_resuggests_observed_config():
    """Clipped boundary anchors used to converge to an exact duplicate and
    burn the remaining trial budget re-evaluating one config."""
    from two_tower_recommender_model.tuning.adaptive import TPESampler
    from two_tower_recommender_model.tuning.sweep import LogUniform

    space = {"x": LogUniform(0.1, 1.0)}
    s = TPESampler(space, seed=0, n_startup=2)
    seen = []
    for i in range(12):
        cfg = s.suggest()
        assert cfg not in seen, f"duplicate suggestion at trial {i}: {cfg}"
        seen.append(dict(cfg))
        # objective pulls hard toward the x=0.1 boundary (the clip corner)
        s.observe(cfg, cfg["x"])
