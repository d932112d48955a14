"""Hyperparameter sweeps: random/grid search with ranked results.

The role of the reference's Ray Tune + Optuna stack
(`ray_tune_optuna_tuning_alex_test.py:594-669`): a search space of categorical
choices (`layer_sizes`, batch size) and log-uniform learning rates
(`mlp_lr`/`ebc_lr`, `:600-612`), `num_samples` trials, optimizing
`metric="val_loss", mode="min"`, with per-trial results reported and a best
config (`:657-669`). No cluster scheduler: trials are plain function calls the
caller can parallelize (or vmap across seeds via `tuning/multi_seed.py`).

Space primitives are deterministic in (seed, trial_index) so sweeps reproduce.
"""

from __future__ import annotations

import dataclasses
import itertools
import logging
import traceback
from typing import Any, Callable, Mapping

import numpy as np

log = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class Choice:
    options: tuple

    def sample(self, rng):
        return self.options[rng.integers(len(self.options))]

    def grid(self):
        return list(self.options)


@dataclasses.dataclass(frozen=True)
class LogUniform:
    low: float
    high: float

    def sample(self, rng):
        return float(np.exp(rng.uniform(np.log(self.low), np.log(self.high))))

    def grid(self, n: int = 3):
        return list(np.exp(np.linspace(np.log(self.low), np.log(self.high), n)))


@dataclasses.dataclass(frozen=True)
class Uniform:
    low: float
    high: float

    def sample(self, rng):
        return float(rng.uniform(self.low, self.high))

    def grid(self, n: int = 3):
        return list(np.linspace(self.low, self.high, n))


def sample_space(space: Mapping[str, Any], rng) -> dict:
    out = {}
    for k, v in space.items():
        out[k] = v.sample(rng) if hasattr(v, "sample") else v
    return out


def grid_space(space: Mapping[str, Any]) -> list[dict]:
    keys, axes = [], []
    for k, v in space.items():
        keys.append(k)
        axes.append(v.grid() if hasattr(v, "grid") else [v])
    return [dict(zip(keys, combo)) for combo in itertools.product(*axes)]


@dataclasses.dataclass
class TrialResult:
    index: int
    config: dict
    metrics: dict
    error: str | None = None


@dataclasses.dataclass
class SweepResult:
    trials: list[TrialResult]
    metric: str
    mode: str

    def completed(self) -> list[TrialResult]:
        return [t for t in self.trials if t.error is None and self.metric in t.metrics]

    def ranked(self) -> list[TrialResult]:
        sign = 1.0 if self.mode == "min" else -1.0
        return sorted(self.completed(), key=lambda t: sign * t.metrics[self.metric])

    def best(self) -> TrialResult:
        ranked = self.ranked()
        if not ranked:
            raise RuntimeError("no completed trials")
        return ranked[0]

    def table(self) -> str:
        lines = [f"{'#':<4}{self.metric:>14}  config"]
        for t in self.ranked():
            lines.append(f"{t.index:<4}{t.metrics[self.metric]:>14.5f}  {t.config}")
        for t in self.trials:
            if t.error is not None:
                lines.append(f"{t.index:<4}{'FAILED':>14}  {t.config}  ({t.error.splitlines()[-1]})")
        return "\n".join(lines)


def call_trial(trial_fn, config, trial_index, logger_root):
    """One trial invocation + per-trial logger dir; top-level so it pickles
    into worker processes."""
    try:
        metrics = dict(trial_fn(dict(config)))
        err = None
    except Exception:
        metrics, err = {}, traceback.format_exc()
    if logger_root is not None:
        from two_tower_recommender_model.utils.tracking import ExperimentLogger

        tl = ExperimentLogger(logger_root, run_id=f"trial_{trial_index:04d}")
        tl.log_params(config)
        if err is None:
            tl.log_metrics(metrics)
    return trial_index, config, metrics, err


def run_sweep(
    trial_fn: Callable[[dict], Mapping[str, float]],
    space: Mapping[str, Any],
    num_trials: int | None = None,
    metric: str = "val_loss",
    mode: str = "min",
    seed: int = 0,
    search: str = "random",  # "random" | "grid" | "tpe"
    logger_root: str | None = None,
    raise_on_failure: bool = False,
    max_workers: int = 1,
) -> SweepResult:
    """Run trials of `trial_fn(config) -> metrics`. Failures are recorded, not
    fatal (the reference's trials likewise report per-trial status).
    `search="tpe"` routes to the adaptive sampler (`tuning/adaptive.py`);
    `max_workers > 1` runs trials concurrently in OS processes (trial_fn must
    be picklable) — the `max_concurrent_trials` role of the reference's Tune
    setup (`ray_tune_optuna_tuning_alex_test.py:654-659`)."""
    if search == "tpe":
        from two_tower_recommender_model.tuning.adaptive import run_adaptive_sweep

        if num_trials is None:
            raise ValueError("tpe search requires num_trials")
        return run_adaptive_sweep(
            trial_fn, space, num_trials, metric=metric, mode=mode, seed=seed,
            max_workers=max_workers, logger_root=logger_root,
        )
    if search == "grid":
        configs = grid_space(space)
        if num_trials is not None:
            configs = configs[:num_trials]
    else:
        if num_trials is None:
            raise ValueError("random search requires num_trials")
        configs = [
            sample_space(space, np.random.default_rng(np.random.SeedSequence([seed, i])))
            for i in range(num_trials)
        ]

    results: list[TrialResult] = []
    if max_workers > 1:
        from concurrent.futures import ProcessPoolExecutor

        from two_tower_recommender_model.tuning.adaptive import check_worker_memory

        check_worker_memory(max_workers)
        with ProcessPoolExecutor(max_workers=max_workers) as pool:
            futs = [
                pool.submit(call_trial, trial_fn, cfg, i, logger_root)
                for i, cfg in enumerate(configs)
            ]
            for fut in futs:
                i, config, metrics, err = fut.result()
                if err is not None and raise_on_failure:
                    raise RuntimeError(err)
                results.append(TrialResult(i, config, metrics, error=err))
        results.sort(key=lambda t: t.index)
        return SweepResult(results, metric, mode)
    for i, config in enumerate(configs):
        i, config, metrics, err = call_trial(trial_fn, config, i, logger_root)
        if err is not None:
            if raise_on_failure:
                raise RuntimeError(err)
            log.warning("trial %d failed: %s", i, err.splitlines()[-1])
        else:
            log.info("trial %d: %s -> %s", i, config, metrics.get(metric))
        results.append(TrialResult(i, config, metrics, error=err))
    return SweepResult(results, metric, mode)
