"""Adaptive hyperparameter search: TPE sampling + asynchronous successive
halving (ASHA), with a multi-process trial driver.

The role of the reference's Ray Tune + Optuna stack
(`ray_tune_optuna_tuning_alex_test.py:636-669`): `OptunaSearch()` (TPE) picks
configs from observed results, `max_concurrent_trials` runs them in parallel,
and Tune's schedulers stop hopeless trials early. Here:

- `TPESampler`: Tree-structured Parzen Estimator over the existing space
  primitives (`Choice`/`LogUniform`/`Uniform`): split observed trials at the
  gamma-quantile of the objective, model good/bad densities per dimension,
  and pick the candidate maximizing the good/bad likelihood ratio.
- `run_asha`: rung-based early stopping — every trial reports its metric per
  resource unit (epoch); a trial is promoted past rung r only while it ranks
  in the top 1/eta of that rung. Asynchronous: promotions happen as results
  arrive, workers never idle waiting for a rung to fill.
- both drivers take `max_workers`: trials run in OS processes
  (`ProcessPoolExecutor`, spawn) with per-trial logger dirs — the
  trial-parallel role of Ray actors. Each JAX process reserves most of an
  accelerator's memory when it first uses it, so on a GPU backend the
  drivers refuse max_workers > 1 unless every worker is given a share
  through `XLA_PYTHON_CLIENT_MEM_FRACTION` (see `check_worker_memory`).
"""

from __future__ import annotations

import dataclasses
import logging
import math
import traceback
from concurrent.futures import FIRST_COMPLETED, ProcessPoolExecutor, wait
from typing import Any, Callable, Mapping

import numpy as np

from two_tower_recommender_model.tuning.sweep import (
    Choice,
    LogUniform,
    SweepResult,
    TrialResult,
    call_trial as _call_trial,
    sample_space,
)

log = logging.getLogger(__name__)


# ---------------------------------------------------------------------------
# TPE


class TPESampler:
    """Minimal TPE: after `n_startup` random trials, sample `n_candidates`
    from the good-density model and keep the one with the best good/bad
    likelihood ratio. Deterministic given (seed, observation order)."""

    def __init__(self, space: Mapping[str, Any], seed: int = 0, gamma: float = 0.25,
                 n_startup: int = 5, n_candidates: int = 24):
        self.space = dict(space)
        self.rng = np.random.default_rng(np.random.SeedSequence([seed, 0x17E]))
        self.gamma = gamma
        self.n_startup = n_startup
        self.n_candidates = n_candidates
        self._obs: list[tuple[dict, float]] = []  # (config, objective; lower better)

    def observe(self, config: dict, objective: float) -> None:
        if math.isfinite(objective):
            self._obs.append((dict(config), float(objective)))

    def _split(self):
        srt = sorted(self._obs, key=lambda t: t[1])
        n_good = max(1, int(np.ceil(self.gamma * len(srt))))
        return [c for c, _ in srt[:n_good]], [c for c, _ in srt[n_good:]]

    def suggest(self) -> dict:
        if len(self._obs) < self.n_startup:
            return sample_space(self.space, self.rng)
        seen = {tuple(sorted(c.items())) for c, _ in self._obs}
        good, bad = self._split()
        best_cfg, best_score = None, -np.inf
        for _ in range(self.n_candidates):
            cfg = {}
            score = 0.0
            for k, dist in self.space.items():
                if not hasattr(dist, "sample"):
                    cfg[k] = dist
                    continue
                gv = [c[k] for c in good]
                bv = [c[k] for c in bad]
                if isinstance(dist, Choice):
                    # categorical: smoothed counts in the good set
                    opts = list(dist.options)
                    counts = np.array([1.0 + sum(1 for v in gv if v == o) for o in opts])
                    p = counts / counts.sum()
                    idx = self.rng.choice(len(opts), p=p)
                    cfg[k] = opts[idx]
                    bcounts = np.array([1.0 + sum(1 for v in bv if v == o) for o in opts])
                    score += np.log(p[idx] / (bcounts / bcounts.sum())[idx])
                else:
                    lo, hi = dist.low, dist.high
                    tolog = isinstance(dist, LogUniform)
                    f = np.log if tolog else (lambda x: x)
                    finv = np.exp if tolog else (lambda x: x)
                    width = f(hi) - f(lo)

                    def kde(v, pts, width=width, f=f, lo=lo, hi=hi):
                        if not pts:
                            return 1.0 / width
                        bw = max(width / max(len(pts), 1) ** 0.5, width * 0.05)
                        z = (f(v) - np.array([f(p) for p in pts])) / bw
                        return float(np.mean(np.exp(-0.5 * z * z) / (bw * np.sqrt(2 * np.pi)))
                                     + 1e-12)

                    # sample from the good KDE (pick an anchor point + noise)
                    if gv:
                        anchor = f(gv[self.rng.integers(len(gv))])
                        bw = max(width / len(gv) ** 0.5, width * 0.05)
                        v = float(np.clip(finv(anchor + self.rng.normal() * bw), lo, hi))
                    else:
                        v = dist.sample(self.rng)
                    cfg[k] = v
                    score += np.log(kde(v, gv) / kde(v, bv))
            if score > best_score:
                # never re-suggest an already-evaluated config (clipped
                # anchors at the space boundary otherwise converge to an
                # exact duplicate and burn the remaining trial budget on it)
                if tuple(sorted(cfg.items())) in seen:
                    continue
                best_cfg, best_score = cfg, score
        if best_cfg is None:  # every candidate was a duplicate: explore
            return sample_space(self.space, self.rng)
        return best_cfg


# ---------------------------------------------------------------------------
# parallel trial execution


def check_worker_memory(max_workers: int) -> None:
    """Refuse several trial processes on a GPU unless each has a share of it.

    A JAX process reserves `XLA_PYTHON_CLIENT_MEM_FRACTION` of a card's
    memory (0.75 unless set) when it first uses the card, so a second
    process on the same card fails for want of memory. This check itself
    brings up the backend, so the driver process holds a share as well."""
    if max_workers <= 1:
        return
    import os

    import jax

    if jax.default_backend() != "gpu":
        return
    frac = os.environ.get("XLA_PYTHON_CLIENT_MEM_FRACTION")
    if frac is None or float(frac) * (max_workers + 1) > 1.0:
        raise ValueError(
            f"max_workers={max_workers} trial processes on a GPU: each JAX "
            "process reserves XLA_PYTHON_CLIENT_MEM_FRACTION of the card's "
            "memory (0.75 unless set), and the driver process holds a share "
            f"too. Set XLA_PYTHON_CLIENT_MEM_FRACTION to at most "
            f"1/{max_workers + 1}, or use max_workers=1 (got {frac!r})."
        )


def run_adaptive_sweep(
    trial_fn: Callable[[dict], Mapping[str, float]],
    space: Mapping[str, Any],
    num_trials: int,
    metric: str = "val_loss",
    mode: str = "min",
    seed: int = 0,
    max_workers: int = 1,
    logger_root: str | None = None,
    gamma: float = 0.25,
    n_startup: int = 5,
) -> SweepResult:
    """TPE-guided sweep; `max_workers > 1` runs trials in OS processes
    (trial_fn must be picklable). The sampler observes results as they land,
    so later trials concentrate near the best region."""
    sign = 1.0 if mode == "min" else -1.0
    sampler = TPESampler(space, seed=seed, gamma=gamma, n_startup=n_startup)
    results: list[TrialResult] = []

    if max_workers <= 1:
        for i in range(num_trials):
            cfg = sampler.suggest()
            idx, cfg, metrics, err = _call_trial(trial_fn, cfg, i, logger_root)
            results.append(TrialResult(idx, cfg, metrics, error=err))
            if err is None and metric in metrics:
                sampler.observe(cfg, sign * metrics[metric])
            log.info("tpe trial %d: %s -> %s", i, cfg, metrics.get(metric))
        return SweepResult(results, metric, mode)

    check_worker_memory(max_workers)
    with ProcessPoolExecutor(max_workers=max_workers) as pool:
        pending: dict = {}  # future -> (trial index, config)
        launched = 0
        pool_broken = False

        def submit(cfg, idx):
            nonlocal pool_broken
            try:
                pending[pool.submit(_call_trial, trial_fn, cfg, idx, logger_root)] = (idx, cfg)
                return True
            except Exception:  # pool already broken: stop launching
                pool_broken = True
                return False

        while launched < num_trials and len(pending) < max_workers:
            if not submit(sampler.suggest(), launched):
                break
            launched += 1
        while pending:
            done, _ = wait(list(pending), return_when=FIRST_COMPLETED)
            for fut in done:
                fidx, fcfg = pending.pop(fut)
                try:
                    idx, cfg, metrics, err = fut.result()
                except Exception as e:
                    # worker process died (OOM/kill/segfault) — _call_trial
                    # catches in-trial exceptions, so this is process death.
                    # Record it and keep the completed results instead of
                    # letting BrokenProcessPool discard the whole sweep.
                    results.append(TrialResult(
                        fidx, fcfg, {}, error=f"worker died: {e!r}"))
                    pool_broken = True
                    continue
                results.append(TrialResult(idx, cfg, metrics, error=err))
                if err is None and metric in metrics:
                    sampler.observe(cfg, sign * metrics[metric])
                if launched < num_trials and not pool_broken:
                    if submit(sampler.suggest(), launched):
                        launched += 1
    results.sort(key=lambda t: t.index)
    return SweepResult(results, metric, mode)


# ---------------------------------------------------------------------------
# ASHA


@dataclasses.dataclass
class AshaTrial:
    index: int
    config: dict
    rung: int = 0
    resource: int = 0
    metric_value: float | None = None
    state: Any = None  # opaque resumable trial state (e.g. TrainState + loaders)
    stopped: bool = False
    error: str | None = None
    history: list = dataclasses.field(default_factory=list)


def run_asha(
    make_trial: Callable[[dict, int, Any], tuple[Any, Mapping[str, float]]],
    space: Mapping[str, Any],
    num_trials: int,
    metric: str = "val_loss",
    mode: str = "min",
    min_resource: int = 1,
    max_resource: int = 8,
    eta: int = 2,
    seed: int = 0,
    sampler: TPESampler | None = None,
) -> list[AshaTrial]:
    """Asynchronous successive halving. `make_trial(config, resource, state)`
    trains for `resource` ADDITIONAL units (epochs) from `state` (None on
    first call) and returns (new_state, metrics). A trial stops at rung r
    unless it ranks in the top 1/eta of all results recorded at rung r.

    Rungs get resource min_resource * eta^r up to max_resource; the schedule
    is the Tune/ASHA one — total resource spent is a fraction of
    num_trials * max_resource (asserted in tests)."""
    sign = 1.0 if mode == "min" else -1.0
    rng = np.random.default_rng(np.random.SeedSequence([seed, 0xA5A]))
    n_rungs = int(np.floor(np.log(max_resource / min_resource) / np.log(eta))) + 1
    rung_results: list[list[float]] = [[] for _ in range(n_rungs)]
    trials: list[AshaTrial] = []

    for i in range(num_trials):
        cfg = sampler.suggest() if sampler is not None else sample_space(space, rng)
        t = AshaTrial(index=i, config=cfg)
        trials.append(t)
        for r in range(n_rungs):
            budget = min_resource * eta**r
            grow = budget - t.resource
            try:
                t.state, metrics = make_trial(dict(t.config), grow, t.state)
            except Exception:
                t.error = traceback.format_exc()
                t.stopped = True
                break
            t.resource = budget
            t.rung = r
            raw = float(metrics.get(metric, float("nan")))
            if not math.isfinite(raw):
                # a diverged (NaN/inf) or missing metric must STOP the trial:
                # NaN compares False against the rung threshold, which would
                # promote the diverged trial through every rung and poison the
                # rung statistics
                t.error = f"non-finite or missing metric {metric!r}: {metrics.get(metric)!r}"
                t.stopped = True
                break
            val = sign * raw
            t.metric_value = val
            t.history.append((budget, dict(metrics)))
            rung_results[r].append(val)
            if sampler is not None and r == n_rungs - 1:
                sampler.observe(t.config, val)
            if r == n_rungs - 1:
                break
            # asynchronous promotion rule: continue only in the top 1/eta of
            # results seen AT THIS RUNG so far
            srt = sorted(rung_results[r])
            k = max(1, len(srt) // eta)
            if val > srt[k - 1]:
                t.stopped = True
                break
    return trials


def asha_best(trials: list[AshaTrial], mode: str = "min") -> AshaTrial:
    """Best trial AT THE HIGHEST REACHED RUNG. Metric values from different
    rungs are not comparable (a trial stopped after 1 epoch was explicitly
    judged not worth promoting — its early metric must not beat fully-trained
    survivors), so only trials that reached the deepest rung compete."""
    done = [t for t in trials
            if t.metric_value is not None and math.isfinite(t.metric_value)]
    if not done:
        raise RuntimeError("no completed trials")
    top_rung = max(t.rung for t in done)
    at_top = [t for t in done if t.rung == top_rung]
    return min(at_top, key=lambda t: t.metric_value)  # metric_value is sign-folded


def asha_total_resource(trials: list[AshaTrial]) -> int:
    return sum(t.resource for t in trials)
