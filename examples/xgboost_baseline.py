"""Gradient-boosted-trees comparison baseline (the reference's Ray-XGBoost
workshop harness, SURVEY §2.7).

Role parity with `workshop/ray-xgboost/01-create-dataset.py:35-60` (synthetic
tabular dataset: `num_training_rows` rows x `num_training_columns` uniform
float features + an integer target of `num_labels` classes) and
`02-ray-xgboost-example.py:170-308` (histogram-boosted trees, binary
`logistic` / multiclass `softprob` objective switched on `num_labels`,
`n_estimators` rounds at `max_depth`, wall-clock + metrics logged to MLflow).

Notes: gradient-boosted trees are a HOST workload here — histogram tree
building is not what the accelerator path is for, so this baseline
intentionally runs on CPU via sklearn's `HistGradientBoostingClassifier` (the same
histogram-split algorithm class as `tree_method="hist"` XGBoost; the
xgboost package itself is not in this image). Its purpose here is what it
is in the reference: a tabular-model timing/quality baseline to hold next
to the two-tower training numbers, logged through the same tracking store.

Run: python examples/xgboost_baseline.py [--rows 100000] [--cols 100]
     [--labels 2] [--estimators 100] [--depth 6]
"""

from __future__ import annotations

import argparse
import time

import numpy as np


def make_synthetic_table(rows: int, cols: int, labels: int, seed: int = 0):
    """The 01-create-dataset shape: uniform float features, integer target.

    A purely random target is unlearnable (the reference's choice — its
    harness measures THROUGHPUT); to also report a meaningful AUROC we make
    the target depend on a random linear score of the features plus noise,
    which histogram trees can learn, while keeping the same column types."""
    rng = np.random.default_rng(seed)
    x = rng.random((rows, cols), dtype=np.float32)
    w = rng.normal(size=cols).astype(np.float32) / np.sqrt(cols)
    score = x @ w + 0.3 * rng.normal(size=rows).astype(np.float32)
    if labels == 2:
        y = (score > np.median(score)).astype(np.int32)
    else:
        qs = np.quantile(score, np.linspace(0, 1, labels + 1)[1:-1])
        y = np.searchsorted(qs, score).astype(np.int32)
    return x, y


def train_baseline(rows: int = 100_000, cols: int = 100, labels: int = 2,
                   estimators: int = 100, depth: int = 6,
                   runs_root: str | None = None, seed: int = 0) -> dict:
    from sklearn.metrics import log_loss, roc_auc_score
    from sklearn.model_selection import train_test_split
    from sklearn.ensemble import HistGradientBoostingClassifier

    x, y = make_synthetic_table(rows, cols, labels, seed=seed)
    x_tr, x_va, y_tr, y_va = train_test_split(
        x, y, test_size=0.2, random_state=seed)

    model = HistGradientBoostingClassifier(
        max_iter=estimators, max_depth=depth, random_state=seed,
        early_stopping=False,
    )
    t0 = time.perf_counter()
    model.fit(x_tr, y_tr)
    fit_s = time.perf_counter() - t0

    proba = model.predict_proba(x_va)
    metrics = {
        "fit_seconds": round(fit_s, 3),
        "rows_per_sec": round(len(x_tr) / fit_s, 1),
        "valid_logloss": round(float(log_loss(y_va, proba)), 5),
    }
    if labels == 2:
        metrics["valid_auroc"] = round(float(roc_auc_score(y_va, proba[:, 1])), 5)
    else:
        metrics["valid_error"] = round(
            float((proba.argmax(1) != y_va).mean()), 5)

    if runs_root:
        from two_tower_recommender_model.utils.tracking import ExperimentLogger

        logger = ExperimentLogger(runs_root)
        logger.log_params({
            "model": "hist_gradient_boosting",
            "num_training_rows": rows, "num_training_columns": cols,
            "num_labels": labels, "n_estimators": estimators,
            "max_depth": depth,
            "objective": "binary:logistic" if labels == 2 else "multi:softprob",
        })
        logger.log_metrics(metrics)
        metrics["run_id"] = logger.run_id
    return metrics


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=100_000)
    ap.add_argument("--cols", type=int, default=100)
    ap.add_argument("--labels", type=int, default=2)
    ap.add_argument("--estimators", type=int, default=100)
    ap.add_argument("--depth", type=int, default=6)
    ap.add_argument("--runs-root", default="runs/xgboost_baseline")
    args = ap.parse_args()
    out = train_baseline(args.rows, args.cols, args.labels, args.estimators,
                         args.depth, runs_root=args.runs_root)
    print(out)


if __name__ == "__main__":
    main()
