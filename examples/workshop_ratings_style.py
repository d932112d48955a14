"""Workshop-path example: explicit ratings -> binary labels -> small-table
two-tower -> HTTP serving endpoint.

Mirrors the reference's workshop chain (`workshop/01-mosaic-streaming.py`
ratings + mean-threshold labels with small tables [193 users, 9740 items];
`workshop/02-mosaic-model-training.py` training + PyFunc + endpoint;
REST invocation `:1423-1430`)."""

from __future__ import annotations

import json
import urllib.request

import jax
import numpy as np

from two_tower_recommender_model import config as cfg
from two_tower_recommender_model.data import Featurizer
from two_tower_recommender_model.data.feature_engineering import binarize_ratings
from two_tower_recommender_model.serving import Scorer
from two_tower_recommender_model.serving.server import ModelServer, validate_serving_input
from two_tower_recommender_model.train import (
    create_train_state, make_eval_step, make_train_step, train_val_test)


def synth_ratings(n, n_users=193, n_items=9740, seed=0):
    """Ratings-shaped synthetic data (the workshop's Learning-From-Sets
    sample dims, `workshop/02-mosaic-model-training.py:136`)."""
    rng = np.random.default_rng(seed)
    users = rng.integers(1, n_users + 1, n)
    items = rng.integers(1, n_items + 1, n)
    # user-mean-anchored ratings so labels carry user signal
    base = 2.5 + 1.5 * np.sin(users * 0.7) * np.cos(items * 0.3)
    ratings = np.clip(base + rng.normal(0, 0.8, n), 0.5, 5.0)
    return {"user_id": users, "product_id": items, "rating": ratings}


def main():
    n_users, n_items = 193, 9740
    import dataclasses
    mcfg = cfg.two_tower_model_config(n_users + 1, n_items + 1,
                                      embedding_dim=64, layer_sizes=(128, 64))
    # linear heads + a hot sparse lr: the small-table workshop config learns
    # per-id biases quickly (the all-ReLU default needs far more data)
    mcfg = dataclasses.replace(
        mcfg,
        query_tower=dataclasses.replace(mcfg.query_tower, final_activation=False),
        candidate_tower=dataclasses.replace(mcfg.candidate_tower, final_activation=False))
    tcfg = cfg.TrainConfig(epochs=2, sparse_learning_rate=0.1, learning_rate=3e-3,
                           limit_val_batches=4, limit_test_batches=4)
    feat = Featurizer(mcfg)

    def batches(n_batches, seed):
        def gen():
            for i in range(n_batches):
                cols = synth_ratings(1024, seed=seed * 1000 + i)
                cols["label"] = binarize_ratings(cols.pop("rating"))
                yield cols
        return gen()

    state, dense_opt = create_train_state(jax.random.key(0), mcfg, tcfg)
    state, results = train_val_test(
        state, make_train_step(mcfg, tcfg, dense_opt), make_eval_step(mcfg, tcfg),
        mcfg, tcfg, feat,
        train_batches_factory=lambda ep: batches(150, ep),
        val_batches_factory=lambda: batches(4, 777),
        test_batches_factory=lambda: batches(4, 888),
    )
    print("train:", {k: round(v, 4) for k, v in results.items() if "auroc" in k})

    scorer = Scorer(mcfg, {"tables": state.tables, **state.dense_params})
    payload = {"dataframe_split": {"columns": ["user_id", "product_id"],
                                   "data": [[1, 42], [2, 99]]}}
    validate_serving_input(scorer, payload)  # pre-deployment contract check

    with ModelServer(scorer) as srv:
        req = urllib.request.Request(
            srv.url + "/invocations", json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=10) as r:
            out = json.loads(r.read())
    print("endpoint predictions:", [round(p, 4) for p in out["predictions"]])
    assert results["test_auroc"] > 0.6, results
    print("WORKSHOP E2E OK")
    return results


if __name__ == "__main__":
    main()
