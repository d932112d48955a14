"""End-to-end example: raw interactions -> feature engineering -> TTRS shards
-> streaming training -> checkpoint/resume -> export -> serving -> retrieval
eval. The single-host walk of the reference's notebook chain
(01_data_prep -> 02_feature_engineering -> 03_model_training ->
04_evaluate_retrieval)."""

import dataclasses
import os
import sys
import tempfile

import jax
import numpy as np
import pandas as pd

from two_tower_recommender_model import config as cfg
from two_tower_recommender_model.data import Featurizer, SyntheticClickstream
from two_tower_recommender_model.data.feature_engineering import (
    build_positive_pairs, index_ids, per_user_split, sample_negatives,
    splits_to_columns, union_pos_neg)
from two_tower_recommender_model.data.loader import StreamLoader
from two_tower_recommender_model.data.shards import write_dataset
from two_tower_recommender_model.evaluation import evaluate_retrieval
from two_tower_recommender_model.serving import load_scorer
from two_tower_recommender_model.train import (
    create_train_state, make_eval_step, make_train_step, train_val_test)
from two_tower_recommender_model.utils.checkpoint import Checkpointer, export_model
from two_tower_recommender_model.utils.tracking import ExperimentLogger


def main(work: str | None = None) -> dict:
    work = work or tempfile.mkdtemp(prefix="two_tower_e2e_")

    # 1. "raw" interactions -> positives + sampled negatives -> split -> index
    ds0 = SyntheticClickstream(800, 300, seed=9, noise=0.05, latent_dim=4)
    raw = ds0.sample(40_000)
    inter = pd.DataFrame({"user_id": raw["user_id"], "product_id": raw["product_id"]})[
        np.asarray(raw["label"]) == 1
    ]
    pos = build_positive_pairs(inter)
    neg = sample_negatives(pos, np.arange(1, 301), seed=0)
    df = per_user_split(union_pos_neg(pos, neg), seed=0)
    indexed, mappings = index_ids(df)
    splits = splits_to_columns(indexed)
    print("splits:", {k: len(v["label"]) for k, v in splits.items()})
    for name, colsd in splits.items():
        write_dataset(os.path.join(work, name), colsd, rows_per_shard=2048)

    # 2. model + streaming training with checkpoints + tracking
    n_users, n_items = len(mappings["user_id"]), len(mappings["product_id"])
    mcfg = cfg.two_tower_model_config(n_users + 1, n_items + 1, embedding_dim=32,
                                      layer_sizes=(64, 32))
    mcfg = dataclasses.replace(
        mcfg,
        query_tower=dataclasses.replace(mcfg.query_tower, final_activation=False),
        candidate_tower=dataclasses.replace(mcfg.candidate_tower, final_activation=False),
    )
    tcfg = cfg.TrainConfig(epochs=3, sparse_learning_rate=0.1, learning_rate=3e-3)
    feat = Featurizer(mcfg)
    logger = ExperimentLogger(os.path.join(work, "runs"))
    logger.log_params({"n_users": n_users, "n_items": n_items})
    ckpt = Checkpointer(os.path.join(work, "ckpt"))
    state, dense_opt = create_train_state(jax.random.key(0), mcfg, tcfg)

    def train_factory(ep):
        loader = StreamLoader(os.path.join(work, "train"), 512, seed=1)
        loader.set_epoch(ep)
        return loader

    state, results = train_val_test(
        state, make_train_step(mcfg, tcfg, dense_opt), make_eval_step(mcfg, tcfg),
        mcfg, tcfg, feat,
        train_batches_factory=train_factory,
        val_batches_factory=lambda: StreamLoader(
            os.path.join(work, "val"), 512, shuffle=False, drop_last=False),
        test_batches_factory=lambda: StreamLoader(
            os.path.join(work, "test"), 512, shuffle=False, drop_last=False),
        logger=logger,
        checkpoint_fn=lambda s, ep: ckpt.save(int(s.step), s, wait=True),
    )
    print("train:", {k: round(v, 4) for k, v in results.items() if "auroc" in k or "loss" in k})

    # 3. restore latest checkpoint -> export -> serve
    template, _ = create_train_state(jax.random.key(9), mcfg, tcfg)
    restored, _, _ = ckpt.restore(template)
    export_model(os.path.join(work, "model"), mcfg, restored)
    scorer = load_scorer(os.path.join(work, "model"))
    print("scorer probs:", scorer.predict({"user_id": [1, 2, 3], "product_id": [5, 6, 7]}).round(3))

    # 4. retrieval eval on held-out test positives
    test_df = indexed[indexed["split"] == "test"]
    test_pos = (
        test_df[test_df.label == 1].groupby("user_id_index")["product_id_index"]
        .apply(list).to_dict()
    )
    params = {"tables": restored.tables, **restored.dense_params}
    m = evaluate_retrieval(params, mcfg, test_pos, k=100, ks=(10, 100))
    print("retrieval:", {k: round(v, 4) for k, v in m.items()})
    print("metric lines:", len(logger.metrics()))
    return {**results, **m}


if __name__ == "__main__":
    out = main(sys.argv[1] if len(sys.argv) > 1 else None)
    assert out["test_auroc"] > 0.6 and out["recall_at_100"] > 0.3, out
    print("E2E OK")
