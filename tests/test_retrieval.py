"""Retrieval eval: export parity with model forward, metric math, end-to-end
recall on a trained model."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from two_tower_recommender_model import config as cfg_lib
from two_tower_recommender_model.data import Featurizer, SyntheticClickstream
from two_tower_recommender_model.evaluation.retrieval import (
    evaluate_retrieval,
    export_feature_embeddings,
    retrieval_metrics,
)
from two_tower_recommender_model.models.two_tower import forward, init_params
from two_tower_recommender_model.train.pipeline import prefetch_to_device
from two_tower_recommender_model.train.step import create_train_state, make_train_step


def test_export_matches_forward():
    """Exported embedding of id i == tower output for a batch containing id i
    (the parity the reference asserts before indexing, 03_model_training.py:1143-1145)."""
    mcfg = cfg_lib.two_tower_model_config(num_users=30, num_items=20, embedding_dim=8,
                                          layer_sizes=(16, 4))
    params = init_params(jax.random.key(0), mcfg)
    feat = Featurizer(mcfg)
    ids = np.array([1, 5, 19])
    batch = jax.tree.map(jnp.asarray, feat({
        "user_id": np.array([7, 7, 7]), "product_id": ids, "label": np.zeros(3)}))
    _, cand = forward(params, batch, mcfg)
    exported = export_feature_embeddings(params, mcfg, "product_id")
    np.testing.assert_allclose(exported[ids], np.asarray(cand), rtol=1e-5, atol=1e-6)
    assert exported.shape == (20, 4)


def test_export_chunking_consistent():
    mcfg = cfg_lib.two_tower_model_config(num_users=30, num_items=100, embedding_dim=8)
    params = init_params(jax.random.key(1), mcfg)
    a = export_feature_embeddings(params, mcfg, "product_id", batch_size=7)
    b = export_feature_embeddings(params, mcfg, "product_id", batch_size=100)
    np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


def test_retrieval_metrics_hand_computed():
    pred = np.array([[1, 2, 3, 4], [9, 8, 7, 6]])
    targets = [[1, 3], [5]]
    m = retrieval_metrics(pred, targets, ks=(2, 4))
    # user0: hits at ranks 1,3 -> recall@2 = 1/2, recall@4 = 2/2; user1: none
    np.testing.assert_allclose(m["recall_at_2"], (0.5 + 0.0) / 2)
    np.testing.assert_allclose(m["recall_at_4"], (1.0 + 0.0) / 2)
    np.testing.assert_allclose(m["precision_at_2"], (0.5 + 0.0) / 2)
    np.testing.assert_allclose(m["mrr"], (1.0 + 0.0) / 2)
    np.testing.assert_allclose(m["hit_rate_at_4"], 0.5)
    # ndcg user0 @2: dcg = 1/log2(2) = 1, idcg = 1/log2(2)+1/log2(3)
    want_ndcg2 = (1.0 / (1.0 + 1.0 / np.log2(3)) + 0.0) / 2
    np.testing.assert_allclose(m["ndcg_at_2"], want_ndcg2, rtol=1e-6)


def test_retrieval_metrics_empty_targets_skipped():
    m = retrieval_metrics(np.array([[1, 2], [3, 4]]), [[1], []], ks=(2,))
    np.testing.assert_allclose(m["recall_at_2"], 1.0)  # only user0 counted


def test_end_to_end_recall_beats_random():
    """Train on synthetic preferences; retrieval recall@10 must clearly beat
    the random baseline (10/60)."""
    mcfg = cfg_lib.two_tower_model_config(num_users=120, num_items=60, embedding_dim=16,
                                          layer_sizes=(32, 16))
    mcfg = dataclasses.replace(
        mcfg,
        query_tower=dataclasses.replace(mcfg.query_tower, final_activation=False),
        candidate_tower=dataclasses.replace(mcfg.candidate_tower, final_activation=False),
    )
    tcfg = cfg_lib.TrainConfig(sparse_learning_rate=0.1, learning_rate=3e-3)
    ds = SyntheticClickstream(120, 60, seed=4, noise=0.05, latent_dim=4)
    feat = Featurizer(mcfg)
    state, dense_opt = create_train_state(jax.random.key(0), mcfg, tcfg)
    tstep = make_train_step(mcfg, tcfg, dense_opt)
    for batch in prefetch_to_device(ds.batches(512, 250), feat):
        state, _ = tstep(state, batch)

    params = {"tables": state.tables, **state.dense_params}
    users = np.arange(1, 121)
    truth = ds.ground_truth_topk(users, k=10)
    user_positives = {int(u): truth[i].tolist() for i, u in enumerate(users)}
    m = evaluate_retrieval(params, mcfg, user_positives, k=20, ks=(10, 20))
    assert m["num_users"] == 120
    assert m["recall_at_10"] > 0.4, m  # random would be ~0.17
    assert 0 <= m["ndcg_at_10"] <= 1


def test_per_user_retrieval_table():
    from two_tower_recommender_model.evaluation.retrieval import per_user_retrieval_table

    pred = np.array([[1, 2, 3], [9, 8, 7]])
    users = np.array([10, 20])
    df = per_user_retrieval_table(pred, users, [[1], [5]], ks=(3,))
    assert list(df["user_id"]) == [10, 20]
    np.testing.assert_allclose(df["recall_at_3"], [1.0, 0.0])
    assert df.loc[0, "product_id_pred"] == [1, 2, 3]
