"""Serving scorer: PyFunc-contract parity, bucketing, export/load round-trip."""

import numpy as np
import jax

from two_tower_recommender_model import config as cfg_lib
from two_tower_recommender_model.models.two_tower import init_params
from two_tower_recommender_model.serving import Scorer, load_scorer
from two_tower_recommender_model.train.step import create_train_state
from two_tower_recommender_model.utils.checkpoint import export_model


def _mcfg():
    return cfg_lib.two_tower_model_config(num_users=50, num_items=30, embedding_dim=8,
                                          layer_sizes=(16, 8))


def test_predict_probabilities():
    mcfg = _mcfg()
    params = init_params(jax.random.key(0), mcfg)
    scorer = Scorer(mcfg, params)
    out = scorer.predict({"user_id": [1, 2, 3], "product_id": [4, 5, 6]})
    assert out.shape == (3,)
    assert ((out >= 0) & (out <= 1)).all()


def test_bucketing_consistent():
    mcfg = _mcfg()
    params = init_params(jax.random.key(0), mcfg)
    scorer = Scorer(mcfg, params)
    users = np.arange(1, 12)  # 11 rows -> padded to 16
    items = (np.arange(1, 12) % 29) + 1
    got = scorer.predict({"user_id": users, "product_id": items})
    one_by_one = np.array([
        scorer.predict({"user_id": [u], "product_id": [i]})[0] for u, i in zip(users, items)
    ])
    np.testing.assert_allclose(got, one_by_one, rtol=1e-5, atol=1e-6)


def test_missing_id_zero_matches_training_semantics():
    mcfg = _mcfg()
    params = init_params(jax.random.key(0), mcfg)
    scorer = Scorer(mcfg, params)
    a = scorer.predict({"user_id": [0], "product_id": [0]})
    b = scorer.predict({"user_id": [0], "product_id": [0]})
    np.testing.assert_array_equal(a, b)  # deterministic bias-only path


def test_embed_shapes():
    mcfg = _mcfg()
    params = init_params(jax.random.key(0), mcfg)
    q, c = Scorer(mcfg, params).embed({"user_id": [1, 2], "product_id": [3, 4]})
    assert q.shape == (2, 8) and c.shape == (2, 8)


def test_export_load_scorer_roundtrip(tmp_path):
    mcfg = _mcfg()
    state, _ = create_train_state(jax.random.key(0), mcfg, cfg_lib.TrainConfig())
    export_model(str(tmp_path / "m"), mcfg, state)
    scorer = load_scorer(str(tmp_path / "m"))
    params = {"tables": state.tables, **state.dense_params}
    direct = Scorer(mcfg, params)
    inp = {"user_id": [1, 9, 33], "product_id": [2, 7, 21]}
    np.testing.assert_allclose(scorer.predict(inp), direct.predict(inp), rtol=1e-6)


def test_retrieval_service_sharded_mesh_matches_single_device():
    """RetrievalService(mesh=...): corpus row-sharded over every device +
    exact sharded top-k == the single-device service, including the
    non-device-multiple corpus (49 items -> 48 rows after the sentinel
    isn't a multiple of 8) and a refresh()."""
    import jax
    from two_tower_recommender_model.parallel import make_mesh
    from two_tower_recommender_model.models.two_tower import init_params
    from two_tower_recommender_model.serving import RetrievalService

    mcfg = cfg_lib.two_tower_model_config(num_users=80, num_items=51,
                                          embedding_dim=16, layer_sizes=(16, 8))
    params = init_params(jax.random.key(3), mcfg)
    single = RetrievalService(mcfg, params)
    mesh = make_mesh(4, 2)
    sharded = RetrievalService(mcfg, params, mesh=mesh)
    users = np.array([1, 5, 17, 42])
    items_s, scores_s = single.retrieve(users, k=7)
    items_m, scores_m = sharded.retrieve(users, k=7)
    np.testing.assert_array_equal(items_m, items_s)
    np.testing.assert_allclose(scores_m, scores_s, rtol=1e-5, atol=1e-6)

    params2 = init_params(jax.random.key(4), mcfg)
    single.refresh(params2)
    sharded.refresh(params2)
    items_s2, _ = single.retrieve(users, k=5)
    items_m2, _ = sharded.retrieve(users, k=5)
    np.testing.assert_array_equal(items_m2, items_s2)
