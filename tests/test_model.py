"""Model: shapes, config validation, forward parity with a hand computation."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from two_tower_recommender_model import config as cfg_lib
from two_tower_recommender_model.data.featurizer import Featurizer
from two_tower_recommender_model.models import two_tower as tt
from two_tower_recommender_model.models.mlp import apply_mlp, init_mlp


@pytest.fixture
def mcfg():
    return cfg_lib.two_tower_model_config(num_users=50, num_items=30, embedding_dim=16,
                                          layer_sizes=(32, 8))


def _batch(mcfg, rng, n=6):
    cols = {
        "user_id": rng.integers(1, 50, n),
        "product_id": rng.integers(1, 30, n),
        "label": rng.integers(0, 2, n),
    }
    return jax.tree.map(jnp.asarray, Featurizer(mcfg)(cols))


def test_shapes_and_dims(mcfg, rng):
    params = tt.init_params(jax.random.key(0), mcfg)
    assert params["tables"]["t_user_id"].shape == (50, 16)
    assert params["tables"]["t_product_id"].shape == (30, 16)
    batch = _batch(mcfg, rng)
    q, c = tt.forward(params, batch, mcfg)
    assert q.shape == (6, 8) and c.shape == (6, 8)
    s = tt.score(params, batch, mcfg)
    np.testing.assert_allclose(s, np.sum(np.asarray(q) * np.asarray(c), axis=1), rtol=1e-6)


def test_forward_matches_manual(mcfg, rng):
    params = tt.init_params(jax.random.key(1), mcfg)
    batch = _batch(mcfg, rng)
    q, _ = tt.forward(params, batch, mcfg)
    # manual: gather user rows, mask, relu-MLP (final activation on — torchrec parity)
    ids = np.asarray(batch.features["user_id"].ids)[:, 0]
    mask = np.asarray(batch.features["user_id"].mask)[:, 0:1]
    x = np.asarray(params["tables"]["t_user_id"])[ids] * mask
    for i in range(2):
        layer = params["query_tower"][f"layer_{i}"]
        x = x @ np.asarray(layer["kernel"]) + np.asarray(layer["bias"])
        x = np.maximum(x, 0)
    np.testing.assert_allclose(q, x, rtol=1e-5, atol=1e-6)


def test_final_activation_off():
    p = init_mlp(jax.random.key(0), 4, (8, 3))
    x = jnp.asarray(np.random.default_rng(0).normal(size=(5, 4)), jnp.float32)
    y = apply_mlp(p, x, "relu", final_activation=False)
    assert np.asarray(y).min() < 0  # linear head can go negative


def test_mismatched_tower_dims_rejected(mcfg):
    bad = dataclasses.replace(
        mcfg, candidate_tower=dataclasses.replace(mcfg.candidate_tower, layer_sizes=(32, 9))
    )
    with pytest.raises(ValueError, match="final layer size"):
        bad.validate()


def test_unknown_feature_rejected(mcfg):
    bad = dataclasses.replace(
        mcfg, query_tower=dataclasses.replace(mcfg.query_tower, features=("nope",))
    )
    with pytest.raises(ValueError, match="unknown feature"):
        bad.validate()


def test_config_roundtrip(mcfg):
    import dataclasses as dc
    import json
    d = json.loads(cfg_lib.to_json(mcfg))
    back = cfg_lib.model_config_from_dict(d)
    assert back == mcfg


def test_multi_feature_tower_with_dense(rng):
    mcfg = cfg_lib.ModelConfig(
        tables=(
            cfg_lib.TableConfig("t_u", 50, 8, ("user_id", "user_ctx")),
            cfg_lib.TableConfig("t_i", 30, 8, ("product_id",)),
        ),
        features=(
            cfg_lib.FeatureConfig("user_id", "t_u"),
            cfg_lib.FeatureConfig("user_ctx", "t_u", max_ids_per_sample=4, pooling="mean"),
            cfg_lib.FeatureConfig("product_id", "t_i"),
        ),
        query_tower=cfg_lib.TowerConfig(("user_id", "user_ctx"), (16, 4), dense_dim=2),
        candidate_tower=cfg_lib.TowerConfig(("product_id",), (16, 4)),
    )
    mcfg.validate()
    f = Featurizer(mcfg, dense_cols=("d0", "d1"))
    n = 5
    cols = {
        "user_id": rng.integers(1, 50, n),
        "user_ctx": f.ragged("user_ctx", [[1, 2, 3], [4], [], [5, 6], [7]]),
        "product_id": rng.integers(1, 30, n),
        "label": rng.integers(0, 2, n),
        "d0": rng.random(n), "d1": rng.random(n),
    }
    batch = jax.tree.map(jnp.asarray, f(cols))
    params = tt.init_params(jax.random.key(0), mcfg)
    q, c = tt.forward(params, batch, mcfg)
    assert q.shape == (n, 4) and c.shape == (n, 4)
