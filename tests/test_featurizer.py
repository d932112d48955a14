"""Featurizer parity with the reference `transform_to_torchrec_batch`
(`03_model_training.py:353-380`): modulo hashing, falsy-id drop, int32 labels."""

import numpy as np
import pytest

from two_tower_recommender_model import config as cfg_lib
from two_tower_recommender_model.data.featurizer import Featurizer


def reference_transform(batch, cat_cols, num_embeddings_per_feature):
    """Straight per-element port of the reference loop (test oracle only)."""
    out = {}
    for col_idx, col in enumerate(cat_cols):
        vals, lens = [], []
        for value in batch[col]:
            if value:
                vals.append(value % num_embeddings_per_feature[col_idx])
                lens.append(1)
            else:
                lens.append(0)
        out[col] = (vals, lens)
    return out


@pytest.fixture
def mcfg():
    return cfg_lib.two_tower_model_config(num_users=100, num_items=40, embedding_dim=8)


def test_hash_and_drop_parity(mcfg):
    cols = {
        "user_id": np.array([1, 0, 205, 99, 100, 101]),
        "product_id": np.array([0, 39, 40, 41, 7, 0]),
        "label": np.array([1, 0, 1, 1, 0, 0]),
    }
    batch = Featurizer(mcfg)(cols)
    ref = reference_transform(cols, ["user_id", "product_id"], [100, 40])
    for feat, nemb in (("user_id", 100), ("product_id", 40)):
        vals, lens = ref[feat]
        got_ids = batch.features[feat].ids[:, 0]
        got_mask = batch.features[feat].mask[:, 0]
        np.testing.assert_array_equal(got_mask, np.array(lens, np.float32))
        np.testing.assert_array_equal(got_ids[got_mask > 0], np.array(vals))
        # dropped slots are forced to id 0
        np.testing.assert_array_equal(got_ids[got_mask == 0], 0)
    assert batch.labels.dtype == np.int32
    np.testing.assert_array_equal(batch.labels, cols["label"])


def test_keep_zero_ids_mode(mcfg):
    cols = {"user_id": np.array([0, 5]), "product_id": np.array([3, 0]), "label": np.zeros(2)}
    batch = Featurizer(mcfg, drop_zero_ids=False)(cols)
    np.testing.assert_array_equal(batch.features["user_id"].mask, 1.0)
    np.testing.assert_array_equal(batch.features["user_id"].ids[:, 0], [0, 5])


def test_multi_id_bags_pad_and_truncate():
    mcfg = cfg_lib.ModelConfig(
        tables=(cfg_lib.TableConfig("t", 1000, 8, ("hist",)),),
        features=(cfg_lib.FeatureConfig("hist", "t", max_ids_per_sample=3, pooling="mean"),),
        query_tower=cfg_lib.TowerConfig(("hist",), (8,)),
        candidate_tower=cfg_lib.TowerConfig(("hist",), (8,)),
    )
    f = Featurizer(mcfg)
    ragged = f.ragged("hist", [[1, 2], [3, 4, 5, 6], []])
    batch = f({"hist": ragged, "label": np.zeros(3)})
    np.testing.assert_array_equal(batch.features["hist"].ids, [[1, 2, 0], [3, 4, 5], [0, 0, 0]])
    np.testing.assert_array_equal(
        batch.features["hist"].mask, [[1, 1, 0], [1, 1, 1], [0, 0, 0]]
    )


def test_dense_columns(mcfg):
    f = Featurizer(mcfg, dense_cols=("price", "qty"))
    cols = {
        "user_id": np.array([1]), "product_id": np.array([2]), "label": np.array([1]),
        "price": np.array([1.5]), "qty": np.array([3.0]),
    }
    batch = f(cols)
    np.testing.assert_allclose(batch.dense, [[1.5, 3.0]])
