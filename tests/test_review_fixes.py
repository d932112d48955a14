"""Regression tests for code-review findings (round 1 self-review)."""

import numpy as np
import pandas as pd
import pytest

from two_tower_recommender_model import config as cfg_lib
from two_tower_recommender_model.data.feature_engineering import sample_negatives
from two_tower_recommender_model.data.loader import StreamLoader
from two_tower_recommender_model.data.shards import write_dataset
from two_tower_recommender_model.evaluation.retrieval import export_feature_embeddings
from two_tower_recommender_model.models.two_tower import init_params


def test_negative_sampler_no_duplicate_pairs_across_rounds():
    """Rejection rounds after the first used to skip dedup -> duplicate
    (user, item) negative pairs."""
    # tiny catalog + many positives forces several rejection rounds
    pos = pd.DataFrame({"user_id": [1] * 10, "product_id": list(range(1, 11)), "label": 1})
    neg = sample_negatives(pos, np.arange(1, 16), seed=0)  # complement size 5
    pairs = list(map(tuple, neg[["user_id", "product_id"]].to_numpy()))
    assert len(pairs) == len(set(pairs))  # distinct
    assert set(neg["product_id"]) <= set(range(11, 16))
    assert len(neg) == 5  # capped at complement size (cannot emit 10 distinct)


def test_negative_sampler_full_coverage_raises():
    pos = pd.DataFrame({"user_id": [1, 1, 1], "product_id": [1, 2, 3], "label": 1})
    with pytest.raises(ValueError, match="whole catalog"):
        sample_negatives(pos, np.array([1, 2, 3]), seed=0)


def test_export_hashes_out_of_range_ids():
    """Export must hash ids like training does, not clamp them."""
    mcfg = cfg_lib.two_tower_model_config(num_users=50, num_items=30, embedding_dim=8)
    import jax

    params = init_params(jax.random.key(0), mcfg)
    all_emb = export_feature_embeddings(params, mcfg, "user_id")
    oob = export_feature_embeddings(params, mcfg, "user_id", ids=np.array([50, 73, 149]))
    # 50 % 50 = 0, 73 % 50 = 23, 149 % 50 = 49 — NOT clamped to row 49
    np.testing.assert_array_equal(oob[0], all_emb[0])
    np.testing.assert_array_equal(oob[1], all_emb[23])
    np.testing.assert_array_equal(oob[2], all_emb[49])


def test_multihost_loader_equal_batch_counts(tmp_path):
    """Unequal shard assignment must not give hosts different step counts
    (cross-host collectives would deadlock)."""
    # 3 shards of unequal sizes over 2 hosts
    write_dataset(str(tmp_path / "ds"), {"row_id": np.arange(500), "label": np.zeros(500)},
                  rows_per_shard=200)  # shards: 200, 200, 100
    counts = []
    for h in range(2):
        loader = StreamLoader(str(tmp_path / "ds"), 50, seed=1, host_index=h, num_hosts=2)
        counts.append(sum(1 for _ in loader))
    assert counts[0] == counts[1], counts
    # and epoch advanced on the truncated host too
    loader = StreamLoader(str(tmp_path / "ds"), 50, seed=1, host_index=0, num_hosts=2)
    list(loader)
    assert loader.state_dict()["epoch"] == 1


def test_multihost_loader_counts_match_global_min(tmp_path):
    write_dataset(str(tmp_path / "ds"), {"row_id": np.arange(500), "label": np.zeros(500)},
                  rows_per_shard=200)
    l0 = StreamLoader(str(tmp_path / "ds"), 50, seed=1, host_index=0, num_hosts=2)
    want = min(l0._host_batch_counts(0))
    got = sum(1 for _ in l0)
    assert got == want


def test_int32_negative_overflow_prehashed():
    from two_tower_recommender_model.data import Featurizer
    from two_tower_recommender_model.data.device_featurizer import (
        PackedFeaturizer, unpack_batch)
    import jax
    import jax.numpy as jnp

    mcfg = cfg_lib.two_tower_model_config(num_users=100, num_items=60, embedding_dim=8)
    raw = np.array([-(2**40) + 3, 5, 0], np.int64)  # below int32 min
    cols = {"user_id": raw, "product_id": np.array([1, 2, 3]), "label": np.zeros(3, np.int64)}
    host = Featurizer(mcfg)(cols)
    packed = PackedFeaturizer(mcfg)(cols)
    dev = unpack_batch(jax.tree.map(jnp.asarray, packed), mcfg)
    np.testing.assert_array_equal(np.asarray(dev.features["user_id"].ids),
                                  host.features["user_id"].ids)
    np.testing.assert_array_equal(np.asarray(dev.features["user_id"].mask),
                                  host.features["user_id"].mask)


def test_pallas_lookup_env_routing(rng):
    """The pooled lookup has one route, XLA's gather: a multi-slot masked
    bag pools to the numpy reference."""
    import jax.numpy as jnp
    from two_tower_recommender_model.ops.embedding_ops import pooled_lookup

    table = jnp.asarray(rng.normal(size=(40, 64)), jnp.float32)
    ids = jnp.asarray(rng.integers(0, 40, (10, 2)), jnp.int32)
    mask = jnp.asarray((rng.random((10, 2)) > 0.3), jnp.float32)
    got = pooled_lookup(table, ids, mask, "sum")
    want = (np.asarray(table)[np.asarray(ids)] * np.asarray(mask)[..., None]).sum(1)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
