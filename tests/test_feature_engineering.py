"""Feature engineering parity: negative sampler, per-user split invariant,
id indexing, ingest join."""

import numpy as np
import pandas as pd
import pytest

from two_tower_recommender_model.data.feature_engineering import (
    assert_user_coverage,
    build_positive_pairs,
    index_ids,
    per_user_split,
    sample_negatives,
    splits_to_columns,
    union_pos_neg,
)
from two_tower_recommender_model.data.ingest import build_order_detail


@pytest.fixture
def interactions(rng):
    return pd.DataFrame(
        {
            "user_id": rng.integers(1, 50, 2000),
            "product_id": rng.integers(1, 100, 2000),
        }
    )


def test_positive_pairs_distinct(interactions):
    pos = build_positive_pairs(interactions)
    assert pos.duplicated(["user_id", "product_id"]).sum() == 0
    assert (pos["label"] == 1).all()


def test_negative_sampler_semantics(interactions):
    pos = build_positive_pairs(interactions)
    all_items = np.arange(1, 101)
    neg = sample_negatives(pos, all_items, seed=0)
    # reference semantics: one negative per positive, per user (02_feature_engineering.py:53-77)
    pos_counts = pos.groupby("user_id").size()
    neg_counts = neg.groupby("user_id").size()
    pd.testing.assert_series_equal(pos_counts, neg_counts, check_names=False)
    # negatives never collide with the user's positives
    pos_set = set(map(tuple, pos[["user_id", "product_id"]].to_numpy()))
    neg_set = set(map(tuple, neg[["user_id", "product_id"]].to_numpy()))
    assert not (pos_set & neg_set)
    assert (neg["label"] == 0).all()
    both = union_pos_neg(pos, neg)
    assert len(both) == 2 * len(pos)


def test_per_user_split_invariant(interactions):
    pos = build_positive_pairs(interactions)
    df = union_pos_neg(pos, sample_negatives(pos, np.arange(1, 101), seed=1))
    split = per_user_split(df, seed=0)
    assert set(split["split"].unique()) <= {"train", "val", "test"}
    assert_user_coverage(split)  # no user lacks train rows
    fr = split["split"].value_counts(normalize=True)
    assert fr["train"] > 0.7


def test_single_row_user_goes_to_train():
    df = pd.DataFrame({"user_id": [1, 2, 2, 2, 2], "product_id": [9, 1, 2, 3, 4],
                       "label": [1, 1, 0, 1, 0]})
    split = per_user_split(df, seed=0)
    assert (split.loc[split.user_id == 1, "split"] == "train").all()


def test_user_coverage_assert_fires():
    df = pd.DataFrame({"user_id": [1, 2], "product_id": [5, 6], "label": [1, 1],
                       "split": ["val", "train"]})
    with pytest.raises(AssertionError, match="no train rows"):
        assert_user_coverage(df)


def test_index_ids_contiguous_one_based(interactions):
    indexed, mappings = index_ids(interactions)
    for col in ("user_id", "product_id"):
        idx = indexed[f"{col}_index"]
        assert idx.min() == 1  # 0 reserved for missing sentinel
        assert idx.max() == len(mappings[col])
        assert len(set(mappings[col].values())) == len(mappings[col])


def test_splits_to_columns(interactions):
    pos = build_positive_pairs(interactions)
    df = per_user_split(pos, seed=0)
    indexed, _ = index_ids(df)
    cols = splits_to_columns(indexed)
    total = sum(len(v["label"]) for v in cols.values())
    assert total == len(df)
    assert cols["train"]["user_id"].dtype == np.int64


def test_order_detail_join():
    orders = pd.DataFrame({"order_id": [1, 2], "user_id": [10, 20], "eval_set": ["prior"] * 2,
                           "order_number": [1, 1], "order_dow": [0, 1],
                           "order_hour_of_day": [9, 10], "days_since_prior_order": [np.nan, 3.0]})
    order_products = pd.DataFrame({"order_id": [1, 1, 2], "product_id": [100, 101, 100],
                                   "add_to_cart_order": [1, 2, 1], "reordered": [0, 0, 1]})
    products = pd.DataFrame({"product_id": [100, 101], "product_name": ["a", "b"],
                             "aisle_id": [1, 2], "department_id": [1, 1]})
    detail = build_order_detail(orders, order_products, products)
    assert len(detail) == 3
    assert set(detail.columns) >= {"user_id", "product_id", "product_name"}
