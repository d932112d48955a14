"""TTRS shard format: round-trip, compression, sharding, index."""

import os

import numpy as np
import pytest

from two_tower_recommender_model.data.shards import (
    ShardedDataset,
    ShardWriter,
    read_shard,
    shard_rows,
    write_dataset,
    write_shard,
)


def test_shard_roundtrip(tmp_path, rng):
    cols = {
        "user_id": rng.integers(0, 1 << 40, 1000),
        "label": rng.integers(0, 2, 1000).astype(np.int32),
        "score": rng.normal(size=1000).astype(np.float32),
        "emb": rng.normal(size=(1000, 8)).astype(np.float32),
    }
    p = str(tmp_path / "s.ttrs")
    n = write_shard(p, cols)
    assert n == 1000
    assert shard_rows(p) == 1000
    back = read_shard(p)
    for k, v in cols.items():
        np.testing.assert_array_equal(back[k], v)
        assert back[k].dtype == v.dtype


def test_column_projection(tmp_path, rng):
    p = str(tmp_path / "s.ttrs")
    write_shard(p, {"a": np.arange(10), "b": np.arange(10) * 2})
    back = read_shard(p, columns=["b"])
    assert set(back) == {"b"}


def test_incompressible_stays_raw(tmp_path, rng):
    p = str(tmp_path / "s.ttrs")
    write_shard(p, {"x": rng.integers(0, 1 << 62, 100)})  # random -> incompressible
    back = read_shard(p)
    assert len(back["x"]) == 100


def test_ragged_rejected(tmp_path):
    with pytest.raises(ValueError, match="ragged"):
        write_shard(str(tmp_path / "s.ttrs"), {"a": np.arange(3), "b": np.arange(4)})


def test_writer_shards_and_index(tmp_path, rng):
    out = str(tmp_path / "ds")
    with ShardWriter(out, rows_per_shard=300) as w:
        for _ in range(4):
            w.write({"a": rng.integers(0, 100, 250), "label": rng.integers(0, 2, 250)})
    ds = ShardedDataset(out)
    assert ds.total_rows == 1000
    assert ds.num_shards == 4  # 300,300,300,100
    assert ds.shard_row_counts == [300, 300, 300, 100]
    all_a = np.concatenate([ds.read_shard(i)["a"] for i in range(ds.num_shards)])
    assert len(all_a) == 1000


def test_write_dataset_single_dict(tmp_path, rng):
    out = str(tmp_path / "ds")
    idx = write_dataset(out, {"a": np.arange(50)}, rows_per_shard=20)
    assert idx["total_rows"] == 50
    assert os.path.exists(os.path.join(out, "index.json"))
