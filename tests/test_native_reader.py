"""Native C++ TTRS reader: builds, matches the Python reader bit-for-bit,
plugs into ShardedDataset, and wins on throughput."""

import time

import numpy as np
import pytest

from two_tower_recommender_model.data.shards import (
    ShardedDataset,
    read_shard,
    write_dataset,
    write_shard,
)
from two_tower_recommender_model.native.build import build_ttrs_reader
from two_tower_recommender_model.native.ttrs import (
    NativeShardReader,
    native_available,
    native_read_shard,
)

pytestmark = pytest.mark.skipif(not native_available(), reason="no native toolchain")


@pytest.fixture(scope="module")
def lib():
    return build_ttrs_reader()


def _write(tmp_path, rng, compress=True):
    cols = {
        "user_id": rng.integers(1, 1 << 40, 5000),
        "product_id": rng.integers(1, 50_000, 5000),
        "label": rng.integers(0, 2, 5000).astype(np.int32),
        "score": rng.normal(size=5000).astype(np.float32),
        "emb": rng.normal(size=(5000, 16)).astype(np.float32),
        "seq": np.tile(np.arange(5000), 1),  # highly compressible
    }
    p = str(tmp_path / "s.ttrs")
    write_shard(p, cols, compress=compress)
    return p, cols


@pytest.mark.parametrize("compress", [True, False])
def test_native_matches_python(tmp_path, rng, lib, compress):
    p, cols = _write(tmp_path, rng, compress)
    py = read_shard(p)
    nat = native_read_shard(p)
    assert set(py) == set(nat) == set(cols)
    for k in cols:
        np.testing.assert_array_equal(nat[k], py[k])
        assert nat[k].dtype == py[k].dtype
        assert nat[k].shape == py[k].shape


def test_native_column_projection(tmp_path, rng, lib):
    p, _ = _write(tmp_path, rng)
    out = native_read_shard(p, ["label", "score"])
    assert set(out) == {"label", "score"}


def test_native_metadata(tmp_path, rng, lib):
    p, cols = _write(tmp_path, rng)
    r = NativeShardReader(p)
    assert r.rows == 5000
    assert set(r.columns()) == set(cols)
    r.close()


def test_native_rejects_garbage(tmp_path, lib):
    p = str(tmp_path / "bad.ttrs")
    with open(p, "wb") as f:
        f.write(b"NOT A SHARD FILE AT ALL")
    with pytest.raises(IOError):
        NativeShardReader(p)


def test_sharded_dataset_uses_native(tmp_path, rng, lib):
    out = str(tmp_path / "ds")
    write_dataset(out, {"a": rng.integers(0, 9, 1000), "label": np.zeros(1000)},
                  rows_per_shard=256)
    ds_native = ShardedDataset(out, use_native=True)
    ds_py = ShardedDataset(out, use_native=False)
    assert ds_native.use_native
    for i in range(ds_native.num_shards):
        a, b = ds_native.read_shard(i), ds_py.read_shard(i)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


def test_native_not_slower(tmp_path, rng, lib):
    """Throughput sanity: native parallel read should not lose to Python."""
    cols = {f"c{i}": rng.integers(0, 1000, 200_000) for i in range(6)}
    p = str(tmp_path / "big.ttrs")
    write_shard(p, cols)

    for fn in (native_read_shard, read_shard):  # warm page cache + jit paths
        fn(p)
    t0 = time.perf_counter()
    for _ in range(3):
        native_read_shard(p)
    t_native = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(3):
        read_shard(p)
    t_py = time.perf_counter() - t0
    # generous bound: suite runs in parallel with other CPU load; the point is
    # catching pathological regressions, not micro-benchmarking under pytest
    assert t_native < t_py * 3.0, (t_native, t_py)
