"""Pre-packed dataset path: write-time featurization + mmap reads must be
numerically identical to the online PackedFeaturizer path, end to end through
training."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from two_tower_recommender_model import config as cfg_lib
from two_tower_recommender_model.data import SyntheticClickstream
from two_tower_recommender_model.data.device_featurizer import (
    PackedFeaturizer,
    unpack_batch,
)
from two_tower_recommender_model.data.loader import StreamLoader
from two_tower_recommender_model.data.prepacked import (
    PrepackedFeaturizer,
    pack_dataset,
)
from two_tower_recommender_model.data.shards import ShardedDataset, read_shard, write_dataset
from two_tower_recommender_model.train.step import (
    create_train_state,
    make_multi_step,
    make_train_step,
    stack_batches,
)


@pytest.fixture
def mcfg():
    return cfg_lib.two_tower_model_config(num_users=200, num_items=80, embedding_dim=8,
                                          layer_sizes=(16, 8))


def _cols(n, seed=0):
    rng = np.random.default_rng(seed)
    return {
        "user_id": rng.integers(0, 200, n),  # includes missing-id zeros
        "product_id": rng.integers(1, 80, n),
        "label": rng.integers(0, 2, n),
    }


def test_mmap_read_matches_buffered(tmp_path):
    cols = _cols(100)
    d = str(tmp_path / "ds")
    write_dataset(d, cols, rows_per_shard=40, compress=False)
    f = os.path.join(d, "shard_000000.ttrs")
    a = read_shard(f)
    b = read_shard(f, mmap=True)
    for k in cols:
        np.testing.assert_array_equal(a[k], b[k])
        assert isinstance(b[k], np.memmap)
    # uncompressed dataset auto-selects the mmap reader
    ds = ShardedDataset(d)
    assert ds.mmap and not ds.use_native
    np.testing.assert_array_equal(ds.read_shard(0)["user_id"], cols["user_id"][:40])


def test_prepacked_equals_online_training(mcfg, tmp_path):
    """pack_dataset -> StreamLoader(mmap) -> PrepackedFeaturizer must produce
    bit-identical training to the online PackedFeaturizer on the raw columns."""
    cols = _cols(512, seed=3)
    d = str(tmp_path / "packed")
    pack_dataset(d, mcfg, cols, rows_per_shard=128)
    ds = ShardedDataset(d)
    pre = PrepackedFeaturizer.for_dataset(ds, mcfg)

    tcfg = cfg_lib.TrainConfig(batch_size=64)
    state_a, dense_opt = create_train_state(jax.random.key(0), mcfg, tcfg)
    state_b = jax.tree.map(lambda x: x, state_a)
    core = make_train_step(mcfg, tcfg, dense_opt, donate=False, jit=False)
    multi = make_multi_step(lambda s, pb: core(s, unpack_batch(pb, mcfg, pack_label=True)),
                            donate=False)

    # online path over the same visit order
    loader = StreamLoader(ds, 64, seed=7)
    online = PackedFeaturizer(mcfg, pack_label=True)
    packed_batches = [pre(b) for b in loader]
    assert len(packed_batches) == 8
    loader2 = StreamLoader(ds, 64, seed=7)
    # reconstruct raw columns from the packed storage for the online featurizer
    raw_batches = []
    for b in loader2:
        ids = np.asarray(b["packed_ids"])
        raw_batches.append(online_from_packed(ids))
    online_batches = [online(rb) for rb in raw_batches]

    ma = stack_batches(packed_batches)
    mb = stack_batches(online_batches)
    np.testing.assert_array_equal(ma.ids_raw, mb.ids_raw)

    state_a, out_a = multi(state_a, ma)
    state_b, out_b = multi(state_b, mb)
    np.testing.assert_array_equal(np.asarray(out_a["loss"]), np.asarray(out_b["loss"]))
    for k in state_a.tables:
        np.testing.assert_array_equal(np.asarray(state_a.tables[k]),
                                      np.asarray(state_b.tables[k]))


def online_from_packed(ids):
    """Invert the bit-30 pack for the oracle path (slot0=user incl. label bit,
    slot1=item)."""
    return {
        "user_id": (ids[:, 0] & ((1 << 30) - 1)).astype(np.int64),
        "product_id": ids[:, 1].astype(np.int64),
        "label": ((ids[:, 0] >> 30) & 1).astype(np.int64),
    }


def test_for_dataset_rejects_mismatched_layout(mcfg, tmp_path):
    d = str(tmp_path / "packed")
    pack_dataset(d, mcfg, _cols(64))
    other = cfg_lib.two_tower_model_config(num_users=999, num_items=80, embedding_dim=8)
    with pytest.raises(ValueError, match="slot layout"):
        PrepackedFeaturizer.for_dataset(ShardedDataset(d), other)
    with pytest.raises(ValueError, match="not a pre-packed"):
        d2 = str(tmp_path / "plain")
        write_dataset(d2, _cols(16))
        PrepackedFeaturizer.for_dataset(ShardedDataset(d2), mcfg)


def test_prepacked_batches_are_views_when_sequential(mcfg, tmp_path):
    """Unshuffled sequential reads: the hot path hands out mmap-backed views
    (no per-batch copy until the macro stack)."""
    d = str(tmp_path / "packed")
    pack_dataset(d, mcfg, _cols(256), rows_per_shard=256)
    ds = ShardedDataset(d)
    loader = StreamLoader(ds, 64, shuffle=False)
    b = next(iter(loader))
    assert b["packed_ids"].base is not None  # view into the mmapped shard
