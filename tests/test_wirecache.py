"""Wire cache: pre-encoded compact batches must decode bit-identically to the
dynamic CompactFeaturizer path, reshuffle deterministically per epoch, and
train through the packed macro loop."""

import dataclasses

import jax
import numpy as np
import pytest

from two_tower_recommender_model import config as cfg_lib
from two_tower_recommender_model.data import SyntheticClickstream
from two_tower_recommender_model.data.compact import (
    CompactFeaturizer,
    CompactScheme,
    batch_from_compact,
)
from two_tower_recommender_model.data.device_featurizer import PackedFeaturizer
from two_tower_recommender_model.data.wirecache import WireCache, build_wire_cache
from two_tower_recommender_model.train.loop import train_one_epoch_packed
from two_tower_recommender_model.train.step import (
    create_train_state,
    make_multi_step,
    make_train_step,
)


@pytest.fixture
def mcfg():
    return cfg_lib.two_tower_model_config(
        num_users=200, num_items=80, embedding_dim=8, layer_sizes=(16, 8)
    )


def _featurizer(mcfg, delta=True):
    scheme = CompactScheme.from_model(
        mcfg, pack_label=True, delta_feature="user_id" if delta else None
    )
    inner = PackedFeaturizer(
        mcfg, pack_label=True, sort_feature="user_id" if delta else None
    )
    return CompactFeaturizer(inner, scheme), scheme


def _source(n_batches, b, seed=0):
    ds = SyntheticClickstream(num_users=200, num_items=80, seed=seed)
    return [ds.sample(b, start=i * b) for i in range(n_batches)]


@pytest.mark.parametrize("delta", [True, False])
def test_cache_batches_decode_identically(tmp_path, mcfg, delta):
    feat, scheme = _featurizer(mcfg, delta)
    src = _source(6, 64)
    build_wire_cache(str(tmp_path / "wc"), src, feat)
    cache = WireCache(str(tmp_path / "wc"), scheme=scheme)
    assert cache.num_batches == 6 and cache.batch_size == 64

    # epoch order is a permutation; match each cached batch to its source
    import jax.numpy as jnp

    order = cache.order(epoch=0)
    for pos, cb in enumerate(cache.batches(epoch=0)):
        want = feat(src[order[pos]])
        got = batch_from_compact(jax.tree.map(jnp.asarray, cb), mcfg, scheme)
        ref = batch_from_compact(jax.tree.map(jnp.asarray, want), mcfg, scheme)
        for name in ref.features:
            np.testing.assert_array_equal(
                np.asarray(got.features[name].ids), np.asarray(ref.features[name].ids)
            )
            np.testing.assert_array_equal(
                np.asarray(got.features[name].mask), np.asarray(ref.features[name].mask)
            )
        np.testing.assert_array_equal(np.asarray(got.labels), np.asarray(ref.labels))


def test_epoch_shuffle_deterministic_and_distinct(tmp_path, mcfg):
    feat, scheme = _featurizer(mcfg)
    build_wire_cache(str(tmp_path / "wc"), _source(16, 8), feat)
    cache = WireCache(str(tmp_path / "wc"), scheme=scheme)
    o0, o0b = cache.order(0), WireCache(str(tmp_path / "wc")).order(0)
    np.testing.assert_array_equal(o0, o0b)  # deterministic across instances
    assert not np.array_equal(cache.order(0), cache.order(1))  # reshuffles
    assert sorted(cache.order(1)) == list(range(16))  # same multiset


def test_host_slices_disjoint_equal(tmp_path, mcfg):
    feat, scheme = _featurizer(mcfg)
    build_wire_cache(str(tmp_path / "wc"), _source(10, 8), feat)
    cache = WireCache(str(tmp_path / "wc"), scheme=scheme)
    seen = []
    for h in range(3):
        batches = list(cache.batches(epoch=2, host_index=h, host_count=3))
        assert len(batches) == 3  # 10 // 3, equal on every host
        seen.extend(np.asarray(b.wire).tobytes() for b in batches)
    assert len(set(seen)) == len(seen)  # disjoint
    # skip_batches resumes mid-slice
    tail = list(cache.batches(epoch=2, host_index=1, host_count=3, skip_batches=2))
    assert len(tail) == 1


def test_ragged_tail_dropped_and_scheme_mismatch(tmp_path, mcfg):
    feat, scheme = _featurizer(mcfg)
    src = _source(3, 64) + [_source(1, 17, seed=9)[0]]
    meta = build_wire_cache(str(tmp_path / "wc"), src, feat)
    assert meta["num_batches"] == 3 and meta["dropped_tail_rows"] == 17
    other = CompactScheme.from_model(mcfg, pack_label=True)  # no delta slot
    with pytest.raises(ValueError, match="different wire scheme"):
        WireCache(str(tmp_path / "wc"), scheme=other)


def test_train_through_packed_loop_matches_dynamic(tmp_path, mcfg):
    """Training an epoch from the cache == training on the same CompactBatches
    fed dynamically in the cache's order (identical final params)."""
    feat, scheme = _featurizer(mcfg)
    src = _source(8, 64)
    build_wire_cache(str(tmp_path / "wc"), src, feat)
    cache = WireCache(str(tmp_path / "wc"), scheme=scheme)

    tcfg = cfg_lib.TrainConfig(batch_size=64, sorted_feature="user_id")
    state0, dense_opt = create_train_state(jax.random.key(0), mcfg, tcfg)
    core = make_train_step(mcfg, tcfg, dense_opt, donate=False, jit=False)
    multi = make_multi_step(
        lambda s, cb: core(s, batch_from_compact(cb, mcfg, scheme)), donate=False
    )

    s_cache, stats = train_one_epoch_packed(
        state0, multi, cache.batches(epoch=0), lambda cb: cb, macro=4
    )
    assert stats["train_steps"] == 8 and stats["train_examples"] == 8 * 64

    dynamic = [feat(src[i]) for i in cache.order(0)]
    s_dyn, _ = train_one_epoch_packed(
        state0, multi, iter(dynamic), lambda cb: cb, macro=4
    )
    jax.tree.map(
        lambda a, b: np.testing.assert_array_equal(np.asarray(a), np.asarray(b)),
        s_cache.tables,
        s_dyn.tables,
    )


def test_stale_cache_rejected(tmp_path, mcfg):
    """A cache built at a different batch size or from a different dataset
    (fingerprint) must be refused — stale caches silently trained old data
    once."""
    feat, scheme = _featurizer(mcfg)
    build_wire_cache(str(tmp_path / "wc"), _source(4, 64), feat,
                     fingerprint={"data_dir": "/a", "total_rows": 256})
    WireCache(str(tmp_path / "wc"), scheme=scheme, batch_size=64,
              fingerprint={"data_dir": "/a", "total_rows": 256})  # ok
    with pytest.raises(ValueError, match="batch_size"):
        WireCache(str(tmp_path / "wc"), scheme=scheme, batch_size=128)
    with pytest.raises(ValueError, match="different dataset"):
        WireCache(str(tmp_path / "wc"), scheme=scheme,
                  fingerprint={"data_dir": "/b", "total_rows": 999})
    # caches without a stored fingerprint (older builds) stay loadable
    build_wire_cache(str(tmp_path / "wc2"), _source(4, 64), feat)
    WireCache(str(tmp_path / "wc2"), scheme=scheme,
              fingerprint={"data_dir": "/a"})


def test_order_modes(tmp_path, mcfg):
    feat, scheme = _featurizer(mcfg)
    build_wire_cache(str(tmp_path / "wc"), _source(10, 8), feat)
    cache = WireCache(str(tmp_path / "wc"), scheme=scheme)
    np.testing.assert_array_equal(cache.order(3, "loader"), np.arange(10))
    rot = cache.order(3, "rotate")
    assert sorted(rot) == list(range(10))
    # a rotation: consecutive differences are 1 mod n
    assert set(np.diff(rot) % 10) <= {1}
    assert not np.array_equal(cache.order(3, "rotate"), cache.order(4, "rotate"))
    np.testing.assert_array_equal(cache.order(3, "rotate"),
                                  WireCache(str(tmp_path / "wc")).order(3, "rotate"))
    with pytest.raises(ValueError, match="order mode"):
        cache.order(0, "bogus")
    got = [np.asarray(b.wire) for b in cache.batches(0, order_mode="loader")]
    want = [feat(c) for c in _source(10, 8)]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w.wire))
