"""Device-side featurization: packed path must match the host Featurizer
numerics exactly, end to end through the train step."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from two_tower_recommender_model import config as cfg_lib
from two_tower_recommender_model.data import Featurizer, SyntheticClickstream
from two_tower_recommender_model.data.device_featurizer import (
    PackedFeaturizer,
    make_packed_eval_step,
    make_packed_train_step,
    unpack_batch,
)
from two_tower_recommender_model.train.step import (
    create_train_state,
    eval_state_init,
    make_eval_step,
    make_train_step,
)
from two_tower_recommender_model.models.metrics import auroc_compute


@pytest.fixture
def mcfg():
    return cfg_lib.two_tower_model_config(num_users=100, num_items=60, embedding_dim=8,
                                          layer_sizes=(16, 8))


def test_unpack_matches_host_featurizer(mcfg, rng):
    cols = {
        "user_id": np.concatenate([[0], rng.integers(1, 300, 15)]),  # incl. missing + overflow-hash
        "product_id": np.concatenate([rng.integers(1, 200, 15), [0]]),
        "label": rng.integers(0, 2, 16),
    }
    host = Featurizer(mcfg)(cols)
    packed = PackedFeaturizer(mcfg)(cols)
    dev = jax.jit(lambda p: unpack_batch(p, mcfg))(jax.tree.map(jnp.asarray, packed))
    for f in ("user_id", "product_id"):
        np.testing.assert_array_equal(np.asarray(dev.features[f].ids), host.features[f].ids)
        np.testing.assert_array_equal(np.asarray(dev.features[f].mask), host.features[f].mask)
    np.testing.assert_array_equal(np.asarray(dev.labels), host.labels)


def test_unpack_keep_zero_mode(mcfg):
    cols = {"user_id": np.array([0, 5]), "product_id": np.array([3, 0]),
            "label": np.zeros(2, np.int64)}
    host = Featurizer(mcfg, drop_zero_ids=False)(cols)
    packed = PackedFeaturizer(mcfg)(cols)
    dev = unpack_batch(jax.tree.map(jnp.asarray, packed), mcfg, drop_zero_ids=False)
    np.testing.assert_array_equal(np.asarray(dev.features["user_id"].mask),
                                  host.features["user_id"].mask)
    np.testing.assert_array_equal(np.asarray(dev.features["user_id"].ids),
                                  host.features["user_id"].ids)


def test_int64_ids_prehashed_preserving_semantics(mcfg):
    # raw ids beyond int32, including one whose hash lands exactly on 0
    n_users = 100  # t_user_id num_embeddings
    raw = np.array([2**40 + 7, 2**35 * 25, 0], np.int64)  # 2**35*25 % 100 == 0
    assert raw[1] % n_users == 0
    cols = {"user_id": raw, "product_id": np.array([1, 2, 3]),
            "label": np.zeros(3, np.int64)}
    host = Featurizer(mcfg)(cols)
    packed = PackedFeaturizer(mcfg)(cols)
    assert packed.ids_raw.dtype == np.int32
    dev = unpack_batch(jax.tree.map(jnp.asarray, packed), mcfg)
    np.testing.assert_array_equal(np.asarray(dev.features["user_id"].ids),
                                  host.features["user_id"].ids)
    np.testing.assert_array_equal(np.asarray(dev.features["user_id"].mask),
                                  host.features["user_id"].mask)


def test_packed_train_step_matches_host_path(mcfg, rng):
    tcfg = cfg_lib.TrainConfig()
    ds = SyntheticClickstream(100, 60, seed=1)
    state_a, dense_opt = create_train_state(jax.random.key(0), mcfg, tcfg)
    state_b = state_a
    base = make_train_step(mcfg, tcfg, dense_opt, donate=False)
    packed_step = make_packed_train_step(base, mcfg)
    # strip the outer donate for the comparison (same state reused)
    import functools
    packed_step_nodonate = jax.jit(functools.partial(
        lambda s, p: base(s, unpack_batch(p, mcfg))))
    host_f = Featurizer(mcfg)
    packed_f = PackedFeaturizer(mcfg)
    for i in range(4):
        cols = ds.sample(64, start=i)
        state_a, out_a = base(state_a, jax.tree.map(jnp.asarray, host_f(cols)))
        state_b, out_b = packed_step_nodonate(state_b, jax.tree.map(jnp.asarray, packed_f(cols)))
    np.testing.assert_allclose(float(out_a["loss"]), float(out_b["loss"]), rtol=1e-6)
    for name in state_a.tables:
        np.testing.assert_array_equal(np.asarray(state_a.tables[name]),
                                      np.asarray(state_b.tables[name]))


def test_packed_eval_step(mcfg, rng):
    tcfg = cfg_lib.TrainConfig()
    ds = SyntheticClickstream(100, 60, seed=1)
    state, _ = create_train_state(jax.random.key(0), mcfg, tcfg)
    estep = make_eval_step(mcfg, tcfg)
    pestep = make_packed_eval_step(estep, mcfg)
    host_f = Featurizer(mcfg)
    packed_f = PackedFeaturizer(mcfg)
    es_a, es_b = eval_state_init(), eval_state_init()
    for i in range(3):
        cols = ds.sample(128, "val", start=i)
        es_a = estep(state, es_a, jax.tree.map(jnp.asarray, host_f(cols)))
        es_b = pestep(state, es_b, jax.tree.map(jnp.asarray, packed_f(cols)))
    np.testing.assert_allclose(float(auroc_compute(es_a.auroc)),
                               float(auroc_compute(es_b.auroc)), rtol=1e-6)


def test_multi_slot_packing(rng):
    mcfg = cfg_lib.ModelConfig(
        tables=(cfg_lib.TableConfig("t", 1000, 8, ("a", "b")),),
        features=(cfg_lib.FeatureConfig("a", "t"),
                  cfg_lib.FeatureConfig("b", "t", max_ids_per_sample=3)),
        query_tower=cfg_lib.TowerConfig(("a",), (8,)),
        candidate_tower=cfg_lib.TowerConfig(("b",), (8,)),
    )
    host_f = Featurizer(mcfg)
    packed_f = PackedFeaturizer(mcfg)
    bags = host_f.ragged("b", [[1, 2], [3, 4, 5, 6]])
    cols = {"a": np.array([7, 0]), "b": bags, "label": np.zeros(2, np.int64)}
    host = host_f(cols)
    dev = unpack_batch(jax.tree.map(jnp.asarray, packed_f(cols)), mcfg)
    assert packed_f.total_slots == 4
    for f in ("a", "b"):
        np.testing.assert_array_equal(np.asarray(dev.features[f].ids), host.features[f].ids)
        np.testing.assert_array_equal(np.asarray(dev.features[f].mask), host.features[f].mask)


def test_pack_label_roundtrip(mcfg, rng):
    cols = {
        "user_id": np.concatenate([[0], rng.integers(1, 90, 15)]),
        "product_id": rng.integers(0, 55, 16),
        "label": rng.integers(0, 2, 16),
    }
    host = Featurizer(mcfg)(cols)
    packed = PackedFeaturizer(mcfg, pack_label=True)(cols)
    assert packed.labels.shape == (0,)
    dev = jax.jit(lambda p: unpack_batch(p, mcfg, pack_label=True))(
        jax.tree.map(jnp.asarray, packed))
    np.testing.assert_array_equal(np.asarray(dev.labels), host.labels)
    for f in ("user_id", "product_id"):
        np.testing.assert_array_equal(np.asarray(dev.features[f].ids), host.features[f].ids)
        np.testing.assert_array_equal(np.asarray(dev.features[f].mask), host.features[f].mask)


def test_pack_label_rejects_huge_tables():
    big = cfg_lib.two_tower_model_config(num_users=1 << 30, num_items=10, embedding_dim=8)
    with pytest.raises(ValueError, match="2\\^30"):
        PackedFeaturizer(big, pack_label=True)


def test_multi_step_scan_matches_sequential(mcfg, rng):
    """K batches through one lax.scan dispatch == K sequential steps."""
    from two_tower_recommender_model.data.device_featurizer import unpack_batch
    from two_tower_recommender_model.train.step import make_multi_step, stack_batches

    tcfg = cfg_lib.TrainConfig()
    ds = SyntheticClickstream(100, 60, seed=2)
    packed_f = PackedFeaturizer(mcfg)
    host = [packed_f(ds.sample(64, start=i)) for i in range(6)]

    state_a, dense_opt = create_train_state(jax.random.key(0), mcfg, tcfg)
    state_b = state_a
    seq = make_train_step(mcfg, tcfg, dense_opt, donate=False)
    for pb in host:
        state_a, out_a = seq(state_a, unpack_batch(jax.tree.map(jnp.asarray, pb), mcfg))

    core = make_train_step(mcfg, tcfg, dense_opt, donate=False, jit=False)
    core_packed = lambda s, pb: core(s, unpack_batch(pb, mcfg))  # noqa: E731
    multi = make_multi_step(core_packed, donate=False)
    stacked = jax.tree.map(jnp.asarray, stack_batches(host))
    state_b, out_b = multi(state_b, stacked)
    assert out_b["loss"].shape == (6,)
    np.testing.assert_allclose(float(out_b["loss"][-1]), float(out_a["loss"]), rtol=1e-6)
    for name in state_a.tables:
        np.testing.assert_array_equal(np.asarray(state_a.tables[name]),
                                      np.asarray(state_b.tables[name]))
    assert int(state_b.step) == 6


def test_prefetch_multiworker_order_preserved(mcfg, rng):
    from two_tower_recommender_model.train.pipeline import prefetch_to_device

    feat = Featurizer(mcfg)
    ds = SyntheticClickstream(100, 60, seed=0)
    cols = [ds.sample(32, start=i) for i in range(12)]
    a = [np.asarray(b.labels) for b in prefetch_to_device(iter(cols), feat, num_workers=4)]
    b = [np.asarray(b.labels) for b in prefetch_to_device(iter(cols), feat, num_workers=1)]
    assert len(a) == len(b) == 12
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_macro_stream_groups_and_trains(mcfg):
    from two_tower_recommender_model.train.pipeline import macro_stream, prefetch_to_device
    from two_tower_recommender_model.train.step import make_multi_step

    tcfg = cfg_lib.TrainConfig()
    ds = SyntheticClickstream(100, 60, seed=3)
    pf = PackedFeaturizer(mcfg)
    state, dense_opt = create_train_state(jax.random.key(0), mcfg, tcfg)
    core = make_train_step(mcfg, tcfg, dense_opt, donate=False, jit=False)
    multi = make_multi_step(lambda s, pb: core(s, unpack_batch(pb, mcfg)), donate=False)
    macros = list(prefetch_to_device(
        macro_stream(ds.batches(64, 7), pf, k=3), lambda x: x))
    assert len(macros) == 2  # 7 batches -> 2 full macros, partial dropped
    assert macros[0].ids_raw.shape == (3, 64, 2)
    for mb in macros:
        state, out = multi(state, mb)
    assert int(state.step) == 6
    assert np.isfinite(np.asarray(out["loss"])).all()


def test_train_one_epoch_packed_matches_sequential(mcfg):
    """train_one_epoch_packed (worker-pool macro assembly) == sequential
    per-batch training over the same stream."""
    from two_tower_recommender_model.train.loop import train_one_epoch_packed
    from two_tower_recommender_model.train.step import make_multi_step

    tcfg = cfg_lib.TrainConfig()
    ds = SyntheticClickstream(100, 60, seed=5)
    pf = PackedFeaturizer(mcfg)
    host_cols = [ds.sample(64, start=i) for i in range(9)]  # 9 batches, macro=4 -> 8 used

    state_a, dense_opt = create_train_state(jax.random.key(0), mcfg, tcfg)
    state_b = state_a
    seq = make_train_step(mcfg, tcfg, dense_opt, donate=False)
    for cols in host_cols[:8]:
        state_a, out_a = seq(state_a, unpack_batch(jax.tree.map(jnp.asarray, pf(cols)), mcfg))

    core = make_train_step(mcfg, tcfg, dense_opt, donate=False, jit=False)
    multi = make_multi_step(lambda s, pb: core(s, unpack_batch(pb, mcfg)), donate=False)
    state_b, stats = train_one_epoch_packed(state_b, multi, iter(host_cols), pf,
                                            macro=4, num_workers=3)
    assert stats["train_steps"] == 8  # trailing partial macro dropped
    assert stats["train_examples"] == 8 * 64
    assert stats["examples_per_sec"] > 0
    np.testing.assert_allclose(stats["train_loss"], float(out_a["loss"]), rtol=1e-6)
    for name in state_a.tables:
        np.testing.assert_array_equal(np.asarray(state_a.tables[name]),
                                      np.asarray(state_b.tables[name]))


def test_train_one_epoch_packed_full_semantics(mcfg):
    """Unified packed epoch (round 2): limit_train_batches honored, trailing
    partial macro trained through tail_step (not dropped), mid-epoch
    validation fires at the validation_freq cadence — and the result equals
    sequential per-batch training over the same 9 batches."""
    from two_tower_recommender_model.data import Featurizer
    from two_tower_recommender_model.train.loop import train_one_epoch_packed
    from two_tower_recommender_model.train.step import make_multi_step

    tcfg = cfg_lib.TrainConfig(validation_freq=3, limit_train_batches=9,
                               limit_val_batches=2)
    ds = SyntheticClickstream(100, 60, seed=6)
    pf = PackedFeaturizer(mcfg)
    feat = Featurizer(mcfg)
    host_cols = [ds.sample(64, start=i) for i in range(12)]  # limited to 9
    val_cols = [ds.sample(64, start=100 + i, split="val") for i in range(2)]

    state_a, dense_opt = create_train_state(jax.random.key(0), mcfg, tcfg)
    state_b = state_a
    seq = make_train_step(mcfg, tcfg, dense_opt, donate=False)
    for cols in host_cols[:9]:
        state_a, out_a = seq(state_a, unpack_batch(jax.tree.map(jnp.asarray, pf(cols)), mcfg))

    core = make_train_step(mcfg, tcfg, dense_opt, donate=False, jit=False)
    multi = make_multi_step(lambda s, pb: core(s, unpack_batch(pb, mcfg)), donate=False)
    tail = make_packed_train_step(core, mcfg)

    class Rec:
        calls = []

        def log_metrics(self, m, step=None):
            Rec.calls.append(dict(m))

    state_b, stats = train_one_epoch_packed(
        state_b, multi, iter(host_cols), pf, macro=4,
        train_cfg=tcfg, tail_step=tail, eval_step=make_eval_step(mcfg, tcfg),
        val_batches_factory=lambda: iter(val_cols), val_featurizer=feat, logger=Rec(),
    )
    # 2 full macros (8 steps) + 1 tail batch = 9 steps, 9*64 examples
    assert stats["train_steps"] == 9
    assert stats["train_examples"] == 9 * 64
    # validations at step>=3 (after macro 1: step 4), >=6 (after macro 2:
    # step 8), >=9 (after the tail step): 3 mid-epoch validations
    assert len(Rec.calls) == 3
    assert all("val_loss" in c and np.isfinite(c["val_loss"]) for c in Rec.calls)
    np.testing.assert_allclose(stats["train_loss"], float(out_a["loss"]), rtol=1e-6)
    for name in state_a.tables:
        np.testing.assert_array_equal(np.asarray(state_a.tables[name]),
                                      np.asarray(state_b.tables[name]))


# --- sorted-batch fast path (TrainConfig.sorted_feature, DESIGN §6c) ---


def test_sort_feature_orders_rows_and_preserves_content(mcfg, rng):
    cols = {
        "user_id": np.concatenate([[0, 0], rng.integers(1, 300, 30)]),
        "product_id": rng.integers(0, 200, 32),
        "label": rng.integers(0, 2, 32),
    }
    plain = PackedFeaturizer(mcfg, pack_label=True)(cols)
    srt = PackedFeaturizer(mcfg, pack_label=True, sort_feature="user_id")(cols)
    raw = srt.ids_raw[:, 0] & ((1 << 30) - 1)
    n = 100  # num_users
    key = np.where(raw == 0, n, raw % n)
    assert (np.diff(key) >= 0).all(), "hashed sort keys must be non-decreasing"
    assert key[-2:].tolist() == [n, n], "missing ids sort last (sentinel key)"
    # same rows, just reordered — compare as sorted row tuples
    a = sorted(map(tuple, plain.ids_raw.tolist()))
    b = sorted(map(tuple, srt.ids_raw.tolist()))
    assert a == b


def test_sorted_feature_training_matches_unsorted(mcfg, rng):
    """sorted_feature + sorted featurizer == plain training (same batches):
    row order within a batch is loss-invariant and the hinted scatter computes
    the same Adagrad update."""
    from two_tower_recommender_model.data import SyntheticClickstream

    ds = SyntheticClickstream(100, 60, seed=11)
    cols_list = [ds.sample(128, start=i) for i in range(4)]

    def run(tcfg, featurizer):
        state, dense_opt = create_train_state(jax.random.key(3), mcfg, tcfg)
        core = make_train_step(mcfg, tcfg, dense_opt, donate=False, jit=False)
        step = make_packed_train_step(core, mcfg)
        losses = []
        for cols in cols_list:
            state, out = step(state, jax.tree.map(jnp.asarray, featurizer(cols)))
            losses.append(float(out["loss"]))
        return state, losses

    base_cfg = cfg_lib.TrainConfig()
    srt_cfg = cfg_lib.TrainConfig(sorted_feature="user_id")
    state_a, loss_a = run(base_cfg, PackedFeaturizer(mcfg))
    state_b, loss_b = run(srt_cfg, PackedFeaturizer(mcfg, sort_feature="user_id"))
    np.testing.assert_allclose(loss_a, loss_b, rtol=1e-5)
    for name in state_a.tables:
        np.testing.assert_allclose(np.asarray(state_a.tables[name]),
                                   np.asarray(state_b.tables[name]),
                                   rtol=1e-5, atol=1e-6)


def test_sorted_feature_validation():
    from two_tower_recommender_model.train.step import validate_sorted_feature

    mcfg = cfg_lib.two_tower_model_config(num_users=50, num_items=30)
    assert validate_sorted_feature(mcfg, cfg_lib.TrainConfig()) is None
    tbl = validate_sorted_feature(
        mcfg, cfg_lib.TrainConfig(sorted_feature="user_id")
    )
    assert tbl == mcfg.feature_table("user_id").name
    with pytest.raises(ValueError, match="no such feature"):
        validate_sorted_feature(mcfg, cfg_lib.TrainConfig(sorted_feature="nope"))
