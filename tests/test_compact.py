"""Compact wire format: must be bit-identical to the packed path end to end.

The compact encoder pre-hashes on host (`enc = 0 | (raw % N) + 1`) and ships
byte planes + packed remainder bits; the device decode must reproduce exactly
what `unpack_batch(PackedBatch)` computes — same hashed ids, same missing
mask (including the raw-hashes-to-0 and `_fit_int32` stand-in edge cases),
same labels — and training through it must produce identical parameters.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from two_tower_recommender_model import config as cfg_lib
from two_tower_recommender_model.data import Featurizer, SyntheticClickstream
from two_tower_recommender_model.data.compact import (
    CompactFeaturizer,
    CompactScheme,
    batch_from_compact,
    compact_from_packed,
    make_compact_train_step,
)
from two_tower_recommender_model.data.device_featurizer import (
    PackedFeaturizer,
    unpack_batch,
)
from two_tower_recommender_model.train.step import (
    create_train_state,
    make_multi_step,
    make_train_step,
    stack_batches,
)


@pytest.fixture
def mcfg():
    return cfg_lib.two_tower_model_config(num_users=100, num_items=60, embedding_dim=8,
                                          layer_sizes=(16, 8))


def flagship_cfg():
    return cfg_lib.two_tower_model_config(num_users=206_209, num_items=49_688,
                                          embedding_dim=8, layer_sizes=(16, 8))


def assert_batches_equal(a, b):
    for f in a.features:
        np.testing.assert_array_equal(np.asarray(a.features[f].ids),
                                      np.asarray(b.features[f].ids))
        np.testing.assert_array_equal(np.asarray(a.features[f].mask),
                                      np.asarray(b.features[f].mask))
    np.testing.assert_array_equal(np.asarray(a.labels), np.asarray(b.labels))
    if a.dense is not None or b.dense is not None:
        np.testing.assert_array_equal(np.asarray(a.dense), np.asarray(b.dense))


def test_flagship_scheme_bit_widths():
    scheme = CompactScheme.from_model(flagship_cfg(), pack_label=True)
    # user: 206,209 rows -> 18 id bits + label = 19 (2 bytes + 3 rem bits)
    # item: 49,688 rows -> 16 id bits (2 bytes + 0 rem bits)
    assert [(-(-s.bits // 1), s.nbytes, s.rem_bits) for s in scheme.slots] == [
        (19, 2, 3), (16, 2, 0)
    ]
    assert scheme.whole_bytes == 4
    assert scheme.rem_bits_total == 3
    assert scheme.wire_bytes_per_example == 4.375  # vs 8.0 packed


@pytest.mark.parametrize("pack_label", [False, True])
def test_compact_matches_unpack_batch(mcfg, rng, pack_label):
    # ids include: 0 (missing), hash-to-zero (multiples of 100/60), > N raw
    cols = {
        "user_id": np.concatenate([[0, 100, 200, 300], rng.integers(1, 5000, 28)]),
        "product_id": np.concatenate([rng.integers(1, 1000, 28), [0, 60, 120, 61]]),
        "label": rng.integers(0, 2, 32),
    }
    pf = PackedFeaturizer(mcfg, pack_label=pack_label)
    pb = pf(cols)
    ref = unpack_batch(jax.tree.map(jnp.asarray, pb), mcfg, pack_label=pack_label)
    scheme = CompactScheme.from_model(mcfg, pack_label=pack_label)
    cb = compact_from_packed(pb, scheme)
    got = jax.jit(lambda c: batch_from_compact(c, mcfg, scheme))(
        jax.tree.map(jnp.asarray, cb))
    assert_batches_equal(got, ref)


def test_compact_matches_host_featurizer_full_scale(rng):
    """Flagship table sizes exercise the remainder-bit path (19-bit slot)."""
    mcfg = flagship_cfg()
    cols = {
        "user_id": np.concatenate([[0], rng.integers(1, 2**31 - 1, 255)]),
        "product_id": rng.integers(0, 10**6, 256),
        "label": rng.integers(0, 2, 256),
    }
    host = Featurizer(mcfg)(cols)
    scheme = CompactScheme.from_model(mcfg, pack_label=True)
    cb = CompactFeaturizer(PackedFeaturizer(mcfg, pack_label=True), scheme)(cols)
    assert cb.wire.shape == (4, 256) and cb.rem.shape == (3, 32)
    got = batch_from_compact(jax.tree.map(jnp.asarray, cb), mcfg, scheme)
    assert_batches_equal(got, host)


def test_compact_multi_slot_and_dense(rng):
    mcfg = cfg_lib.ModelConfig(
        tables=(cfg_lib.TableConfig("t", 1000, 8, ("a", "b")),),
        features=(cfg_lib.FeatureConfig("a", "t"),
                  cfg_lib.FeatureConfig("b", "t", max_ids_per_sample=3)),
        query_tower=cfg_lib.TowerConfig(("a",), (8,)),
        candidate_tower=cfg_lib.TowerConfig(("b",), (8,)),
    )
    host_f = Featurizer(mcfg)
    bags = host_f.ragged("b", [[1, 2], [3, 4, 5, 6]] * 4)
    cols = {"a": np.array([7, 0] * 4), "b": bags,
            "label": np.zeros(8, np.int64), "price": rng.random(8)}
    pf = PackedFeaturizer(mcfg, dense_cols=("price",))
    scheme = CompactScheme.from_model(mcfg, pack_label=False)
    # 1000 rows -> 10 bits per slot, 4 slots: 0 whole bytes + ... falls back?
    # 4 slots x 2 rem bits each = 8 rem bits -> ok (8R = 64 > 32 would fall back)
    cb = compact_from_packed(pf(cols), scheme)
    ref = unpack_batch(jax.tree.map(jnp.asarray, pf(cols)), mcfg)
    got = batch_from_compact(jax.tree.map(jnp.asarray, cb), mcfg, scheme)
    assert_batches_equal(got, ref)


def test_compact_rem_overflow_falls_back_to_whole_bytes():
    # 5 slots x 7 rem bits = 35 rem bits -> 8*35 > 32, must fall back
    mcfg = cfg_lib.ModelConfig(
        tables=(cfg_lib.TableConfig("t", 100, 8, ("a", "b")),),
        features=(cfg_lib.FeatureConfig("a", "t"),
                  cfg_lib.FeatureConfig("b", "t", max_ids_per_sample=4)),
        query_tower=cfg_lib.TowerConfig(("a",), (8,)),
        candidate_tower=cfg_lib.TowerConfig(("b",), (8,)),
    )
    scheme = CompactScheme.from_model(mcfg, pack_label=False)
    assert scheme.rem_bits_total == 0
    assert all(s.nbytes == 1 for s in scheme.slots)  # 7 bits -> 1 byte each


def test_compact_requires_batch_multiple_of_8(mcfg):
    scheme = CompactScheme.from_model(mcfg, pack_label=True)
    if not scheme.rem_bits_total:
        pytest.skip("no remainder bits in this scheme")
    pb = PackedFeaturizer(mcfg, pack_label=True)(
        {"user_id": np.arange(1, 6), "product_id": np.arange(1, 6),
         "label": np.zeros(5, np.int64)})
    with pytest.raises(ValueError, match="% 8"):
        compact_from_packed(pb, scheme)


def test_compact_preserves_sort_order(mcfg, rng):
    cols = {
        "user_id": np.concatenate([[0, 0], rng.integers(1, 300, 30)]),
        "product_id": rng.integers(0, 200, 32),
        "label": rng.integers(0, 2, 32),
    }
    scheme = CompactScheme.from_model(mcfg, pack_label=True)
    pf = PackedFeaturizer(mcfg, pack_label=True, sort_feature="user_id")
    cb = CompactFeaturizer(pf, scheme)(cols)
    got = batch_from_compact(jax.tree.map(jnp.asarray, cb), mcfg, scheme)
    ref = unpack_batch(jax.tree.map(jnp.asarray, pf(cols)), mcfg, pack_label=True)
    assert_batches_equal(got, ref)
    # flat update key (hashed id, missing -> sentinel N) is non-decreasing
    ids = np.asarray(got.features["user_id"].ids[:, 0])
    mask = np.asarray(got.features["user_id"].mask[:, 0])
    key = np.where(mask > 0, ids, 100)
    assert (np.diff(key) >= 0).all()


def test_compact_train_step_matches_packed(mcfg):
    """Training through CompactBatch == training through PackedBatch, exactly."""
    tcfg = cfg_lib.TrainConfig()
    ds = SyntheticClickstream(100, 60, seed=7)
    scheme = CompactScheme.from_model(mcfg, pack_label=True)
    pf = PackedFeaturizer(mcfg, pack_label=True)

    state_a, dense_opt = create_train_state(jax.random.key(0), mcfg, tcfg)
    state_b = state_a
    core = make_train_step(mcfg, tcfg, dense_opt, donate=False, jit=False)
    packed_step = jax.jit(lambda s, pb: core(s, unpack_batch(pb, mcfg, pack_label=True)))
    compact_step = jax.jit(
        lambda s, cb: core(s, batch_from_compact(cb, mcfg, scheme)))

    for i in range(4):
        cols = ds.sample(64, start=i)
        pb = pf(cols)
        state_a, out_a = packed_step(state_a, jax.tree.map(jnp.asarray, pb))
        state_b, out_b = compact_step(
            state_b, jax.tree.map(jnp.asarray, compact_from_packed(pb, scheme)))
    np.testing.assert_array_equal(float(out_a["loss"]), float(out_b["loss"]))
    for name in state_a.tables:
        np.testing.assert_array_equal(np.asarray(state_a.tables[name]),
                                      np.asarray(state_b.tables[name]))


def test_compact_macro_scan_and_stack(mcfg):
    """stack_batches + make_multi_step work on CompactBatch macro payloads."""
    tcfg = cfg_lib.TrainConfig()
    ds = SyntheticClickstream(100, 60, seed=8)
    scheme = CompactScheme.from_model(mcfg, pack_label=True)
    cf = CompactFeaturizer(PackedFeaturizer(mcfg, pack_label=True), scheme)
    batches = [cf(ds.sample(64, start=i)) for i in range(4)]
    stacked = jax.tree.map(jnp.asarray, stack_batches(batches))
    assert stacked.wire.shape == (4, scheme.whole_bytes, 64)

    state, dense_opt = create_train_state(jax.random.key(0), mcfg, tcfg)
    core = make_train_step(mcfg, tcfg, dense_opt, donate=False, jit=False)
    multi = make_multi_step(
        lambda s, cb: core(s, batch_from_compact(cb, mcfg, scheme)), donate=False)
    state, out = multi(state, stacked)
    assert out["loss"].shape == (4,)
    assert np.isfinite(np.asarray(out["loss"])).all()
    assert int(state.step) == 4


def test_make_compact_train_step_wrapper(mcfg):
    tcfg = cfg_lib.TrainConfig()
    ds = SyntheticClickstream(100, 60, seed=9)
    scheme = CompactScheme.from_model(mcfg, pack_label=True)
    cf = CompactFeaturizer(PackedFeaturizer(mcfg, pack_label=True), scheme)
    state, dense_opt = create_train_state(jax.random.key(0), mcfg, tcfg)
    core = make_train_step(mcfg, tcfg, dense_opt, donate=False, jit=False)
    step = make_compact_train_step(core, mcfg, scheme)
    state, out = step(state, jax.tree.map(jnp.asarray, cf(ds.sample(64))))
    assert np.isfinite(float(out["loss"]))


# ---------------------------------------------------------------------------
# sorted-slot delta encoding


def _delta_scheme(mc, pack_label=True):
    return CompactScheme.from_model(mc, pack_label=pack_label,
                                    delta_feature="user_id")


@pytest.mark.parametrize("pack_label", [True, False])
def test_delta_roundtrip_bit_identical(rng, pack_label):
    """Delta-encoded sorted slot must decode to exactly unpack_batch's output
    (hashed ids, missing mask, labels)."""
    mc = flagship_cfg()
    feat = PackedFeaturizer(mc, pack_label=pack_label, sort_feature="user_id")
    scheme = _delta_scheme(mc, pack_label)
    ds = SyntheticClickstream(206_209, 49_688, seed=4)
    cols = ds.sample(2048)
    cols["user_id"][:17] = 0  # missing user ids (sort last, encode as N+1)
    pb = feat(cols)
    cb = compact_from_packed(pb, scheme)
    got = batch_from_compact(jax.tree.map(jnp.asarray, cb), mc, scheme)
    exp = unpack_batch(jax.tree.map(jnp.asarray, pb), mc, pack_label=pack_label)
    for name in exp.features:
        np.testing.assert_array_equal(np.asarray(got.features[name].ids),
                                      np.asarray(exp.features[name].ids))
        np.testing.assert_array_equal(np.asarray(got.features[name].mask),
                                      np.asarray(exp.features[name].mask))
    np.testing.assert_array_equal(np.asarray(got.labels), np.asarray(exp.labels))


def test_delta_wire_bytes_drop():
    mc = flagship_cfg()
    plain = CompactScheme.from_model(mc, pack_label=True)
    delta = _delta_scheme(mc)
    assert plain.wire_bytes_per_example == 4.375
    # 19-bit user slot (18 id + label) -> 8 delta bits + 1 label rem bit
    assert delta.wire_bytes_per_example == 3.125
    assert delta.delta_capacity == (206_209 + 1) // 256 + 2


def test_delta_exceptions_exercised(rng):
    """Sparse batches force deltas > 255: the exception sidecar must carry
    them exactly."""
    mc = flagship_cfg()
    feat = PackedFeaturizer(mc, pack_label=True, sort_feature="user_id")
    scheme = _delta_scheme(mc)
    # 64 users spread over the full 206k range -> every delta > 255
    cols = {
        "user_id": (rng.integers(1, 206_209, 64) * 1).astype(np.int64),
        "product_id": rng.integers(1, 49_688, 64).astype(np.int64),
        "label": rng.integers(0, 2, 64).astype(np.int64),
    }
    pb = feat(cols)
    cb = compact_from_packed(pb, scheme)
    assert int((np.asarray(cb.delta_extra) > 0).sum()) > 30
    got = batch_from_compact(jax.tree.map(jnp.asarray, cb), mc, scheme)
    exp = unpack_batch(jax.tree.map(jnp.asarray, pb), mc, pack_label=True)
    np.testing.assert_array_equal(np.asarray(got.features["user_id"].ids),
                                  np.asarray(exp.features["user_id"].ids))
    np.testing.assert_array_equal(np.asarray(got.labels), np.asarray(exp.labels))


def test_delta_rejects_unsorted_batch():
    mc = flagship_cfg()
    feat = PackedFeaturizer(mc, pack_label=True)  # NO sort
    scheme = _delta_scheme(mc)
    with pytest.raises(ValueError, match="sort"):
        CompactFeaturizer(feat, scheme)
    # direct encode of an unsorted PackedBatch also fails loudly
    rng = np.random.default_rng(0)
    cols = {
        "user_id": rng.integers(1, 206_209, 64).astype(np.int64),
        "product_id": rng.integers(1, 49_688, 64).astype(np.int64),
        "label": rng.integers(0, 2, 64).astype(np.int64),
    }
    with pytest.raises(ValueError, match="not sorted"):
        compact_from_packed(feat(cols), scheme)


def test_delta_train_step_matches_packed():
    """Training through the delta wire == training through PackedBatch."""
    mc = flagship_cfg()
    tcfg = cfg_lib.TrainConfig(sparse_learning_rate=0.05, learning_rate=1e-3,
                               sorted_feature="user_id")
    feat = PackedFeaturizer(mc, pack_label=True, sort_feature="user_id")
    scheme = _delta_scheme(mc)
    cfeat = CompactFeaturizer(feat, scheme)
    ds = SyntheticClickstream(206_209, 49_688, seed=6)

    state, dense_opt = create_train_state(jax.random.key(0), mc, tcfg)
    core = make_train_step(mc, tcfg, dense_opt, donate=False, jit=False)
    step_p = jax.jit(lambda s, pb: core(s, unpack_batch(pb, mc, pack_label=True)))
    step_c = make_compact_train_step(core, mc, scheme)

    s_p = s_c = state
    for i in range(3):
        cols = ds.sample(1024, start=i)
        pb = feat(cols)
        s_p, out_p = step_p(s_p, jax.tree.map(jnp.asarray, pb))
        s_c, out_c = step_c(s_c, jax.tree.map(jnp.asarray, compact_from_packed(pb, scheme)))
    np.testing.assert_array_equal(np.asarray(out_p["loss"]), np.asarray(out_c["loss"]))
    for name in s_p.tables:
        np.testing.assert_array_equal(np.asarray(s_p.tables[name]),
                                      np.asarray(s_c.tables[name]))


def test_delta_macro_stacking(rng):
    """stack_batches over CompactBatch with delta sidecars keeps per-batch
    exception arrays aligned (leading K axis)."""
    mc = flagship_cfg()
    feat = PackedFeaturizer(mc, pack_label=True, sort_feature="user_id")
    scheme = _delta_scheme(mc)
    cfeat = CompactFeaturizer(feat, scheme)
    ds = SyntheticClickstream(206_209, 49_688, seed=8)
    cbs = [cfeat(ds.sample(512, start=i)) for i in range(3)]
    mb = stack_batches(cbs)
    assert mb.delta_pos.shape[0] == 3
    one = jax.tree.map(lambda x: x[1], mb)
    got = batch_from_compact(jax.tree.map(jnp.asarray, one), mc, scheme)
    exp = batch_from_compact(jax.tree.map(jnp.asarray, cbs[1]), mc, scheme)
    np.testing.assert_array_equal(np.asarray(got.features["user_id"].ids),
                                  np.asarray(exp.features["user_id"].ids))


@pytest.mark.parametrize("seed", range(8))
def test_compact_roundtrip_fuzz(seed):
    """Randomized schemes (table counts/sizes, multi-slot features, missing
    ids, both pack_label modes) — the compact decode must equal unpack_batch
    bit-for-bit on every draw."""
    r = np.random.default_rng(seed)
    n_tables = int(r.integers(1, 4))
    tables, features = [], []
    for t in range(n_tables):
        n = int(r.integers(3, 300_000))
        tables.append(cfg_lib.TableConfig(f"t{t}", n, 8, (f"f{t}",)))
        L = int(r.integers(1, 4))
        features.append(cfg_lib.FeatureConfig(f"f{t}", f"t{t}",
                                              max_ids_per_sample=L,
                                              pooling=("sum", "mean")[t % 2]))
    mc = cfg_lib.ModelConfig(
        tables=tuple(tables), features=tuple(features),
        query_tower=cfg_lib.TowerConfig((features[0].name,), (8, 4)),
        candidate_tower=cfg_lib.TowerConfig((features[-1].name,), (8, 4)),
    )
    mc.validate()
    pack_label = bool(seed % 2)
    feat = PackedFeaturizer(mc, pack_label=pack_label)
    scheme = CompactScheme.from_model(mc, pack_label=pack_label)
    b = 64
    cols = {"label": r.integers(0, 2, b).astype(np.int64)}
    for fc in features:
        if fc.max_ids_per_sample == 1:
            v = r.integers(0, 1 << 30, b).astype(np.int64)
            v[r.random(b) < 0.2] = 0  # missing
            cols[fc.name] = v
        else:
            vals = r.integers(0, 1 << 30, (b, fc.max_ids_per_sample)).astype(np.int64)
            vals[r.random(vals.shape) < 0.3] = 0
            cols[fc.name] = vals
    pb = feat(cols)
    cb = compact_from_packed(pb, scheme)
    got = batch_from_compact(jax.tree.map(jnp.asarray, cb), mc, scheme)
    exp = unpack_batch(jax.tree.map(jnp.asarray, pb), mc, pack_label=pack_label)
    for name in exp.features:
        np.testing.assert_array_equal(np.asarray(got.features[name].ids),
                                      np.asarray(exp.features[name].ids), err_msg=name)
        np.testing.assert_array_equal(np.asarray(got.features[name].mask),
                                      np.asarray(exp.features[name].mask), err_msg=name)
    if pack_label:
        np.testing.assert_array_equal(np.asarray(got.labels), np.asarray(exp.labels))


@pytest.mark.parametrize("pack_label", [True, False])
def test_delta_segments_decode_bit_identical(rng, pack_label):
    """delta_segments=S: S per-slice-sorted encodes concatenated along the
    batch axis decode to exactly the concat of the per-slice unpack_batch
    outputs (the multi-host assembly layout — cumsum resets per segment,
    exception positions segment-relative)."""
    mc = flagship_cfg()
    S, b_loc = 4, 512
    feat = PackedFeaturizer(mc, pack_label=pack_label, sort_feature="user_id")
    scheme = CompactScheme.from_model(mc, pack_label=pack_label,
                                      delta_feature="user_id",
                                      delta_segments=S)
    assert scheme.delta_capacity % 64 == 0
    ds = SyntheticClickstream(206_209, 49_688, seed=11)
    slices, cbs, exps = [], [], []
    for h in range(S):
        cols = ds.sample(b_loc, start=1000 * h)
        if h == 1:
            cols["user_id"][:9] = 0  # missing ids in one slice
        pb = feat(cols)
        cbs.append(compact_from_packed(pb, scheme))
        exps.append(unpack_batch(jax.tree.map(jnp.asarray, pb), mc,
                                 pack_label=pack_label))
    # assemble like make_array_from_process_local_data: wire/rem concat on
    # the batch axis, sidecars+labels concat on axis 0
    from two_tower_recommender_model.data.compact import CompactBatch
    glob = CompactBatch(
        wire=np.concatenate([c.wire for c in cbs], axis=-1),
        rem=(np.concatenate([c.rem for c in cbs], axis=-1)
             if cbs[0].rem is not None else None),
        labels=np.concatenate([c.labels for c in cbs]),
        dense=None, weights=None,
        delta_pos=np.concatenate([c.delta_pos for c in cbs]),
        delta_extra=np.concatenate([c.delta_extra for c in cbs]),
    )
    got = batch_from_compact(jax.tree.map(jnp.asarray, glob), mc, scheme)
    for name in exps[0].features:
        np.testing.assert_array_equal(
            np.asarray(got.features[name].ids),
            np.concatenate([np.asarray(e.features[name].ids) for e in exps]))
        np.testing.assert_array_equal(
            np.asarray(got.features[name].mask),
            np.concatenate([np.asarray(e.features[name].mask) for e in exps]))
    np.testing.assert_array_equal(
        np.asarray(got.labels),
        np.concatenate([np.asarray(e.labels) for e in exps]))
