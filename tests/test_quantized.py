"""Int8 quantized tables: round-trip accuracy, lookup parity, training
tracks f32, export dequantizes."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from two_tower_recommender_model import config as cfg_lib
from two_tower_recommender_model.data import Featurizer, SyntheticClickstream
from two_tower_recommender_model.ops.quantized import (
    QuantizedTable,
    dequantize_table,
    quantize_table,
    quantized_pooled_lookup,
)
from two_tower_recommender_model.train.pipeline import prefetch_to_device
from two_tower_recommender_model.train.step import create_train_state, make_train_step


def test_quantize_roundtrip_error_bound(rng):
    t = jnp.asarray(rng.normal(size=(50, 128)) * 0.3, jnp.float32)
    qt = quantize_table(t)
    assert qt.values.dtype == jnp.int8
    back = dequantize_table(qt)
    # error bounded by scale/254 per element
    bound = np.asarray(qt.scales)[:, None] / 254.0 + 1e-7
    assert (np.abs(np.asarray(back) - np.asarray(t)) <= bound).all()


def test_zero_row_safe():
    t = jnp.zeros((4, 8), jnp.float32)
    qt = quantize_table(t)
    np.testing.assert_array_equal(dequantize_table(qt), 0.0)


def test_quantized_lookup_close_to_f32(rng):
    t = jnp.asarray(rng.normal(size=(40, 16)) * 0.2, jnp.float32)
    qt = quantize_table(t)
    ids = jnp.asarray(rng.integers(0, 40, (8, 3)), jnp.int32)
    w = jnp.asarray(rng.random((8, 3)), jnp.float32)
    got = quantized_pooled_lookup(qt, ids, w)
    want = (np.asarray(t)[np.asarray(ids)] * np.asarray(w)[..., None]).sum(1)
    np.testing.assert_allclose(got, want, atol=0.01)


def test_int8_training_tracks_f32():
    """table_dtype=int8 trains end to end; loss stays close to f32 over a
    short horizon and tables remain int8 throughout."""
    results = {}
    for td in (None, "int8"):
        mcfg = cfg_lib.two_tower_model_config(100, 60, 16, (32, 16))
        if td:
            mcfg = dataclasses.replace(mcfg, table_dtype=td)
        tcfg = cfg_lib.TrainConfig(sparse_learning_rate=0.05)
        ds = SyntheticClickstream(100, 60, seed=0)
        feat = Featurizer(mcfg)
        state, dense_opt = create_train_state(jax.random.key(0), mcfg, tcfg)
        step = make_train_step(mcfg, tcfg, dense_opt, donate=False)
        for batch in prefetch_to_device(ds.batches(256, 25), feat):
            state, out = step(state, batch)
        if td == "int8":
            assert isinstance(state.tables["t_user_id"], QuantizedTable)
            assert state.tables["t_user_id"].values.dtype == jnp.int8
        results[td] = float(out["loss"])
    assert abs(results["int8"] - results[None]) < 0.03, results


def test_int8_export_dequantizes(tmp_path):
    from two_tower_recommender_model.serving import load_scorer
    from two_tower_recommender_model.utils.checkpoint import export_model

    mcfg = dataclasses.replace(
        cfg_lib.two_tower_model_config(50, 30, 8, (16, 8)), table_dtype="int8")
    state, _ = create_train_state(jax.random.key(0), mcfg, cfg_lib.TrainConfig())
    export_model(str(tmp_path / "m"), mcfg, state)
    scorer = load_scorer(str(tmp_path / "m"))
    p = scorer.predict({"user_id": [1, 2], "product_id": [3, 4]})
    assert p.shape == (2,) and np.isfinite(p).all()


def test_int8_column_sharded_guard():
    """Column sharding is incompatible with per-row scales; clear error."""
    from two_tower_recommender_model.parallel import make_mesh, plan_sharding, shard_train_state
    from two_tower_recommender_model.parallel.planner import COLUMN_SHARDED
    import pytest

    mcfg = dataclasses.replace(
        cfg_lib.two_tower_model_config(50, 30, 8, (16, 8)), table_dtype="int8")
    state, _ = create_train_state(jax.random.key(0), mcfg, cfg_lib.TrainConfig())
    mesh = make_mesh(8, 1)
    plan = plan_sharding(mcfg, 8, force={"t_user_id": COLUMN_SHARDED,
                                         "t_product_id": COLUMN_SHARDED})
    with pytest.raises(NotImplementedError, match="scales"):
        shard_train_state(state, plan, mesh)
    # replicated int8 works
    plan_rep = plan_sharding(mcfg, 8)  # small tables -> replicated
    sh = shard_train_state(state, plan_rep, mesh)
    assert isinstance(sh.tables["t_user_id"], QuantizedTable)


def test_int8_row_sharded_matches_single_device():
    """int8 tables row-sharded over 8 devices == single-device int8 training."""
    from two_tower_recommender_model.parallel import (
        batch_sharding, make_mesh, make_sharded_train_step, plan_sharding,
        shard_train_state)
    from two_tower_recommender_model.parallel.planner import ROW_SHARDED
    from two_tower_recommender_model.parallel.sharded import unshard_train_state
    import jax

    mcfg = dataclasses.replace(
        cfg_lib.two_tower_model_config(100, 60, 16, (32, 8)), table_dtype="int8")
    tcfg = cfg_lib.TrainConfig(sparse_learning_rate=0.05)
    ds = SyntheticClickstream(100, 60, seed=2)
    feat = Featurizer(mcfg)
    batches = [jax.tree.map(jnp.asarray, feat(ds.sample(64, start=i))) for i in range(3)]

    state, dense_opt = create_train_state(jax.random.key(0), mcfg, tcfg)
    ref_state = state
    ref_step = make_train_step(mcfg, tcfg, dense_opt, donate=False)
    for b in batches:
        ref_state, ref_out = ref_step(ref_state, b)

    mesh = make_mesh(8, 1)
    plan = plan_sharding(mcfg, 8, force={"t_user_id": ROW_SHARDED,
                                         "t_product_id": ROW_SHARDED})
    sh_state = shard_train_state(state, plan, mesh)
    assert isinstance(sh_state.tables["t_user_id"], QuantizedTable)
    step = make_sharded_train_step(mcfg, tcfg, dense_opt, mesh, plan, donate=False)
    sh = batch_sharding(mesh)
    for b in batches:
        sh_state, out = step(sh_state, jax.tree.map(lambda x: jax.device_put(x, sh(x)), b))

    np.testing.assert_allclose(float(out["loss"]), float(ref_out["loss"]), rtol=1e-5)
    gathered = unshard_train_state(sh_state, plan, mcfg)
    for name in ref_state.tables:
        np.testing.assert_array_equal(np.asarray(gathered.tables[name].values),
                                      np.asarray(ref_state.tables[name].values))
        np.testing.assert_allclose(np.asarray(gathered.tables[name].scales),
                                   np.asarray(ref_state.tables[name].scales), rtol=1e-5)


def test_quantized_dense_sorted_hint_identical(rng):
    """int8 transient-dense update: sorted ids + hint == unsorted (same math,
    different scatter scheduling) — the int8 arm of DESIGN §6c."""
    import jax.numpy as jnp

    from two_tower_recommender_model.ops.quantized import (
        quantize_table,
        quantized_dense_rowwise_adagrad,
    )

    n, d, m = 30, 8, 64
    qt = quantize_table(jnp.asarray(rng.normal(size=(n, d)), jnp.float32))
    acc = jnp.asarray(rng.random(n), jnp.float32)
    ids = np.sort(rng.integers(0, n, m).astype(np.int32))
    grads = jnp.asarray(rng.normal(size=(m, d)), jnp.float32)
    plain_t, plain_a = quantized_dense_rowwise_adagrad(
        qt, acc, jnp.asarray(ids), grads, 0.1)
    fast_t, fast_a = quantized_dense_rowwise_adagrad(
        qt, acc, jnp.asarray(ids), grads, 0.1, ids_sorted=True)
    np.testing.assert_array_equal(np.asarray(plain_t.values), np.asarray(fast_t.values))
    np.testing.assert_array_equal(np.asarray(plain_t.scales), np.asarray(fast_t.scales))
    np.testing.assert_allclose(np.asarray(plain_a), np.asarray(fast_a), rtol=1e-6)


def test_gather_int8_rows_bitcast_identity():
    """The int32-packed gather is byte-identical to the direct int8 take,
    including 2D id arrays and the D % 4 != 0 fallback."""
    import numpy as np
    from two_tower_recommender_model.ops.quantized import gather_int8_rows

    rng = np.random.default_rng(0)
    vals = jnp.asarray(rng.integers(-127, 128, size=(37, 8), dtype=np.int8))
    ids = jnp.asarray(rng.integers(0, 37, size=(11, 3), dtype=np.int32))
    np.testing.assert_array_equal(
        np.asarray(gather_int8_rows(vals, ids)),
        np.asarray(jnp.take(vals, ids, axis=0)),
    )
    vals5 = jnp.asarray(rng.integers(-127, 128, size=(16, 5), dtype=np.int8))
    ids1 = jnp.asarray(rng.integers(0, 16, size=(7,), dtype=np.int32))
    np.testing.assert_array_equal(
        np.asarray(gather_int8_rows(vals5, ids1)),
        np.asarray(jnp.take(vals5, ids1, axis=0)),
    )


def test_gather_int8_rows_scales_fused_identity():
    """The packed rows+scale gather returns byte-identical values and scales."""
    import numpy as np
    from two_tower_recommender_model.ops.quantized import (
        gather_int8_rows_scales,
    )

    rng = np.random.default_rng(1)
    vals = jnp.asarray(rng.integers(-127, 128, size=(23, 8), dtype=np.int8))
    scales = jnp.asarray(rng.uniform(0.1, 3.0, size=23).astype(np.float32))
    ids = jnp.asarray(rng.integers(0, 23, size=(9, 2), dtype=np.int32))
    got_v, got_s = gather_int8_rows_scales(vals, scales, ids)
    np.testing.assert_array_equal(np.asarray(got_v), np.asarray(jnp.take(vals, ids, axis=0)))
    np.testing.assert_array_equal(np.asarray(got_s), np.asarray(jnp.take(scales, ids, axis=0)))
    # D % 4 != 0 fallback
    vals5 = jnp.asarray(rng.integers(-127, 128, size=(13, 5), dtype=np.int8))
    scl5 = jnp.asarray(rng.uniform(0.1, 3.0, size=13).astype(np.float32))
    ids1 = jnp.asarray(rng.integers(0, 13, size=(6,), dtype=np.int32))
    got_v5, got_s5 = gather_int8_rows_scales(vals5, scl5, ids1)
    np.testing.assert_array_equal(np.asarray(got_v5), np.asarray(jnp.take(vals5, ids1, axis=0)))
    np.testing.assert_array_equal(np.asarray(got_s5), np.asarray(jnp.take(scl5, ids1, axis=0)))


def test_big_int8_table_inits_without_f32_intermediate(monkeypatch):
    """Beyond-f32-capacity int8 tables chunk-init directly (no full f32
    table): lower the threshold so the path runs at test scale, and check
    the state is a valid QuantizedTable with in-bounds values and per-row
    absmax scales matching a dequantize-requantize round trip."""
    import two_tower_recommender_model.models.two_tower as tt
    from two_tower_recommender_model import config as cfg_lib
    from two_tower_recommender_model.train.step import create_train_state

    monkeypatch.setattr(tt, "BIG_INT8_INIT_ROWS", 500)
    mcfg = cfg_lib.two_tower_model_config(num_users=1200, num_items=60,
                                          embedding_dim=16, layer_sizes=(16, 8))
    mcfg = dataclasses.replace(mcfg, table_dtype="int8")
    state, _ = create_train_state(jax.random.key(0), mcfg, cfg_lib.TrainConfig())
    qt = state.tables["t_user_id"]
    assert isinstance(qt, QuantizedTable) and qt.values.shape == (1200, 16)
    vals = np.asarray(qt.values)
    assert vals.min() >= -127 and vals.max() <= 127 and np.abs(vals).max() > 0
    # scales are the rows' absmax in the dequantized domain: requantizing
    # the dequantized table is a fixed point (same bytes)
    deq = dequantize_table(qt)
    rq = quantize_table(deq)
    np.testing.assert_array_equal(np.asarray(rq.values), vals)
    # the small item table still takes the full-init + quantize path
    assert isinstance(state.tables["t_product_id"], QuantizedTable)
    assert state.adagrad_acc["t_user_id"].shape == (1200,)


def test_packed_storage_matches_unpacked_bitwise(monkeypatch):
    """Packed int32-word storage is the SAME bytes: training with packed
    tables must be bitwise identical to the unpacked s8 format (gathers
    return identical rows; the requant math is shared), across several
    steps and through the forward/eval path."""
    import two_tower_recommender_model.ops.quantized as q
    import two_tower_recommender_model.models.two_tower as tt
    from two_tower_recommender_model import config as cfg_lib
    from two_tower_recommender_model.data import Featurizer, SyntheticClickstream
    from two_tower_recommender_model.train.step import (
        create_train_state,
        make_train_step,
    )

    mcfg = cfg_lib.two_tower_model_config(num_users=700, num_items=300,
                                          embedding_dim=16, layer_sizes=(16, 8))
    mcfg = dataclasses.replace(mcfg, table_dtype="int8")
    tcfg = cfg_lib.TrainConfig(sparse_learning_rate=0.05)
    ds = SyntheticClickstream(699, 299, seed=7)
    feat = Featurizer(mcfg)
    batches = [jax.tree.map(jnp.asarray, feat(ds.sample(64, start=i)))
               for i in range(4)]

    states = {}
    for mode in ("unpacked", "packed"):
        if mode == "packed":
            # chunk-init + packed storage at test scale
            monkeypatch.setattr(tt, "BIG_INT8_INIT_ROWS", 500)
            monkeypatch.setattr(q, "PACKED_STORAGE_MIN_ROWS", 500)
        else:
            monkeypatch.setattr(tt, "BIG_INT8_INIT_ROWS", 500)
            monkeypatch.setattr(q, "PACKED_STORAGE_MIN_ROWS", 10**9)
        state, dense_opt = create_train_state(jax.random.key(0), mcfg, tcfg)
        step = make_train_step(mcfg, tcfg, dense_opt, donate=False)
        for b in batches:
            state, out = step(state, b)
        states[mode] = (state, float(out["loss"]))

    up, pk = states["unpacked"], states["packed"]
    assert up[0].tables["t_user_id"].packed is False
    assert pk[0].tables["t_user_id"].packed is True
    assert pk[0].tables["t_user_id"].values.dtype == jnp.int32
    assert pk[0].tables["t_user_id"].shape == (700, 16)
    np.testing.assert_array_equal(
        np.asarray(dequantize_table(pk[0].tables["t_user_id"])),
        np.asarray(dequantize_table(up[0].tables["t_user_id"])))
    # identical raw bytes, not just dequantized values
    from two_tower_recommender_model.ops.quantized import unpack_int8_values

    np.testing.assert_array_equal(
        np.asarray(unpack_int8_values(pk[0].tables["t_user_id"].values, 16)),
        np.asarray(up[0].tables["t_user_id"].values))
    assert pk[1] == up[1]  # loss bitwise equal


def test_packed_storage_rejected_by_sharded_state(monkeypatch):
    import pytest

    import two_tower_recommender_model.ops.quantized as q
    import two_tower_recommender_model.models.two_tower as tt
    from two_tower_recommender_model import config as cfg_lib
    from two_tower_recommender_model.parallel import (
        make_mesh, plan_sharding, shard_train_state)
    from two_tower_recommender_model.train.step import create_train_state

    monkeypatch.setattr(tt, "BIG_INT8_INIT_ROWS", 500)
    monkeypatch.setattr(q, "PACKED_STORAGE_MIN_ROWS", 500)
    mcfg = cfg_lib.two_tower_model_config(num_users=700, num_items=300,
                                          embedding_dim=16, layer_sizes=(16, 8))
    mcfg = dataclasses.replace(mcfg, table_dtype="int8")
    state, _ = create_train_state(jax.random.key(0), mcfg, cfg_lib.TrainConfig())
    plan = plan_sharding(mcfg, 8)
    with pytest.raises(NotImplementedError, match="PACKED int8 storage"):
        shard_train_state(state, plan, make_mesh(8, 1))


def test_packed_checkpoint_and_export_roundtrip(tmp_path, monkeypatch):
    """Packed tables must survive the orbax checkpoint round trip (the
    `packed` flag is pytree aux data, values stay int32 words) and export
    to the portable f32 saved-model through dequantize_table."""
    import two_tower_recommender_model.ops.quantized as q
    import two_tower_recommender_model.models.two_tower as tt
    from two_tower_recommender_model import config as cfg_lib
    from two_tower_recommender_model.train.step import create_train_state
    from two_tower_recommender_model.utils.checkpoint import (
        Checkpointer,
        export_model,
        load_model,
    )

    monkeypatch.setattr(tt, "BIG_INT8_INIT_ROWS", 500)
    monkeypatch.setattr(q, "PACKED_STORAGE_MIN_ROWS", 500)
    mcfg = cfg_lib.two_tower_model_config(num_users=700, num_items=300,
                                          embedding_dim=16, layer_sizes=(16, 8))
    mcfg = dataclasses.replace(mcfg, table_dtype="int8")
    state, _ = create_train_state(jax.random.key(0), mcfg, cfg_lib.TrainConfig())
    assert state.tables["t_user_id"].packed

    ckpt = Checkpointer(str(tmp_path / "c"))
    ckpt.save(0, state, wait=True)
    fresh, _ = create_train_state(jax.random.key(1), mcfg, cfg_lib.TrainConfig())
    restored, _, _ = ckpt.restore(fresh)
    rt = restored.tables["t_user_id"]
    assert rt.packed and rt.values.dtype == jnp.int32
    np.testing.assert_array_equal(np.asarray(rt.values),
                                  np.asarray(state.tables["t_user_id"].values))
    ckpt.close()

    export_model(str(tmp_path / "m"), mcfg, state)
    cfg2, params2 = load_model(str(tmp_path / "m"))
    np.testing.assert_allclose(
        params2["tables"]["t_user_id"],
        np.asarray(dequantize_table(state.tables["t_user_id"])), rtol=1e-6)
