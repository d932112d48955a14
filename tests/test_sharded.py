"""Multi-device correctness on the 8-device CPU mesh: the sharded train step
must reproduce the single-device step bit-for-bit (up to float tolerance) —
the JAX analog of validating DMP against single-GPU numerics (SURVEY §7.4)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from two_tower_recommender_model import config as cfg_lib
from two_tower_recommender_model.data import Featurizer, SyntheticClickstream
from two_tower_recommender_model.parallel import (
    batch_sharding,
    make_mesh,
    make_sharded_eval_step,
    make_sharded_train_step,
    plan_sharding,
    shard_train_state,
)
from two_tower_recommender_model.parallel.planner import REPLICATED, ROW_SHARDED
from two_tower_recommender_model.parallel.sharded import (
    make_sharded_lookup,
    unshard_train_state,
)
from two_tower_recommender_model.train.step import (
    create_train_state,
    eval_state_init,
    make_eval_step,
    make_train_step,
)
from two_tower_recommender_model.models.metrics import auroc_compute, mean_compute


def _put_batch(batch, mesh):
    sh = batch_sharding(mesh)
    return jax.tree.map(lambda x: jax.device_put(x, sh(x)), batch)


@pytest.fixture
def setup():
    mcfg = cfg_lib.two_tower_model_config(num_users=100, num_items=60, embedding_dim=16,
                                          layer_sizes=(32, 8))
    tcfg = cfg_lib.TrainConfig(sparse_learning_rate=0.05, learning_rate=1e-3)
    ds = SyntheticClickstream(100, 60, seed=2)
    feat = Featurizer(mcfg)
    batches = [jax.tree.map(jnp.asarray, feat(ds.sample(64, start=i))) for i in range(4)]
    return mcfg, tcfg, batches


@pytest.mark.parametrize("mesh_shape", [(8, 1), (4, 2), (2, 4)])
def test_sharded_matches_single_device(setup, mesh_shape):
    mcfg, tcfg, batches = setup
    mesh = make_mesh(*mesh_shape)
    plan = plan_sharding(mcfg, mesh.devices.size, force={
        "t_user_id": ROW_SHARDED, "t_product_id": ROW_SHARDED})
    assert plan["t_user_id"].padded_rows % 8 == 0

    state, dense_opt = create_train_state(jax.random.key(0), mcfg, tcfg)
    ref_state = state

    # single-device reference
    ref_step = make_train_step(mcfg, tcfg, dense_opt, donate=False)
    for b in batches:
        ref_state, ref_out = ref_step(ref_state, b)

    sh_state = shard_train_state(state, plan, mesh)
    step = make_sharded_train_step(mcfg, tcfg, dense_opt, mesh, plan, donate=False)
    for b in batches:
        sh_state, out = step(sh_state, _put_batch(b, mesh))

    np.testing.assert_allclose(float(out["loss"]), float(ref_out["loss"]), rtol=1e-5)
    gathered = unshard_train_state(sh_state, plan, mcfg)
    for name in ref_state.tables:
        np.testing.assert_allclose(
            gathered.tables[name], np.asarray(ref_state.tables[name]), rtol=1e-4, atol=1e-6
        )
        np.testing.assert_allclose(
            gathered.adagrad_acc[name], np.asarray(ref_state.adagrad_acc[name]),
            rtol=1e-4, atol=1e-6,
        )
    ref_dense = jax.tree.leaves(ref_state.dense_params)
    got_dense = jax.tree.leaves(gathered.dense_params)
    for a, b in zip(got_dense, ref_dense):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-4, atol=1e-6)


def test_mixed_replicated_and_sharded(setup):
    mcfg, tcfg, batches = setup
    mesh = make_mesh(8, 1)
    plan = plan_sharding(mcfg, 8, force={
        "t_user_id": ROW_SHARDED, "t_product_id": REPLICATED})
    state, dense_opt = create_train_state(jax.random.key(0), mcfg, tcfg)
    ref_state = state
    ref_step = make_train_step(mcfg, tcfg, dense_opt, donate=False)
    for b in batches[:2]:
        ref_state, _ = ref_step(ref_state, b)

    sh_state = shard_train_state(state, plan, mesh)
    step = make_sharded_train_step(mcfg, tcfg, dense_opt, mesh, plan, donate=False)
    for b in batches[:2]:
        sh_state, _ = step(sh_state, _put_batch(b, mesh))
    gathered = unshard_train_state(sh_state, plan, mcfg)
    for name in ref_state.tables:
        np.testing.assert_allclose(
            gathered.tables[name], np.asarray(ref_state.tables[name]), rtol=1e-4, atol=1e-6
        )


def test_sharded_lookup_vs_local(rng):
    mesh = make_mesh(4, 2)
    table = jnp.asarray(rng.normal(size=(64, 8)), jnp.float32)
    ids = jnp.asarray(rng.integers(0, 64, (16, 3)), jnp.int32)
    w = jnp.asarray((rng.random((16, 3)) > 0.3), jnp.float32)
    lookup = make_sharded_lookup(mesh)
    got = jax.jit(lookup)(
        jax.device_put(table, jax.NamedSharding(mesh, jax.P(("data", "model"), None))),
        ids, w,
    )
    want = (np.asarray(table)[np.asarray(ids)] * np.asarray(w)[..., None]).sum(1)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_sharded_eval_matches_single(setup):
    mcfg, tcfg, batches = setup
    mesh = make_mesh(8, 1)
    plan = plan_sharding(mcfg, 8, force={
        "t_user_id": ROW_SHARDED, "t_product_id": ROW_SHARDED})
    state, _ = create_train_state(jax.random.key(0), mcfg, tcfg)
    ref_es = eval_state_init()
    ref_estep = make_eval_step(mcfg, tcfg)
    for b in batches:
        ref_es = ref_estep(state, ref_es, b)

    sh_state = shard_train_state(state, plan, mesh)
    estep = make_sharded_eval_step(mcfg, tcfg, mesh, plan)
    es = eval_state_init()
    for b in batches:
        es = estep(sh_state, es, _put_batch(b, mesh))
    np.testing.assert_allclose(float(mean_compute(es.loss)), float(mean_compute(ref_es.loss)), rtol=1e-5)
    np.testing.assert_allclose(float(auroc_compute(es.auroc)), float(auroc_compute(ref_es.auroc)), rtol=1e-5)


def test_planner_budget_and_plan_print():
    mcfg = cfg_lib.two_tower_model_config(num_users=100_000, num_items=50_000,
                                          embedding_dim=128)
    plan = plan_sharding(mcfg, 8, replicate_threshold_bytes=1 << 20)
    assert plan["t_user_id"].strategy == ROW_SHARDED
    desc = plan.describe()
    assert "t_user_id" in desc and "row_sharded" in desc
    with pytest.raises(MemoryError):
        plan_sharding(mcfg, 8, hbm_budget_bytes=4 << 20, replicate_threshold_bytes=1 << 20)
    # single device => everything replicated
    plan1 = plan_sharding(mcfg, 1)
    assert all(s.strategy == REPLICATED for s in plan1.specs.values())


def test_sharded_topk_matches_dense(rng):
    from two_tower_recommender_model.parallel.sharded import make_sharded_topk
    from jax.sharding import NamedSharding
    from jax import P as _P

    mesh = make_mesh(4, 2)
    corpus = jnp.asarray(rng.normal(size=(512, 16)), jnp.float32)
    queries = jnp.asarray(rng.normal(size=(10, 16)), jnp.float32)
    sharded_corpus = jax.device_put(corpus, NamedSharding(mesh, _P(("data", "model"), None)))
    topk = make_sharded_topk(mesh, k=12, corpus_chunk=32)
    vals, idx = topk(queries, sharded_corpus)
    scores = np.asarray(queries) @ np.asarray(corpus).T
    want_idx = np.argsort(-scores, axis=1)[:, :12]
    want_vals = np.take_along_axis(scores, want_idx, 1)
    np.testing.assert_allclose(np.asarray(vals), want_vals, rtol=1e-5, atol=1e-6)
    got_scores = np.take_along_axis(scores, np.asarray(idx), 1)
    np.testing.assert_allclose(got_scores, want_vals, rtol=1e-5, atol=1e-6)


def test_sharded_topk_k_exceeds_shard(rng):
    # k larger than any single shard's row count still returns global top-k
    from two_tower_recommender_model.parallel.sharded import make_sharded_topk
    from jax.sharding import NamedSharding
    from jax import P as _P

    mesh = make_mesh(8, 1)
    corpus = jnp.asarray(rng.normal(size=(64, 8)), jnp.float32)  # 8 rows/shard
    queries = jnp.asarray(rng.normal(size=(3, 8)), jnp.float32)
    sharded_corpus = jax.device_put(corpus, NamedSharding(mesh, _P(("data", "model"), None)))
    vals, idx = make_sharded_topk(mesh, k=16, corpus_chunk=8)(queries, sharded_corpus)
    scores = np.asarray(queries) @ np.asarray(corpus).T
    want = -np.sort(-scores, axis=1)[:, :16]
    np.testing.assert_allclose(np.asarray(vals), want, rtol=1e-5, atol=1e-6)


def test_sharded_topk_non_multiple_corpus(rng):
    """Corpus row counts that don't divide the mesh (the real-data case:
    49,688 Instacart items minus the sentinel = 49,687) are padded and
    masked internally — pad rows can never evict real candidates, indices
    stay exact global rows."""
    from two_tower_recommender_model.parallel.sharded import make_sharded_topk

    mesh = make_mesh(4, 2)
    # 119 rows over 8 devices; make every true score NEGATIVE so a zero pad
    # row would win if it leaked into any shard's local top-k
    corpus = jnp.asarray(-np.abs(rng.normal(size=(119, 8))) - 0.1, jnp.float32)
    queries = jnp.asarray(np.abs(rng.normal(size=(5, 8))) + 0.1, jnp.float32)
    vals, idx = make_sharded_topk(mesh, k=12, corpus_chunk=16)(queries, corpus)
    scores = np.asarray(queries) @ np.asarray(corpus).T
    want_idx = np.argsort(-scores, axis=1)[:, :12]
    want_vals = np.take_along_axis(scores, want_idx, 1)
    np.testing.assert_allclose(np.asarray(vals), want_vals, rtol=1e-5, atol=1e-6)
    assert np.asarray(idx).max() < 119
    got_scores = np.take_along_axis(scores, np.asarray(idx), 1)
    np.testing.assert_allclose(got_scores, want_vals, rtol=1e-5, atol=1e-6)


def test_padded_eval_matches_unpadded(setup):
    """Zero-weight padding must not change eval metrics: sharded eval over
    padded ragged batches == single-device eval over the raw stream."""
    from two_tower_recommender_model.data.featurizer import pad_batch
    from two_tower_recommender_model.data import SyntheticClickstream

    mcfg, tcfg, _ = setup
    ds = SyntheticClickstream(100, 60, seed=3)
    feat = Featurizer(mcfg)
    # ragged batch sizes: 50, 37, 13 (none divisible by 8)
    cols = [ds.sample(n, "val", start=i) for i, n in enumerate((50, 37, 13))]

    state, _ = create_train_state(jax.random.key(0), mcfg, tcfg)
    ref_estep = make_eval_step(mcfg, tcfg)
    ref_es = eval_state_init()
    for c in cols:
        ref_es = ref_estep(state, ref_es, jax.tree.map(jnp.asarray, feat(c)))

    mesh = make_mesh(8, 1)
    plan = plan_sharding(mcfg, 8, force={"t_user_id": ROW_SHARDED,
                                         "t_product_id": ROW_SHARDED})
    sh_state = shard_train_state(state, plan, mesh)
    estep = make_sharded_eval_step(mcfg, tcfg, mesh, plan)
    es = eval_state_init()
    for c in cols:
        b = pad_batch(feat(c), 8)
        assert b.batch_size % 8 == 0
        es = estep(sh_state, es, _put_batch(jax.tree.map(jnp.asarray, b), mesh))
    np.testing.assert_allclose(float(mean_compute(es.loss)),
                               float(mean_compute(ref_es.loss)), rtol=1e-5)
    np.testing.assert_allclose(float(auroc_compute(es.auroc)),
                               float(auroc_compute(ref_es.auroc)), rtol=1e-5)


@pytest.mark.parametrize("mesh_shape", [(8, 1), (4, 2)])
def test_column_sharded_matches_single_device(setup, mesh_shape):
    """Column-sharded tables (TorchRec's column-wise sharder analog) must
    reproduce single-device numerics, including the cross-shard psum in the
    row-wise Adagrad accumulator."""
    from two_tower_recommender_model.parallel.planner import COLUMN_SHARDED

    mcfg, tcfg, batches = setup
    mesh = make_mesh(*mesh_shape)
    plan = plan_sharding(mcfg, mesh.devices.size, force={
        "t_user_id": COLUMN_SHARDED, "t_product_id": COLUMN_SHARDED})
    assert plan["t_user_id"].padded_dim % 8 == 0

    state, dense_opt = create_train_state(jax.random.key(0), mcfg, tcfg)
    ref_state = state
    ref_step = make_train_step(mcfg, tcfg, dense_opt, donate=False)
    for b in batches:
        ref_state, ref_out = ref_step(ref_state, b)

    sh_state = shard_train_state(state, plan, mesh)
    step = make_sharded_train_step(mcfg, tcfg, dense_opt, mesh, plan, donate=False)
    for b in batches:
        sh_state, out = step(sh_state, _put_batch(b, mesh))

    np.testing.assert_allclose(float(out["loss"]), float(ref_out["loss"]), rtol=1e-5)
    gathered = unshard_train_state(sh_state, plan, mcfg)
    for name in ref_state.tables:
        np.testing.assert_allclose(
            gathered.tables[name], np.asarray(ref_state.tables[name]), rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(
            gathered.adagrad_acc[name], np.asarray(ref_state.adagrad_acc[name]),
            rtol=1e-4, atol=1e-6)


def test_mixed_row_column_replicated(setup):
    from two_tower_recommender_model.parallel.planner import COLUMN_SHARDED

    mcfg, tcfg, batches = setup
    mesh = make_mesh(8, 1)
    plan = plan_sharding(mcfg, 8, force={
        "t_user_id": ROW_SHARDED, "t_product_id": COLUMN_SHARDED})
    state, dense_opt = create_train_state(jax.random.key(0), mcfg, tcfg)
    ref_state = state
    ref_step = make_train_step(mcfg, tcfg, dense_opt, donate=False)
    for b in batches[:2]:
        ref_state, _ = ref_step(ref_state, b)
    sh_state = shard_train_state(state, plan, mesh)
    step = make_sharded_train_step(mcfg, tcfg, dense_opt, mesh, plan, donate=False)
    for b in batches[:2]:
        sh_state, _ = step(sh_state, _put_batch(b, mesh))
    gathered = unshard_train_state(sh_state, plan, mcfg)
    for name in ref_state.tables:
        np.testing.assert_allclose(
            gathered.tables[name], np.asarray(ref_state.tables[name]), rtol=1e-4, atol=1e-6)


def test_column_sharded_dim_padding():
    """embedding_dim not divisible by device count pads columns; numerics and
    export shape stay correct."""
    from two_tower_recommender_model.parallel.planner import COLUMN_SHARDED

    mcfg = cfg_lib.two_tower_model_config(num_users=50, num_items=30, embedding_dim=12,
                                          layer_sizes=(16, 8))
    tcfg = cfg_lib.TrainConfig()
    ds = SyntheticClickstream(50, 30, seed=1)
    feat = Featurizer(mcfg)
    batches = [jax.tree.map(jnp.asarray, feat(ds.sample(32, start=i))) for i in range(2)]
    mesh = make_mesh(8, 1)
    plan = plan_sharding(mcfg, 8, force={"t_user_id": COLUMN_SHARDED,
                                         "t_product_id": COLUMN_SHARDED})
    assert plan["t_user_id"].padded_dim == 16

    state, dense_opt = create_train_state(jax.random.key(0), mcfg, tcfg)
    ref_state = state
    ref_step = make_train_step(mcfg, tcfg, dense_opt, donate=False)
    for b in batches:
        ref_state, _ = ref_step(ref_state, b)

    sh_state = shard_train_state(state, plan, mesh)
    step = make_sharded_train_step(mcfg, tcfg, dense_opt, mesh, plan, donate=False)
    for b in batches:
        sh_state, _ = step(sh_state, _put_batch(b, mesh))
    gathered = unshard_train_state(sh_state, plan, mcfg)
    assert gathered.tables["t_user_id"].shape == (50, 12)
    for name in ref_state.tables:
        np.testing.assert_allclose(
            gathered.tables[name], np.asarray(ref_state.tables[name]), rtol=1e-4, atol=1e-6)


def test_pad_to_eval_with_all_padding_batches(setup):
    """evaluate(pad_to=N): every batch grows to exactly N zero-weight-padded
    rows, and an all-padding (0-row source) batch contributes NOTHING to the
    metrics — the multi-host aligned-eval contract (a host whose data ran
    out keeps dispatching filler batches so collectives line up)."""
    from two_tower_recommender_model.data import SyntheticClickstream
    from two_tower_recommender_model.data.featurizer import pad_batch_to
    from two_tower_recommender_model.train.loop import evaluate

    mcfg, tcfg, _ = setup
    ds = SyntheticClickstream(100, 60, seed=4)
    feat = Featurizer(mcfg)
    cols = [ds.sample(n, "val", start=i) for i, n in enumerate((64, 64, 29))]
    empty = {k: v[:0] for k, v in cols[0].items()}

    state, _ = create_train_state(jax.random.key(0), mcfg, tcfg)
    estep = make_eval_step(mcfg, tcfg)
    ref = evaluate(state, estep, cols, feat, stage="val")
    got = evaluate(state, estep, cols + [empty, empty], feat, stage="val", pad_to=64)
    np.testing.assert_allclose(got["val_loss"], ref["val_loss"], rtol=1e-5)
    np.testing.assert_allclose(got["val_auroc"], ref["val_auroc"], rtol=1e-5)

    # fixed shapes: pad_batch_to output is always exactly pad_to rows
    for c in cols + [empty]:
        assert pad_batch_to(feat(c), 64).batch_size == 64
    with pytest.raises(ValueError):
        pad_batch_to(feat(cols[0]), 32)


# ---------------------------------------------------------------------------
# all-to-all exchange (sharded_exchange="alltoall", DESIGN §9)


@pytest.mark.parametrize("mesh_shape", [(8, 1), (4, 2)])
def test_alltoall_matches_single_device(setup, mesh_shape):
    """The O(B_local x D) all-to-all exchange must reproduce single-device
    numerics exactly like the dense scheme does — including the model-axis
    responsibility split and duplicate-id grad aggregation on the owner."""
    mcfg, tcfg, batches = setup
    tcfg = cfg_lib.TrainConfig(
        sparse_learning_rate=0.05, learning_rate=1e-3,
        sharded_exchange="alltoall", exchange_capacity_factor=2.0,
    )
    mesh = make_mesh(*mesh_shape)
    plan = plan_sharding(mcfg, mesh.devices.size, force={
        "t_user_id": ROW_SHARDED, "t_product_id": ROW_SHARDED})

    state, dense_opt = create_train_state(jax.random.key(0), mcfg, tcfg)
    ref_state = state
    ref_step = make_train_step(mcfg, tcfg, dense_opt, donate=False)
    for b in batches:
        ref_state, ref_out = ref_step(ref_state, b)

    sh_state = shard_train_state(state, plan, mesh)
    step = make_sharded_train_step(mcfg, tcfg, dense_opt, mesh, plan, donate=False)
    for b in batches:
        sh_state, out = step(sh_state, _put_batch(b, mesh))
        assert int(out["exchange_overflow"]) == 0

    np.testing.assert_allclose(float(out["loss"]), float(ref_out["loss"]), rtol=1e-5)
    gathered = unshard_train_state(sh_state, plan, mcfg)
    for name in ref_state.tables:
        np.testing.assert_allclose(
            gathered.tables[name], np.asarray(ref_state.tables[name]),
            rtol=1e-4, atol=1e-6,
        )
        np.testing.assert_allclose(
            gathered.adagrad_acc[name], np.asarray(ref_state.adagrad_acc[name]),
            rtol=1e-4, atol=1e-6,
        )


def test_alltoall_hot_id_dedupes_not_overflows(setup):
    """A pathologically hot id (every row the same user) must NOT overflow:
    the exchange dedupes, so a hot id costs ONE bucket slot and one wire
    row regardless of its multiplicity — and the step still matches the
    single-device numerics."""
    mcfg, _, _ = setup
    tcfg = cfg_lib.TrainConfig(
        sharded_exchange="alltoall", exchange_capacity_factor=0.05,
    )
    mesh = make_mesh(8, 1)
    plan = plan_sharding(mcfg, 8, force={
        "t_user_id": ROW_SHARDED, "t_product_id": ROW_SHARDED})
    state, dense_opt = create_train_state(jax.random.key(0), mcfg, tcfg)
    feat = Featurizer(mcfg)
    skewed = jax.tree.map(jnp.asarray, feat({
        "user_id": np.full(512, 5, np.int64),  # every id -> one bucket slot
        "product_id": np.arange(1, 513, dtype=np.int64) % 59 + 1,
        "label": np.ones(512, np.int64),
    }))
    ref_step = make_train_step(mcfg, tcfg, dense_opt, donate=False)
    ref_state, ref_out = ref_step(state, skewed)
    sh_state = shard_train_state(state, plan, mesh)
    step = make_sharded_train_step(mcfg, tcfg, dense_opt, mesh, plan, donate=False)
    sh_state, out = step(sh_state, _put_batch(skewed, mesh))
    assert int(out["exchange_overflow"]) == 0
    np.testing.assert_allclose(float(out["loss"]), float(ref_out["loss"]),
                               rtol=1e-5)
    gathered = unshard_train_state(sh_state, plan, mcfg)
    np.testing.assert_allclose(
        gathered.tables["t_user_id"], np.asarray(ref_state.tables["t_user_id"]),
        rtol=1e-4, atol=1e-6)


def test_alltoall_overflow_flag():
    """DISTINCT ids past a bucket's unique-id capacity are dropped AND
    counted (the max_unique_ids_per_partition-style guard): many distinct
    ids concentrated on one shard with a tiny capacity_factor must fire
    exchange_overflow instead of failing silently. Note the rows-per-shard
    capacity bound makes this impossible on small tables — the table must
    be large enough that the batch-proportional capacity binds."""
    mcfg = cfg_lib.two_tower_model_config(num_users=4096, num_items=60,
                                          embedding_dim=16, layer_sizes=(32, 8))
    tcfg = cfg_lib.TrainConfig(
        sharded_exchange="alltoall", exchange_capacity_factor=0.05,
    )
    mesh = make_mesh(8, 1)
    plan = plan_sharding(mcfg, 8, force={
        "t_user_id": ROW_SHARDED, "t_product_id": ROW_SHARDED})
    state, dense_opt = create_train_state(jax.random.key(0), mcfg, tcfg)
    sh_state = shard_train_state(state, plan, mesh)
    step = make_sharded_train_step(mcfg, tcfg, dense_opt, mesh, plan, donate=False)
    feat = Featurizer(mcfg)
    # 512 rows -> 64 DISTINCT ids per data slice, all owned by shard 0
    # (rows_per_shard = 512), against a unique-capacity of 8
    concentrated = jax.tree.map(jnp.asarray, feat({
        "user_id": (np.arange(512, dtype=np.int64) % 500) + 1,
        "product_id": np.arange(1, 513, dtype=np.int64) % 59 + 1,
        "label": np.ones(512, np.int64),
    }))
    _, out = step(sh_state, _put_batch(concentrated, mesh))
    assert int(out["exchange_overflow"]) > 0


def test_alltoall_bf16_wire_close_to_exact(setup):
    """exchange_wire_dtype=bfloat16 halves the dominant collective payloads;
    values round once on the wire, so results track the exact path at bf16
    tolerance."""
    mcfg, _, batches = setup
    mesh = make_mesh(8, 1)
    plan = plan_sharding(mcfg, 8, force={
        "t_user_id": ROW_SHARDED, "t_product_id": ROW_SHARDED})
    state, dense_opt = create_train_state(jax.random.key(0), mcfg,
                                          cfg_lib.TrainConfig())
    outs = {}
    for wire in ("float32", "bfloat16"):
        tcfg = cfg_lib.TrainConfig(
            sharded_exchange="alltoall", exchange_wire_dtype=wire,
            exchange_capacity_factor=2.0,
        )
        sh_state = shard_train_state(state, plan, mesh)
        step = make_sharded_train_step(mcfg, tcfg, dense_opt, mesh, plan,
                                       donate=False)
        s = sh_state
        for b in batches[:2]:
            s, out = step(s, _put_batch(b, mesh))
        outs[wire] = (float(out["loss"]),
                      unshard_train_state(s, plan, mcfg).tables["t_user_id"])
    np.testing.assert_allclose(outs["bfloat16"][0], outs["float32"][0], rtol=2e-2)
    np.testing.assert_allclose(np.asarray(outs["bfloat16"][1]),
                               np.asarray(outs["float32"][1]),
                               rtol=2e-2, atol=2e-3)


def test_alltoall_eval_matches_dense(setup):
    """The eval forward under the alltoall exchange == the dense exchange."""
    mcfg, _, batches = setup
    mesh = make_mesh(8, 1)
    plan = plan_sharding(mcfg, 8, force={
        "t_user_id": ROW_SHARDED, "t_product_id": ROW_SHARDED})
    state, dense_opt = create_train_state(jax.random.key(0), mcfg,
                                          cfg_lib.TrainConfig())
    sh_state = shard_train_state(state, plan, mesh)
    results = {}
    for exchange in ("dense", "alltoall"):
        tcfg = cfg_lib.TrainConfig(sharded_exchange=exchange,
                                   exchange_capacity_factor=2.0)
        estep = make_sharded_eval_step(mcfg, tcfg, mesh, plan)
        es = eval_state_init()
        for b in batches[:2]:
            es = estep(sh_state, es, _put_batch(b, mesh))
        results[exchange] = (float(mean_compute(es.loss)),
                             float(auroc_compute(es.auroc)))
    np.testing.assert_allclose(results["alltoall"][0], results["dense"][0],
                               rtol=1e-6)
    np.testing.assert_allclose(results["alltoall"][1], results["dense"][1],
                               rtol=1e-6)


def test_alltoall_overflow_survives_macro_scan(setup):
    """The macro scan must carry the exchange's dropped-id count (silent
    drops are the one failure mode the static-capacity design may not
    have): a clean run reports 0, and the packed multi-step output shape
    stays loop-compatible."""
    from two_tower_recommender_model.data.device_featurizer import (
        PackedFeaturizer,
    )
    from two_tower_recommender_model.parallel import (
        macro_batch_sharding,
        make_sharded_multi_step,
    )
    from two_tower_recommender_model.train.step import stack_batches
    from two_tower_recommender_model.train.pipeline import device_put_batch

    mcfg, _, _ = setup
    tcfg = cfg_lib.TrainConfig(sharded_exchange="alltoall",
                               exchange_capacity_factor=2.0)
    mesh = make_mesh(8, 1)
    plan = plan_sharding(mcfg, 8, force={
        "t_user_id": ROW_SHARDED, "t_product_id": ROW_SHARDED})
    state, dense_opt = create_train_state(jax.random.key(0), mcfg, tcfg)
    sh_state = shard_train_state(state, plan, mesh)
    feat = PackedFeaturizer(mcfg, pack_label=True)
    from two_tower_recommender_model.data import SyntheticClickstream

    ds = SyntheticClickstream(100, 60, seed=4)
    mb = device_put_batch(
        stack_batches([feat(ds.sample(64, start=i)) for i in range(3)]),
        macro_batch_sharding(mesh))
    multi = make_sharded_multi_step(mcfg, tcfg, dense_opt, mesh, plan,
                                    donate=False)
    _, out = multi(sh_state, mb)
    assert out["loss"].shape == (3,)
    assert int(out["exchange_overflow"]) == 0

    # the dense exchange's output keeps its original shape (no key)
    tcfg_d = cfg_lib.TrainConfig()
    multi_d = make_sharded_multi_step(mcfg, tcfg_d, dense_opt, mesh, plan,
                                      donate=False)
    _, out_d = multi_d(sh_state, mb)
    assert "exchange_overflow" not in out_d


def test_alltoall_overflow_raises_from_loop_and_eval():
    """Capacity overflow must SURFACE: the epoch loop raises at epoch end
    and evaluate() raises before returning metrics (the 'never drop
    silently' invariant, CLAUDE.md) — both driven end-to-end through the
    public loop APIs."""
    from two_tower_recommender_model.train.loop import evaluate, train_one_epoch

    mcfg = cfg_lib.two_tower_model_config(num_users=4096, num_items=60,
                                          embedding_dim=16, layer_sizes=(32, 8))
    tcfg = cfg_lib.TrainConfig(
        sharded_exchange="alltoall", exchange_capacity_factor=0.05,
    )
    mesh = make_mesh(8, 1)
    plan = plan_sharding(mcfg, 8, force={
        "t_user_id": ROW_SHARDED, "t_product_id": ROW_SHARDED})
    state, dense_opt = create_train_state(jax.random.key(0), mcfg, tcfg)
    sh_state = shard_train_state(state, plan, mesh)
    step = make_sharded_train_step(mcfg, tcfg, dense_opt, mesh, plan, donate=False)
    feat = Featurizer(mcfg)
    sh = batch_sharding(mesh)

    def batches():
        yield {  # 64 distinct ids per data slice, all owned by shard 0
            "user_id": (np.arange(512, dtype=np.int64) % 500) + 1,
            "product_id": np.arange(1, 513, dtype=np.int64) % 59 + 1,
            "label": np.ones(512, np.int64),
        }

    featurize = lambda cols: jax.tree.map(  # noqa: E731
        lambda x: jax.device_put(jnp.asarray(x), sh(x)), feat(cols))
    with pytest.raises(RuntimeError, match="dropped .* distinct"):
        train_one_epoch(sh_state, step, batches(), featurize, tcfg)

    estep = make_sharded_eval_step(mcfg, tcfg, mesh, plan)
    with pytest.raises(RuntimeError, match="eval dropped"):
        evaluate(sh_state, estep, batches(), featurize)


def test_sharded_topk_valid_count_masks_resident_padding(rng):
    """A pre-padded resident corpus (the serving pattern) with `valid=` set
    must mask its zero pad rows exactly like internal padding — zero rows
    would otherwise beat all-negative true scores."""
    from two_tower_recommender_model.parallel.sharded import make_sharded_topk

    mesh = make_mesh(8, 1)
    true_rows = 117
    corpus = jnp.asarray(-np.abs(rng.normal(size=(true_rows, 8))) - 0.1,
                         jnp.float32)
    pad = (-true_rows) % 8
    padded = jnp.concatenate([corpus, jnp.zeros((pad, 8), jnp.float32)])
    queries = jnp.asarray(np.abs(rng.normal(size=(4, 8))) + 0.1, jnp.float32)
    vals, idx = make_sharded_topk(mesh, k=10, corpus_chunk=16)(
        queries, padded, valid=true_rows)
    scores = np.asarray(queries) @ np.asarray(corpus).T
    want_idx = np.argsort(-scores, axis=1)[:, :10]
    np.testing.assert_allclose(
        np.asarray(vals), np.take_along_axis(scores, want_idx, 1),
        rtol=1e-5, atol=1e-6)
    assert np.asarray(idx).max() < true_rows
