"""Table-wise sharding: bucket placement, cost-model planner choices, and
numerics == single-device on virtual meshes (the TorchRec `table_wise`
sharder role, `03_model_training.py:797-815`)."""

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
from two_tower_recommender_model.parallel.planner import (
    REPLICATED,
    ROW_SHARDED,
    TABLE_WISE,
)
from two_tower_recommender_model.parallel.sharded import unshard_train_state
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


def test_planner_cost_model_picks_table_wise_for_midsize():
    """Mid-size tables (fits comfortably on one device, too big to
    replicate): the cost model must choose table_wise; huge tables must stay
    row_sharded; tiny ones replicated."""
    mcfg = cfg_lib.ModelConfig(
        tables=(
            cfg_lib.TableConfig("tiny", 1_000, 128),        # ~0.5 MB
            cfg_lib.TableConfig("mid", 50_000, 128),        # ~26 MB
            cfg_lib.TableConfig("huge", 3_000_000, 128),    # ~1.5 GB
        ),
        features=(
            cfg_lib.FeatureConfig("tiny", "tiny"),
            cfg_lib.FeatureConfig("mid", "mid"),
            cfg_lib.FeatureConfig("huge", "huge"),
        ),
        query_tower=cfg_lib.TowerConfig(("tiny", "mid"), (16, 8)),
        candidate_tower=cfg_lib.TowerConfig(("huge",), (16, 8)),
    )
    plan = plan_sharding(mcfg, 8)
    assert plan["tiny"].strategy == REPLICATED
    assert plan["mid"].strategy == TABLE_WISE
    assert plan["huge"].strategy == ROW_SHARDED
    assert plan["mid"].owner in range(8)
    assert plan.buckets[plan["mid"].bucket].embedding_dim == 128
    assert "table_wise" in plan.describe() and "bucket" in plan.describe()


def test_bucket_bin_packing_balances_devices():
    tables = tuple(
        cfg_lib.TableConfig(f"t{i}", 10_000 + i * 1000, 64) for i in range(6)
    )
    mcfg = cfg_lib.ModelConfig(
        tables=tables,
        features=tuple(cfg_lib.FeatureConfig(f"t{i}", f"t{i}") for i in range(6)),
        query_tower=cfg_lib.TowerConfig(("t0", "t1", "t2"), (8,)),
        candidate_tower=cfg_lib.TowerConfig(("t3", "t4", "t5"), (8,)),
    )
    plan = plan_sharding(mcfg, 4, force={f"t{i}": TABLE_WISE for i in range(6)})
    (bucket,) = plan.buckets.values()
    assert set(bucket.tables) == {f"t{i}" for i in range(6)}
    # no device overloaded: max load <= total/min + largest table
    loads = {}
    for i in range(6):
        s = plan[f"t{i}"]
        loads[s.owner] = loads.get(s.owner, 0) + s.num_embeddings
    assert max(loads.values()) <= bucket.rows_per_device
    # offsets within one device are non-overlapping
    for dev in loads:
        spans = sorted(
            (plan[f"t{i}"].bucket_offset, plan[f"t{i}"].num_embeddings)
            for i in range(6) if plan[f"t{i}"].owner == dev
        )
        end = 0
        for off, n in spans:
            assert off >= end
            end = off + n


@pytest.mark.parametrize("mesh_shape", [(8, 1), (4, 2)])
def test_table_wise_matches_single_device(setup, mesh_shape):
    mcfg, tcfg, batches = setup
    mesh = make_mesh(*mesh_shape)
    plan = plan_sharding(mcfg, mesh.devices.size, force={
        "t_user_id": TABLE_WISE, "t_product_id": TABLE_WISE})
    assert plan["t_user_id"].bucket == plan["t_product_id"].bucket

    state, dense_opt = create_train_state(jax.random.key(0), mcfg, tcfg)
    ref_state = state
    ref_step = make_train_step(mcfg, tcfg, dense_opt, donate=False)
    for b in batches:
        ref_state, ref_out = ref_step(ref_state, b)

    sh_state = shard_train_state(state, plan, mesh)
    assert plan["t_user_id"].bucket in sh_state.tables
    assert "t_user_id" not in sh_state.tables  # lives inside the bucket
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


def test_table_wise_mixed_with_row_and_replicated(setup):
    """One TW table + one row-sharded: both collective families in one step."""
    mcfg, tcfg, batches = setup
    mesh = make_mesh(8, 1)
    plan = plan_sharding(mcfg, 8, force={
        "t_user_id": ROW_SHARDED, "t_product_id": TABLE_WISE})
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


def test_table_wise_eval_matches_single(setup):
    mcfg, tcfg, batches = setup
    mesh = make_mesh(8, 1)
    plan = plan_sharding(mcfg, 8, force={
        "t_user_id": TABLE_WISE, "t_product_id": TABLE_WISE})
    state, _ = create_train_state(jax.random.key(0), mcfg, tcfg)

    ref_es = eval_state_init()
    ref_step = make_eval_step(mcfg, tcfg)
    for b in batches:
        ref_es = ref_step(state, ref_es, b)

    sh_state = shard_train_state(state, plan, mesh)
    from two_tower_recommender_model.parallel import make_sharded_eval_step

    es = eval_state_init()
    estep = make_sharded_eval_step(mcfg, tcfg, mesh, plan)
    for b in batches:
        es = estep(sh_state, es, _put_batch(b, mesh))
    np.testing.assert_allclose(float(mean_compute(es.loss)),
                               float(mean_compute(ref_es.loss)), rtol=1e-5)
    np.testing.assert_allclose(float(auroc_compute(es.auroc)),
                               float(auroc_compute(ref_es.auroc)), rtol=1e-5)


def test_sharded_multi_step_matches_sequential(setup):
    """K-step packed macro scan over the sharded step == K sequential sharded
    steps == single-device — the multi-chip fast path (make_sharded_multi_step)."""
    import numpy as np

    from two_tower_recommender_model.data.device_featurizer import PackedFeaturizer
    from two_tower_recommender_model.data import SyntheticClickstream
    from two_tower_recommender_model.parallel import (
        macro_batch_sharding, make_sharded_multi_step)
    from two_tower_recommender_model.train.step import stack_batches

    mcfg, tcfg, batches = setup
    mesh = make_mesh(8, 1)
    plan = plan_sharding(mcfg, 8, force={
        "t_user_id": ROW_SHARDED, "t_product_id": TABLE_WISE})
    state, dense_opt = create_train_state(jax.random.key(0), mcfg, tcfg)

    ds = SyntheticClickstream(100, 60, seed=2)
    pf = PackedFeaturizer(mcfg, pack_label=True)
    host_cols = [ds.sample(64, start=i) for i in range(4)]

    # sequential sharded reference
    ref = shard_train_state(state, plan, mesh)
    step = make_sharded_train_step(mcfg, tcfg, dense_opt, mesh, plan, donate=False)
    feat = Featurizer(mcfg)
    for cols in host_cols:
        b = jax.tree.map(jnp.asarray, feat(cols))
        ref, ref_out = step(ref, _put_batch(b, mesh))

    # packed macro scan
    sh = shard_train_state(state, plan, mesh)
    multi = make_sharded_multi_step(mcfg, tcfg, dense_opt, mesh, plan, donate=False)
    mb = stack_batches([pf(c) for c in host_cols])
    msh = macro_batch_sharding(mesh)
    mb = jax.tree.map(lambda x: jax.device_put(x, msh(x)), mb)
    sh, out = multi(sh, mb)

    np.testing.assert_allclose(float(out["loss"][-1]), float(ref_out["loss"]), rtol=1e-5)
    a = unshard_train_state(sh, plan, mcfg)
    b = unshard_train_state(ref, plan, mcfg)
    for name in a.tables:
        np.testing.assert_allclose(a.tables[name], b.tables[name], rtol=1e-5, atol=1e-7)


def test_comm_volume_report_groups_and_totals():
    """The analytic comm table: replicated tables show only the bwd gather;
    sharded strategies add fwd collectives; every table-wise table of one dim
    rides ONE bucket group; the totals are O(B x D), never O(rows)."""
    from two_tower_recommender_model.parallel.planner import comm_volume_report

    mcfg = cfg_lib.ModelConfig(
        tables=(
            cfg_lib.TableConfig("small", 100, 16),
            cfg_lib.TableConfig("tw_a", 5000, 16),
            cfg_lib.TableConfig("tw_b", 6000, 16),
            cfg_lib.TableConfig("big", 100_000, 16),
        ),
        features=(
            cfg_lib.FeatureConfig("small", "small"),
            cfg_lib.FeatureConfig("tw_a", "tw_a"),
            cfg_lib.FeatureConfig("tw_b", "tw_b"),
            cfg_lib.FeatureConfig("big", "big"),
        ),
        query_tower=cfg_lib.TowerConfig(("small", "tw_a"), (8,)),
        candidate_tower=cfg_lib.TowerConfig(("tw_b", "big"), (8,)),
    )
    plan = plan_sharding(mcfg, 4, force={
        "small": REPLICATED, "tw_a": TABLE_WISE, "tw_b": TABLE_WISE,
        "big": ROW_SHARDED})
    rep = comm_volume_report(mcfg, plan, batch_size=256)
    # one bucket group for BOTH tw tables
    assert rep.count("__tw_bucket_d16__") == 3  # 3 collective lines, once
    assert "tw_a" not in rep.replace("__tw_bucket_d16__", "")
    # replicated: exactly one line (bwd)
    assert rep.count("small") == 1
    # bwd gather bytes for 'small': B * L * D * 4 = 256*1*16*4
    assert f"{256*16*4:,}" in rep
    # the report never mentions table row counts in byte columns: totals are
    # batch-bound — doubling rows leaves the total unchanged
    mcfg2 = cfg_lib.ModelConfig(
        tables=tuple(cfg_lib.TableConfig(t.name, t.num_embeddings * 2, 16)
                     for t in mcfg.tables),
        features=mcfg.features, query_tower=mcfg.query_tower,
        candidate_tower=mcfg.candidate_tower)
    plan2 = plan_sharding(mcfg2, 4, force={
        "small": REPLICATED, "tw_a": TABLE_WISE, "tw_b": TABLE_WISE,
        "big": ROW_SHARDED})
    rep2 = comm_volume_report(mcfg2, plan2, batch_size=256)
    assert rep.splitlines()[-1] == rep2.splitlines()[-1]


def test_int8_table_wise_matches_single_device():
    """Round 2b: int8 tables can shard TABLE_WISE (quantized bucket with a
    parallel scales array); numerics == the single-device quantized step."""
    import dataclasses

    mcfg = cfg_lib.two_tower_model_config(num_users=100, num_items=60,
                                          embedding_dim=16, layer_sizes=(32, 8))
    mcfg = dataclasses.replace(mcfg, table_dtype="int8")
    tcfg = cfg_lib.TrainConfig(sparse_learning_rate=0.05, learning_rate=1e-3)
    ds = SyntheticClickstream(100, 60, seed=5)
    feat = Featurizer(mcfg)
    batches = [jax.tree.map(jnp.asarray, feat(ds.sample(64, start=i))) for i in range(3)]

    mesh = make_mesh(8, 1)
    plan = plan_sharding(mcfg, 8, force={
        "t_user_id": TABLE_WISE, "t_product_id": TABLE_WISE})
    # int8 bucket is dtype-suffixed and distinct from any f32 bucket
    assert set(plan.buckets) == {"__tw_bucket_d16_int8__"}
    assert plan.buckets["__tw_bucket_d16_int8__"].dtype == "int8"

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
        np.testing.assert_array_equal(
            np.asarray(gathered.tables[name].values),
            np.asarray(ref_state.tables[name].values),
        )
        np.testing.assert_allclose(
            np.asarray(gathered.tables[name].scales),
            np.asarray(ref_state.tables[name].scales), rtol=1e-6,
        )
        np.testing.assert_allclose(
            gathered.adagrad_acc[name], np.asarray(ref_state.adagrad_acc[name]),
            rtol=1e-5, atol=1e-7,
        )


def test_mixed_dtype_table_wise_buckets_are_separate():
    """f32 and int8 table-wise tables of the same dim land in DIFFERENT
    buckets and still train."""
    mcfg = cfg_lib.ModelConfig(
        tables=(
            cfg_lib.TableConfig("t_u", 80, 16, ("u",)),
            cfg_lib.TableConfig("t_i", 50, 16, ("i",), dtype="int8"),
        ),
        features=(
            cfg_lib.FeatureConfig("u", "t_u"),
            cfg_lib.FeatureConfig("i", "t_i"),
        ),
        query_tower=cfg_lib.TowerConfig(("u",), (16, 8)),
        candidate_tower=cfg_lib.TowerConfig(("i",), (16, 8)),
    )
    mcfg.validate()
    tcfg = cfg_lib.TrainConfig(sparse_learning_rate=0.05)
    mesh = make_mesh(8, 1)
    plan = plan_sharding(mcfg, 8, force={"t_u": TABLE_WISE, "t_i": TABLE_WISE})
    assert set(plan.buckets) == {"__tw_bucket_d16__", "__tw_bucket_d16_int8__"}

    state, dense_opt = create_train_state(jax.random.key(1), mcfg, tcfg)
    sh_state = shard_train_state(state, plan, mesh)
    step = make_sharded_train_step(mcfg, tcfg, dense_opt, mesh, plan, donate=False)
    rng = np.random.default_rng(0)
    feat = Featurizer(mcfg)
    b = jax.tree.map(jnp.asarray, feat({
        "u": rng.integers(1, 80, 64), "i": rng.integers(1, 50, 64),
        "label": rng.integers(0, 2, 64)}))
    sh_state, out = step(sh_state, _put_batch(b, mesh))
    assert np.isfinite(float(out["loss"]))
    gathered = unshard_train_state(sh_state, plan, mcfg)
    assert gathered.tables["t_u"].shape == (80, 16)
    assert gathered.tables["t_i"].values.shape == (50, 16)
