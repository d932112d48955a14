"""Sorted-batch fast paths in the SHARDED (multi-chip) train step.

The single-device sorted-scatter hint (DESIGN §6c) extends to row-sharded
tables because a globally sorted id stream stays non-decreasing after
subtracting each shard's base row. These
tests pin the contract: sharded training on host-sorted batches must
reproduce the single-device step's numerics on every mesh shape.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from two_tower_recommender_model import config as cfg_lib
from two_tower_recommender_model.data import Featurizer, SyntheticClickstream
from two_tower_recommender_model.parallel import (
    batch_sharding,
    make_mesh,
    make_sharded_train_step,
    plan_sharding,
    shard_train_state,
)
from two_tower_recommender_model.parallel.planner import REPLICATED, ROW_SHARDED
from two_tower_recommender_model.parallel.sharded import unshard_train_state
from two_tower_recommender_model.train.step import create_train_state, make_train_step


def _sort_batch(batch, n_users: int):
    """Reorder rows by the user feature's hashed id, missing last — the Batch-
    level equivalent of `sort_packed_batch` (the flat-id key the update sees)."""
    feat = batch.features["user_id"]
    ids = np.asarray(feat.ids[:, 0])
    mask = np.asarray(feat.mask[:, 0])
    key = np.where(mask > 0, ids, n_users)
    order = np.argsort(key, kind="stable")
    return jax.tree.map(lambda x: x[order], batch)


def _put_batch(batch, mesh):
    sh = batch_sharding(mesh)
    return jax.tree.map(lambda x: jax.device_put(x, sh(x)), batch)


def _make_setup(embedding_dim: int, batch_size: int, n_batches: int = 3):
    mcfg = cfg_lib.two_tower_model_config(
        num_users=100, num_items=60, embedding_dim=embedding_dim,
        layer_sizes=(32, 8),
    )
    ds = SyntheticClickstream(100, 60, seed=7)
    feat = Featurizer(mcfg)
    batches = [
        _sort_batch(jax.tree.map(np.asarray, feat(ds.sample(batch_size, start=i))), 100)
        for i in range(n_batches)
    ]
    return mcfg, batches


def _run_pair(mcfg, tcfg, batches, mesh_shape, force):
    """(single-device final state, sharded-gathered final state) on the same
    sorted batches."""
    mesh = make_mesh(*mesh_shape)
    plan = plan_sharding(mcfg, mesh.devices.size, force=force)
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
    return ref_state, unshard_train_state(sh_state, plan, mcfg)


def _assert_states_close(ref_state, gathered, rtol=1e-4, atol=1e-6):
    for name in ref_state.tables:
        np.testing.assert_allclose(
            gathered.tables[name], np.asarray(ref_state.tables[name]),
            rtol=rtol, atol=atol,
        )
        np.testing.assert_allclose(
            gathered.adagrad_acc[name], np.asarray(ref_state.adagrad_acc[name]),
            rtol=rtol, atol=atol,
        )
    for a, b in zip(
        jax.tree.leaves(gathered.dense_params), jax.tree.leaves(ref_state.dense_params)
    ):
        np.testing.assert_allclose(a, np.asarray(b), rtol=rtol, atol=atol)


@pytest.mark.parametrize("mesh_shape", [(8, 1), (4, 2)])
def test_sorted_hint_sharded_matches_single_device(mesh_shape):
    """sorted_feature (indices_are_sorted scatter hint + clamp trick for
    below-shard ids) on a row-sharded table == single-device numerics."""
    mcfg, batches = _make_setup(embedding_dim=16, batch_size=64)
    tcfg = cfg_lib.TrainConfig(
        sparse_learning_rate=0.05, learning_rate=1e-3, sorted_feature="user_id"
    )
    ref, got = _run_pair(
        mcfg, tcfg, batches, mesh_shape,
        force={"t_user_id": ROW_SHARDED, "t_product_id": ROW_SHARDED},
    )
    _assert_states_close(ref, got)


def test_sorted_replicated_matches_single_device():
    """A REPLICATED sorted table takes the deterministic every-device sorted
    update (globally sorted flat ids need no shard-base shift)."""
    mcfg, batches = _make_setup(embedding_dim=16, batch_size=64)
    tcfg = cfg_lib.TrainConfig(
        sparse_learning_rate=0.05, learning_rate=1e-3, sorted_feature="user_id"
    )
    ref, got = _run_pair(
        mcfg, tcfg, batches, (8, 1),
        force={"t_user_id": REPLICATED, "t_product_id": ROW_SHARDED},
    )
    _assert_states_close(ref, got)


def test_sorted_feature_rejects_table_wise():
    """The sorted fast paths cover row-sharded and replicated tables only."""
    from two_tower_recommender_model.parallel.planner import TABLE_WISE

    mcfg, _ = _make_setup(embedding_dim=16, batch_size=64, n_batches=0)
    tcfg = cfg_lib.TrainConfig(sorted_feature="user_id")
    mesh = make_mesh(8, 1)
    plan = plan_sharding(mcfg, 8, force={
        "t_user_id": TABLE_WISE, "t_product_id": REPLICATED})
    _, dense_opt = create_train_state(jax.random.key(0), mcfg, tcfg)
    with pytest.raises(ValueError, match="row_sharded or"):
        make_sharded_train_step(mcfg, tcfg, dense_opt, mesh, plan, donate=False)


@pytest.mark.parametrize("delta", [False, True])
def test_sharded_compact_multi_step_matches_single_device(delta):
    """The sharded compact-wire macro path (GSPMD-partitioned in-jit decode,
    incl. the delta slot's cross-shard cumsum) == single-device compact
    training."""
    import jax.numpy as jnp

    from two_tower_recommender_model.data.compact import (
        CompactFeaturizer, CompactScheme, batch_from_compact)
    from two_tower_recommender_model.data.device_featurizer import PackedFeaturizer
    from two_tower_recommender_model.parallel import (
        compact_macro_shardings, make_sharded_compact_multi_step)
    from two_tower_recommender_model.train.step import make_multi_step, stack_batches

    mcfg = cfg_lib.two_tower_model_config(
        num_users=500, num_items=200, embedding_dim=16, layer_sizes=(32, 8))
    tcfg = cfg_lib.TrainConfig(
        sparse_learning_rate=0.05, learning_rate=1e-3,
        sorted_feature="user_id" if delta else None)
    ds = SyntheticClickstream(500, 200, seed=3)
    pf = PackedFeaturizer(mcfg, pack_label=True,
                          sort_feature="user_id" if delta else None)
    scheme = CompactScheme.from_model(
        mcfg, pack_label=True, delta_feature="user_id" if delta else None)
    cf = CompactFeaturizer(pf, scheme)
    macro = stack_batches([cf(ds.sample(128, start=i)) for i in range(3)])

    state, dense_opt = create_train_state(jax.random.key(0), mcfg, tcfg)

    from two_tower_recommender_model.train.step import make_train_step as _mts
    core = _mts(mcfg, tcfg, dense_opt, donate=False, jit=False)
    ref_multi = make_multi_step(
        lambda s, cb: core(s, batch_from_compact(cb, mcfg, scheme)), donate=False)
    ref_state, ref_out = ref_multi(state, jax.tree.map(jnp.asarray, macro))

    mesh = make_mesh(8, 1)
    plan = plan_sharding(mcfg, 8, force={
        "t_user_id": ROW_SHARDED, "t_product_id": ROW_SHARDED})
    sh_state = shard_train_state(state, plan, mesh)
    multi = make_sharded_compact_multi_step(
        mcfg, tcfg, dense_opt, mesh, plan, scheme, donate=False)
    sh = compact_macro_shardings(mesh, macro)
    mb = jax.tree.map(lambda x, s: jax.device_put(x, s), macro, sh)
    sh_state, out = multi(sh_state, mb)

    np.testing.assert_allclose(np.asarray(out["loss"]), np.asarray(ref_out["loss"]),
                               rtol=1e-5)
    # atol 5e-6: GSPMD partitions the decode + update reductions, so f32
    # summation order differs slightly from the single-device program
    _assert_states_close(ref_state, unshard_train_state(sh_state, plan, mcfg),
                         atol=5e-6)


@pytest.mark.parametrize("mesh_shape", [(8, 1), (4, 2)])
def test_unsorted_row_and_replicated_sharded_matches_single_device(mesh_shape):
    """UNSORTED batches: the row-sharded table takes the sorted-segment
    update per shard and the replicated one the every-device update;
    numerics match the single-device step."""
    mcfg = cfg_lib.two_tower_model_config(
        num_users=100, num_items=60, embedding_dim=32, layer_sizes=(32, 8),
    )
    ds = SyntheticClickstream(100, 60, seed=7)
    feat = Featurizer(mcfg)
    batches = [
        jax.tree.map(np.asarray, feat(ds.sample(128, start=i))) for i in range(3)
    ]  # NOT sorted
    tcfg = cfg_lib.TrainConfig(sparse_learning_rate=0.05, learning_rate=1e-3)
    ref, got = _run_pair(
        mcfg, tcfg, batches, mesh_shape,
        force={"t_user_id": ROW_SHARDED, "t_product_id": REPLICATED},
    )
    _assert_states_close(ref, got, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("mesh_shape", [(8, 1), (4, 2)])
def test_int8_sorted_sharded_matches_single_device(mesh_shape):
    """int8 tables + sorted_feature: the sorted table's shards take the
    quantized segment update on their monotone local ids. Contract vs the
    single-device step is dequantized closeness (per-shard aggregation order
    can flip one int8 rounding step)."""
    import dataclasses

    from two_tower_recommender_model.ops.quantized import dequantize_table

    mcfg, batches = _make_setup(embedding_dim=32, batch_size=128)
    mcfg = dataclasses.replace(mcfg, table_dtype="int8")
    tcfg = cfg_lib.TrainConfig(
        sparse_learning_rate=0.05, learning_rate=1e-3, sorted_feature="user_id",
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

    np.testing.assert_allclose(float(out["loss"]), float(ref_out["loss"]), rtol=1e-3)
    gathered = unshard_train_state(sh_state, plan, mcfg)
    for name in ref_state.tables:
        assert gathered.tables[name].values.dtype == np.int8
        da = np.asarray(dequantize_table(ref_state.tables[name]))
        db = np.asarray(dequantize_table(gathered.tables[name]))
        np.testing.assert_allclose(db, da, atol=5e-3)
        np.testing.assert_allclose(
            gathered.adagrad_acc[name], np.asarray(ref_state.adagrad_acc[name]),
            rtol=1e-3, atol=1e-5,
        )
