"""Multi-device parity for the NORTH-STAR loss (in-batch sampled softmax,
BASELINE.json): the sharded train step with loss="sampled_softmax" must match
the single-device step — the dense [B, B] path and the chunked scan path,
plus the streaming logQ-correction state and a table-wise plan. Complements
tests/test_sharded.py (all-BCE)."""

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
from two_tower_recommender_model.parallel.planner import ROW_SHARDED, TABLE_WISE
from two_tower_recommender_model.parallel.sharded import unshard_train_state
from two_tower_recommender_model.train.step import (
    create_train_state,
    make_train_step,
)


def _put_batch(batch, mesh):
    sh = batch_sharding(mesh)
    return jax.tree.map(lambda x: jax.device_put(x, sh(x)), batch)


def _setup(batch_size=64, n_batches=3, logq=False):
    mcfg = cfg_lib.two_tower_model_config(num_users=100, num_items=60,
                                          embedding_dim=16, layer_sizes=(32, 8))
    tcfg = cfg_lib.TrainConfig(
        sparse_learning_rate=0.05, learning_rate=1e-3,
        loss="sampled_softmax", logq_correction=logq,
        softmax_temperature=0.8,
    )
    ds = SyntheticClickstream(100, 60, seed=5)
    feat = Featurizer(mcfg)
    batches = [jax.tree.map(jnp.asarray, feat(ds.sample(batch_size, start=i)))
               for i in range(n_batches)]
    return mcfg, tcfg, batches


def _assert_states_match(sh_state, ref_state, plan, mcfg, rtol=1e-4, atol=1e-6):
    gathered = unshard_train_state(sh_state, plan, mcfg)
    for name in ref_state.tables:
        np.testing.assert_allclose(
            gathered.tables[name], np.asarray(ref_state.tables[name]),
            rtol=rtol, atol=atol)
    for a, b in zip(jax.tree.leaves(gathered.dense_params),
                    jax.tree.leaves(ref_state.dense_params)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=rtol, atol=atol)


@pytest.mark.parametrize("mesh_shape", [(8, 1), (4, 2)])
def test_sampled_softmax_scan_sharded_matches_single(mesh_shape):
    """Scan-path softmax (GSPMD-partitioned): sharded == single-device —
    loss trajectory, tables, dense params."""
    mcfg, tcfg, batches = _setup()
    mesh = make_mesh(*mesh_shape)
    plan = plan_sharding(mcfg, mesh.devices.size, force={
        "t_user_id": ROW_SHARDED, "t_product_id": ROW_SHARDED})

    state, dense_opt = create_train_state(jax.random.key(0), mcfg, tcfg)
    ref_state = state
    ref_step = make_train_step(mcfg, tcfg, dense_opt, donate=False)
    ref_losses = []
    for b in batches:
        ref_state, out = ref_step(ref_state, b)
        ref_losses.append(float(out["loss"]))

    sh_state = shard_train_state(state, plan, mesh)
    step = make_sharded_train_step(mcfg, tcfg, dense_opt, mesh, plan, donate=False)
    for b, ref_loss in zip(batches, ref_losses):
        sh_state, out = step(sh_state, _put_batch(b, mesh))
        np.testing.assert_allclose(float(out["loss"]), ref_loss, rtol=1e-5)
    _assert_states_match(sh_state, ref_state, plan, mcfg)


def test_sampled_softmax_chunked_scan_sharded_matches_single():
    """Past 4096 rows the loss runs as a scan over [R, B] row chunks; GSPMD
    partitions that scan along the data-sharded batch, and the sharded step
    still matches the single-device step."""
    from two_tower_recommender_model.models.losses import _auto_row_chunk

    mcfg, tcfg, batches = _setup(batch_size=8192, n_batches=2)
    assert _auto_row_chunk(8192) is not None  # guard: the scan path engages
    mesh = make_mesh(8, 1)
    plan = plan_sharding(mcfg, 8, force={
        "t_user_id": ROW_SHARDED, "t_product_id": ROW_SHARDED})

    state, dense_opt = create_train_state(jax.random.key(0), mcfg, tcfg)
    ref_state = state
    ref_step = make_train_step(mcfg, tcfg, dense_opt, donate=False)
    ref_losses = []
    for b in batches:
        ref_state, out = ref_step(ref_state, b)
        ref_losses.append(float(out["loss"]))

    sh_state = shard_train_state(state, plan, mesh)
    step = make_sharded_train_step(mcfg, tcfg, dense_opt, mesh, plan, donate=False)
    for b, ref_loss in zip(batches, ref_losses):
        sh_state, out = step(sh_state, _put_batch(b, mesh))
        np.testing.assert_allclose(float(out["loss"]), ref_loss, rtol=1e-5)
    _assert_states_match(sh_state, ref_state, plan, mcfg, atol=1e-5)


def test_sampled_softmax_logq_counts_sharded(monkeypatch):
    """Streaming logQ correction: the replicated item_counts scatter-add and
    the count-derived logQ term match single-device through the sharded step."""
    mcfg, tcfg, batches = _setup(logq=True)
    mesh = make_mesh(8, 1)
    plan = plan_sharding(mcfg, 8, force={
        "t_user_id": ROW_SHARDED, "t_product_id": ROW_SHARDED})

    state, dense_opt = create_train_state(jax.random.key(0), mcfg, tcfg)
    assert state.item_counts is not None
    ref_state = state
    ref_step = make_train_step(mcfg, tcfg, dense_opt, donate=False)
    ref_losses = []
    for b in batches:
        ref_state, out = ref_step(ref_state, b)
        ref_losses.append(float(out["loss"]))

    sh_state = shard_train_state(state, plan, mesh)
    step = make_sharded_train_step(mcfg, tcfg, dense_opt, mesh, plan, donate=False)
    for b, ref_loss in zip(batches, ref_losses):
        sh_state, out = step(sh_state, _put_batch(b, mesh))
        np.testing.assert_allclose(float(out["loss"]), ref_loss, rtol=1e-5)
    np.testing.assert_allclose(
        np.asarray(sh_state.item_counts), np.asarray(ref_state.item_counts))
    _assert_states_match(sh_state, ref_state, plan, mcfg)


def test_sampled_softmax_table_wise_plan():
    """The north-star loss over a TABLE_WISE plan (bucketed small tables):
    loss + final tables match single-device."""
    mcfg, tcfg, batches = _setup()
    mesh = make_mesh(8, 1)
    plan = plan_sharding(mcfg, 8, force={
        "t_user_id": TABLE_WISE, "t_product_id": TABLE_WISE})

    state, dense_opt = create_train_state(jax.random.key(0), mcfg, tcfg)
    ref_state = state
    ref_step = make_train_step(mcfg, tcfg, dense_opt, donate=False)
    for b in batches:
        ref_state, ref_out = ref_step(ref_state, b)

    sh_state = shard_train_state(state, plan, mesh)
    step = make_sharded_train_step(mcfg, tcfg, dense_opt, mesh, plan, donate=False)
    for b in batches:
        sh_state, out = step(sh_state, _put_batch(b, mesh))
    np.testing.assert_allclose(float(out["loss"]), float(ref_out["loss"]),
                               rtol=1e-5)
    _assert_states_match(sh_state, ref_state, plan, mcfg)
