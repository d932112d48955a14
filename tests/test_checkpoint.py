"""Checkpointing: save/restore round-trip, true resume (state + loader),
sharded-layout restore, export/load model, tracking."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from two_tower_recommender_model import config as cfg_lib
from two_tower_recommender_model.data import Featurizer, SyntheticClickstream
from two_tower_recommender_model.data.loader import StreamLoader
from two_tower_recommender_model.data.shards import write_dataset
from two_tower_recommender_model.parallel import (
    make_mesh, plan_sharding, shard_train_state,
)
from two_tower_recommender_model.parallel.planner import ROW_SHARDED
from two_tower_recommender_model.train.step import create_train_state, make_train_step
from two_tower_recommender_model.utils.checkpoint import Checkpointer, export_model, load_model
from two_tower_recommender_model.utils.tracking import ExperimentLogger, latest_run, list_runs


@pytest.fixture
def setup():
    mcfg = cfg_lib.two_tower_model_config(num_users=60, num_items=40, embedding_dim=8,
                                          layer_sizes=(16, 8))
    tcfg = cfg_lib.TrainConfig()
    ds = SyntheticClickstream(60, 40, seed=0)
    feat = Featurizer(mcfg)
    return mcfg, tcfg, ds, feat


def _tree_equal(a, b):
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_save_restore_roundtrip(tmp_path, setup):
    mcfg, tcfg, ds, feat = setup
    state, dense_opt = create_train_state(jax.random.key(0), mcfg, tcfg)
    step_fn = make_train_step(mcfg, tcfg, dense_opt, donate=False)
    for i in range(3):
        state, _ = step_fn(state, jax.tree.map(jnp.asarray, feat(ds.sample(32, start=i))))

    with Checkpointer(str(tmp_path / "ckpt")) as ckpt:
        ckpt.save(3, state, loader_state={"epoch": 0, "batches_yielded": 3,
                                          "seed": 0, "host_index": 0, "num_hosts": 1},
                  extra={"note": "hi"}, wait=True)

    template, _ = create_train_state(jax.random.key(1), mcfg, tcfg)
    with Checkpointer(str(tmp_path / "ckpt")) as ckpt2:
        restored, loader_state, extra = ckpt2.restore(template)
    _tree_equal(restored, state)
    assert loader_state["batches_yielded"] == 3
    assert extra == {"note": "hi"}
    assert int(restored.step) == 3


def test_resume_continues_identically(tmp_path, setup):
    """Train 6 steps straight vs train 3 + checkpoint + restore + 3: identical."""
    mcfg, tcfg, ds, feat = setup
    batches = [jax.tree.map(jnp.asarray, feat(ds.sample(32, start=i))) for i in range(6)]

    state_a, dense_opt = create_train_state(jax.random.key(0), mcfg, tcfg)
    step_fn = make_train_step(mcfg, tcfg, dense_opt, donate=False)
    for b in batches:
        state_a, _ = step_fn(state_a, b)

    state_b, _ = create_train_state(jax.random.key(0), mcfg, tcfg)
    for b in batches[:3]:
        state_b, _ = step_fn(state_b, b)
    with Checkpointer(str(tmp_path / "c")) as ckpt:
        ckpt.save(3, state_b, wait=True)
    template, _ = create_train_state(jax.random.key(2), mcfg, tcfg)
    with Checkpointer(str(tmp_path / "c")) as ckpt:
        state_c, _, _ = ckpt.restore(template)
    for b in batches[3:]:
        state_c, _ = step_fn(state_c, b)
    _tree_equal(state_a, state_c)


def test_restore_sharded_layout(tmp_path, setup):
    mcfg, tcfg, ds, feat = setup
    mesh = make_mesh(8, 1)
    plan = plan_sharding(mcfg, 8, force={"t_user_id": ROW_SHARDED,
                                         "t_product_id": ROW_SHARDED})
    state, _ = create_train_state(jax.random.key(0), mcfg, tcfg)
    sh_state = shard_train_state(state, plan, mesh)
    with Checkpointer(str(tmp_path / "c")) as ckpt:
        ckpt.save(0, sh_state, wait=True)
    template = shard_train_state(state, plan, mesh)
    with Checkpointer(str(tmp_path / "c")) as ckpt:
        restored, _, _ = ckpt.restore(template)
    # restored with the sharded placement
    assert restored.tables["t_user_id"].sharding.spec == sh_state.tables["t_user_id"].sharding.spec
    _tree_equal(restored.tables, sh_state.tables)


def test_loader_state_in_checkpoint_resumes_stream(tmp_path):
    write_dataset(str(tmp_path / "ds"), {"row_id": np.arange(600), "label": np.zeros(600)},
                  rows_per_shard=100)
    loader = StreamLoader(str(tmp_path / "ds"), 50, seed=1)
    it = iter(loader)
    seen = [next(it)["row_id"] for _ in range(4)]
    st = loader.state_dict()
    it.close()

    loader2 = StreamLoader(str(tmp_path / "ds"), 50, seed=1)
    loader2.load_state_dict(st)
    rest = [b["row_id"] for b in loader2]

    fresh = StreamLoader(str(tmp_path / "ds"), 50, seed=1)
    want = [b["row_id"] for b in fresh]
    got = seen + rest
    assert len(got) == len(want)
    for x, y in zip(got, want):
        np.testing.assert_array_equal(x, y)


def test_export_load_model(tmp_path, setup):
    mcfg, tcfg, ds, feat = setup
    state, _ = create_train_state(jax.random.key(0), mcfg, tcfg)
    export_model(str(tmp_path / "m"), mcfg, state)
    cfg2, params = load_model(str(tmp_path / "m"))
    assert cfg2 == mcfg
    np.testing.assert_array_equal(params["tables"]["t_user_id"],
                                  np.asarray(state.tables["t_user_id"]))
    np.testing.assert_array_equal(
        params["query_tower"]["layer_0"]["kernel"],
        np.asarray(state.dense_params["query_tower"]["layer_0"]["kernel"]),
    )


def test_export_normalizes_dtype_config(tmp_path, setup):
    """params.npz is always f32; the exported model_config.json must agree
    (no stale table_dtype='bfloat16' / per-table overrides misleading
    consumers that trust the config)."""
    import dataclasses
    import json as _json

    mcfg, tcfg, ds, feat = setup
    tables = tuple(dataclasses.replace(t, dtype="int8" if i == 0 else None)
                   for i, t in enumerate(mcfg.tables))
    mcfg_bf16 = dataclasses.replace(mcfg, table_dtype="bfloat16", tables=tables)
    state, _ = create_train_state(jax.random.key(0), mcfg_bf16, tcfg)
    export_model(str(tmp_path / "m"), mcfg_bf16, state)
    with open(tmp_path / "m" / "model_config.json") as f:
        saved = _json.load(f)
    assert saved["table_dtype"] is None
    assert all(t["dtype"] is None for t in saved["tables"])
    cfg2, params = load_model(str(tmp_path / "m"))
    for name, arr in params["tables"].items():
        assert arr.dtype == np.float32
        assert cfg2.table_dtype_of(name) == "float32"


def test_max_to_keep(tmp_path, setup):
    mcfg, tcfg, ds, feat = setup
    state, _ = create_train_state(jax.random.key(0), mcfg, tcfg)
    with Checkpointer(str(tmp_path / "c"), max_to_keep=2) as ckpt:
        for s in range(4):
            ckpt.save(s, state, wait=True)
        assert ckpt.latest_step() == 3
        steps = ckpt.manager.all_steps()
    assert sorted(steps) == [2, 3]


def test_tracking_roundtrip(tmp_path):
    lg = ExperimentLogger(str(tmp_path / "runs"))
    lg.log_params({"lr": 1e-3, "layers": (128, 64)})
    lg.log_params({"extra": np.int64(7)})
    lg.log_metrics({"loss": 0.5}, step=1)
    lg.log_metrics({"loss": np.float32(0.25), "auroc": 0.8}, step=2)
    assert lg.params["lr"] == 1e-3 and lg.params["extra"] == 7
    ms = lg.metrics()
    assert len(ms) == 2 and ms[1]["loss"] == 0.25
    assert list_runs(str(tmp_path / "runs")) == [lg.run_id]
    assert latest_run(str(tmp_path / "runs")).run_id == lg.run_id
