"""Concat-MLP ranker, LR schedules, parquet path, text features, profiling,
launch helpers."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pandas as pd
import pytest

from two_tower_recommender_model import config as cfg_lib
from two_tower_recommender_model.data import Featurizer, SyntheticClickstream
from two_tower_recommender_model.data.parquet import parquet_batches, write_parquet_dataset
from two_tower_recommender_model.data.text_features import (
    build_product_text_features,
    concat_text_fields,
    cosine_similarity,
    embed_text,
)
from two_tower_recommender_model.models.concat_mlp import init_ranker_params, ranker_forward
from two_tower_recommender_model.models.losses import bce_with_logits
from two_tower_recommender_model.parallel.launch import (
    TrainingMethod,
    devices_for,
    global_batch_slice,
    host_info,
    per_host_loader_slice,
)
from two_tower_recommender_model.train.optimizer import dense_optimizer
from two_tower_recommender_model.utils.profiling import StepTimer, device_memory_stats


@pytest.fixture
def mcfg():
    return cfg_lib.two_tower_model_config(num_users=50, num_items=30, embedding_dim=8)


def _batch(mcfg, rng, n=16):
    f = Featurizer(mcfg)
    return jax.tree.map(jnp.asarray, f({
        "user_id": rng.integers(1, 50, n), "product_id": rng.integers(1, 30, n),
        "label": rng.integers(0, 2, n)}))


# -- concat-MLP ranker (Composer model family) -------------------------------

def test_ranker_forward_shapes_and_trains(mcfg, rng):
    params = init_ranker_params(jax.random.key(0), mcfg, hidden_sizes=(32, 16))
    batch = _batch(mcfg, rng)
    logits = ranker_forward(params, batch, mcfg)
    assert logits.shape == (16,)

    opt = optax.adam(1e-2)
    ost = opt.init(params)

    @jax.jit
    def step(params, ost, batch):
        def lf(p):
            return bce_with_logits(ranker_forward(p, batch, mcfg), batch.labels)
        loss, g = jax.value_and_grad(lf)(params)
        upd, ost2 = opt.update(g, ost, params)
        return optax.apply_updates(params, upd), ost2, loss

    l0 = None
    ds = SyntheticClickstream(50, 30, seed=0)
    f = Featurizer(mcfg)
    for i, cols in enumerate(ds.batches(128, 40)):
        params, ost, loss = step(params, ost, jax.tree.map(jnp.asarray, f(cols)))
        if i == 0:
            l0 = float(loss)
    assert float(loss) < l0


def test_ranker_dropout_deterministic_given_rng(mcfg, rng):
    params = init_ranker_params(jax.random.key(0), mcfg)
    batch = _batch(mcfg, rng)
    k = jax.random.key(42)
    a = ranker_forward(params, batch, mcfg, dropout_rate=0.5, dropout_rng=k)
    b = ranker_forward(params, batch, mcfg, dropout_rate=0.5, dropout_rng=k)
    np.testing.assert_array_equal(a, b)
    c = ranker_forward(params, batch, mcfg, dropout_rate=0.5, dropout_rng=jax.random.key(7))
    assert not np.allclose(a, c)


# -- LR schedules ------------------------------------------------------------

@pytest.mark.parametrize("schedule", ["constant", "linear", "cosine"])
def test_dense_optimizer_schedules(schedule):
    opt = dense_optimizer(1e-3, schedule=schedule, total_steps=100, warmup_steps=10)
    params = {"w": jnp.ones(4)}
    state = opt.init(params)
    g = {"w": jnp.ones(4)}
    for _ in range(3):
        upd, state = opt.update(g, state, params)
        params = optax.apply_updates(params, upd)
    assert np.isfinite(np.asarray(params["w"])).all()


def test_schedule_requires_total_steps():
    with pytest.raises(ValueError, match="total_steps"):
        dense_optimizer(1e-3, schedule="linear")


def test_weight_decay_adamw():
    opt = dense_optimizer(1e-3, weight_decay=0.01)
    assert opt is not None


# -- parquet path ------------------------------------------------------------

def test_parquet_roundtrip_batches(tmp_path, rng):
    cols = {"user_id": rng.integers(1, 100, 1000), "product_id": rng.integers(1, 50, 1000),
            "label": rng.integers(0, 2, 1000)}
    files = write_parquet_dataset(str(tmp_path / "pq"), cols, rows_per_file=300)
    assert len(files) == 4
    got = list(parquet_batches(str(tmp_path / "pq"), 256))
    total = np.concatenate([b["user_id"] for b in got])
    np.testing.assert_array_equal(total, cols["user_id"])
    assert got[0]["user_id"].dtype == np.int64


def test_parquet_preprocess_hook(tmp_path, rng):
    cols = {"user_id": rng.integers(1, 100, 100), "label": rng.integers(0, 2, 100)}
    write_parquet_dataset(str(tmp_path / "pq"), cols)
    got = list(parquet_batches(str(tmp_path / "pq"), 64,
                               preprocess=lambda c: {**c, "user_id": c["user_id"] * 2}))
    np.testing.assert_array_equal(np.concatenate([b["user_id"] for b in got]),
                                  cols["user_id"] * 2)


# -- text features -----------------------------------------------------------

def test_text_embedding_properties():
    texts = ["organic banana produce", "organic strawberry produce", "frozen pizza snacks"]
    emb = embed_text(texts, dim=128)
    assert emb.shape == (3, 128)
    np.testing.assert_allclose(np.linalg.norm(emb, axis=1), 1.0, rtol=1e-5)
    sims = emb @ emb.T
    assert sims[0, 1] > sims[0, 2]  # banana~strawberry > banana~pizza
    # deterministic
    np.testing.assert_array_equal(emb, embed_text(texts, dim=128))


def test_cosine_similarity_and_concat():
    assert concat_text_fields("a", "", "b") == "a b"
    a = np.array([[1.0, 0.0], [0.0, 1.0], [0.0, 0.0]])
    b = np.array([[1.0, 0.0], [1.0, 0.0], [1.0, 0.0]])
    np.testing.assert_allclose(cosine_similarity(a, b), [1.0, 0.0, 0.0])


def test_product_feature_table():
    df = pd.DataFrame({"product_id": [1, 2], "department": ["produce", "snacks"],
                       "aisle": ["fresh", "chips"], "product_name": ["banana", "crisps"]})
    table, emb = build_product_text_features(df, dim=64)
    assert list(table["product_id"]) == [1, 2]
    assert emb.shape == (2, 64)


# -- profiling + launch helpers ---------------------------------------------

def test_step_timer():
    t = StepTimer(window=10)
    for _ in range(5):
        t.update(128)
    s = t.summary()
    assert s["total_examples"] == 640
    assert s["examples_per_sec"] > 0


def test_device_memory_stats():
    stats = device_memory_stats()
    assert len(stats) == 8


def test_launch_helpers():
    assert len(devices_for(TrainingMethod.SINGLE_CHIP)) == 1
    assert len(devices_for(TrainingMethod.SINGLE_HOST)) == 8
    info = host_info()
    assert info["process_count"] == 1 and info["global_devices"] == 8
    assert per_host_loader_slice() == (0, 1)
    assert global_batch_slice(1024) == 1024


def test_ranker_train_step_api(mcfg, rng):
    from two_tower_recommender_model.models.concat_mlp import make_ranker_train_step
    from two_tower_recommender_model.train.pipeline import prefetch_to_device

    step, init_fn = make_ranker_train_step(mcfg, learning_rate=1e-2, dropout_rate=0.2,
                                           donate=False)
    state = init_fn(jax.random.key(0), hidden_sizes=(32, 16))
    ds = SyntheticClickstream(50, 30, seed=0)
    feat = Featurizer(mcfg)
    losses = []
    for batch in prefetch_to_device(ds.batches(128, 30), feat):
        state, out = step(state, batch)
        losses.append(float(out["loss"]))
    assert int(state["step"]) == 30
    assert losses[-1] < losses[0]


def test_profile_trace_writes(tmp_path):
    from two_tower_recommender_model.utils.profiling import profile_trace

    with profile_trace(str(tmp_path / "trace")):
        _ = jnp.ones((64, 64)) @ jnp.ones((64, 64))
    import os
    found = []
    for root, _, files in os.walk(tmp_path / "trace"):
        found.extend(files)
    assert found  # some trace artifact was written


def test_batch_predict_parquet_input(tmp_path, rng):
    from two_tower_recommender_model.models.two_tower import init_params
    from two_tower_recommender_model.serving import Scorer
    from two_tower_recommender_model.serving.batch import batch_predict
    from two_tower_recommender_model.data.shards import ShardedDataset

    mcfg2 = cfg_lib.two_tower_model_config(num_users=50, num_items=30, embedding_dim=8)
    scorer = Scorer(mcfg2, init_params(jax.random.key(0), mcfg2))
    cols = {"user_id": rng.integers(1, 50, 300), "product_id": rng.integers(1, 30, 300),
            "label": rng.integers(0, 2, 300)}
    write_parquet_dataset(str(tmp_path / "pq"), cols, rows_per_file=128)
    idx = batch_predict(scorer, str(tmp_path / "pq"), str(tmp_path / "out"),
                        batch_size=64, input_format="parquet")
    assert idx["total_rows"] == 300
    out = ShardedDataset(str(tmp_path / "out"))
    preds = np.concatenate([out.read_shard(i)["prediction"] for i in range(out.num_shards)])
    assert ((preds >= 0) & (preds <= 1)).all()


def test_loader_column_projection(tmp_path, rng):
    from two_tower_recommender_model.data.loader import StreamLoader
    from two_tower_recommender_model.data.shards import write_dataset

    write_dataset(str(tmp_path / "ds"), {"a": np.arange(100), "b": np.arange(100) * 2,
                                         "label": np.zeros(100)}, rows_per_shard=40)
    loader = StreamLoader(str(tmp_path / "ds"), 25, shuffle=False, columns=["a", "label"])
    batch = next(iter(loader))
    assert set(batch) == {"a", "label"}


def test_precomputed_embeddings_roundtrip(tmp_path):
    """(id -> embedding) files in both ai_query-output shapes (.npz/.parquet)
    round-trip into the dense [num_ids+1, D] table (row 0 = pad), with
    validation on duplicates/sentinel-0/missing columns."""
    from two_tower_recommender_model.data.text_features import (
        load_precomputed_embeddings,
        save_precomputed_embeddings,
    )

    rng = np.random.default_rng(4)
    ids = np.array([3, 1, 7], np.int64)  # unordered, sparse
    emb = rng.normal(size=(3, 16)).astype(np.float32)

    for ext in (".npz", ".parquet"):
        p = str(tmp_path / f"e{ext}")
        save_precomputed_embeddings(p, ids, emb)
        table = load_precomputed_embeddings(p, num_ids=10)
        assert table.shape == (11, 16)
        np.testing.assert_array_equal(table[3], emb[0])
        np.testing.assert_array_equal(table[1], emb[1])
        np.testing.assert_array_equal(table[7], emb[2])
        np.testing.assert_array_equal(table[0], 0.0)  # pad sentinel
        np.testing.assert_array_equal(table[2], 0.0)  # missing id -> zeros
        # num_ids defaults to max(ids)
        assert load_precomputed_embeddings(p).shape == (8, 16)

    p = str(tmp_path / "bad.npz")
    save_precomputed_embeddings(p, np.array([2, 2]), emb[:2])
    with pytest.raises(ValueError, match="duplicate"):
        load_precomputed_embeddings(p)
    save_precomputed_embeddings(p, np.array([0, 1]), emb[:2])
    with pytest.raises(ValueError, match="sentinel"):
        load_precomputed_embeddings(p)
    save_precomputed_embeddings(p, np.array([1, 9]), emb[:2])
    with pytest.raises(ValueError, match="exceeds"):
        load_precomputed_embeddings(p, num_ids=5)
    with pytest.raises(ValueError, match="missing array"):
        load_precomputed_embeddings(p, id_col="nope_id")


def test_xgboost_baseline_harness(tmp_path):
    """SURVEY §2.7's gradient-boosted comparison harness (reference
    workshop/ray-xgboost/02-ray-xgboost-example.py:170-308): trains the
    histogram-boosted baseline on the synthetic table, logs timing+metrics
    through the tracking store, and learns better than chance."""
    import sys, os
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "examples"))
    from xgboost_baseline import train_baseline

    out = train_baseline(rows=5000, cols=10, estimators=15, depth=4,
                         runs_root=str(tmp_path / "runs"))
    assert out["valid_auroc"] > 0.6  # learnable signal, learned
    assert out["fit_seconds"] > 0 and out["rows_per_sec"] > 0
    from two_tower_recommender_model.utils.tracking import latest_run

    run = latest_run(str(tmp_path / "runs"))
    assert run.params["n_estimators"] == 15
    assert any("valid_logloss" in m for m in run.metrics())

    # multiclass arm (the reference's num_labels>2 softprob switch)
    out3 = train_baseline(rows=3000, cols=8, labels=3, estimators=10, depth=3)
    assert out3["valid_error"] < 0.6
