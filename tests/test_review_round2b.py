"""Regression tests for the round-2 self-review findings (ASHA NaN handling,
pack_label contract plumbing, registry atomicity, shared Adagrad epilogue)."""

import json
import os
import subprocess
import sys

import zlib

import numpy as np
import pytest

from two_tower_recommender_model.tuning.adaptive import (
    asha_best,
    asha_total_resource,
    run_asha,
)
from two_tower_recommender_model.tuning.sweep import Uniform


def test_asha_nan_trial_is_stopped_not_promoted():
    """A diverging (NaN-metric) trial must stop at its first rung instead of
    being promoted through every rung (NaN compares False against the rung
    threshold) and must not poison asha_best."""
    space = {"x": Uniform(0.0, 1.0)}

    def make_trial(cfg, grow, state):
        state = (state or 0) + grow
        val = float("nan") if cfg["x"] > 0.5 else cfg["x"]
        return state, {"val_loss": val}

    trials = run_asha(make_trial, space, num_trials=12, min_resource=1,
                      max_resource=8, eta=2, seed=3)
    nan_trials = [t for t in trials if t.error and "non-finite" in t.error]
    assert nan_trials, "expected some diverging trials with x > 0.5"
    for t in nan_trials:
        assert t.resource == 1, f"NaN trial ran {t.resource} units (must stop at rung 0)"
        assert t.stopped
    best = asha_best(trials)
    assert best.metric_value is not None and np.isfinite(best.metric_value)
    assert best.config["x"] <= 0.5


def test_asha_missing_metric_marks_error_not_crash():
    space = {"x": Uniform(0.0, 1.0)}

    def make_trial(cfg, grow, state):
        if cfg["x"] > 0.5:
            return state, {"other_metric": 1.0}  # metric key missing
        return state, {"val_loss": cfg["x"]}

    trials = run_asha(make_trial, space, num_trials=10, min_resource=1,
                      max_resource=4, eta=2, seed=0)
    assert any(t.error and "missing" in t.error for t in trials)
    assert asha_best(trials).config["x"] <= 0.5


def test_asha_best_compares_only_at_top_rung():
    """A trial stopped early with a (spuriously good) low-rung metric must not
    beat fully-trained survivors — values from different rungs are not
    comparable."""
    space = {"x": Uniform(0.0, 1.0)}

    def make_trial(cfg, grow, state):
        state = (state or 0) + grow
        # metric IMPROVES with budget; the early-stopped trial's rung-0 value
        # is lower than any fully-trained value
        if cfg["x"] > 0.5:
            return state, {"val_loss": -1.0 + state}  # rung0: 0.0 then stopped
        return state, {"val_loss": 1.0 / state}  # improves toward 0 with budget

    trials = run_asha(make_trial, space, num_trials=12, min_resource=1,
                      max_resource=8, eta=2, seed=1)
    best = asha_best(trials)
    top_rung = max(t.rung for t in trials if t.metric_value is not None)
    assert best.rung == top_rung


def test_compact_featurizer_rejects_pack_label_mismatch():
    from two_tower_recommender_model import config as cfg_lib
    from two_tower_recommender_model.data.compact import (
        CompactFeaturizer,
        CompactScheme,
    )
    from two_tower_recommender_model.data.device_featurizer import PackedFeaturizer

    mcfg = cfg_lib.two_tower_model_config(100, 50, embedding_dim=16, layer_sizes=(16, 8))
    inner = PackedFeaturizer(mcfg, pack_label=True)
    scheme = CompactScheme.from_model(mcfg, pack_label=False)
    with pytest.raises(ValueError, match="pack_label"):
        CompactFeaturizer(inner, scheme)


def test_registry_never_reuses_version_of_crashed_attempt(tmp_path):
    """An orphan vN directory (crashed register that claimed the number but
    never indexed it) must not be reused/overwritten by the next register."""
    import jax

    from two_tower_recommender_model import config as cfg_lib
    from two_tower_recommender_model.train.step import create_train_state
    from two_tower_recommender_model.utils.registry import ModelRegistry

    mcfg = cfg_lib.two_tower_model_config(20, 10, embedding_dim=8, layer_sizes=(8, 4))
    tcfg = cfg_lib.TrainConfig()
    state, _ = create_train_state(jax.random.key(0), mcfg, tcfg)

    reg = ModelRegistry(str(tmp_path))
    v1 = reg.register("m", mcfg, state)
    assert v1 == 1
    # simulate a crashed attempt that claimed v2 but never wrote the index
    os.mkdir(os.path.join(str(tmp_path), "m", "v2"))
    marker = os.path.join(str(tmp_path), "m", "v2", "orphan.marker")
    open(marker, "w").write("partial artifact from a crashed register")
    v3 = reg.register("m", mcfg, state)
    assert v3 == 3, "register must skip the claimed-but-unindexed version"
    assert os.path.exists(marker), "orphan version dir must not be overwritten"
    assert [e["version"] for e in reg.versions("m")] == [1, 3]
    # the indexed versions load fine
    reg.load("m", 3)


def test_parallel_sweep_survives_worker_death(tmp_path):
    """A worker killed mid-trial (BrokenProcessPool) must not discard the
    completed trials — the sweep returns partial results with the dead trial
    marked errored."""
    from two_tower_recommender_model.tuning.adaptive import run_adaptive_sweep
    from two_tower_recommender_model.tuning.sweep import Choice

    space = {"kill": Choice((0, 0, 0, 1))}  # some trials hard-kill the worker
    res = run_adaptive_sweep(_maybe_die_trial, space, num_trials=8,
                             metric="val_loss", seed=5, max_workers=2,
                             n_startup=100)  # pure random: keeps kill sampling on
    assert len(res.trials) >= 1
    ok = [t for t in res.trials if t.error is None]
    died = [t for t in res.trials if t.error and "died" in t.error]
    assert ok, "completed trials must be preserved"
    assert died, "the killed worker's trial must be recorded as errored"


def _maybe_die_trial(cfg):
    if cfg["kill"]:
        os._exit(9)  # simulate OOM-kill / segfault (not catchable in-process)
    return {"val_loss": 0.5}


def test_shared_adagrad_epilogue_paths_agree():
    """dense_rowwise_adagrad (scatter-add + masked epilogue) and
    sparse_rowwise_adagrad (sorted segments) compute the same row-wise
    Adagrad on identical gradients, sorted hint or not."""
    import jax.numpy as jnp

    from two_tower_recommender_model.train.optimizer import (
        dense_rowwise_adagrad,
        sparse_rowwise_adagrad,
    )

    rng = np.random.default_rng(0)
    n, d, m = 64, 128, 256
    table = jnp.asarray(rng.normal(size=(n, d)).astype(np.float32))
    acc = jnp.asarray(rng.random(n).astype(np.float32))
    ids = np.sort(rng.integers(0, n, m)).astype(np.int32)
    grads = rng.normal(size=(m, d)).astype(np.float32)

    t1, a1 = dense_rowwise_adagrad(table, acc, jnp.asarray(ids), jnp.asarray(grads),
                                   0.1, 1e-6, ids_sorted=True)
    t2, a2 = sparse_rowwise_adagrad(table, acc, jnp.asarray(ids),
                                    jnp.asarray(grads), 0.1, 1e-6)
    np.testing.assert_allclose(np.asarray(t1), np.asarray(t2), rtol=2e-6, atol=2e-6)
    np.testing.assert_allclose(np.asarray(a1), np.asarray(a2), rtol=2e-6, atol=2e-6)


def test_prepacked_unpacked_labels_flow_through_cli(tmp_path):
    """A prepacked dataset written with pack_label=False (labels in their own
    column) must train with REAL labels through scripts/train.py (finite
    AUROC) — the CLI must honor the dataset's recorded label encoding."""
    from two_tower_recommender_model import config as cfg_lib
    from two_tower_recommender_model.data import SyntheticClickstream
    from two_tower_recommender_model.data.prepacked import pack_dataset

    mcfg = cfg_lib.two_tower_model_config(80, 40, embedding_dim=8, layer_sizes=(16, 8))
    ds = SyntheticClickstream(80, 40, seed=3, noise=0.05, latent_dim=2)
    root = tmp_path / "data"
    for split, rows in (("train", 2048), ("val", 512), ("test", 512)):
        pack_dataset(str(root / split), mcfg, ds.sample(rows, start=zlib.crc32(split.encode()) % 97),
                     pack_label=False, rows_per_shard=1024)

    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = env.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
    r = subprocess.run([
        sys.executable, "scripts/train.py",
        "--data-dir", str(root), "--num-users", "80", "--num-items", "40",
        "--epochs", "1", "--batch-size", "128",
        "--embedding-dim", "8", "--layer-sizes", "16", "8",
        "--no-shard",
        "--runs-root", str(tmp_path / "runs"),
    ], capture_output=True, text=True, env=env, timeout=420)
    assert r.returncode == 0, (r.stdout[-2000:], r.stderr[-3000:])
    line = [ln for ln in r.stdout.splitlines() if "test_auroc" in ln][-1]
    metrics = eval(line[line.index("{"):])  # the printed results dict
    assert np.isfinite(metrics["test_auroc"]), metrics
    # all-zero labels (the pre-fix failure) make BCE collapse toward 0 loss on
    # negatives and AUROC undefined; a real mix keeps loss near ln 2 initially
    assert 0.2 < metrics["train_loss"] < 1.5, metrics


def test_odd_large_batch_softmax_never_goes_dense():
    """An odd batch size > 4096 with no power-of-2 divisor must pad+mask into
    the blockwise path (the dense [B, B] matrix would OOM at scale) and match
    a direct dense computation on the small version of the same inputs."""
    import jax.numpy as jnp

    from two_tower_recommender_model.models.losses import (
        _chunked_sampled_softmax,
        in_batch_sampled_softmax,
    )

    rng = np.random.default_rng(0)
    b, d = 4099, 8  # prime > 4096
    q = jnp.asarray(rng.normal(size=(b, d)).astype(np.float32))
    c = jnp.asarray(rng.normal(size=(b, d)).astype(np.float32))
    labels = jnp.asarray(rng.integers(0, 2, b).astype(np.int32))
    got = float(in_batch_sampled_softmax(q, c, labels))
    # oracle: the padded+masked chunked path at r=1 equals per-row dense math
    exp = float(_chunked_sampled_softmax(
        jnp.pad(q, ((0, 509), (0, 0))), jnp.pad(c, ((0, 509), (0, 0))),
        jnp.pad(labels, (0, 509)), None, None, 1.0, 512, n_valid=b))
    np.testing.assert_allclose(got, exp, rtol=1e-6)
    assert np.isfinite(got)


def test_split_positives_resolves_packed_slots_by_name(tmp_path):
    """A prepacked split whose ITEM feature comes first (slot 0) must still
    group positives by the right columns — slot indices come from the
    recorded layout, not an assumed [user, item] order."""
    from two_tower_recommender_model import config as cfg_lib
    from two_tower_recommender_model.data.prepacked import pack_dataset
    from two_tower_recommender_model.evaluation.retrieval import split_positives

    mc = cfg_lib.ModelConfig(
        tables=(cfg_lib.TableConfig("t_i", 50, 8, ("product_id",)),
                cfg_lib.TableConfig("t_u", 90, 8, ("user_id",))),
        features=(cfg_lib.FeatureConfig("product_id", "t_i"),   # slot 0!
                  cfg_lib.FeatureConfig("user_id", "t_u")),     # slot 1
        query_tower=cfg_lib.TowerConfig(("user_id",), (8, 4)),
        candidate_tower=cfg_lib.TowerConfig(("product_id",), (8, 4)),
    )
    mc.validate()
    rng = np.random.default_rng(0)
    cols = {
        "user_id": rng.integers(1, 90, 256).astype(np.int64),
        "product_id": rng.integers(1, 50, 256).astype(np.int64),
        "label": rng.integers(0, 2, 256).astype(np.int64),
    }
    d = str(tmp_path / "split")
    pack_dataset(d, mc, cols, rows_per_shard=128)
    got = split_positives(d)
    exp: dict[int, list] = {}
    for u, p, l in zip(cols["user_id"], cols["product_id"], cols["label"]):
        if l == 1:
            exp.setdefault(int(u), []).append(int(p))
    assert got == exp


def test_cli_no_packed_rejects_prepacked_dataset(tmp_path):
    from two_tower_recommender_model import config as cfg_lib
    from two_tower_recommender_model.data import SyntheticClickstream
    from two_tower_recommender_model.data.prepacked import pack_dataset

    mcfg = cfg_lib.two_tower_model_config(80, 40, embedding_dim=8, layer_sizes=(16, 8))
    ds = SyntheticClickstream(80, 40, seed=3)
    root = tmp_path / "data"
    for split in ("train", "val", "test"):
        pack_dataset(str(root / split), mcfg, ds.sample(512), rows_per_shard=256)
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run([
        sys.executable, "scripts/train.py", "--data-dir", str(root),
        "--num-users", "80", "--num-items", "40", "--epochs", "1",
        "--batch-size", "64", "--no-packed", "--no-shard",
    ], capture_output=True, text=True, env=env, timeout=240)
    assert r.returncode != 0
    assert "PRE-PACKED" in (r.stdout + r.stderr)
