"""CLI scripts end-to-end: prepare (CSV -> shards) then train (sharded path,
checkpoints, export) as a subprocess — the full user journey."""

import json
import os
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest


@pytest.fixture(scope="module")
def csv_dir(tmp_path_factory):
    """Tiny instacart-shaped CSVs."""
    rng = np.random.default_rng(0)
    d = tmp_path_factory.mktemp("csv")
    n_orders, n_users, n_products = 400, 40, 60
    orders = pd.DataFrame({
        "order_id": np.arange(n_orders),
        "user_id": rng.integers(1, n_users + 1, n_orders),
        "eval_set": "prior",
        "order_number": rng.integers(1, 10, n_orders),
        "order_dow": rng.integers(0, 7, n_orders),
        "order_hour_of_day": rng.integers(0, 24, n_orders),
        "days_since_prior_order": rng.random(n_orders) * 30,
    })
    products = pd.DataFrame({
        "product_id": np.arange(1, n_products + 1),
        "product_name": [f"product {i}" for i in range(1, n_products + 1)],
        "aisle_id": rng.integers(1, 10, n_products),
        "department_id": rng.integers(1, 5, n_products),
    })
    rows = []
    for oid in range(n_orders):
        for pid in rng.choice(n_products, size=rng.integers(1, 6), replace=False) + 1:
            rows.append((oid, pid, 1, 0))
    order_products = pd.DataFrame(rows, columns=[
        "order_id", "product_id", "add_to_cart_order", "reordered"])
    orders.to_csv(d / "orders.csv", index=False)
    products.to_csv(d / "products.csv", index=False)
    order_products.to_csv(d / "order_products__prior.csv", index=False)
    return str(d)


def _run(cmd, **env_extra):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = env.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
    env.update(env_extra)
    return subprocess.run(cmd, capture_output=True, text=True, env=env, timeout=420)


def test_prepare_then_train_then_export(csv_dir, tmp_path):
    out = str(tmp_path / "prepared")
    r = _run([sys.executable, "scripts/prepare_instacart.py",
              "--csv-dir", csv_dir, "--out", out])
    assert r.returncode == 0, r.stderr[-2000:]
    meta = json.load(open(os.path.join(out, "meta.json")))
    assert meta["num_users"] > 0 and meta["num_items"] > 0
    for split in ("train", "val", "test"):
        assert os.path.exists(os.path.join(out, split, "index.json"))

    export_dir = str(tmp_path / "model")
    ckpt_dir = str(tmp_path / "ckpt")
    r = _run([
        sys.executable, "scripts/train.py",
        "--data-dir", out,
        "--num-users", str(meta["num_users"]),
        "--num-items", str(meta["num_items"]),
        "--epochs", "1", "--batch-size", "64",
        "--embedding-dim", "8", "--layer-sizes", "16", "8",
        "--limit-train-batches", "10", "--limit-val-batches", "3",
        "--limit-test-batches", "3",
        "--runs-root", str(tmp_path / "runs"),
        "--checkpoint-dir", ckpt_dir,
        "--export-dir", export_dir,
    ])
    assert r.returncode == 0, (r.stdout[-2000:], r.stderr[-3000:])
    assert "test_auroc" in r.stdout
    assert os.path.exists(os.path.join(export_dir, "params.npz"))
    assert os.listdir(ckpt_dir)

    # exported model loads and scores
    from two_tower_recommender_model.serving import load_scorer
    scorer = load_scorer(export_dir)
    p = scorer.predict({"user_id": [1, 2], "product_id": [3, 4]})
    assert p.shape == (2,)


def test_fetch_script_offline_generates_replica(tmp_path):
    """Round 2: without the kaggle CLI the fetch script generates the
    schema-faithful replica instead of failing (small sizes here)."""
    d = str(tmp_path / "d")
    r = _run([sys.executable, "scripts/fetch_instacart.py", "--out", d,
              "--replica-users", "60", "--replica-products", "40"],
             PATH="/usr/bin:/bin")  # ensure no kaggle CLI
    assert r.returncode == 0, r.stderr[-500:]
    assert "replica" in (r.stdout + r.stderr).lower()
    for f in ("orders.csv", "products.csv", "order_products__prior.csv"):
        assert os.path.exists(os.path.join(d, f))


def test_cli_resume_continues_from_epoch(csv_dir, tmp_path):
    """--resume must continue from the checkpointed epoch, not replay from 0
    (review finding: train_factory's set_epoch clobbered the restored
    position)."""
    out = str(tmp_path / "prepared")
    r = _run([sys.executable, "scripts/prepare_instacart.py",
              "--csv-dir", csv_dir, "--out", out])
    assert r.returncode == 0, r.stderr[-1000:]
    meta = json.load(open(os.path.join(out, "meta.json")))
    ckpt = str(tmp_path / "ckpt")
    base = [sys.executable, "scripts/train.py", "--data-dir", out,
            "--num-users", str(meta["num_users"]), "--num-items", str(meta["num_items"]),
            "--batch-size", "64", "--embedding-dim", "8", "--layer-sizes", "16", "8",
            "--limit-train-batches", "5", "--limit-val-batches", "2",
            "--limit-test-batches", "2", "--runs-root", str(tmp_path / "runs"),
            "--checkpoint-dir", ckpt, "--no-shard"]
    r = _run(base + ["--epochs", "1"])
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    r = _run(base + ["--epochs", "2", "--resume"])
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    assert "resumed from step 5, epoch 1" in r.stdout, r.stdout[:400]
    # only ONE additional epoch ran: final step counter is 10, not 15
    from two_tower_recommender_model.utils.checkpoint import Checkpointer
    from two_tower_recommender_model import config as cfg_lib
    from two_tower_recommender_model.train.step import create_train_state
    import jax
    mcfg = cfg_lib.two_tower_model_config(meta["num_users"], meta["num_items"],
                                          embedding_dim=8, layer_sizes=(16, 8))
    template, _ = create_train_state(jax.random.key(0), mcfg, cfg_lib.TrainConfig())
    with Checkpointer(ckpt) as c:
        restored, _, extra = c.restore(template)
    assert int(restored.step) == 10
    assert extra["completed_epoch"] == 1


def test_cli_sharded_sorted_feature(csv_dir, tmp_path):
    """--sorted-feature on the multi-device (sharded, single-process) packed
    path: the per-shard sorted fast paths (round-2 extension) train through
    the CLI and produce finite metrics."""
    out = str(tmp_path / "prepared")
    r = _run([sys.executable, "scripts/prepare_instacart.py",
              "--csv-dir", csv_dir, "--out", out])
    assert r.returncode == 0, r.stderr[-2000:]
    meta = json.load(open(os.path.join(out, "meta.json")))

    r = _run([
        sys.executable, "scripts/train.py",
        "--data-dir", out,
        "--num-users", str(meta["num_users"]),
        "--num-items", str(meta["num_items"]),
        "--epochs", "1", "--batch-size", "64",
        "--embedding-dim", "8", "--layer-sizes", "16", "8",
        "--limit-train-batches", "10", "--limit-val-batches", "3",
        "--limit-test-batches", "3",
        "--runs-root", str(tmp_path / "runs"),
        "--sorted-feature", "user_id",
    ])
    assert r.returncode == 0, (r.stdout[-2000:], r.stderr[-3000:])
    assert "test_auroc" in r.stdout
    # the sharded plan must have run (8 simulated devices, no --no-shard)
    assert "row_sharded" in r.stdout or "replicated" in r.stdout


def test_cli_sorted_feature_rejected_off_packed(csv_dir, tmp_path):
    out = str(tmp_path / "prepared")
    r = _run([sys.executable, "scripts/prepare_instacart.py",
              "--csv-dir", csv_dir, "--out", out])
    assert r.returncode == 0, r.stderr[-2000:]
    meta = json.load(open(os.path.join(out, "meta.json")))
    r = _run([
        sys.executable, "scripts/train.py",
        "--data-dir", out,
        "--num-users", str(meta["num_users"]),
        "--num-items", str(meta["num_items"]),
        "--epochs", "1", "--batch-size", "64",
        "--no-packed", "--sorted-feature", "user_id",
    ])
    assert r.returncode != 0
    assert "packed path" in (r.stdout + r.stderr)


def test_cli_sorted_feature_auto_default(csv_dir, tmp_path):
    """The CLI defaults to --sorted-feature auto: picks the largest eligible
    table's feature and logs it; 'off' disables."""
    out = str(tmp_path / "prepared")
    r = _run([sys.executable, "scripts/prepare_instacart.py",
              "--csv-dir", csv_dir, "--out", out])
    assert r.returncode == 0, r.stderr[-2000:]
    meta = json.load(open(os.path.join(out, "meta.json")))
    base = [
        sys.executable, "scripts/train.py",
        "--data-dir", out,
        "--num-users", str(meta["num_users"]),
        "--num-items", str(meta["num_items"]),
        "--epochs", "1", "--batch-size", "64",
        "--embedding-dim", "8", "--layer-sizes", "16", "8",
        "--limit-train-batches", "6", "--limit-val-batches", "2",
        "--limit-test-batches", "2",
        "--runs-root", str(tmp_path / "runs"),
    ]
    r = _run(base)
    assert r.returncode == 0, (r.stdout[-2000:], r.stderr[-3000:])
    # the fixture has 60 products > 40 users: the LARGER table wins
    assert "sorted-feature auto: product_id" in (r.stdout + r.stderr)

    r = _run(base + ["--sorted-feature", "off", "--runs-root", str(tmp_path / "runs2")])
    assert r.returncode == 0, (r.stdout[-2000:], r.stderr[-3000:])
    assert "sorted-feature auto" not in (r.stdout + r.stderr)


def test_cli_block_kernel_auto_follows_compute_dtype(csv_dir, tmp_path):
    """Table traffic always takes XLA's gather/scatter routes: bf16 and f32
    tower compute both train through the CLI's default packed path, and the
    former `--block-sorted-kernel` switch is refused."""
    out = str(tmp_path / "prepared_bk")
    r = _run([sys.executable, "scripts/prepare_instacart.py",
              "--csv-dir", csv_dir, "--out", out])
    assert r.returncode == 0, r.stderr[-2000:]
    meta = json.load(open(os.path.join(out, "meta.json")))
    base = [
        sys.executable, "scripts/train.py",
        "--data-dir", out,
        "--num-users", str(meta["num_users"]),
        "--num-items", str(meta["num_items"]),
        "--epochs", "1", "--batch-size", "128",
        "--embedding-dim", "128", "--layer-sizes", "16", "8",
        "--limit-train-batches", "4", "--limit-val-batches", "2",
        "--limit-test-batches", "2",
    ]
    r = _run(base + ["--compute-dtype", "bfloat16",
                     "--runs-root", str(tmp_path / "runs_bk1")])
    assert r.returncode == 0, (r.stdout[-2000:], r.stderr[-3000:])
    assert "test_auroc" in r.stdout

    r = _run(base + ["--runs-root", str(tmp_path / "runs_bk2")])
    assert r.returncode == 0, (r.stdout[-2000:], r.stderr[-3000:])
    assert "test_auroc" in r.stdout

    r = _run(base + ["--block-sorted-kernel", "auto",
                     "--runs-root", str(tmp_path / "runs_bk3")])
    assert r.returncode == 2
    assert "unrecognized arguments" in r.stderr


def test_cli_wire_cache_build_then_reuse(csv_dir, tmp_path):
    """--wire-cache: first run encodes the cache (logged), second run reuses it
    (no rebuild); both train to finite metrics through the packed macro loop."""
    out = str(tmp_path / "prepared")
    r = _run([sys.executable, "scripts/prepare_instacart.py",
              "--csv-dir", csv_dir, "--out", out])
    assert r.returncode == 0, r.stderr[-2000:]
    meta = json.load(open(os.path.join(out, "meta.json")))
    wc = str(tmp_path / "wc")
    base = [
        sys.executable, "scripts/train.py",
        "--data-dir", out,
        "--num-users", str(meta["num_users"]),
        "--num-items", str(meta["num_items"]),
        "--epochs", "2", "--batch-size", "64",
        "--embedding-dim", "8", "--layer-sizes", "16", "8",
        "--limit-val-batches", "2", "--limit-test-batches", "2",
        "--wire-cache", wc,
    ]
    r = _run(base + ["--runs-root", str(tmp_path / "runs")])
    assert r.returncode == 0, (r.stdout[-2000:], r.stderr[-3000:])
    assert "wire cache built" in (r.stdout + r.stderr)
    assert "test_auroc" in r.stdout
    # every cached batch must actually train (macro clamp + tail_step; a
    # cache smaller than one macro regressed to 0 steps once)
    assert "'train_steps': 0" not in r.stdout, r.stdout[-2000:]
    assert os.path.exists(os.path.join(wc, "gen-0", "meta.json"))

    r = _run(base + ["--runs-root", str(tmp_path / "runs2")])
    assert r.returncode == 0, (r.stdout[-2000:], r.stderr[-3000:])
    assert "wire cache built" not in (r.stdout + r.stderr)
    assert "test_auroc" in r.stdout
    assert "'train_steps': 0" not in r.stdout, r.stdout[-2000:]


def test_cli_compute_and_table_dtype(csv_dir, tmp_path):
    """Round 2e: --compute-dtype bfloat16 (mixed-precision towers) and
    --table-dtype bfloat16 train through the CLI and export a scorable
    model; losses stay finite."""
    out = str(tmp_path / "prepared_mp")
    r = _run([sys.executable, "scripts/prepare_instacart.py",
              "--csv-dir", csv_dir, "--out", out])
    assert r.returncode == 0, r.stderr[-2000:]
    meta = json.load(open(os.path.join(out, "meta.json")))

    export_dir = str(tmp_path / "model_mp")
    r = _run([
        sys.executable, "scripts/train.py",
        "--data-dir", out,
        "--num-users", str(meta["num_users"]),
        "--num-items", str(meta["num_items"]),
        "--epochs", "1", "--batch-size", "64",
        "--embedding-dim", "8", "--layer-sizes", "16", "8",
        "--limit-train-batches", "10", "--limit-val-batches", "3",
        "--limit-test-batches", "3",
        "--compute-dtype", "bfloat16",
        "--table-dtype", "bfloat16",
        "--runs-root", str(tmp_path / "runs_mp"),
        "--export-dir", export_dir,
    ])
    assert r.returncode == 0, (r.stdout[-2000:], r.stderr[-3000:])
    assert "test_auroc" in r.stdout

    from two_tower_recommender_model.serving import load_scorer
    scorer = load_scorer(export_dir)
    p = scorer.predict({"user_id": [1, 2], "product_id": [3, 4]})
    assert p.shape == (2,) and np.all(np.isfinite(p))


def test_cli_select_best_on_recall(csv_dir, tmp_path):
    """--select-best val_recall_at_100 runs the per-epoch exact-top-k eval on
    val positives and selects/export on it (sampled_softmax: the objective
    whose AUROC misleads)."""
    out = str(tmp_path / "prepared")
    r = _run([sys.executable, "scripts/prepare_instacart.py",
              "--csv-dir", csv_dir, "--out", out])
    assert r.returncode == 0, r.stderr[-2000:]
    meta = json.load(open(os.path.join(out, "meta.json")))

    export_dir = str(tmp_path / "model")
    r = _run([
        sys.executable, "scripts/train.py",
        "--data-dir", out,
        "--num-users", str(meta["num_users"]),
        "--num-items", str(meta["num_items"]),
        "--epochs", "2", "--batch-size", "64",
        "--embedding-dim", "8", "--layer-sizes", "16", "8",
        "--loss", "sampled_softmax",
        "--limit-train-batches", "8", "--limit-val-batches", "3",
        "--limit-test-batches", "3",
        "--select-best", "val_recall_at_100",
        "--retrieval-eval-users", "50",
        "--runs-root", str(tmp_path / "runs"),
        "--export-dir", export_dir,
    ])
    assert r.returncode == 0, (r.stdout[-2000:], r.stderr[-3000:])
    assert "per-epoch retrieval eval" in r.stdout
    assert "val_recall_at_100" in r.stdout
    assert "best_epoch" in r.stdout
    assert os.path.exists(os.path.join(export_dir, "params.npz"))
