"""The one-command Instacart parity pipeline (replica -> prepare -> train ->
retrieval eval) at CI scale, as a real subprocess chain — the reference's
01->02->03->04 notebook sequence."""

import json
import os
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_replica_schema_matches_reference():
    """The generated CSVs carry the exact Instacart schemas the ingest stage
    expects (`01_data_prep.py:17-27`)."""
    from two_tower_recommender_model.data.replica import write_instacart_replica

    out = "/tmp/ttrm_replica_schema"
    stats = write_instacart_replica(out, num_users=120, num_products=80, seed=3)
    assert stats["users"] == 120 and stats["orders"] >= 120 * 4

    orders = pd.read_csv(os.path.join(out, "orders.csv"))
    assert list(orders.columns) == [
        "order_id", "user_id", "eval_set", "order_number", "order_dow",
        "order_hour_of_day", "days_since_prior_order",
    ]
    assert orders.order_id.is_unique
    assert set(orders.eval_set) == {"prior", "train"}
    # exactly one held-out ("train") order per user — the real dataset's shape
    assert (orders[orders.eval_set == "train"].groupby("user_id").size() == 1).all()
    # per-user counts within the real bounds
    per_user = orders.groupby("user_id").size()
    assert per_user.min() >= 4 and per_user.max() <= 100

    prior = pd.read_csv(os.path.join(out, "order_products__prior.csv"))
    assert list(prior.columns) == ["order_id", "product_id", "add_to_cart_order", "reordered"]
    assert prior.product_id.between(1, 80).all()
    # add_to_cart_order restarts at 1 per order
    assert (prior.groupby("order_id")["add_to_cart_order"].min() == 1).all()

    products = pd.read_csv(os.path.join(out, "products.csv"))
    assert list(products.columns) == ["product_id", "product_name", "aisle_id", "department_id"]
    assert len(products) == 80


def test_replica_has_learnable_preference_signal():
    """Users repeat products across orders far above chance — the signal the
    two-tower model must recover (latent preference model, not uniform)."""
    from two_tower_recommender_model.data.replica import write_instacart_replica

    out = "/tmp/ttrm_replica_signal"
    write_instacart_replica(out, num_users=300, num_products=2000, seed=5)
    orders = pd.read_csv(os.path.join(out, "orders.csv"))
    prior = pd.read_csv(os.path.join(out, "order_products__prior.csv"))
    df = prior.merge(orders[["order_id", "user_id"]], on="order_id")
    # distinct products per user / total rows per user: with uniform picking
    # over 2000 products this ratio would be ~1; preference+popularity pulls
    # it well below (users re-buy their favorites)
    g = df.groupby("user_id")["product_id"]
    ratio = (g.nunique() / g.size()).mean()
    assert ratio < 0.75, ratio


@pytest.mark.slow
@pytest.mark.parametrize("packed", [False, True], ids=["raw", "packed"])
def test_pipeline_end_to_end_subprocess(tmp_path, packed):
    """fetch(replica) -> prepare -> train -> evaluate_retrieval as real CLI
    subprocesses on CPU; retrieval metrics emitted at the reference protocol.
    The packed variant writes pre-packed mmap shards and must produce the
    same protocol output."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    # drop the 8-virtual-device flag pytest's conftest sets: the subprocess
    # should run the single-device packed path like a user shell would
    env.pop("XLA_FLAGS", None)
    work = str(tmp_path / "run")
    cmd = [sys.executable, os.path.join(REPO, "scripts", "instacart_pipeline.py"),
           "--work", work, "--smoke", "--epochs", "1", "--batch-size", "1024"]
    if packed:
        cmd.append("--packed")
    r = subprocess.run(cmd, env=env, capture_output=True, text=True, timeout=540,
                       cwd=REPO)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    assert "PIPELINE COMPLETE" in r.stdout
    with open(os.path.join(work, "retrieval_metrics.json")) as f:
        m = json.load(f)
    assert m["num_users"] > 1000
    assert np.isfinite(m["recall_at_100"]) and 0 <= m["recall_at_100"] <= 1
    if packed:
        assert "(packed)" in r.stdout


def test_fast_preset_expansion(monkeypatch):
    """--fast expands to the production flags without clobbering explicit
    user choices."""
    import importlib.util
    # scripts/ has generically named modules (train.py, ...); scope the path
    # entry to this test so later tests can't import a shadowed module.
    monkeypatch.syspath_prepend(os.path.join(REPO, "scripts"))  # for `import _repo_path`
    spec = importlib.util.spec_from_file_location(
        "instacart_pipeline", os.path.join(REPO, "scripts", "instacart_pipeline.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)

    class A:
        packed = False
        wire_cache = False
        sorted_feature = None
        compute_dtype = None

    a = A()
    mod.apply_fast_preset(a)
    assert a.packed and a.wire_cache
    assert a.sorted_feature == "user_id"
    # bf16 towers are preset-default; explicit float32 still wins below
    assert a.compute_dtype == "bfloat16"

    b = A()
    b.sorted_feature = "off"
    b.compute_dtype = "float32"
    mod.apply_fast_preset(b)
    assert b.sorted_feature == "off" and b.compute_dtype == "float32"
