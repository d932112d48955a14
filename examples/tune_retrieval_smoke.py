"""TPE-tune the in-batch sampled-softmax objective ON THE RETRIEVAL METRIC.

The reference tunes `val_loss` (`ray_tune_optuna_tuning_alex_test.py:636-669`)
— a proxy. Retrieval quality is what ships, so this sweep optimizes
recall@100 at the exact eval protocol (k=100, exact top-k) directly, over the
smoke-scale schema-faithful Instacart replica (8k users / 4k products) the
pipeline harness uses. ~10 trials x ~1 min on one chip.

    python examples/tune_retrieval_smoke.py [workdir]

Prints the ranked trial table and the best config; the winning temperature /
lr ranges transfer to the full-scale run (`scripts/instacart_pipeline.py`).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

SCRIPTS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "scripts")


def prepare_smoke(work: str) -> tuple[str, dict]:
    """fetch replica + prepare shards once (idempotent by existence)."""
    csv_dir = os.path.join(work, "csv")
    shards = os.path.join(work, "shards")
    if not os.path.exists(os.path.join(shards, "meta.json")):
        subprocess.run([sys.executable, os.path.join(SCRIPTS, "fetch_instacart.py"),
                        "--out", csv_dir, "--replica", "--replica-users", "8000",
                        "--replica-products", "4000", "--seed", "0"], check=True)
        subprocess.run([sys.executable, os.path.join(SCRIPTS, "prepare_instacart.py"),
                        "--csv-dir", csv_dir, "--out", shards, "--seed", "0"],
                       check=True)
    with open(os.path.join(shards, "meta.json")) as f:
        return shards, json.load(f)




def main(work: str | None = None):
    import jax

    from two_tower_recommender_model import config as cfg
    from two_tower_recommender_model.data.device_featurizer import (
        PackedFeaturizer, make_packed_train_step, unpack_batch)
    from two_tower_recommender_model.data.loader import StreamLoader
    from two_tower_recommender_model.evaluation.retrieval import (
        evaluate_retrieval, split_positives)
    from two_tower_recommender_model.train.loop import train_one_epoch_packed
    from two_tower_recommender_model.train.step import (
        create_train_state, full_params, make_multi_step, make_train_step)
    from two_tower_recommender_model.tuning.adaptive import run_adaptive_sweep
    from two_tower_recommender_model.tuning.sweep import Choice, LogUniform

    work = work or "/tmp/tune_retrieval_smoke"
    shards, meta = prepare_smoke(work)
    # model SELECTION scores on the VAL split; the TEST split is reserved for
    # the final report of the winning config (no test leakage into tuning)
    val_positives = split_positives(os.path.join(shards, "val"))
    test_positives = split_positives(os.path.join(shards, "test"))
    print(f"smoke data ready: {meta}; {len(val_positives)} val / "
          f"{len(test_positives)} test users", flush=True)

    mcfg = cfg.two_tower_model_config(
        num_users=meta["num_users"], num_items=meta["num_items"],
        embedding_dim=128, layer_sizes=(128, 64))

    def trial(config):
        t0 = time.perf_counter()
        tcfg = cfg.TrainConfig(
            epochs=3, batch_size=8192, loss="sampled_softmax",
            softmax_temperature=float(config["temperature"]),
            sparse_learning_rate=float(config["sparse_lr"]),
            learning_rate=float(config["lr"]),
            logq_correction=bool(config["logq"]),
        )
        feat = PackedFeaturizer(mcfg, pack_label=True)
        state, dense_opt = create_train_state(jax.random.key(0), mcfg, tcfg)
        core = make_train_step(mcfg, tcfg, dense_opt, donate=False, jit=False)
        multi = make_multi_step(
            lambda s, pb: core(s, unpack_batch(pb, mcfg, pack_label=True)))
        tail_step = make_packed_train_step(core, mcfg, pack_label=True)
        for epoch in range(tcfg.epochs):
            loader = StreamLoader(os.path.join(shards, "train"), tcfg.batch_size,
                                  seed=1)
            loader.set_epoch(epoch)
            state, stats = train_one_epoch_packed(state, multi, loader, feat,
                                                  macro=8, tail_step=tail_step)
        params = full_params(state)
        m = evaluate_retrieval(params, mcfg, val_positives, k=100,
                               max_users=10_000, ks=(100,))
        return {"recall_at_100": float(m["recall_at_100"]),
                "train_loss": stats["train_loss"],
                "trial_time_s": round(time.perf_counter() - t0, 1),
                "_params": params}

    space = {
        "temperature": LogUniform(0.05, 3.0),
        "sparse_lr": LogUniform(0.02, 0.5),
        "lr": LogUniform(3e-4, 1e-2),
        "logq": Choice((True, False)),
    }
    res = run_adaptive_sweep(trial, space, num_trials=int(os.environ.get("TRIALS", 10)),
                             metric="recall_at_100", mode="max", seed=0, n_startup=4)
    print(res.table(), flush=True)
    best = res.best()
    test_m = evaluate_retrieval(best.metrics["_params"], mcfg, test_positives,
                                k=100, max_users=10_000, ks=(100,))
    print(f"BEST val recall@100 = {best.metrics['recall_at_100']:.4f} @ {best.config}")
    print(f"TEST recall@100 (winning config, held out) = {test_m['recall_at_100']:.4f}")
    return res


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else None)
