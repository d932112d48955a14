"""Full-scale integration proof: Instacart-sized run through the REAL
pipeline — feature engineering at 206k users, TTRS shards, streaming
training, exact retrieval eval at the reference's 10k-user/k=100 protocol.

The reference trains this scale in ~16 min/epoch on an A10 and evaluates
against a managed ANN service (`03_model_training.py:866`,
`04_evaluate_retrieval.py`); this script does the whole loop locally and
prints stage timings.

    python examples/full_scale_synthetic.py [workdir]
"""

from __future__ import annotations

import dataclasses
import os
import sys
import tempfile
import time

import numpy as np


def stage(name, t0):
    dt = time.perf_counter() - t0
    print(f"[{name}] {dt:.1f}s", flush=True)
    return time.perf_counter()


def main(work: str | None = None) -> dict:
    import jax

    from two_tower_recommender_model import config as cfg
    from two_tower_recommender_model.data import Featurizer, SyntheticClickstream
    from two_tower_recommender_model.data.feature_engineering import (
        per_user_split, splits_to_columns)
    from two_tower_recommender_model.data.loader import StreamLoader
    from two_tower_recommender_model.data.shards import write_dataset
    from two_tower_recommender_model.evaluation import evaluate_retrieval
    from two_tower_recommender_model.data.device_featurizer import unpack_batch
    from two_tower_recommender_model.train import (
        create_train_state, evaluate, make_eval_step, make_multi_step, make_train_step)
    from two_tower_recommender_model.train.loop import train_one_epoch_packed
    from two_tower_recommender_model.utils.profiling import device_label

    print(f"device: {device_label()}", flush=True)  # beside every timing below
    work = work or tempfile.mkdtemp(prefix="full_scale_")
    N_USERS, N_ITEMS = 206_209, 49_688
    t0 = time.perf_counter()

    # 1. interactions at scale (synthetic market-basket with latent prefs);
    #    positives+negatives 1:1 like the reference's union
    import pandas as pd

    ds = SyntheticClickstream(N_USERS, N_ITEMS, seed=0, noise=0.05, latent_dim=4,
                              popularity=1.0)
    ROWS = 26_000_000  # the reference's epoch scale
    cols = ds.sample(ROWS)
    df = pd.DataFrame({"user_id": cols["user_id"], "product_id": cols["product_id"],
                       "label": cols["label"]})
    df = df.drop_duplicates(["user_id", "product_id"], keep="first")
    t0 = stage(f"interactions ({len(df)} rows, {df.user_id.nunique()} users)", t0)

    # 2. per-user split + shard write. The TRAIN split is written PRE-PACKED
    #    (featurize once at write time, mmap reads — data/prepacked.py);
    #    val/test stay raw columns for the featureful eval path.
    mcfg = cfg.two_tower_model_config(N_USERS + 1, N_ITEMS + 1, embedding_dim=128,
                                      layer_sizes=(128, 64))
    from two_tower_recommender_model.data.prepacked import (
        PrepackedFeaturizer, pack_dataset)
    from two_tower_recommender_model.data.shards import ShardedDataset

    split = per_user_split(df, seed=0)
    splits = splits_to_columns(split, user_col="user_id", item_col="product_id")
    for name, c in splits.items():
        if name == "train":
            pack_dataset(os.path.join(work, name), mcfg, c, rows_per_shard=1 << 19)
        else:
            write_dataset(os.path.join(work, name), c, rows_per_shard=1 << 19)
    t0 = stage(
        "split+shards (" + ", ".join(f"{k}={len(v['label'])}" for k, v in splits.items()) + ")",
        t0,
    )

    # 3. streaming training, flagship config
    mcfg = dataclasses.replace(
        mcfg,
        query_tower=dataclasses.replace(mcfg.query_tower, final_activation=False),
        candidate_tower=dataclasses.replace(mcfg.candidate_tower, final_activation=False))
    # sorted fast path on by default (loss-invariant row sort, DESIGN §6c)
    tcfg = cfg.TrainConfig(epochs=8, batch_size=65_536, sparse_learning_rate=0.2,
                           learning_rate=3e-3, limit_val_batches=8,
                           sorted_feature="user_id")
    feat = Featurizer(mcfg)
    train_ds = ShardedDataset(os.path.join(work, "train"))
    pf = PrepackedFeaturizer.for_dataset(train_ds, mcfg, sort_feature="user_id")
    state, dense_opt = create_train_state(jax.random.key(0), mcfg, tcfg)
    core = make_train_step(mcfg, tcfg, dense_opt, donate=False, jit=False)
    multi = make_multi_step(lambda s, pb: core(s, unpack_batch(pb, mcfg, pack_label=True)))
    estep = make_eval_step(mcfg, tcfg)

    results = {}
    for epoch in range(tcfg.epochs):
        loader = StreamLoader(train_ds, tcfg.batch_size, seed=1, read_workers=2)
        loader.set_epoch(epoch)
        state, stats = train_one_epoch_packed(state, multi, loader, pf, macro=16)
        print(f"  epoch {epoch}: {stats['train_examples']} examples, "
              f"{stats['epoch_time_s']:.2f}s, {stats['examples_per_sec']/1e6:.1f}M ex/s",
              flush=True)
        results.update(stats)
    t0 = stage("train 8 epochs", t0)

    val = evaluate(state, estep,
                   StreamLoader(os.path.join(work, "val"), tcfg.batch_size,
                                shuffle=False, drop_last=False), feat, 8)
    print("  val:", {k: round(v, 4) for k, v in val.items()}, flush=True)
    results.update(val)
    t0 = stage("val eval", t0)

    # 4. retrieval at the reference protocol: 10k users, k=100, full corpus
    test_df = split[split["split"] == "test"]
    pos = test_df[test_df.label == 1].groupby("user_id")["product_id"].apply(list)
    user_positives = dict(pos.iloc[:10_000])
    params = {"tables": state.tables, **state.dense_params}
    m = evaluate_retrieval(params, mcfg, user_positives, k=100, ks=(10, 100))
    print("  retrieval:", {k: round(v, 4) for k, v in m.items()}, flush=True)
    results.update(m)
    stage("retrieval eval (10k users x 49688 items, exact k=100)", t0)
    return results


if __name__ == "__main__":
    out = main(sys.argv[1] if len(sys.argv) > 1 else None)
    assert out["val_auroc"] > 0.55, out
    assert out["recall_at_100"] > 0.1, out
    print("FULL SCALE OK")
