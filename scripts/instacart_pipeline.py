#!/usr/bin/env python
"""ONE command, reference parity end to end: data -> shards -> training ->
retrieval eval at the exact `04_evaluate_retrieval.py` protocol.

    python scripts/instacart_pipeline.py --work out/instacart_run

Chains the whole reference notebook sequence (01_data_prep ->
02_feature_engineering -> 03_model_training -> 04_evaluate_retrieval):

  1. fetch_instacart      Kaggle CSVs if available, else the full-scale
                          schema-faithful replica (206,209 users / 49,688
                          products / ~30M prior rows)
  2. prepare_instacart    ingest, negatives, per-user split, id indexing,
                          TTRS shards
  3. train                flagship two-tower (dim 128, towers [128, 64]),
                          packed fast path, model export
  4. evaluate_retrieval   recall@100 over 10k users, k=100, exact top-k

Pass --smoke for a minutes-scale subsampled run (same code path).
"""

from __future__ import annotations

import _repo_path  # noqa: F401  (repo-root fallback when not pip-installed)

import argparse
import json
import os
import subprocess
import sys
import time

SCRIPTS = os.path.dirname(os.path.abspath(__file__))


def run(cmd: list[str]) -> None:
    print(f"\n>>> {' '.join(cmd)}", flush=True)
    t0 = time.perf_counter()
    subprocess.run(cmd, check=True)
    print(f"<<< done in {time.perf_counter() - t0:.1f}s", flush=True)


def apply_fast_preset(args) -> None:
    """`--fast`: the production flags for one device (explicit flags win).
    Pre-packed mmap shards + wire cache cut the per-epoch host cost; the
    sorted feature enables the sorted-scatter update; bf16 tower compute
    runs the towers on the bf16 tensor cores (params and both optimizers
    stay f32)."""
    args.packed = True
    args.wire_cache = True
    if args.sorted_feature is None:
        args.sorted_feature = "user_id"
    if args.compute_dtype is None:
        args.compute_dtype = "bfloat16"


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--work", required=True, help="working directory for all stages")
    ap.add_argument("--csv-dir", default=None,
                    help="existing Instacart CSVs (skips fetch)")
    ap.add_argument("--smoke", action="store_true",
                    help="subsampled run (8k users) for CI/smoke")
    ap.add_argument("--packed", action="store_true",
                    help="write pre-packed shards (mmap fast path)")
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--batch-size", type=int, default=8192)
    ap.add_argument("--loss", choices=["bce", "sampled_softmax", "weighted_bce"],
                    default="bce")
    ap.add_argument("--sparse-learning-rate", type=float, default=0.1)
    ap.add_argument("--learning-rate", type=float, default=1e-3)
    ap.add_argument("--softmax-temperature", type=float, default=1.0,
                    help="sampled_softmax logit temperature (tuned on the "
                         "smoke replica by examples/tune_retrieval_smoke.py)")
    ap.add_argument("--wire-cache", action="store_true",
                    help="train through a pre-encoded wire cache under "
                         "<work>/wirecache (data/wirecache.py)")
    ap.add_argument("--macro-batches", type=int, default=None,
                    help="pass-through to train.py")
    ap.add_argument("--sorted-feature", default=None,
                    help="pass through to train.py (hinted-scatter + delta "
                         "wire fast paths)")
    ap.add_argument("--compute-dtype", default=None,
                    choices=["float32", "bfloat16"],
                    help="tower matmul dtype passthrough to train.py")
    ap.add_argument("--fast", action="store_true",
                    help="production preset for one device: pre-packed "
                         "shards, sorted feature, wire cache, bf16 tower "
                         "compute")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    if args.fast:
        apply_fast_preset(args)

    csv_dir = args.csv_dir or os.path.join(args.work, "csv")
    shards = os.path.join(args.work, "shards")
    model_dir = os.path.join(args.work, "model")
    py = sys.executable

    if args.csv_dir is None:
        fetch = [py, os.path.join(SCRIPTS, "fetch_instacart.py"), "--out", csv_dir,
                 "--seed", str(args.seed)]
        if args.smoke:
            fetch += ["--replica", "--replica-users", "8000", "--replica-products", "4000"]
        run(fetch)

    prep = [py, os.path.join(SCRIPTS, "prepare_instacart.py"), "--csv-dir", csv_dir,
            "--out", shards, "--seed", str(args.seed)]
    if args.packed:
        prep.append("--packed")
    run(prep)

    with open(os.path.join(shards, "meta.json")) as f:
        meta = json.load(f)

    run([
        py, os.path.join(SCRIPTS, "train.py"),
        "--data-dir", shards,
        "--num-users", str(meta["num_users"]),
        "--num-items", str(meta["num_items"]),
        "--epochs", str(args.epochs),
        "--batch-size", str(args.batch_size),
        "--loss", args.loss,
        "--sparse-learning-rate", str(args.sparse_learning_rate),
        "--learning-rate", str(args.learning_rate),
        "--softmax-temperature", str(args.softmax_temperature),
        "--seed", str(args.seed),
        "--runs-root", os.path.join(args.work, "runs"),
        "--export-dir", model_dir,
    ] + (["--sorted-feature", args.sorted_feature] if args.sorted_feature else [])
      + (["--wire-cache", os.path.join(args.work, "wirecache")]
         if args.wire_cache else [])
      + (["--macro-batches", str(args.macro_batches)]
         if args.macro_batches is not None else [])
      + (["--compute-dtype", args.compute_dtype]
         if args.compute_dtype else []))

    run([
        py, os.path.join(SCRIPTS, "evaluate_retrieval.py"),
        "--model-dir", model_dir,
        "--data-dir", shards,
        "--k", "100",
        "--max-users", "10000",
        "--json-out", os.path.join(args.work, "retrieval_metrics.json"),
    ])
    with open(os.path.join(args.work, "retrieval_metrics.json")) as f:
        m = json.load(f)
    print(f"\nPIPELINE COMPLETE: recall@100 = {m['recall_at_100']:.4f} "
          f"over {int(m['num_users'])} users (protocol: k=100, 10k users, "
          f"exact top-k — 04_evaluate_retrieval.py:131-226)")


if __name__ == "__main__":
    main()
