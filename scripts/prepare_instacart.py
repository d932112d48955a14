#!/usr/bin/env python
"""Instacart raw CSVs -> training shards: the 01_data_prep + 02_feature_
engineering notebook chain as one CLI.

    python scripts/prepare_instacart.py --csv-dir data/instacart --out out/instacart

Steps (reference citations in each library call):
  1. ingest CSVs with explicit schemas, join order_detail (01_data_prep.py)
  2. positives = distinct (user, product); sampled complement negatives 1:1
  3. per-user 80/10/10 split with the every-user-trains invariant
  4. contiguous 1-based id indexing (0 reserved = missing)
  5. TTRS shard datasets for train/val/test + id-mapping + counts JSON
"""

from __future__ import annotations

import _repo_path  # noqa: F401  (repo-root fallback when not pip-installed)

import argparse
import json
import os


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--csv-dir", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rows-per-shard", type=int, default=1 << 18)
    ap.add_argument("--max-users", type=int, default=None, help="subsample for smoke runs")
    ap.add_argument("--packed", action="store_true",
                    help="write PRE-PACKED uncompressed shards (device-layout "
                         "columns, mmap fast path — data/prepacked.py); "
                         "train.py auto-detects them")
    args = ap.parse_args()

    import numpy as np

    from two_tower_recommender_model.data.feature_engineering import (
        build_positive_pairs, index_ids, per_user_split, sample_negatives,
        splits_to_columns, union_pos_neg,
    )
    from two_tower_recommender_model.data.ingest import build_order_detail, read_csv_table
    from two_tower_recommender_model.data.shards import write_dataset

    orders = read_csv_table(os.path.join(args.csv_dir, "orders.csv"), "orders")
    products = read_csv_table(os.path.join(args.csv_dir, "products.csv"), "products")
    prior = read_csv_table(
        os.path.join(args.csv_dir, "order_products__prior.csv"), "order_products"
    )
    detail = build_order_detail(orders, prior, products)
    if args.max_users:
        keep = detail["user_id"].drop_duplicates().head(args.max_users)
        detail = detail[detail["user_id"].isin(set(keep))]
    print(f"order_detail rows: {len(detail)}")

    pos = build_positive_pairs(detail)
    print(f"positives: {len(pos)}")
    all_items = products["product_id"].to_numpy()
    neg = sample_negatives(pos, all_items, seed=args.seed)
    df = per_user_split(union_pos_neg(pos, neg), seed=args.seed)
    indexed, mappings = index_ids(df)
    splits = splits_to_columns(indexed)

    os.makedirs(args.out, exist_ok=True)
    if args.packed:
        from two_tower_recommender_model import config as cfg_lib
        from two_tower_recommender_model.data.prepacked import pack_dataset

        mcfg = cfg_lib.two_tower_model_config(
            num_users=len(mappings["user_id"]) + 1,
            num_items=len(mappings["product_id"]) + 1,
        )
    for name, cols in splits.items():
        if args.packed:
            idx = pack_dataset(os.path.join(args.out, name), mcfg, cols,
                               rows_per_shard=args.rows_per_shard)
        else:
            idx = write_dataset(os.path.join(args.out, name), cols, args.rows_per_shard)
        print(f"{name}: {idx['total_rows']} rows, {len(idx['shards'])} shards"
              + (" (packed)" if args.packed else ""))

    # +1: table sizes INCLUDE the reserved id-0 missing sentinel — indices are
    # 1-based up to len(mapping), so a table of exactly len(mapping) rows would
    # alias the largest id onto row 0 via the modulo hash
    meta = {
        "num_users": len(mappings["user_id"]) + 1,
        "num_items": len(mappings["product_id"]) + 1,
        "distinct_users": len(mappings["user_id"]),
        "distinct_items": len(mappings["product_id"]),
        "seed": args.seed,
    }
    with open(os.path.join(args.out, "meta.json"), "w") as f:
        json.dump(meta, f, indent=1)
    np.savez(
        os.path.join(args.out, "id_mappings.npz"),
        user_ids=np.array(list(mappings["user_id"].keys())),
        product_ids=np.array(list(mappings["product_id"].keys())),
    )
    print("meta:", meta)


if __name__ == "__main__":
    main()
