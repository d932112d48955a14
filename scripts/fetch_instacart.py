#!/usr/bin/env python
"""Fetch the Instacart market-basket dataset (Kaggle) into a local directory.

The role of the reference's acquisition cell (`config/data_extract.py:20-80`:
Kaggle CLI download via secret-stored credentials, unzip, move to UC Volumes).
Here: kaggle CLI if available, with a clear offline path — place the CSVs
manually and the pipeline picks them up.

Usage:
    python scripts/fetch_instacart.py --out data/instacart
    # offline: put orders.csv, products.csv, order_products__prior.csv,
    #          order_products__train.csv, departments.csv, aisles.csv in --out
"""

from __future__ import annotations

import _repo_path  # noqa: F401  (repo-root fallback when not pip-installed)

import argparse
import os
import shutil
import subprocess
import sys
import zipfile

DATASET = "psparks/instacart-market-basket-analysis"
EXPECTED = [
    "orders.csv", "products.csv", "order_products__prior.csv",
    "order_products__train.csv", "departments.csv", "aisles.csv",
]


def have(out: str) -> list[str]:
    return [f for f in EXPECTED if not os.path.exists(os.path.join(out, f))]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="data/instacart")
    ap.add_argument("--replica", action="store_true",
                    help="generate the full-scale schema-faithful replica instead "
                         "of downloading (offline environments)")
    ap.add_argument("--replica-users", type=int, default=None,
                    help="override replica user count (default: real 206,209)")
    ap.add_argument("--replica-products", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    os.makedirs(args.out, exist_ok=True)

    missing = have(args.out)
    if not missing:
        print(f"all {len(EXPECTED)} CSVs already present in {args.out}")
        return 0

    if args.replica or shutil.which("kaggle") is None:
        if not args.replica:
            print("kaggle CLI not found — generating the schema-faithful replica "
                  "(pass real CSVs via --out to use organic data)", file=sys.stderr)
        from two_tower_recommender_model.data.replica import (
            REAL_PRODUCTS,
            REAL_USERS,
            write_instacart_replica,
        )

        stats = write_instacart_replica(
            args.out,
            num_users=args.replica_users or REAL_USERS,
            num_products=args.replica_products or REAL_PRODUCTS,
            seed=args.seed,
        )
        print(f"replica ready in {args.out}: {stats}")
        return 0

    subprocess.run(
        ["kaggle", "datasets", "download", "-d", DATASET, "-p", args.out], check=True
    )
    for f in os.listdir(args.out):
        if f.endswith(".zip"):
            with zipfile.ZipFile(os.path.join(args.out, f)) as z:
                z.extractall(args.out)
    missing = have(args.out)
    if missing:
        print(f"still missing after download: {missing}", file=sys.stderr)
        return 1
    print(f"dataset ready in {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
