"""Kaggle acquisition contract.

The live download can't run here (no network/credentials), so these tests pin
everything AROUND it: fixture CSVs carry the real Kaggle dataset's exact
headers (psparks/instacart-market-basket-analysis — the tables the reference
declares explicit schemas for at `01_data_prep.py:39-109` and downloads at
`config/data_extract.py:20-80`), the ingest schemas must parse them including
the real quirks (NaN days_since_prior_order on first orders, comma/quote
product names), the schema-faithful replica must emit byte-identical headers,
and `fetch_instacart.py`'s Kaggle arm runs end-to-end against a FAKE kaggle
CLI that drops the fixture zip — leaving the network call itself as the only
untested line.
"""

from __future__ import annotations

import os
import stat
import subprocess
import sys
import zipfile

import pandas as pd
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Exact header lines of the real Kaggle CSVs (public dataset schema).
KAGGLE_HEADERS = {
    "orders.csv": "order_id,user_id,eval_set,order_number,order_dow,"
                  "order_hour_of_day,days_since_prior_order",
    "products.csv": "product_id,product_name,aisle_id,department_id",
    "order_products__prior.csv": "order_id,product_id,add_to_cart_order,reordered",
    "order_products__train.csv": "order_id,product_id,add_to_cart_order,reordered",
    "departments.csv": "department_id,department",
    "aisles.csv": "aisle_id,aisle",
}

# Fixture rows with the dataset's real parsing quirks.
FIXTURE_ROWS = {
    "orders.csv": [
        "2539329,1,prior,1,2,08,",              # first order: empty days_since
        "2398795,1,prior,2,3,07,15.0",
        "1187899,1,train,11,4,08,14.0",
    ],
    "products.csv": [
        '1,Chocolate Sandwich Cookies,61,19',
        '2,"All-Seasons Salt, Iodized",104,13',  # comma inside quoted name
        '3,"Robust Golden ""Unsweetened"" Tea",94,7',  # embedded quotes
    ],
    "order_products__prior.csv": [
        "2539329,1,1,0",
        "2398795,2,1,1",
    ],
    "order_products__train.csv": [
        "1187899,3,1,0",
    ],
    "departments.csv": ["19,snacks", "13,pantry", "7,beverages"],
    "aisles.csv": ["61,cookies cakes", "104,spices seasonings", "94,tea"],
}


def write_fixtures(d: str) -> None:
    for name, header in KAGGLE_HEADERS.items():
        with open(os.path.join(d, name), "w") as f:
            f.write(header + "\n")
            f.write("\n".join(FIXTURE_ROWS[name]) + "\n")


TABLE_OF = {
    "orders.csv": "orders",
    "products.csv": "products",
    "order_products__prior.csv": "order_products",
    "order_products__train.csv": "order_products",
    "departments.csv": "departments",
    "aisles.csv": "aisles",
}


def test_ingest_schemas_parse_kaggle_fixtures(tmp_path):
    """Every declared ingest schema parses the real-header fixture, with the
    declared dtypes, NaN first-order gaps, and quoted product names intact."""
    from two_tower_recommender_model.data.ingest import (
        INSTACART_SCHEMAS,
        read_csv_table,
    )

    write_fixtures(str(tmp_path))
    for name, table in TABLE_OF.items():
        df = read_csv_table(str(tmp_path / name), table)
        schema = INSTACART_SCHEMAS[table]
        assert list(df.columns) == list(schema), name
        for col, want in schema.items():
            if want == "string":
                continue
            assert str(df[col].dtype) == want, (name, col, df[col].dtype)

    orders = read_csv_table(str(tmp_path / "orders.csv"), "orders")
    assert pd.isna(orders["days_since_prior_order"].iloc[0])  # first order
    products = read_csv_table(str(tmp_path / "products.csv"), "products")
    assert products["product_name"].iloc[1] == "All-Seasons Salt, Iodized"
    assert products["product_name"].iloc[2] == 'Robust Golden "Unsweetened" Tea'


def test_ingest_rejects_wrong_header(tmp_path):
    with open(tmp_path / "orders.csv", "w") as f:
        f.write("order_id,user,eval_set\n1,1,prior\n")
    from two_tower_recommender_model.data.ingest import read_csv_table

    with pytest.raises(ValueError, match="missing columns"):
        read_csv_table(str(tmp_path / "orders.csv"), "orders")


def test_replica_headers_match_kaggle(tmp_path):
    """The schema-faithful replica must emit the EXACT Kaggle header lines —
    the contract that keeps replica-validated code valid on organic data."""
    from two_tower_recommender_model.data.replica import write_instacart_replica

    write_instacart_replica(str(tmp_path), num_users=30, num_products=20, seed=0)
    for name, header in KAGGLE_HEADERS.items():
        with open(tmp_path / name) as f:
            first = f.readline().strip()
        assert first == header, (name, first)


def test_fetch_kaggle_arm_end_to_end(tmp_path):
    """fetch_instacart.py's download arm against a FAKE kaggle CLI that drops
    the fixture zip: CLI discovery, invocation args, unzip, and completeness
    validation all run — only the real network call is substituted."""
    fix = tmp_path / "fix"
    fix.mkdir()
    write_fixtures(str(fix))
    zpath = tmp_path / "instacart-market-basket-analysis.zip"
    with zipfile.ZipFile(zpath, "w") as z:
        for name in KAGGLE_HEADERS:
            z.write(fix / name, name)

    bindir = tmp_path / "bin"
    bindir.mkdir()
    fake = bindir / "kaggle"
    fake.write_text(
        "#!/bin/bash\n"
        "# fake kaggle CLI: assert the real arm's invocation, drop the zip\n"
        'if [ "$1 $2" != "datasets download" ]; then exit 2; fi\n'
        'while [ $# -gt 0 ]; do if [ "$1" = "-p" ]; then OUT="$2"; fi; shift; done\n'
        f'cp "{zpath}" "$OUT/"\n'
    )
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)

    out = tmp_path / "data"
    env = {**os.environ, "PATH": f"{bindir}:{os.environ['PATH']}"}
    r = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", "fetch_instacart.py"),
         "--out", str(out)],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=120,
    )
    assert r.returncode == 0, r.stdout + r.stderr
    assert "dataset ready" in r.stdout
    for name in KAGGLE_HEADERS:
        assert (out / name).exists(), name

    # downloaded CSVs flow into the ingest layer
    from two_tower_recommender_model.data.ingest import read_csv_table

    df = read_csv_table(str(out / "orders.csv"), "orders")
    assert len(df) == 3
