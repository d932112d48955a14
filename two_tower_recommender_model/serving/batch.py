"""Offline batch inference over a dataset directory.

The role of the reference's Ray `map_batches` batch scoring
(`workshop/03-batch-inference-ray.py:83-139`) and the Spark-UDF variant
(`workshop/03-batch-inference-spark.py:28-35`): stream a TTRS or parquet
dataset through the Scorer, append a `prediction` column, write TTRS shards
out. IO (native shard reads) overlaps scoring via the loader's prefetch
thread; the accelerator does the batched dot-product work.
"""

from __future__ import annotations

import numpy as np

from two_tower_recommender_model.data.loader import StreamLoader
from two_tower_recommender_model.data.shards import ShardWriter
from two_tower_recommender_model.serving.scorer import Scorer


def batch_predict(
    scorer: Scorer,
    dataset_path: str,
    output_path: str,
    batch_size: int = 4096,
    input_format: str = "ttrs",  # "ttrs" | "parquet"
    keep_columns: tuple[str, ...] | None = None,
    rows_per_shard: int = 1 << 18,
) -> dict:
    """Score every row; returns the output dataset index."""
    if input_format == "ttrs":
        batches = StreamLoader(dataset_path, batch_size, shuffle=False, drop_last=False)
    elif input_format == "parquet":
        from two_tower_recommender_model.data.parquet import parquet_batches

        batches = parquet_batches(dataset_path, batch_size)
    else:
        raise ValueError(f"unknown input_format {input_format!r}")

    with ShardWriter(output_path, rows_per_shard) as w:
        for cols in batches:
            preds = scorer.predict(cols)
            out = {
                k: np.asarray(v)
                for k, v in cols.items()
                if keep_columns is None or k in keep_columns
            }
            out["prediction"] = preds.astype(np.float32)
            w.write(out)
    return w.close()
