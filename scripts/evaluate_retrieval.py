#!/usr/bin/env python
"""Retrieval evaluation at the EXACT reference protocol — the role of
`04_evaluate_retrieval.py`: held-out positives per user from the test split
(`:42-58`), top-k search with k=100 over up to 10,000 users (`:131-141`),
retriever metrics averaged per user (`mlflow.evaluate(model_type="retriever",
retriever_k=k)`, `:202-226`) — computed with the exact on-device top-k
instead of an ANN service.

    python scripts/evaluate_retrieval.py --model-dir out/model \\
        --data-dir out/instacart [--k 100] [--max-users 10000]
"""

from __future__ import annotations

import _repo_path  # noqa: F401  (repo-root fallback when not pip-installed)

import argparse
import json


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--model-dir", required=True, help="export_model directory")
    ap.add_argument("--data-dir", required=True, help="prepare_instacart output dir")
    ap.add_argument("--split", default="test")
    ap.add_argument("--k", type=int, default=100)
    ap.add_argument("--max-users", type=int, default=10_000)
    ap.add_argument("--per-user-table", default=None,
                    help="write the per-user results table (csv) here")
    ap.add_argument("--json-out", default=None)
    args = ap.parse_args()

    import os

    import numpy as np

    from two_tower_recommender_model.evaluation.retrieval import (
        evaluate_retrieval,
        split_positives,
    )
    from two_tower_recommender_model.utils.checkpoint import load_model

    model_cfg, params = load_model(args.model_dir)

    # test-split POSITIVES grouped per user (`04_evaluate_retrieval.py:42-58`)
    user_positives = split_positives(os.path.join(args.data_dir, args.split))
    print(f"{args.split} positives: {sum(map(len, user_positives.values()))} "
          f"over {len(user_positives)} users; evaluating "
          f"{min(len(user_positives), args.max_users)} users at k={args.k}")

    metrics = evaluate_retrieval(
        params, model_cfg, user_positives, k=args.k,
        max_users=args.max_users, ks=(10, args.k),
    )
    print(json.dumps({k: round(float(v), 5) for k, v in metrics.items()}, indent=1))
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(metrics, f, indent=1)

    if args.per_user_table:
        import jax.numpy as jnp

        from two_tower_recommender_model.evaluation.retrieval import (
            export_feature_embeddings,
            per_user_retrieval_table,
        )
        from two_tower_recommender_model.ops.topk import chunked_topk

        users = np.array(sorted(user_positives.keys())[: args.max_users])
        q = export_feature_embeddings(params, model_cfg, "user_id", ids=users)
        c = export_feature_embeddings(params, model_cfg, "product_id")
        _, idx = chunked_topk(jnp.asarray(q), jnp.asarray(c[1:]), k=args.k)
        df = per_user_retrieval_table(
            np.asarray(idx) + 1, users, [user_positives[u] for u in users],
            ks=(args.k,),
        )
        df.to_csv(args.per_user_table, index=False)
        print(f"per-user table -> {args.per_user_table}")


if __name__ == "__main__":
    main()
