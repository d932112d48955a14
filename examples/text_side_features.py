"""End-to-end: product TEXT features feed the candidate tower.

The reference builds LLM text embeddings for products
(`02a_create_product_features.py:30-56`) and its generalized TwoTower takes
dense side features split at `dense_index`
(`ray_tune_optuna_tuning_alex_test.py:270-306`). This example wires the whole
path: product text -> hashed-n-gram embeddings (`data/text_features.py`,
the offline stand-in for `ai_query("databricks-gte-large-en")`) -> per-batch
dense candidate-tower input -> training -> retrieval eval where the corpus
export uses each item's text vector (`export_feature_embeddings(dense=...)`).

    python examples/text_side_features.py
"""

from __future__ import annotations

import dataclasses

import numpy as np


def main(num_users=2000, num_items=500, text_dim=32, steps=200,
         precomputed_path=None) -> dict:
    """`precomputed_path` (.npz or .parquet of product_id -> embedding — the
    exact shape real `ai_query` output arrives in) replaces the n-gram
    encoder as the text-feature source; None keeps the offline fallback."""
    import jax
    import jax.numpy as jnp
    import pandas as pd

    from two_tower_recommender_model import config as cfg
    from two_tower_recommender_model.data import Featurizer, SyntheticClickstream
    from two_tower_recommender_model.data.text_features import (
        build_product_text_features,
    )
    from two_tower_recommender_model.evaluation.retrieval import evaluate_retrieval
    from two_tower_recommender_model.train.pipeline import prefetch_to_device
    from two_tower_recommender_model.train.step import create_train_state, make_train_step

    # 1. product text -> embedding table aligned to raw item id (row 0 = pad)
    products = pd.DataFrame({
        "product_id": np.arange(1, num_items + 1),
        "product_name": [f"organic product {i} pack" for i in range(1, num_items + 1)],
        "department": [f"department_{i % 21}" for i in range(1, num_items + 1)],
        "aisle": [f"aisle_{i % 134}" for i in range(1, num_items + 1)],
    })
    if precomputed_path is not None:
        from two_tower_recommender_model.data.text_features import (
            load_precomputed_embeddings,
        )

        text_table = load_precomputed_embeddings(
            precomputed_path, num_ids=num_items)
        text_dim = text_table.shape[1]
    else:
        _, text_emb = build_product_text_features(products, dim=text_dim)
        text_table = np.zeros((num_items + 1, text_dim), np.float32)
        text_table[1:] = text_emb

    # 2. model: candidate tower takes id embedding + text dense input
    mcfg = cfg.two_tower_model_config(num_users + 1, num_items + 1,
                                      embedding_dim=32, layer_sizes=(64, 32))
    mcfg = dataclasses.replace(
        mcfg,
        query_tower=dataclasses.replace(mcfg.query_tower, final_activation=False),
        candidate_tower=dataclasses.replace(
            mcfg.candidate_tower, dense_dim=text_dim, final_activation=False),
    )
    tcfg = cfg.TrainConfig(sparse_learning_rate=0.1, learning_rate=3e-3)
    ds = SyntheticClickstream(num_users, num_items, seed=9, noise=0.05, latent_dim=4)
    base_feat = Featurizer(mcfg)

    def featurize(cols):
        # per-batch dense side input = each example's item text vector
        batch = base_feat(cols)
        return batch.replace(dense=text_table[np.asarray(cols["product_id"])])

    state, dense_opt = create_train_state(jax.random.key(0), mcfg, tcfg)
    step = make_train_step(mcfg, tcfg, dense_opt)
    for batch in prefetch_to_device(ds.batches(1024, steps), featurize):
        state, out = step(state, batch)
    loss = float(jax.block_until_ready(out["loss"]))

    # 3. retrieval with the text features in the corpus export
    params = {"tables": state.tables, **state.dense_params}
    users = np.arange(1, min(num_users, 500) + 1)
    truth = ds.ground_truth_topk(users, k=10)
    pos = {int(u): truth[i].tolist() for i, u in enumerate(users)}
    m = evaluate_retrieval(params, mcfg, pos, k=20, ks=(10, 20),
                           candidate_dense=text_table)
    print(f"loss={loss:.4f}  recall@10={m['recall_at_10']:.4f} "
          f"(random would be {10/num_items:.4f})")
    return {"loss": loss, **m}


if __name__ == "__main__":
    import sys
    import tempfile

    if "--precomputed" in sys.argv:
        # produce an embedding file in the ai_query-output shape, then run
        # the whole pipeline through the ingestion path
        from two_tower_recommender_model.data.text_features import (
            embed_text,
            save_precomputed_embeddings,
        )

        num_items, text_dim = 500, 32
        emb = embed_text([f"organic product {i} pack" for i in range(1, num_items + 1)],
                         dim=text_dim)
        ext = ".parquet" if "--parquet" in sys.argv else ".npz"
        with tempfile.TemporaryDirectory() as d:
            path = f"{d}/product_embeddings{ext}"
            save_precomputed_embeddings(
                path, np.arange(1, num_items + 1), emb)
            out = main(num_items=num_items, text_dim=text_dim,
                       precomputed_path=path)
    else:
        out = main()
    assert out["recall_at_10"] > 3 * 10 / 500, out
    print("TEXT SIDE FEATURES OK")
