"""The TwoTower model, functional-pytree style.

Architecture parity with the reference `TwoTower` (`03_model_training.py:395-437`):
per-tower, pooled embeddings of that tower's features are concatenated along
the feature axis and projected through an MLP; scoring is the dot product of
the two tower outputs (`03_model_training.py:452`). Generalized (as in the
reference's Ray-tune variant, `ray_tune_optuna_tuning_alex_test.py:185-306`) to
N features per side, per-feature pooling, and optional dense side features
concatenated before the tower MLP.

Params are a plain pytree:

    {"tables": {table_name: [N, D] array},
     "query_tower": mlp pytree, "candidate_tower": mlp pytree}

The forward is split in two stages so the embedding backward can stay sparse
(see `train/step.py`):
  - `pooled_embeddings(tables, batch, cfg)` — gather+pool (no autodiff needed),
  - `towers_forward(params, pooled, dense, cfg)` — dense compute (autodiffed).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from two_tower_recommender_model.config import ModelConfig, TowerConfig
from two_tower_recommender_model.data.featurizer import Batch
from two_tower_recommender_model.models.mlp import apply_mlp, init_mlp
from two_tower_recommender_model.ops.embedding_ops import pooled_lookup


# int8 tables with at least this many rows skip the full f32 init (see
# init_params) — 4M rows x 128 f32 is 2 GB, comfortably under HBM, while
# the capacity-class tables int8 exists for (40M+) are not
BIG_INT8_INIT_ROWS = 4_000_000


def init_table(rng: jax.Array, num_embeddings: int, dim: int, dtype=jnp.float32) -> jax.Array:
    """EmbeddingBag-style init: U(-sqrt(1/N), sqrt(1/N)) (fbgemm default used
    by the reference's `EmbeddingBagCollection`, `03_model_training.py:770-784`)."""
    bound = (1.0 / num_embeddings) ** 0.5
    return jax.random.uniform(rng, (num_embeddings, dim), dtype, -bound, bound)


def tower_in_dim(cfg: ModelConfig, tower: TowerConfig) -> int:
    return sum(cfg.feature_table(f).embedding_dim for f in tower.features) + tower.dense_dim


def init_params(rng: jax.Array, cfg: ModelConfig) -> dict:
    cfg.validate()
    dtype = jnp.dtype(cfg.param_dtype)

    def table_init_dtype(t):
        # int8 tables initialize in f32 and are quantized by create_train_state
        td = cfg.table_dtype_of(t.name)
        return jnp.dtype("float32" if td == "int8" else td)

    keys = jax.random.split(rng, len(cfg.tables) + 2)
    tables = {
        t.name: init_table(k, t.num_embeddings, t.embedding_dim, table_init_dtype(t))
        for t, k in zip(cfg.tables, keys[:-2])
        # int8 tables past the f32-capacity class are SKIPPED here (a full
        # f32 init of a 40M-row table is 20 GB — over HBM by itself) and
        # chunk-initialized by create_train_state (ops/quantized.py:
        # init_quantized_table)
        if not (cfg.table_dtype_of(t.name) == "int8"
                and t.num_embeddings >= BIG_INT8_INIT_ROWS)
    }
    return {
        "tables": tables,
        "query_tower": init_mlp(
            keys[-2], tower_in_dim(cfg, cfg.query_tower), cfg.query_tower.layer_sizes, dtype
        ),
        "candidate_tower": init_mlp(
            keys[-1], tower_in_dim(cfg, cfg.candidate_tower), cfg.candidate_tower.layer_sizes, dtype
        ),
    }


def pooled_embeddings(
    tables: dict[str, jax.Array],
    batch: Batch,
    cfg: ModelConfig,
) -> dict[str, jax.Array]:
    """Per-feature pooled embeddings `{feature: [B, D_f]}` — the role of
    `self.ebc(kjt)` (`03_model_training.py:417`). Pooled outputs are cast to
    the compute dtype when it differs from the table storage dtype (e.g. bf16
    tables pooled into f32 activations)."""
    compute_dtype = (
        jnp.dtype(cfg.compute_dtype)
        if cfg.compute_dtype != cfg.resolved_table_dtype
        else None
    )
    out = {}
    for fc in cfg.features:
        feat = batch.features[fc.name]
        out[fc.name] = pooled_lookup(
            tables[fc.table], feat.ids, feat.mask, fc.pooling, compute_dtype
        )
    return out


def _tower(params_key: str, tower: TowerConfig, params: dict, pooled, dense, cfg: ModelConfig):
    xs = [pooled[f] for f in tower.features]
    if tower.dense_dim:
        if dense is None:
            raise ValueError("tower expects dense features but batch.dense is None")
        xs.append(dense.astype(xs[0].dtype))
    x = jnp.concatenate(xs, axis=1) if len(xs) > 1 else xs[0]
    return apply_mlp(
        params[params_key], x, tower.activation, tower.final_activation,
        jnp.dtype(cfg.compute_dtype),
    )


def towers_forward(
    params: dict,
    pooled: dict[str, jax.Array],
    dense: jax.Array | None,
    cfg: ModelConfig,
) -> tuple[jax.Array, jax.Array]:
    """(query_embedding, candidate_embedding) — `03_model_training.py:414-436`.
    Dense side features, when configured, feed both towers' concat (the
    generalized variant splits them; here each tower declares its own
    `dense_dim` slice via config)."""
    q = _tower("query_tower", cfg.query_tower, params, pooled, dense, cfg)
    c = _tower("candidate_tower", cfg.candidate_tower, params, pooled, dense, cfg)
    return q, c


def forward(params: dict, batch: Batch, cfg: ModelConfig) -> tuple[jax.Array, jax.Array]:
    pooled = pooled_embeddings(params["tables"], batch, cfg)
    return towers_forward(params, pooled, batch.dense, cfg)


def score(params: dict, batch: Batch, cfg: ModelConfig) -> jax.Array:
    """Dot-product logits (`03_model_training.py:452`)."""
    q, c = forward(params, batch, cfg)
    return jnp.sum(q * c, axis=1)
