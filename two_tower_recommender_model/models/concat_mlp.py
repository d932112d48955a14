"""Concat-MLP ranker: the reference's secondary ("Composer") model family.

`TwoTowerComposerModel` (`pytorch-model-training.py:350-518`) is not a
two-tower retrieval model: user and item embeddings are *concatenated* and
pushed through one MLP (Linear+ReLU+Dropout blocks) to a scalar logit — a
pointwise ranker trained with BCE, replicated data-parallel (plain
`nn.Embedding`, no table sharding). This is its JAX equivalent; the
replicated-table plan of `parallel/planner.py` is exactly its distribution
story.

Params pytree: {"tables": {...}, "mlp": {...}} — table init/update machinery
is shared with the two-tower path (same fused row-wise Adagrad applies), the
scoring head differs.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from two_tower_recommender_model.config import ModelConfig
from two_tower_recommender_model.data.featurizer import Batch
from two_tower_recommender_model.models.mlp import init_mlp
from two_tower_recommender_model.models.two_tower import init_table, pooled_embeddings


def init_ranker_params(
    rng: jax.Array,
    cfg: ModelConfig,
    hidden_sizes: tuple[int, ...] = (128, 64),
) -> dict:
    """All features (both 'towers') concat into one MLP ending in 1 logit
    (`pytorch-model-training.py:379-409`)."""
    dtype = jnp.dtype(cfg.param_dtype)
    keys = jax.random.split(rng, len(cfg.tables) + 1)
    tables = {
        t.name: init_table(k, t.num_embeddings, t.embedding_dim, dtype)
        for t, k in zip(cfg.tables, keys[:-1])
    }
    in_dim = sum(cfg.feature_table(f.name).embedding_dim for f in cfg.features)
    in_dim += cfg.query_tower.dense_dim + cfg.candidate_tower.dense_dim
    mlp = init_mlp(keys[-1], in_dim, tuple(hidden_sizes) + (1,), dtype)
    return {"tables": tables, "mlp": mlp}


def ranker_forward(
    params: dict,
    batch: Batch,
    cfg: ModelConfig,
    dropout_rate: float = 0.0,
    dropout_rng: jax.Array | None = None,
) -> jax.Array:
    """[B] logits. Hidden blocks are Linear+ReLU+Dropout, final layer linear
    (`pytorch-model-training.py:393-409`)."""
    pooled = pooled_embeddings(params["tables"], batch, cfg)
    xs = [pooled[f.name] for f in cfg.features]
    if batch.dense is not None:
        xs.append(batch.dense.astype(xs[0].dtype))
    x = jnp.concatenate(xs, axis=1)
    compute_dtype = jnp.dtype(cfg.compute_dtype)
    x = x.astype(compute_dtype)
    mlp = params["mlp"]
    n = len(mlp)
    for i in range(n):
        layer = mlp[f"layer_{i}"]
        x = jnp.dot(
            x, layer["kernel"].astype(compute_dtype), preferred_element_type=jnp.float32
        ).astype(x.dtype) + layer["bias"].astype(compute_dtype)
        if i < n - 1:
            x = jax.nn.relu(x)
            if dropout_rate > 0.0 and dropout_rng is not None:
                keep = jax.random.bernoulli(
                    jax.random.fold_in(dropout_rng, i), 1.0 - dropout_rate, x.shape
                )
                x = jnp.where(keep, x / (1.0 - dropout_rate), 0.0)
    return x[:, 0]


def make_ranker_train_step(cfg: ModelConfig, learning_rate: float = 1e-3,
                           dropout_rate: float = 0.0, donate: bool = True):
    """Composer-parity training for the ranker: ONE Adam over everything via
    plain autodiff (the reference's Composer stack trains its dense replicated
    `nn.Embedding` model exactly this way with `DecoupledAdamW`,
    `pytorch-model-training.py:563-575`) — appropriate for the small
    replicated tables this family targets. Returns (train_step, init_fn).
    State: (params, opt_state, step, rng)."""
    import optax

    from two_tower_recommender_model.models.losses import bce_with_logits

    opt = optax.adam(learning_rate)

    def init_fn(rng, hidden_sizes=(128, 64)):
        params = init_ranker_params(rng, cfg, hidden_sizes)
        return {"params": params, "opt_state": opt.init(params),
                "step": jnp.zeros((), jnp.int32), "rng": rng}

    def step(state, batch):
        drop_rng = (
            jax.random.fold_in(state["rng"], state["step"]) if dropout_rate > 0 else None
        )

        def loss_of(params):
            logits = ranker_forward(params, batch, cfg, dropout_rate, drop_rng)
            return bce_with_logits(logits, batch.labels), logits

        (loss, logits), grads = jax.value_and_grad(loss_of, has_aux=True)(state["params"])
        updates, opt_state = opt.update(grads, state["opt_state"], state["params"])
        new_state = {
            "params": optax.apply_updates(state["params"], updates),
            "opt_state": opt_state,
            "step": state["step"] + 1,
            "rng": state["rng"],
        }
        return new_state, {"loss": loss, "logits": logits}

    return jax.jit(step, donate_argnums=(0,) if donate else ()), init_fn
