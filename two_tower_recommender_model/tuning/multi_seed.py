"""Vmapped multi-seed trials: S independent models trained in one compiled
program.

The single-program replacement for spinning one Ray actor per trial
(`ray_tune_optuna_tuning_alex_test.py:636-665`) when what varies is the seed:
`jax.vmap` over the TrainState batches S model replicas through the same
train step, so seed-robustness studies cost one XLA program and saturate the
chip instead of a cluster.
"""

from __future__ import annotations

from typing import Iterable

import jax
import jax.numpy as jnp
import numpy as np

from two_tower_recommender_model.config import ModelConfig, TrainConfig
from two_tower_recommender_model.data.featurizer import Featurizer
from two_tower_recommender_model.models import two_tower
from two_tower_recommender_model.models.metrics import exact_auroc
from two_tower_recommender_model.train.step import create_train_state, make_train_step


def multi_seed_train(
    model_cfg: ModelConfig,
    train_cfg: TrainConfig,
    seeds: Iterable[int],
    train_batches: Iterable[dict],
    eval_batch: dict,
    featurizer: Featurizer | None = None,
) -> dict[str, np.ndarray]:
    """Train one model per seed simultaneously; returns per-seed final train
    loss and eval AUROC arrays (aligned with `seeds`)."""
    seeds = list(seeds)
    featurizer = featurizer or Featurizer(model_cfg)

    states = []
    dense_opt = None
    for s in seeds:
        st, dense_opt = create_train_state(jax.random.key(s), model_cfg, train_cfg)
        states.append(st)
    stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *states)

    base_step = make_train_step(model_cfg, train_cfg, dense_opt, donate=False)
    vstep = jax.jit(jax.vmap(base_step, in_axes=(0, None)))

    loss = None
    for cols in train_batches:
        batch = jax.tree.map(jnp.asarray, featurizer(cols))
        stacked, out = vstep(stacked, batch)
        loss = out["loss"]

    ev = jax.tree.map(jnp.asarray, featurizer(eval_batch))

    @jax.jit
    @jax.vmap
    def eval_logits(state):
        params = {"tables": state.tables, **state.dense_params}
        q, c = two_tower.forward(params, ev, model_cfg)
        return jnp.sum(q * c, axis=1)

    logits = np.asarray(eval_logits(stacked))
    labels = np.asarray(ev.labels)
    aurocs = np.array([exact_auroc(logits[i], labels) for i in range(len(seeds))])
    return {
        "seeds": np.array(seeds),
        "final_train_loss": np.asarray(loss) if loss is not None else np.full(len(seeds), np.nan),
        "eval_auroc": aurocs,
    }
