"""Batch scoring with the PyFunc-style dict-of-arrays contract.

The role of the reference's `TwoTowerWrapper(PythonModel).predict`
(`workshop/02-mosaic-model-training.py:1121-1201`) and the Spark/Ray batch
inference paths (`workshop/03-batch-inference-*.py`): raw id columns in, per
-row interaction probabilities out (sigmoid over the dot-product logits,
`:1160-1166`). The same featurizer hash/drop semantics as training apply.

Inputs are padded to power-of-two buckets so arbitrary request sizes reuse a
small set of compiled programs (serving-friendly static shapes).
"""

from __future__ import annotations

from typing import Any, Mapping

import jax
import jax.numpy as jnp
import numpy as np

from two_tower_recommender_model.config import ModelConfig
from two_tower_recommender_model.data.featurizer import Featurizer
from two_tower_recommender_model.models.two_tower import forward


class Scorer:
    def __init__(self, model_cfg: ModelConfig, params: dict,
                 drop_zero_ids: bool = True, dense_cols: tuple[str, ...] = (),
                 max_bucket: int = 1 << 15):
        self.model_cfg = model_cfg
        self.params = jax.tree.map(jnp.asarray, params)
        self.featurizer = Featurizer(model_cfg, drop_zero_ids, dense_cols)
        self.max_bucket = max_bucket

        @jax.jit
        def _score(params, batch):
            q, c = forward(params, batch, model_cfg)
            return jax.nn.sigmoid(jnp.sum(q * c, axis=1))

        self._score = _score

        @jax.jit
        def _embed(params, batch):
            return forward(params, batch, model_cfg)

        self._embed = _embed

    def _bucket(self, n: int) -> int:
        b = 1
        while b < n:
            b <<= 1
        # beyond the cap, use the exact size (one-off compile beats huge padding)
        return b if b <= self.max_bucket else n

    def _prepare(self, inputs: Mapping[str, Any]):
        cols = {k: np.asarray(v) for k, v in inputs.items()}
        if "label" not in cols:
            first = next(iter(cols.values()))
            cols["label"] = np.zeros(len(first), np.int64)
        batch = self.featurizer(cols)
        n = batch.batch_size
        bucket = self._bucket(n)
        pad = bucket - n
        if pad:
            batch = jax.tree.map(
                lambda x: np.concatenate([x, np.zeros((pad,) + x.shape[1:], x.dtype)]), batch
            )
        return jax.tree.map(jnp.asarray, batch), n

    def predict(self, inputs: Mapping[str, Any]) -> np.ndarray:
        """dict of id columns (+optional dense) -> [n] probabilities."""
        batch, n = self._prepare(inputs)
        return np.asarray(self._score(self.params, batch))[:n]

    def embed(self, inputs: Mapping[str, Any]) -> tuple[np.ndarray, np.ndarray]:
        """dict of id columns -> (query_embeddings, candidate_embeddings)."""
        batch, n = self._prepare(inputs)
        q, c = self._embed(self.params, batch)
        return np.asarray(q)[:n], np.asarray(c)[:n]


def load_scorer(path: str, **kwargs) -> Scorer:
    """Load a Scorer from an `export_model` directory (the role of the MLflow
    model reload + PyFunc wrap, `03_model_training.py:1015-1054`)."""
    from two_tower_recommender_model.utils.checkpoint import load_model

    model_cfg, params = load_model(path)
    return Scorer(model_cfg, params, **kwargs)


def load_scorer_from_registry(
    registry_root: str, name: str, version="Production", **kwargs
) -> Scorer:
    """Serve a registered model by stage/number — the `models:/<name>/<stage>`
    serving-URI role (`workshop/02-mosaic-model-training.py:1357-1402`)."""
    from two_tower_recommender_model.utils.registry import ModelRegistry

    model_cfg, params = ModelRegistry(registry_root).load(name, version)
    return Scorer(model_cfg, params, **kwargs)
