"""Online retrieval service: user -> top-k items, as a callable and over HTTP.

The role of the reference's Vector Search index + `similarity_search` REST
API (`03_model_training.py:1189-1211`, `04_evaluate_retrieval.py:136-141`):
the item corpus is embedded once (full-corpus export) and kept device-
resident; each query embeds the user(s) and runs the exact chunked top-k —
no external index service, no approximation.

HTTP surface (added to `ModelServer` when constructed with a
`RetrievalService`):

    POST /retrieve  {"user_id": [u1, u2], "k": 10}
                 -> {"items": [[...], [...]], "scores": [[...], [...]]}
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from two_tower_recommender_model.config import ModelConfig
from two_tower_recommender_model.evaluation.retrieval import export_feature_embeddings
from two_tower_recommender_model.ops.topk import chunked_topk


class RetrievalService:
    def __init__(
        self,
        model_cfg: ModelConfig,
        params: dict,
        query_feature: str = "user_id",
        candidate_feature: str = "product_id",
        exclude_item_zero: bool = True,
        max_k: int = 1000,
        mesh=None,
    ):
        """`mesh`: a `jax.sharding.Mesh` row-shards the corpus over every
        device and routes queries through the exact sharded top-k
        (`parallel.sharded.make_sharded_topk`: per-shard running merge +
        an O(devices x Q x k) candidate all-gather) — the multi-chip form
        of the ANN-service replacement. Non-device-multiple corpora are
        padded and masked internally."""
        self.model_cfg = model_cfg
        self.params = params
        self.query_feature = query_feature
        self.candidate_feature = candidate_feature
        self.max_k = max_k
        self.mesh = mesh
        self._start = 1 if exclude_item_zero else 0
        self._topk_cache: dict[int, object] = {}
        self._set_corpus(params)

    def _set_corpus(self, params: dict) -> None:
        item_emb = export_feature_embeddings(
            params, self.model_cfg, self.candidate_feature)
        corpus = jnp.asarray(item_emb[self._start :])
        if self.mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec

            # keep the PADDED corpus resident and row-sharded across calls;
            # retrieve() passes the logical row count so the sharded top-k
            # masks the pad rows (no per-call re-padding or resharding)
            pad = (-corpus.shape[0]) % self.mesh.devices.size
            padded = jnp.pad(corpus, ((0, pad), (0, 0))) if pad else corpus
            self._corpus_device = jax.device_put(
                padded,
                NamedSharding(self.mesh,
                              PartitionSpec(tuple(self.mesh.axis_names), None)),
            )
        else:
            self._corpus_device = corpus
        self.corpus = corpus
        self.corpus_size = int(corpus.shape[0])

    def _topk(self, k: int):
        if self.mesh is None:
            return lambda q, c: chunked_topk(q, c, k=k)
        if k not in self._topk_cache:
            from two_tower_recommender_model.parallel.sharded import (
                make_sharded_topk,
            )

            self._topk_cache[k] = make_sharded_topk(self.mesh, k=k)
        return self._topk_cache[k]

    def retrieve(self, user_ids, k: int = 100) -> tuple[np.ndarray, np.ndarray]:
        """(items [U, k], scores [U, k]) — best first; exact over the corpus."""
        if not (1 <= k <= min(self.max_k, self.corpus_size)):
            raise ValueError(
                f"k={k} out of range [1, {min(self.max_k, self.corpus_size)}]"
            )
        user_ids = np.asarray(user_ids)
        q = export_feature_embeddings(
            self.params, self.model_cfg, self.query_feature, ids=user_ids
        )
        if self.mesh is not None:
            scores, idx = self._topk(k)(jnp.asarray(q), self._corpus_device,
                                        valid=self.corpus_size)
        else:
            scores, idx = self._topk(k)(jnp.asarray(q), self._corpus_device)
        return np.asarray(idx) + self._start, np.asarray(scores)

    def refresh(self, params: dict) -> None:
        """Re-embed the corpus after a model update (the `index.sync()` role,
        `03_model_training.py:1208-1211`)."""
        self.params = params
        self._set_corpus(params)
