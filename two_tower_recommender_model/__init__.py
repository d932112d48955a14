"""two_tower_recommender_model — a JAX two-tower retrieval framework.

A ground-up JAX/XLA/Pallas re-design of the capabilities of the reference
two-tower recommender stack (TorchRec `EmbeddingBagCollection` + MLP towers +
`DistributedModelParallel` + Mosaic streaming + Vector Search retrieval eval):

- `config`      — typed configs (the role of `Args` / `config` dicts,
                  reference `03_model_training.py:55-70`, `config/notebook_config.py`).
- `data`        — synthetic generator, columnar ingest, feature engineering
                  (negative sampling / per-user split / id indexing), sharded
                  streaming dataset + deterministic resumable loader, featurizer
                  (the role of `transform_to_torchrec_batch`).
- `models`      — embedding tables, MLP towers, TwoTower model, losses
                  (BCE parity + in-batch sampled softmax), streaming AUROC.
- `ops`         — XLA + Pallas kernels: pooled embedding lookup, fused
                  row-wise-Adagrad update, chunked matmul top-k retrieval.
- `parallel`    — device mesh, memory-aware sharding planner (the role of
                  `EmbeddingShardingPlanner`), sharded lookup/update collectives.
- `train`       — optimizers, train/eval loops, prefetching input pipeline
                  (the role of `TrainPipelineSparseDist`).
- `evaluation`  — full-corpus embedding export + exact top-k retrieval metrics
                  (recall@k / precision@k / NDCG@k / MRR).
- `serving`     — batch scorer with the PyFunc-style dict-of-arrays contract.
- `tuning`      — grid/random hyperparameter sweeps, vmapped multi-seed trials.
- `utils`       — orbax checkpointing with true resume, experiment tracking.
"""

__version__ = "0.1.0"

from two_tower_recommender_model import config  # noqa: F401
