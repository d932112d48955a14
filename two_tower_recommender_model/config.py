"""Typed configuration for the two-tower framework.

Replaces the reference's ad-hoc config surfaces:
- `Args` dataclass (reference `03_model_training.py:55-70`)
- `ModelConfig`/`DataConfig`/`TrainerConfig` (`pytorch-model-training.py:157-199`)
- notebook config dicts (`config/notebook_config.py:1-39`, `workshop/config.py:1-27`)

Everything is a frozen dataclass so configs are hashable and can be closed over
by `jax.jit` as static values.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Mapping


@dataclasses.dataclass(frozen=True)
class TableConfig:
    """One embedding table (the role of `EmbeddingBagConfig`,
    reference `03_model_training.py:770-784`).

    A table may serve several sparse features (feature_names), all sharing the
    same rows — exactly the TorchRec table/feature split.
    """

    name: str
    num_embeddings: int
    embedding_dim: int = 128
    feature_names: tuple[str, ...] = ()
    # per-table storage dtype override ("float32" | "bfloat16" | "int8");
    # None -> the model-wide table_dtype. Lets one model mix e.g. an int8
    # side-feature table with f32 id tables.
    dtype: str | None = None

    def __post_init__(self):
        if not self.feature_names:
            object.__setattr__(self, "feature_names", (self.name,))


@dataclasses.dataclass(frozen=True)
class FeatureConfig:
    """One sparse input feature: which table it reads and its bag geometry.

    `max_ids_per_sample` is the fixed (XLA-static) padded bag length L. The
    reference's jagged KJT bags become `[B, L]` id arrays + a `[B, L]` validity
    mask; the reference main path has L=1 with length in {0, 1}
    (`03_model_training.py:356-365`).
    """

    name: str
    table: str
    max_ids_per_sample: int = 1
    pooling: str = "sum"  # "sum" | "mean"


@dataclasses.dataclass(frozen=True)
class TowerConfig:
    """One tower: the features it consumes, optional dense side input, MLP sizes.

    `layer_sizes` mirrors the reference towers `[128, 64]` / `[128, 64, 32]`
    (`03_model_training.py:870-879`, `:966-978`). `final_activation=True`
    matches `torchrec.modules.mlp.MLP` semantics (activation after every
    layer, including the last — reference `03_model_training.py:345,408-409`).
    """

    features: tuple[str, ...]
    layer_sizes: tuple[int, ...] = (128, 64)
    dense_dim: int = 0
    activation: str = "relu"
    final_activation: bool = True


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """The full two-tower model: tables + feature wiring + two towers.

    Generalizes the reference `TwoTower` (`03_model_training.py:395-437`, two
    single-feature tables) and the generalized Ray-tune variant (N features per
    side + dense features, `ray_tune_optuna_tuning_alex_test.py:185-306`).
    """

    tables: tuple[TableConfig, ...]
    features: tuple[FeatureConfig, ...]
    query_tower: TowerConfig
    candidate_tower: TowerConfig
    param_dtype: str = "float32"
    compute_dtype: str = "float32"  # "bfloat16" for tensor-core towers
    # table storage dtype; None -> param_dtype. "bfloat16" halves gather HBM
    # traffic at production table sizes (optimizer math stays f32)
    table_dtype: str | None = None

    @property
    def resolved_table_dtype(self) -> str:
        return self.table_dtype or self.param_dtype

    def table_dtype_of(self, table_name: str) -> str:
        """Storage dtype for one table (per-table override, else model-wide)."""
        return self.table(table_name).dtype or self.resolved_table_dtype

    def table(self, name: str) -> TableConfig:
        for t in self.tables:
            if t.name == name:
                return t
        raise KeyError(f"no table named {name!r}")

    def feature(self, name: str) -> FeatureConfig:
        for f in self.features:
            if f.name == name:
                return f
        raise KeyError(f"no feature named {name!r}")

    def feature_table(self, feature_name: str) -> TableConfig:
        return self.table(self.feature(feature_name).table)

    @property
    def tower_out_dim(self) -> int:
        return self.query_tower.layer_sizes[-1]

    def validate(self) -> None:
        table_names = {t.name for t in self.tables}
        feat_names = {f.name for f in self.features}
        for f in self.features:
            if f.table not in table_names:
                raise ValueError(f"feature {f.name!r} references unknown table {f.table!r}")
        for tower_name, tower in (("query", self.query_tower), ("candidate", self.candidate_tower)):
            for fn in tower.features:
                if fn not in feat_names:
                    raise ValueError(f"{tower_name} tower references unknown feature {fn!r}")
        # Parity with the reference assertion that both towers project to the
        # same output dim before retrieval indexing (`03_model_training.py:1143-1145`).
        if self.query_tower.layer_sizes[-1] != self.candidate_tower.layer_sizes[-1]:
            raise ValueError("query and candidate towers must share the final layer size")


def two_tower_model_config(
    num_users: int,
    num_items: int,
    embedding_dim: int = 128,
    layer_sizes: tuple[int, ...] = (128, 64),
    user_feature: str = "user_id",
    item_feature: str = "product_id",
    compute_dtype: str = "float32",
) -> ModelConfig:
    """The reference's flagship architecture: two tables, one feature each,
    symmetric towers (`03_model_training.py:770-790`)."""
    cfg = ModelConfig(
        tables=(
            TableConfig(f"t_{user_feature}", num_users, embedding_dim, (user_feature,)),
            TableConfig(f"t_{item_feature}", num_items, embedding_dim, (item_feature,)),
        ),
        features=(
            FeatureConfig(user_feature, f"t_{user_feature}"),
            FeatureConfig(item_feature, f"t_{item_feature}"),
        ),
        query_tower=TowerConfig((user_feature,), tuple(layer_sizes)),
        candidate_tower=TowerConfig((item_feature,), tuple(layer_sizes)),
        compute_dtype=compute_dtype,
    )
    cfg.validate()
    return cfg


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training hyperparameters (the role of `Args`, reference
    `03_model_training.py:55-70`)."""

    epochs: int = 3
    batch_size: int = 1024
    learning_rate: float = 1e-3  # dense towers (Adam)
    sparse_learning_rate: float = 1e-2  # embedding tables (row-wise Adagrad)
    adagrad_eps: float = 1e-10
    loss: str = "bce"  # "bce" (parity) | "weighted_bce" | "sampled_softmax"
    logq_correction: bool = True  # only for sampled_softmax
    softmax_temperature: float = 1.0  # only for sampled_softmax
    # weighted_bce: one weight per interaction type; the one-hot type columns
    # live in batch.dense[:, start : start + len(weights)]
    # (`ray_tune_optuna_tuning_alex_test.py:308-318`)
    loss_type_weights: tuple[float, ...] | None = None
    loss_type_onehot_start: int = 0
    seed: int = 0
    validation_freq: int | None = None  # mid-epoch val every N steps
    limit_train_batches: int | None = None
    limit_val_batches: int | None = None
    limit_test_batches: int | None = None
    print_sharding_plan: bool = True
    drop_zero_ids: bool = True  # parity: falsy ids get a 0-length bag
    # Name of a single-slot feature whose hashed ids arrive SORTED within each
    # batch (host sorts rows at featurize time — loss-invariant). Enables the
    # `indices_are_sorted` scatter fast path for that feature's table. The
    # featurizer must be built with the same `sort_feature`;
    # `make_train_step` validates the feature layout.
    sorted_feature: str | None = None
    # "float32" (exact) | "bfloat16": dtype of the transient gradient-
    # aggregation buffer for the sorted table's update (bf16 halves the
    # buffer's bytes; duplicate-row grads accumulate at reduced precision).
    scatter_buffer_dtype: str = "float32"
    # "dense" | "alltoall": collective scheme for row-sharded (and bucketed
    # table-wise) f32 tables in the SHARDED step. "dense" is the original
    # psum_scatter/all_gather exchange — per-device comm O(B_global x D),
    # simple and exact, fine at small meshes. "alltoall" routes each
    # example's rows/grads directly between the example's data shard and the
    # id's table shard over static-capacity buckets — per-device comm
    # O(B_local x D), the scheme that scales (DESIGN §9). The exchange
    # DEDUPES: a hot id costs one bucket slot and one wire row however many
    # batch rows repeat it (duplicate grads pre-aggregate sender-side).
    # Capacity bounds distinct ids per partition (the
    # max_unique_ids_per_partition convention of sharded embeddings): each (sender, owner) bucket holds
    # min(ceil(B_local*L/ndev * capacity_factor), rows_per_shard) DISTINCT
    # ids — when the rows_per_shard bound binds (small tables), overflow is
    # impossible by construction. Distinct ids past capacity are dropped
    # from that step and COUNTED — the step reports `exchange_overflow`,
    # and training should treat nonzero as a configuration error (raise
    # capacity_factor). Uniform/hashed ids concentrate tightly around
    # B_local*L/ndev, so 1.25 has astronomically small overflow odds at
    # production batch sizes.
    sharded_exchange: str = "dense"
    exchange_capacity_factor: float = 1.25
    # "float32" (exact) | "bfloat16": wire dtype of the row/grad payloads in
    # the alltoall exchange (ids always int32). bf16 halves the dominant
    # collective bytes; values round once on the wire (the same opt-in
    # numerics class as scatter_buffer_dtype).
    exchange_wire_dtype: str = "float32"
    checkpoint_dir: str | None = None
    checkpoint_every_epochs: int = 1


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Logical device mesh. `data` is the batch/DP axis; `model` the table-
    sharding axis. Tables are row-sharded over the *flattened* (data, model)
    mesh — one global copy of every row (the TorchRec DMP layout,
    `03_model_training.py:797-815`) — while dense towers replicate over both
    axes and sync grads over `data`."""

    data: int = 1
    model: int = 1

    @property
    def num_devices(self) -> int:
        return self.data * self.model


def to_json(cfg: Any) -> str:
    return json.dumps(dataclasses.asdict(cfg), indent=2, default=str)


def _tuplify(obj: Any) -> Any:
    if isinstance(obj, list):
        return tuple(_tuplify(x) for x in obj)
    return obj


def model_config_from_dict(d: Mapping[str, Any]) -> ModelConfig:
    """Rebuild a ModelConfig from logged params (the role of the reference's
    `eval()`-of-param-strings model reload, `03_model_training.py:1015-1054` —
    done here with typed parsing instead of eval)."""
    tables = tuple(
        TableConfig(t["name"], t["num_embeddings"], t["embedding_dim"],
                    tuple(t["feature_names"]), t.get("dtype"))
        for t in d["tables"]
    )
    features = tuple(
        FeatureConfig(f["name"], f["table"], f["max_ids_per_sample"], f["pooling"])
        for f in d["features"]
    )

    def tower(td):
        return TowerConfig(
            tuple(td["features"]), tuple(td["layer_sizes"]), td["dense_dim"],
            td["activation"], td["final_activation"],
        )

    cfg = ModelConfig(
        tables=tables,
        features=features,
        query_tower=tower(d["query_tower"]),
        candidate_tower=tower(d["candidate_tower"]),
        param_dtype=d.get("param_dtype", "float32"),
        compute_dtype=d.get("compute_dtype", "float32"),
        table_dtype=d.get("table_dtype"),
    )
    cfg.validate()
    return cfg
