"""Checkpointing with true mid-training resume (orbax-backed).

The reference checkpoints full gathered state-dicts to MLflow per epoch
(`gather_and_get_state_dict`/`log_state_dict_to_mlflow`,
`03_model_training.py:474-502`) but never exercises resume (SURVEY §5). Here:

- sharded-aware: orbax saves each array with its sharding; on restore, arrays
  come back placed per the abstract template (so a row-sharded table restores
  row-sharded, no gather-to-host needed — the multi-host upgrade over
  `ShardedTensor.gather` to rank 0),
- true resume: optimizer state, Adagrad accumulators, step counter and the
  data-loader position (`StreamLoader.state_dict`) are saved together,
- retention: keep the last N checkpoints.
"""

from __future__ import annotations

import json
import os
from typing import Any

import jax

from two_tower_recommender_model.train.step import TrainState


class Checkpointer:
    def __init__(self, directory: str, max_to_keep: int = 3):
        # orbax is imported only by the code that checkpoints, so training
        # without a checkpoint directory does not need it installed
        import orbax.checkpoint as ocp

        self.directory = os.path.abspath(directory)
        self.manager = ocp.CheckpointManager(
            self.directory,
            options=ocp.CheckpointManagerOptions(max_to_keep=max_to_keep, create=True),
            item_names=("state", "extra"),
        )

    def save(self, step: int, state: TrainState, loader_state: dict | None = None,
             extra: dict | None = None, wait: bool = False) -> None:
        import orbax.checkpoint as ocp

        payload = {"loader_state": loader_state, "extra": extra or {}}
        self.manager.save(
            step,
            args=ocp.args.Composite(
                state=ocp.args.StandardSave(state),
                extra=ocp.args.JsonSave(payload),
            ),
        )
        if wait:
            self.manager.wait_until_finished()

    def latest_step(self) -> int | None:
        return self.manager.latest_step()

    def restore(self, template: TrainState, step: int | None = None) -> tuple[TrainState, dict, dict]:
        """Restore (state, loader_state, extra). `template` provides shapes,
        dtypes and shardings (build it with create_train_state [+
        shard_train_state for the sharded layout])."""
        import orbax.checkpoint as ocp

        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.directory}")
        abstract = jax.tree.map(ocp.utils.to_shape_dtype_struct, template)
        restored = self.manager.restore(
            step,
            args=ocp.args.Composite(
                state=ocp.args.StandardRestore(abstract),
                extra=ocp.args.JsonRestore(),
            ),
        )
        extra = restored["extra"] or {}
        return restored["state"], extra.get("loader_state"), extra.get("extra", {})

    def close(self) -> None:
        self.manager.wait_until_finished()
        self.manager.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def export_model(path: str, model_cfg, state: TrainState) -> None:
    """Portable saved-model: config JSON + params npz (the role of the MLflow
    artifact + hyperparam logging that the reference reload rebuilds from,
    `03_model_training.py:1015-1054` — but with typed config instead of
    eval()'d param strings)."""
    import dataclasses

    import numpy as np

    os.makedirs(path, exist_ok=True)
    cfg_dict = dataclasses.asdict(model_cfg)
    # The exported arrays are always f32 (bf16/int8 tables are cast below);
    # normalize the stored config so consumers that trust it (re-quantization,
    # HBM planning, TrainState rebuilds) see dtypes that match the arrays.
    cfg_dict["table_dtype"] = None
    for t in cfg_dict.get("tables", []):
        t["dtype"] = None
    with open(os.path.join(path, "model_config.json"), "w") as f:
        json.dump(cfg_dict, f, indent=1)
    from two_tower_recommender_model.ops.quantized import (
        QuantizedTable,
        dequantize_table,
    )

    flat = {}
    for name, table in state.tables.items():
        if isinstance(table, QuantizedTable):
            table = dequantize_table(table)  # portable export is always f32
        arr = np.asarray(table)
        if arr.dtype != np.float32:
            # bf16 round-trips through np.savez as raw void ('V2') and is
            # unreadable on load — the portable export is always f32
            arr = arr.astype(np.float32)
        flat[f"tables/{name}"] = arr
    for tower in ("query_tower", "candidate_tower"):
        for lname, layer in state.dense_params[tower].items():
            for p, arr in layer.items():
                flat[f"{tower}/{lname}/{p}"] = np.asarray(arr)
    np.savez(os.path.join(path, "params.npz"), **flat)


def load_model(path: str) -> tuple[Any, dict]:
    """Load (model_cfg, params) written by `export_model`."""
    import numpy as np

    from two_tower_recommender_model.config import model_config_from_dict

    with open(os.path.join(path, "model_config.json")) as f:
        model_cfg = model_config_from_dict(json.load(f))
    data = np.load(os.path.join(path, "params.npz"))
    params: dict[str, Any] = {"tables": {}, "query_tower": {}, "candidate_tower": {}}
    for key in data.files:
        parts = key.split("/")
        if parts[0] == "tables":
            params["tables"][parts[1]] = data[key]
        else:
            params[parts[0]].setdefault(parts[1], {})[parts[2]] = data[key]
    return model_cfg, params
