"""Train/eval steps: two-stage backward with fused sparse update.

One jit-compiled program per step — the JAX answer to the reference's
`TrainPipelineSparseDist` stream-overlap machinery (`03_model_training.py:648`):
XLA schedules the gathers, tower matmuls and (in the sharded build)
collectives inside a single compiled step, while the host-side prefetcher
(`train/pipeline.py`) keeps the next batch in flight.

Gradient flow (the `apply_optimizer_in_backward` design,
`03_model_training.py:791-795`):

  stage A  pooled = gather+pool(tables, ids)          (outside autodiff)
  stage B  (loss, logits), (d_dense, d_pooled) = grad of towers+loss
  stage C  d_pooled -> per-row grads -> fused row-wise Adagrad scatter
           d_dense  -> Adam

The table gradient therefore never exists as a dense [N, D] array in the
autodiff graph, and stage C touches only the rows present in the batch.
"""

from __future__ import annotations

import functools
import zlib

from typing import Callable

import jax
import jax.numpy as jnp
import optax

from two_tower_recommender_model.config import ModelConfig, TrainConfig
from two_tower_recommender_model.data.featurizer import Batch
from two_tower_recommender_model.models import losses as losses_lib
from two_tower_recommender_model.models import two_tower
from two_tower_recommender_model.models.metrics import (
    AUROCState,
    MeanState,
    auroc_init,
    auroc_update,
    mean_init,
    mean_update,
)
from two_tower_recommender_model.ops.embedding_ops import row_grads_from_pooled
from two_tower_recommender_model.train import optimizer as opt_lib
from two_tower_recommender_model.utils.pytree import pytree_dataclass


@pytree_dataclass
class TrainState:
    step: jax.Array  # scalar int32
    tables: dict[str, jax.Array]
    adagrad_acc: dict[str, jax.Array]  # per-table [N] row accumulators
    dense_params: dict
    dense_opt_state: optax.OptState
    # streaming item-frequency counts [num_candidate_ids] for the sampled-
    # softmax logQ popularity correction (None unless enabled)
    item_counts: jax.Array | None = None


def dense_param_tree(params: dict) -> dict:
    return {"query_tower": params["query_tower"], "candidate_tower": params["candidate_tower"]}


def full_params(state: TrainState) -> dict:
    return {"tables": state.tables, **state.dense_params}


def create_train_state(
    rng: jax.Array, model_cfg: ModelConfig, train_cfg: TrainConfig
) -> tuple[TrainState, optax.GradientTransformation]:
    params = two_tower.init_params(rng, model_cfg)
    if any(model_cfg.table_dtype_of(t.name) == "int8" for t in model_cfg.tables):
        from two_tower_recommender_model.ops.quantized import quantize_table

        params["tables"] = {
            k: quantize_table(v) if model_cfg.table_dtype_of(k) == "int8" else v
            for k, v in params["tables"].items()
        }
    # beyond-f32-capacity int8 tables (init_params skips them — a full f32
    # init of a 40M-row table is 20 GB, over HBM by itself): generate and
    # quantize chunk-wise, never materializing more than one f32 chunk
    for t in model_cfg.tables:
        if t.name not in params["tables"]:
            from two_tower_recommender_model.ops.quantized import (
                PACKED_STORAGE_MIN_ROWS,
                init_quantized_table,
            )

            assert model_cfg.table_dtype_of(t.name) == "int8", t.name
            params["tables"][t.name] = init_quantized_table(
                jax.random.fold_in(rng, zlib.crc32(t.name.encode())),
                t.num_embeddings, t.embedding_dim,
                packed=t.num_embeddings >= PACKED_STORAGE_MIN_ROWS,
            )
    dense_opt = opt_lib.dense_optimizer(train_cfg.learning_rate)
    dense_params = dense_param_tree(params)
    item_counts = None
    if train_cfg.loss == "sampled_softmax" and train_cfg.logq_correction:
        cand_table = model_cfg.feature_table(model_cfg.candidate_tower.features[0])
        item_counts = jnp.zeros((cand_table.num_embeddings,), jnp.float32)
    state = TrainState(
        step=jnp.zeros((), jnp.int32),
        tables=params["tables"],
        adagrad_acc={
            name: jnp.zeros((t.shape[0],), jnp.float32) for name, t in params["tables"].items()
        },
        dense_params=dense_params,
        dense_opt_state=dense_opt.init(dense_params),
        item_counts=item_counts,
    )
    return state, dense_opt


def _table_flat_grads(
    model_cfg: ModelConfig, batch: Batch, pooled_grads: dict[str, jax.Array]
) -> dict[str, tuple[jax.Array, jax.Array]]:
    """Collect ([M] ids, [M, D] grads) per *table*, concatenating all features
    that read it (TorchRec's table/feature fan-in)."""
    per_table: dict[str, list] = {t.name: [] for t in model_cfg.tables}
    for fc in model_cfg.features:
        table = model_cfg.table(fc.table)
        feat = batch.features[fc.name]
        rg = row_grads_from_pooled(pooled_grads[fc.name], feat.mask, fc.pooling)
        fid, fg = opt_lib.row_grad_flatten(feat.ids, feat.mask, rg, table.num_embeddings)
        per_table[fc.table].append((fid, fg))
    out = {}
    for name, parts in per_table.items():
        if not parts:
            continue
        ids = jnp.concatenate([p[0] for p in parts]) if len(parts) > 1 else parts[0][0]
        gs = jnp.concatenate([p[1] for p in parts]) if len(parts) > 1 else parts[0][1]
        out[name] = (ids, gs)
    return out


def validate_sorted_feature(model_cfg: ModelConfig, train_cfg: TrainConfig) -> str | None:
    """Resolve `TrainConfig.sorted_feature` to its table name, enforcing the
    layout under which a host-sorted batch yields non-decreasing flat ids for
    that table: the feature is single-slot and the table's only reader (a
    multi-slot or fanned-in table interleaves other ids into the flat array,
    breaking the `indices_are_sorted` promise)."""
    feat = train_cfg.sorted_feature
    if feat is None:
        return None
    fc = next((f for f in model_cfg.features if f.name == feat), None)
    if fc is None:
        raise ValueError(f"sorted_feature {feat!r}: no such feature")
    if fc.max_ids_per_sample != 1:
        raise ValueError(f"sorted_feature {feat!r} must be single-slot "
                         f"(has {fc.max_ids_per_sample})")
    readers = [f.name for f in model_cfg.features if f.table == fc.table]
    if readers != [feat]:
        raise ValueError(f"sorted_feature {feat!r}: table {fc.table!r} is also "
                         f"read by {readers} — flat ids would interleave")
    return fc.table


def auto_sorted_feature(model_cfg: ModelConfig) -> str | None:
    """The feature `sorted_feature="auto"` resolves to: the single-slot,
    sole-reader feature with the LARGEST table (sorting buys the most on the
    biggest scatter). None when no feature qualifies."""
    best, best_rows = None, 0
    for fc in model_cfg.features:
        if fc.max_ids_per_sample != 1:
            continue
        readers = [f.name for f in model_cfg.features if f.table == fc.table]
        if readers != [fc.name]:
            continue
        rows = model_cfg.table(fc.table).num_embeddings
        if rows > best_rows:
            best, best_rows = fc.name, rows
    return best


def pick_table_update_fn(
    model_cfg: ModelConfig,
    train_cfg: TrainConfig,
    sorted_table: str | None,
    tname: str,
    n_flat_ids: int,
    quantized: bool,
    sparse_update: Callable | None = None,
) -> Callable:
    """The per-table update routing of `make_train_step`. Returns an update
    callable `(table, acc, flat_ids, flat_grads, lr, eps) -> (table, acc)`.

    int8 storage takes the size-picked quantized update; float tables take
    an explicit `sparse_update` override if given, else the size-picked
    scatter/segment update. A transient-dense update of the host-sorted
    table gets the `indices_are_sorted` hint and the configured scatter
    buffer dtype."""
    from two_tower_recommender_model.ops.quantized import (
        pick_quantized_update,
        quantized_dense_rowwise_adagrad,
    )

    num_rows = model_cfg.table(tname).num_embeddings
    if quantized:
        upd = pick_quantized_update(num_rows, n_flat_ids)
    elif sparse_update is not None:
        return sparse_update
    else:
        upd = opt_lib.pick_sparse_update(num_rows, n_flat_ids)
    if sparse_update is None and tname == sorted_table and upd in (
        opt_lib.dense_rowwise_adagrad, quantized_dense_rowwise_adagrad
    ):
        sorted_buf = (
            jnp.bfloat16 if train_cfg.scatter_buffer_dtype == "bfloat16" else None
        )
        upd = functools.partial(upd, ids_sorted=True, buffer_dtype=sorted_buf)
    return upd


def _streaming_log_q(state: TrainState, batch: Batch, cand_feature: str):
    """(new item counts, logQ | None). Streaming logQ estimates each in-batch
    item's sampling probability from running counts (popularity correction
    for in-batch negatives)."""
    if state.item_counts is None:
        return None, None
    cand_ids = batch.features[cand_feature].ids[:, 0]
    new_counts = state.item_counts.at[cand_ids].add(1.0)
    return new_counts, losses_lib.item_log_q_from_counts(new_counts, cand_ids)


def step_gradients(model_cfg: ModelConfig, loss_fn: Callable, state: TrainState,
                   batch: Batch, log_q: jax.Array | None = None):
    """Stages A-B of the train step: (loss, logits, d_dense, {table: ([M] ids,
    [M, D] per-slot grads)}), before any optimizer sees them."""
    pooled = two_tower.pooled_embeddings(state.tables, batch, model_cfg)

    def loss_of(dense_params, pooled):
        q, c = two_tower.towers_forward(dense_params, pooled, batch.dense, model_cfg)
        return loss_fn(q, c, batch, log_q=log_q)

    (loss, logits), (d_dense, d_pooled) = jax.value_and_grad(
        loss_of, argnums=(0, 1), has_aux=True
    )(state.dense_params, pooled)
    return loss, logits, d_dense, _table_flat_grads(model_cfg, batch, d_pooled)


def make_apply_gradients(
    model_cfg: ModelConfig,
    train_cfg: TrainConfig,
    dense_opt: optax.GradientTransformation,
    sparse_update: Callable | None = None,
):
    """Stage C of the train step, unjitted: `(state, grads) -> new state`, where
    `grads` is `{"d_dense", "table_grads", "item_counts"}` as
    `make_train_step(..., with_grads=True)` returns it: Adam on the dense
    params, the per-table row-wise Adagrad (`pick_table_update_fn`)."""
    from two_tower_recommender_model.ops.quantized import QuantizedTable

    sorted_table = validate_sorted_feature(model_cfg, train_cfg)

    def apply(state: TrainState, grads: dict) -> TrainState:
        updates, new_opt_state = dense_opt.update(
            grads["d_dense"], state.dense_opt_state, state.dense_params
        )
        new_dense = optax.apply_updates(state.dense_params, updates)

        new_tables = dict(state.tables)
        new_acc = dict(state.adagrad_acc)
        for tname, (fids, fgrads) in grads["table_grads"].items():
            upd = pick_table_update_fn(
                model_cfg, train_cfg, sorted_table, tname, fids.shape[0],
                isinstance(state.tables[tname], QuantizedTable), sparse_update,
            )
            new_tables[tname], new_acc[tname] = upd(
                state.tables[tname],
                state.adagrad_acc[tname],
                fids,
                fgrads,
                train_cfg.sparse_learning_rate,
                train_cfg.adagrad_eps,
            )

        return TrainState(
            step=state.step + 1,
            tables=new_tables,
            adagrad_acc=new_acc,
            dense_params=new_dense,
            dense_opt_state=new_opt_state,
            item_counts=grads["item_counts"],
        )

    return apply


def make_train_step(
    model_cfg: ModelConfig,
    train_cfg: TrainConfig,
    dense_opt: optax.GradientTransformation,
    sparse_update: Callable | None = None,
    donate: bool = True,
    jit: bool = True,
    with_grads: bool = False,
):
    """Single-device jitted train step. The multi-chip version with sharded
    tables lives in `parallel/sharded.py` and shares stages B/C.
    `jit=False` returns the raw traceable step (for composition under
    `lax.scan`, see `make_multi_step`). `with_grads=True` adds the gradients
    the step applied to its outputs, under "grads" (see
    `make_apply_gradients`).

    `sparse_update=None` picks the fused-update implementation per table at
    trace time (`opt_lib.pick_sparse_update`): transient-dense scatter-add
    when the batch touches a sizable table fraction, sorted-segment otherwise
    — both compute identical row-wise Adagrad (oracle-tested)."""
    loss_fn = losses_lib.loss_fn_from_config(train_cfg, model_cfg)
    cand_feature = model_cfg.candidate_tower.features[0]
    apply = make_apply_gradients(model_cfg, train_cfg, dense_opt, sparse_update)

    def step(state: TrainState, batch: Batch):
        new_counts, log_q = _streaming_log_q(state, batch, cand_feature)
        loss, logits, d_dense, table_grads = step_gradients(
            model_cfg, loss_fn, state, batch, log_q)
        grads = {"d_dense": d_dense, "table_grads": table_grads,
                 "item_counts": new_counts}
        out = {"loss": loss, "logits": logits}
        if with_grads:
            out["grads"] = grads
        return apply(state, grads), out

    if not jit:
        return step
    return jax.jit(step, donate_argnums=(0,) if donate else ())


def make_multi_step(step_fn: Callable, donate: bool = True):
    """Train on a K-batch macro-batch in ONE device dispatch: `lax.scan` over
    stacked batches (leading axis K on every leaf). Amortizes per-dispatch and
    per-transfer latency when the host feed, not the chip, is the bottleneck —
    the JAX macro-batching pattern. Returns (state, {"loss": [K]}).

    `step_fn` must be an unjitted step core (e.g. `make_train_step(...,
    jit=False)`, optionally composed with `unpack_batch`)."""

    def multi(state, stacked_batches):
        def body(carry, one_batch):
            new_state, out = step_fn(carry, one_batch)
            return new_state, out["loss"]

        state, losses = jax.lax.scan(body, state, stacked_batches)
        return state, {"loss": losses}

    return jax.jit(multi, donate_argnums=(0,) if donate else ())


def stack_batches(batches: list):
    """Stack K host batches into one macro-batch pytree (leading axis K)."""
    import numpy as np

    return jax.tree.map(lambda *xs: np.stack(xs), *batches)


@pytree_dataclass
class EvalState:
    """Running eval metrics (the reference `evaluate` loop's AUROC + mean loss,
    `03_model_training.py:504-566`). `exchange_overflow` counts distinct ids
    the alltoall exchange dropped during eval forwards (None under the dense
    exchange / single-device paths) — `evaluate` raises on a nonzero count
    so capacity overflow can never silently corrupt metrics."""

    auroc: AUROCState
    loss: MeanState
    exchange_overflow: jax.Array | None = None


def eval_state_init(bins: int = 8192) -> EvalState:
    return EvalState(auroc=auroc_init(bins), loss=mean_init())


def make_eval_step(model_cfg: ModelConfig, train_cfg: TrainConfig):
    loss_fn = losses_lib.make_loss_fn("bce")  # eval metric parity: BCE + AUROC

    @jax.jit
    def step(state: TrainState, eval_state: EvalState, batch: Batch):
        params = full_params(state)
        q, c = two_tower.forward(params, batch, model_cfg)
        loss, logits = loss_fn(q, c, batch)
        w = batch.weights
        if w is None:
            n = jnp.float32(batch.labels.shape[0])
        else:
            # zero-weight rows are padding: re-average the loss over real rows
            n = w.sum()
            loss = losses_lib.bce_with_logits(logits, batch.labels, w)
        return EvalState(
            auroc=auroc_update(eval_state.auroc, logits, batch.labels, w),
            loss=mean_update(eval_state.loss, loss, n),
        )

    return step
