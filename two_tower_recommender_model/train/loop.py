"""Training/eval loops — the role of the reference's `train_val_test`,
`train`, and `evaluate` (`03_model_training.py:504-685`).

Shape preserved from the reference:
- a baseline validation eval before any training (`:651`),
- per epoch: train -> validation eval -> metric logging -> checkpoint,
- optional mid-epoch validation every `validation_freq` steps (`:595-617`),
- `limit_{train,val,test}_batches` truncation (`:568-585`),
- a final test eval (`:668-674`).
"""

from __future__ import annotations

import itertools
import logging
import time
from typing import Callable, Iterable

import jax

from two_tower_recommender_model.config import ModelConfig, TrainConfig
from two_tower_recommender_model.data.featurizer import Featurizer, pad_batch, pad_batch_to
from two_tower_recommender_model.models.metrics import auroc_compute, mean_compute
from two_tower_recommender_model.train import pipeline as pipeline_lib
from two_tower_recommender_model.train.step import TrainState, eval_state_init

log = logging.getLogger(__name__)


def evaluate(
    state: TrainState,
    eval_step: Callable,
    batches: Iterable[dict],
    featurizer: Featurizer,
    limit_batches: int | None = None,
    stage: str = "val",
    sharding=None,
    pad_multiple: int | None = None,
    pad_to: int | None = None,
) -> dict[str, float]:
    """One pass of eval; returns {"<stage>_loss", "<stage>_auroc"}
    (`03_model_training.py:504-566`). `pad_multiple` pads ragged tail batches
    with zero-weight rows so they shard across devices without dropping or
    skewing metrics. `pad_to` pads EVERY batch to that fixed row count
    instead — required in multi-host eval (with a loader in
    align_hosts="pad" mode), where each step's per-process shape must be
    identical across hosts, including a host's all-padding filler batches."""
    es = eval_state_init()
    it = iter(batches)
    if limit_batches is not None:
        it = itertools.islice(it, limit_batches)
    featurize = featurizer
    if pad_to:
        featurize = lambda cols: pad_batch_to(featurizer(cols), pad_to)  # noqa: E731
    elif pad_multiple:
        featurize = lambda cols: pad_batch(featurizer(cols), pad_multiple)  # noqa: E731
    n = 0
    for batch in pipeline_lib.prefetch_to_device(it, featurize, sharding=sharding):
        es = eval_step(state, es, batch)
        n += 1
    loss = float(mean_compute(es.loss)) if n else float("nan")
    auroc = float(auroc_compute(es.auroc)) if n else float("nan")
    if es.exchange_overflow is not None and int(es.exchange_overflow) > 0:
        raise RuntimeError(
            f"{stage} eval dropped {int(es.exchange_overflow)} distinct ids "
            "past the alltoall bucket capacity — metrics would be computed "
            "on corrupted pooled embeddings; raise "
            "TrainConfig.exchange_capacity_factor (or use the dense exchange)"
        )
    return {f"{stage}_loss": loss, f"{stage}_auroc": auroc}


def _accumulate_overflow(total, out):
    """Lazily sum the alltoall exchange's dropped-id counts across steps
    (jax-array adds only — no device sync in the hot loop); checked once at
    epoch end by `_check_overflow`."""
    ovf = out.get("exchange_overflow")
    if ovf is None:
        return total
    ovf = ovf.sum() if getattr(ovf, "ndim", 0) else ovf
    return ovf if total is None else total + ovf


def _check_overflow(total, where: str) -> None:
    if total is not None and int(total) > 0:
        raise RuntimeError(
            f"{where}: the alltoall exchange dropped {int(total)} distinct "
            "ids past its bucket capacity this epoch — their embeddings did "
            "not train. This is a configuration error: raise "
            "TrainConfig.exchange_capacity_factor (or use "
            "sharded_exchange=\'dense\')."
        )


def train_one_epoch(
    state: TrainState,
    train_step: Callable,
    batches: Iterable[dict],
    featurizer: Featurizer,
    train_cfg: TrainConfig,
    eval_step: Callable | None = None,
    val_batches_factory: Callable[[], Iterable[dict]] | None = None,
    logger=None,
    epoch: int = 0,
    sharding=None,
    pad_multiple: int | None = None,
    pad_to: int | None = None,
) -> tuple[TrainState, dict[str, float]]:
    it = iter(batches)
    if train_cfg.limit_train_batches is not None:
        it = itertools.islice(it, train_cfg.limit_train_batches)

    steps = 0
    examples = 0
    t0 = time.perf_counter()
    last_loss = None
    overflow = None
    for batch in pipeline_lib.prefetch_to_device(it, featurizer, sharding=sharding):
        state, out = train_step(state, batch)
        last_loss = out["loss"]
        overflow = _accumulate_overflow(overflow, out)
        steps += 1
        examples += batch.batch_size
        if (
            train_cfg.validation_freq
            and eval_step is not None
            and val_batches_factory is not None
            and steps % train_cfg.validation_freq == 0
        ):
            metrics = evaluate(
                state, eval_step, val_batches_factory(), featurizer,
                train_cfg.limit_val_batches, "val", sharding, pad_multiple, pad_to,
            )
            log.info("epoch %d step %d mid-epoch %s", epoch, steps, metrics)
            if logger is not None:
                logger.log_metrics(metrics, step=int(state.step))
    if last_loss is not None:
        last_loss = float(jax.block_until_ready(last_loss))
    _check_overflow(overflow, f"epoch {epoch}")
    dt = time.perf_counter() - t0
    stats = {
        "train_steps": steps,
        "train_examples": examples,
        "train_loss": last_loss if last_loss is not None else float("nan"),
        "examples_per_sec": examples / dt if dt > 0 else 0.0,
        "epoch_time_s": dt,
    }
    return state, stats


def train_val_test(
    state: TrainState,
    train_step: Callable,
    eval_step: Callable,
    model_cfg: ModelConfig,
    train_cfg: TrainConfig,
    featurizer: Featurizer,
    train_batches_factory: Callable[[int], Iterable[dict]],
    val_batches_factory: Callable[[], Iterable[dict]],
    test_batches_factory: Callable[[], Iterable[dict]],
    logger=None,
    checkpoint_fn: Callable[[TrainState, int], None] | None = None,
    sharding=None,
    pad_multiple: int | None = None,
    pad_to: int | None = None,
    start_epoch: int = 0,
    train_epoch_fn: Callable | None = None,
    select_best: str | None = None,
    retrieval_eval_fn: Callable[[TrainState], dict[str, float]] | None = None,
) -> tuple[TrainState, dict[str, float]]:
    """`start_epoch` supports resume: epochs [start_epoch, epochs) run, so a
    run restored from a mid-training checkpoint continues instead of
    replaying from epoch 0.

    `train_epoch_fn(state, epoch) -> (state, stats)` swaps the inner epoch
    implementation (e.g. a `train_one_epoch_packed` closure) while keeping the
    baseline-eval / per-epoch-val / checkpoint orchestration here.

    `select_best` names a per-epoch val metric (e.g. "val_auroc"; a name
    containing "loss" means lower-is-better): the state of the BEST epoch is
    kept (on-device copy — donation invalidates the live buffers next epoch),
    the final test eval runs on it, and it is what's returned — the
    early-stopping/export-best role of the reference's Composer
    `save_folder`+`eval_interval` retention (`pytorch-model-training.py:
    563-611`).

    `retrieval_eval_fn(state) -> {"val_recall_at_100": ...}` (e.g.
    `evaluation.retrieval.make_retrieval_eval_fn`) merges retrieval metrics
    into every epoch's val metrics — and `select_best` may name one, since
    AUROC misleads for the in-batch sampled-softmax objective while recall@k
    is the reference's headline (`04_evaluate_retrieval.py:202-226`)."""
    results: dict[str, float] = {}
    best_state, best_metric, best_epoch = None, None, None

    def _improved(val):
        if best_metric is None:
            return True
        return val < best_metric if "loss" in select_best else val > best_metric

    metrics = evaluate(
        state, eval_step, val_batches_factory(), featurizer,
        train_cfg.limit_val_batches, "val", sharding, pad_multiple, pad_to,
    )
    if retrieval_eval_fn is not None:
        metrics.update(retrieval_eval_fn(state))
    log.info("baseline %s", metrics)
    results.update({f"baseline_{k}": v for k, v in metrics.items()})
    if logger is not None:
        logger.log_metrics(results, step=0)

    for epoch in range(start_epoch, train_cfg.epochs):
        if train_epoch_fn is not None:
            state, stats = train_epoch_fn(state, epoch)
        else:
            state, stats = train_one_epoch(
                state, train_step, train_batches_factory(epoch), featurizer, train_cfg,
                eval_step, val_batches_factory, logger, epoch, sharding, pad_multiple,
                pad_to,
            )
        metrics = evaluate(
            state, eval_step, val_batches_factory(), featurizer,
            train_cfg.limit_val_batches, "val", sharding, pad_multiple, pad_to,
        )
        if retrieval_eval_fn is not None:
            metrics.update(retrieval_eval_fn(state))
        log.info("epoch %d train %s val %s", epoch, stats, metrics)
        results.update(metrics)
        results.update({k: v for k, v in stats.items()})
        if logger is not None:
            logger.log_metrics({**stats, **metrics, "epoch": epoch}, step=int(state.step))
        if checkpoint_fn is not None and (epoch + 1) % train_cfg.checkpoint_every_epochs == 0:
            checkpoint_fn(state, epoch)
        if select_best is not None and _improved(metrics[select_best]):
            import jax

            best_metric, best_epoch = metrics[select_best], epoch
            best_state = jax.tree.map(lambda x: x.copy(), state)

    if best_state is not None:
        log.info("select_best: epoch %d (%s=%.5f)", best_epoch, select_best,
                 best_metric)
        results["best_epoch"] = float(best_epoch)
        state = best_state
    metrics = evaluate(
        state, eval_step, test_batches_factory(), featurizer,
        train_cfg.limit_test_batches, "test", sharding, pad_multiple, pad_to,
    )
    log.info("test %s", metrics)
    results.update(metrics)
    if logger is not None:
        logger.log_metrics(metrics, step=int(state.step))
    return state, results


def _macro_dims(mb) -> tuple[int, int]:
    """(K steps, B examples/step) of a stacked macro payload — PackedBatch
    (`ids_raw[K, B, S]`) or CompactBatch (`wire[K, W, B]`, batch axis last)."""
    if hasattr(mb, "wire"):
        return mb.wire.shape[0], mb.wire.shape[-1]
    return mb.ids_raw.shape[0], mb.ids_raw.shape[1]


def train_one_epoch_packed(
    state: TrainState,
    multi_step: Callable,
    batches: Iterable[dict],
    packed_featurizer,
    macro: int = 16,
    prefetch: int = 2,
    num_workers: int = 2,
    train_cfg: TrainConfig | None = None,
    tail_step: Callable | None = None,
    eval_step: Callable | None = None,
    val_batches_factory: Callable[[], Iterable[dict]] | None = None,
    val_featurizer: Featurizer | None = None,
    logger=None,
    epoch: int = 0,
    sharding=None,  # leaf -> NamedSharding for the [K, B, ...] macro payload
    tail_sharding=None,  # leaf -> NamedSharding for single tail batches
    val_sharding=None,
    pad_multiple: int | None = None,
    pad_to: int | None = None,
) -> tuple[TrainState, dict[str, float]]:
    """High-throughput epoch: packed device-side featurization + K-step
    macro-batches through `make_multi_step`, with the SAME feature surface as
    `train_one_epoch` (the reference's `train`, `03_model_training.py:568-630`):

    - `train_cfg.limit_train_batches` truncation,
    - mid-epoch validation every `train_cfg.validation_freq` steps (checked at
      macro boundaries — the packed analog of the reference's `batched(...)`
      chunking, `03_model_training.py:595-617`),
    - trailing partial macro: fed batch-by-batch through `tail_step` (e.g.
      `make_packed_train_step(...)`) instead of being dropped.

    `num_workers` featurizes+stacks macro groups concurrently (order kept)."""
    import jax

    from two_tower_recommender_model.train.step import stack_batches

    it = iter(batches)
    if train_cfg is not None and train_cfg.limit_train_batches is not None:
        it = itertools.islice(it, train_cfg.limit_train_batches)
    vfreq = train_cfg.validation_freq if train_cfg is not None else None
    can_validate = vfreq and eval_step is not None and val_batches_factory is not None

    tail: list = []

    def groups():
        g = []
        for cols in it:
            g.append(cols)
            if len(g) == macro:
                yield g
                g = []
        tail.extend(g)

    def assemble(group):
        return stack_batches([packed_featurizer(c) for c in group])

    def maybe_validate(state, steps, next_val):
        if not can_validate or steps < next_val:
            return next_val
        metrics = evaluate(
            state, eval_step, val_batches_factory(), val_featurizer or packed_featurizer,
            train_cfg.limit_val_batches, "val", val_sharding, pad_multiple, pad_to,
        )
        log.info("epoch %d step %d mid-epoch %s", epoch, steps, metrics)
        if logger is not None:
            logger.log_metrics(metrics, step=int(state.step))
        while next_val <= steps:
            next_val += vfreq
        return next_val

    steps = 0
    examples = 0
    next_val = vfreq or 0
    t0 = time.perf_counter()
    last_loss = None
    overflow = None
    for mb in pipeline_lib.prefetch_to_device(
        groups(), assemble, prefetch=prefetch, num_workers=num_workers,
        sharding=sharding,
    ):
        state, out = multi_step(state, mb)
        last_loss = out["loss"][-1]
        overflow = _accumulate_overflow(overflow, out)
        k, b = _macro_dims(mb)
        steps += k
        examples += k * b
        next_val = maybe_validate(state, steps, next_val)
    if tail and tail_step is not None:
        for cols in tail:
            pb = packed_featurizer(cols)
            # device_put_batch handles multi-host assembly (each process
            # contributes its local slice of the global batch)
            pb = pipeline_lib.device_put_batch(pb, tail_sharding)
            state, out = tail_step(state, pb)
            last_loss = out["loss"]
            overflow = _accumulate_overflow(overflow, out)
            steps += 1
            examples += pb.batch_size
            next_val = maybe_validate(state, steps, next_val)
    if last_loss is not None:
        last_loss = float(jax.block_until_ready(last_loss))
    _check_overflow(overflow, f"epoch {epoch}")
    dt = time.perf_counter() - t0
    return state, {
        "train_steps": steps,
        "train_examples": examples,
        "train_loss": last_loss if last_loss is not None else float("nan"),
        "examples_per_sec": examples / dt if dt > 0 else 0.0,
        "epoch_time_s": dt,
    }
