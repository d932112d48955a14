#!/usr/bin/env python
"""On-card smoke test of the two-tower trainer: one process, one GPU.

    python chip_smoke.py           # phases a-d on one card
    python chip_smoke.py --four    # phase e only, on four cards

a. The device: platform, kind, count, JAX version, XLA_FLAGS, the compile
   cache, and the card's name and power limit from `nvidia-smi`.
b. Training through `scripts/train.py`'s own `main`, at the flagship widths
   (206,209 users x 49,688 items, dim 128, towers [128, 64], BCE, row-wise
   Adagrad + Adam) on TTRS shards written from a seeded synthetic
   clickstream, on its default packed / sorted / compact path. Losses must
   be finite and the tables must move; prints the warm ms/step of the
   production macro step and its `memory_analysis()`.
c. One flagship train step from identical state and batch on the card (at
   "highest" matmul precision and at its default) and on JAX's CPU backend
   at "highest": the loss, logits and gradients against the CPU's, and the
   updated state (touched table rows, Adagrad accumulators, dense params)
   against the CPU applying the card's gradients; for f32, int8 and
   bf16-compute tables and the sampled-softmax loss.
d. Exact top-100 retrieval for 1,024 users over the trained 49,688-item
   corpus (`ops/topk.chunked_topk`) against a numpy float64 ranking.
e. `--four`: the sharded train step over the planner's row-sharded plan on
   four cards, with the dense and the all-to-all exchange, each compared
   with the single-card step on the same global batch.

Any failed check raises and the script exits non-zero. JAX must find a GPU;
on any other backend the script refuses to run. The last stdout line is one
JSON object: {"ok": true, "device": {"platform", "kind", "count"}}.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import shutil
import sys
import tempfile
import time
import traceback

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# Flagship widths and batches. The phase functions take sizes as arguments
# so that they can be rehearsed on the CPU at a tiny size.
NUM_USERS, NUM_ITEMS = 206_209, 49_688
TRAIN_BATCH = 65_536
TRAIN_BATCHES = 30
COMPARE_BATCH = 8_192
SOFTMAX_BATCH = 65_536
SOFTMAX_COMPARE_BATCH = 4_096
RETRIEVAL_USERS, TOP_K = 1_024, 100

# Bounds on the card-vs-CPU relative error (`_check` says which field is
# held element-wise, max |card - cpu| / max |cpu|, and which norm-wise).
# At "highest" both sides run f32 matmuls in full f32, so only summation
# order differs: 1e-5, for the gradients and, at every setting, for the
# update applied to the same gradients.
BOUND_HIGHEST = 1e-5
# At the default precision f32 matmuls run as TF32 (10-bit mantissa,
# u = 2**-11): loss, logits and the dense gradient hold 1e-2.
BOUND_REDUCED = 1e-2
# Per-example table gradients under TF32: a ReLU unit whose pre-activation
# lies within TF32's error of zero flips (about 1.6u = 8e-4 per unit and
# example once the embeddings have trained; at initialization the biases
# dominate and none flips), and each flip moves that example's row gradient
# by about one unit's share of it, ~1/8 over ~64 live units. With ~300
# units on the towers' paths, ~0.2 flips per example: sqrt(0.2) / 8 ~ 5e-2.
BOUND_TF32_TABLE_GRADS = 5e-2
# bf16 tower compute rounds activations to 8 mantissa bits (2**-9 = 2e-3
# relative rounding) at either precision setting: loss, logits and table
# gradients hold 1e-2.
BOUND_BF16 = 1e-2
# The dense gradient is a batch sum that nearly cancels once the towers fit
# the label mean (the synthetic labels hold nothing else to fit), so bf16
# rounding moves it far more than 2e-3: on the CPU the bf16 program's dense
# gradient lies ~0.16 from the f32 program's. The card rounds the same
# program at other points, which depend on the gemm algorithms autotuning
# picks: over six compiles of one step it read 0.85e-2 to 1.15e-2 from the
# CPU's, 0.054 to 0.073 of that distance. So it is held to a share of bf16's
# own error: at most a quarter of the CPU's bf16 distance to the f32 program.
BF16_DENSE_GRAD_SHARE = 0.25
# The sharded step reduces over four cards in another order than one card.
BOUND_SHARDED = 1e-4
# Train steps on the card before a comparison. At initialization the
# gradients are ill-conditioned: BCE's per-example gradients nearly cancel
# over the batch and the sampled softmax's in-batch candidates are nearly
# collinear, so rounding noise grows by the cancellation ratio.
COMPARE_WARM_STEPS = 3
# {precision: (bound, table-gradient bound)} for `compare_step`'s gradients.
F32_BOUNDS = {"highest": (BOUND_HIGHEST, None),
              None: (BOUND_REDUCED, BOUND_TF32_TABLE_GRADS)}
BF16_BOUNDS = {"highest": (BOUND_BF16, None), None: (BOUND_BF16, None)}


def log(msg: str) -> None:
    print(msg, flush=True)


def result_line(devices) -> str:
    """The script's last stdout line."""
    d = devices[0]
    return json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind, "count": len(devices)}})


def require_gpus(devices, count: int) -> None:
    """Refuse anything but `count` or more GPUs: no CPU fallback."""
    if not devices or devices[0].platform != "gpu":
        platform = devices[0].platform if devices else "none"
        raise SystemExit(f"chip_smoke needs a GPU; JAX found {platform!r}")
    if len(devices) < count:
        raise SystemExit(f"chip_smoke needs {count} GPUs; JAX found {len(devices)}")


def rel_err(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max(initial=0.0)), 1e-30)
    return float(np.abs(got - want).max(initial=0.0)) / scale


def flagship_config(num_users=NUM_USERS, num_items=NUM_ITEMS):
    from two_tower_recommender_model import config as cfg_lib

    return cfg_lib.two_tower_model_config(num_users, num_items, embedding_dim=128,
                                          layer_sizes=(128, 64))


def table_rows(mcfg) -> tuple[int, int]:
    return (mcfg.feature_table("user_id").num_embeddings,
            mcfg.feature_table("product_id").num_embeddings)


def synthetic(mcfg, seed: int):
    from two_tower_recommender_model.data import SyntheticClickstream

    users, items = table_rows(mcfg)
    return SyntheticClickstream(users - 1, items - 1, seed=seed)


# --------------------------------------------------------------- a. device


def phase_device(devices) -> str:
    import jax

    from two_tower_recommender_model.utils.compile_cache import enable_compile_cache
    from two_tower_recommender_model.utils.profiling import gpu_name_and_power_limit

    cache = enable_compile_cache()
    card = gpu_name_and_power_limit()
    d = devices[0]
    log(f"[a] platform={d.platform} kind={d.device_kind!r} count={len(devices)} "
        f"jax={jax.__version__}")
    log(f"[a] XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r} compile_cache={cache}")
    log(f"[a] card (name, power limit): {card}")
    return card


# --------------------------------------------------------------- b. train


def write_shards(root: str, mcfg, batch: int, train_batches: int,
                 eval_batches: int = 2) -> None:
    from two_tower_recommender_model.data.shards import write_dataset

    ds = synthetic(mcfg, seed=0)
    for split, n in (("train", train_batches), ("val", eval_batches),
                     ("test", eval_batches)):
        write_dataset(os.path.join(root, split), ds.sample(n * batch, split=split),
                      rows_per_shard=1 << 19)


def load_train_cli():
    import importlib.util

    sys.path.insert(0, os.path.join(REPO, "scripts"))
    spec = importlib.util.spec_from_file_location(
        "train_cli", os.path.join(REPO, "scripts", "train.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_train(work: str, card: str, mcfg, batch=TRAIN_BATCH,
                train_batches=TRAIN_BATCHES, macro=8, timed_dispatches=5):
    """Train `mcfg`'s widths through the CLI; returns the final state."""
    import jax

    from two_tower_recommender_model import config as cfg_lib
    from two_tower_recommender_model.data.loader import StreamLoader
    from two_tower_recommender_model.train.step import create_train_state, stack_batches

    num_users, num_items = table_rows(mcfg)
    t0 = time.perf_counter()
    data = os.path.join(work, "data")
    write_shards(data, mcfg, batch, train_batches)
    log(f"[b] wrote {train_batches} x {batch} train rows in "
        f"{time.perf_counter() - t0:.1f} s")

    cli = load_train_cli()
    argv = ["--data-dir", data, "--num-users", str(num_users),
            "--num-items", str(num_items), "--batch-size", str(batch),
            "--epochs", "1", "--macro-batches", str(macro),
            "--limit-train-batches", str(train_batches),
            "--limit-val-batches", "2", "--limit-test-batches", "2",
            "--runs-root", os.path.join(work, "runs")]
    t0 = time.perf_counter()
    run = cli.main(argv)
    log(f"[b] scripts/train.py main: {time.perf_counter() - t0:.1f} s, compile included")
    res = run["results"]
    for key in ("train_loss", "val_loss", "test_loss"):
        if not np.isfinite(res[key]):
            raise AssertionError(f"{key} is not finite: {res[key]}")
    log(f"[b] train_loss={res['train_loss']:.5f} val_loss={res['val_loss']:.5f} "
        f"val_auroc={res['val_auroc']:.4f} steps={res['train_steps']}")

    state = run["state"]
    # the CLI builds its state from key(--seed=0) on the same device
    init, _ = create_train_state(jax.random.key(0), mcfg, cfg_lib.TrainConfig())
    for name, table in state.tables.items():
        new, old = np.asarray(table), np.asarray(init.tables[name])
        if not np.isfinite(new).all():
            raise AssertionError(f"table {name} holds non-finite values")
        moved = int((new != old).any(axis=1).sum())
        if moved == 0:
            raise AssertionError(f"table {name} did not change")
        log(f"[b] table {name}: {moved} of {new.shape[0]} rows changed")

    # warm ms/step of the compiled macro step the epoch loop dispatched
    step, featurizer = run["macro_step"], run["featurizer"]
    loader = StreamLoader(os.path.join(data, "train"), batch, seed=1)
    cols = [c for _, c in zip(range(macro), loader)]
    mb = jax.device_put(stack_batches([featurizer(c) for c in cols]))
    mem = step.lower(state, mb).compile().memory_analysis()
    state, out = step(state, mb)
    jax.block_until_ready(out["loss"])
    times = []
    for _ in range(timed_dispatches):
        t0 = time.perf_counter()
        state, out = step(state, mb)
        jax.block_until_ready(out["loss"])
        times.append(time.perf_counter() - t0)
    if not np.isfinite(np.asarray(out["loss"])).all():
        raise AssertionError("non-finite loss in the timed dispatches")
    ms = sorted(times)[len(times) // 2] / macro * 1e3
    log(f"[b] warm macro step (K={macro}, bs={batch}): {ms:.3f} ms/step median of "
        f"{timed_dispatches} dispatches, all "
        f"{[round(t / macro * 1e3, 3) for t in times]} ms/step; card: {card}")
    log(f"[b] memory_analysis: {mem}")
    return state


# --------------------------------------------------------------- c. compare


def _touched_rows(mcfg, batch) -> dict:
    """{table: (row ids touched once, row ids touched by several slots)}."""
    rows: dict = {}
    for fc in mcfg.features:
        feat = batch.features[fc.name]
        ids = np.asarray(feat.ids)[np.asarray(feat.mask) > 0]
        rows.setdefault(fc.table, []).append(ids)
    out = {}
    for t, v in rows.items():
        ids, counts = np.unique(np.concatenate(v), return_counts=True)
        out[t] = (ids[counts == 1], ids[counts > 1])
    return out


def norm_err(got, want) -> float:
    """Norm-wise relative error ||got - want|| / ||want||."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want)) / max(float(np.linalg.norm(want)), 1e-30)


def _errors(pairs: dict) -> dict:
    """{field: (element-wise, norm-wise) relative error}."""
    return {k: (rel_err(g, w), norm_err(g, w)) for k, (g, w) in pairs.items()}


def _leaves(tree) -> np.ndarray:
    import jax

    return np.concatenate([np.ravel(x) for x in jax.tree.leaves(tree)])


def _grad_errors(mcfg, got, want) -> dict:
    """Errors of one step's forward outputs and gradients: loss, logits, the
    dense gradient, each table's per-slot gradients, and their float64 sums
    over the rows that several slots touch."""
    g, w = got["grads"], want["grads"]
    pairs = {"loss": (got["loss"], want["loss"]),
             "logits": (got["logits"], want["logits"]),
             "dense_grad": (_leaves(g["d_dense"]), _leaves(w["d_dense"]))}
    for name, (ids, slot) in g["table_grads"].items():
        ids = np.asarray(ids)
        live = ids < mcfg.table(name).num_embeddings
        slot, slot_w = np.asarray(slot)[live], np.asarray(w["table_grads"][name][1])[live]
        pairs[f"{name}.slot_grads"] = (slot, slot_w)
        rows, inv, counts = np.unique(ids[live], return_inverse=True, return_counts=True)
        summed = [np.zeros((len(rows), slot.shape[1])) for _ in range(2)]
        for acc, x in zip(summed, (slot, slot_w)):
            np.add.at(acc, inv, x.astype(np.float64))
        pairs[f"{name}.aggregated_grads"] = tuple(s[counts > 1] for s in summed)
    return _errors(pairs)


def _state_errors(mcfg, batch, got, want) -> dict:
    """Errors of an updated state: the touched table rows (rows touched once
    and rows several slots touch apart), Adagrad accumulators and dense
    params; int8 tables add their scales and `int8_steps`, the largest
    difference of stored values."""
    from two_tower_recommender_model.ops.quantized import QuantizedTable, dequantize_table

    pairs, steps = {}, {}
    for name, (single, multi) in _touched_rows(mcfg, batch).items():
        rows = np.concatenate([single, multi])
        gt, wt = got.tables[name], want.tables[name]
        if isinstance(wt, QuantizedTable):
            steps[f"{name}.int8_steps"] = int(np.abs(
                np.asarray(gt.values)[rows].astype(np.int32)
                - np.asarray(wt.values)[rows].astype(np.int32)).max(initial=0))
            gsc, wsc = np.asarray(gt.scales), np.asarray(wt.scales)
            pairs[f"{name}.scales"] = (gsc[single], wsc[single])
            pairs[f"{name}.aggregated_scales"] = (gsc[multi], wsc[multi])
            gt, wt = np.asarray(dequantize_table(gt)), np.asarray(dequantize_table(wt))
            kind = "dequantized_rows"
        else:
            gt, wt = np.asarray(gt), np.asarray(wt)
            kind = "rows"
        pairs[f"{name}.{kind}"] = (gt[single], wt[single])
        pairs[f"{name}.aggregated_{kind}"] = (gt[multi], wt[multi])
        pairs[f"{name}.adagrad"] = (np.asarray(got.adagrad_acc[name])[rows],
                                    np.asarray(want.adagrad_acc[name])[rows])
    pairs["dense_params"] = (_leaves(got.dense_params), _leaves(want.dense_params))
    errs = _errors(pairs)
    errs.update({k: (float(v), float(v)) for k, v in steps.items()})
    return errs


def _check(label: str, errs: dict, bound: float, table_grad_bound: float | None = None,
           int8_steps: int | None = None, dense_grad_bound: float | None = None) -> None:
    """Hold every field to `bound`: loss and logits element-wise, the rest
    norm-wise (element-wise maxima are printed beside them). Table gradients
    hold `table_grad_bound` and the dense gradient `dense_grad_bound` where
    they are given. int8 stored values are held within `int8_steps` of each
    other, and their dequantized rows are then printed only."""
    log(f"{label}: bound {bound:g}"
        + (f", table gradients {table_grad_bound:g}" if table_grad_bound else "")
        + (f", dense gradient {dense_grad_bound:.3g}" if dense_grad_bound else "")
        + " (loss, logits element-wise; the rest norm-wise); element-wise/norm-wise: "
        + ", ".join(f"{k}={e:.3g}/{n:.3g}" for k, (e, n) in errs.items()))
    for key, (elem, norm) in errs.items():
        field = key.rsplit(".", 1)[-1]
        if field == "int8_steps":
            held, err = int8_steps, elem
        elif field.endswith("dequantized_rows") and int8_steps is not None:
            continue
        elif field.endswith("_grads") and table_grad_bound is not None:
            held, err = table_grad_bound, norm
        elif field == "dense_grad" and dense_grad_bound is not None:
            held, err = dense_grad_bound, norm
        else:
            held, err = bound, (elem if field in ("loss", "logits") else norm)
        if held is not None and not err <= held:
            raise AssertionError(f"{label}: {key} error {err:.3g} over {held:g}")


def compare_inputs(mcfg, tcfg, batch_size: int, gpu, cpu, seed: int = 0,
                   warm_steps: int = COMPARE_WARM_STEPS):
    """(state, batch, dense optimizer) for a card-vs-CPU comparison. The state
    is built once on the CPU and copied to both sides (jax.random differs
    across backends), after `warm_steps` train steps on the card at "highest"
    precision over other batches of the same stream."""
    import jax

    from two_tower_recommender_model.data import Featurizer
    from two_tower_recommender_model.train.step import create_train_state, make_train_step

    with jax.default_device(cpu):
        state, dense_opt = create_train_state(jax.random.key(seed), mcfg, tcfg)
    ds, feat = synthetic(mcfg, seed + 1), Featurizer(mcfg)
    if warm_steps:
        step = make_train_step(mcfg, tcfg, dense_opt)
        state = jax.device_put(jax.device_get(state), gpu)
        with jax.default_matmul_precision("highest"):
            for i in range(warm_steps):
                state, _ = step(state, jax.device_put(
                    feat(ds.sample(batch_size, start=i + 1)), gpu))
    return jax.device_get(state), feat(ds.sample(batch_size)), dense_opt


def compare_errors(mcfg, tcfg, state, batch, dense_opt, gpu, cpu,
                   precisions=("highest", None)) -> dict:
    """{precision: (gradient errors, update errors)} from one train step on
    the card at each matmul precision (None = the card's default).
    Gradients: the card's against the CPU's at "highest". Update: the card's
    new state against the CPU applying the card's own gradients to the same
    state, which holds the update alone (scatter-add or sorted segment sum,
    row-wise Adagrad, Adam) whatever the gradients' conditioning."""
    import jax

    from two_tower_recommender_model.train.step import make_apply_gradients, make_train_step

    step = make_train_step(mcfg, tcfg, dense_opt, donate=False, with_grads=True)
    apply = jax.jit(make_apply_gradients(mcfg, tcfg, dense_opt))

    def run(fn, device, *args, precision="highest"):
        ctx = (jax.default_matmul_precision(precision) if precision
               else contextlib.nullcontext())
        with ctx:
            return jax.device_get(fn(*(jax.device_put(a, device) for a in args)))

    _, ref = run(step, cpu, state, batch)
    errs = {}
    for p in precisions:
        new, got = run(step, gpu, state, batch, precision=p)
        expected = run(apply, cpu, state, got["grads"])
        errs[p] = (_grad_errors(mcfg, got, ref),
                   _state_errors(mcfg, batch, new, expected))
    return errs


def bf16_dense_grad_error(mcfg, tcfg, state, batch, dense_opt, cpu) -> float:
    """Norm-wise distance, on the CPU at "highest", of the bf16-compute
    program's dense gradient from the f32 program's, from the same state and
    batch: how far bf16 rounding itself moves it."""
    import jax

    from two_tower_recommender_model.train.step import make_train_step

    grads = []
    for dtype in ("bfloat16", "float32"):
        step = make_train_step(dataclasses.replace(mcfg, compute_dtype=dtype), tcfg,
                               dense_opt, donate=False, with_grads=True)
        with jax.default_matmul_precision("highest"):
            _, out = step(*(jax.device_put(a, cpu) for a in (state, batch)))
        grads.append(_leaves(jax.device_get(out["grads"]["d_dense"])))
    return norm_err(*grads)


def compare_step(label: str, mcfg, tcfg, batch_size: int, gpu, cpu,
                 bounds: dict, int8_steps: int | None = None,
                 dense_grad_share: float | None = None) -> None:
    """One train step from identical state and batch on the card at "highest"
    and at its default precision, against the CPU (see `compare_errors`).
    `bounds[precision]` = (bound, table-gradient bound | None) for the
    gradients; with `dense_grad_share` the dense gradient is held instead to
    that share of `bf16_dense_grad_error`. The update holds BOUND_HIGHEST at
    every precision."""
    inputs = compare_inputs(mcfg, tcfg, batch_size, gpu, cpu)
    errs = compare_errors(mcfg, tcfg, *inputs, gpu, cpu)
    dense_grad_bound = None
    if dense_grad_share is not None:
        own = bf16_dense_grad_error(mcfg, tcfg, *inputs, cpu)
        dense_grad_bound = dense_grad_share * own
        log(f"[c] {label} bs={batch_size}: bf16 vs f32 program on the CPU, dense "
            f"gradient {own:.3g} norm-wise; held at {dense_grad_share:g} of it")
    for precision, (grad_errs, update_errs) in errs.items():
        name = f"[c] {label} bs={batch_size} card@{precision or 'default'}"
        _check(f"{name} vs cpu@highest, gradients", grad_errs, *bounds[precision],
               dense_grad_bound=dense_grad_bound)
        _check(f"{name}, update vs cpu applying the card's gradients", update_errs,
               BOUND_HIGHEST, int8_steps=int8_steps)


def phase_compare(gpu, cpu, mcfg, batch=COMPARE_BATCH, softmax_batch=SOFTMAX_BATCH,
                  softmax_compare=SOFTMAX_COMPARE_BATCH) -> None:
    import jax

    from two_tower_recommender_model import config as cfg_lib
    from two_tower_recommender_model.data import Featurizer
    from two_tower_recommender_model.models.losses import _auto_row_chunk
    from two_tower_recommender_model.train.step import create_train_state, make_train_step

    bce = cfg_lib.TrainConfig(sparse_learning_rate=0.05, learning_rate=1e-3)
    compare_step("f32 tables", mcfg, bce, batch, gpu, cpu, F32_BOUNDS)
    # int8: the update holds stored values within one step of each other,
    # since requantization rounds to nearest
    compare_step("int8 tables", dataclasses.replace(mcfg, table_dtype="int8"), bce,
                 batch, gpu, cpu, F32_BOUNDS, int8_steps=1)
    # at "highest" XLA lowers the bf16 tower matmuls to cuBLAS with f32
    # outputs and, allowed excess precision, drops some of the program's
    # f32 -> bf16 -> f32 roundings: the card then differs from the CPU at
    # bf16 level (with --xla_allow_excess_precision=false it agrees to 1e-4)
    compare_step("bf16 compute", dataclasses.replace(mcfg, compute_dtype="bfloat16"),
                 bce, batch, gpu, cpu, BF16_BOUNDS, dense_grad_share=BF16_DENSE_GRAD_SHARE)
    sm = cfg_lib.TrainConfig(sparse_learning_rate=0.05, learning_rate=1e-3,
                             loss="sampled_softmax", softmax_temperature=0.7)
    compare_step("sampled softmax", mcfg, sm, softmax_compare, gpu, cpu, F32_BOUNDS)
    # the chunked scan path the large batch below runs, compared at 2x the
    # dense path's limit
    assert _auto_row_chunk(2 * softmax_compare) is not None
    compare_step("sampled softmax (scan path)", mcfg, sm, 2 * softmax_compare,
                 gpu, cpu, F32_BOUNDS)

    # the scan path at the softmax cell's batch, on the card only
    assert _auto_row_chunk(softmax_batch) is not None
    with jax.default_device(gpu):
        state, opt = create_train_state(jax.random.key(3), mcfg, sm)
        step = make_train_step(mcfg, sm, opt)
        ds, feat = synthetic(mcfg, seed=4), Featurizer(mcfg)
        batches = [jax.device_put(feat(ds.sample(softmax_batch, start=i)), gpu)
                   for i in range(5)]
        # two warm steps: the first takes an uncommitted state, the rest the
        # committed one the step returns, and each compiles once
        for b in batches[:2]:
            state, out = step(state, b)
        jax.block_until_ready(out["loss"])
        batches = batches[2:]
        t0 = time.perf_counter()
        outs = []
        for b in batches:
            state, out = step(state, b)
            outs.append(out["loss"])
        jax.block_until_ready(outs)
        ms = (time.perf_counter() - t0) / len(outs) * 1e3
    losses = [float(v) for v in outs]
    if not np.isfinite(losses).all():
        raise AssertionError(f"sampled softmax bs={softmax_batch}: losses {losses}")
    log(f"[c] sampled softmax bs={softmax_batch} scan path on the card: losses "
        f"{[round(v, 5) for v in losses]}, {ms:.2f} ms/step over {len(outs)} steps "
        "with device-resident batches")


# --------------------------------------------------------------- d. retrieval


def phase_retrieval(state, mcfg, n_users=RETRIEVAL_USERS, k=TOP_K) -> None:
    import jax
    import jax.numpy as jnp

    from two_tower_recommender_model.evaluation.retrieval import export_feature_embeddings
    from two_tower_recommender_model.ops.topk import chunked_topk
    from two_tower_recommender_model.train.step import full_params

    params = jax.device_get(full_params(state))
    corpus = export_feature_embeddings(params, mcfg, "product_id")
    users = export_feature_embeddings(params, mcfg, "user_id",
                                      ids=np.arange(1, n_users + 1))
    if not (np.isfinite(corpus).all() and np.isfinite(users).all()):
        raise AssertionError("non-finite exported embeddings")
    with jax.default_matmul_precision("highest"):
        vals, idx = chunked_topk(jnp.asarray(users), jnp.asarray(corpus), k=k)
    vals, idx = np.asarray(vals), np.asarray(idx)
    exact, worst = 0, 0.0
    for lo in range(0, n_users, 128):
        scores = users[lo:lo + 128].astype(np.float64) @ corpus.astype(np.float64).T
        ref = np.argsort(-scores, axis=1, kind="stable")[:, :k]
        for r in range(scores.shape[0]):
            q = lo + r
            got_i = idx[q]
            if len(np.unique(got_i)) != k:
                raise AssertionError(f"user {q}: duplicate indices in top-{k}")
            kth = scores[r, ref[r, -1]]
            tol = 1e-5 * max(abs(scores[r, ref[r, 0]]), 1e-30)
            if (scores[r, got_i] < kth - tol).any():
                raise AssertionError(f"user {q}: an index below the {k}th score")
            worst = max(worst, float(np.abs(vals[q] - scores[r, got_i]).max())
                        / max(abs(scores[r, ref[r, 0]]), 1e-30))
            exact += int(set(got_i.tolist()) == set(ref[r].tolist()))
    if worst > 1e-5:
        raise AssertionError(f"top-{k} scores off by {worst:.3g} relative")
    log(f"[d] top-{k} over {corpus.shape[0]} x {corpus.shape[1]} corpus for "
        f"{n_users} users: {exact} identical index sets, the rest equal up to "
        f"ties; max score rel err {worst:.3g}")


# --------------------------------------------------------------- e. four cards


def phase_sharded(devices, mcfg, batch=TRAIN_BATCH) -> None:
    import jax

    from two_tower_recommender_model import config as cfg_lib
    from two_tower_recommender_model.data import Featurizer
    from two_tower_recommender_model.parallel import (
        batch_sharding, make_mesh, make_sharded_train_step, plan_sharding,
        shard_train_state,
    )
    from two_tower_recommender_model.parallel.planner import ROW_SHARDED
    from two_tower_recommender_model.parallel.sharded import unshard_train_state
    from two_tower_recommender_model.train.step import create_train_state, make_train_step

    n = len(devices)
    mesh = make_mesh(n, 1, devices=devices)
    if set(mesh.devices.flat) != set(devices):
        raise AssertionError(f"mesh {mesh.devices} does not span {devices}")
    plan = plan_sharding(mcfg, n, force={t.name: ROW_SHARDED for t in mcfg.tables})
    log(plan.describe())
    cpu = jax.devices("cpu")[0]
    batch_host = Featurizer(mcfg)(synthetic(mcfg, seed=11).sample(batch))

    for exchange in ("dense", "alltoall"):
        tcfg = cfg_lib.TrainConfig(sparse_learning_rate=0.05, learning_rate=1e-3,
                                   sharded_exchange=exchange)
        with jax.default_device(cpu):
            state, opt = create_train_state(jax.random.key(0), mcfg, tcfg)
        state = jax.device_get(state)
        with jax.default_matmul_precision("highest"):
            ref = jax.device_get(make_train_step(mcfg, tcfg, opt, donate=False)(
                jax.device_put(state, devices[0]), jax.device_put(batch_host, devices[0])))
            sh_state = shard_train_state(state, plan, mesh)
            for name, arr in sh_state.tables.items():
                shards = arr.addressable_shards
                on = {s.device for s in shards}
                rows = {s.data.shape[0] for s in shards}
                if on != set(devices) or len(rows) != 1 or len(shards) != n:
                    raise AssertionError(
                        f"table {name} shards: devices {on}, row counts {rows}")
            sh = batch_sharding(mesh)
            batch_sh = jax.tree.map(lambda x: jax.device_put(x, sh(x)), batch_host)
            if {s.device for s in batch_sh.labels.addressable_shards} != set(devices):
                raise AssertionError("the batch does not span the mesh")
            step = make_sharded_train_step(mcfg, tcfg, opt, mesh, plan, donate=False)
            new, out = step(sh_state, batch_sh)
            jax.block_until_ready(out["loss"])
            t0 = time.perf_counter()
            for _ in range(3):
                _, o = step(sh_state, batch_sh)
                jax.block_until_ready(o["loss"])
            ms = (time.perf_counter() - t0) / 3 * 1e3
        overflow = int(out.get("exchange_overflow", 0))
        if overflow:
            raise AssertionError(f"{exchange}: exchange_overflow={overflow}")
        got, out = unshard_train_state(new, plan, mcfg), jax.device_get(out)
        errs = _errors({"loss": (out["loss"], ref[1]["loss"]),
                        "logits": (out["logits"], ref[1]["logits"])})
        errs.update(_state_errors(mcfg, batch_host, got, ref[0]))
        _check(f"[e] {exchange} exchange, {n} cards, bs={batch} vs one card "
               f"(overflow {overflow}, {ms:.2f} ms/step at highest precision)",
               errs, BOUND_SHARDED)


# --------------------------------------------------------------- main


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the sharded step on four cards")
    args = ap.parse_args(argv)

    import jax

    devices = jax.devices()
    require_gpus(devices, 4 if args.four else 1)
    card = phase_device(devices)
    mcfg = flagship_config()
    if args.four:
        devices = devices[:4]
        phase_sharded(devices, mcfg)
    else:
        devices = devices[:1]
        work = tempfile.mkdtemp(prefix="chip_smoke_")
        try:
            state = phase_train(work, card, mcfg)
            phase_compare(devices[0], jax.devices("cpu")[0], mcfg)
            phase_retrieval(state, mcfg)
        finally:
            shutil.rmtree(work, ignore_errors=True)
    log(card)  # as nvidia-smi gives it, on the line before the result
    print(result_line(devices), flush=True)


if __name__ == "__main__":
    try:
        main()
    except SystemExit as e:
        if not isinstance(e.code, int):
            print(e.code, file=sys.stderr, flush=True)
        sys.stdout.flush()
        os._exit(e.code if isinstance(e.code, int) else 1)
    except BaseException:
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)
    sys.stdout.flush()
    os._exit(0)
