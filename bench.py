"""Headline benchmark: two-tower training throughput (examples/s) on one GPU.

Reference baseline (BASELINE.md): the TorchRec stack trains the 26M-sample
Instacart set in ~16 min/epoch on one A10 => ~27k examples/s
(`03_model_training.py:866`). Same model here: 206k-user / 50k-item tables,
dim 128, towers [128, 64], BCE loss, fused row-wise Adagrad (sparse) + Adam
(dense) — measured end-to-end including host featurization and H2D transfer
via the prefetching pipeline.

Methodology:
1. the reported value is the MEDIAN of >=5 timed windows, each ended by
   `block_until_ready`; the full per-window list is in the record;
2. a roofline guard models bytes/step and FLOPs/step and REFUSES to report
   any number whose implied bandwidth or FLOP rate exceeds the card's
   published peaks (`PEAKS`, keyed by `device_kind`);
3. the per-window training loss must decrease from the first to the last
   window (proof the steps actually executed);
4. a from-disk epoch (TTRS shards -> StreamLoader -> packed train) is
   measured alongside, so the hot-loop number can be reconciled with the
   end-to-end pipeline number in one place.

Runs on a GPU only: with no GPU it exits non-zero. Prints the card's name
and power limit, then ONE JSON line; "metric"/"value"/"unit"/"vs_baseline"
lead, diagnostics follow. `BENCH_RECORD=<path>` also writes the full record.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import os
import sys
import time

BASELINE_EXAMPLES_PER_SEC = 27_000.0  # 1x A10, derived in BASELINE.md

# Published dense peaks per card, keyed by `jax.devices()[0].device_kind`
# (NVIDIA H100 SXM data sheet). The rates hold at the card's full power
# limit; a card capped lower (nvidia-smi's power.limit) cannot reach them, so
# every share of peak is recorded beside the card's own limit.
PEAKS_POWER_LIMIT_W = 700
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "bf16_flops": 989e12,
        "tf32_flops": 495e12,
        "f32_flops": 67e12,
        "hbm_bytes_per_s": 3.35e12,
    },
}

N_USERS, N_ITEMS = 206_209, 49_688
EMBED_DIM = 128
LAYERS = (128, 64)


def device_peaks(device_kind: str) -> dict:
    """The published peaks of one card. A kind that is not in `PEAKS` (a CPU
    included) is an error, never a default."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise ValueError(
            f"no published peaks for device kind {device_kind!r}; add its "
            "data-sheet rates to bench.PEAKS") from None


def roofline_model(batch_size: int, table_dtype: str, wire_bytes: float = 8.0) -> dict:
    """Modeled per-example device-memory bytes and matmul FLOPs for the
    flagship step.

    Bytes (per sparse feature, D=128): forward gather reads one row; the
    fused update reads + writes the touched row and its f32 accumulator
    scalar. int8 adds a per-row scale read+write. Tower activations/params
    are small and mostly fused; the id transfer is `wire_bytes`/example
    (8 packed int32, 4.375 compact bit-packed).
    FLOPs: two towers, fwd+bwd ~= 3x fwd.
    """
    tb = {"float32": 4, "bfloat16": 2, "int8": 1}[table_dtype]
    n_feat = 2
    gather = n_feat * EMBED_DIM * tb            # fwd row read
    update = n_feat * 2 * EMBED_DIM * tb        # row read + write
    acc = n_feat * 2 * 4                        # accumulator read + write (f32)
    scales = n_feat * 2 * 4 if table_dtype == "int8" else 0
    bytes_ex = gather + update + acc + scales + wire_bytes

    def tower_flops(in_dim):
        f, d = 0, in_dim
        for out in LAYERS:
            f += 2 * d * out
            d = out
        return f

    flops_ex = 2 * 3 * tower_flops(EMBED_DIM)  # 2 towers, fwd+bwd ~ 3x fwd
    return {"bytes_per_example": bytes_ex, "flops_per_example": flops_ex}


def check_roofline(eps: float, model: dict, label: str, peaks: dict,
                   compute_dtype: str = "float32") -> dict:
    """Implied rates of a measured examples/s against the card's peaks. f32
    tower matmuls may run as TF32 at JAX's default precision, so their FLOP
    bound is the TF32 peak. `peaks["card"]`, when given, is the card's name
    and power limit, recorded beside the shares."""
    flops_peak = peaks["bf16_flops" if compute_dtype == "bfloat16" else "tf32_flops"]
    implied_bw = eps * model["bytes_per_example"]
    implied_flops = eps * model["flops_per_example"]
    out = {
        **model,
        "implied_gb_per_sec": round(implied_bw / 1e9, 1),
        "implied_tflop_per_sec": round(implied_flops / 1e12, 2),
        "hbm_peak_gb_per_sec": peaks["hbm_bytes_per_s"] / 1e9,
        "flops_peak_tflop_per_sec": flops_peak / 1e12,
        "hbm_share_of_peak": round(implied_bw / peaks["hbm_bytes_per_s"], 4),
        "peaks_at_power_limit_w": PEAKS_POWER_LIMIT_W,
        "card": peaks.get("card"),
    }
    if implied_bw > peaks["hbm_bytes_per_s"] or implied_flops > flops_peak:
        raise RuntimeError(
            f"{label}: measured {eps:.3g} ex/s implies "
            f"{implied_bw/1e9:.0f} GB/s / {implied_flops/1e12:.1f} TFLOP/s — "
            f"over the card's peak ({peaks['hbm_bytes_per_s']/1e9:.0f} GB/s / "
            f"{flops_peak/1e12:.0f} TFLOP/s). Refusing to report a "
            "physically impossible number (measurement artifact)."
        )
    return out


def _median(xs):
    s = sorted(xs)
    n = len(s)
    return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])


def parse_variant(spec: str) -> tuple[str, bool, bool, bool, bool]:
    """'float32+sorted+compact+delta' -> (dtype, sorted, bf16 buffer,
    compact wire, delta wire). '+delta' delta-encodes the sorted slot on the
    compact wire (implies sorted+compact; 3.125 B/example flagship vs
    4.375)."""
    parts = spec.split("+")
    delta = "delta" in parts[1:]
    return (parts[0], "sorted" in parts[1:] or delta,
            "bf16buf" in parts[1:], "compact" in parts[1:] or delta, delta)


def variant_compute_dtype(spec: str) -> str:
    """'+bf16compute' runs the tower matmuls in bfloat16 (params stay f32;
    non-exact vs f32 towers)."""
    return "bfloat16" if "bf16compute" in spec.split("+")[1:] else "float32"


def _model_config(variant: str):
    from two_tower_recommender_model import config as cfg_lib

    mcfg = cfg_lib.two_tower_model_config(
        num_users=N_USERS, num_items=N_ITEMS, embedding_dim=EMBED_DIM,
        layer_sizes=LAYERS, compute_dtype=variant_compute_dtype(variant),
    )
    table_dtype = parse_variant(variant)[0]
    if table_dtype != "float32":
        mcfg = dataclasses.replace(mcfg, table_dtype=table_dtype)
    return mcfg


def measure_hot_loop(variant: str, batch_size: int, macro: int, windows: int,
                     per_window: int, peaks: dict, warmup: int = 3) -> dict:
    """Chained-state macro-batch training over a pool of host payloads.

    `variant` is `<table_dtype>[+sorted][+bf16buf][+compact][+delta]
    [+bf16compute]`: `+sorted` host-sorts each batch by the user feature's
    hashed id and enables the `indices_are_sorted` scatter fast path for the
    user table (identical numerics, DESIGN §6c); `+bf16buf` additionally
    aggregates that table's transient gradient buffer in bf16
    (reduced-precision duplicate accumulation, opt-in); `+compact` ships the
    bit-packed compact wire format (4.375 B/example vs 8 — identical
    numerics, DESIGN §6d); `+delta` additionally delta-encodes the sorted
    slot (3.125 B/example — identical numerics, implies sorted+compact)."""
    import jax

    from two_tower_recommender_model import config as cfg_lib
    from two_tower_recommender_model.data import SyntheticClickstream
    from two_tower_recommender_model.data.compact import (
        CompactFeaturizer,
        CompactScheme,
        batch_from_compact,
    )
    from two_tower_recommender_model.data.device_featurizer import (
        PackedFeaturizer,
        unpack_batch,
    )
    from two_tower_recommender_model.train.pipeline import prefetch_to_device
    from two_tower_recommender_model.train.step import (
        create_train_state,
        make_multi_step,
        make_train_step,
        stack_batches,
    )

    table_dtype, sort, bf16buf, compact, delta = parse_variant(variant)
    mcfg = _model_config(variant)
    tcfg = cfg_lib.TrainConfig(
        batch_size=batch_size,
        sorted_feature="user_id" if sort else None,
        scatter_buffer_dtype="bfloat16" if bf16buf else "float32",
    )
    ds = SyntheticClickstream(num_users=N_USERS, num_items=N_ITEMS, seed=0,
                              noise=0.05, latent_dim=4)
    featurizer = PackedFeaturizer(mcfg, pack_label=True,
                                  sort_feature="user_id" if sort else None)

    state, dense_opt = create_train_state(jax.random.key(0), mcfg, tcfg)
    core = make_train_step(mcfg, tcfg, dense_opt, donate=False, jit=False)
    if compact:
        scheme = CompactScheme.from_model(
            mcfg, pack_label=True,
            delta_feature="user_id" if delta else None)
        featurizer = CompactFeaturizer(featurizer, scheme)
        train_step = make_multi_step(
            lambda s, cb: core(s, batch_from_compact(cb, mcfg, scheme))
        )
        wire_bytes = scheme.wire_bytes_per_example
    else:
        train_step = make_multi_step(
            lambda s, pb: core(s, unpack_batch(pb, mcfg, pack_label=True))
        )
        wire_bytes = 8.0

    n_macros = warmup + windows * per_window
    pool = [featurizer(ds.sample(batch_size, start=i)) for i in range(macro + 5)]

    def macro_stream():
        it = itertools.cycle(pool)
        for _ in range(n_macros):
            yield stack_batches([next(it) for _ in range(macro)])

    window_times, window_losses = [], []
    n = 0
    t0 = None
    for mb in prefetch_to_device(macro_stream(), lambda x: x, prefetch=3):
        state, out = train_step(state, mb)
        n += 1
        if n >= warmup and (n - warmup) % per_window == 0:
            loss = float(jax.block_until_ready(out["loss"]).mean())
            now = time.perf_counter()
            if t0 is not None:
                window_times.append(now - t0)
                window_losses.append(round(loss, 5))
            t0 = now
    window_eps = [per_window * macro * batch_size / t for t in window_times]
    eps = _median(window_eps)
    if not (window_losses[-1] < window_losses[0]):
        raise RuntimeError(
            f"loss did not decrease across windows ({window_losses}) — "
            "steps may not have executed; refusing to report."
        )
    return {
        "examples_per_sec": eps,
        "windows_examples_per_sec": [round(e, 1) for e in window_eps],
        "window_losses": window_losses,
        "roofline": check_roofline(
            eps, roofline_model(batch_size, table_dtype, wire_bytes),
            f"hot_loop[{variant}]", peaks, variant_compute_dtype(variant)),
    }


def measure_device_step(variant: str, batch_size: int, peaks: dict, k: int = 16,
                        pool_n: int = 8, reps: int = 5) -> dict:
    """Device step time with the host feed excluded: K chained train steps
    run inside ONE dispatch (`lax.scan` on donated state) over a payload pool
    transferred once, timed with `block_until_ready`; the median over `reps`
    dispatches divided by K is the step time. '+softmax' trains the in-batch
    sampled-softmax objective instead of BCE."""
    import functools

    import jax
    import jax.numpy as jnp
    import numpy as np

    from two_tower_recommender_model import config as cfg_lib
    from two_tower_recommender_model.data import SyntheticClickstream
    from two_tower_recommender_model.data.device_featurizer import (
        PackedBatch,
        PackedFeaturizer,
        unpack_batch,
    )
    from two_tower_recommender_model.train.step import (
        create_train_state,
        make_train_step,
    )

    table_dtype, sort, bf16buf, _compact, _delta = parse_variant(variant)
    mcfg = _model_config(variant)
    tcfg = cfg_lib.TrainConfig(
        batch_size=batch_size,
        sorted_feature="user_id" if sort else None,
        scatter_buffer_dtype="bfloat16" if bf16buf else "float32",
        loss="sampled_softmax" if "softmax" in variant.split("+")[1:] else "bce",
    )
    feat = PackedFeaturizer(mcfg, pack_label=True,
                            sort_feature="user_id" if sort else None)
    ds = SyntheticClickstream(num_users=N_USERS, num_items=N_ITEMS, seed=0,
                              noise=0.05, latent_dim=4)
    pool = jnp.asarray(np.stack(
        [feat(ds.sample(batch_size, start=i)).ids_raw for i in range(pool_n)]
    ))  # [P, B, S], transferred once

    state, dense_opt = create_train_state(jax.random.key(0), mcfg, tcfg)
    core = make_train_step(mcfg, tcfg, dense_opt, donate=False, jit=False)

    @functools.partial(jax.jit, donate_argnums=(0,), static_argnums=(2,))
    def run(state, pool, n_steps):
        def body(carry, i):
            pb = PackedBatch(
                ids_raw=jax.lax.dynamic_index_in_dim(pool, i % pool_n, keepdims=False),
                labels=jnp.zeros(0, jnp.int32),
            )
            carry, out = core(carry, unpack_batch(pb, mcfg, pack_label=True))
            return carry, out["loss"]

        state, losses = jax.lax.scan(body, state, jnp.arange(n_steps, dtype=jnp.int32))
        return state, losses[-1]

    state, v = run(state, pool, k)  # compile + warm
    losses = [round(float(v), 5)]
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        state, v = run(state, pool, k)
        v = jax.block_until_ready(v)
        times.append(time.perf_counter() - t0)
        losses.append(round(float(v), 5))
    if not (losses[-1] < losses[0]):
        raise RuntimeError(
            f"device-step loss did not decrease ({losses}) — steps may not "
            "have executed; refusing to report."
        )
    per_step = _median(times) / k
    eps = batch_size / per_step
    return {
        "examples_per_sec": round(eps, 1),
        "step_ms": round(per_step * 1e3, 3),
        "dispatch_ms": [round(t * 1e3, 2) for t in sorted(times)],
        "losses": losses,
        "roofline": check_roofline(
            eps, roofline_model(batch_size, table_dtype, wire_bytes=0.0),
            f"device_step[{variant}]", peaks, variant_compute_dtype(variant)),
    }


def measure_from_disk(batch_size: int, macro: int, rows: int) -> dict:
    """End-to-end epochs from TTRS shards on local disk — the numbers that
    reconcile with the reference's from-disk 27k ex/s epoch
    (`03_model_training.py:866`). Two production modes measured on the SAME
    prepared dataset:

    - dynamic (`scripts/train.py` default): PRE-PACKED uncompressed shards
      (device-layout columns written at prep time, `data/prepacked.py`) ->
      mmap StreamLoader row shuffle -> per-batch sort + compact/delta encode
      in the prefetch workers -> macro-scan train;
    - wire_cache (`--wire-cache`): batches fully encoded ONCE at build time
      (`data/wirecache.py`), epochs reshuffle at batch granularity and the
      host path is mmap + one memcpy — reports the build time too."""
    import tempfile

    import jax

    from two_tower_recommender_model import config as cfg_lib
    from two_tower_recommender_model.data import SyntheticClickstream
    from two_tower_recommender_model.data.compact import (
        CompactFeaturizer,
        CompactScheme,
        batch_from_compact,
    )
    from two_tower_recommender_model.data.loader import StreamLoader
    from two_tower_recommender_model.data.prepacked import (
        PrepackedFeaturizer,
        pack_dataset,
    )
    from two_tower_recommender_model.data.shards import ShardedDataset
    from two_tower_recommender_model.data.wirecache import (
        WireCache,
        build_wire_cache,
    )
    from two_tower_recommender_model.train.loop import train_one_epoch_packed
    from two_tower_recommender_model.train.step import (
        create_train_state,
        make_multi_step,
        make_train_step,
    )

    mcfg = cfg_lib.two_tower_model_config(
        num_users=N_USERS, num_items=N_ITEMS, embedding_dim=EMBED_DIM, layer_sizes=LAYERS
    )
    # scripts/train.py defaults: host row-sort in the prefetch workers ->
    # hinted scatter + delta wire (identical numerics to the unsorted path)
    tcfg = cfg_lib.TrainConfig(batch_size=batch_size, sorted_feature="user_id")
    ds = SyntheticClickstream(num_users=N_USERS, num_items=N_ITEMS, seed=1)
    work = tempfile.mkdtemp(prefix="bench_disk_")
    pack_dataset(work, mcfg, ds.sample(rows), rows_per_shard=1 << 19)
    dataset = ShardedDataset(work)

    scheme = CompactScheme.from_model(mcfg, pack_label=True,
                                      delta_feature="user_id")
    featurizer = CompactFeaturizer(
        PrepackedFeaturizer.for_dataset(dataset, mcfg, sort_feature="user_id"),
        scheme)
    state, dense_opt = create_train_state(jax.random.key(0), mcfg, tcfg)
    core = make_train_step(mcfg, tcfg, dense_opt, donate=False, jit=False)
    multi = make_multi_step(lambda s, cb: core(s, batch_from_compact(cb, mcfg, scheme)))

    # epoch 0 warms compile + page cache; epochs 1-3 measure (median — the
    # from-disk loop has real run-to-run variance from IO scheduling)
    epoch_stats = []
    for epoch in range(4):
        loader = StreamLoader(dataset, batch_size, seed=1, read_workers=2)
        loader.set_epoch(epoch)
        state, stats = train_one_epoch_packed(state, multi, loader, featurizer, macro=macro)
        if epoch > 0:
            epoch_stats.append(stats)
    eps = _median([s["examples_per_sec"] for s in epoch_stats])
    out = {
        "examples_per_sec": eps,
        "epochs_examples_per_sec": [round(s["examples_per_sec"], 1) for s in epoch_stats],
        "rows": epoch_stats[-1]["train_examples"],
        "epoch_time_s": round(_median([s["epoch_time_s"] for s in epoch_stats]), 3),
        "wire_bytes_per_example": scheme.wire_bytes_per_example,
    }

    # --- wire-cache mode on the same dataset (one-time encode, then
    # mmap+memcpy epochs; same compiled step, same wire format) ---
    loader = StreamLoader(dataset, batch_size, seed=1, read_workers=2)
    loader.set_epoch(0)
    t0 = time.perf_counter()
    build_wire_cache(work + "_wc", loader, featurizer)
    build_s = time.perf_counter() - t0
    cache = WireCache(work + "_wc", scheme=scheme)
    wc_stats = []
    for epoch in range(4):
        state, stats = train_one_epoch_packed(
            state, multi, cache.batches(epoch), lambda cb: cb, macro=macro)
        if epoch > 0:
            wc_stats.append(stats)
    out["wire_cache"] = {
        "examples_per_sec": round(
            _median([s["examples_per_sec"] for s in wc_stats]), 1),
        "epochs_examples_per_sec": [
            round(s["examples_per_sec"], 1) for s in wc_stats],
        "epoch_time_s": round(_median([s["epoch_time_s"] for s in wc_stats]), 3),
        "build_s": round(build_s, 2),
    }
    return out


DEFAULT_HOT_LOOP_VARIANTS = (
    "float32+sorted+compact+delta,"
    "float32+sorted+compact+delta+bf16compute,"
    "float32+sorted+compact,float32+sorted,float32,"
    "bfloat16+sorted+compact+delta,int8+sorted+compact+delta"
)
DEFAULT_DEVICE_VARIANTS = {
    "device_step": "float32+sorted",
    "device_step_bf16": "float32+sorted+bf16compute",
    "device_step_int8": "int8+sorted",
    "device_step_softmax": "float32+sorted+softmax",
}


def main() -> None:
    import jax

    from two_tower_recommender_model.utils.compile_cache import enable_compile_cache
    from two_tower_recommender_model.utils.profiling import gpu_name_and_power_limit

    enable_compile_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench.py measures a GPU; JAX found {dev.platform!r}")
    card = gpu_name_and_power_limit()
    peaks = {**device_peaks(dev.device_kind), "card": card}
    print(f"# card: {card}", file=sys.stderr, flush=True)
    print(card, flush=True)

    batch_size = int(os.environ.get("BENCH_BATCH_SIZE", 262144))
    macro = int(os.environ.get("BENCH_MACRO_BATCHES", 32))
    windows = max(int(os.environ.get("BENCH_WINDOWS", 5)), 5)
    per_window = max(int(os.environ.get("BENCH_STEPS", 480)) // macro // windows, 1)
    # enough rows that a from-disk epoch runs >= 4 full macro dispatches at
    # the headline batch size (2-dispatch epochs are dominated by per-epoch
    # fixed costs: loader reset, first-batch latency, the final loss fetch)
    disk_rows = int(os.environ.get("BENCH_DISK_ROWS",
                                   max(8 << 20, 4 * macro * batch_size)))
    dtypes = [d for d in os.environ.get(
        "BENCH_TABLE_DTYPES", DEFAULT_HOT_LOOP_VARIANTS).split(",") if d]
    if not dtypes:
        raise SystemExit("BENCH_TABLE_DTYPES is empty: nothing to measure")

    variants = {}
    for dt in dtypes:
        variants[dt] = measure_hot_loop(dt, batch_size, macro, windows,
                                        per_window, peaks)
        print(f"# {dt}: {variants[dt]['examples_per_sec']:.3g} ex/s "
              f"windows={variants[dt]['windows_examples_per_sec']} "
              f"losses={variants[dt]['window_losses']}", file=sys.stderr, flush=True)

    # headline: the fastest exact-f32 config ("+sorted" is a pure scheduling
    # hint; "+bf16buf" and "+bf16compute" round values, so they are excluded)
    exact_f32 = [d for d in variants if parse_variant(d)[0] == "float32"
                 and not parse_variant(d)[2]
                 and variant_compute_dtype(d) == "float32"]
    headline_dtype = (max(exact_f32, key=lambda d: variants[d]["examples_per_sec"])
                      if exact_f32 else dtypes[0])
    headline_var = variants[headline_dtype]
    headline = headline_var["examples_per_sec"]
    record = {
        "metric": "two_tower_train_examples_per_sec_1gpu",
        "value": round(headline, 1),
        "unit": "examples/s",
        "vs_baseline": round(headline / BASELINE_EXAMPLES_PER_SEC, 2),
        "note": ("hot-loop (in-memory feed, median of "
                 f"{windows} windows); baseline 27k ex/s is the reference's "
                 "from-disk A10 epoch — see from_disk for the apples-to-apples "
                 "comparison"),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices()),
                   "xla_flags": os.environ.get("XLA_FLAGS", ""),
                   "card": card},
        "batch_size": batch_size,
        "macro": macro,
        "headline_dtype": headline_dtype,
        "windows_examples_per_sec": headline_var["windows_examples_per_sec"],
        "window_losses": headline_var["window_losses"],
        "roofline": headline_var["roofline"],
        "variants": {
            dt: {
                "examples_per_sec": round(v["examples_per_sec"], 1),
                "windows_examples_per_sec": v["windows_examples_per_sec"],
                "window_losses": v["window_losses"],
                "roofline": v["roofline"],
            }
            for dt, v in variants.items()
        },
    }
    for key, default in DEFAULT_DEVICE_VARIANTS.items():
        variant = os.environ.get(f"BENCH_{key.upper()}", default)
        if not variant:
            continue
        bs = (int(os.environ.get("BENCH_SOFTMAX_BATCH_SIZE", 65536))
              if "softmax" in variant.split("+")[1:] else batch_size)
        rec = measure_device_step(variant, bs, peaks)
        record[key] = {"variant": variant, "batch_size": bs, **rec}
        print(f"# {key}[{variant}] bs={bs}: {rec['examples_per_sec']:.3g} ex/s "
              f"({rec['step_ms']} ms/step) losses={rec['losses']}",
              file=sys.stderr, flush=True)

    if disk_rows > 0:
        fd = measure_from_disk(batch_size, macro, disk_rows)
        model = roofline_model(batch_size, "float32", fd["wire_bytes_per_example"])
        check_roofline(fd["examples_per_sec"], model, "from_disk", peaks)
        check_roofline(fd["wire_cache"]["examples_per_sec"], model,
                       "from_disk_wire_cache", peaks)
        record["from_disk"] = {
            "examples_per_sec": round(fd["examples_per_sec"], 1),
            "epochs_examples_per_sec": fd["epochs_examples_per_sec"],
            "rows": fd["rows"],
            "epoch_time_s": fd["epoch_time_s"],
            "vs_baseline": round(fd["examples_per_sec"] / BASELINE_EXAMPLES_PER_SEC, 2),
            "wire_cache": {
                **fd["wire_cache"],
                "vs_baseline": round(
                    fd["wire_cache"]["examples_per_sec"] / BASELINE_EXAMPLES_PER_SEC, 2),
            },
        }

    record_path = os.environ.get("BENCH_RECORD")
    if record_path:
        with open(record_path, "w") as f:
            json.dump(record, f, indent=1)
    print(json.dumps(compact_record(record)))


def compact_record(record: dict) -> dict:
    """One parseable stdout line: headline, device and per-path scalars only
    (window arrays, rooflines and losses stay in the full record)."""
    out = {k: record[k] for k in
           ("metric", "value", "unit", "vs_baseline", "device", "batch_size",
            "headline_dtype")
           if k in record}
    if record.get("variants"):
        out["variants_examples_per_sec"] = {
            dt: v.get("examples_per_sec")
            for dt, v in record["variants"].items()}
    for key in DEFAULT_DEVICE_VARIANTS:
        if key in record:
            out[key] = {
                "examples_per_sec": record[key].get("examples_per_sec"),
                "step_ms": record[key].get("step_ms"),
            }
            if record[key].get("batch_size") != record.get("batch_size"):
                out[key]["batch_size"] = record[key].get("batch_size")
    if "from_disk" in record:
        out["from_disk_examples_per_sec"] = record["from_disk"].get(
            "examples_per_sec")
        if "wire_cache" in record["from_disk"]:
            out["wire_cache_examples_per_sec"] = record["from_disk"][
                "wire_cache"].get("examples_per_sec")
    return out


if __name__ == "__main__":
    sys.exit(main())
