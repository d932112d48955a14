#!/usr/bin/env python
"""CLI training entry point — the role of the reference's per-rank `main(args)`
(`03_model_training.py:704-843`) plus its launcher ladder (`:865-990`).

Examples:
  # single chip/host on TTRS shard dirs produced by scripts/prepare_instacart.py
  python scripts/train.py --data-dir out/instacart --num-users 206209 --num-items 49688

  # multi-host (run once per host):
  JAX_COORDINATOR_ADDRESS=host0:1234 JAX_NUM_PROCESSES=2 JAX_PROCESS_ID=$RANK \
  python scripts/train.py --data-dir ... --multi-host
"""

from __future__ import annotations

import _repo_path  # noqa: F401  (repo-root fallback when not pip-installed)

import argparse
import logging
import os
import re


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--data-dir", required=True, help="dir with train/ val/ test/ TTRS datasets")
    ap.add_argument("--num-users", type=int, required=True)
    ap.add_argument("--num-items", type=int, required=True)
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--batch-size", type=int, default=1024)
    ap.add_argument("--embedding-dim", type=int, default=128)
    ap.add_argument("--layer-sizes", type=int, nargs="+", default=[128, 64])
    ap.add_argument("--learning-rate", type=float, default=1e-3)
    ap.add_argument("--sparse-learning-rate", type=float, default=1e-2)
    ap.add_argument("--loss", choices=["bce", "sampled_softmax", "weighted_bce"], default="bce")
    ap.add_argument("--softmax-temperature", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--validation-freq", type=int, default=None)
    ap.add_argument("--limit-train-batches", type=int, default=None)
    ap.add_argument("--limit-val-batches", type=int, default=None)
    ap.add_argument("--limit-test-batches", type=int, default=None)
    ap.add_argument("--runs-root", default="runs")
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--multi-host", action="store_true")
    ap.add_argument("--mesh-model", type=int, default=1, help="model axis size")
    ap.add_argument("--no-shard", action="store_true", help="force replicated tables")
    ap.add_argument("--no-packed", action="store_true",
                    help="disable the packed macro-batch fast path (single-device only)")
    ap.add_argument("--macro-batches", type=int, default=32,
                    help="steps per dispatch on the packed fast path (mid-epoch "
                         "validation lands on macro boundaries, so larger values "
                         "coarsen the validation_freq grid)")
    ap.add_argument("--export-dir", default=None, help="export saved model here at the end")
    ap.add_argument("--sorted-feature", default="auto",
                    help="single-slot feature to host-sort each batch by: enables the "
                         "indices_are_sorted scatter fast path for its table "
                         "(packed path, single- or multi-device, one process). "
                         "'auto' (default) picks the largest eligible table and "
                         "silently disables where the fast path doesn't apply; "
                         "'off' disables")
    ap.add_argument("--wire-cache", default=None, metavar="DIR",
                    help="pre-encoded batch cache (data/wirecache.py): built on "
                         "first use from epoch-0 loader order, reused after — "
                         "epoch host cost drops to mmap+memcpy. Epochs reshuffle "
                         "at BATCH granularity (intra-batch composition is "
                         "frozen at build; rebuild the cache to re-roll it) and "
                         "the trailing partial batch is dropped. Requires the "
                         "packed path + compact wire; multi-host builds one "
                         "cache per process under DIR/host-N-of-M")
    ap.add_argument("--select-best", default=None, metavar="METRIC",
                    help="keep the state of the best epoch by this val metric "
                         "(e.g. val_auroc; names containing 'loss' minimize) — "
                         "the test eval and --export-dir use it instead of the "
                         "final epoch. Retrieval metrics work too "
                         "(val_recall_at_100, val_ndcg_at_10, ...): each "
                         "epoch runs an exact top-k retrieval eval on a val-"
                         "user subsample — the right selector for the "
                         "sampled_softmax objective, whose val AUROC "
                         "misleads")
    ap.add_argument("--retrieval-eval-users", type=int, default=2000,
                    help="user subsample size for the per-epoch retrieval "
                         "eval (--select-best val_recall_at_100 etc.)")
    ap.add_argument("--wire-cache-order",
                    choices=["auto", "loader", "rotate", "shuffle"],
                    default="auto",
                    help="batch order per wire-cache epoch. 'auto' (default): "
                         "loader order on a fresh generation (bitwise-"
                         "identical to dynamic training), seeded rotation on "
                         "generation reuse. A uniform 'shuffle' has cost "
                         "recall at full scale")
    ap.add_argument("--wire-cache-generations", type=int, default=1,
                    help="number of distinct batch compositions to pre-encode "
                         "(DIR/gen-N, one per loader-epoch row shuffle), cycled "
                         "across training epochs — a single frozen composition "
                         "overfits multi-epoch runs; set to the epoch count "
                         "for full row-level freshness")
    ap.add_argument("--compute-dtype", choices=["float32", "bfloat16"], default="float32",
                    help="dtype of the tower matmuls (params and optimizer state "
                         "stay float32); bfloat16 runs them on the bf16 tensor "
                         "cores")
    ap.add_argument("--table-dtype", choices=["float32", "bfloat16", "int8"],
                    default="float32",
                    help="embedding-table storage dtype (Adagrad math stays float32); "
                         "bfloat16 halves, int8 quarters table HBM")
    ap.add_argument("--sharded-exchange", choices=["dense", "alltoall"],
                    default="dense",
                    help="collective scheme for row-sharded f32 tables on a "
                         "multi-device mesh: 'alltoall' routes rows/grads "
                         "directly between data shards and id owners through "
                         "deduped static-capacity buckets — O(B_local x D) "
                         "per-device comm, the scheme that weak-scales "
                         "(DESIGN §9); 'dense' is the psum_scatter exchange")
    ap.add_argument("--exchange-capacity-factor", type=float, default=1.25,
                    help="alltoall bucket capacity multiple of B_local*L/ndev "
                         "(unique ids per (sender, owner) bucket; the epoch "
                         "loop RAISES if any distinct id overflows)")
    ap.add_argument("--exchange-wire-dtype", choices=["float32", "bfloat16"],
                    default="float32",
                    help="alltoall row/grad payload dtype; bfloat16 halves "
                         "the dominant collective bytes (one rounding)")
    ap.add_argument("--wire-format", choices=["auto", "packed", "compact"], default="auto",
                    help="host->device batch encoding on the packed fast path: 'compact' "
                         "bit-packs pre-hashed ids (4.375 B/example flagship vs 8 — "
                         "identical numerics; wins when H2D bandwidth binds). 'auto' "
                         "picks compact on the single-device path when batch size %% 8 == 0")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Train, evaluate and optionally export. Returns the final state and
    metrics, plus, on the packed path, the compiled macro step and the
    featurizer that feeds it (`chip_smoke.py` times them)."""
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(message)s")

    from two_tower_recommender_model.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    if args.multi_host:
        from two_tower_recommender_model.parallel.launch import initialize_multi_host

        initialize_multi_host()

    import jax

    from two_tower_recommender_model import config as cfg_lib
    from two_tower_recommender_model.data import Featurizer
    from two_tower_recommender_model.data.loader import StreamLoader
    from two_tower_recommender_model.parallel import (
        batch_sharding, make_mesh, make_sharded_eval_step, make_sharded_train_step,
        plan_sharding, shard_train_state,
    )
    from two_tower_recommender_model.parallel.launch import per_host_loader_slice
    from two_tower_recommender_model.train.loop import train_val_test
    from two_tower_recommender_model.train.step import (
        create_train_state, make_eval_step, make_train_step,
    )
    from two_tower_recommender_model.utils.tracking import ExperimentLogger

    mcfg = cfg_lib.two_tower_model_config(
        num_users=args.num_users, num_items=args.num_items,
        embedding_dim=args.embedding_dim, layer_sizes=tuple(args.layer_sizes),
        compute_dtype=args.compute_dtype,
    )
    if args.table_dtype != "float32":
        import dataclasses as _dc

        mcfg = _dc.replace(mcfg, table_dtype=args.table_dtype)
    sorted_auto = False
    if args.sorted_feature == "off":
        args.sorted_feature = None
    elif args.sorted_feature == "auto":
        # fast-by-default: sort by the largest eligible table's feature where
        # the fast path applies, silently off elsewhere
        from two_tower_recommender_model.train.step import auto_sorted_feature

        args.sorted_feature = (
            auto_sorted_feature(mcfg)
            if not args.no_packed and jax.process_count() == 1 else None
        )
        sorted_auto = args.sorted_feature is not None
        if args.sorted_feature:
            logging.info("sorted-feature auto: %s", args.sorted_feature)
    tcfg = cfg_lib.TrainConfig(
        epochs=args.epochs, batch_size=args.batch_size,
        learning_rate=args.learning_rate, sparse_learning_rate=args.sparse_learning_rate,
        loss=args.loss, seed=args.seed, validation_freq=args.validation_freq,
        softmax_temperature=args.softmax_temperature,
        limit_train_batches=args.limit_train_batches,
        limit_val_batches=args.limit_val_batches,
        limit_test_batches=args.limit_test_batches,
        sorted_feature=args.sorted_feature,
        sharded_exchange=args.sharded_exchange,
        exchange_capacity_factor=args.exchange_capacity_factor,
        exchange_wire_dtype=args.exchange_wire_dtype,
    )
    if args.sorted_feature and (args.no_packed or jax.process_count() > 1):
        # the hinted updates live in the packed steps (the per-batch loop's
        # Featurizer doesn't sort, silently breaking the hint's promise), and
        # multi-host batch slices are only per-host sorted
        raise SystemExit(
            "--sorted-feature requires the packed path in a single process "
            "(single- or multi-device)"
        )
    if args.wire_format == "compact" and args.no_packed:
        raise SystemExit("--wire-format compact requires the packed path")
    if args.wire_cache and args.no_packed:
        raise SystemExit("--wire-cache requires the packed path (drop --no-packed)")
    featurizer = Featurizer(mcfg)
    host_index, num_hosts = per_host_loader_slice()
    n_devices = len(jax.devices())

    state, dense_opt = create_train_state(jax.random.key(args.seed), mcfg, tcfg)
    sharding = None
    sharded = n_devices > 1 and not args.no_shard
    if sharded and args.batch_size % n_devices:
        raise SystemExit(
            f"--batch-size {args.batch_size} must be divisible by {n_devices} devices"
        )
    if sharded:
        mesh = make_mesh(model=args.mesh_model)
        hbm = None
        try:
            hbm = (jax.devices()[0].memory_stats() or {}).get("bytes_limit")
        except Exception:
            pass
        plan = plan_sharding(mcfg, n_devices, hbm_budget_bytes=hbm)
        if sorted_auto and args.sorted_feature:
            # auto mode downgrades gracefully when the planner picked a
            # strategy the sorted fast paths don't cover (column/table-wise)
            import dataclasses as _dc

            from two_tower_recommender_model.parallel.planner import (
                REPLICATED as _REP, ROW_SHARDED as _ROW,
            )
            from two_tower_recommender_model.train.step import (
                validate_sorted_feature as _vsf,
            )

            st = plan[_vsf(mcfg, tcfg)].strategy
            if st not in (_ROW, _REP):
                # the sorted fast paths don't cover this strategy
                logging.info("sorted-feature auto: off (table is %s)", st)
                args.sorted_feature = None
                tcfg = _dc.replace(tcfg, sorted_feature=None)
        if tcfg.print_sharding_plan and jax.process_index() == 0:
            print(plan.describe())
        state = shard_train_state(state, plan, mesh)
        train_step = make_sharded_train_step(mcfg, tcfg, dense_opt, mesh, plan)
        eval_step = make_sharded_eval_step(mcfg, tcfg, mesh, plan)
        sharding = batch_sharding(mesh)
    else:
        train_step = make_train_step(mcfg, tcfg, dense_opt)
        eval_step = make_eval_step(mcfg, tcfg)

    logger = ExperimentLogger(args.runs_root) if jax.process_index() == 0 else None
    if logger:
        from two_tower_recommender_model.parallel.mesh import topology_summary

        topo = topology_summary()
        # hyperparams + cluster metadata (the reference logs both,
        # 03_model_training.py:765-767 and :947-955)
        logger.log_params({
            "num_users": args.num_users, "num_items": args.num_items,
            "embedding_dim": args.embedding_dim, "layer_sizes": args.layer_sizes,
            "batch_size": args.batch_size, "loss": args.loss,
            "devices": n_devices, "hosts": num_hosts,
            "platform": topo.platform, "device_kind": topo.device_kind,
            "devices_per_host": topo.devices_per_host,
        })

    ckpt = None
    if args.checkpoint_dir:
        from two_tower_recommender_model.utils.checkpoint import Checkpointer

        ckpt = Checkpointer(args.checkpoint_dir)
    train_loader = StreamLoader(
        os.path.join(args.data_dir, "train"), args.batch_size, seed=args.seed,
        host_index=host_index, num_hosts=num_hosts,
    )
    if args.no_packed and train_loader.dataset.index.get("packed"):
        raise SystemExit(
            "--no-packed cannot train on a PRE-PACKED dataset (its columns are "
            "device-layout packed_ids, not raw features) — drop --no-packed or "
            "prepare the data without --packed"
        )
    start_epoch = 0
    if args.resume and ckpt is not None and ckpt.latest_step() is not None:
        state, loader_state, extra = ckpt.restore(state)
        # checkpoints are taken at epoch boundaries: resume at the NEXT epoch
        # (loader position within a truncated epoch is irrelevant there)
        start_epoch = int(extra.get("completed_epoch", -1)) + 1
        print(f"resumed from step {int(state.step)}, epoch {start_epoch}")

    def train_factory(epoch):
        train_loader.set_epoch(epoch)
        return train_loader

    # eval padding: single-host pads ragged tails to a device multiple;
    # multi-host additionally pads EVERY eval batch to the full batch size and
    # runs all hosts to the global max batch count (align_hosts="pad" +
    # pad_to) so cross-host collectives line up without dropping any sample
    eval_pad_to = args.batch_size if num_hosts > 1 else None

    def eval_factory(split):
        # ragged tail batches are padded with zero-weight rows (pad_multiple
        # below), so no eval sample is ever dropped even when sharded
        return lambda: StreamLoader(
            os.path.join(args.data_dir, split), args.batch_size, shuffle=False,
            drop_last=False, host_index=host_index, num_hosts=num_hosts,
            align_hosts="pad" if num_hosts > 1 else "truncate",
        )

    def checkpoint_fn(s, epoch):
        if ckpt is not None:
            ckpt.save(int(s.step), s, loader_state=train_loader.state_dict(),
                      extra={"completed_epoch": epoch}, wait=True)

    # Packed macro-batch fast path (default): device-side featurization +
    # K-step scan dispatches, full train_val_test semantics (mid-epoch
    # validation, limits, tail batches) via train_one_epoch_packed. The
    # sharded variant scans the sharded step (make_sharded_multi_step) with
    # the macro payload's batch axis on the data mesh axis.
    train_epoch_fn = multi = packed_feat = None
    if not args.no_packed:
        # multi-host included: macro payloads assemble across processes via
        # make_array_from_process_local_data (tested in test_multihost.py)
        import jax as _jax

        from two_tower_recommender_model.data.device_featurizer import (
            PackedFeaturizer, make_packed_train_step, unpack_batch,
        )
        from two_tower_recommender_model.data.prepacked import PrepackedFeaturizer
        from two_tower_recommender_model.train.loop import train_one_epoch_packed
        from two_tower_recommender_model.train.step import make_multi_step

        if train_loader.dataset.index.get("packed"):
            packed_feat = PrepackedFeaturizer.for_dataset(
                train_loader.dataset, mcfg, sort_feature=tcfg.sorted_feature
            )
        else:
            packed_feat = PackedFeaturizer(
                mcfg, pack_label=True, sort_feature=tcfg.sorted_feature
            )
        # unpack with the featurizer's ACTUAL label encoding — a prepacked
        # dataset written with pack_label=False stores labels in a separate
        # column, and unpacking it as if bit-30-packed silently zeroes every
        # label
        pl = packed_feat.pack_label
        if sharded:
            from two_tower_recommender_model.parallel import (
                compact_macro_shardings_for_scheme,
                macro_batch_sharding,
                make_sharded_compact_multi_step,
                make_sharded_multi_step,
            )
            core_sh = make_sharded_train_step(
                mcfg, tcfg, dense_opt, mesh, plan, donate=False, jit=False)
            wire = args.wire_format
            if wire == "auto":
                # compact needs batch % (8 * data-axis) == 0 (bit groups of 8
                # examples, then the group axis shards over data); auto stays
                # conservative on multi-host (explicit --wire-format compact
                # works there too — tested in test_multihost.py)
                wire = ("compact"
                        if args.batch_size % (8 * n_devices) == 0
                        and _jax.process_count() == 1 else "packed")
            if wire == "compact":
                from two_tower_recommender_model.data.compact import (
                    CompactFeaturizer, CompactScheme, batch_from_compact,
                )

                delta_feat, segs = args.sorted_feature, 1
                if _jax.process_count() > 1 and delta_feat is None:
                    # multi-host: the step's sorted fast paths need a GLOBAL
                    # sort (unavailable), but the WIRE doesn't — each host
                    # sorts its own slice (loss-invariant) and delta-encodes
                    # it as one segment; the decode cumsum resets at process
                    # boundaries (CompactScheme.delta_segments)
                    from two_tower_recommender_model.train.step import (
                        auto_sorted_feature,
                    )

                    delta_feat = auto_sorted_feature(mcfg)
                    if delta_feat is not None:
                        segs = _jax.process_count()
                        if train_loader.dataset.index.get("packed"):
                            packed_feat = PrepackedFeaturizer.for_dataset(
                                train_loader.dataset, mcfg,
                                sort_feature=delta_feat)
                        else:
                            packed_feat = PackedFeaturizer(
                                mcfg, pack_label=True, sort_feature=delta_feat)
                        pl = packed_feat.pack_label
                        logging.info(
                            "multi-host delta wire: per-host sort by %s "
                            "(%d segments)", delta_feat, segs)
                scheme = CompactScheme.from_model(
                    mcfg, pack_label=pl, delta_feature=delta_feat,
                    delta_segments=segs)
                dense_flag = bool(getattr(packed_feat, "dense", False))
                packed_feat = CompactFeaturizer(packed_feat, scheme)
                multi = make_sharded_compact_multi_step(
                    mcfg, tcfg, dense_opt, mesh, plan, scheme)
                tail_step = _jax.jit(
                    lambda s, cb: core_sh(s, batch_from_compact(cb, mcfg, scheme)),
                    donate_argnums=(0,),
                )
                macro_sh = compact_macro_shardings_for_scheme(
                    mesh, scheme, dense=dense_flag, batch_size=args.batch_size)
                tail_sh = compact_macro_shardings_for_scheme(
                    mesh, scheme, dense=dense_flag, macro=False,
                    batch_size=args.batch_size)
            else:
                multi = make_sharded_multi_step(mcfg, tcfg, dense_opt, mesh, plan,
                                                pack_label=pl)
                tail_step = _jax.jit(
                    lambda s, pb: core_sh(s, unpack_batch(pb, mcfg, pack_label=pl)),
                    donate_argnums=(0,),
                )
                macro_sh = macro_batch_sharding(mesh)
                tail_sh = sharding  # per-batch data placement
        else:
            core = make_train_step(mcfg, tcfg, dense_opt, donate=False, jit=False)
            wire = args.wire_format
            if wire == "auto":
                wire = "compact" if args.batch_size % 8 == 0 else "packed"
            if wire == "compact":
                from two_tower_recommender_model.data.compact import (
                    CompactFeaturizer, CompactScheme, batch_from_compact,
                    make_compact_train_step,
                )

                # sorted batches upgrade the sorted slot to uint8 delta
                # encoding (3.125 B/example flagship vs 4.375; identical
                # numerics — data/compact.py)
                scheme = CompactScheme.from_model(
                    mcfg, pack_label=pl, delta_feature=args.sorted_feature)
                packed_feat = CompactFeaturizer(packed_feat, scheme)
                multi = make_multi_step(
                    lambda s, cb: core(s, batch_from_compact(cb, mcfg, scheme))
                )
                tail_step = make_compact_train_step(core, mcfg, scheme)
            else:
                multi = make_multi_step(
                    lambda s, pb: core(s, unpack_batch(pb, mcfg, pack_label=pl))
                )
                tail_step = make_packed_train_step(core, mcfg, pack_label=pl)
            macro_sh = tail_sh = None

        # prepacked val/test datasets eval through the packed eval step
        from two_tower_recommender_model.data.shards import ShardedDataset

        val_ds = ShardedDataset(os.path.join(args.data_dir, "val"))
        if val_ds.index.get("packed"):
            from two_tower_recommender_model.data.device_featurizer import (
                make_packed_eval_step,
            )

            featurizer = PrepackedFeaturizer.for_dataset(val_ds, mcfg)
            eval_step = make_packed_eval_step(eval_step, mcfg,
                                              pack_label=featurizer.pack_label)

        wire_cache = None
        wc_limit = None
        if args.wire_cache:
            scheme_wc = getattr(packed_feat, "scheme", None)
            if scheme_wc is None:
                raise SystemExit("--wire-cache requires the compact wire format "
                                 "(drop --wire-format packed)")
            from two_tower_recommender_model.data.wirecache import (
                WireCache, build_wire_cache,
            )

            # multi-host: one cache PER PROCESS, each encoding this host's
            # loader slice (batches assemble into global arrays exactly like
            # the dynamic path, via device_put_batch)
            cache_dir = args.wire_cache
            if _jax.process_count() > 1:
                cache_dir = os.path.join(
                    args.wire_cache,
                    f"host-{_jax.process_index()}-of-{_jax.process_count()}")
            # dataset identity: a reused cache must have been built from the
            # SAME shards at the SAME batch size (stale caches silently train
            # old data otherwise)
            wc_fp = {
                "data_dir": os.path.abspath(args.data_dir),
                "total_rows": train_loader.dataset.index.get("total_rows"),
                "num_shards": len(train_loader.dataset.index.get("shards", [])),
            }
            # N generations = N distinct batch compositions (one per loader
            # epoch's row shuffle), cycled across training epochs — the
            # measured quality cost of a single frozen composition is real
            # (data/wirecache.py docstring); N == epochs restores row-level
            # freshness at N one-time builds
            wire_caches = []
            for g in range(max(1, args.wire_cache_generations)):
                gdir = os.path.join(cache_dir, f"gen-{g}")
                if not os.path.exists(os.path.join(gdir, "meta.json")):
                    train_loader.set_epoch(g)
                    meta = build_wire_cache(gdir, train_loader, packed_feat,
                                            fingerprint=wc_fp)
                    logging.info("wire cache built: %d batches (%d tail rows "
                                 "dropped) -> %s", meta["num_batches"],
                                 meta["dropped_tail_rows"], gdir)
                try:
                    wire_caches.append(WireCache(
                        gdir, scheme=scheme_wc, seed=args.seed,
                        batch_size=args.batch_size, fingerprint=wc_fp))
                except ValueError as e:
                    raise SystemExit(f"--wire-cache: {e}")
            wire_cache = wire_caches[0]
            wc_limit = min(c.num_batches for c in wire_caches)
            if args.loss == "sampled_softmax" and len(wire_caches) < args.epochs:
                # recall stays at parity, but the in-batch objective's val
                # AUROC drifts harder when negative
                # co-occurrence sets repeat — don't read AUROC as quality here
                logging.warning(
                    "wire cache: %d generation(s) < %d epochs with an in-batch "
                    "loss — composition reuse accelerates val-AUROC calibration "
                    "drift (retrieval recall unaffected). "
                    "Use --wire-cache-generations %d for fresh compositions.",
                    len(wire_caches), args.epochs, args.epochs)
            if _jax.process_count() > 1:
                # lockstep contract: every host must take the SAME number of
                # steps per epoch — truncate to the global minimum batch count
                import numpy as _np
                from jax.experimental import multihost_utils as _mhu

                counts = _np.asarray(_mhu.process_allgather(
                    _np.asarray([wc_limit]), tiled=True))
                wc_limit = int(counts.min())
            if wc_limit != wire_cache.num_batches:
                logging.info("wire cache: truncating %d -> %d batches "
                             "(global min across hosts/generations)",
                             wire_cache.num_batches, wc_limit)

        def train_epoch_fn(state, epoch):
            if wire_cache is not None:
                # clamp the macro to the cache size so small datasets still
                # take the macro fast path; leftovers (< one macro) train
                # batch-by-batch through tail_step rather than being dropped
                macro_eff = max(1, min(args.macro_batches, wc_limit))
                cache = wire_caches[epoch % len(wire_caches)]
                mode = args.wire_cache_order
                if mode == "auto":
                    # fresh generation -> loader order (replays the dynamic
                    # path bitwise); reuse -> rotate (phase variety without
                    # the uniform-shuffle recall cost)
                    mode = "loader" if epoch < len(wire_caches) else "rotate"
                return train_one_epoch_packed(
                    state, multi,
                    cache.batches(epoch, limit_batches=wc_limit,
                                  order_mode=mode),
                    lambda cb: cb,
                    macro=macro_eff, train_cfg=tcfg, tail_step=tail_step,
                    eval_step=eval_step,
                    val_batches_factory=eval_factory("val"), val_featurizer=featurizer,
                    logger=logger, epoch=epoch, sharding=macro_sh,
                    tail_sharding=tail_sh, val_sharding=sharding,
                    pad_multiple=n_devices if sharded else None, pad_to=eval_pad_to,
                )
            train_loader.set_epoch(epoch)
            return train_one_epoch_packed(
                state, multi, train_loader, packed_feat, macro=args.macro_batches,
                train_cfg=tcfg, tail_step=tail_step, eval_step=eval_step,
                val_batches_factory=eval_factory("val"), val_featurizer=featurizer,
                logger=logger, epoch=epoch, sharding=macro_sh, tail_sharding=tail_sh,
                val_sharding=sharding, pad_multiple=n_devices if sharded else None,
                pad_to=eval_pad_to,
            )

    # --select-best on a RETRIEVAL metric (val_recall_at_100 etc.): per-epoch
    # exact top-k on a user subsample feeds the selector — val AUROC is not a
    # selection signal for the in-batch objective
    retrieval_eval_fn = None
    if args.select_best and any(
        t in args.select_best for t in ("recall", "ndcg", "mrr", "precision", "hit")
    ):
        from two_tower_recommender_model.evaluation.retrieval import (
            make_retrieval_eval_fn,
            split_positives,
        )

        positives = split_positives(os.path.join(args.data_dir, "val"))
        m = re.search(r"_at_(\d+)$", args.select_best)
        k_sel = int(m.group(1)) if m else 100
        params_fn = None
        if sharded:
            from two_tower_recommender_model.parallel.sharded import (
                unshard_train_state,
            )
            from two_tower_recommender_model.train.step import full_params

            def params_fn(state):
                return full_params(unshard_train_state(state, plan, mcfg))

        retrieval_eval_fn = make_retrieval_eval_fn(
            mcfg, positives, k=max(k_sel, 100), ks=(k_sel,),
            max_users=args.retrieval_eval_users, params_fn=params_fn,
        )
        print(f"per-epoch retrieval eval: {len(positives)} users with val "
              f"positives, subsample {args.retrieval_eval_users}, "
              f"selecting on {args.select_best}")

    state, results = train_val_test(
        state, train_step, eval_step, mcfg, tcfg, featurizer,
        train_batches_factory=train_factory,
        val_batches_factory=eval_factory("val"),
        test_batches_factory=eval_factory("test"),
        logger=logger, checkpoint_fn=checkpoint_fn, sharding=sharding,
        pad_multiple=n_devices if sharded else None, pad_to=eval_pad_to,
        start_epoch=start_epoch, train_epoch_fn=train_epoch_fn,
        select_best=args.select_best,
        retrieval_eval_fn=retrieval_eval_fn,
    )
    from two_tower_recommender_model.utils.profiling import device_label

    print(f"device: {device_label()}")
    print({k: round(v, 5) for k, v in results.items()})

    if args.export_dir and jax.process_index() == 0:
        from two_tower_recommender_model.parallel.sharded import unshard_train_state
        from two_tower_recommender_model.utils.checkpoint import export_model

        export_state = state
        if n_devices > 1 and not args.no_shard:
            export_state = unshard_train_state(state, plan, mcfg)
        export_model(args.export_dir, mcfg, export_state)
        print(f"exported model to {args.export_dir}")
    if ckpt is not None:
        ckpt.close()
    return {"state": state, "results": results, "macro_step": multi,
            "featurizer": packed_feat}


if __name__ == "__main__":
    main()
