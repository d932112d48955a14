"""Sharded embedding lookup/update collectives + the multi-chip train step.

The replacement for TorchRec `DistributedModelParallel` +
`TrainPipelineSparseDist` (`03_model_training.py:648,797-815`): tables are
row-sharded over the flattened (data, model) mesh — each row exists once
globally — dense towers are replicated with data-parallel grads, and the
sparse exchange rides XLA collectives (NCCL on the GPU):

  forward   all_gather(ids over data)            # tiny: B*L int32
            local partial pool from own rows     # XLA gather
            psum_scatter(partial over data)      # B_glob*D floats
            psum(over model)                     # B_loc*D floats
  backward  all_gather(pooled grads over data)   # B_glob*D floats
            fused row-wise Adagrad scatter into the local shard only

Communication per step is O(batch x dim), independent of table size. There
is no id->owner all-to-all and no host sync; the
whole train step is one jit program, so XLA overlaps the collectives with the
dense tower compute (the role of the reference's CUDA-stream overlap).

Replicated (small) tables take the DDP-style path: local lookup, all_gather
the batch grads over data, identical deterministic Adagrad update everywhere.
"""

from __future__ import annotations

import functools
from typing import Callable

import jax
import jax.numpy as jnp
import optax
from jax.sharding import NamedSharding, PartitionSpec as P

from two_tower_recommender_model.config import ModelConfig, TrainConfig
from two_tower_recommender_model.data.device_featurizer import unpack_batch
from two_tower_recommender_model.data.featurizer import Batch
from two_tower_recommender_model.models import losses as losses_lib
from two_tower_recommender_model.models import two_tower
from two_tower_recommender_model.models.metrics import auroc_update, mean_update
from two_tower_recommender_model.parallel.mesh import DATA_AXIS, FLAT_AXES, MODEL_AXIS
from two_tower_recommender_model.parallel.planner import (
    COLUMN_SHARDED,
    REPLICATED,
    ROW_SHARDED,
    TABLE_WISE,
    ShardingPlan,
)
from two_tower_recommender_model.train import optimizer as opt_lib
from two_tower_recommender_model.train.step import EvalState, TrainState

# ---------------------------------------------------------------------------
# placement helpers


def batch_sharding(mesh) -> Callable:
    """Leaf -> NamedSharding placing the leading (batch) dim on the data axis."""
    def fn(x):
        spec = P(DATA_AXIS, *([None] * (x.ndim - 1)))
        return NamedSharding(mesh, spec)
    return fn


def shard_train_state(state: TrainState, plan: ShardingPlan, mesh) -> TrainState:
    """Pad row-sharded tables to the device multiple and place everything:
    tables P((data, model), None) or replicated; dense params + opt state
    replicated. The materialize-on-device moment of `DistributedModelParallel`
    (`03_model_training.py:812-815`)."""
    from two_tower_recommender_model.ops.quantized import QuantizedTable

    import numpy as np

    for name, t in state.tables.items():
        if isinstance(t, QuantizedTable) and t.packed:
            raise NotImplementedError(
                f"table {name!r} uses PACKED int8 storage (rows >= "
                "PACKED_STORAGE_MIN_ROWS) — the sharded runtime consumes the "
                "unpacked s8 format; per-shard rows are below the packed "
                "threshold anyway, so build the state after raising "
                "ops.quantized.PACKED_STORAGE_MIN_ROWS above the table size "
                "(DESIGN §8)"
            )
    rep = NamedSharding(mesh, P())
    tables, accs = {}, {}
    # table-wise buckets: one [ndev*R, D] row-sharded array per embedding dim
    # holding every table-wise table at its (owner, offset) slot
    for bname, b in plan.buckets.items():
        r = b.rows_per_device
        member0 = state.tables[b.tables[0]]
        quantized = isinstance(member0, QuantizedTable)
        big = np.zeros(
            (plan.num_devices * r, b.embedding_dim),
            member0.values.dtype if quantized else member0.dtype,
        )
        big_scales = np.zeros((plan.num_devices * r,), np.float32) if quantized else None
        big_acc = np.zeros((plan.num_devices * r,), np.float32)
        for tname in b.tables:
            spec = plan[tname]
            t = state.tables[tname]
            start = spec.owner * r + spec.bucket_offset
            if quantized:
                if not isinstance(t, QuantizedTable):
                    raise ValueError(f"bucket {bname} mixes quantized and float tables")
                n = t.values.shape[0]
                big[start : start + n] = np.asarray(t.values)
                big_scales[start : start + n] = np.asarray(t.scales)
            else:
                arr = np.asarray(t)
                n = arr.shape[0]
                big[start : start + n] = arr
            big_acc[start : start + n] = np.asarray(state.adagrad_acc[tname])
        if quantized:
            tables[bname] = jax.device_put(
                QuantizedTable(values=big, scales=big_scales),
                QuantizedTable(
                    values=NamedSharding(mesh, P(FLAT_AXES, None)),
                    scales=NamedSharding(mesh, P(FLAT_AXES)),
                ),
            )
        else:
            tables[bname] = jax.device_put(big, NamedSharding(mesh, P(FLAT_AXES, None)))
        accs[bname] = jax.device_put(big_acc, NamedSharding(mesh, P(FLAT_AXES)))
    for name, spec in plan.specs.items():
        if spec.strategy == TABLE_WISE:
            continue  # lives inside its bucket
        t = state.tables[name]
        a = state.adagrad_acc[name]
        if isinstance(t, QuantizedTable) and spec.strategy == COLUMN_SHARDED:
            raise NotImplementedError(
                f"int8 table {name!r}: per-row scales do not split by columns; "
                "use row_sharded or replicated"
            )
        if spec.strategy == ROW_SHARDED and isinstance(t, QuantizedTable):
            pad = spec.padded_rows - t.values.shape[0]
            if pad:
                t = QuantizedTable(
                    values=jnp.pad(t.values, ((0, pad), (0, 0))),
                    scales=jnp.pad(t.scales, (0, pad)),
                )
                a = jnp.pad(a, (0, pad))
            tables[name] = jax.device_put(
                t,
                QuantizedTable(
                    values=NamedSharding(mesh, P(FLAT_AXES, None)),
                    scales=NamedSharding(mesh, P(FLAT_AXES)),
                ),
            )
            accs[name] = jax.device_put(a, NamedSharding(mesh, P(FLAT_AXES)))
        elif spec.strategy == ROW_SHARDED:
            pad = spec.padded_rows - t.shape[0]
            if pad:
                t = jnp.pad(t, ((0, pad), (0, 0)))
                a = jnp.pad(a, (0, pad))
            tables[name] = jax.device_put(t, NamedSharding(mesh, P(FLAT_AXES, None)))
            accs[name] = jax.device_put(a, NamedSharding(mesh, P(FLAT_AXES)))
        elif spec.strategy == COLUMN_SHARDED:
            dpad = spec.padded_dim - t.shape[1]
            if dpad:
                t = jnp.pad(t, ((0, 0), (0, dpad)))
            tables[name] = jax.device_put(t, NamedSharding(mesh, P(None, FLAT_AXES)))
            accs[name] = jax.device_put(a, rep)  # full-row accumulator, replicated
        else:
            tables[name] = jax.device_put(t, rep)
            accs[name] = jax.device_put(a, rep)
    return TrainState(
        step=jax.device_put(state.step, rep),
        tables=tables,
        adagrad_acc=accs,
        dense_params=jax.device_put(state.dense_params, rep),
        dense_opt_state=jax.device_put(state.dense_opt_state, rep),
        item_counts=(None if state.item_counts is None
                     else jax.device_put(state.item_counts, rep)),
    )


def _to_host(arr):
    """device_get that also works for arrays spanning multiple processes
    (multi-host): replicated arrays read the local copy, cross-process sharded
    arrays all-gather (every host gets the full value — the multi-host form of
    `ShardedTensor.gather`, `03_model_training.py:480-495`)."""
    import numpy as np

    if isinstance(arr, jax.Array) and not arr.is_fully_addressable:
        if arr.is_fully_replicated:
            return np.asarray(arr.addressable_data(0))
        from jax.experimental import multihost_utils

        return np.asarray(multihost_utils.process_allgather(arr, tiled=True))
    return jax.device_get(arr)


def unshard_train_state(state: TrainState, plan: ShardingPlan, model_cfg: ModelConfig) -> TrainState:
    """Gather shards to host and strip row padding (the role of
    `ShardedTensor.gather` to rank 0 for checkpointing,
    `03_model_training.py:474-495`)."""
    def unpad(name, arr):
        from two_tower_recommender_model.ops.quantized import QuantizedTable

        t = model_cfg.table(name)
        if isinstance(arr, QuantizedTable):
            return QuantizedTable(
                values=_to_host(arr.values)[: t.num_embeddings],
                scales=_to_host(arr.scales)[: t.num_embeddings],
            )
        out = _to_host(arr)[: t.num_embeddings]
        if out.ndim == 2 and out.shape[1] > t.embedding_dim:
            out = out[:, : t.embedding_dim]
        return out

    from two_tower_recommender_model.ops.quantized import QuantizedTable

    # table-wise tables: slice each member back out of its gathered bucket
    tables, accs = {}, {}
    bucket_host = {
        b: (
            QuantizedTable(values=_to_host(arr.values), scales=_to_host(arr.scales))
            if isinstance(arr := state.tables[b], QuantizedTable)
            else _to_host(arr)
        )
        for b in plan.buckets
    }
    bucket_acc_host = {b: _to_host(state.adagrad_acc[b]) for b in plan.buckets}
    for name, spec in plan.specs.items():
        if spec.strategy == TABLE_WISE:
            r = plan.buckets[spec.bucket].rows_per_device
            start = spec.owner * r + spec.bucket_offset
            n = spec.num_embeddings
            bh = bucket_host[spec.bucket]
            if isinstance(bh, QuantizedTable):
                tables[name] = QuantizedTable(
                    values=bh.values[start : start + n],
                    scales=bh.scales[start : start + n],
                )
            else:
                tables[name] = bh[start : start + n]
            accs[name] = bucket_acc_host[spec.bucket][start : start + n]
        else:
            tables[name] = unpad(name, state.tables[name])
            accs[name] = unpad(name, state.adagrad_acc[name])

    get = lambda tree: jax.tree.map(_to_host, tree)  # noqa: E731
    return TrainState(
        step=_to_host(state.step),
        tables=tables,
        adagrad_acc=accs,
        dense_params=get(state.dense_params),
        dense_opt_state=get(state.dense_opt_state),
        item_counts=(None if state.item_counts is None else _to_host(state.item_counts)),
    )


# ---------------------------------------------------------------------------
# collectives


def _local_partial_pool(table_shard, ids_all, w_all, didx):
    """Partial pooled sum using only this device's rows."""
    rows = table_shard.shape[0]
    local = ids_all - didx * rows
    ok = (local >= 0) & (local < rows) & (w_all != 0)
    emb = jnp.take(table_shard, jnp.where(ok, local, 0), axis=0)
    emb = emb * jnp.where(ok, w_all, 0.0)[..., None].astype(emb.dtype)
    return emb.sum(axis=1)  # [B_glob, D]


def make_sharded_lookup(mesh):
    """Weighted-sum pooled lookup over a row-sharded table."""

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(FLAT_AXES, None), P(DATA_AXIS, None), P(DATA_AXIS, None)),
        out_specs=P(DATA_AXIS, None),
        check_vma=False,
    )
    def lookup(table_shard, ids, w):
        didx = jax.lax.axis_index(FLAT_AXES)
        ids_all = jax.lax.all_gather(ids, DATA_AXIS, axis=0, tiled=True)
        w_all = jax.lax.all_gather(w, DATA_AXIS, axis=0, tiled=True)
        part = _local_partial_pool(table_shard, ids_all, w_all, didx)
        out = jax.lax.psum_scatter(part, DATA_AXIS, scatter_dimension=0, tiled=True)
        return jax.lax.psum(out, MODEL_AXIS)

    return lookup


# ---------------------------------------------------------------------------
# all-to-all exchange (the O(B_local x D) scheme — DESIGN §9)
#
# The dense scheme above moves O(B_global x D) bytes per DEVICE per step
# (psum_scatter of the dense partial-pool + grad all_gather), so its
# comm/compute ratio grows linearly with the mesh and weak scaling collapses
# (§9's model: ~13% at 8 chips). Here each example's rows and grads travel
# DIRECTLY between the example's data shard and the id's table shard:
#
#   route    owner = id // rows_per_shard; sort local ids by owner; place
#            each into a static [ndev, cap] bucket (rank within its owner
#            group), cap = ceil(B_loc*L/ndev * capacity_factor)
#   forward  all_to_all(ids)  ->  owner gathers its rows  ->  all_to_all back
#   backward all_to_all(ids, grads) -> owner runs sorted-segment Adagrad
#
# Static capacity replaces TorchRec's variable-split NCCL all-to-all (XLA
# collectives are static-shaped): the max_ids_per_partition design point of
# sharded embedding libraries. Ids past capacity are dropped from
# that step and COUNTED (`exchange_overflow` in the step output) — with
# hashed/uniform ids the bucket loads concentrate at B_loc*L/ndev with
# sqrt-size fluctuations, so capacity_factor 1.25 makes overflow
# astronomically rare at production batches; skewed id streams should raise
# it (or fall back to the dense scheme, which has no capacity).
#
# Meshes with a model axis: each (data i, model j) replica holds the same
# batch slice, so replica j takes responsibility for exactly the owners
# whose flat index has model-coordinate j — every id is routed ONCE
# globally, every bucket still loads ~B_loc*L/ndev, and the pooled partial
# results psum over the model axis (a [B_loc, D] collective, small).


def _a2a_route(flat_ids, w_flat, rows, ndev, cap, responsible):
    """Bucket-slot assignment for the all-to-all exchange, DEDUPLICATED:
    every distinct id occupies ONE slot of its owner's bucket, however many
    batch positions repeat it (duplicate lookups read the same response
    slot; duplicate grads pre-aggregate into the same send slot). Capacity
    therefore bounds UNIQUE ids per (sender, owner) bucket — the
    max_unique_ids_per_partition convention, and the reason hot ids cost one row of
    wire, not one per occurrence.

    Returns (slot_for_pos [M] int32 in [0, ndev*cap] with ndev*cap = the
    dump slot for ids that don't route, ok [M] bool, overflow = count of
    DISTINCT ids dropped past capacity). Routing = sort by id (owner =
    id // rows is monotone in id, so owner groups are automatic), unique-
    rank within the owner group, slot = owner*cap + rank."""
    m = flat_ids.shape[0]
    ok = (w_flat != 0) & responsible
    big = jnp.int32(ndev * rows)  # sorts invalid entries last; owner >= ndev
    key = jnp.where(ok, flat_ids, big).astype(jnp.int32)
    iota = jnp.arange(m, dtype=jnp.int32)
    skey, pos = jax.lax.sort((key, iota), num_keys=1)
    owner_s = jnp.minimum(skey // rows, ndev)
    is_new = jnp.concatenate([
        jnp.ones((1,), jnp.int32),
        (skey[1:] != skey[:-1]).astype(jnp.int32),
    ])
    urank = jnp.cumsum(is_new) - 1  # global unique rank (sorted order)
    ofirst = jnp.searchsorted(owner_s, owner_s, side="left")
    rank = urank - jnp.take(urank, ofirst)  # unique rank within owner group
    fits = (owner_s < ndev) & (rank < cap)
    slot_sorted = jnp.where(fits, owner_s * cap + rank, ndev * cap)
    slot_for_pos = jnp.zeros(m, jnp.int32).at[pos].set(slot_sorted)
    overflow = jnp.sum(is_new * ((owner_s < ndev) & (rank >= cap)))
    return slot_for_pos, ok, overflow


def _a2a_cap(m: int, ndev: int, capacity_factor: float, rows: int) -> int:
    """Bucket capacity: ceil(m * capacity_factor / ndev), never more than
    the owner's row count — a sender cannot address more UNIQUE rows on one
    shard than the shard holds, so when the `rows` bound binds, overflow is
    IMPOSSIBLE by construction (and small tables' buckets shrink to their
    shard size, cutting wire bytes: the flagship 50k-item table's exchange
    drops ~5x vs batch-proportional buckets at B_loc=262k)."""
    cap = max(int(m * capacity_factor) // ndev, 1)
    cap = min(cap, rows)
    return -(-cap // 8) * 8  # sublane multiple


def make_alltoall_lookup(mesh, capacity_factor: float = 1.25,
                         wire_dtype: str = "float32"):
    """Weighted-sum pooled lookup over a row-sharded table, all-to-all
    exchange. Same result class as `make_sharded_lookup` (exact f32 rows,
    f32 pooling; `wire_dtype="bfloat16"` rounds row payloads once on the
    wire, opt-in). Returns (pooled [B_loc, D], overflow count)."""
    wdt = jnp.dtype(wire_dtype)

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(FLAT_AXES, None), P(DATA_AXIS, None), P(DATA_AXIS, None)),
        out_specs=(P(DATA_AXIS, None), P()),
        check_vma=False,
    )
    def lookup(table_shard, ids, w):
        ndev = jax.lax.axis_size(FLAT_AXES)
        didx = jax.lax.axis_index(FLAT_AXES)
        model_size = jax.lax.axis_size(MODEL_AXIS)
        my_model = jax.lax.axis_index(MODEL_AXIS)
        rows, d = table_shard.shape
        b, slots = ids.shape
        m = b * slots
        cap = _a2a_cap(m, ndev, capacity_factor, rows)
        flat_ids = ids.reshape(m).astype(jnp.int32)
        w_flat = w.reshape(m)
        owner = jnp.clip(flat_ids // rows, 0, ndev - 1)
        responsible = (owner % model_size) == my_model
        slot, ok, overflow = _a2a_route(flat_ids, w_flat, rows, ndev, cap,
                                        responsible)
        sentinel = jnp.int32(ndev * rows)
        send_ids = jnp.full((ndev * cap + 1,), sentinel, jnp.int32)
        send_ids = send_ids.at[slot].set(flat_ids)[: ndev * cap]
        recv_ids = jax.lax.all_to_all(
            send_ids.reshape(ndev, cap), FLAT_AXES,
            split_axis=0, concat_axis=0, tiled=True,
        ).reshape(-1)
        local_req = recv_ids - didx * rows
        req_ok = (local_req >= 0) & (local_req < rows)
        rows_req = jnp.take(table_shard, jnp.where(req_ok, local_req, 0), axis=0)
        rows_req = jnp.where(req_ok[:, None], rows_req, 0).astype(wdt)
        resp = jax.lax.all_to_all(
            rows_req.reshape(ndev, cap, d), FLAT_AXES,
            split_axis=0, concat_axis=0, tiled=True,
        ).reshape(-1, d).astype(jnp.float32)
        resp = jnp.concatenate([resp, jnp.zeros((1, d), jnp.float32)])
        emb = jnp.take(resp, slot, axis=0)  # dump slot -> zero row
        w_eff = jnp.where(ok, w_flat, 0.0)
        pooled = (emb * w_eff[:, None]).reshape(b, slots, d).sum(axis=1)
        pooled = jax.lax.psum(pooled, MODEL_AXIS)
        return pooled, jax.lax.psum(overflow, FLAT_AXES)

    return lookup


def make_alltoall_update(mesh, lr: float, eps: float,
                         capacity_factor: float = 1.25,
                         wire_dtype: str = "float32"):
    """Fused row-wise Adagrad over a row-sharded table, all-to-all exchange:
    each replica routes its (w-scaled) per-slot grads straight to the id's
    owning shard, which aggregates duplicates with the sorted-segment update
    (same numerics class as the dense scheme — f32 summation order).
    Returns (table, acc, overflow count)."""
    wdt = jnp.dtype(wire_dtype)

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(
            P(FLAT_AXES, None), P(FLAT_AXES),
            P(DATA_AXIS, None), P(DATA_AXIS, None), P(DATA_AXIS, None, None),
        ),
        out_specs=(P(FLAT_AXES, None), P(FLAT_AXES), P()),
        check_vma=False,
    )
    def update(table_shard, acc_shard, ids, w, row_g):
        ndev = jax.lax.axis_size(FLAT_AXES)
        didx = jax.lax.axis_index(FLAT_AXES)
        model_size = jax.lax.axis_size(MODEL_AXIS)
        my_model = jax.lax.axis_index(MODEL_AXIS)
        rows, d = table_shard.shape
        b, slots = ids.shape
        m = b * slots
        cap = _a2a_cap(m, ndev, capacity_factor, rows)
        flat_ids = ids.reshape(m).astype(jnp.int32)
        w_flat = w.reshape(m)
        owner = jnp.clip(flat_ids // rows, 0, ndev - 1)
        responsible = (owner % model_size) == my_model
        slot, ok, overflow = _a2a_route(flat_ids, w_flat, rows, ndev, cap,
                                        responsible)
        sentinel = jnp.int32(ndev * rows)
        send_ids = jnp.full((ndev * cap + 1,), sentinel, jnp.int32)
        send_ids = send_ids.at[slot].set(
            jnp.where(ok, flat_ids, sentinel))[: ndev * cap]
        g_flat = row_g.reshape(m, d)
        # duplicate ids share a slot: scatter-ADD pre-aggregates their grads
        # locally (f32), so each distinct row crosses the wire once
        send_g = jnp.zeros((ndev * cap + 1, d), jnp.float32)
        send_g = send_g.at[slot].add(
            jnp.where(ok[:, None], g_flat, 0.0))[: ndev * cap].astype(wdt)
        recv_ids = jax.lax.all_to_all(
            send_ids.reshape(ndev, cap), FLAT_AXES,
            split_axis=0, concat_axis=0, tiled=True,
        ).reshape(-1)
        recv_g = jax.lax.all_to_all(
            send_g.reshape(ndev, cap, d), FLAT_AXES,
            split_axis=0, concat_axis=0, tiled=True,
        ).reshape(-1, d).astype(jnp.float32)
        local_req = recv_ids - didx * rows
        req_ok = (local_req >= 0) & (local_req < rows)
        flat_local = jnp.where(req_ok, local_req, rows).astype(jnp.int32)
        new_t, new_a = opt_lib.sparse_rowwise_adagrad(
            table_shard, acc_shard, flat_local, recv_g, lr, eps)
        return new_t, new_a, jax.lax.psum(overflow, FLAT_AXES)

    return update


def make_sharded_update(mesh, lr: float, eps: float):
    """Fused row-wise Adagrad on a row-sharded table. `row_g` is the per-slot
    gradient [B_loc, Lt, D] (already weight-scaled); each device applies only
    the rows it owns, so every row is updated exactly once globally."""

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(
            P(FLAT_AXES, None), P(FLAT_AXES),
            P(DATA_AXIS, None), P(DATA_AXIS, None), P(DATA_AXIS, None, None),
        ),
        out_specs=(P(FLAT_AXES, None), P(FLAT_AXES)),
        check_vma=False,
    )
    def update(table_shard, acc_shard, ids, w, row_g):
        didx = jax.lax.axis_index(FLAT_AXES)
        ids_all = jax.lax.all_gather(ids, DATA_AXIS, axis=0, tiled=True)
        w_all = jax.lax.all_gather(w, DATA_AXIS, axis=0, tiled=True)
        g_all = jax.lax.all_gather(row_g, DATA_AXIS, axis=0, tiled=True)
        rows = table_shard.shape[0]
        local = ids_all - didx * rows
        ok = (local >= 0) & (local < rows) & (w_all != 0)
        flat_ids = jnp.where(ok, local, rows).astype(jnp.int32).reshape(-1)
        flat_g = g_all.reshape(-1, g_all.shape[-1])
        return opt_lib.sparse_rowwise_adagrad(table_shard, acc_shard, flat_ids, flat_g, lr, eps)

    return update


def make_replicated_update(mesh, lr: float, eps: float):
    """DDP-style update for replicated tables: all_gather the batch grads over
    data, run the identical sparse update on every device (deterministic, so
    replicas stay bitwise in sync — no grad psum of a table-shaped buffer)."""

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(
            P(), P(),
            P(DATA_AXIS, None), P(DATA_AXIS, None), P(DATA_AXIS, None, None),
        ),
        out_specs=(P(), P()),
        check_vma=False,
    )
    def update(table, acc, ids, w, row_g):
        from two_tower_recommender_model.ops.quantized import (
            QuantizedTable,
            quantized_rowwise_adagrad,
        )

        ids_all = jax.lax.all_gather(ids, DATA_AXIS, axis=0, tiled=True)
        w_all = jax.lax.all_gather(w, DATA_AXIS, axis=0, tiled=True)
        g_all = jax.lax.all_gather(row_g, DATA_AXIS, axis=0, tiled=True)
        n = table.shape[0]
        flat_ids = jnp.where(w_all != 0, ids_all, n).astype(jnp.int32).reshape(-1)
        flat_g = g_all.reshape(-1, g_all.shape[-1])
        if isinstance(table, QuantizedTable):
            return quantized_rowwise_adagrad(table, acc, flat_ids, flat_g, lr, eps)
        return opt_lib.sparse_rowwise_adagrad(table, acc, flat_ids, flat_g, lr, eps)

    return update


def make_sorted_sharded_update(
    mesh, lr: float, eps: float, buffer_dtype=None, quantized: bool = False,
):
    """Row-sharded fused Adagrad for the host-sorted feature's table.

    The globally sorted id stream stays non-decreasing after subtracting the
    shard base, so each device can use the transient-dense scatter with the
    `indices_are_sorted` hint on its own rows. Below-shard ids go negative —
    jnp scatters WRAP negative indices (verified), so the scatter path
    zero-gates those grads and clamps ids into [0, rows] (row 0 then
    aggregates an exact zero, a no-op update).

    Requires the GLOBAL batch sorted by this table's hashed ids — true when
    one process feeds the whole batch (`PackedFeaturizer(sort_feature=...)`).
    Multi-host slices are only per-host sorted; the builder gates on
    `jax.process_count() == 1`.

    `quantized=True` expects an int8 `QuantizedTable` shard and takes the
    quantized segment update (which drops out-of-range ids itself)."""
    from two_tower_recommender_model.ops.quantized import (
        QuantizedTable,
        quantized_rowwise_adagrad,
    )

    table_spec = (
        QuantizedTable(values=P(FLAT_AXES, None), scales=P(FLAT_AXES))
        if quantized else P(FLAT_AXES, None)
    )

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(
            table_spec, P(FLAT_AXES),
            P(DATA_AXIS, None), P(DATA_AXIS, None), P(DATA_AXIS, None, None),
        ),
        out_specs=(table_spec, P(FLAT_AXES)),
        check_vma=False,
    )
    def update(table_shard, acc_shard, ids, w, row_g):
        didx = jax.lax.axis_index(FLAT_AXES)
        ids_all = jax.lax.all_gather(ids, DATA_AXIS, axis=0, tiled=True)
        w_all = jax.lax.all_gather(w, DATA_AXIS, axis=0, tiled=True)
        g_all = jax.lax.all_gather(row_g, DATA_AXIS, axis=0, tiled=True)
        rows = (table_shard.values if quantized else table_shard).shape[0]
        sentinel = mesh.devices.size * rows
        key = jnp.where(w_all != 0, ids_all, sentinel).astype(jnp.int32)
        local = key.reshape(-1) - didx * rows  # non-decreasing
        flat_g = g_all.reshape(-1, g_all.shape[-1])
        if quantized:
            return quantized_rowwise_adagrad(
                table_shard, acc_shard, local, flat_g, lr, eps
            )
        upd = opt_lib.pick_sparse_update(rows, local.shape[0])
        if upd is opt_lib.dense_rowwise_adagrad:
            flat_g = jnp.where((local >= 0)[:, None], flat_g, 0.0)
            flat_ids = jnp.clip(local, 0, rows)
            return opt_lib.dense_rowwise_adagrad(
                table_shard, acc_shard, flat_ids, flat_g, lr, eps,
                ids_sorted=True, buffer_dtype=buffer_dtype,
            )
        # segment path sorts internally and drops out-of-range rows itself
        return opt_lib.sparse_rowwise_adagrad(
            table_shard, acc_shard, local, flat_g, lr, eps
        )

    return update


def make_replicated_sorted_update(mesh, lr: float, eps: float, buffer_dtype=None):
    """DDP-style update for a REPLICATED table whose feature is host-sorted:
    the gathered global flat ids are non-decreasing (missing slots carry the
    sentinel n, which the host sort keyed them by), so the deterministic
    every-device update can take the `indices_are_sorted` transient-dense
    fast path when the table is small enough for it to win."""

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(
            P(), P(),
            P(DATA_AXIS, None), P(DATA_AXIS, None), P(DATA_AXIS, None, None),
        ),
        out_specs=(P(), P()),
        check_vma=False,
    )
    def update(table, acc, ids, w, row_g):
        ids_all = jax.lax.all_gather(ids, DATA_AXIS, axis=0, tiled=True)
        w_all = jax.lax.all_gather(w, DATA_AXIS, axis=0, tiled=True)
        g_all = jax.lax.all_gather(row_g, DATA_AXIS, axis=0, tiled=True)
        n = table.shape[0]
        flat_ids = jnp.where(w_all != 0, ids_all, n).astype(jnp.int32).reshape(-1)
        flat_g = g_all.reshape(-1, g_all.shape[-1])
        upd = opt_lib.pick_sparse_update(n, flat_ids.shape[0])
        if upd is opt_lib.dense_rowwise_adagrad:
            return opt_lib.dense_rowwise_adagrad(
                table, acc, flat_ids, flat_g, lr, eps,
                ids_sorted=True, buffer_dtype=buffer_dtype,
            )
        return opt_lib.sparse_rowwise_adagrad(table, acc, flat_ids, flat_g, lr, eps)

    return update


def make_column_lookup(mesh):
    """Weighted-sum pooled lookup over a column-sharded table: every device
    holds all rows for a column slice; the slices concat back via an
    all_gather on the feature axis."""

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(None, FLAT_AXES), P(DATA_AXIS, None), P(DATA_AXIS, None)),
        out_specs=P(DATA_AXIS, None),
        check_vma=False,
    )
    def lookup(table_cols, ids, w):
        ids_all = jax.lax.all_gather(ids, DATA_AXIS, axis=0, tiled=True)
        w_all = jax.lax.all_gather(w, DATA_AXIS, axis=0, tiled=True)
        emb = jnp.take(table_cols, ids_all, axis=0)
        part = (emb * jnp.where(w_all != 0, w_all, 0.0)[..., None].astype(emb.dtype)).sum(1)
        full = jax.lax.all_gather(part, FLAT_AXES, axis=1, tiled=True)  # [B_glob, D_pad]
        didx = jax.lax.axis_index(DATA_AXIS)
        b_loc = ids.shape[0]
        return jax.lax.dynamic_slice_in_dim(full, didx * b_loc, b_loc, axis=0)

    return lookup


def make_column_update(mesh, lr: float, eps: float, full_dim: int):
    """Row-wise Adagrad on a column-sharded table: weight update touches local
    columns; the per-row squared-grad reduction psums across column shards so
    the replicated accumulator stays consistent."""

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(
            P(None, FLAT_AXES), P(),
            P(DATA_AXIS, None), P(DATA_AXIS, None), P(DATA_AXIS, None, None),
        ),
        out_specs=(P(None, FLAT_AXES), P()),
        check_vma=False,
    )
    def update(table_cols, acc, ids, w, row_g):
        ids_all = jax.lax.all_gather(ids, DATA_AXIS, axis=0, tiled=True)
        w_all = jax.lax.all_gather(w, DATA_AXIS, axis=0, tiled=True)
        g_all = jax.lax.all_gather(row_g, DATA_AXIS, axis=0, tiled=True)  # [B_glob, Lt, D_pad]
        didx = jax.lax.axis_index(FLAT_AXES)
        d_loc = table_cols.shape[1]
        g_cols = jax.lax.dynamic_slice_in_dim(g_all, didx * d_loc, d_loc, axis=2)
        n = table_cols.shape[0]
        flat_ids = jnp.where(w_all != 0, ids_all, n).astype(jnp.int32).reshape(-1)
        flat_g = g_cols.reshape(-1, d_loc)
        return opt_lib.sparse_rowwise_adagrad_columns(
            table_cols, acc, flat_ids, flat_g, lr, eps, full_dim, psum_axis=FLAT_AXES
        )

    return update


# ---------------------------------------------------------------------------
# forward / train / eval step builders


def _pool_weights(fc, feat):
    """Effective per-slot weights: mask for sum pooling, mask/count for mean —
    turns both poolings into weighted-sum so one kernel serves both."""
    w = feat.mask
    if fc.pooling == "mean":
        counts = w.sum(axis=1, keepdims=True)
        w = w / jnp.maximum(counts, 1.0)
    return w


def _local_weighted_pool(table, ids, w):
    emb = jnp.take(table, ids, axis=0)
    return (emb * w[..., None].astype(emb.dtype)).sum(axis=1)


def make_sharded_forward(
    model_cfg: ModelConfig,
    mesh,
    plan: ShardingPlan,
    exchange: str = "dense",
    capacity_factor: float = 1.25,
    exchange_wire_dtype: str = "float32",
):
    from two_tower_recommender_model.ops.quantized import (
        QuantizedTable,
        quantized_pooled_lookup,
    )

    lookup = make_sharded_lookup(mesh)
    a2a_lookup = None
    if exchange == "alltoall":
        a2a_lookup = make_alltoall_lookup(
            mesh, capacity_factor=capacity_factor, wire_dtype=exchange_wire_dtype
        )
    elif exchange != "dense":
        raise ValueError(f"sharded_exchange must be dense|alltoall, got {exchange!r}")
    col_lookup = make_column_lookup(mesh)
    q_lookup = make_quantized_sharded_lookup(mesh)

    def pooled_embeddings(tables, batch: Batch):
        """(pooled, weights, overflow) — overflow is the alltoall
        exchange's dropped-distinct-id count summed over features (None
        under the dense exchange), so EVERY consumer of the forward can
        surface capacity overflow instead of silently pooling zero rows
        for the dropped ids."""
        pooled, weights = {}, {}
        overflow = None
        for fc in model_cfg.features:
            feat = batch.features[fc.name]
            w = _pool_weights(fc, feat)
            weights[fc.name] = w
            spec = plan[fc.table]
            if spec.strategy == TABLE_WISE:
                # bucket coordinates: owner's shard base + table offset + id.
                # Dead slots (w == 0) are excluded inside the lookup, so their
                # translated ids are harmless.
                r = plan.buckets[spec.bucket].rows_per_device
                base = spec.owner * r + spec.bucket_offset
                bucket_arr = tables[spec.bucket]
                # buckets keep the dense exchange even under "alltoall":
                # table-wise concentrates every id of a table on ONE owner,
                # so bucket a2a would need m-sized (not m/ndev) capacity —
                # no better than the dense scheme it would replace
                bucket_lookup = (
                    q_lookup if isinstance(bucket_arr, QuantizedTable) else lookup
                )
                pooled[fc.name] = bucket_lookup(bucket_arr, feat.ids + base, w)
                continue
            table = tables[fc.table]
            if isinstance(table, QuantizedTable):
                if spec.strategy == ROW_SHARDED:
                    pooled[fc.name] = q_lookup(table, feat.ids, w)
                else:  # replicated
                    pooled[fc.name] = quantized_pooled_lookup(table, feat.ids, w)
            elif spec.strategy == ROW_SHARDED:
                if a2a_lookup is not None:
                    pooled[fc.name], ovf = a2a_lookup(tables[fc.table], feat.ids, w)
                    overflow = ovf if overflow is None else overflow + ovf
                else:
                    pooled[fc.name] = lookup(tables[fc.table], feat.ids, w)
            elif spec.strategy == COLUMN_SHARDED:
                out = col_lookup(tables[fc.table], feat.ids, w)
                if spec.padded_dim > spec.embedding_dim:
                    out = out[:, : spec.embedding_dim]
                pooled[fc.name] = out
            else:
                pooled[fc.name] = _local_weighted_pool(tables[fc.table], feat.ids, w)
        return pooled, weights, overflow

    def forward(state: TrainState, batch: Batch):
        pooled, _, overflow = pooled_embeddings(state.tables, batch)
        q, c = two_tower.towers_forward(
            {**state.dense_params}, pooled, batch.dense, model_cfg
        )
        return q, c, overflow

    return forward, pooled_embeddings


def make_sharded_train_step(
    model_cfg: ModelConfig,
    train_cfg: TrainConfig,
    dense_opt: optax.GradientTransformation,
    mesh,
    plan: ShardingPlan,
    donate: bool = True,
    jit: bool = True,
):
    """Multi-chip train step: same two-stage backward as the single-device
    step (`train/step.py`), with sharded lookup/update collectives. Dense
    tower grads sync over the data axis automatically (replicated params,
    data-sharded batch => XLA inserts the psum)."""
    from two_tower_recommender_model.train.step import validate_sorted_feature

    loss_fn = losses_lib.loss_fn_from_config(train_cfg, model_cfg)
    sorted_table = validate_sorted_feature(model_cfg, train_cfg)
    if sorted_table is not None:
        if jax.process_count() > 1:
            raise ValueError(
                "sorted_feature in the sharded step requires a single process "
                "(multi-host batch slices are only per-host sorted; the "
                "per-shard sorted fast paths need the GLOBAL batch sorted)"
            )
        if plan[sorted_table].strategy not in (ROW_SHARDED, REPLICATED):
            raise ValueError(
                f"sorted_feature table {sorted_table!r} must be row_sharded or "
                f"replicated in the sharded step (plan says "
                f"{plan[sorted_table].strategy})"
            )
    _, pooled_embeddings = make_sharded_forward(
        model_cfg, mesh, plan,
        exchange=train_cfg.sharded_exchange,
        capacity_factor=train_cfg.exchange_capacity_factor,
        exchange_wire_dtype=train_cfg.exchange_wire_dtype,
    )
    sharded_update = make_sharded_update(
        mesh, train_cfg.sparse_learning_rate, train_cfg.adagrad_eps
    )
    a2a_update = None
    if train_cfg.sharded_exchange == "alltoall":
        a2a_update = make_alltoall_update(
            mesh, train_cfg.sparse_learning_rate, train_cfg.adagrad_eps,
            capacity_factor=train_cfg.exchange_capacity_factor,
            wire_dtype=train_cfg.exchange_wire_dtype,
        )
    sorted_update = sorted_rep_update = None
    if sorted_table is not None:
        sorted_buf = (
            jnp.bfloat16 if train_cfg.scatter_buffer_dtype == "bfloat16" else None
        )
        if plan[sorted_table].strategy == ROW_SHARDED:
            sorted_update = make_sorted_sharded_update(
                mesh, train_cfg.sparse_learning_rate, train_cfg.adagrad_eps,
                buffer_dtype=sorted_buf,
                quantized=model_cfg.table_dtype_of(sorted_table) == "int8",
            )
        else:  # replicated
            sorted_rep_update = make_replicated_sorted_update(
                mesh, train_cfg.sparse_learning_rate, train_cfg.adagrad_eps,
                buffer_dtype=sorted_buf,
            )
    replicated_update = make_replicated_update(
        mesh, train_cfg.sparse_learning_rate, train_cfg.adagrad_eps
    )
    column_updates = {
        t.name: make_column_update(
            mesh, train_cfg.sparse_learning_rate, train_cfg.adagrad_eps, t.embedding_dim
        )
        for t in model_cfg.tables
        if plan[t.name].strategy == COLUMN_SHARDED
    }
    q_sharded_update = make_quantized_sharded_update(
        mesh, train_cfg.sparse_learning_rate, train_cfg.adagrad_eps
    )

    cand_feature = model_cfg.candidate_tower.features[0]

    def step(state: TrainState, batch: Batch):
        pooled, weights, fwd_overflow = pooled_embeddings(state.tables, batch)

        log_q = None
        new_counts = state.item_counts
        if state.item_counts is not None:
            cand_ids = batch.features[cand_feature].ids[:, 0]
            new_counts = state.item_counts.at[cand_ids].add(1.0)
            log_q = losses_lib.item_log_q_from_counts(new_counts, cand_ids)

        def loss_of(dense_params, pooled):
            q, c = two_tower.towers_forward(dense_params, pooled, batch.dense, model_cfg)
            loss, logits = loss_fn(q, c, batch, log_q=log_q)
            return loss, logits

        (loss, logits), (d_dense, d_pooled) = jax.value_and_grad(
            loss_of, argnums=(0, 1), has_aux=True
        )(state.dense_params, pooled)

        updates, new_opt_state = dense_opt.update(
            d_dense, state.dense_opt_state, state.dense_params
        )
        new_dense = optax.apply_updates(state.dense_params, updates)

        # Per-table flat (ids [B, Lt], w [B, Lt], row_g [B, Lt, D]) across the
        # features reading that table — aggregation across features happens
        # inside the fused update, matching the dense-autodiff oracle.
        # Table-wise tables group under their BUCKET (ids translated to
        # bucket coordinates), so every table-wise table of one dim updates
        # through ONE collective call.
        per_table: dict[str, list] = {}
        for fc in model_cfg.features:
            feat = batch.features[fc.name]
            w = weights[fc.name]
            row_g = d_pooled[fc.name][:, None, :] * w[..., None].astype(d_pooled[fc.name].dtype)
            spec = plan[fc.table]
            if spec.strategy == TABLE_WISE:
                r = plan.buckets[spec.bucket].rows_per_device
                base = spec.owner * r + spec.bucket_offset
                per_table.setdefault(spec.bucket, []).append((feat.ids + base, w, row_g))
            else:
                per_table.setdefault(fc.table, []).append((feat.ids, w, row_g))

        new_tables = dict(state.tables)
        new_acc = dict(state.adagrad_acc)
        overflow = fwd_overflow  # forward + backward routing drops, summed
        for tname, parts in per_table.items():
            ids = jnp.concatenate([p[0] for p in parts], axis=1)
            w = jnp.concatenate([p[1] for p in parts], axis=1)
            row_g = jnp.concatenate([p[2] for p in parts], axis=1)
            from two_tower_recommender_model.ops.quantized import QuantizedTable

            if tname in plan.buckets:
                # bucket is a row-sharded array (QuantizedTable for int8);
                # buckets keep the dense exchange (see make_sharded_forward)
                upd = (
                    q_sharded_update
                    if isinstance(state.tables[tname], QuantizedTable)
                    else sharded_update
                )
            else:
                spec = plan[tname]
                quantized = isinstance(state.tables[tname], QuantizedTable)
                if spec.strategy == COLUMN_SHARDED:
                    if spec.padded_dim > spec.embedding_dim:
                        row_g = jnp.pad(
                            row_g, ((0, 0), (0, 0), (0, spec.padded_dim - spec.embedding_dim))
                        )
                    upd = column_updates[tname]
                elif spec.strategy == ROW_SHARDED:
                    if tname == sorted_table:
                        # built with quantized=True when the table is int8
                        upd = sorted_update
                    elif quantized:
                        upd = q_sharded_update
                    else:
                        upd = a2a_update if a2a_update is not None else sharded_update
                elif tname == sorted_table and not quantized:
                    upd = sorted_rep_update
                else:
                    upd = replicated_update
            if upd is a2a_update:
                new_tables[tname], new_acc[tname], ovf = upd(
                    state.tables[tname], state.adagrad_acc[tname], ids, w, row_g
                )
                overflow = ovf if overflow is None else overflow + ovf
            else:
                new_tables[tname], new_acc[tname] = upd(
                    state.tables[tname], state.adagrad_acc[tname], ids, w, row_g
                )

        new_state = TrainState(
            step=state.step + 1,
            tables=new_tables,
            adagrad_acc=new_acc,
            dense_params=new_dense,
            dense_opt_state=new_opt_state,
            item_counts=new_counts,
        )
        out = {"loss": loss, "logits": logits}
        if overflow is not None:
            # nonzero => ids were dropped this step (bucket capacity): raise
            # exchange_capacity_factor. See TrainConfig.sharded_exchange.
            out["exchange_overflow"] = overflow
        return new_state, out

    if not jit:
        return step
    return jax.jit(step, donate_argnums=(0,) if donate else ())


def _scan_out(out: dict):
    """Per-step outputs carried through the macro scan: loss always; the
    alltoall exchange's dropped-id count when that route is active (the
    overflow guard must survive macro batching — silent drops are the one
    failure mode the static-capacity design is not allowed to have)."""
    if "exchange_overflow" in out:
        return (out["loss"], out["exchange_overflow"])
    return out["loss"]


def _macro_out(outs):
    if isinstance(outs, tuple):
        losses, ovf = outs
        return {"loss": losses, "exchange_overflow": ovf.sum()}
    return {"loss": outs}


def make_sharded_multi_step(
    model_cfg: ModelConfig,
    train_cfg: TrainConfig,
    dense_opt: optax.GradientTransformation,
    mesh,
    plan: ShardingPlan,
    pack_label: bool = True,
    donate: bool = True,
):
    """Multi-chip packed fast path: K sharded train steps per dispatch —
    `lax.scan` over a stacked `PackedBatch` (leading axis K; batch axis
    sharded over data) with the device-side unpack fused in. The multi-chip
    form of `make_multi_step` + `unpack_batch`; use `macro_batch_sharding`
    to place the macro payload."""

    core = make_sharded_train_step(
        model_cfg, train_cfg, dense_opt, mesh, plan, donate=False, jit=False
    )

    def multi(state: TrainState, packed_mb):
        def body(carry, pb):
            new_state, out = core(
                carry, unpack_batch(pb, model_cfg, pack_label=pack_label)
            )
            return new_state, _scan_out(out)

        state, outs = jax.lax.scan(body, state, packed_mb)
        return state, _macro_out(outs)

    return jax.jit(multi, donate_argnums=(0,) if donate else ())


def macro_batch_sharding(mesh) -> Callable:
    """Leaf -> NamedSharding for stacked macro batches [K, B, ...]: the K
    axis replicated, the batch axis on data."""
    def fn(x):
        if x.ndim < 2 or x.shape[-1] == 0:
            return NamedSharding(mesh, P())
        spec = P(None, DATA_AXIS, *([None] * (x.ndim - 2)))
        return NamedSharding(mesh, spec)
    return fn


def make_sharded_compact_multi_step(
    model_cfg: ModelConfig,
    train_cfg: TrainConfig,
    dense_opt: optax.GradientTransformation,
    mesh,
    plan: ShardingPlan,
    scheme,
    donate: bool = True,
):
    """Multi-chip packed fast path over the COMPACT wire: K sharded train
    steps per dispatch scanning stacked `CompactBatch`es. The in-jit decode
    (`batch_from_compact`) is elementwise per example, so GSPMD partitions it
    along the data-sharded batch axis for free; a delta-encoded sorted slot's
    cumsum reconstruction spans the batch axis, which XLA partitions with a
    small prefix collective. Place payloads with `compact_macro_shardings`.
    A delta slot needs either a single process (global sort) or
    `scheme.delta_segments == process_count` (per-process sorts; the cumsum
    resets at process-slice boundaries)."""
    from two_tower_recommender_model.data.compact import batch_from_compact

    if (scheme.delta_feature is not None and jax.process_count() > 1
            and scheme.delta_segments != jax.process_count()):
        raise ValueError(
            "delta wire across processes needs CompactScheme.from_model("
            f"..., delta_segments={jax.process_count()}) — got "
            f"{scheme.delta_segments}")
    core = make_sharded_train_step(
        model_cfg, train_cfg, dense_opt, mesh, plan, donate=False, jit=False
    )

    def multi(state: TrainState, macro_cb):
        def body(carry, cb):
            new_state, out = core(carry, batch_from_compact(cb, model_cfg, scheme))
            return new_state, _scan_out(out)

        state, outs = jax.lax.scan(body, state, macro_cb)
        return state, _macro_out(outs)

    return jax.jit(multi, donate_argnums=(0,) if donate else ())


def compact_macro_shardings(mesh, macro_cb):
    """CompactBatch-of-NamedShardings for a stacked macro CompactBatch
    [K, ...]: wire/rem shard their LAST (batch / batch-group) axis over data;
    labels/dense/weights shard the batch axis; delta sidecars replicate.
    Requires the per-shard slice widths to divide evenly (batch % (8 * data)
    == 0 when a rem buffer exists)."""
    from two_tower_recommender_model.data.compact import CompactBatch

    ndata = mesh.shape[DATA_AXIS]
    if macro_cb.wire.shape[-1] % ndata:
        raise ValueError(
            f"batch {macro_cb.wire.shape[-1]} must divide by data axis {ndata}"
        )
    if macro_cb.rem is not None and macro_cb.rem.shape[-1] % ndata:
        raise ValueError(
            f"compact rem groups {macro_cb.rem.shape[-1]} must divide by the "
            f"data axis {ndata} (need batch % {8 * ndata} == 0)"
        )
    d = lambda *spec: NamedSharding(mesh, P(*spec))  # noqa: E731
    return CompactBatch(
        wire=d(None, None, DATA_AXIS),
        rem=None if macro_cb.rem is None else d(None, None, DATA_AXIS),
        labels=d(None, DATA_AXIS) if macro_cb.labels.size else d(),
        dense=None if macro_cb.dense is None else d(None, DATA_AXIS, None),
        weights=None if macro_cb.weights is None else d(None, DATA_AXIS),
        delta_pos=None if macro_cb.delta_pos is None else d(),
        delta_extra=None if macro_cb.delta_extra is None else d(),
    )


def compact_macro_shardings_for_scheme(
    mesh, scheme, labels_packed: bool | None = None,
    dense: bool = False, weights: bool = False, macro: bool = True,
    batch_size: int | None = None,
):
    """Like `compact_macro_shardings` but built from the static CompactScheme
    (no example batch needed — e.g. before the first loader batch exists).
    `macro=False` produces shardings for a SINGLE CompactBatch (tail steps).
    Pass `batch_size` to fail loudly on divisibility up front (the same
    checks `compact_macro_shardings` runs against an example batch)."""
    from two_tower_recommender_model.data.compact import CompactBatch

    if batch_size is not None:
        ndata = mesh.shape[DATA_AXIS]
        if batch_size % ndata:
            raise ValueError(f"batch {batch_size} must divide by data axis {ndata}")
        if scheme.rem_bits_total and (batch_size // 8) % ndata:
            raise ValueError(
                f"compact rem groups {batch_size // 8} must divide by the "
                f"data axis {ndata} (need batch % {8 * ndata} == 0)"
            )
    if labels_packed is None:
        labels_packed = scheme.pack_label
    lead = (None,) if macro else ()
    d = lambda *spec: NamedSharding(mesh, P(*lead, *spec))  # noqa: E731
    rep = NamedSharding(mesh, P())
    return CompactBatch(
        wire=d(None, DATA_AXIS),
        rem=d(None, DATA_AXIS) if scheme.rem_bits_total else None,
        labels=rep if labels_packed else d(DATA_AXIS),
        dense=d(DATA_AXIS, None) if dense else None,
        weights=d(DATA_AXIS) if weights else None,
        # per-segment sidecars assemble [S*K] across processes (positions are
        # segment-relative); single-segment sidecars replicate
        delta_pos=(None if scheme.delta_feature is None
                   else d(DATA_AXIS) if scheme.delta_segments > 1 else rep),
        delta_extra=(None if scheme.delta_feature is None
                     else d(DATA_AXIS) if scheme.delta_segments > 1 else rep),
    )


def make_sharded_eval_step(model_cfg: ModelConfig, train_cfg: TrainConfig, mesh, plan: ShardingPlan):
    loss_fn = losses_lib.make_loss_fn("bce")
    forward, _ = make_sharded_forward(
        model_cfg, mesh, plan,
        exchange=train_cfg.sharded_exchange,
        capacity_factor=train_cfg.exchange_capacity_factor,
        exchange_wire_dtype=train_cfg.exchange_wire_dtype,
    )

    @jax.jit
    def step(state: TrainState, eval_state: EvalState, batch: Batch):
        q, c, overflow = forward(state, batch)
        loss, logits = loss_fn(q, c, batch)
        w = batch.weights
        if w is None:
            n = jnp.float32(batch.labels.shape[0])
        else:
            # zero-weight rows are padding: re-average the loss over real rows
            n = w.sum()
            loss = losses_lib.bce_with_logits(logits, batch.labels, w)
        new_ovf = eval_state.exchange_overflow
        if overflow is not None:
            new_ovf = (overflow if new_ovf is None else new_ovf + overflow)
        return EvalState(
            auroc=auroc_update(eval_state.auroc, logits, batch.labels, w),
            loss=mean_update(eval_state.loss, loss, n),
            exchange_overflow=new_ovf,
        )

    return step


# ---------------------------------------------------------------------------
# sharded retrieval


def make_sharded_topk(mesh, k: int, corpus_chunk: int = 4096):
    """Exact top-k over a corpus row-sharded across the flattened mesh.

    Each device scans its corpus shard with the chunked running-merge kernel
    (`ops/topk.py`), then the per-shard candidates (k per device) are
    all-gathered and merged — comm is O(devices * Q * k), never the scores
    matrix. The multi-chip form of the retrieval eval's ANN-service
    replacement (`04_evaluate_retrieval.py:131-141`).

    Corpora whose row count is not a device multiple (the common case —
    Instacart's 49,688 items minus the id-0 sentinel is 49,687) are padded
    here and the pad rows masked to -inf BEFORE each shard's local top-k, so
    they can never evict real candidates; returned indices are exact global
    rows of the unpadded corpus."""
    from two_tower_recommender_model.ops.topk import _topk_merge_scan

    ndev = int(mesh.devices.size)

    @functools.lru_cache(maxsize=8)
    def build(valid_global: int):
        @functools.partial(
            jax.shard_map,
            mesh=mesh,
            in_specs=(P(), P(FLAT_AXES, None)),
            out_specs=(P(), P()),
            check_vma=False,
        )
        def topk(queries, corpus_shard):
            rows = corpus_shard.shape[0]
            didx = jax.lax.axis_index(FLAT_AXES)
            # rows beyond the true corpus (global padding lands in the last
            # shard(s)) are masked inside the merge scan, pre-selection
            local_valid = jnp.clip(valid_global - didx * rows, 0, rows)
            chunk = min(corpus_chunk, rows)
            pad = (-rows) % chunk
            padded = jnp.pad(corpus_shard, ((0, pad), (0, 0))) if pad else corpus_shard
            vals, idx = _topk_merge_scan(queries, padded, k, chunk,
                                         valid=local_valid)
            idx = idx + didx * rows  # local -> global row ids
            # merge candidates from every shard
            av = jax.lax.all_gather(vals, FLAT_AXES, axis=0)  # [ndev, Q, k]
            ai = jax.lax.all_gather(idx, FLAT_AXES, axis=0)
            n = av.shape[0]
            av = jnp.moveaxis(av, 0, 1).reshape(queries.shape[0], n * k)
            ai = jnp.moveaxis(ai, 0, 1).reshape(queries.shape[0], n * k)
            best, pos = jax.lax.top_k(av, k)
            return best, jnp.take_along_axis(ai, pos, axis=1)

        return jax.jit(topk)

    def call(queries, corpus, valid: int | None = None):
        """`valid`: logical corpus rows when `corpus` is ALREADY padded to a
        device multiple (e.g. a serving corpus kept resident+sharded across
        calls) — rows past it are masked exactly like internally-added
        padding. Default: every row of `corpus` is real."""
        rows = corpus.shape[0]
        n = rows if valid is None else valid
        pad = (-rows) % ndev
        if pad:
            corpus = jnp.concatenate(
                [corpus, jnp.zeros((pad, corpus.shape[1]), corpus.dtype)])
        return build(n)(queries, corpus)

    return call


# ---------------------------------------------------------------------------
# quantized (int8) sharded tables


def make_quantized_sharded_lookup(mesh):
    """Row-sharded int8 lookup: like `make_sharded_lookup` but dequantizing
    local rows (int8 values + per-row scales) before the partial pool —
    gathers move 1/4 the HBM bytes."""
    from two_tower_recommender_model.ops.quantized import QuantizedTable

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(
            QuantizedTable(values=P(FLAT_AXES, None), scales=P(FLAT_AXES)),
            P(DATA_AXIS, None), P(DATA_AXIS, None),
        ),
        out_specs=P(DATA_AXIS, None),
        check_vma=False,
    )
    def lookup(qt_shard, ids, w):
        didx = jax.lax.axis_index(FLAT_AXES)
        ids_all = jax.lax.all_gather(ids, DATA_AXIS, axis=0, tiled=True)
        w_all = jax.lax.all_gather(w, DATA_AXIS, axis=0, tiled=True)
        rows = qt_shard.values.shape[0]
        local = ids_all - didx * rows
        ok = (local >= 0) & (local < rows) & (w_all != 0)
        safe = jnp.where(ok, local, 0)
        from two_tower_recommender_model.ops.quantized import (
            gather_int8_rows_scales,
        )

        emb, scales = gather_int8_rows_scales(qt_shard.values, qt_shard.scales, safe)
        emb = (emb.astype(jnp.float32) * (scales / 127.0)[..., None]
               * jnp.where(ok, w_all, 0.0)[..., None])
        part = emb.sum(axis=1)
        out = jax.lax.psum_scatter(part, DATA_AXIS, scatter_dimension=0, tiled=True)
        return jax.lax.psum(out, MODEL_AXIS)

    return lookup


def make_quantized_sharded_update(mesh, lr: float, eps: float):
    """Row-sharded int8 row-wise Adagrad: each device re-quantizes only the
    rows it owns."""
    from two_tower_recommender_model.ops.quantized import (
        QuantizedTable,
        quantized_rowwise_adagrad,
    )

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(
            QuantizedTable(values=P(FLAT_AXES, None), scales=P(FLAT_AXES)),
            P(FLAT_AXES),
            P(DATA_AXIS, None), P(DATA_AXIS, None), P(DATA_AXIS, None, None),
        ),
        out_specs=(
            QuantizedTable(values=P(FLAT_AXES, None), scales=P(FLAT_AXES)),
            P(FLAT_AXES),
        ),
        check_vma=False,
    )
    def update(qt_shard, acc_shard, ids, w, row_g):
        didx = jax.lax.axis_index(FLAT_AXES)
        ids_all = jax.lax.all_gather(ids, DATA_AXIS, axis=0, tiled=True)
        w_all = jax.lax.all_gather(w, DATA_AXIS, axis=0, tiled=True)
        g_all = jax.lax.all_gather(row_g, DATA_AXIS, axis=0, tiled=True)
        rows = qt_shard.values.shape[0]
        local = ids_all - didx * rows
        ok = (local >= 0) & (local < rows) & (w_all != 0)
        flat_ids = jnp.where(ok, local, rows).astype(jnp.int32).reshape(-1)
        flat_g = g_all.reshape(-1, g_all.shape[-1])
        return quantized_rowwise_adagrad(qt_shard, acc_shard, flat_ids, flat_g, lr, eps)

    return update
