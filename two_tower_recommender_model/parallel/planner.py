"""Memory- and comm-aware embedding sharding planner.

The role of TorchRec's `EmbeddingShardingPlanner` +
`HeuristicalStorageReservation(percentage=0.05)` + plan printout
(`03_model_training.py:797-822`): decide, per table, how to place it across
the mesh — accounting for HBM and per-step communication — and emit a
human-readable plan. The planner covers TorchRec's default sharder set
(`get_default_sharders()`, chosen from at `03_model_training.py:797-815`):

- ``replicated``    — every device holds a full copy; lookups are local, the
  update all-gathers batch grads and applies the same deterministic Adagrad
  step everywhere (DDP; the Composer path, `pytorch-model-training.py:350-518`).
- ``table_wise``    — the whole table lives on ONE device. All table-wise
  tables of one embedding dim share a single row-sharded "bucket" array whose
  per-device shard holds that device's assigned tables back to back (greedy
  balanced bin-packing) — so lookups/updates reuse the row-sharded collective
  path with an id offset, and ALL table-wise tables ride ONE collective group
  per bucket instead of one per table.
- ``row_sharded``   — rows split over the flattened (data, model) mesh.
- ``column_sharded``— dim split across devices (full rows everywhere).

Strategy choice is a COST MODEL, not a byte threshold: per table and
strategy we score

    cost = mem_bytes_per_device            (HBM pressure)
         + comm_bytes_per_step             (collective traffic at `batch_hint`)
         + COLLECTIVE_OVERHEAD_EQ          (per extra collective group)
         + IMBALANCE_WEIGHT * imbalance    (table-wise places T bytes on one
                                            device; penalize concentration)

and take the argmin (deterministic given inputs, so every process computes an
identical plan — the SPMD answer to `collective_plan`'s cross-rank agreement,
`03_model_training.py:809-811`).

Comm volumes per step (f32 bytes, B = batch_hint, L = slots, D = dim):
- replicated:  bwd grad all-gather        B*L*D*4
- row/table:   bwd grad all-gather        B*L*D*4
             + fwd psum_scatter + psum    2*B*D*4
             + fwd id all-gather          B*L*4
(The fwd comm of the sharded paths is what replication buys away; the memory
is what it costs.)
"""

from __future__ import annotations

import dataclasses

from two_tower_recommender_model.config import ModelConfig

REPLICATED = "replicated"
ROW_SHARDED = "row_sharded"
COLUMN_SHARDED = "column_sharded"
TABLE_WISE = "table_wise"

# Cost-model calibration (bytes-equivalent). COLLECTIVE_OVERHEAD_EQ charges
# each additional collective group the equivalent of moving ~8 MiB — the
# dispatch+latency cost of a separate shard_map collective set;
# IMBALANCE_WEIGHT penalizes concentrating a table's bytes on one device
# relative to spreading them.
COLLECTIVE_OVERHEAD_EQ = 8 << 20
IMBALANCE_WEIGHT = 0.25


def _bucket_name(dim: int, dtype: str) -> str:
    """Table-wise tables group into one physical bucket per (dim, dtype) —
    dtypes can't share an array. The float32 name stays suffix-free for
    plan-print stability."""
    return f"__tw_bucket_d{dim}__" if dtype == "float32" else f"__tw_bucket_d{dim}_{dtype}__"


@dataclasses.dataclass(frozen=True)
class TableShard:
    table: str
    strategy: str
    num_embeddings: int  # logical rows
    padded_rows: int  # physical rows (device multiple for row_sharded)
    embedding_dim: int
    bytes_per_device: int
    padded_dim: int = 0  # physical dim (device multiple, column_sharded only)
    owner: int = -1  # table_wise: owning device index (flattened mesh order)
    bucket: str = ""  # table_wise: physical bucket array name
    bucket_offset: int = 0  # table_wise: row offset inside the owner's shard

    @property
    def rows_per_device(self) -> int:
        return self.padded_rows  # replicated: full copy per device


@dataclasses.dataclass(frozen=True)
class BucketSpec:
    """One physical array holding all table-wise tables of one (embedding dim,
    dtype): shape [num_devices * rows_per_device, dim], row-sharded over the
    flattened mesh; device d's shard contains its assigned tables at their
    offsets. int8 buckets carry a parallel per-row scales array
    (QuantizedTable layout)."""

    name: str
    embedding_dim: int
    rows_per_device: int
    tables: tuple[str, ...]
    dtype: str = "float32"


@dataclasses.dataclass(frozen=True)
class ShardingPlan:
    num_devices: int
    specs: dict[str, TableShard]
    hbm_budget_bytes: int | None
    reserve_fraction: float
    buckets: dict[str, BucketSpec] = dataclasses.field(default_factory=dict)

    def __getitem__(self, table: str) -> TableShard:
        return self.specs[table]

    @property
    def total_bytes_per_device(self) -> int:
        # table-wise bytes_per_device already reports the balanced bucket
        # share; summing per-table would double-count, so count buckets once
        total = sum(
            s.bytes_per_device for s in self.specs.values() if s.strategy != TABLE_WISE
        )
        for b in self.buckets.values():
            total += (b.rows_per_device * b.embedding_dim + b.rows_per_device) * 4
        return total

    def describe(self) -> str:
        """Printable plan (the role of the reference's sharding-plan print,
        `03_model_training.py:818-822`)."""
        lines = [
            f"EmbeddingShardingPlan over {self.num_devices} device(s)"
            + (
                f"  [budget {self.hbm_budget_bytes/2**30:.1f} GiB/device,"
                f" reserve {self.reserve_fraction:.0%}]"
                if self.hbm_budget_bytes
                else ""
            ),
            f"{'table':<24}{'strategy':<16}{'rows':>12}{'padded':>12}{'dim':>6}"
            f"{'MiB/device':>12}  placement",
        ]
        for s in self.specs.values():
            place = ""
            if s.strategy == TABLE_WISE:
                place = f"dev {s.owner} @ {s.bucket}[{s.bucket_offset}:]"
            lines.append(
                f"{s.table:<24}{s.strategy:<16}{s.num_embeddings:>12}{s.padded_rows:>12}"
                f"{s.embedding_dim:>6}{s.bytes_per_device/2**20:>12.2f}  {place}"
            )
        for b in self.buckets.values():
            lines.append(
                f"{b.name:<24}{'(bucket)':<16}{b.rows_per_device*self.num_devices:>12}"
                f"{'':>12}{b.embedding_dim:>6}"
                f"{(b.rows_per_device*b.embedding_dim+b.rows_per_device)*4/2**20:>12.2f}"
                f"  tables: {', '.join(b.tables)}"
            )
        lines.append(f"{'total':<24}{'':<16}{'':>12}{'':>12}{'':>6}"
                     f"{self.total_bytes_per_device/2**20:>12.2f}")
        return "\n".join(lines)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _strategy_costs(
    table_bytes: int, num_devices: int, b: int, slots: int, dim: int,
) -> dict[str, float]:
    """Per-strategy score (bytes-equivalent, per device per step):

    - `gather`/`update`: HBM traffic of the fwd row reads and the fused
      row-wise update (read+write touched rows + grad buffer). Replication
      pays it in FULL on every device (each replica rewrites every touched
      row); sharded strategies split it ~1/num_devices.
    - `bwd_comm`: the grad all-gather every strategy performs.
    - `fwd_comm`: psum_scatter + psum + id all-gather, sharded paths only.
    - memory enters as bytes/device (capacity pressure + tie-break).
    - table_wise concentrates the table's bytes on one device (imbalance
      penalty) but shares its collective group with every other table-wise
      table via the bucket; row_sharded pays its own group (overhead term).
    """
    bwd_comm = b * slots * dim * 4
    fwd_comm = 2 * b * dim * 4 + b * slots * 4
    gather = b * slots * dim * 4
    update = 3 * b * slots * dim * 4
    imb = IMBALANCE_WEIGHT * table_bytes * (1 - 1 / num_devices)
    return {
        REPLICATED: table_bytes + gather + update + bwd_comm,
        ROW_SHARDED: (
            table_bytes / num_devices + (gather + update) / num_devices
            + bwd_comm + fwd_comm + COLLECTIVE_OVERHEAD_EQ
        ),
        TABLE_WISE: (
            table_bytes / num_devices + (gather + update) / num_devices
            + bwd_comm + fwd_comm + imb
        ),
    }


def plan_sharding(
    model_cfg: ModelConfig,
    num_devices: int,
    hbm_budget_bytes: int | None = None,
    replicate_threshold_bytes: int = 4 << 20,
    reserve_fraction: float = 0.05,
    force: dict[str, str] | None = None,
    bytes_per_param: int = 4,
    batch_hint: int = 65536,
) -> ShardingPlan:
    """Choose a strategy per table by the cost model above. `force` overrides
    per-table ({table_name: strategy}). Tables under
    `replicate_threshold_bytes` short-circuit to replicated (comm-free fwd
    beats everything at that size). Raises if the plan exceeds the HBM budget
    after the heuristic reserve (the `HeuristicalStorageReservation` role)."""
    slots_per_table: dict[str, int] = {t.name: 0 for t in model_cfg.tables}
    for fc in model_cfg.features:
        slots_per_table[fc.table] += fc.max_ids_per_sample

    chosen: dict[str, str] = {}
    table_bytes: dict[str, int] = {}
    for t in model_cfg.tables:
        # +1 row: shared sentinel row used by padded/dead lookup slots.
        tb = (t.num_embeddings * t.embedding_dim + t.num_embeddings) * bytes_per_param
        table_bytes[t.name] = tb
        if force and t.name in force:
            chosen[t.name] = force[t.name]
        elif num_devices == 1 or tb <= replicate_threshold_bytes:
            chosen[t.name] = REPLICATED
        else:
            costs = _strategy_costs(
                tb, num_devices, batch_hint, max(slots_per_table[t.name], 1),
                t.embedding_dim,
            )
            chosen[t.name] = min(costs, key=costs.get)

    # --- table-wise bucket assignment: greedy balanced bin-packing ---
    tw_tables = [t for t in model_cfg.tables if chosen[t.name] == TABLE_WISE]
    owners: dict[str, int] = {}
    offsets: dict[str, int] = {}
    buckets: dict[str, BucketSpec] = {}
    by_key: dict[tuple[int, str], list] = {}  # (dim, dtype): one bucket each
    for t in sorted(tw_tables, key=lambda t: -table_bytes[t.name]):
        by_key.setdefault(
            (t.embedding_dim, model_cfg.table_dtype_of(t.name)), []
        ).append(t)
    for (dim, dtype), group in by_key.items():
        load = [0] * num_devices  # rows per device
        for t in group:
            dev = min(range(num_devices), key=lambda d: load[d])
            owners[t.name] = dev
            offsets[t.name] = load[dev]
            load[dev] += t.num_embeddings
        name = _bucket_name(dim, dtype)
        rows = max(load) if load else 0
        buckets[name] = BucketSpec(
            name=name, embedding_dim=dim, rows_per_device=max(rows, 1),
            tables=tuple(t.name for t in group), dtype=dtype,
        )

    specs: dict[str, TableShard] = {}
    for t in model_cfg.tables:
        strategy = chosen[t.name]
        tb = table_bytes[t.name]
        padded = t.num_embeddings
        padded_dim = t.embedding_dim
        owner, bucket, boff = -1, "", 0
        if strategy == ROW_SHARDED:
            padded = _round_up(t.num_embeddings, num_devices)
            per_dev_rows = padded // num_devices
            bytes_per_device = (per_dev_rows * t.embedding_dim + per_dev_rows) * bytes_per_param
        elif strategy == COLUMN_SHARDED:
            padded_dim = _round_up(t.embedding_dim, num_devices)
            # full acc row vector is replicated per device
            bytes_per_device = (
                t.num_embeddings * (padded_dim // num_devices) + t.num_embeddings
            ) * bytes_per_param
        elif strategy == TABLE_WISE:
            owner = owners[t.name]
            boff = offsets[t.name]
            bucket = _bucket_name(t.embedding_dim, model_cfg.table_dtype_of(t.name))
            r = buckets[bucket].rows_per_device
            bytes_per_device = (r * t.embedding_dim + r) * bytes_per_param \
                // max(len(buckets[bucket].tables), 1)
        else:
            bytes_per_device = tb
        specs[t.name] = TableShard(
            table=t.name,
            strategy=strategy,
            num_embeddings=t.num_embeddings,
            padded_rows=padded,
            embedding_dim=t.embedding_dim,
            bytes_per_device=bytes_per_device,
            padded_dim=padded_dim,
            owner=owner,
            bucket=bucket,
            bucket_offset=boff,
        )
    plan = ShardingPlan(
        num_devices=num_devices,
        specs=specs,
        hbm_budget_bytes=hbm_budget_bytes,
        reserve_fraction=reserve_fraction,
        buckets=buckets,
    )
    if hbm_budget_bytes is not None:
        usable = int(hbm_budget_bytes * (1 - reserve_fraction))
        if plan.total_bytes_per_device > usable:
            raise MemoryError(
                f"sharding plan needs {plan.total_bytes_per_device/2**20:.1f} MiB/device, "
                f"budget {usable/2**20:.1f} MiB after {reserve_fraction:.0%} reserve:\n"
                + plan.describe()
            )
    return plan


def comm_volume_report(model_cfg: ModelConfig, plan: ShardingPlan, batch_size: int) -> str:
    """Analytic per-step collective traffic for a plan at a given GLOBAL batch
    size — one line per collective, so the O(batch x dim) claim (independent
    of table size) is checkable from the driver output.

    Byte counts are per device per step, f32 pooled outputs / grads:
    - id all-gather (row/table/column):  B * L * 4
    - fwd psum_scatter + psum:           2 * B * D * 4
    - bwd grad all-gather:               B * L * D * 4   (every strategy)
    """
    slots: dict[str, int] = {t.name: 0 for t in model_cfg.tables}
    for fc in model_cfg.features:
        slots[fc.table] += fc.max_ids_per_sample
    lines = [
        f"per-step collective traffic @ global batch {batch_size} "
        f"(bytes/device, independent of table rows):",
        f"{'group':<26}{'collective':<22}{'bytes':>14}",
    ]
    total = 0

    def row(group, coll, nbytes):
        nonlocal total
        total += nbytes
        lines.append(f"{group:<26}{coll:<22}{nbytes:>14,}")

    seen_buckets = set()
    for t in model_cfg.tables:
        s = plan[t.name]
        L, D = max(slots[t.name], 1), t.embedding_dim
        if s.strategy == REPLICATED:
            row(t.name, "bwd grad all_gather", batch_size * L * D * 4)
            continue
        group = s.bucket if s.strategy == TABLE_WISE else t.name
        if s.strategy == TABLE_WISE:
            if s.bucket in seen_buckets:
                continue  # whole bucket rides ONE collective group
            seen_buckets.add(s.bucket)
            L = sum(
                max(slots[m], 1) for m in plan.buckets[s.bucket].tables
            )
            D = plan.buckets[s.bucket].embedding_dim
        row(group, "fwd id all_gather", batch_size * L * 4)
        row(group, "fwd psum_scatter+psum", 2 * batch_size * D * 4)
        row(group, "bwd grad all_gather", batch_size * L * D * 4)
    lines.append(f"{'total':<26}{'':<22}{total:>14,}")
    return "\n".join(lines)
