"""Analytic multi-device scaling model (DESIGN §9). Its numbers are
predictions, not measurements.

It predicts the weak-scaling step time of the sharded train step from
quantities that are measured or exactly countable:

- the single-device step time at the per-device batch, measured on the card;
- the per-device collective bytes of the sharded step, computed from the
  sharding plan with the same accounting `dryrun_multichip` prints
  (`parallel/planner.py: comm_volume_report`) — a test pins the two
  together;
- the interconnect rate: NVLink 4 on an H100 SXM host gives each card
  900 GB/s to the others, 450 GB/s each way (NVIDIA's data sheet), and
  every card reaches every other at that rate, so there are no torus axes
  to count.

Weak scaling: each device keeps the single-device batch, so compute time
per step is constant and efficiency = t_compute / (t_compute +
t_comm_exposed) with t_comm_exposed = (1 - overlap) * t_comm. XLA overlaps
collectives with the dense tower compute inside the one-jit-program step;
`overlap` is therefore a [0, 1) knob reported alongside, not buried in the
headline.

The model is the reason `sharded_exchange="alltoall"` exists: the dense
psum_scatter/all_gather scheme moves O(B_global x D) bytes per device, so
its comm/compute ratio GROWS with the mesh; the all-to-all scheme moves
O(B_local x D) and holds flat. Reference anchor: the TorchRec stack
measured ~50% 4-GPU and ~33% 8-GPU per-chip efficiency
(`03_model_training.py:866,908,926`; BASELINE.md).
"""

from __future__ import annotations

import dataclasses

from two_tower_recommender_model.config import ModelConfig
from two_tower_recommender_model.parallel.planner import (
    REPLICATED,
    ROW_SHARDED,
    TABLE_WISE,
    ShardingPlan,
)

# NVLink 4 (H100 SXM): 450 GB/s each way per card to its peers, all to all
# (NVIDIA's data sheet).
NVLINK_BYTES_PER_S = 450e9


@dataclasses.dataclass(frozen=True)
class CommModel:
    """Per-device, per-step collective bytes of one sharded train step."""

    exchange: str
    global_batch: int
    n_devices: int
    per_group: dict  # group -> {collective -> bytes}
    total_bytes: int

    def describe(self) -> str:
        lines = [
            f"per-step collective bytes/device ({self.exchange} exchange, "
            f"global batch {self.global_batch}, {self.n_devices} devices):"
        ]
        for group, colls in self.per_group.items():
            for coll, nbytes in colls.items():
                lines.append(f"  {group:<24}{coll:<28}{nbytes:>14,}")
        lines.append(f"  {'total':<24}{'':<28}{self.total_bytes:>14,}")
        return "\n".join(lines)


def _slots_per_table(model_cfg: ModelConfig) -> dict:
    slots = {t.name: 0 for t in model_cfg.tables}
    for fc in model_cfg.features:
        slots[fc.table] += fc.max_ids_per_sample
    return slots


def collective_bytes(
    model_cfg: ModelConfig,
    plan: ShardingPlan,
    batch_size: int,
    n_devices: int,
    exchange: str = "dense",
    capacity_factor: float = 1.25,
    wire_bytes_per_value: int = 4,
) -> CommModel:
    """Per-device collective bytes for one sharded train step.

    `exchange="dense"` reproduces `comm_volume_report`'s accounting exactly
    (`tests/test_scaling_model.py` pins them; the dryrun prints the report):
    per row-sharded group, ids all-gather `B*L*4`, forward
    psum_scatter+psum `2*B*D*4`, backward grad all-gather `B*L*D*4` — all
    O(B_global).

    `exchange="alltoall"` counts the static-capacity bucket exchange
    (`sharded.py: make_alltoall_*`): per group, ids a2a twice (forward
    request + backward re-request), row payload a2a forward and grad
    payload a2a backward — all sized by the DEDUPED bucket capacity
    `cap = min(ceil(B_local*L*capf/ndev), rows_per_shard)` (the `_a2a_cap`
    formula; the rows bound is what shrinks small tables' exchanges to
    their shard size), so per-device bytes are O(min(B_local, table rows))
    and independent of the mesh. `wire_bytes_per_value=2` models
    `exchange_wire_dtype="bfloat16"`.
    """
    slots = _slots_per_table(model_cfg)
    b_local = batch_size // n_devices
    per_group: dict = {}
    total = 0

    from two_tower_recommender_model.parallel.sharded import _a2a_cap

    def a2a_cap(m: int, rows_per_shard: int) -> int:
        # the implementation's own capacity formula — the byte model can
        # never desynchronize from the exchange it describes
        return _a2a_cap(m, n_devices, capacity_factor, rows_per_shard)

    def add(group, coll, nbytes):
        nonlocal total
        nbytes = int(nbytes)
        per_group.setdefault(group, {})[coll] = nbytes
        total += nbytes

    seen_buckets = set()
    for t in model_cfg.tables:
        s = plan[t.name]
        L, D = max(slots[t.name], 1), t.embedding_dim
        if s.strategy == REPLICATED:
            add(t.name, "bwd grad all_gather", batch_size * L * D * 4)
            continue
        group = s.bucket if s.strategy == TABLE_WISE else t.name
        if s.strategy == TABLE_WISE:
            if s.bucket in seen_buckets:
                continue
            seen_buckets.add(s.bucket)
            L = sum(max(slots[m], 1) for m in plan.buckets[s.bucket].tables)
            D = plan.buckets[s.bucket].embedding_dim
        # table-wise buckets keep the dense exchange under both schemes
        # (every id of a table goes to ONE owner — a2a buys nothing there;
        # `make_sharded_forward`'s routing)
        if exchange == "dense" or s.strategy != ROW_SHARDED:
            add(group, "fwd id all_gather", batch_size * L * 4)
            add(group, "fwd psum_scatter+psum", 2 * batch_size * D * 4)
            add(group, "bwd grad all_gather", batch_size * L * D * 4)
        elif exchange == "alltoall":
            m = b_local * L
            rows_per_shard = s.padded_rows // n_devices
            buf = n_devices * a2a_cap(m, rows_per_shard)
            add(group, "fwd+bwd id all_to_all", 2 * buf * 4)
            add(group, "fwd row all_to_all", buf * D * wire_bytes_per_value)
            add(group, "bwd grad all_to_all", buf * D * wire_bytes_per_value)
        else:
            raise ValueError(f"unknown exchange {exchange!r}")
    # data-parallel dense tower grad psum: one all-reduce over the tower
    # params per step (ring: ~2x params bytes per device)
    n_dense = sum(
        _mlp_params(_tower_in_dim(model_cfg, tw), tw.layer_sizes)
        for tw in (model_cfg.query_tower, model_cfg.candidate_tower)
    )
    add("dense towers", "grad psum", 2 * n_dense * 4)
    return CommModel(
        exchange=exchange,
        global_batch=batch_size,
        n_devices=n_devices,
        per_group=per_group,
        total_bytes=total,
    )


def _tower_in_dim(cfg: ModelConfig, tower) -> int:
    return sum(cfg.feature_table(f).embedding_dim for f in tower.features) + tower.dense_dim


def _mlp_params(in_dim: int, layers) -> int:
    n, d = 0, in_dim
    for out in layers:
        n += d * out + out
        d = out
    return n


@dataclasses.dataclass(frozen=True)
class ScalingPrediction:
    n_devices: int
    per_chip_batch: int
    compute_ms: float
    comm_ms: float
    overlap: float
    step_ms: float
    examples_per_sec_per_chip: float
    efficiency: float  # vs the same chip running solo (weak scaling)

    def row(self) -> str:
        return (
            f"{self.n_devices:>4}  {self.per_chip_batch:>9,}  "
            f"{self.compute_ms:>8.2f}  {self.comm_ms:>8.2f}  "
            f"{self.step_ms:>8.2f}  {self.examples_per_sec_per_chip:>14,.0f}  "
            f"{self.efficiency * 100:>6.1f}%"
        )


def predict_weak_scaling(
    single_chip_step_ms: float,
    per_chip_batch: int,
    model_cfg: ModelConfig,
    plan: ShardingPlan,
    n_devices: int,
    exchange: str = "dense",
    capacity_factor: float = 1.25,
    wire_bytes_per_value: int = 4,
    link_bytes_per_s: float = NVLINK_BYTES_PER_S,
    overlap: float = 0.0,
) -> ScalingPrediction:
    """Weak-scaling prediction: per-chip batch held at the single-chip
    optimum, global batch = per_chip_batch * n_devices.

    `single_chip_step_ms` is the measured device-step time at
    `per_chip_batch`; compute per chip is
    unchanged under weak scaling (each chip runs the same gathers/updates/
    towers on its local batch — table shards are SMALLER than single-chip
    tables, so this slightly over-counts compute and the prediction is
    conservative). `overlap` in [0, 1) discounts comm that XLA hides under
    compute."""
    comm = collective_bytes(
        model_cfg, plan, per_chip_batch * n_devices, n_devices,
        exchange=exchange, capacity_factor=capacity_factor,
        wire_bytes_per_value=wire_bytes_per_value,
    )
    comm_ms = comm.total_bytes / link_bytes_per_s * 1e3
    step_ms = single_chip_step_ms + (1.0 - overlap) * comm_ms
    eps_chip = per_chip_batch / step_ms * 1e3
    eff = single_chip_step_ms / step_ms
    return ScalingPrediction(
        n_devices=n_devices,
        per_chip_batch=per_chip_batch,
        compute_ms=single_chip_step_ms,
        comm_ms=comm_ms,
        overlap=overlap,
        step_ms=step_ms,
        examples_per_sec_per_chip=eps_chip,
        efficiency=eff,
    )


def scaling_table(
    single_chip_step_ms: float,
    per_chip_batch: int,
    model_cfg: ModelConfig,
    plan: ShardingPlan,
    device_counts=(1, 4, 8, 16),
    schemes=(("dense", 4), ("alltoall", 4), ("alltoall", 2)),
    capacity_factor: float = 1.25,
    overlap: float = 0.0,
) -> str:
    """Markdown-ish table: predicted weak-scaling per scheme x mesh size."""
    lines = [f"weak scaling over NVLink ({NVLINK_BYTES_PER_S / 1e9:.0f} GB/s "
             "each way): predicted, not measured", ""]
    for exchange, wire in schemes:
        tag = exchange + (" (bf16 wire)" if wire == 2 else "")
        lines.append(f"scheme: {tag}  (capacity_factor={capacity_factor}, "
                     f"overlap={overlap})")
        lines.append(f"{'chips':>5}  {'batch/chip':>9}  {'comp ms':>8}  "
                     f"{'comm ms':>8}  {'step ms':>8}  {'ex/s/chip':>14}  "
                     f"{'eff':>7}")
        for n in device_counts:
            if n == 1:
                p = ScalingPrediction(
                    1, per_chip_batch, single_chip_step_ms, 0.0, overlap,
                    single_chip_step_ms,
                    per_chip_batch / single_chip_step_ms * 1e3, 1.0)
            else:
                p = predict_weak_scaling(
                    single_chip_step_ms, per_chip_batch, model_cfg, plan, n,
                    exchange=exchange, capacity_factor=capacity_factor,
                    wire_bytes_per_value=wire, overlap=overlap,
                )
            lines.append(p.row())
        lines.append("")
    return "\n".join(lines)
