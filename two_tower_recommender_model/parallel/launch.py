"""Multi-host launch: process setup, scaling modes, per-host batch slicing.

The role of the reference's launcher ladder (`TrainingMethod` SNSG/SNMG/MNMG
+ `TorchDistributor` + NCCL env plumbing, `03_model_training.py:72-78`,
`:736-751`, `:865-990`): JAX needs no per-accelerator process spawn —
one process per *host*, `jax.distributed.initialize` for the rendezvous (the
`init_process_group` analog), and every chip on the host is driven by the same
program. The SNSG/SNMG/MNMG distinction collapses to how many hosts/chips the
mesh spans:

    SINGLE_CHIP   1 process, 1 device      (SNSG)
    SINGLE_HOST   1 process, all local devices (SNMG)
    MULTI_HOST    N processes (1/host), jax.distributed.initialize (MNMG)

`initialize_multi_host` reads coordinator/rank from args or env
(JAX_COORDINATOR_ADDRESS, JAX_PROCESS_ID, JAX_NUM_PROCESSES — the
MASTER_ADDR/RANK/WORLD_SIZE analog, `03_model_training.py:881-887`).
"""

from __future__ import annotations

import enum
import logging
import os

import jax

log = logging.getLogger(__name__)


class TrainingMethod(str, enum.Enum):
    SINGLE_CHIP = "single_chip"  # SNSG
    SINGLE_HOST = "single_host"  # SNMG
    MULTI_HOST = "multi_host"  # MNMG


def initialize_multi_host(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> None:
    """`jax.distributed.initialize` with env fallback — call once per host
    process before any device use (the NCCL-rendezvous analog,
    `03_model_training.py:739-751`)."""
    coordinator_address = coordinator_address or os.environ.get("JAX_COORDINATOR_ADDRESS")
    if num_processes is None:
        num_processes = int(os.environ.get("JAX_NUM_PROCESSES", "0")) or None
    if process_id is None:
        pid = os.environ.get("JAX_PROCESS_ID")
        process_id = int(pid) if pid is not None else None
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
    log.info(
        "distributed: process %d/%d, %d local / %d global devices",
        jax.process_index(), jax.process_count(),
        jax.local_device_count(), jax.device_count(),
    )


def devices_for(method: TrainingMethod) -> list:
    if method == TrainingMethod.SINGLE_CHIP:
        return jax.devices()[:1]
    return jax.devices()


def host_info() -> dict:
    return {
        "process_index": jax.process_index(),
        "process_count": jax.process_count(),
        "local_devices": jax.local_device_count(),
        "global_devices": jax.device_count(),
    }


def per_host_loader_slice() -> tuple[int, int]:
    """(host_index, num_hosts) for `StreamLoader` — each host streams a
    disjoint shard subset (the Mosaic per-rank partitioning role)."""
    return jax.process_index(), jax.process_count()


def global_batch_slice(global_batch_size: int) -> int:
    """Per-host batch size for a data-parallel global batch."""
    n = jax.process_count()
    if global_batch_size % n:
        raise ValueError(f"global batch {global_batch_size} not divisible by {n} hosts")
    return global_batch_size // n


def put_global_batch(local_batch, mesh):
    """Assemble a *global* device batch from this host's local shard.

    Each host streams a disjoint slice (`per_host_loader_slice`) and calls
    this with its local arrays; the result is a global jax.Array sharded over
    the mesh's data axis whose global batch = sum of host batches — the
    multi-host H2D moment of the reference's per-rank dataloaders
    (`03_model_training.py:758-760`). Works identically in single-process
    (where it's just a device_put with a data sharding)."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from two_tower_recommender_model.parallel.mesh import DATA_AXIS

    def put(x):
        spec = P(DATA_AXIS, *([None] * (x.ndim - 1)))
        sharding = NamedSharding(mesh, spec)
        return jax.make_array_from_process_local_data(sharding, x)

    return jax.tree.map(put, local_batch)
