"""Device mesh construction + topology discovery.

The role of the reference's `Topology(local_world_size, world_size,
compute_device)` + cluster introspection (`03_model_training.py:799-803`,
`:934-955`): topology comes from `jax.devices()`; multi-host process
setup is `jax.distributed.initialize` (the NCCL-rendezvous analog,
`03_model_training.py:739-751`) which callers invoke once before building the
mesh.

Axes:
- ``data``  — batch / data-parallel axis (dense towers sync grads here),
- ``model`` — second axis for table sharding. Embedding tables are row-sharded
  over the *flattened* (data, model) mesh, so every row exists exactly once
  globally (TorchRec DMP layout). A 1-D mesh (model=1) is the common case;
  the 2-D form exists so other shardings (e.g. column-sharded tables over
  one axis only) can be expressed.
"""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
from jax.sharding import Mesh

DATA_AXIS = "data"
MODEL_AXIS = "model"
FLAT_AXES = (DATA_AXIS, MODEL_AXIS)


def make_mesh(data: int | None = None, model: int = 1, devices=None) -> Mesh:
    """Build a (data, model) mesh. `data=None` uses all remaining devices."""
    devices = list(jax.devices()) if devices is None else list(devices)
    n = len(devices)
    if data is None:
        if n % model:
            raise ValueError(f"{n} devices not divisible by model={model}")
        data = n // model
    if data * model > n:
        raise ValueError(f"mesh {data}x{model} needs {data*model} devices, have {n}")
    arr = np.array(devices[: data * model]).reshape(data, model)
    return Mesh(arr, FLAT_AXES)


@dataclasses.dataclass(frozen=True)
class Topology:
    num_devices: int
    num_hosts: int
    devices_per_host: int
    platform: str
    device_kind: str
    hbm_bytes_per_device: int | None


def topology_summary(devices=None) -> Topology:
    """Discover the topology from the JAX runtime (the role of the Databricks
    SDK cluster introspection, `03_model_training.py:934-955`)."""
    devices = list(jax.devices()) if devices is None else list(devices)
    hosts = {d.process_index for d in devices}
    d0 = devices[0]
    hbm = None
    try:
        stats = d0.memory_stats()
        if stats:
            hbm = stats.get("bytes_limit")
    except Exception:
        pass
    return Topology(
        num_devices=len(devices),
        num_hosts=len(hosts),
        devices_per_host=len(devices) // max(len(hosts), 1),
        platform=d0.platform,
        device_kind=d0.device_kind,
        hbm_bytes_per_device=hbm,
    )
