"""Profiling + step-rate observability.

The reference has no tracing beyond tqdm (SURVEY §5); this build makes the
north-star metric (examples/s/chip) a first-class, always-on counter and wires
the JAX profiler for kernel-level traces viewable in Perfetto/TensorBoard.
"""

from __future__ import annotations

import collections
import contextlib
import time

import jax


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """Capture a JAX profiler trace (XLA + host) for the enclosed block."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


class StepTimer:
    """Rolling examples/s + step-time stats. `update(batch_size)` per step;
    maintains a window so warmup/compile steps wash out."""

    def __init__(self, window: int = 50):
        self._times = collections.deque(maxlen=window + 1)
        self._examples = collections.deque(maxlen=window)
        self.total_steps = 0
        self.total_examples = 0
        self._t0 = time.perf_counter()
        self._times.append(self._t0)

    def update(self, batch_size: int) -> None:
        self._times.append(time.perf_counter())
        self._examples.append(batch_size)
        self.total_steps += 1
        self.total_examples += batch_size

    @property
    def examples_per_sec(self) -> float:
        if len(self._times) < 2:
            return 0.0
        dt = self._times[-1] - self._times[0]
        return sum(self._examples) / dt if dt > 0 else 0.0

    @property
    def step_time_ms(self) -> float:
        if len(self._times) < 2:
            return 0.0
        return (self._times[-1] - self._times[0]) / (len(self._times) - 1) * 1e3

    def summary(self) -> dict[str, float]:
        wall = time.perf_counter() - self._t0
        return {
            "examples_per_sec": self.examples_per_sec,
            "step_time_ms": self.step_time_ms,
            "total_steps": float(self.total_steps),
            "total_examples": float(self.total_examples),
            "wall_time_s": wall,
        }


def device_memory_stats() -> dict[str, float]:
    """Per-device HBM usage (bytes) where the backend reports it."""
    out = {}
    for d in jax.devices():
        try:
            stats = d.memory_stats() or {}
        except Exception:
            stats = {}
        out[str(d.id)] = {
            "bytes_in_use": float(stats.get("bytes_in_use", -1)),
            "bytes_limit": float(stats.get("bytes_limit", -1)),
        }
    return out


def gpu_name_and_power_limit() -> str:
    """`name, power.limit` of the cards as `nvidia-smi` reports them, read by
    a child process that stays off JAX. A card set below its full power limit
    cannot hold its top clock under load, so every device number is reported
    beside this line."""
    import subprocess

    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()


def device_label() -> str:
    """The devices JAX runs on — platform, kind and count, plus the cards'
    names and power limits on a GPU — for printing beside any time or rate."""
    devices = jax.devices()
    d = devices[0]
    label = f"{d.platform} {d.device_kind} x{len(devices)}"
    if d.platform == "gpu":
        label += f" ({'; '.join(gpu_name_and_power_limit().splitlines())})"
    return label
