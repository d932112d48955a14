"""Checkpointing (`utils.checkpoint`), experiment tracking
(`utils.tracking`), the model registry and profiling helpers, and the pytree
dataclass decorator (`utils.pytree`). Import the submodules directly."""
