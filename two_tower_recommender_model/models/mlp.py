"""Functional MLP matching `torchrec.modules.mlp.MLP` semantics.

Each layer is Linear -> activation, *including the final layer* (torchrec
`Perceptron` applies the activation unconditionally — the reference towers
therefore emit non-negative (ReLU'd) embeddings; reference import
`03_model_training.py:345`, use `:408-409`). `final_activation=False` gives the
conventional linear-head variant.

Plain pytree params (no module framework): params fold cleanly into jit /
shard_map and optax without adapter layers.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


_ACTIVATIONS = {
    "relu": jax.nn.relu,
    "gelu": jax.nn.gelu,
    "tanh": jnp.tanh,
    "sigmoid": jax.nn.sigmoid,
    "none": lambda x: x,
}


def init_mlp(
    rng: jax.Array,
    in_size: int,
    layer_sizes: tuple[int, ...],
    param_dtype=jnp.float32,
) -> dict:
    """Torch-Linear-style init: W ~ U(-1/sqrt(fan_in), 1/sqrt(fan_in)), same
    for bias (matches the reference's effective init distribution)."""
    params = {}
    fan_in = in_size
    for i, out in enumerate(layer_sizes):
        rng, wk, bk = jax.random.split(rng, 3)
        bound = 1.0 / np.sqrt(fan_in)
        params[f"layer_{i}"] = {
            "kernel": jax.random.uniform(wk, (fan_in, out), param_dtype, -bound, bound),
            "bias": jax.random.uniform(bk, (out,), param_dtype, -bound, bound),
        }
        fan_in = out
    return params


def apply_mlp(
    params: dict,
    x: jax.Array,
    activation: str = "relu",
    final_activation: bool = True,
    compute_dtype=None,
) -> jax.Array:
    act = _ACTIVATIONS[activation]
    n = len(params)
    if compute_dtype is not None:
        x = x.astype(compute_dtype)
    for i in range(n):
        layer = params[f"layer_{i}"]
        kernel, bias = layer["kernel"], layer["bias"]
        if compute_dtype is not None:
            kernel = kernel.astype(compute_dtype)
            bias = bias.astype(compute_dtype)
        x = jnp.dot(x, kernel, preferred_element_type=jnp.float32).astype(
            x.dtype
        ) + bias
        if i < n - 1 or final_activation:
            x = act(x)
    return x
