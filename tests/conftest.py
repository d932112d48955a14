"""Test harness: run on CPU with 8 simulated devices.

The JAX answer to the reference's "test multi-node without a permanent
cluster" ladder (SURVEY §4): `--xla_force_host_platform_device_count=8` gives
an 8-device mesh on host CPU, so all sharding/collective paths compile and run
in CI with no accelerator attached. Platforms are switched through
jax.config, which works even when jax was imported before this file.
"""

import os

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)

# Subprocess tests (multi-host workers, CLI runs) inherit os.environ; make the
# package importable from any cwd even when the editable install is absent
# (fresh environments lose `pip install -e .` state).
_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
os.environ["PYTHONPATH"] = (
    _REPO_ROOT + os.pathsep + os.environ["PYTHONPATH"]
    if os.environ.get("PYTHONPATH")
    else _REPO_ROOT
)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_default_matmul_precision", "highest")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(scope="session", autouse=True)
def _devices():
    assert len(jax.devices()) == 8, "expected 8 simulated CPU devices"
    yield


@pytest.fixture
def rng():
    return np.random.default_rng(0)
