"""Platform plumbing that runs before any model code: the compile cache, the
pytree dataclasses that replaced flax.struct, the main path's imports,
chip_smoke.py's refusals and result line, and the sweep drivers' one-process
per-card guard."""

import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from two_tower_recommender_model.utils import compile_cache
from two_tower_recommender_model.utils.pytree import pytree_dataclass, static_field

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ------------------------------------------------------------ compile cache


@pytest.fixture
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_follows_env(monkeypatch, restore_cache_dir, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    jax.config.update("jax_compilation_cache_dir", None)
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    # JAX reads the variable itself; nothing is set in code
    assert jax.config.jax_compilation_cache_dir is None


def test_compile_cache_defaults_to_repo_dir(monkeypatch, restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    expected = os.path.join(REPO, ".jax_cache")
    assert compile_cache.DEFAULT_CACHE_DIR == expected
    assert compile_cache.enable_compile_cache() == expected
    assert jax.config.jax_compilation_cache_dir == expected
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


# ------------------------------------------------------- pytree dataclasses


@pytree_dataclass
class _Pair:
    a: jax.Array
    b: jax.Array | None = None
    tag: str = static_field(default="x")


def test_pytree_dataclass_flatten_unflatten():
    p = _Pair(a=jnp.arange(3.0), b=jnp.ones(2), tag="t")
    leaves, treedef = jax.tree.flatten(p)
    assert len(leaves) == 2  # the static field is metadata, not a leaf
    q = jax.tree.unflatten(treedef, [x * 2 for x in leaves])
    assert isinstance(q, _Pair) and q.tag == "t"
    np.testing.assert_array_equal(q.a, np.arange(3.0) * 2)
    # None children are empty subtrees
    assert len(jax.tree.leaves(_Pair(a=jnp.zeros(1)))) == 1


def test_pytree_dataclass_replace_and_frozen():
    p = _Pair(a=jnp.zeros(2))
    q = p.replace(b=jnp.ones(2))
    assert p.b is None and q.b is not None and q.tag == p.tag
    with pytest.raises(dataclasses.FrozenInstanceError):
        p.a = jnp.ones(2)


def test_pytree_dataclass_jit_round_trip():
    traces = []

    @jax.jit
    def f(p):
        traces.append(p.tag)
        return p.replace(a=p.a + 1)

    out = f(_Pair(a=jnp.zeros(2), tag="u"))
    assert isinstance(out, _Pair) and out.tag == "u"
    np.testing.assert_array_equal(out.a, np.ones(2))
    f(_Pair(a=jnp.ones(2), tag="u"))
    f(_Pair(a=jnp.ones(2), tag="v"))  # static field change -> retrace
    assert traces == ["u", "v"]


def test_train_state_is_a_pytree():
    from two_tower_recommender_model import config as cfg_lib
    from two_tower_recommender_model.ops.quantized import QuantizedTable, quantize_table
    from two_tower_recommender_model.train.step import create_train_state

    mcfg = cfg_lib.two_tower_model_config(30, 20, embedding_dim=8, layer_sizes=(8, 4))
    state, _ = create_train_state(jax.random.key(0), mcfg, cfg_lib.TrainConfig())
    doubled = jax.tree.map(lambda x: x * 2, state)
    np.testing.assert_array_equal(doubled.tables["t_user_id"],
                                  np.asarray(state.tables["t_user_id"]) * 2)
    qt = quantize_table(jnp.ones((8, 8)), packed=True)
    leaves, treedef = jax.tree.flatten(qt)
    assert len(leaves) == 2
    assert jax.tree.unflatten(treedef, leaves).packed is True
    assert isinstance(jax.tree.map(lambda x: x, qt), QuantizedTable)


# ------------------------------------------------------- main-path imports


def test_main_path_imports_only_the_jax_stack():
    """The training, sharding, serving and checkpoint-free CLI path imports
    nothing beyond JAX, numpy, scipy, optax, chex and einops: no flax, no
    orbax, and no pandas/pyarrow (those stay in data preparation)."""
    code = """
import importlib, importlib.util, sys
sys.path.insert(0, "scripts")
for m in ("config", "data", "data.loader", "data.shards", "data.compact",
          "data.device_featurizer", "data.prepacked", "data.wirecache",
          "models.two_tower", "models.losses", "ops.topk", "ops.quantized",
          "parallel", "parallel.sharded", "train.step", "train.loop",
          "utils.checkpoint", "utils.tracking", "utils.compile_cache",
          "evaluation.retrieval", "serving", "tuning"):
    importlib.import_module("two_tower_recommender_model." + m)
spec = importlib.util.spec_from_file_location("train_cli", "scripts/train.py")
spec.loader.exec_module(importlib.util.module_from_spec(spec))
print(sorted(m for m in ("flax", "orbax", "pandas", "pyarrow") if m in sys.modules))
"""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.strip().splitlines()[-1] == "[]"


def test_former_package_name_is_an_alias():
    """The package's former name imports the very same modules."""
    aliases = [d for d in os.listdir(REPO)
               if d.startswith("two_tower_recommender_model_")
               and os.path.isfile(os.path.join(REPO, d, "__init__.py"))]
    assert len(aliases) == 1
    code = f"""
import importlib
import two_tower_recommender_model as new
import two_tower_recommender_model.config as new_config
old = importlib.import_module("{aliases[0]}")
assert old is new
old_step = importlib.import_module("{aliases[0]}.train.step")
new_step = importlib.import_module("two_tower_recommender_model.train.step")
assert old_step is new_step
assert new_step.__spec__.name == "two_tower_recommender_model.train.step"
from {aliases[0]}.config import TrainConfig
assert TrainConfig is new_config.TrainConfig
print("ok")
"""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.strip() == "ok"


# ------------------------------------------------------------- chip_smoke


def test_chip_smoke_refuses_cpu_backend():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert "needs a GPU" in r.stderr
    assert '"ok"' not in r.stdout


def test_chip_smoke_result_line():
    cs = _load_chip_smoke()
    dev = types.SimpleNamespace(platform="gpu", device_kind="NVIDIA H100 80GB HBM3")
    line = cs.result_line([dev])
    assert json.loads(line) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}}
    assert "\n" not in line
    assert json.loads(cs.result_line([dev] * 4))["device"]["count"] == 4


def test_chip_smoke_four_refuses_fewer_than_four_cards():
    cs = _load_chip_smoke()
    gpu = types.SimpleNamespace(platform="gpu", device_kind="NVIDIA H100 80GB HBM3")
    cs.require_gpus([gpu], 1)
    cs.require_gpus([gpu] * 4, 4)
    with pytest.raises(SystemExit, match="needs 4 GPUs"):
        cs.require_gpus([gpu] * 3, 4)
    with pytest.raises(SystemExit, match="needs a GPU"):
        cs.require_gpus(jax.devices()[:4], 4)


def test_chip_smoke_rel_err():
    cs = _load_chip_smoke()
    assert cs.rel_err([1.0, 2.0], [1.0, 2.0]) == 0.0
    assert cs.rel_err([1.0, 2.2], [1.0, 2.0]) == pytest.approx(0.1)
    assert cs.rel_err([0.0], [0.0]) == 0.0


def test_chip_smoke_check_holds_each_field():
    cs = _load_chip_smoke()
    errs = {"loss": (1e-6, 1e-6), "t.slot_grads": (0.2, 3e-2), "dense_grad": (0.5, 5e-3)}
    cs._check("x", errs, 1e-2, 5e-2)  # table gradients by their own bound
    with pytest.raises(AssertionError, match="slot_grads"):
        cs._check("x", errs, 1e-2)
    with pytest.raises(AssertionError, match="loss"):  # element-wise
        cs._check("x", {"loss": (2e-2, 0.0)}, 1e-2)
    int8 = {"t.int8_steps": (1.0, 1.0), "t.dequantized_rows": (0.1, 0.1)}
    cs._check("x", int8, 1e-5, int8_steps=1)
    with pytest.raises(AssertionError, match="int8_steps"):
        cs._check("x", {"t.int8_steps": (2.0, 2.0)}, 1e-5, int8_steps=1)
    with pytest.raises(AssertionError, match="dequantized_rows"):
        cs._check("x", int8, 1e-5)


def test_chip_smoke_check_holds_dense_grad_to_its_own_bound():
    cs = _load_chip_smoke()
    errs = {"loss": (1e-6, 1e-6), "dense_grad": (0.5, 3e-2)}
    cs._check("x", errs, 1e-2, dense_grad_bound=4e-2)  # norm-wise, its own bound
    with pytest.raises(AssertionError, match="dense_grad"):
        cs._check("x", errs, 1e-2)
    with pytest.raises(AssertionError, match="dense_grad"):
        cs._check("x", errs, 1e-2, dense_grad_bound=2e-2)
    with pytest.raises(AssertionError, match="loss"):  # the rest keep `bound`
        cs._check("x", {"loss": (2e-2, 0.0)}, 1e-2, dense_grad_bound=1.0)


def test_chip_smoke_bf16_dense_grad_error():
    """bf16's own dense-gradient error, on which the bf16 compare's dense
    bound rests: nonzero and well under 1 at a tiny size, and the same for
    the bf16 and f32 configs it is asked from."""
    cs = _load_chip_smoke()
    from two_tower_recommender_model import config as cfg_lib

    mcfg = dataclasses.replace(cs.flagship_config(300, 80), compute_dtype="bfloat16")
    tcfg = cfg_lib.TrainConfig(sparse_learning_rate=0.05, learning_rate=1e-3)
    cpu0, cpu1 = jax.devices()[:2]
    inputs = cs.compare_inputs(mcfg, tcfg, 256, cpu1, cpu0, warm_steps=1)
    own = cs.bf16_dense_grad_error(mcfg, tcfg, *inputs, cpu0)
    assert 0.0 < own < 0.5
    f32 = dataclasses.replace(mcfg, compute_dtype="float32")
    assert cs.bf16_dense_grad_error(f32, tcfg, *inputs, cpu0) == own
    grads, update = cs.compare_errors(mcfg, tcfg, *inputs, cpu1, cpu0,
                                      precisions=("highest",))["highest"]
    cs._check("grads", grads, cs.BOUND_BF16,
              dense_grad_bound=cs.BF16_DENSE_GRAD_SHARE * own)
    cs._check("update", update, cs.BOUND_HIGHEST)


@pytest.mark.parametrize("table_dtype", ["float32", "int8"])
def test_chip_smoke_compare_rehearsal(table_dtype):
    """Phase c's comparison between two CPU devices at a tiny size: every
    gradient and update field is present and agrees."""
    cs = _load_chip_smoke()
    from two_tower_recommender_model import config as cfg_lib

    mcfg = dataclasses.replace(cs.flagship_config(300, 80), table_dtype=table_dtype)
    tcfg = cfg_lib.TrainConfig(sparse_learning_rate=0.05, learning_rate=1e-3)
    cpu0, cpu1 = jax.devices()[:2]
    inputs = cs.compare_inputs(mcfg, tcfg, 256, cpu1, cpu0, warm_steps=1)
    errs = cs.compare_errors(mcfg, tcfg, *inputs, cpu1, cpu0, precisions=("highest",))
    grads, update = errs["highest"]
    for t in ("t_user_id", "t_product_id"):
        assert {f"{t}.slot_grads", f"{t}.aggregated_grads"} <= set(grads)
        assert f"{t}.adagrad" in update
    assert {"loss", "logits", "dense_grad"} <= set(grads)
    assert "dense_params" in update
    cs._check("grads", grads, cs.BOUND_HIGHEST)
    cs._check("update", update, cs.BOUND_HIGHEST,
              int8_steps=1 if table_dtype == "int8" else None)


def test_device_label_names_the_devices():
    from two_tower_recommender_model.utils.profiling import device_label

    assert device_label() == "cpu cpu x8"  # conftest's 8 virtual CPU devices


# ----------------------------------------------------- one process per card


def test_worker_memory_guard_allows_cpu_and_one_worker(monkeypatch):
    from two_tower_recommender_model.tuning.adaptive import check_worker_memory

    monkeypatch.delenv("XLA_PYTHON_CLIENT_MEM_FRACTION", raising=False)
    check_worker_memory(4)  # CPU backend: processes share host memory
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    check_worker_memory(1)


def test_worker_memory_guard_refuses_gpu_without_fraction(monkeypatch):
    from two_tower_recommender_model.tuning import sweep
    from two_tower_recommender_model.tuning.adaptive import check_worker_memory

    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    monkeypatch.delenv("XLA_PYTHON_CLIENT_MEM_FRACTION", raising=False)
    with pytest.raises(ValueError, match="XLA_PYTHON_CLIENT_MEM_FRACTION"):
        check_worker_memory(2)
    monkeypatch.setenv("XLA_PYTHON_CLIENT_MEM_FRACTION", "0.5")  # 3 x 0.5 > 1
    with pytest.raises(ValueError, match="at most 1/3"):
        check_worker_memory(2)
    # the grid/random driver refuses before starting any worker
    with pytest.raises(ValueError, match="XLA_PYTHON_CLIENT_MEM_FRACTION"):
        sweep.run_sweep(lambda cfg: {"val_loss": 0.0}, {"lr": [1, 2]},
                        search="grid", max_workers=2)


def test_worker_memory_guard_accepts_a_share_per_worker(monkeypatch):
    from two_tower_recommender_model.tuning.adaptive import check_worker_memory

    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    monkeypatch.setenv("XLA_PYTHON_CLIENT_MEM_FRACTION", "0.3")
    check_worker_memory(2)
