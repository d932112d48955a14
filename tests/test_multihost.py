"""REAL multi-host test: 2 OS processes x 2 CPU devices each, coordinated via
`jax.distributed.initialize`, running the sharded train step with per-host
disjoint data — must reproduce the single-process 4-device result.

This exercises what the virtual-mesh tests cannot: cross-process collectives,
`make_array_from_process_local_data` batch assembly, per-host loader slicing,
and the launch helpers — the MNMG rung of the reference's ladder
(`03_model_training.py:926-990`) without a cluster."""

import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

WORKER = r'''
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_default_matmul_precision", "highest")

port, pid, out_dir = sys.argv[1], int(sys.argv[2]), sys.argv[3]
from two_tower_recommender_model.parallel.launch import (
    initialize_multi_host, per_host_loader_slice, put_global_batch, host_info)
initialize_multi_host(f"127.0.0.1:{port}", num_processes=2, process_id=pid)
assert host_info()["global_devices"] == 4

import numpy as np
import jax.numpy as jnp
from two_tower_recommender_model import config as cfg_lib
from two_tower_recommender_model.data import Featurizer, SyntheticClickstream
from two_tower_recommender_model.parallel import (
    make_mesh, make_sharded_train_step, plan_sharding, shard_train_state)
from two_tower_recommender_model.parallel.planner import ROW_SHARDED
from two_tower_recommender_model.parallel.sharded import unshard_train_state
from two_tower_recommender_model.train.step import create_train_state

mcfg = cfg_lib.two_tower_model_config(num_users=64, num_items=40, embedding_dim=8,
                                      layer_sizes=(16, 8))
tcfg = cfg_lib.TrainConfig(sparse_learning_rate=0.05, learning_rate=1e-3)
mesh = make_mesh(4, 1)
plan = plan_sharding(mcfg, 4, force={"t_user_id": ROW_SHARDED, "t_product_id": ROW_SHARDED})
state, dense_opt = create_train_state(jax.random.key(0), mcfg, tcfg)
state = shard_train_state(state, plan, mesh)
step = make_sharded_train_step(mcfg, tcfg, dense_opt, mesh, plan, donate=False)

ds = SyntheticClickstream(64, 40, seed=9)
feat = Featurizer(mcfg)
host_index, num_hosts = per_host_loader_slice()
B = 32  # global batch; each host contributes 16
for i in range(3):
    cols = ds.sample(B, start=i)
    lo = host_index * (B // num_hosts)
    local_cols = {k: v[lo : lo + B // num_hosts] for k, v in cols.items()}
    batch = put_global_batch(jax.tree.map(np.asarray, feat(local_cols)), mesh)
    state, out = step(state, batch)

loss = float(jax.device_get(out["loss"]))
gathered = unshard_train_state(state, plan, mcfg)
if pid == 0:
    np.savez(os.path.join(out_dir, "result.npz"),
             loss=loss,
             t_user=gathered.tables["t_user_id"],
             t_item=gathered.tables["t_product_id"])
print(f"worker {pid} done loss={loss}", flush=True)
'''


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.slow
def test_two_process_training_matches_single_process(tmp_path):
    port = _free_port()
    worker_py = tmp_path / "worker.py"
    worker_py.write_text(WORKER)
    # inherit the parent env: jax.random output depends on which backend
    # plugins are registered, and the single-process reference below runs in
    # this process — workers must match it
    env = dict(os.environ)
    procs = [
        subprocess.Popen(
            [sys.executable, str(worker_py), str(port), str(i), str(tmp_path)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for i in range(2)
    ]
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=300)
        outs.append(out)
        assert p.returncode == 0, out[-3000:]
    result = np.load(tmp_path / "result.npz")

    # single-process reference on the in-test 8-device mesh (first 4 devices)
    from two_tower_recommender_model import config as cfg_lib
    from two_tower_recommender_model.data import Featurizer, SyntheticClickstream
    from two_tower_recommender_model.train.step import create_train_state, make_train_step

    mcfg = cfg_lib.two_tower_model_config(num_users=64, num_items=40, embedding_dim=8,
                                          layer_sizes=(16, 8))
    tcfg = cfg_lib.TrainConfig(sparse_learning_rate=0.05, learning_rate=1e-3)
    state, dense_opt = create_train_state(jax.random.key(0), mcfg, tcfg)
    step = make_train_step(mcfg, tcfg, dense_opt, donate=False)
    ds = SyntheticClickstream(64, 40, seed=9)
    feat = Featurizer(mcfg)
    for i in range(3):
        state, out = step(state, jax.tree.map(jnp.asarray, feat(ds.sample(32, start=i))))

    np.testing.assert_allclose(result["loss"], float(out["loss"]), rtol=1e-5)
    np.testing.assert_allclose(result["t_user"], np.asarray(state.tables["t_user_id"]),
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(result["t_item"], np.asarray(state.tables["t_product_id"]),
                               rtol=1e-4, atol=1e-6)


@pytest.mark.slow
def test_cli_multihost_two_processes(tmp_path):
    """scripts/train.py with --multi-host across 2 OS processes: per-host
    disjoint streams assemble into global batches (the review-found
    device_put-drops-data bug would silently train on half the data)."""
    import json

    from two_tower_recommender_model.data.shards import write_dataset
    from two_tower_recommender_model.data import SyntheticClickstream

    ds = SyntheticClickstream(60, 40, seed=1)
    for split, n in (("train", 2000), ("val", 400), ("test", 400)):
        cols = ds.sample(n, split)
        write_dataset(str(tmp_path / "data" / split), cols, rows_per_shard=256)

    port = _free_port()
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    env["JAX_PLATFORMS"] = "cpu"
    env["JAX_COORDINATOR_ADDRESS"] = f"127.0.0.1:{port}"
    env["JAX_NUM_PROCESSES"] = "2"

    procs = []
    for pid in range(2):
        e = dict(env)
        e["JAX_PROCESS_ID"] = str(pid)
        procs.append(subprocess.Popen(
            [sys.executable, "scripts/train.py",
             "--data-dir", str(tmp_path / "data"),
             "--num-users", "61", "--num-items", "41",
             "--epochs", "1", "--batch-size", "64",
             "--embedding-dim", "8", "--layer-sizes", "16", "8",
             "--limit-train-batches", "8", "--limit-val-batches", "2",
             "--limit-test-batches", "2", "--multi-host",
             "--runs-root", str(tmp_path / f"runs{pid}")],
            env=e, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=300)
        outs.append(out)
        assert p.returncode == 0, out[-3000:]
    assert "test_auroc" in outs[0]
    # rank 0 prints the sharding plan; rank 1 does not
    assert "EmbeddingShardingPlan" in outs[0] or "EmbeddingShardingPlan" in outs[1]
    # eval metrics must be REAL numbers: the pre-fix loader truncated all
    # hosts to the global MIN batch count, which with few eval shards is 0
    # on some (or all) hosts -> silent nan metrics
    results = [line for line in outs[0].splitlines() if "'test_auroc'" in line]
    assert results, outs[0][-2000:]
    parsed = json.loads(results[-1].replace("'", '"'))
    for key in ("baseline_val_auroc", "val_loss", "val_auroc", "test_loss", "test_auroc"):
        assert np.isfinite(parsed[key]), (key, parsed)


WORKER_PACKED = r'''
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_default_matmul_precision", "highest")

port, pid, out_dir = sys.argv[1], int(sys.argv[2]), sys.argv[3]
from two_tower_recommender_model.parallel.launch import (
    initialize_multi_host, per_host_loader_slice, host_info)
initialize_multi_host(f"127.0.0.1:{port}", num_processes=2, process_id=pid)
assert host_info()["global_devices"] == 4

import numpy as np
import jax.numpy as jnp
from two_tower_recommender_model import config as cfg_lib
from two_tower_recommender_model.data import SyntheticClickstream
from two_tower_recommender_model.data.device_featurizer import PackedFeaturizer
from two_tower_recommender_model.parallel import (
    macro_batch_sharding, make_mesh, make_sharded_multi_step, plan_sharding,
    shard_train_state)
from two_tower_recommender_model.parallel.planner import ROW_SHARDED, TABLE_WISE
from two_tower_recommender_model.parallel.sharded import unshard_train_state
from two_tower_recommender_model.train.pipeline import device_put_batch
from two_tower_recommender_model.train.step import create_train_state, stack_batches

mcfg = cfg_lib.two_tower_model_config(num_users=64, num_items=40, embedding_dim=8,
                                      layer_sizes=(16, 8))
tcfg = cfg_lib.TrainConfig(sparse_learning_rate=0.05, learning_rate=1e-3)
mesh = make_mesh(4, 1)
plan = plan_sharding(mcfg, 4, force={"t_user_id": ROW_SHARDED,
                                     "t_product_id": TABLE_WISE})
state, dense_opt = create_train_state(jax.random.key(0), mcfg, tcfg)
state = shard_train_state(state, plan, mesh)
multi = make_sharded_multi_step(mcfg, tcfg, dense_opt, mesh, plan, donate=False)

ds = SyntheticClickstream(64, 40, seed=9)
pf = PackedFeaturizer(mcfg, pack_label=True)
host_index, num_hosts = per_host_loader_slice()
B, K = 32, 3  # global batch 32; each host contributes 16; one 3-step macro
local = []
for i in range(K):
    cols = ds.sample(B, start=i)
    lo = host_index * (B // num_hosts)
    local.append(pf({k: v[lo : lo + B // num_hosts] for k, v in cols.items()}))
mb = stack_batches(local)  # [K, B_local, S]
mb = device_put_batch(mb, macro_batch_sharding(mesh))  # global [K, B, S]
state, out = multi(state, mb)

loss = float(jax.device_get(out["loss"][-1]))
gathered = unshard_train_state(state, plan, mcfg)
if pid == 0:
    np.savez(os.path.join(out_dir, "result_packed.npz"),
             loss=loss,
             t_user=gathered.tables["t_user_id"],
             t_item=gathered.tables["t_product_id"])
print(f"worker {pid} done loss={loss}", flush=True)
'''


@pytest.mark.slow
def test_two_process_packed_macro_matches_single_process(tmp_path):
    """The PACKED multi-chip fast path across 2 real OS processes: per-host
    macro payload halves assemble via make_array_from_process_local_data,
    the K-step sharded scan (row-sharded + table-wise plan) must reproduce
    single-process sequential training."""
    port = _free_port()
    worker_py = tmp_path / "worker_packed.py"
    worker_py.write_text(WORKER_PACKED)
    env = dict(os.environ)
    procs = [
        subprocess.Popen(
            [sys.executable, str(worker_py), str(port), str(i), str(tmp_path)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for i in range(2)
    ]
    for p in procs:
        out, _ = p.communicate(timeout=300)
        assert p.returncode == 0, out[-3000:]
    result = np.load(tmp_path / "result_packed.npz")

    from two_tower_recommender_model import config as cfg_lib
    from two_tower_recommender_model.data import Featurizer, SyntheticClickstream
    from two_tower_recommender_model.train.step import create_train_state, make_train_step

    mcfg = cfg_lib.two_tower_model_config(num_users=64, num_items=40, embedding_dim=8,
                                          layer_sizes=(16, 8))
    tcfg = cfg_lib.TrainConfig(sparse_learning_rate=0.05, learning_rate=1e-3)
    state, dense_opt = create_train_state(jax.random.key(0), mcfg, tcfg)
    step = make_train_step(mcfg, tcfg, dense_opt, donate=False)
    ds = SyntheticClickstream(64, 40, seed=9)
    feat = Featurizer(mcfg)
    for i in range(3):
        state, out = step(state, jax.tree.map(jnp.asarray, feat(ds.sample(32, start=i))))

    np.testing.assert_allclose(result["loss"], float(out["loss"]), rtol=1e-5)
    np.testing.assert_allclose(result["t_user"], np.asarray(state.tables["t_user_id"]),
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(result["t_item"], np.asarray(state.tables["t_product_id"]),
                               rtol=1e-4, atol=1e-6)


WORKER_COMPACT = r'''
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_default_matmul_precision", "highest")

port, pid, out_dir = sys.argv[1], int(sys.argv[2]), sys.argv[3]
from two_tower_recommender_model.parallel.launch import (
    initialize_multi_host, per_host_loader_slice)
initialize_multi_host(f"127.0.0.1:{port}", num_processes=2, process_id=pid)

import numpy as np
import jax.numpy as jnp
from two_tower_recommender_model import config as cfg_lib
from two_tower_recommender_model.data import SyntheticClickstream
from two_tower_recommender_model.data.compact import CompactFeaturizer, CompactScheme
from two_tower_recommender_model.data.device_featurizer import PackedFeaturizer
from two_tower_recommender_model.parallel import (
    compact_macro_shardings_for_scheme, make_mesh, make_sharded_compact_multi_step,
    plan_sharding, shard_train_state)
from two_tower_recommender_model.parallel.planner import ROW_SHARDED
from two_tower_recommender_model.parallel.sharded import unshard_train_state
from two_tower_recommender_model.train.pipeline import device_put_batch
from two_tower_recommender_model.train.step import create_train_state, stack_batches

mcfg = cfg_lib.two_tower_model_config(num_users=64, num_items=40, embedding_dim=8,
                                      layer_sizes=(16, 8))
tcfg = cfg_lib.TrainConfig(sparse_learning_rate=0.05, learning_rate=1e-3)
mesh = make_mesh(4, 1)
plan = plan_sharding(mcfg, 4, force={"t_user_id": ROW_SHARDED,
                                     "t_product_id": ROW_SHARDED})
state, dense_opt = create_train_state(jax.random.key(0), mcfg, tcfg)
state = shard_train_state(state, plan, mesh)
scheme = CompactScheme.from_model(mcfg, pack_label=True)  # non-delta: multi-host OK
multi = make_sharded_compact_multi_step(mcfg, tcfg, dense_opt, mesh, plan, scheme,
                                        donate=False)

ds = SyntheticClickstream(64, 40, seed=9)
cf = CompactFeaturizer(PackedFeaturizer(mcfg, pack_label=True), scheme)
host_index, num_hosts = per_host_loader_slice()
B, K = 32, 3
local = []
for i in range(K):
    cols = ds.sample(B, start=i)
    lo = host_index * (B // num_hosts)
    local.append(cf({k: v[lo : lo + B // num_hosts] for k, v in cols.items()}))
mb = stack_batches(local)  # local CompactBatch slices [K, ..., B_local(...)]
sh = compact_macro_shardings_for_scheme(mesh, scheme, batch_size=B)
mb = device_put_batch(mb, sh)  # cross-process assembly per leaf
state, out = multi(state, mb)

loss = float(jax.device_get(out["loss"][-1]))
gathered = unshard_train_state(state, plan, mcfg)
if pid == 0:
    np.savez(os.path.join(out_dir, "result_compact.npz"),
             loss=loss, t_user=gathered.tables["t_user_id"])
print(f"worker {pid} done loss={loss}", flush=True)
'''


@pytest.mark.slow
def test_two_process_compact_wire_matches_single_process(tmp_path):
    """The COMPACT wire (bit-planed, batch axis LAST) across 2 real OS
    processes: per-host plane slices assemble via
    make_array_from_process_local_data against the shardings PYTREE, and the
    sharded compact scan must reproduce single-process training. (For the
    delta slot across processes see test_two_process_delta_wire_* —
    per-host sorts encode independent segments.)"""
    port = _free_port()
    worker_py = tmp_path / "worker_compact.py"
    worker_py.write_text(WORKER_COMPACT)
    env = dict(os.environ)
    procs = [
        subprocess.Popen(
            [sys.executable, str(worker_py), str(port), str(i), str(tmp_path)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for i in range(2)
    ]
    for p in procs:
        out, _ = p.communicate(timeout=300)
        assert p.returncode == 0, out[-3000:]
    result = np.load(tmp_path / "result_compact.npz")

    from two_tower_recommender_model import config as cfg_lib
    from two_tower_recommender_model.data import Featurizer, SyntheticClickstream
    from two_tower_recommender_model.train.step import create_train_state, make_train_step

    mcfg = cfg_lib.two_tower_model_config(num_users=64, num_items=40, embedding_dim=8,
                                          layer_sizes=(16, 8))
    tcfg = cfg_lib.TrainConfig(sparse_learning_rate=0.05, learning_rate=1e-3)
    state, dense_opt = create_train_state(jax.random.key(0), mcfg, tcfg)
    step = make_train_step(mcfg, tcfg, dense_opt, donate=False)
    ds = SyntheticClickstream(64, 40, seed=9)
    feat = Featurizer(mcfg)
    for i in range(3):
        state, out = step(state, jax.tree.map(jnp.asarray, feat(ds.sample(32, start=i))))

    np.testing.assert_allclose(result["loss"], float(out["loss"]), rtol=1e-5)
    np.testing.assert_allclose(result["t_user"], np.asarray(state.tables["t_user_id"]),
                               rtol=1e-4, atol=1e-6)


def test_cli_multihost_wire_cache(tmp_path):
    """--wire-cache across 2 OS processes: each host encodes ITS loader slice
    into its own cache (host-N-of-M subdir), epochs train through the macro
    assembler with global-min step alignment, metrics are finite."""
    import json

    from two_tower_recommender_model.data import SyntheticClickstream
    from two_tower_recommender_model.data.shards import write_dataset

    ds = SyntheticClickstream(60, 40, seed=1)
    for split, n in (("train", 2000), ("val", 400), ("test", 400)):
        cols = ds.sample(n, split)
        write_dataset(str(tmp_path / "data" / split), cols, rows_per_shard=256)

    port = _free_port()
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    env["JAX_PLATFORMS"] = "cpu"
    env["JAX_COORDINATOR_ADDRESS"] = f"127.0.0.1:{port}"
    env["JAX_NUM_PROCESSES"] = "2"

    procs = []
    for pid in range(2):
        e = dict(env)
        e["JAX_PROCESS_ID"] = str(pid)
        procs.append(subprocess.Popen(
            [sys.executable, "scripts/train.py",
             "--data-dir", str(tmp_path / "data"),
             "--num-users", "61", "--num-items", "41",
             "--epochs", "2", "--batch-size", "64",
             "--embedding-dim", "8", "--layer-sizes", "16", "8",
             "--limit-val-batches", "2", "--limit-test-batches", "2",
             "--multi-host", "--wire-format", "compact",
             "--wire-cache", str(tmp_path / "wc"),
             "--runs-root", str(tmp_path / f"runs{pid}")],
            env=e, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=300)
        outs.append(out)
        assert p.returncode == 0, out[-3000:]
    # one cache per process, each from that host's loader slice
    assert os.path.exists(str(tmp_path / "wc" / "host-0-of-2" / "gen-0" / "meta.json"))
    assert os.path.exists(str(tmp_path / "wc" / "host-1-of-2" / "gen-0" / "meta.json"))
    assert "wire cache built" in outs[0]
    results = [line for line in outs[0].splitlines() if "'test_auroc'" in line]
    assert results, outs[0][-2000:]
    parsed = json.loads(results[-1].replace("'", '"'))
    assert parsed["train_steps"] > 0, parsed
    for key in ("baseline_val_auroc", "val_loss", "val_auroc", "test_loss", "test_auroc"):
        assert np.isfinite(parsed[key]), (key, parsed)


WORKER_DELTA = r'''
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_default_matmul_precision", "highest")

port, pid, out_dir = sys.argv[1], int(sys.argv[2]), sys.argv[3]
from two_tower_recommender_model.parallel.launch import (
    initialize_multi_host, per_host_loader_slice)
initialize_multi_host(f"127.0.0.1:{port}", num_processes=2, process_id=pid)

import numpy as np
import jax.numpy as jnp
from two_tower_recommender_model import config as cfg_lib
from two_tower_recommender_model.data import SyntheticClickstream
from two_tower_recommender_model.data.compact import CompactFeaturizer, CompactScheme
from two_tower_recommender_model.data.device_featurizer import PackedFeaturizer
from two_tower_recommender_model.parallel import (
    compact_macro_shardings_for_scheme, make_mesh, make_sharded_compact_multi_step,
    plan_sharding, shard_train_state)
from two_tower_recommender_model.parallel.planner import ROW_SHARDED
from two_tower_recommender_model.parallel.sharded import unshard_train_state
from two_tower_recommender_model.train.pipeline import device_put_batch
from two_tower_recommender_model.train.step import create_train_state, stack_batches

mcfg = cfg_lib.two_tower_model_config(num_users=64, num_items=40, embedding_dim=8,
                                      layer_sizes=(16, 8))
tcfg = cfg_lib.TrainConfig(sparse_learning_rate=0.05, learning_rate=1e-3)
mesh = make_mesh(4, 1)
plan = plan_sharding(mcfg, 4, force={"t_user_id": ROW_SHARDED,
                                     "t_product_id": ROW_SHARDED})
state, dense_opt = create_train_state(jax.random.key(0), mcfg, tcfg)
state = shard_train_state(state, plan, mesh)
# per-host sort + per-segment delta: each process encodes its sorted slice
scheme = CompactScheme.from_model(mcfg, pack_label=True,
                                  delta_feature="user_id", delta_segments=2)
multi = make_sharded_compact_multi_step(mcfg, tcfg, dense_opt, mesh, plan, scheme,
                                        donate=False)

ds = SyntheticClickstream(64, 40, seed=9)
cf = CompactFeaturizer(
    PackedFeaturizer(mcfg, pack_label=True, sort_feature="user_id"), scheme)
host_index, num_hosts = per_host_loader_slice()
B, K = 32, 3
local = []
for i in range(K):
    cols = ds.sample(B, start=i)
    if i == 1:
        cols["user_id"][:5] = 0  # missing ids exercise the N+1 sentinel
    lo = host_index * (B // num_hosts)
    local.append(cf({k: v[lo : lo + B // num_hosts] for k, v in cols.items()}))
mb = stack_batches(local)
sh = compact_macro_shardings_for_scheme(mesh, scheme, batch_size=B)
mb = device_put_batch(mb, sh)
state, out = multi(state, mb)

loss = float(jax.device_get(out["loss"][-1]))
gathered = unshard_train_state(state, plan, mcfg)
if pid == 0:
    np.savez(os.path.join(out_dir, "result_delta.npz"),
             loss=loss, t_user=gathered.tables["t_user_id"],
             t_item=gathered.tables["t_product_id"])
print(f"worker {pid} done loss={loss}", flush=True)
'''


@pytest.mark.slow
def test_two_process_delta_wire_matches_single_process(tmp_path):
    """Per-host-sorted DELTA wire across 2 real OS processes: each process
    delta-encodes its own sorted slice (one segment), the [S*K] exception
    sidecars assemble across processes, and the segment-reset decode trains
    to the single-process result (row order within host slices differs ->
    f32 summation-order tolerance; loss is row-permutation-invariant)."""
    port = _free_port()
    worker_py = tmp_path / "worker_delta.py"
    worker_py.write_text(WORKER_DELTA)
    env = dict(os.environ)
    procs = [
        subprocess.Popen(
            [sys.executable, str(worker_py), str(port), str(i), str(tmp_path)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for i in range(2)
    ]
    for p in procs:
        out, _ = p.communicate(timeout=300)
        assert p.returncode == 0, out[-3000:]
    result = np.load(tmp_path / "result_delta.npz")

    from two_tower_recommender_model import config as cfg_lib
    from two_tower_recommender_model.data import Featurizer, SyntheticClickstream
    from two_tower_recommender_model.train.step import create_train_state, make_train_step

    mcfg = cfg_lib.two_tower_model_config(num_users=64, num_items=40, embedding_dim=8,
                                          layer_sizes=(16, 8))
    tcfg = cfg_lib.TrainConfig(sparse_learning_rate=0.05, learning_rate=1e-3)
    state, dense_opt = create_train_state(jax.random.key(0), mcfg, tcfg)
    step = make_train_step(mcfg, tcfg, dense_opt, donate=False)
    ds = SyntheticClickstream(64, 40, seed=9)
    feat = Featurizer(mcfg)
    for i in range(3):
        cols = ds.sample(32, start=i)
        if i == 1:
            cols["user_id"][:5] = 0
        state, out = step(state, jax.tree.map(jnp.asarray, feat(cols)))

    np.testing.assert_allclose(result["loss"], float(out["loss"]), rtol=1e-5)
    np.testing.assert_allclose(result["t_user"], np.asarray(state.tables["t_user_id"]),
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(result["t_item"], np.asarray(state.tables["t_product_id"]),
                               rtol=1e-4, atol=1e-6)


WORKER_INT8 = r'''
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_default_matmul_precision", "highest")

port, pid, out_dir = sys.argv[1], int(sys.argv[2]), sys.argv[3]
from two_tower_recommender_model.parallel.launch import (
    initialize_multi_host, per_host_loader_slice, put_global_batch)
initialize_multi_host(f"127.0.0.1:{port}", num_processes=2, process_id=pid)

import dataclasses
import numpy as np
import jax.numpy as jnp
from two_tower_recommender_model import config as cfg_lib
from two_tower_recommender_model.data import Featurizer, SyntheticClickstream
from two_tower_recommender_model.parallel import (
    make_mesh, make_sharded_train_step, plan_sharding, shard_train_state)
from two_tower_recommender_model.parallel.planner import ROW_SHARDED
from two_tower_recommender_model.parallel.sharded import unshard_train_state
from two_tower_recommender_model.ops.quantized import dequantize_table
from two_tower_recommender_model.train.step import create_train_state

# int8 tables without sorted_feature: the quantized segment update runs
# per shard across processes (no host sort required)
mcfg = cfg_lib.two_tower_model_config(num_users=300, num_items=80, embedding_dim=128)
mcfg = dataclasses.replace(mcfg, table_dtype="int8")
tcfg = cfg_lib.TrainConfig(sparse_learning_rate=0.05, learning_rate=1e-3)
mesh = make_mesh(4, 1)
plan = plan_sharding(mcfg, 4, force={"t_user_id": ROW_SHARDED, "t_product_id": ROW_SHARDED})
state, dense_opt = create_train_state(jax.random.key(0), mcfg, tcfg)
state = shard_train_state(state, plan, mesh)
step = make_sharded_train_step(mcfg, tcfg, dense_opt, mesh, plan, donate=False)

ds = SyntheticClickstream(300, 80, seed=9)
feat = Featurizer(mcfg)
host_index, num_hosts = per_host_loader_slice()
B = 256
for i in range(3):
    cols = ds.sample(B, start=i)
    lo = host_index * (B // num_hosts)
    local_cols = {k: v[lo : lo + B // num_hosts] for k, v in cols.items()}
    batch = put_global_batch(jax.tree.map(np.asarray, feat(local_cols)), mesh)
    state, out = step(state, batch)

loss = float(jax.device_get(out["loss"]))
gathered = unshard_train_state(state, plan, mcfg)
if pid == 0:
    np.savez(os.path.join(out_dir, "result_int8.npz"),
             loss=loss,
             t_user=np.asarray(dequantize_table(gathered.tables["t_user_id"])),
             t_item=np.asarray(dequantize_table(gathered.tables["t_product_id"])))
print(f"worker {pid} done loss={loss}", flush=True)
'''


@pytest.mark.slow
def test_two_process_int8_block_kernels_match_single_process(tmp_path):
    """int8 tables across 2 REAL processes — every table update runs the
    quantized segment update through cross-process collectives; dequantized
    result matches the single-process step (int8 rounding tolerance)."""
    port = _free_port()
    worker_py = tmp_path / "worker_int8.py"
    worker_py.write_text(WORKER_INT8)
    env = dict(os.environ)
    procs = [
        subprocess.Popen(
            [sys.executable, str(worker_py), str(port), str(i), str(tmp_path)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for i in range(2)
    ]
    for p in procs:
        out, _ = p.communicate(timeout=300)
        assert p.returncode == 0, out[-3000:]
    result = np.load(tmp_path / "result_int8.npz")

    import dataclasses

    from two_tower_recommender_model import config as cfg_lib
    from two_tower_recommender_model.data import Featurizer, SyntheticClickstream
    from two_tower_recommender_model.ops.quantized import dequantize_table
    from two_tower_recommender_model.train.step import create_train_state, make_train_step

    mcfg = cfg_lib.two_tower_model_config(num_users=300, num_items=80,
                                          embedding_dim=128)
    mcfg = dataclasses.replace(mcfg, table_dtype="int8")
    tcfg = cfg_lib.TrainConfig(sparse_learning_rate=0.05, learning_rate=1e-3)
    state, dense_opt = create_train_state(jax.random.key(0), mcfg, tcfg)
    step = make_train_step(mcfg, tcfg, dense_opt, donate=False)
    ds = SyntheticClickstream(300, 80, seed=9)
    feat = Featurizer(mcfg)
    for i in range(3):
        state, out = step(state, jax.tree.map(jnp.asarray, feat(ds.sample(256, start=i))))

    np.testing.assert_allclose(result["loss"], float(out["loss"]), rtol=1e-3)
    np.testing.assert_allclose(
        result["t_user"], np.asarray(dequantize_table(state.tables["t_user_id"])),
        atol=5e-3)
    np.testing.assert_allclose(
        result["t_item"], np.asarray(dequantize_table(state.tables["t_product_id"])),
        atol=5e-3)


WORKER_SOFTMAX = r'''
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_default_matmul_precision", "highest")

port, pid, out_dir = sys.argv[1], int(sys.argv[2]), sys.argv[3]
from two_tower_recommender_model.parallel.launch import (
    initialize_multi_host, per_host_loader_slice, put_global_batch, host_info)
initialize_multi_host(f"127.0.0.1:{port}", num_processes=2, process_id=pid)
assert host_info()["global_devices"] == 4

import numpy as np
import jax.numpy as jnp
from two_tower_recommender_model import config as cfg_lib
from two_tower_recommender_model.data import Featurizer, SyntheticClickstream
from two_tower_recommender_model.parallel import (
    make_mesh, make_sharded_train_step, plan_sharding, shard_train_state)
from two_tower_recommender_model.parallel.planner import ROW_SHARDED
from two_tower_recommender_model.parallel.sharded import unshard_train_state
from two_tower_recommender_model.train.step import create_train_state

mcfg = cfg_lib.two_tower_model_config(num_users=100, num_items=60, embedding_dim=16,
                                      layer_sizes=(32, 8))
tcfg = cfg_lib.TrainConfig(sparse_learning_rate=0.05, learning_rate=1e-3,
                           loss="sampled_softmax", logq_correction=True,
                           softmax_temperature=0.8)
mesh = make_mesh(4, 1)
plan = plan_sharding(mcfg, 4, force={"t_user_id": ROW_SHARDED, "t_product_id": ROW_SHARDED})
state, dense_opt = create_train_state(jax.random.key(0), mcfg, tcfg)
state = shard_train_state(state, plan, mesh)
step = make_sharded_train_step(mcfg, tcfg, dense_opt, mesh, plan, donate=False)

ds = SyntheticClickstream(100, 60, seed=5)
feat = Featurizer(mcfg)
host_index, num_hosts = per_host_loader_slice()
B = 512  # global batch -> B_local = 128
for i in range(2):
    cols = ds.sample(B, start=i)
    lo = host_index * (B // num_hosts)
    local_cols = {k: v[lo : lo + B // num_hosts] for k, v in cols.items()}
    batch = put_global_batch(jax.tree.map(np.asarray, feat(local_cols)), mesh)
    state, out = step(state, batch)

loss = float(jax.device_get(out["loss"]))
gathered = unshard_train_state(state, plan, mcfg)
if pid == 0:
    np.savez(os.path.join(out_dir, "result_softmax.npz"),
             loss=loss,
             counts=np.asarray(gathered.item_counts),
             t_user=gathered.tables["t_user_id"],
             t_item=gathered.tables["t_product_id"])
print(f"worker {pid} done loss={loss}", flush=True)
'''


@pytest.mark.slow
def test_two_process_sampled_softmax_fused_matches_single_process(tmp_path):
    """NORTH-STAR loss across 2 REAL processes: the GSPMD-partitioned
    sampled softmax with streaming logQ counts matches the single-process
    step."""
    port = _free_port()
    worker_py = tmp_path / "worker_softmax.py"
    worker_py.write_text(WORKER_SOFTMAX)
    env = dict(os.environ)
    procs = [
        subprocess.Popen(
            [sys.executable, str(worker_py), str(port), str(i), str(tmp_path)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for i in range(2)
    ]
    for p in procs:
        out, _ = p.communicate(timeout=300)
        assert p.returncode == 0, out[-3000:]
    result = np.load(tmp_path / "result_softmax.npz")

    from two_tower_recommender_model import config as cfg_lib
    from two_tower_recommender_model.data import Featurizer, SyntheticClickstream
    from two_tower_recommender_model.train.step import create_train_state, make_train_step

    mcfg = cfg_lib.two_tower_model_config(num_users=100, num_items=60, embedding_dim=16,
                                          layer_sizes=(32, 8))
    tcfg = cfg_lib.TrainConfig(sparse_learning_rate=0.05, learning_rate=1e-3,
                               loss="sampled_softmax", logq_correction=True,
                               softmax_temperature=0.8)
    state, dense_opt = create_train_state(jax.random.key(0), mcfg, tcfg)
    step = make_train_step(mcfg, tcfg, dense_opt, donate=False)
    ds = SyntheticClickstream(100, 60, seed=5)
    feat = Featurizer(mcfg)
    for i in range(2):
        state, out = step(state, jax.tree.map(jnp.asarray, feat(ds.sample(512, start=i))))

    np.testing.assert_allclose(result["loss"], float(out["loss"]), rtol=1e-4)
    np.testing.assert_allclose(result["counts"], np.asarray(state.item_counts))
    np.testing.assert_allclose(result["t_user"], np.asarray(state.tables["t_user_id"]),
                               rtol=1e-4, atol=1e-6)
    # the item table accumulates dc through a different f32 add order
    # (cross-process reductions vs one device)
    np.testing.assert_allclose(result["t_item"], np.asarray(state.tables["t_product_id"]),
                               rtol=1e-4, atol=1e-5)


WORKER_A2A = r'''
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_default_matmul_precision", "highest")

port, pid, out_dir = sys.argv[1], int(sys.argv[2]), sys.argv[3]
from two_tower_recommender_model.parallel.launch import (
    initialize_multi_host, per_host_loader_slice, put_global_batch, host_info)
initialize_multi_host(f"127.0.0.1:{port}", num_processes=2, process_id=pid)
assert host_info()["global_devices"] == 4

import numpy as np
import jax.numpy as jnp
from two_tower_recommender_model import config as cfg_lib
from two_tower_recommender_model.data import Featurizer, SyntheticClickstream
from two_tower_recommender_model.parallel import (
    make_mesh, make_sharded_train_step, plan_sharding, shard_train_state)
from two_tower_recommender_model.parallel.planner import ROW_SHARDED
from two_tower_recommender_model.parallel.sharded import unshard_train_state
from two_tower_recommender_model.train.step import create_train_state

mcfg = cfg_lib.two_tower_model_config(num_users=64, num_items=40, embedding_dim=8,
                                      layer_sizes=(16, 8))
# the ALL-TO-ALL exchange across REAL processes (DESIGN §9): cross-process
# all_to_all collectives + overflow accounting
tcfg = cfg_lib.TrainConfig(sparse_learning_rate=0.05, learning_rate=1e-3,
                           sharded_exchange="alltoall",
                           exchange_capacity_factor=4.0)
mesh = make_mesh(4, 1)
plan = plan_sharding(mcfg, 4, force={"t_user_id": ROW_SHARDED, "t_product_id": ROW_SHARDED})
state, dense_opt = create_train_state(jax.random.key(0), mcfg, tcfg)
state = shard_train_state(state, plan, mesh)
step = make_sharded_train_step(mcfg, tcfg, dense_opt, mesh, plan, donate=False)

ds = SyntheticClickstream(64, 40, seed=9)
feat = Featurizer(mcfg)
host_index, num_hosts = per_host_loader_slice()
B = 32
for i in range(3):
    cols = ds.sample(B, start=i)
    lo = host_index * (B // num_hosts)
    local_cols = {k: v[lo : lo + B // num_hosts] for k, v in cols.items()}
    batch = put_global_batch(jax.tree.map(np.asarray, feat(local_cols)), mesh)
    state, out = step(state, batch)
    assert int(jax.device_get(out["exchange_overflow"])) == 0

loss = float(jax.device_get(out["loss"]))
gathered = unshard_train_state(state, plan, mcfg)
if pid == 0:
    np.savez(os.path.join(out_dir, "result_a2a.npz"),
             loss=loss,
             t_user=gathered.tables["t_user_id"],
             t_item=gathered.tables["t_product_id"])
print(f"worker {pid} done loss={loss}", flush=True)
'''


@pytest.mark.slow
def test_two_process_alltoall_matches_single_process(tmp_path):
    """The round-5 all-to-all exchange across 2 REAL OS processes: the
    bucket route's all_to_all collectives cross process boundaries, the
    overflow count stays zero, and training reproduces the single-process
    step."""
    port = _free_port()
    worker_py = tmp_path / "worker_a2a.py"
    worker_py.write_text(WORKER_A2A)
    env = dict(os.environ)
    procs = [
        subprocess.Popen(
            [sys.executable, str(worker_py), str(port), str(i), str(tmp_path)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for i in range(2)
    ]
    for p in procs:
        out, _ = p.communicate(timeout=300)
        assert p.returncode == 0, out[-3000:]
    result = np.load(tmp_path / "result_a2a.npz")

    from two_tower_recommender_model import config as cfg_lib
    from two_tower_recommender_model.data import Featurizer, SyntheticClickstream
    from two_tower_recommender_model.train.step import create_train_state, make_train_step

    mcfg = cfg_lib.two_tower_model_config(num_users=64, num_items=40, embedding_dim=8,
                                          layer_sizes=(16, 8))
    tcfg = cfg_lib.TrainConfig(sparse_learning_rate=0.05, learning_rate=1e-3)
    state, dense_opt = create_train_state(jax.random.key(0), mcfg, tcfg)
    step = make_train_step(mcfg, tcfg, dense_opt, donate=False)
    ds = SyntheticClickstream(64, 40, seed=9)
    feat = Featurizer(mcfg)
    for i in range(3):
        state, out = step(state, jax.tree.map(jnp.asarray, feat(ds.sample(32, start=i))))

    np.testing.assert_allclose(result["loss"], float(out["loss"]), rtol=1e-5)
    np.testing.assert_allclose(result["t_user"], np.asarray(state.tables["t_user_id"]),
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(result["t_item"], np.asarray(state.tables["t_product_id"]),
                               rtol=1e-4, atol=1e-6)
