"""Host->device input pipeline: featurize + transfer ahead of compute.

The role of the reference's `TrainPipelineSparseDist` overlap (H2D copy stream
+ input-dist + compute, `03_model_training.py:648`) re-done for JAX: JAX
dispatch is async, so keeping N batches in flight means simply featurizing and
`jax.device_put`-ing ahead of the step that consumes them — the transfer and
the previous step's compute overlap without explicit streams. A background
thread hides featurizer CPU time too.
"""

from __future__ import annotations

import collections
import queue
import threading
from typing import Callable, Iterable, Iterator

import jax

from two_tower_recommender_model.data.featurizer import Batch


def device_put_batch(batch: Batch, sharding=None) -> Batch:
    """`sharding` is either a callable (leaf -> NamedSharding) or a pytree of
    NamedShardings matching `batch` (e.g. `compact_macro_shardings`, whose
    wire leaves shard a NON-leading axis that a per-leaf callable can't
    distinguish)."""
    if sharding is None:
        return jax.tree.map(jax.device_put, batch)
    get = sharding if callable(sharding) else None
    if jax.process_count() > 1:
        # multi-host: this process holds only its LOCAL slice of the global
        # batch; device_put with a cross-process sharding would treat the
        # local array as the whole global value (silently dropping the other
        # hosts' data) — assemble through process-local data instead
        if get is not None:
            return jax.tree.map(
                lambda x: jax.make_array_from_process_local_data(get(x), x), batch
            )
        return jax.tree.map(
            lambda x, s: jax.make_array_from_process_local_data(s, x), batch, sharding
        )
    if get is not None:
        return jax.tree.map(lambda x: jax.device_put(x, get(x)), batch)
    return jax.tree.map(lambda x, s: jax.device_put(x, s), batch, sharding)


def prefetch_to_device(
    columns_iter: Iterable[dict],
    featurize: Callable[[dict], Batch],
    prefetch: int = 2,
    sharding=None,
    background: bool = True,
    num_workers: int = 1,
) -> Iterator[Batch]:
    """Yield device-resident Batches, keeping `prefetch` transfers in flight.
    `num_workers > 1` featurizes concurrently (order preserved) — useful when
    host featurization, not the device, limits throughput."""
    if background and num_workers > 1:
        from concurrent.futures import ThreadPoolExecutor

        pool = ThreadPoolExecutor(max_workers=num_workers)

        def host_batches():
            futures: collections.deque = collections.deque()
            it = iter(columns_iter)
            try:
                for cols in it:
                    futures.append(pool.submit(featurize, cols))
                    if len(futures) > num_workers + 1:
                        yield futures.popleft().result()
                while futures:
                    yield futures.popleft().result()
            finally:
                pool.shutdown(wait=False, cancel_futures=True)

        source = host_batches()
    elif background:
        q: queue.Queue = queue.Queue(maxsize=max(prefetch, 1))
        stop = object()
        abandoned = threading.Event()
        err: list[BaseException] = []

        def put(item) -> bool:
            while not abandoned.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for cols in columns_iter:
                    if not put(featurize(cols)):
                        return
            except BaseException as e:  # propagate to consumer
                err.append(e)
            finally:
                put(stop)

        t = threading.Thread(target=worker, daemon=True)
        t.start()

        def host_batches():
            try:
                while True:
                    item = q.get()
                    if item is stop:
                        if err:
                            raise err[0]
                        return
                    yield item
            finally:
                abandoned.set()

        source = host_batches()
    else:
        source = (featurize(cols) for cols in columns_iter)

    buf: collections.deque = collections.deque()
    for hb in source:
        buf.append(device_put_batch(hb, sharding))
        if len(buf) > prefetch:
            yield buf.popleft()
    while buf:
        yield buf.popleft()


def macro_stream(columns_iter: Iterable[dict], packed_featurizer, k: int):
    """Group a per-batch column stream into K-deep macro-batches for
    `train.step.make_multi_step` (leading axis K on every leaf) — the
    bench-proven pattern that amortizes transfer + dispatch latency. Drops a
    trailing partial group (macro shapes must stay static under jit)."""
    from two_tower_recommender_model.train.step import stack_batches

    group = []
    for cols in columns_iter:
        group.append(packed_featurizer(cols))
        if len(group) == k:
            yield stack_batches(group)
            group = []
