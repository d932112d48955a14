"""Deterministic, resumable, multi-host streaming loader over TTRS shards.

The role of `StreamingDataset`/`StreamingDataLoader`
(`get_dataloader_with_mosaic`, `03_model_training.py:386-393`): per-host shard
partitioning, seeded shuffling, batching — plus the two things the reference
delegates to the Mosaic library and never exercises (SURVEY §5):

- **determinism**: the visit order is a pure function of
  (seed, epoch, host_index, num_hosts); every host sees a disjoint sample set.
- **true resume**: `state_dict()` captures (epoch, batches_yielded);
  `load_state_dict()` fast-forwards by skipping whole shards where possible,
  so a restored run continues the exact same stream.

A background thread prefetches the next shard while the current one is being
sliced into batches (the host-side half of the reference's
`TrainPipelineSparseDist` overlap).
"""

from __future__ import annotations

import collections
import queue
import threading
from typing import Iterator

import numpy as np

from two_tower_recommender_model.data.shards import ShardedDataset


class StreamLoader:
    def __init__(
        self,
        dataset: ShardedDataset | str,
        batch_size: int,
        shuffle: bool = True,
        seed: int = 0,
        host_index: int = 0,
        num_hosts: int = 1,
        drop_last: bool = True,
        prefetch_shards: int = 2,
        columns: list[str] | None = None,
        read_workers: int = 1,
        align_hosts: str = "truncate",
    ):
        """`read_workers > 1` decodes shards concurrently (order preserved;
        zlib inflate in the native reader releases the GIL, so workers scale).
        Determinism is unaffected — the visit order is fixed by the plan.

        `align_hosts` governs multi-host step alignment (every host must
        dispatch the same number of steps — each carries cross-host
        collectives). "truncate" (default, the training choice) cuts all
        hosts to the global MINIMUM batch count. "pad" (the eval choice)
        runs every host to the global MAXIMUM: hosts that run out of data
        yield 0-row batches, which `evaluate(pad_to=...)` grows into
        all-padding zero-weight batches — no sample is ever dropped, unlike
        mosaic's drop-based rebalancing (`03_model_training.py:386-393`)."""
        self.dataset = ShardedDataset(dataset) if isinstance(dataset, str) else dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.host_index = host_index
        self.num_hosts = num_hosts
        self.drop_last = drop_last
        self.prefetch_shards = prefetch_shards
        self.columns = columns
        self.read_workers = read_workers
        if align_hosts not in ("truncate", "pad"):
            raise ValueError(f"align_hosts must be 'truncate' or 'pad', got {align_hosts!r}")
        self.align_hosts = align_hosts
        self._epoch = 0
        self._batches_yielded = 0  # within current epoch

    # -- determinism ------------------------------------------------------

    def _epoch_plan(self, epoch: int) -> list[int]:
        """This host's shard visit order for an epoch."""
        order = np.arange(self.dataset.num_shards)
        if self.shuffle:
            rng = np.random.default_rng(np.random.SeedSequence([self.seed, epoch]))
            rng.shuffle(order)
        # round-robin shard assignment => each sample belongs to exactly one host
        return [int(s) for s in order[self.host_index :: self.num_hosts]]

    def _row_perm(self, epoch: int, shard: int, n: int) -> np.ndarray:
        if not self.shuffle:
            return np.arange(n)
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, epoch, shard]))
        return rng.permutation(n)

    def batches_per_epoch(self, epoch: int = 0) -> int:
        if self.num_hosts > 1:
            counts = self._host_batch_counts(epoch)
            return min(counts) if self.align_hosts == "truncate" else max(counts)
        rows = sum(self.dataset.shard_row_counts[s] for s in self._epoch_plan(epoch))
        if self.drop_last:
            return rows // self.batch_size
        return -(-rows // self.batch_size)

    def _host_batch_counts(self, epoch: int) -> list[int]:
        """Per-host batch counts for an epoch. In multi-host mode every host
        must dispatch the SAME number of steps (each step contains cross-host
        collectives); with unequal shard row counts, round-robin assignment
        can give hosts different counts. align_hosts="truncate" cuts everyone
        to min(counts); align_hosts="pad" runs everyone to max(counts) with
        0-row filler batches (see __iter__)."""
        counts = []
        order = np.arange(self.dataset.num_shards)
        if self.shuffle:
            rng = np.random.default_rng(np.random.SeedSequence([self.seed, epoch]))
            rng.shuffle(order)
        for h in range(self.num_hosts):
            rows = sum(self.dataset.shard_row_counts[int(s)] for s in order[h :: self.num_hosts])
            counts.append(
                rows // self.batch_size if self.drop_last else -(-rows // self.batch_size)
            )
        return counts

    def _empty_batch(self) -> dict[str, np.ndarray]:
        sch = self.dataset.schema(self.columns)
        return {k: np.zeros((0, *shape), dtype) for k, (dtype, shape) in sch.items()}

    # -- resume -----------------------------------------------------------

    def state_dict(self) -> dict:
        return {
            "epoch": self._epoch,
            "batches_yielded": self._batches_yielded,
            "seed": self.seed,
            "host_index": self.host_index,
            "num_hosts": self.num_hosts,
        }

    def load_state_dict(self, state: dict) -> None:
        if (state["seed"], state["host_index"], state["num_hosts"]) != (
            self.seed, self.host_index, self.num_hosts,
        ):
            raise ValueError(
                f"loader state {state} incompatible with loader "
                f"(seed={self.seed}, host={self.host_index}/{self.num_hosts})"
            )
        self._epoch = state["epoch"]
        self._batches_yielded = state["batches_yielded"]

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch
        self._batches_yielded = 0

    # -- iteration --------------------------------------------------------

    def _shard_reader_pool(self, plan: list[int], out: queue.Queue, stop: threading.Event):
        """Multi-worker variant: decode up to `read_workers` shards ahead,
        emit in plan order."""
        from concurrent.futures import ThreadPoolExecutor

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    out.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        pool = ThreadPoolExecutor(max_workers=self.read_workers)
        try:
            futures = collections.deque()
            for s in plan:
                if stop.is_set():
                    return
                futures.append((s, pool.submit(self.dataset.read_shard, s, self.columns)))
                while len(futures) > self.read_workers:
                    s0, f = futures.popleft()
                    if not put((s0, f.result())):
                        return
            while futures:
                s0, f = futures.popleft()
                if not put((s0, f.result())):
                    return
        except BaseException as e:
            put(e)
        finally:
            pool.shutdown(wait=False, cancel_futures=True)
            put(None)

    def _shard_reader(self, plan: list[int], out: queue.Queue, stop: threading.Event):
        def put(item) -> bool:
            # bounded-queue put that gives up when the consumer abandoned the
            # iterator (otherwise this thread would block forever holding a
            # decoded shard)
            while not stop.is_set():
                try:
                    out.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        try:
            for s in plan:
                if stop.is_set():
                    return
                if not put((s, self.dataset.read_shard(s, self.columns))):
                    return
        except BaseException as e:
            put(e)
        finally:
            put(None)

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        epoch = self._epoch
        skip_batches = self._batches_yielded
        plan = self._epoch_plan(epoch)
        max_batches = pad_to_batches = None
        if self.num_hosts > 1:
            counts = self._host_batch_counts(epoch)
            if self.align_hosts == "truncate":
                max_batches = min(counts)
            else:  # "pad": no truncation; fill up to the global max
                pad_to_batches = max(counts)

        # Fast-forward for resume: a batch never crosses shards in reverse, so
        # we can drop whole shards that were fully consumed.
        skip_rows = skip_batches * self.batch_size
        rows_before = 0
        start_idx = 0
        for i, s in enumerate(plan):
            n = self.dataset.shard_row_counts[s]
            if rows_before + n <= skip_rows:
                rows_before += n
                start_idx = i + 1
            else:
                break
        within_shard_skip = skip_rows - rows_before

        q: queue.Queue = queue.Queue(maxsize=self.prefetch_shards)
        stop = threading.Event()
        reader = self._shard_reader_pool if self.read_workers > 1 else self._shard_reader
        t = threading.Thread(target=reader, args=(plan[start_idx:], q, stop), daemon=True)
        t.start()

        buf = _ChunkBuffer()
        first = True
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                if isinstance(item, BaseException):
                    raise item
                s, cols = item
                perm = self._row_perm(epoch, s, len(next(iter(cols.values()))))
                if first and within_shard_skip:
                    perm = perm[within_shard_skip:]
                first = False
                buf.push({k: v[perm] for k, v in cols.items()})
                while buf.rows >= self.batch_size:
                    if max_batches is not None and self._batches_yielded >= max_batches:
                        self._epoch = epoch + 1  # truncated epoch still completes
                        self._batches_yielded = 0
                        return
                    self._batches_yielded += 1
                    yield buf.take(self.batch_size)
            if (
                buf.rows
                and not self.drop_last
                and (max_batches is None or self._batches_yielded < max_batches)
            ):
                self._batches_yielded += 1
                yield buf.take(buf.rows)
            if pad_to_batches is not None and self._batches_yielded < pad_to_batches:
                empty = self._empty_batch()
                while self._batches_yielded < pad_to_batches:
                    self._batches_yielded += 1
                    yield {k: v.copy() for k, v in empty.items()}
        finally:
            stop.set()
        # epoch finished -> advance
        self._epoch = epoch + 1
        self._batches_yielded = 0


class _ChunkBuffer:
    """Row cursor over queued shard chunks. Batches are zero-copy views into
    the decoded shard arrays; only the (rare) batch straddling a shard
    boundary concatenates — the previous rebuild-the-buffer-per-batch scheme
    recopied every column once per batch (O(shard_rows x batches_per_shard)
    host traffic)."""

    def __init__(self):
        self.chunks: collections.deque[dict[str, np.ndarray]] = collections.deque()
        self.rows = 0
        self._head_off = 0

    def push(self, cols: dict[str, np.ndarray]) -> None:
        n = len(next(iter(cols.values())))
        if n:
            self.chunks.append(cols)
            self.rows += n

    def take(self, n: int) -> dict[str, np.ndarray]:
        parts = []
        need = n
        while need:
            head = self.chunks[0]
            avail = len(next(iter(head.values()))) - self._head_off
            use = min(avail, need)
            parts.append({k: v[self._head_off : self._head_off + use] for k, v in head.items()})
            self._head_off += use
            need -= use
            if use == avail:
                self.chunks.popleft()
                self._head_off = 0
        self.rows -= n
        if len(parts) == 1:
            return parts[0]
        return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
