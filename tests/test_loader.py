"""StreamLoader: determinism, multi-host disjoint coverage, resume."""

import numpy as np
import pytest

from two_tower_recommender_model.data.loader import StreamLoader
from two_tower_recommender_model.data.shards import ShardedDataset, write_dataset


@pytest.fixture
def dataset(tmp_path):
    n = 1000
    write_dataset(
        str(tmp_path / "ds"),
        {"row_id": np.arange(n), "label": np.arange(n) % 2},
        rows_per_shard=128,
    )
    return ShardedDataset(str(tmp_path / "ds"))


def _collect(loader, n=None):
    out = []
    for i, b in enumerate(loader):
        out.append(b)
        if n is not None and i + 1 >= n:
            break
    return out


def test_deterministic_same_seed(dataset):
    a = _collect(StreamLoader(dataset, 64, seed=3))
    b = _collect(StreamLoader(dataset, 64, seed=3))
    assert len(a) == len(b) == 1000 // 64
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x["row_id"], y["row_id"])


def test_different_epochs_differ(dataset):
    l1 = StreamLoader(dataset, 64, seed=3, drop_last=False)
    a = _collect(l1)  # epoch 0; advances to epoch 1
    b = _collect(l1)  # epoch 1
    assert any(not np.array_equal(x["row_id"], y["row_id"]) for x, y in zip(a, b))
    # but both epochs cover the same sample set
    sa = np.sort(np.concatenate([x["row_id"] for x in a]))
    sb = np.sort(np.concatenate([x["row_id"] for x in b]))
    np.testing.assert_array_equal(sa, sb)


def test_full_coverage_no_shuffle(dataset):
    loader = StreamLoader(dataset, 100, shuffle=False, drop_last=False)
    rows = np.concatenate([b["row_id"] for b in loader])
    np.testing.assert_array_equal(np.sort(rows), np.arange(1000))


def test_multi_host_disjoint_and_complete(dataset):
    seen = []
    for h in range(4):
        loader = StreamLoader(dataset, 32, seed=5, host_index=h, num_hosts=4, drop_last=False)
        seen.append(np.concatenate([b["row_id"] for b in loader]))
    allrows = np.concatenate(seen)
    assert len(allrows) == 1000
    assert len(np.unique(allrows)) == 1000  # disjoint + complete


def test_drop_last(dataset):
    loader = StreamLoader(dataset, 300, drop_last=True)
    batches = _collect(loader)
    assert all(len(b["row_id"]) == 300 for b in batches)
    assert len(batches) == 3


def test_resume_mid_epoch(dataset):
    full = _collect(StreamLoader(dataset, 64, seed=7))

    loader = StreamLoader(dataset, 64, seed=7)
    it = iter(loader)
    first = [next(it) for _ in range(6)]
    state = loader.state_dict()
    assert state["batches_yielded"] == 6
    it.close()

    resumed = StreamLoader(dataset, 64, seed=7)
    resumed.load_state_dict(state)
    rest = _collect(resumed)
    got = first + rest
    assert len(got) == len(full)
    for x, y in zip(got, full):
        np.testing.assert_array_equal(x["row_id"], y["row_id"])


def test_resume_state_mismatch_rejected(dataset):
    loader = StreamLoader(dataset, 64, seed=7)
    state = loader.state_dict()
    other = StreamLoader(dataset, 64, seed=8)
    with pytest.raises(ValueError, match="incompatible"):
        other.load_state_dict(state)


def test_batches_per_epoch(dataset):
    assert StreamLoader(dataset, 64).batches_per_epoch() == 15
    assert StreamLoader(dataset, 64, drop_last=False).batches_per_epoch() == 16


def test_read_workers_deterministic(dataset):
    a = _collect(StreamLoader(dataset, 64, seed=3, read_workers=4))
    b = _collect(StreamLoader(dataset, 64, seed=3, read_workers=1))
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x["row_id"], y["row_id"])


def test_align_hosts_pad_complete_and_aligned(tmp_path):
    """align_hosts="pad" (eval mode): every host yields the same batch count
    (global max), data union is complete, and exhausted hosts yield 0-row
    batches whose dtypes match the dataset schema."""
    n = 500  # 1 shard of 128*3 + 116 over 4 shards; uneven across 3 hosts
    write_dataset(
        str(tmp_path / "ds"),
        {"row_id": np.arange(n), "label": (np.arange(n) % 2).astype(np.int64)},
        rows_per_shard=128,
    )
    ds = ShardedDataset(str(tmp_path / "ds"))
    loaders = [
        StreamLoader(ds, 64, shuffle=False, drop_last=False, host_index=h,
                     num_hosts=3, align_hosts="pad")
        for h in range(3)
    ]
    per_host = [_collect(ld) for ld in loaders]
    counts = [len(b) for b in per_host]
    assert counts[0] == counts[1] == counts[2] == loaders[0].batches_per_epoch(0)
    allrows = np.concatenate([b["row_id"] for bs in per_host for b in bs])
    np.testing.assert_array_equal(np.sort(allrows), np.arange(n))
    # the host with the least data ends in 0-row schema-typed batches
    empties = [b for bs in per_host for b in bs if len(b["row_id"]) == 0]
    assert empties
    for b in empties:
        assert set(b) == {"row_id", "label"}
        assert b["row_id"].dtype == np.arange(1).dtype
        assert b["label"].dtype == np.int64


def test_align_hosts_pad_zero_shard_host(tmp_path):
    """A host owning ZERO shards (fewer shards than hosts) still yields the
    global max batch count of empty batches — the case that silently
    produced nan eval metrics under min-truncation."""
    write_dataset(str(tmp_path / "ds"), {"row_id": np.arange(100)}, rows_per_shard=256)
    ds = ShardedDataset(str(tmp_path / "ds"))
    with_data = _collect(StreamLoader(ds, 32, shuffle=False, drop_last=False,
                                      host_index=0, num_hosts=2, align_hosts="pad"))
    without = _collect(StreamLoader(ds, 32, shuffle=False, drop_last=False,
                                    host_index=1, num_hosts=2, align_hosts="pad"))
    assert len(with_data) == len(without) == 4
    assert sum(len(b["row_id"]) for b in with_data) == 100
    assert all(len(b["row_id"]) == 0 for b in without)


def test_align_hosts_truncate_unchanged(dataset):
    """Default mode keeps the training semantics: all hosts truncated to the
    global minimum."""
    counts = []
    for h in range(3):
        ld = StreamLoader(dataset, 64, seed=5, host_index=h, num_hosts=3)
        counts.append(len(_collect(ld)))
    assert len(set(counts)) == 1
