"""The training loader's producer process (``data/producer.py``) against the
loader's in-process route (``num_workers=0``): the same batches bit for bit
and the same generator states after every batch, over epochs and after an
iteration left mid-epoch, single and data-parallel; batches that outlive the
producer's next ones; the producer's errors raised in the consumer; no
process left behind; no torch and no CUDA in the child; its spans and
counters.  Every step that waits on the producer has a time limit.

This module imports no torch: the CUDA probe below is unpickled in the
producer, which imports this module, and reports what the child loaded."""

import gc
import os
import sys
import threading

import numpy as np
import pytest

from treelearn_tpu_torch.data.dataset import (TreeDataset, TreeLoader,
                                              build_dataloader)
from treelearn_tpu_torch.data.synthetic import (make_crop_npz,
                                                make_synthetic_forest,
                                                verticality_proxy)

AUG = {"scaled": True, "jitter": True, "flip": True, "rot": True,
       "point_jitter": True}
N_CROPS = 7          # 3 batches of 2 an epoch, one crop left out
LIMIT_S = 15.0       # each step that waits on the producer, its start included


def _within(fn, seconds=LIMIT_S):
    """``fn()``, failing the test if it has not returned in ``seconds``."""
    out = {}

    def run():
        try:
            out["value"] = fn()
        except BaseException as exc:    # handed to the test's thread
            out["error"] = exc

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(seconds)
    assert not t.is_alive(), f"not done within {seconds} s"
    if "error" in out:
        raise out["error"]
    return out.get("value")


@pytest.fixture
def pool(tmp_path):
    for i in range(N_CROPS):
        data, _ = make_synthetic_forest(n_trees=2, extent=6,
                                        points_per_tree=200 + 40 * i,
                                        ground_points=500 + 30 * i,
                                        seed=i + 1)
        data[:, :2] -= data[:, :2].mean(0)
        make_crop_npz(str(tmp_path / f"c{i}.npz"), data,
                      verticality_proxy(data))
    return str(tmp_path)


def _loader(pool, num_workers, n_shards=1, dataset_cls=TreeDataset):
    ds = dataset_cls(pool, inner_square_edge_length=4.0, training=True,
                     data_augmentations=AUG, seed=11)
    return TreeLoader(ds, batch_size=2 // n_shards, training=True, seed=5,
                      min_bucket=2048, n_shards=n_shards,
                      num_workers=num_workers)


def _assert_same(got, want):
    assert list(got) == list(want)
    for k, w in want.items():
        g = got[k]
        if isinstance(w, np.ndarray):
            assert (g.dtype, g.shape) == (w.dtype, w.shape), k
            assert g.tobytes() == w.tobytes(), k
        else:
            assert type(g) is type(w) and g == w, k


def _assert_same_states(a, b):
    assert a.rng.bit_generator.state == b.rng.bit_generator.state
    assert (a.dataset.rng.bit_generator.state
            == b.dataset.rng.bit_generator.state)


def _pid(loader):
    return loader._producer.proc.pid


def _gone(pid):
    return not os.path.exists(f"/proc/{pid}")


def _children():
    """The pids of this process's children."""
    out = set()
    for tid in os.listdir("/proc/self/task"):
        try:
            with open(f"/proc/self/task/{tid}/children") as f:
                out.update(int(p) for p in f.read().split())
        except FileNotFoundError:       # a thread that has ended
            pass
    return out


def _take(it, n):
    return _within(lambda: [next(it) for _ in range(n)])


@pytest.mark.parametrize("n_shards", [1, 2])
def test_epochs_equal_the_in_process_stream(pool, n_shards):
    """Three epochs, every key and the padding bitwise, both generators'
    states after every batch; one producer serves all three."""
    here, there = _loader(pool, 0, n_shards), _loader(pool, 1, n_shards)
    assert len(here) == 3
    pids = set()
    for _ in range(3):
        a, b = iter(here), iter(there)
        for _ in range(len(here)):
            (want,), (got,) = [next(a)], _take(b, 1)
            _assert_same(got, want)
            _assert_same_states(there, here)
            pids.add(_pid(there))
        for it in (a, b):
            with pytest.raises(StopIteration):
                _within(lambda: next(it))
    assert len(pids) == 1
    there.close()


def test_left_mid_epoch_then_again(pool):
    """An iteration left after one batch (closed), a new one left by a
    break, then whole epochs: the producer restarts from the handed-back
    states and the stream stays the in-process one."""
    here, there = _loader(pool, 0), _loader(pool, 1)

    def both(n):
        a, b = iter(here), iter(there)
        for _ in range(n):
            _assert_same(_take(b, 1)[0], next(a))
            _assert_same_states(there, here)
        return a, b

    a, b = both(1)
    first = _pid(there)
    a.close()
    b.close()
    _assert_same_states(there, here)
    assert there._producer is None and _gone(first)

    def left_by_break():
        for x, y in zip(here, there):
            _assert_same(y, x)
            break

    _within(left_by_break)
    _assert_same_states(there, here)
    for _ in range(2):
        both(3)
    there.close()


def test_a_batch_outlives_the_next_five(pool):
    """Batch 0, held, is unchanged after five more batches (two epochs'
    worth of the producer's files)."""
    here, there = _loader(pool, 0), _loader(pool, 1)
    want = [b for _ in range(2) for b in here]
    it = iter(_forever(there))
    (b0,) = _take(it, 1)
    kept = {k: np.array(v, copy=True) if isinstance(v, np.ndarray) else v
            for k, v in b0.items()}
    rest = _take(it, 5)
    _assert_same(b0, kept)
    _assert_same(b0, want[0])
    for got, w in zip(rest, want[1:]):
        _assert_same(got, w)
    it.close()
    there.close()


def _forever(loader):
    while True:
        yield from loader


def test_slots_are_reused(pool):
    """Batches let go are the producer's to fill again: over seven epochs
    the slots stay a few batches' worth, and the stream is unchanged."""
    from treelearn_tpu_torch.data.producer import PREFETCH

    here, there = _loader(pool, 0), _loader(pool, 1)
    it = iter(_forever(there))
    n_arrays = None
    for _ in range(7):
        for want in here:
            (got,) = _take(it, 1)
            _assert_same(got, want)
            n_arrays = sum(isinstance(v, np.ndarray) for v in got.values())
            del got
    # live here: the last batch; made ahead: PREFETCH; in between: two
    assert len(there._producer._maps) <= (PREFETCH + 3) * n_arrays
    it.close()
    there.close()


def test_an_unreadable_crop_raises_in_the_consumer(pool):
    """A crop cut short after the loaders were built: the producer's
    exception reaches the consumer with the in-process route's type and
    message, at the same batch, and no process is left."""
    before = _children()
    here, there = _loader(pool, 0), _loader(pool, 1)
    path = sorted(os.listdir(pool))[3]
    with open(os.path.join(pool, path), "r+b") as f:
        f.truncate(100)

    def run(loader):
        got = []
        try:
            for _ in range(3):
                got.extend(loader)
        except Exception as exc:
            return got, exc
        raise AssertionError("no crop failed")

    want, err = run(here)
    got, exc = _within(lambda: run(there))
    assert type(exc) is type(err) and str(exc) == str(err)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _assert_same(g, w)
    assert there._producer is None and _children() <= before


def test_no_process_left(pool):
    """After close(), and after a loader whose producer runs on between
    epochs is collected, the producer process is gone and reaped."""
    before = _children()
    loader = _loader(pool, 1)
    _within(lambda: list(loader))
    pid = _pid(loader)
    loader.close()
    assert _gone(pid) and loader._producer is None
    assert _children() <= before
    _within(lambda: list(loader))       # the loader stays usable
    pid = _pid(loader)
    assert not _gone(pid)
    del loader
    _within(gc.collect)
    assert _gone(pid) and _children() <= before


class CudaProbe(TreeDataset):
    """A crop that carries, in every row, whether the process that made it
    had torch loaded and CUDA initialised."""

    def __getitem__(self, index):
        sample = super().__getitem__(index)
        torch = sys.modules.get("torch")
        flags = [torch is not None,
                 torch is not None and torch.cuda.is_initialized()]
        sample["probe"] = np.tile(np.asarray(flags), (len(sample["coords"]),
                                                      1))
        return sample


def test_the_producer_loads_no_torch_and_no_cuda(pool):
    loader = _loader(pool, 1, dataset_cls=CudaProbe)
    batches = _within(lambda: list(loader))
    loader.close()
    for b in batches:
        probe = b["probe"][:b["n_points"]]
        assert probe.shape == (b["n_points"], 2)
        assert not probe.any(), "torch or CUDA in the producer"


def test_spans_and_counters_on_receipt(pool):
    """The consumer's thread records one loader.wait span a batch and no
    part of making it; the producer's parts arrive as loader.*_us
    counters; every request is counted ready or waited."""
    from treelearn_tpu_torch.utils.trace import SpanTimer

    loader = _loader(pool, 1)
    with SpanTimer("cpu") as timer:
        batches = _within(lambda: [b for _ in range(2) for b in loader])
    loader.close()
    split, counters = timer.summary(), timer.counters()
    assert split["loader.wait"][0] == len(batches) == 6
    assert not {"loader.batch", "loader.read", "loader.collate"} & set(split)
    assert counters.get("loader.ready", 0) + counters.get(
        "loader.waited", 0) == 6
    for part in ("batch", "read", "augment", "offsets", "collate"):
        assert counters[f"loader.{part}_us"] > 0, part


@pytest.mark.parametrize("training,configured,want", [
    (True, None, 1), (False, None, 0), (True, 0, 0), (True, 2, 2),
    (False, 2, 2)])
def test_build_dataloader_passes_num_workers(pool, training, configured,
                                             want):
    ds = TreeDataset(pool, inner_square_edge_length=4.0, training=training)
    kw = {} if configured is None else {"num_workers": configured}
    assert build_dataloader(ds, training=training, **kw).num_workers == want
