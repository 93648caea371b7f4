"""The readback pool (titan_tpu_torch.ops.hostbuf) on the CPU, its
page-locking replaced by an injected allocator of plain host memory: a
buffer is never taken again while a view of the array it handed out
lives, at most two are held, a third readback with both held takes the
pageable path uncounted, a smaller readback takes a larger free buffer,
threads never share one, and memory refused once is not asked again. With no allocator injected the pool
leaves a CPU tensor as its own ``.numpy()`` view. The benchmark's reader
of the pool's counter closes the file."""

import sys
import threading

import numpy as np
import pytest
import torch

from gbench import registry
from titan_tpu_torch.obs import devprof
from titan_tpu_torch.ops import hostbuf as HB

KEY = "bfs_batched.readback.pinned"


class Alloc:
    """Plain host memory in place of page-locked memory, every request
    recorded."""

    def __init__(self):
        self.sizes = []

    def __call__(self, nbytes):
        self.sizes.append(nbytes)
        return torch.empty(nbytes, dtype=torch.uint8)


def _dist(K, n, seed):
    """A ``[K, n]`` column slice of a ``[K, n + 2]`` array, as the
    batched BFS reads back."""
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, 1 << 30, (K, n + 2), dtype=torch.int32,
                         generator=g)[:, :n]


def _in(pool, arr) -> int:
    """The index of the pool's buffer that ``arr`` lies in, or -1."""
    for i, b in enumerate(pool._bufs):
        if np.shares_memory(arr, b.mem.numpy()):
            return i
    return -1


def _pinned_calls(prof) -> int:
    return prof.kernel_stats().get(KEY, {}).get("calls", 0)


def test_a_buffer_waits_for_the_last_view_of_its_array():
    alloc = Alloc()
    pool = HB.HostBufferPool(alloc=alloc)
    t1 = _dist(4, 1000, 1)
    a1 = pool.read(t1, KEY)
    assert a1.shape == (4, 1000) and a1.dtype == np.int32
    assert np.array_equal(a1, t1.numpy()) and _in(pool, a1) == 0
    rows = [a1[0], a1[3, 10:20]]
    want = [r.copy() for r in rows]
    del a1
    # the rows keep the first buffer: the next readback pins a second
    a2 = pool.read(_dist(4, 1000, 2), KEY)
    assert _in(pool, a2) == 1 and alloc.sizes == [16000, 16000]
    del a2
    a3 = pool.read(_dist(4, 1000, 3), KEY)
    assert _in(pool, a3) == 1
    for r, w in zip(rows, want):
        assert np.array_equal(r, w)
    del a3
    rows.pop()
    a4 = pool.read(_dist(4, 1000, 4), KEY)
    assert _in(pool, a4) == 1             # one row of the first still held
    del a4
    rows.clear()
    a5 = pool.read(_dist(4, 1000, 5), KEY)
    assert _in(pool, a5) in (0, 1) and alloc.sizes == [16000, 16000]
    assert np.array_equal(a5, _dist(4, 1000, 5).numpy())


def test_a_third_readback_with_both_buffers_held_is_pageable():
    alloc = Alloc()
    pool = HB.HostBufferPool(alloc=alloc)
    with devprof.DeviceCostProfiler() as prof:
        held = [pool.read(_dist(3, 500, s), KEY) for s in (1, 2)]
        assert [_in(pool, a) for a in held] == [0, 1]
        assert _pinned_calls(prof) == 2
        t3 = _dist(3, 500, 3)
        a3 = pool.read(t3, KEY)
        assert _in(pool, a3) == -1 and np.array_equal(a3, t3.numpy())
        assert _pinned_calls(prof) == 2 and len(alloc.sizes) == HB.SLOTS
        assert pool.buffers() == [6000, 6000]
        held.pop()
        a4 = pool.read(_dist(3, 500, 4), KEY)
        assert _in(pool, a4) == 1 and _pinned_calls(prof) == 3
        assert np.array_equal(held[0], _dist(3, 500, 1).numpy())


def test_a_smaller_readback_takes_a_larger_free_buffer():
    alloc = Alloc()
    pool = HB.HostBufferPool(alloc=alloc)
    big = pool.read(_dist(16, 1000, 1), KEY)
    del big
    t = _dist(5, 999, 2)
    small = pool.read(t, KEY)
    assert small.shape == (5, 999) and small.dtype == np.int32
    assert small.flags.c_contiguous and _in(pool, small) == 0
    assert np.array_equal(small, t.numpy()) and alloc.sizes == [64000]
    # a larger one than every free buffer, the pool full: it replaces
    # the smaller free buffer; with none free it is pageable
    held = pool.read(_dist(2, 10, 3), KEY)
    assert pool.buffers() == [64000, 80]
    del small
    huge = pool.read(_dist(16, 2000, 4), KEY)
    assert pool.buffers() == [80, 128000] and _in(pool, huge) == 1
    assert np.array_equal(held, _dist(2, 10, 3).numpy())
    bigger = pool.read(_dist(16, 3000, 5), KEY)
    assert _in(pool, bigger) == -1 and pool.buffers() == [80, 128000]


@pytest.mark.parametrize("workers", [2, 6])
def test_threads_never_share_a_buffer(workers):
    """Two threads, and more threads than buffers (some readbacks then
    pageable), each reading back and checking its own arrays."""
    pool = HB.HostBufferPool(alloc=Alloc())
    rounds, errors = 300, []
    start = threading.Barrier(workers)

    def worker(w):
        try:
            start.wait(timeout=30)
            for i in range(rounds):
                t = _dist(4, 256, 1000 * w + i)
                a = pool.read(t, KEY)
                # another thread filling the same buffer would change it
                for _ in range(3):
                    assert np.array_equal(a, t.numpy()), (w, i)
                    threading.Event().wait(0)
                del a
        except BaseException as e:          # reported below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(w,))
                   for w in range(workers)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads)
    assert not errors, errors[0]
    assert len(pool.buffers()) <= HB.SLOTS


def test_cards_only_pool_leaves_a_cpu_tensor_as_its_view():
    pool = HB.HostBufferPool()
    t = _dist(2, 64, 1)
    with devprof.DeviceCostProfiler() as prof:
        a = pool.read(t, KEY)
        assert np.shares_memory(a, t.numpy()) and _pinned_calls(prof) == 0
    assert pool.buffers() == [] and HB.POOL.buffers() == []
    assert np.shares_memory(HB.POOL.read(t, KEY), t.numpy())


def test_a_refused_allocation_is_not_asked_again():
    asked = []

    def refuse(nbytes):
        asked.append(nbytes)
        return None
    pool = HB.HostBufferPool(alloc=refuse)
    for s in range(3):
        t = _dist(2, 64, s)
        a = pool.read(t, KEY)
        assert np.array_equal(a, t.numpy()) and _in(pool, a) == -1
    assert asked == [512] and pool.buffers() == []


def _run(readback, pinned, served=True):
    prof = {"bfs_batched.readback": {"calls": readback, "exec_s": 1.0}}
    if pinned is not None:
        prof[KEY] = {"calls": pinned, "exec_s": 0.1}
    return {"window": (0.0, 51.0), "on_card": True, "devprof": prof,
            "jobs": [{"kind": "bfs" if served else "dense", "ok": True}]}


@pytest.mark.parametrize("readback,pinned,want", [
    (16, 16, 1.0), (16, 12, 0.75), (16, 0, 0.0),
    (16, None, None),        # a program without the pool (the parent)
    (0, 0, None)])           # no readback in the window
def test_the_benchmark_reads_the_pinned_share(readback, pinned, want):
    read = registry.metric("model.bfs_pinned_share").read
    assert read(_run(readback, pinned)) == want
    assert read(_run(readback, pinned, served=False)) is None
