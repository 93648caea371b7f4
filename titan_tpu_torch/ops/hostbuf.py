"""Page-locked host buffers for a result's readback from the card.

A copy from the card into pageable memory is staged by CUDA through a
bounce buffer, and each page of a fresh destination faults on first
touch; into page-locked memory that is already mapped it runs at the
link's rate.
``POOL.read(t, key)`` copies a ``[K, n]`` card tensor into a buffer of
the process's pool and returns a numpy array over it, of ``t``'s shape
and dtype, complete when it returns. The rows a caller keeps are views
of that array, so a buffer is taken again only once the array it last
handed out is gone: the pool holds a weak reference to the array, never
a count of readbacks or a time.

The pool holds at most ``SLOTS`` buffers: one being filled, one still
held by the last batch's callers. A readback takes the smallest free
buffer at least as large as it is. With none, it locks one of its own
size while the pool has room, or in place of a smaller free one; else it
takes the pageable path, ``t.cpu().numpy()``. A process that keeps every
result so locks two buffers and then reads back as before, and one where
CUDA refuses to lock memory reads back as before from then on. A buffer
is ordinary host memory page-locked by ``cudaHostRegister``
(portable to every card), so one put out of the pool is unlocked and
freed, not kept in PyTorch's pinned cache. One lock guards the pool; the
copy runs outside it, into a buffer no other thread can take. A CPU
tensor comes back as its own ``.numpy()`` view, no copy.
"""

from __future__ import annotations

import threading
import weakref

import numpy as np
import torch

from titan_tpu_torch.obs import devprof

__all__ = ["HostBufferPool", "POOL", "SLOTS"]

#: buffers a pool holds: one being filled, one still held by callers
SLOTS = 2
#: ``cudaHostRegisterPortable``: page-locked for every card's context
_PORTABLE = 1
#: ``_Buffer.held`` while a readback copies into the buffer
_FILLING = object()


def _lock_pages(nbytes: int):
    """``nbytes`` of host memory page-locked, as a uint8 tensor, or None
    where CUDA refuses to lock them."""
    # faulted in first: CUDA locks present pages faster than it faults
    # them in itself
    mem = torch.zeros(nbytes, dtype=torch.uint8)
    rt = torch.cuda.cudart()
    if rt.cudaHostRegister(mem.data_ptr(), nbytes, _PORTABLE) \
            != rt.cudaError.success:
        return None
    return mem


def _unlock_pages(ptr: int) -> None:
    torch.cuda.cudart().cudaHostUnregister(ptr)


class _Buffer:
    """A uint8 host tensor and who holds it: None (free), ``_FILLING``,
    or a weak reference to the array it handed out (free once that is
    dead). A locked buffer's pages are unlocked once, when it leaves the
    pool or is collected: a collected object's weak references are
    called before its slots are cleared, so before ``mem`` is dropped."""

    __slots__ = ("mem", "held", "unlock", "__weakref__")

    def __init__(self, mem: torch.Tensor, locked: bool):
        self.mem = mem
        self.held = None
        self.unlock = None
        if locked:
            self.unlock = weakref.finalize(self, _unlock_pages,
                                           mem.data_ptr())
            self.unlock.atexit = False

    def free(self) -> bool:
        held = self.held
        return held is None or (held is not _FILLING and held() is None)


class HostBufferPool:
    """At most ``SLOTS`` host buffers for readbacks (module doc).

    ``alloc(nbytes)`` returns a uint8 host tensor, or None where the
    memory cannot be had. None locks host memory's pages and serves card
    tensors only; an injected allocator (tests) serves tensors of every
    device, the CPU's included."""

    def __init__(self, alloc=None):
        self._alloc = alloc or _lock_pages
        self._locks = alloc is None
        self._refused = False
        self._lock = threading.Lock()
        self._bufs: list[_Buffer] = []

    def buffers(self) -> list[int]:
        """The byte size of each buffer the pool holds."""
        with self._lock:
            return [b.mem.numel() for b in self._bufs]

    def _take(self, nbytes: int):
        """A buffer of at least ``nbytes`` marked as filling, or None
        (the pageable path)."""
        with self._lock:
            free = [b for b in self._bufs if b.free()]
            fits = [b for b in free if b.mem.numel() >= nbytes]
            if fits:
                buf = min(fits, key=lambda b: b.mem.numel())
            else:
                full = len(self._bufs) >= SLOTS
                if self._refused or (full and not free):
                    return None
                if full:
                    # a smaller free buffer makes room, its memory freed
                    # before the new buffer's is taken
                    old = free.pop(0)
                    self._bufs.remove(old)
                    if old.unlock is not None:
                        old.unlock()
                    del old
                mem = self._alloc(nbytes)
                if mem is None:
                    self._refused = True
                    return None
                buf = _Buffer(mem, self._locks)
                self._bufs.append(buf)
            buf.held = _FILLING
            return buf

    def _hand_out(self, buf: _Buffer, arr) -> None:
        with self._lock:
            buf.held = None if arr is None else weakref.ref(arr)

    def read(self, t: torch.Tensor, key: str) -> np.ndarray:
        """``t``, a ``[K, n]`` tensor whose rows are each contiguous, on
        the host as a numpy array (module doc); a readback that lands in
        a buffer of the pool counts as a call of the host stage
        ``key``."""
        if self._locks and t.device.type != "cuda":
            return t.numpy()
        nbytes = t.numel() * t.element_size()
        buf = self._take(nbytes)
        if buf is None:
            return t.cpu().numpy()
        try:
            with devprof.stage(key):
                host = buf.mem[:nbytes].view(t.dtype).view(t.shape)
                # row by row: each row of a [K, n] column slice is
                # contiguous, so no [K, n] copy on the card first
                for i in range(t.shape[0]):
                    host[i].copy_(t[i], non_blocking=True)
                if t.device.type == "cuda":
                    torch.cuda.current_stream(t.device).synchronize()
                arr = host.numpy()
        except BaseException:
            self._hand_out(buf, None)
            raise
        self._hand_out(buf, arr)
        return arr


#: the process's pool
POOL = HostBufferPool()
