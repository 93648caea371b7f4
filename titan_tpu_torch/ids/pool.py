"""Per-namespace id pools with background block renewal.

(reference: titan-core graphdb/database/idassigner/StandardIDPool.java:291 —
claims contiguous blocks from the IDAuthority and hands out ids one at a
time; when the current block is ``renew_percentage`` from exhaustion a
background fetch starts so callers rarely block on the authority.)
"""

from __future__ import annotations

import threading
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Optional

from titan_tpu_torch.errors import IDPoolExhaustedError
from titan_tpu_torch.ids.authority import IDAuthority, IDBlock

_renew_pool = ThreadPoolExecutor(max_workers=2, thread_name_prefix="idpool-renew")


class StandardIDPool:
    def __init__(self, authority: IDAuthority, namespace: bytes,
                 block_size: int, max_id: int, renew_percentage: float = 0.3,
                 renew_timeout_s: float = 120.0):
        self._authority = authority
        self._namespace = namespace
        self._block_size = block_size
        self._max_id = max_id
        self._renew_at = max(1, int(block_size * renew_percentage))
        self._timeout = renew_timeout_s
        self._lock = threading.Lock()
        self._block: Optional[IDBlock] = None
        self._next = 0
        self._pending: Optional[Future] = None
        self._closed = False

    def _fetch(self) -> IDBlock:
        block = self._authority.get_id_block(self._namespace, self._block_size,
                                             self._timeout)
        if block.start >= self._max_id:
            raise IDPoolExhaustedError(
                f"id namespace {self._namespace!r} exhausted (max {self._max_id})")
        return block

    def next_id(self) -> int:
        with self._lock:
            if self._closed:
                raise IDPoolExhaustedError("pool closed")
            while self._block is None or self._next >= self._block.end:
                if self._pending is not None:
                    fut, self._pending = self._pending, None
                    self._block = fut.result()
                else:
                    self._block = self._fetch()
                self._next = self._block.start
            nid = self._next
            self._next += 1
            if (self._block.end - self._next) == self._renew_at and \
                    self._pending is None:
                self._pending = _renew_pool.submit(self._fetch)
            if nid >= self._max_id:
                raise IDPoolExhaustedError(
                    f"id namespace {self._namespace!r} exhausted")
            return nid

    def close(self):
        with self._lock:
            self._closed = True
