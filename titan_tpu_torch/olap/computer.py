"""Host BSP graph computer: thread-pool scan execution of VertexPrograms.

(reference: titan-core graphdb/olap/computer/FulgoraGraphComputer.java:48-401
— per-iteration scan over all vertices executing the program, message
exchange through an in-heap vertex memory with optional combiners, loop until
``terminate``, then write mutated vertex state back in batched transactions.
This is the generality fallback; DensePrograms take the superstep engine,
``olap/engine.GPUGraphComputer``.)

The port's copy of ``titan_tpu/olap/computer.py``: ``g.compute("host")``
returns it. Host code only, it touches no device.
"""

from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

from titan_tpu_torch.olap.api import (MapReduce, Memory, Messenger,
                                      ScanMetrics, VertexProgram,
                                      execute_map_reduce)


def _check_map_reduces(map_reduces, require=None) -> None:
    """Reject wrong stage types up front and duplicate memory keys (two
    stages sharing a key would silently overwrite each other's result)."""
    if not map_reduces:
        return
    seen = set()
    for mr in map_reduces:
        if require is not None and not isinstance(mr, require):
            names = ([r.__name__ for r in require]
                     if isinstance(require, tuple) else [require.__name__])
            raise TypeError(
                f"{type(mr).__name__} is not a supported MapReduce stage "
                f"here (need {'/'.join(names)}; DenseMapReduce runs on the "
                "GPU computer only)")
        if mr.memory_key in seen:
            raise ValueError(
                f"duplicate MapReduce memory_key {mr.memory_key!r}")
        seen.add(mr.memory_key)


class VertexMemory:
    """(reference: FulgoraVertexMemory.java:24-120) per-vertex message
    buckets with optional combiner, double-buffered across supersteps."""

    def __init__(self, combiner=None):
        self._combiner = combiner
        self._incoming: dict[int, list] = {}
        self._outgoing: dict[int, list] = {}
        self._state: dict[int, dict] = {}
        self._lock = threading.Lock()

    def send(self, target: int, message) -> None:
        with self._lock:
            if self._combiner is not None:
                cur = self._outgoing.get(target)
                if cur is None:
                    self._outgoing[target] = [message]
                else:
                    cur[0] = self._combiner(cur[0], message)
            else:
                self._outgoing.setdefault(target, []).append(message)

    def messages_for(self, vid: int) -> list:
        return self._incoming.get(vid, [])

    def complete_iteration(self) -> None:
        self._incoming = self._outgoing
        self._outgoing = {}

    def get_state(self, vid: int) -> dict:
        st = self._state.get(vid)
        if st is None:
            st = {}
            with self._lock:
                self._state.setdefault(vid, st)
                st = self._state[vid]
        return st

    def all_states(self) -> dict:
        return self._state


class ComputerVertex:
    """Vertex view handed to programs: adjacency from the tx + a mutable
    compute-state dict (reference: PreloadedVertex)."""

    __slots__ = ("_v", "_vm")

    def __init__(self, v, vm: VertexMemory):
        self._v = v
        self._vm = vm

    @property
    def id(self):
        return self._v.id

    def label(self):
        return self._v.label()

    def value(self, key, default=None):
        return self._v.value(key, default)

    def edges(self, direction, *labels):
        return self._v.edges(direction, *labels)

    def vertices(self, direction, *labels):
        return self._v.vertices(direction, *labels)

    def out(self, *labels):
        return self._v.out(*labels)

    def in_(self, *labels):
        return self._v.in_(*labels)

    def both(self, *labels):
        return self._v.both(*labels)

    def degree(self, direction, *labels):
        return self._v.degree(direction, *labels)

    # compute-scoped state
    def set_state(self, key, value):
        self._vm.get_state(self._v.id)[key] = value

    def get_state(self, key, default=None):
        return self._vm.get_state(self._v.id).get(key, default)


class HostComputerResult:
    def __init__(self, memory: Memory, states: dict, iterations: int):
        self.memory = memory
        self.states = states
        self.iterations = iterations

    def state_of(self, vid: int) -> dict:
        return self.states.get(vid, {})


class HostGraphComputer:
    def __init__(self, graph, num_threads: int = 0):
        self.graph = graph
        import os
        self.num_threads = num_threads or min(32, (os.cpu_count() or 4))

    def run_async(self, program: VertexProgram, scheduler,
                  max_iterations: int = 100, write_back: bool = False,
                  map_reduces: Optional[list] = None):
        """Delegate a host BSP run to the serving scheduler: the job
        queues behind (and shares admission with) the device jobs, and its
        result is this computer's HostComputerResult. Returns the Job
        handle immediately."""
        from titan_tpu_torch.olap.api import JobSpec

        def _run():
            return self.run(program, max_iterations=max_iterations,
                            write_back=write_back,
                            map_reduces=map_reduces)
        return scheduler.submit(JobSpec(kind="callable",
                                        params={"fn": _run}))

    def run(self, program: VertexProgram, max_iterations: int = 100,
            write_back: bool = False,
            map_reduces: Optional[list] = None, *,
            checkpoint=None, checkpoint_every: int = 0,
            resume: Optional[dict] = None) -> HostComputerResult:
        """Run a host BSP program; optionally through the checkpoint
        plane (olap/recovery): ``checkpoint(iteration, payload)`` fires
        every ``checkpoint_every`` completed supersteps with the FULL
        host state (vertex states + pending messages + global memory —
        Python objects; the store persists them as a digest-checked
        pickle payload), and ``resume`` restores such a payload to
        continue the superstep loop. Host programs run per-vertex
        callbacks in a thread pool, so unlike the device kernels the
        continuation is deterministic only if the program's message
        combining is order-independent."""
        # validate BEFORE the expensive BSP loop
        _check_map_reduces(map_reduces, require=MapReduce)
        memory = Memory()
        vm = VertexMemory(program.combiner())
        program.setup(memory)
        iterations = 0
        if resume is not None:
            vm._state = dict(resume["states"])
            vm._incoming = dict(resume["messages"])
            memory._values = dict(resume["memory"])
            iterations = int(resume["iteration"])
        while True:
            memory.iteration = iterations
            tx = self.graph.new_transaction(read_only=True)
            try:
                vertices = [ComputerVertex(v, vm) for v in tx.vertices()]
                with ThreadPoolExecutor(max_workers=self.num_threads) as pool:
                    list(pool.map(
                        lambda cv: program.execute(
                            cv, Messenger(vm, cv.id), memory), vertices))
            finally:
                tx.rollback()
            vm.complete_iteration()
            iterations += 1
            terminated = (program.terminate(memory)
                          or iterations >= max_iterations)
            if (checkpoint is not None and checkpoint_every > 0
                    and not terminated
                    and iterations % checkpoint_every == 0):
                checkpoint(iterations, {"states": vm.all_states(),
                                        "messages": vm._incoming,
                                        "memory": memory._values,
                                        "iteration": iterations})
            if terminated:
                break
        # MapReduce stages over the final vertex states (reference:
        # FulgoraGraphComputer.java:192-246)
        for mr in (map_reduces or ()):
            tx = self.graph.new_transaction(read_only=True)
            try:
                memory.set(mr.memory_key, execute_map_reduce(
                    mr, (ComputerVertex(v, vm) for v in tx.vertices())))
            finally:
                tx.rollback()
        if write_back and program.state_keys:
            self._write_back(program, vm)
        return HostComputerResult(memory, vm.all_states(), iterations)

    def _write_back(self, program: VertexProgram, vm: VertexMemory,
                    batch: int = 5000) -> None:
        """Persist program state as vertex properties in batched txs
        (reference: FulgoraGraphComputer.java:248-305)."""
        items = list(vm.all_states().items())
        for i in range(0, len(items), batch):
            tx = self.graph.new_transaction()
            try:
                for vid, state in items[i:i + batch]:
                    v = tx.vertex(vid)
                    if v is None:
                        continue
                    for key in program.state_keys:
                        if key in state:
                            v.property(key, state[key])
                tx.commit()
            except BaseException:
                tx.rollback()
                raise
