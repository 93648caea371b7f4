"""The port's host graph computer (``titan_tpu_torch/olap/computer.py``,
``g.compute(backend="host")``) against the JAX package's: message passing
with a combiner, classic MapReduce stages, state written back to the
graph, checkpoint and resume, and ``run_async`` through each package's
scheduler, on twin graphs; vertex states, memories and iteration counts
exact."""

import importlib

import numpy as np
import pytest

from torch_twins import gods, open_twin

ROOT = {"jax": "titan_tpu", "port": "titan_tpu_torch"}
BOTH = ("jax", "port")


def mod(which: str, name: str):
    return importlib.import_module(f"{ROOT[which]}.{name}")


def programs(which):
    """tests/test_olap.py's in-degree program, tests/test_mapreduce.py's
    MaxInDegree stage and tests/test_recovery.py's counter, for either
    package's contracts."""
    api = mod(which, "olap.api")
    Direction = mod(which, "core.defs").Direction

    class InDegree(api.VertexProgram):
        def execute(self, vertex, messenger, memory):
            if memory.iteration == 0:
                messenger.send(1, [n.id for n in vertex.out()])
            else:
                vertex.set_state("indeg", sum(messenger.receive()))

        def terminate(self, memory):
            return memory.iteration >= 1

        def combiner(self):
            return lambda a, b: a + b

        @property
        def state_keys(self):
            return ("indeg",)

    class Lists(InDegree):
        """The same without a combiner: every message is kept."""

        def combiner(self):
            return None

        def execute(self, vertex, messenger, memory):
            if memory.iteration == 0:
                messenger.send(vertex.id, [n.id for n in vertex.out()])
            else:
                vertex.set_state("from", sorted(messenger.receive()))
                memory.add("received", len(messenger.receive()))

    class MaxInDegree(api.MapReduce):
        memory_key = "maxInDeg"

        def map(self, vertex, emitter):
            emitter.emit("max", vertex.get_state("indeg", 0))

        def reduce(self, key, values, emitter):
            emitter.emit(key, max(values))

        def finalize(self, results):
            return results["max"][0]

    class Histogram(api.MapReduce):
        memory_key = "hist"

        def map(self, vertex, emitter):
            emitter.emit(vertex.get_state("indeg", 0), 1)

        def combine(self, key, values, emitter):
            emitter.emit(key, sum(values))

        def reduce(self, key, values, emitter):
            emitter.emit(key, sum(values))

        def finalize(self, results):
            return sorted((k, v[0]) for k, v in results.items())

    class Count(api.VertexProgram):
        def execute(self, vertex, messenger, memory):
            vertex.set_state("n", vertex.get_state("n", 0) + 1)

        def terminate(self, memory):
            return memory.iteration >= 4

    class OutDegree(api.VertexProgram):
        def execute(self, vertex, messenger, memory):
            vertex.set_state("deg", vertex.degree(Direction.OUT))

        def terminate(self, memory):
            return True

    return InDegree, Lists, MaxInDegree, Histogram, Count, OutDegree


def test_the_degree_program_on_the_gods():
    got = {}
    for which in BOTH:
        g = gods(which)
        try:
            InDegree = programs(which)[0]
            comp = g.compute("host")
            assert type(comp).__name__ == "HostGraphComputer"
            res = comp.run(InDegree(), max_iterations=5)
            tx = g.new_transaction()
            names = {v.id: v.value("name") for v in tx.vertices()}
            tx.rollback()
            got[which] = (res.iterations, sorted(
                (names[vid], st.get("indeg")) for vid, st in
                res.states.items()))
        finally:
            g.close()
    assert got["port"] == got["jax"]
    indeg = dict(got["port"][1])
    assert got["port"][0] == 2
    assert (indeg["jupiter"], indeg["cerberus"], indeg["saturn"]) == (3, 2, 1)


@pytest.mark.parametrize("threads", [1, 4])
def test_messages_without_a_combiner_and_memory(threads):
    got = {}
    for which in BOTH:
        g = gods(which)
        try:
            Lists = programs(which)[1]
            comp = mod(which, "olap.computer").HostGraphComputer(
                g, num_threads=threads)
            res = comp.run(Lists())
            got[which] = (res.iterations, res.memory.get("received"),
                          sorted((vid, tuple(st.get("from", ())))
                                 for vid, st in res.states.items()))
        finally:
            g.close()
    assert got["port"] == got["jax"]
    assert got["port"][1] == 17          # one message an edge


def test_map_reduce_stages():
    got = {}
    for which in BOTH:
        g = gods(which)
        try:
            InDegree, _, MaxInDegree, Histogram = programs(which)[:4]
            res = g.compute("host").run(
                InDegree(), map_reduces=[MaxInDegree(), Histogram()])
            got[which] = (res.memory.get("maxInDeg"), res.memory.get("hist"),
                          sorted(res.memory.keys()))
            api = mod(which, "olap.api")
            errors = []

            class Same(api.MapReduce):
                memory_key = "maxInDeg"

                def map(self, vertex, emitter):
                    pass
            for stages in ([MaxInDegree(), Same()], [object()]):
                with pytest.raises((ValueError, TypeError)) as exc:
                    g.compute("host").run(InDegree(), map_reduces=stages)
                errors.append(type(exc.value).__name__)
            got[which] += (errors,)
        finally:
            g.close()
    assert got["port"] == got["jax"]
    assert got["port"][0] == 3 and got["port"][3] == ["ValueError",
                                                       "TypeError"]


def test_write_back_persists_the_state():
    got = {}
    for which in BOTH:
        g = gods(which)
        try:
            InDegree = programs(which)[0]
            g.compute("host").run(InDegree(), write_back=True)
            tx = g.new_transaction()
            got[which] = sorted((v.value("name"), v.value("indeg"))
                                for v in tx.vertices())
            tx.rollback()
        finally:
            g.close()
    assert got["port"] == got["jax"]
    assert dict(got["port"])["jupiter"] == 3


def test_checkpoint_and_resume():
    got = {}
    for which in BOTH:
        g = open_twin(which)
        try:
            tx = g.new_transaction()
            for i in range(4):
                tx.add_vertex("node", name=f"v{i}")
            tx.commit()
            Count = programs(which)[4]
            comp = mod(which, "olap.computer").HostGraphComputer(
                g, num_threads=1)
            caps = {}
            ref = comp.run(Count(), checkpoint_every=2,
                           checkpoint=lambda it, p: caps.__setitem__(it, p))
            again = comp.run(Count(), resume=caps[2])
            assert again.iterations == ref.iterations
            assert again.states == ref.states
            got[which] = (ref.iterations, sorted(caps),
                          sorted(ref.states.items()), caps[2]["iteration"])
        finally:
            g.close()
    assert got["port"] == got["jax"]
    assert got["port"][:2] == (5, [2, 4])


def test_run_async_through_the_scheduler():
    """``run_async`` queues the run as a ``callable`` job behind each
    package's scheduler; the results equal."""
    got = {}
    for which in BOTH:
        g = open_twin(which)
        try:
            tx = g.new_transaction()
            vs = [tx.add_vertex("node", name=f"v{i}") for i in range(6)]
            for a, b in [(0, 1), (1, 2), (2, 3), (0, 3), (4, 5)]:
                vs[a].add_edge("link", vs[b])
            tx.commit()
            snap = mod(which, "olap.tpu.snapshot" if which == "jax"
                       else "olap.snapshot").build(g)
            sched_mod = mod(which, "olap.serving")
            kw = {"device": "cpu"} if which == "port" else {}
            sched = sched_mod.JobScheduler(snapshot=snap, **kw)
            try:
                OutDegree = programs(which)[5]
                job = mod(which, "olap.computer").HostGraphComputer(
                    g, num_threads=2).run_async(OutDegree(), sched)
                assert job.wait(60) and job.state.value == "done", job.error
                res = job.result["value"]
                got[which] = (job.spec.kind, sorted(
                    (vid, st["deg"]) for vid, st in res.states.items()))
            finally:
                sched.close()
        finally:
            g.close()
    assert got["port"] == got["jax"]
    assert got["port"][0] == "callable"
    assert [d for _, d in got["port"][1]] == [2, 1, 1, 0, 1, 0]


def test_the_default_stays_the_gpu_computer_and_tpu_stays_refused():
    import titan_tpu_torch
    g = titan_tpu_torch.open("inmemory")
    try:
        assert type(g.compute(device="cpu")).__name__ == "GPUGraphComputer"
        assert g.compute("host", num_threads=3).num_threads == 3
        with pytest.raises(NotImplementedError, match="item 11"):
            g.compute("tpu")
        with pytest.raises(ValueError, match="unknown computer"):
            g.compute("nope")
    finally:
        g.close()


def test_the_host_computer_equals_the_engine_s_in_degrees():
    """The host computer's in-degrees on a seeded graph equal the directed
    snapshot's, counted on the host in numpy (on the card the smoke's
    phase 17d counts them there)."""
    import titan_tpu_torch
    from titan_tpu_torch.olap import snapshot as SN
    g = titan_tpu_torch.open("inmemory")
    try:
        tx = g.new_transaction()
        vs = [tx.add_vertex("node") for _ in range(50)]
        rng = np.random.default_rng(42)
        for _ in range(300):
            a, b = rng.integers(0, 50, 2)
            tx.add_edge(vs[int(a)], "link", vs[int(b)])
        tx.commit()
        res = g.compute(backend="host").run(programs("port")[0]())
        snap = SN.build(g, directed=True)
        got = [res.state_of(int(v)).get("indeg", 0)
               for v in snap.vertex_ids]
        assert got == np.bincount(snap.dst, minlength=snap.n).tolist()
    finally:
        g.close()
