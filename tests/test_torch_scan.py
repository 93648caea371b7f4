"""The port's scan framework against the JAX package's: ``StandardScanner``
over a raw store, the maintenance jobs (``VertexCountJob``,
``GhostVertexRemover``), ``key_splits``, ``ScanJobSpec`` and both split
runners (``InProcessSplitRunner`` on threads, ``DistributedScanRunner`` in
spawned processes over sqlite) with ``distributed_reindex``, each on twin
graphs; counts and id sets exact. A factory under the JAX package or JAX
is refused before anything is imported."""

import importlib
import sys
import threading

import numpy as np
import pytest

from torch_twins import open_twin

ROOT = {"jax": "titan_tpu", "port": "titan_tpu_torch"}
BOTH = ("jax", "port")


def mod(which: str, name: str):
    return importlib.import_module(f"{ROOT[which]}.{name}")


def count_spec(which: str):
    return mod(which, "olap.distributed").ScanJobSpec(
        f"{ROOT[which]}.olap.jobs:make_vertex_count_job")


def populate(g, n_people=40, n_edges=60, seed=11):
    """tests/test_distributed.py's graph: persons and random knows edges."""
    tx = g.new_transaction()
    people = [tx.add_vertex("person", name=f"p{i}")
              for i in range(n_people)]
    rng = np.random.default_rng(seed)
    for _ in range(n_edges):
        a, b = rng.integers(0, n_people, 2)
        people[int(a)].add_edge("knows", people[int(b)])
    tx.commit()


def counts(m) -> dict:
    return dict(sorted(m._counts.items()))


# -- the scanner over a raw store -------------------------------------------

class _Counting:
    """tests/test_olap.py's CountingJob, for either package's ScanJob."""

    @staticmethod
    def make(which, queries):
        base = mod(which, "olap.api").ScanJob

        class Counting(base):
            def __init__(self):
                self.rows, self.entries = [], 0
                self._lock = threading.Lock()

            def get_queries(self):
                return queries

            def process(self, key, entries_by_query, metrics):
                with self._lock:
                    self.rows.append(key)
                    self.entries += sum(len(v) for v in
                                        entries_by_query.values())
        return Counting()


@pytest.mark.parametrize("threads", [1, 4])
def test_scanner_executes_a_job_over_a_store(threads):
    got = {}
    for which in BOTH:
        api = mod(which, "storage.api")
        m = mod(which, "storage.inmemory").InMemoryStoreManager()
        store = m.open_database("edgestore")
        t = m.begin_transaction()
        for i in range(100):
            cols = [api.Entry(bytes([c]), b"v") for c in range(i % 5 + 1)]
            store.mutate(i.to_bytes(8, "big"), cols, [], t)
        t.commit()
        scanner = mod(which, "storage.scan").StandardScanner(store, m)
        job = _Counting.make(which, [api.SliceQuery(b"\x00", b"\x05")])
        metrics = scanner.execute(job, num_threads=threads)
        job2 = _Counting.make(which, [api.SliceQuery(b"\x03", b"\x05"),
                                      api.SliceQuery(b"\x00", None)])
        scanner.execute(job2, num_threads=threads, block_size=7)
        job3 = _Counting.make(which, [api.SliceQuery()])
        scanner.execute(job3, num_threads=threads, key_range=(
            (10).to_bytes(8, "big"), (20).to_bytes(8, "big")))
        got[which] = (sorted(job.rows), job.entries, counts(metrics),
                      sorted(job2.rows), job2.entries, sorted(job3.rows))
    assert got["port"] == got["jax"]
    assert len(got["port"][0]) == 100 and len(got["port"][3]) == 40
    assert got["port"][5] == [i.to_bytes(8, "big") for i in range(10, 20)]


def test_scanner_refuses_a_job_without_queries():
    for which in BOTH:
        m = mod(which, "storage.inmemory").InMemoryStoreManager()
        store = m.open_database("edgestore")
        scanner = mod(which, "storage.scan").StandardScanner(store, m)
        with pytest.raises(ValueError, match="no queries"):
            scanner.execute(_Counting.make(which, []))


# -- the maintenance jobs ----------------------------------------------------

def test_vertex_count_job_equals_jax():
    got = {}
    for which in BOTH:
        g = open_twin(which)
        populate(g)
        b = g.backend
        jobs = mod(which, "olap.jobs")
        m = mod(which, "storage.scan").StandardScanner(
            b.edge_store.store, b.manager).execute(
            jobs.VertexCountJob(g), graph=g)
        got[which] = counts(m)
        g.close()
    assert got["port"] == got["jax"]
    assert got["port"]["vertex-count"] == 40
    assert got["port"]["edge-count"] == 60


def test_ghost_vertex_removal_equals_jax():
    got = {}
    for which in BOTH:
        api = mod(which, "storage.api")
        g = open_twin(which)
        tx = g.new_transaction()
        a = tx.add_vertex(name="alive")
        ghosts = [tx.add_vertex(name=f"ghost{i}") for i in range(3)]
        for gh in ghosts:
            a.add_edge("knows", gh)
        tx.commit()
        [q] = g.codec.query_type(g.schema.system.vertex_exists,
                                 mod(which, "core.defs").Direction.OUT,
                                 g.schema)
        txh = g.backend.manager.begin_transaction()
        for gh in ghosts[:2]:         # the existence marker gone
            key = g.idm.key_bytes(gh.id)
            entries = g.backend.edge_store.store.get_slice(
                api.KeySliceQuery(key, q), txh)
            g.backend.edge_store.store.mutate(
                key, [], [e.column for e in entries], txh)
            g.backend.edge_store.invalidate(key)
        txh.commit()
        removed = mod(which, "olap.jobs").remove_ghost_vertices(g)
        tx = g.new_transaction()
        alive = sorted(v.id for v in tx.vertices())
        tx.rollback()
        txh = g.backend.manager.begin_transaction()
        left = [len(g.backend.edge_store.store.get_slice(api.KeySliceQuery(
            g.idm.key_bytes(gh.id), api.SliceQuery()), txh))
            for gh in ghosts]
        txh.commit()
        got[which] = (removed, alive, left)
        g.close()
    assert got["port"] == got["jax"]
    assert got["port"][0] == 2 and got["port"][2][:2] == [0, 0]


# -- splits and specs ----------------------------------------------------------

@pytest.mark.parametrize("bits", [0, 3, 5])
def test_key_splits_equal_jax(bits):
    splits = {}
    for which in BOTH:
        idm = mod(which, "ids.idmanager").IDManager(partition_bits=bits)
        splits[which] = [mod(which, "olap.distributed").key_splits(idm, n)
                         for n in (1, 3, 4, 32, 64)]
    assert splits["port"] == splits["jax"]
    n_parts = 1 << bits
    for got in splits["port"]:
        for (_, e1), (s2, _) in zip(got, got[1:]):
            assert e1 == s2
        assert got[0][0] == (0).to_bytes(8, "big")
        assert got[-1][1] == (n_parts << (63 - bits)).to_bytes(8, "big")


def test_spec_builds_the_ports_factories():
    from titan_tpu_torch.indexing.jobs import IndexRepairJob
    from titan_tpu_torch.olap.distributed import ScanJobSpec
    from titan_tpu_torch.olap.jobs import VertexCountJob
    g = open_twin("port")
    try:
        m = g.management()
        m.make_property_key("name", str)
        m.build_index("byName", "vertex").add_key("name") \
            .build_composite_index()
        m.commit()
        assert isinstance(count_spec("port").build(g), VertexCountJob)
        job = ScanJobSpec("titan_tpu_torch.olap.distributed:make_repair_job",
                          {"index_name": "byName"}).build(g)
        assert isinstance(job, IndexRepairJob)
        with pytest.raises(ValueError, match="module:callable"):
            ScanJobSpec("no-colon").build(g)
        with pytest.raises(ValueError, match="unknown index"):
            ScanJobSpec("titan_tpu_torch.olap.distributed:make_repair_job",
                        {"index_name": "nope"}).build(g)
    finally:
        g.close()


@pytest.mark.parametrize("factory", [
    "titan_tpu.olap.jobs:make_vertex_count_job",
    "titan_tpu.no_such_module:nope", "jax:numpy", "jaxlib.x:y"])
def test_spec_refuses_a_jax_factory_before_importing_it(factory):
    """A JAX coordinator's spec fails as the job's fault: a ValueError
    naming the package, raised before any import (a module that does not
    exist would otherwise raise ModuleNotFoundError)."""
    from titan_tpu_torch.olap.distributed import ScanJobSpec
    before = set(sys.modules)
    g = open_twin("port")
    try:
        with pytest.raises(ValueError, match="never imports"):
            ScanJobSpec(factory).build(g)
    finally:
        g.close()
    assert "titan_tpu.no_such_module" not in sys.modules
    assert {m for m in set(sys.modules) - before
            if m.split(".")[0] in ("jax", "jaxlib", "titan_tpu")} == set()


# -- the split runners ---------------------------------------------------------

@pytest.mark.parametrize("workers", [1, 4, 32])
def test_in_process_split_runner_matches_full_scan(workers):
    got = {}
    for which in BOTH:
        g = open_twin(which)
        populate(g)
        runner = mod(which, "olap.distributed").InProcessSplitRunner(
            g, num_workers=workers)
        got[which] = counts(runner.run(count_spec(which)))
        with pytest.raises(TypeError, match="ScanJobSpec"):
            runner.run(mod(which, "olap.jobs").VertexCountJob(g))
        g.close()
    assert got["port"] == got["jax"]
    assert got["port"]["vertex-count"] == 40
    assert got["port"]["edge-count"] == 60


def _sqlite(tmp_path, which, name="db"):
    return {"storage.backend": "sqlite",
            "storage.directory": str(tmp_path / which / name)}


def test_distributed_runner_processes(tmp_path):
    """Two spawned split processes over a sqlite graph in each package:
    the same counts as the in-process runner and as each other."""
    got = {}
    for which in BOTH:
        cfg = _sqlite(tmp_path, which)
        g = open_twin(which, config=dict(cfg))
        populate(g)
        g.close()
        dist = mod(which, "olap.distributed")
        m = dist.DistributedScanRunner(cfg, num_workers=2,
                                       threads_per_worker=1).run(
            count_spec(which))
        g2 = importlib.import_module(ROOT[which]).open(dict(cfg))
        m2 = dist.InProcessSplitRunner(g2, num_workers=2).run(
            count_spec(which))
        g2.close()
        got[which] = (counts(m), counts(m2))
    assert got["port"] == got["jax"]
    assert got["port"][0]["vertex-count"] == 40 == \
        got["port"][1]["vertex-count"]
    assert got["port"][0]["edge-count"] == 60


def test_distributed_reindex(tmp_path):
    """A composite index built after the data: REGISTER, REINDEX in two
    spawned processes, ENABLE; the same entries and query answers in
    both packages."""
    got = {}
    for which in BOTH:
        cfg = _sqlite(tmp_path, which)
        g = open_twin(which, config=dict(cfg))
        populate(g, n_people=25, n_edges=0)
        mgmt = g.management()
        mgmt.build_index("byNameDist", "vertex").add_key(
            g.schema.get_by_name("name")).build_composite_index()
        mgmt.update_index("byNameDist", "register")
        g.close()
        m = mod(which, "olap.distributed").distributed_reindex(
            cfg, "byNameDist", num_workers=2)
        g2 = importlib.import_module(ROOT[which]).open(dict(cfg))
        g2.management().update_index("byNameDist", "enable")
        tx = g2.new_transaction()
        hits = [(v.id, v.value("name"))
                for v in tx.query().has("name", "p7").vertices()]
        tx.commit()
        g2.close()
        got[which] = (counts(m), hits)
    assert got["port"] == got["jax"]
    assert got["port"][0]["index-entries-added"] == 25
    assert [n for _, n in got["port"][1]] == ["p7"]
