"""The port stands alone: no module of titan_tpu_torch, and neither
chip_smoke.py nor the port's scripts (scripts/torch_*.py), imports jax or
anything of the JAX package titan_tpu, of the TPU probes under
experiments/ or of the tests' tree (the lint fixtures among it)."""

import ast
import pathlib
import subprocess
import sys
import textwrap

import pytest
import torch

from titan_tpu_torch.device import next_pow2, resolve_device

ROOT = pathlib.Path(__file__).resolve().parent.parent
FILES = sorted((ROOT / "titan_tpu_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py"] + sorted((ROOT / "scripts").glob("torch_*.py"))


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "titan_tpu", "experiments", "tests")


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_the_port_scripts_are_scanned():
    names = {p.name for p in FILES}
    assert {"torch_bfs_breakdown.py", "torch_engine_breakdown.py",
            "seg_scan.py", "engine.py", "overlay.py"} <= names
    assert ROOT / "titan_tpu_torch" / "olap" / "live" / "__init__.py" \
        in FILES


SERVING = [("olap", "serving", m) for m in (
    "__init__", "autotune", "batcher", "hbm", "jobs", "pool", "scheduler",
    "tenants")] + [("olap", "serving", "interactive", m) for m in (
        "__init__", "collector", "compile", "scheduler")] + [
    ("olap", "live", m) for m in ("__init__", "compactor", "feed",
                                  "overlay", "plane")] + [
    ("ops", "epoch_merge")] + [("obs", m) for m in (
        "__init__", "devprof", "flightrec", "slo", "tracing")] + [
    ("utils", "__init__"), ("utils", "metrics")]


def test_the_serving_obs_and_utils_modules_are_scanned():
    for parts in SERVING:
        path = ROOT.joinpath("titan_tpu_torch", *parts[:-1],
                             parts[-1] + ".py")
        assert path in FILES, path


def test_importing_the_serving_layer_loads_no_jax():
    """At run time too: importing the serving layer, its interactive lane,
    the live plane (feed, plane, compactor, epoch merge), the
    observability plane and the metrics registry in a fresh interpreter,
    and serving a job over a live plane, loads no module of jax or
    titan_tpu (imports inside functions included, since the scheduler,
    the lane and the plane's pump run some on their workers)."""
    code = (
        "import sys\n"
        "import titan_tpu_torch.olap.serving as S\n"
        "import titan_tpu_torch.olap.serving.autotune, "
        "titan_tpu_torch.obs.devprof, titan_tpu_torch.obs.flightrec\n"
        "import titan_tpu_torch.olap.serving.interactive.collector, "
        "titan_tpu_torch.olap.serving.interactive.compile, "
        "titan_tpu_torch.olap.serving.interactive.scheduler\n"
        "import titan_tpu_torch.olap.live.compactor, "
        "titan_tpu_torch.olap.live.feed, titan_tpu_torch.olap.live.plane, "
        "titan_tpu_torch.ops.epoch_merge\n"
        "import titan_tpu_torch.utils.metrics\n"
        "import numpy as np\n"
        "from titan_tpu_torch.olap import snapshot as SN\n"
        "from titan_tpu_torch.olap.api import JobSpec\n"
        "s = S.JobScheduler(snapshot=SN.from_arrays(4, [0, 1], [1, 0]),\n"
        "                   device='cpu', hbm_budget_bytes=1e9)\n"
        "j = s.submit(JobSpec(kind='bfs', params={'source_dense': 0}))\n"
        "assert j.wait(60) and j.state.value == 'done', j.error\n"
        "from titan_tpu_torch.olap.serving.interactive import "
        "plan_from_wire\n"
        "r = s.interactive().submit(plan_from_wire({'start': [0], "
        "'hops': 2, 'terminal': 'count'}))\n"
        "assert r['result'] == 1, r\n"
        "s.close()\n"
        "import titan_tpu_torch\n"
        "from titan_tpu_torch.olap.live import LiveGraphPlane\n"
        "g = titan_tpu_torch.open('inmemory')\n"
        "tx = g.new_transaction()\n"
        "a, b, c = (tx.add_vertex('node') for _ in range(3))\n"
        "a.add_edge('link', b)\n"
        "tx.commit()\n"
        "p = LiveGraphPlane(g, device='cpu', poll_interval_s=0.01)\n"
        "s = S.JobScheduler(live=p, device='cpu', hbm_budget_bytes=1e9)\n"
        "tx = g.new_transaction()\n"
        "tx.vertex(b.id).add_edge('link', tx.vertex(c.id))\n"
        "tx.commit()\n"
        "j = s.submit(JobSpec(kind='bfs', params={'source': a.id}))\n"
        "assert j.wait(60) and j.result['reached'] == 3, j.error\n"
        "s.close()\n"
        "g.close()\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'titan_tpu'))\n"
        "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


#: the OLTP spine and the store-to-card path, the port's own copies
SPINE = [("errors",), ("factory",), ("utils", "times"), ("utils", "varint"),
         ("native", "__init__"), ("olap", "__init__"), ("olap", "bulk"),
         ("olap", "snapshot"), ("indexing", "serializer")] + [
    ("config", m) for m in ("__init__", "configuration", "defaults",
                            "options")] + [
    ("codec", m) for m in ("__init__", "dataio", "relation_ids",
                           "attributes", "edges")] + [
    ("ids", m) for m in ("__init__", "idmanager", "assigner", "authority",
                         "placement", "pool")] + [
    ("storage", m) for m in ("__init__", "api", "inmemory", "sqlitekv",
                             "cache", "config_store", "locking", "log",
                             "tx", "backend", "registry")] + [
    ("core", m) for m in ("__init__", "defs", "attribute", "system_types",
                          "schema", "elements", "relations", "tx",
                          "changes", "wal", "management", "graph")]


def test_the_graph_spine_is_scanned():
    for parts in SPINE:
        path = ROOT.joinpath("titan_tpu_torch", *parts[:-1],
                             parts[-1] + ".py")
        assert path in FILES, path


#: the queries, the traversal dsl with its compiled path, and the gods
TRAVERSAL = [("query", m) for m in ("__init__", "predicates", "profile",
                                    "graphquery", "vertexquery")] + [
    ("traversal", m) for m in ("__init__", "dsl", "olap_compile")] + [
    ("example",)]


def test_the_queries_and_traversals_are_scanned():
    for parts in TRAVERSAL:
        path = ROOT.joinpath("titan_tpu_torch", *parts[:-1],
                             parts[-1] + ".py")
        assert path in FILES, path


def test_a_traversal_run_loads_no_jax():
    """In a fresh interpreter: the gods, a query, a vertex query, an
    interpreted and a compiled traversal on the CPU, and a port traversal
    through the interactive lane load no module of jax or titan_tpu."""
    code = (
        "import sys\n"
        "import titan_tpu_torch\n"
        "from titan_tpu_torch import example\n"
        "from titan_tpu_torch.olap import snapshot\n"
        "from titan_tpu_torch.olap.serving import JobScheduler\n"
        "from titan_tpu_torch.olap.serving.interactive import "
        "compile_traversal\n"
        "from titan_tpu_torch.traversal.dsl import anon\n"
        "g = titan_tpu_torch.open('inmemory')\n"
        "example.load(g)\n"
        "assert len(g.query().has('name', 'pluto').vertices()) == 1\n"
        "h = g.traversal().V().has('name', 'hercules').next()\n"
        "assert h.query().labels('battled').count() == 3\n"
        "t = g.traversal().V().repeat(anon().out()).times(2).count()\n"
        "c = g.traversal().with_computer('gpu', device='cpu')\n"
        "ct = c.V().repeat(anon().out()).times(2).count()\n"
        "assert t.to_list() == ct.to_list() and ct.profile().compiled\n"
        "s = JobScheduler(snapshot=snapshot.build(g, directed=False),\n"
        "                 device='cpu', hbm_budget_bytes=1e9)\n"
        "plan = compile_traversal(g.traversal().V(h.id).out().out()"
        ".dedup().count())\n"
        "assert s.interactive().submit(plan)['result'] > 0\n"
        "s.close()\n"
        "g.close()\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'titan_tpu'))\n"
        "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_a_graph_run_loads_no_jax():
    """In a fresh interpreter: open("inmemory"), a bulk load, a snapshot
    build and one compute() on the CPU, then a sqlite graph with its WAL
    and a change-log processor, load no module of jax or titan_tpu."""
    code = (
        "import sys\n"
        "import numpy as np\n"
        "import titan_tpu_torch\n"
        "from titan_tpu_torch.olap import bulk, snapshot\n"
        "from titan_tpu_torch.models import pagerank\n"
        "g = titan_tpu_torch.open('inmemory')\n"
        "src = np.arange(32); dst = (src * 7 + 1) % 32\n"
        "bulk.bulk_load_adjacency(g, src, dst, n=32)\n"
        "snap = snapshot.build(g, directed=False)\n"
        "assert snap.n == 32 and snap.num_edges == 64\n"
        "r = pagerank.run(g.compute(device='cpu'))\n"
        "assert r.iterations == 20 and abs(r['rank'].sum() - 1) < 1e-4\n"
        "g.close()\n"
        "import tempfile, time\n"
        "d = tempfile.mkdtemp()\n"
        "g = titan_tpu_torch.open({'storage.backend': 'sqlite',\n"
        "                          'storage.directory': d,\n"
        "                          'tx.log-tx': True})\n"
        "seen = []\n"
        "titan_tpu_torch.open_log_processors(g).add_log_processor('x')"
        ".set_start_time(0).add_processor(\n"
        "    lambda gr, txid, st: seen.append(txid)).build()\n"
        "tx = g.new_transaction(log_identifier='x')\n"
        "tx.add_vertex('node')\n"
        "tx.commit()\n"
        "t0 = time.time()\n"
        "while not seen and time.time() - t0 < 30:\n"
        "    time.sleep(0.02)\n"
        "assert len(seen) == 1, seen\n"
        "g.close()\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'titan_tpu'))\n"
        "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_guard_sees_the_prefix_correctly():
    assert _forbidden("titan_tpu.native") and _forbidden("jax.numpy")
    assert _forbidden("experiments.probe2_rates")
    assert _forbidden("tests.fixtures.graftlint.titan_tpu.models.pallas_ok")
    assert not _forbidden("titan_tpu_torch.ops.frontier")
    assert not _forbidden("titan_tpu_torch.ops.window_sum")


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.name)
def test_no_jax_or_titan_tpu_imports(path):
    bad = [m for m in _imports(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_device_none_means_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def test_next_pow2_matches_the_jax_package_rule():
    assert [next_pow2(x) for x in (0, 1, 2, 3, 4, 5, 1023, 1024)] == \
        [2, 2, 2, 4, 4, 8, 1024, 1024]


#: the front door: the HTTP server, its wire plumbing, the exposition and
#: federation, the remote store and the replica fleet
FRONT_DOOR = [("server",), ("utils", "httpnode"), ("obs", "promexport"),
              ("obs", "federate"), ("storage", "remote")] + [
    ("olap", "fleet", m) for m in ("__init__", "membership", "router",
                                   "replica")]


def test_the_front_door_is_scanned():
    for parts in FRONT_DOOR:
        path = ROOT.joinpath("titan_tpu_torch", *parts[:-1],
                             parts[-1] + ".py")
        assert path in FILES, path


def test_serving_over_http_loads_no_jax():
    """A job and a scrape over HTTP, a graph over a storage node and a
    router over one replica, in a fresh interpreter: nothing of jax or
    titan_tpu is loaded (the handlers import inside functions)."""
    code = (
        "import sys, json, time\n"
        "import titan_tpu_torch\n"
        "from titan_tpu_torch.server import GraphServer\n"
        "from titan_tpu_torch.storage.inmemory import "
        "InMemoryStoreManager\n"
        "from titan_tpu_torch.storage.remote import KCVSServer\n"
        "from titan_tpu_torch.olap.fleet import FleetRouter\n"
        "from titan_tpu_torch.utils.httpnode import json_call, text_get\n"
        "node = KCVSServer(InMemoryStoreManager()).start()\n"
        "g = titan_tpu_torch.open({'storage.backend': 'remote',\n"
        "    'storage.hostname': '127.0.0.1', 'storage.port': node.port,\n"
        "    'storage.lock.wait-time': 5, 'ids.authority.wait-time': 5})\n"
        "tx = g.new_transaction()\n"
        "a, b = tx.add_vertex('node'), tx.add_vertex('node')\n"
        "a.add_edge('link', b)\n"
        "tx.commit()\n"
        "srv = GraphServer(g, port=0, device='cpu').start()\n"
        "url = f'http://{srv.host}:{srv.port}'\n"
        "r = FleetRouter([url], autotune='off', autopump=False).start()\n"
        "j = json_call(r.url, '/jobs', {'kind': 'bfs', 'source': a.id})\n"
        "for _ in range(500):\n"
        "    r.pump()\n"
        "    w = json.loads(text_get(r.url, '/jobs/' + j['job']))\n"
        "    if w['state'] == 'done': break\n"
        "    time.sleep(0.02)\n"
        "assert w['remote']['result']['reached'] == 2, w\n"
        "assert 'serving_jobs_completed' in text_get(url, '/metrics')\n"
        "assert 'instance=' in text_get(r.url, '/metrics?federate=1')\n"
        "r.stop(); srv.stop(); g.close(); node.stop()\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'titan_tpu'))\n"
        "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


#: the scan cluster and the mixed indexes, with the host computer
SCAN_AND_INDEX = [("storage", "cluster"), ("storage", "scan")] + [
    ("olap", m) for m in ("api", "jobs", "distributed", "scan_worker",
                          "computer")] + [
    ("indexing", m) for m in ("__init__", "provider", "memindex",
                              "ftsindex", "jobs", "remote")]


def test_the_scan_cluster_and_indexes_are_scanned():
    for parts in SCAN_AND_INDEX:
        path = ROOT.joinpath("titan_tpu_torch", *parts[:-1],
                             parts[-1] + ".py")
        assert path in FILES, path


def test_scans_indexes_and_the_host_computer_load_no_jax():
    """What the AST scan cannot see, at run time in a fresh interpreter:
    the factories a scan imports by name, two spawned split processes, a
    scan worker's job over a remote-cluster ring, REINDEX over it, the
    three index providers opened by name (memindex, lucene, remote-index)
    and the host computer load no module of jax or titan_tpu; a factory
    or an index backend under the JAX package is refused before import."""
    code = textwrap.dedent("""
        import os, sys, tempfile
        import titan_tpu_torch
        from titan_tpu_torch.indexing.memindex import MemoryIndex
        from titan_tpu_torch.indexing.remote import IndexServer
        from titan_tpu_torch.olap.api import VertexProgram
        from titan_tpu_torch.olap.distributed import (DistributedScanRunner,
                                                      ScanJobSpec)
        from titan_tpu_torch.olap.scan_worker import (
            RemoteScanRunner, ScanWorkerServer, distributed_reindex_remote)
        from titan_tpu_torch.storage.inmemory import InMemoryStoreManager
        from titan_tpu_torch.storage.remote import KCVSServer

        class Ones(VertexProgram):
            def execute(self, vertex, messenger, memory):
                vertex.set_state("one", 1)

            def terminate(self, memory):
                return True

        d = tempfile.mkdtemp()
        spec = ScanJobSpec("titan_tpu_torch.olap.jobs:make_vertex_count_job")
        scfg = {"storage.backend": "sqlite",
                "storage.directory": os.path.join(d, "db")}
        g = titan_tpu_torch.open(scfg)
        tx = g.new_transaction()
        a, b = tx.add_vertex("person"), tx.add_vertex("person")
        a.add_edge("knows", b)
        tx.commit()
        g.close()
        m = DistributedScanRunner(scfg, num_workers=2).run(spec)
        assert m.get("vertex-count") == 2, m._counts
        nodes = [KCVSServer(InMemoryStoreManager()).start()
                 for _ in range(2)]
        ws = [ScanWorkerServer().start() for _ in range(2)]
        idx = IndexServer(MemoryIndex("node")).start()
        cfg = {"storage.backend": "remote-cluster",
               "storage.hostname": [f"127.0.0.1:{n.port}" for n in nodes],
               "storage.cluster.replication-factor": 2,
               "index.mem.backend": "memindex",
               "index.mem.directory": os.path.join(d, "mem"),
               "index.fts.backend": "lucene",
               "index.fts.directory": os.path.join(d, "fts"),
               "index.node.backend": "remote-index",
               "index.node.hostname": ["127.0.0.1"],
               "index.node.port": idx.port}
        g = titan_tpu_torch.open(cfg)
        tx = g.new_transaction()
        for i in range(5):
            tx.add_vertex("person", name=f"b{i}")
        tx.commit()
        mg = g.management()
        mg.build_index("byName", "vertex").add_key(
            g.schema.get_by_name("name")).build_mixed_index("fts")
        mg.update_index("byName", "register")
        mg.commit()
        g.close()
        urls = [f"127.0.0.1:{w.port}" for w in ws]
        assert RemoteScanRunner(urls, cfg).run(spec).get(
            "vertex-count") == 5
        m = distributed_reindex_remote(urls, cfg, "byName")
        assert m.get("index-entries-added") == 5, m._counts
        g = titan_tpu_torch.open(cfg)
        g.management().update_index("byName", "enable")
        assert len(g.index_query("byName", "name:b3")) == 1
        assert {type(g.index_provider(n)).__name__
                for n in ("mem", "fts", "node")} == {
            "MemoryIndex", "FTSIndex", "RemoteIndexProvider"}
        res = g.compute(backend="host").run(Ones())
        assert len(res.states) == 5
        g.close()
        for bad in ("titan_tpu.olap.jobs:make_vertex_count_job",
                    "jax.numpy:zeros"):
            try:
                ScanJobSpec(bad).build(None)
            except ValueError as e:
                assert "never imports" in str(e)
            else:
                raise AssertionError(bad)
        try:
            titan_tpu_torch.open({
                "storage.backend": "inmemory",
                "index.x.backend": "titan_tpu.indexing.memindex.MemoryIndex"})
        except ValueError as e:
            assert "never imports" in str(e)
        else:
            raise AssertionError("a JAX index backend opened")
        for n in ws + nodes + [idx]:
            n.stop()
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "titan_tpu"))
        print(bad)
        """)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=180)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


SLICE_17 = [("models", "bfs"), ("models", "bfs_hybrid_fused"),
            ("storage", "gdbmkv"), ("io",), ("deploy",),
            ("config", "docgen"), ("utils", "metrics")]


def test_the_bfs_variants_and_the_oltp_remainder_are_scanned():
    for parts in SLICE_17:
        path = ROOT.joinpath("titan_tpu_torch", *parts[:-1],
                             parts[-1] + ".py")
        assert path in FILES, path


def test_the_bfs_variants_and_the_oltp_remainder_load_no_jax():
    """At run time: the fused BFS's plain version, the push-frontier BFS
    (plain and tiled), a metered gdbm graph with a CSV reporter written
    to graphbin and GraphSON and read back, docgen and deploy's status
    load no module of jax or titan_tpu."""
    code = textwrap.dedent("""\
        import os, sys, tempfile
        import numpy as np
        import titan_tpu_torch
        from titan_tpu_torch import deploy, io as tio
        from titan_tpu_torch.config.docgen import render
        from titan_tpu_torch.models import bfs as B
        from titan_tpu_torch.models import bfs_hybrid_fused as F
        from titan_tpu_torch.olap import snapshot as SN
        rng = np.random.default_rng(1)
        s, t = rng.integers(0, 64, 300), rng.integers(0, 64, 300)
        snap = SN.from_arrays(64, np.concatenate([s, t]),
                              np.concatenate([t, s]))
        d0, _ = F.frontier_bfs_hybrid_fused(snap, int(s[0]), device="cpu")
        d1, _ = B.frontier_bfs(snap, int(s[0]), device="cpu")
        d2, _ = B.frontier_bfs_tiled(snap, int(s[0]), device="cpu",
                                     max_shard_edges=100)
        assert (d0 == d1).all() and (d1 == d2).all()
        d = tempfile.mkdtemp()
        fast = {"storage.lock.wait-time": 5, "ids.authority.wait-time": 5}
        g = titan_tpu_torch.open({"storage.backend": "gdbm",
                                  "storage.directory": d + "/a",
                                  "metrics.enabled": True,
                                  "metrics.csv.interval-s": 0.05,
                                  "metrics.csv.directory": d + "/csv",
                                  **fast})
        tx = g.new_transaction()
        a = tx.add_vertex("person", name="a")
        a.add_edge("knows", tx.add_vertex("person", name="b"))
        tx.commit()
        tio.write_graphbin(g, d + "/g.bin")
        tio.write_graphson(g, d + "/g.json")
        import time
        deadline = time.time() + 10
        while not g._reporters[0].reports and time.time() < deadline:
            time.sleep(0.02)
        g.close()
        for i, (fn, path) in enumerate(((tio.read_graphbin, "/g.bin"),
                                        (tio.read_graphson, "/g.json"))):
            h = titan_tpu_torch.open({"storage.backend": "gdbm",
                                      "storage.directory": d + f"/r{i}",
                                      **fast})
            assert fn(h, d + path) == {"vertices": 2, "edges": 1}
            h.close()
        assert os.path.exists(d + "/csv/metrics.csv")
        assert "titan_tpu_torch.config.docgen" in render()
        open(d + "/dep.yaml", "w").write("services: []\\n")
        assert deploy.status(d + "/dep.yaml") == {}
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "titan_tpu"))
        print(bad)
        """)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=180)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


#: the multi-device layer and the sharded models
MULTI_DEVICE = [("parallel", m) for m in ("__init__", "mesh", "partition",
                                          "multihost")] + [
    ("models", "bfs_hybrid_sharded"), ("models", "bfs"), ("olap", "engine")]


def test_the_multi_device_modules_are_scanned():
    for parts in MULTI_DEVICE:
        path = ROOT.joinpath("titan_tpu_torch", *parts[:-1],
                             parts[-1] + ".py")
        assert path in FILES, path
    assert ROOT / "scripts" / "torch_sharded_4card.py" in FILES


def test_a_sharded_run_loads_no_jax():
    """In a fresh interpreter: the launcher, two gloo ranks running the
    sharded hybrid BFS, the sharded push BFS and the sharded engine, and
    the parent, load no module of jax or titan_tpu (each rank asserts it
    for itself in tests/torch_mesh_worker.py)."""
    code = textwrap.dedent("""
        import sys
        import numpy as np
        sys.path.insert(0, "tests")
        import torch_mesh_worker as W
        from titan_tpu_torch.parallel.multihost import launch

        def main():
            n = 64
            src = np.arange(n - 1, dtype=np.int32)
            s2 = np.concatenate([src, src + 1])
            d2 = np.concatenate([src + 1, src])
            case = {"n": n, "src": s2, "dst": d2, "source": 0}
            got = launch(W.sharded_bfs_cases, 2, "cpu", args=([case],),
                         timeout=120)
            assert (got[0]["dist"] == np.arange(n)).all()
            got = launch(W.push_bfs_cases, 2, "cpu", args=([case],),
                         timeout=120)
            assert (got[0][0] == np.arange(n)).all()
            got = launch(W.engine_cases, 2, "cpu", args=(
                [{**case, "kind": "bfs"}], "unused"), timeout=120)
            assert got["refusal"] is not None
            bad = sorted(m for m in sys.modules
                         if m.split(".")[0] in ("jax", "jaxlib", "titan_tpu"))
            print(bad)

        if __name__ == "__main__":
            main()
        """)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_the_probes_are_scanned_and_import_no_experiment():
    """The probe kernels' module and script are scanned, and no file of
    the port imports ``experiments/`` (``ops/probes.PROBES`` keeps its own
    copy of the probes' shapes)."""
    assert ROOT / "titan_tpu_torch" / "ops" / "probes.py" in FILES
    assert ROOT / "scripts" / "torch_probes.py" in FILES
    bad = {str(p.relative_to(ROOT)): m for p in FILES for m in _imports(p)
           if m and m.split(".")[0] == "experiments"}
    assert not bad, bad


def test_the_probes_load_no_jax():
    """In a fresh interpreter: the probe wrappers on CPU tensors load no
    module of jax, titan_tpu or experiments."""
    code = textwrap.dedent("""
        import sys
        import torch
        from titan_tpu_torch.ops import probes as PR
        x = torch.arange(256 * 128, dtype=torch.int32).view(256, 128)
        PR.tile_transpose(PR.stream_copy(x))
        PR.table_gather(x[:8].contiguous(), x % 8, x % 32)
        PR.row_shuffle(x, x % 128)
        PR.table_scatter(x % 8, x, 8, "add")
        PR.segment_copy(x.view(-1), x[0, :4].contiguous() * 4,
                        x[0, :4].contiguous() * 4, 4, 16)
        print(sorted(m for m in sys.modules if m.split(".")[0] in
                     ("jax", "jaxlib", "titan_tpu", "experiments")))
        """)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
