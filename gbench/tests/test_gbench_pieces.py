"""The benchmark's pieces on the CPU: the generator, the work and time
arithmetic of the end-to-end metrics, ``seg_scan``'s byte model, and the
finding of configurations, mixes, job kinds and metrics by name."""

import json
import math
import os
import re

import pytest
import torch

from gbench import graphgen, registry
from gbench.graph import Graph, simple_edges
from gbench.metrics import _window as W
from gbench.reference import bfs as RB
from gbench.reference import pagerank as RP

CFG = {"scale": 10, "edgefactor": 16,
       "initiator": {"A": 0.57, "B": 0.19, "C": 0.19, "D": 0.05},
       "search_keys": 16}
BIG_SEED = 2**31 + 12345


def test_generator_is_fixed_by_the_seed():
    u1, v1 = Graph(CFG, BIG_SEED, "cpu").edges()
    u2, v2 = Graph(CFG, BIG_SEED, "cpu").edges()
    u3, _ = Graph(CFG, BIG_SEED + 1, "cpu").edges()
    assert torch.equal(u1, u2) and torch.equal(v1, v2)
    assert not torch.equal(u1, u3)
    assert u1.dtype == torch.int32 and u1.shape == (16 << 10,)
    assert int(u1.min()) >= 0 and int(u1.max()) < 1 << 10


def test_generator_follows_the_initiator():
    """Before the scramble a bit of the row id is 1 with chance C + D and
    of the column id with chance B + D; the scramble is a bijection, so
    the degree multiset is what the quadrants make."""
    scale, m = 8, 16 << 8
    gen = torch.Generator().manual_seed(7)
    r = torch.rand(m * scale, generator=gen)
    ab, abc = 0.76, 0.95
    row = (r >= ab).float().mean()
    col = (((r >= 0.57) & (r < ab)) | (r >= abc)).float().mean()
    assert abs(float(row) - 0.24) < 0.01 and abs(float(col) - 0.24) < 0.01
    u, v = graphgen.kronecker_edges(scale, 16, 3, 0.57, 0.19, 0.19, "cpu")
    deg = torch.bincount(torch.cat([u, v]).long(), minlength=1 << scale)
    # Kronecker graphs are skewed: the top 1% of vertices hold far more
    # than 1% of the tuple ends
    top = deg.sort(descending=True).values[: (1 << scale) // 100].sum()
    assert float(top) / float(deg.sum()) > 0.05


def test_search_keys_are_fixed_distinct_and_connected():
    g = Graph(CFG, BIG_SEED, "cpu")
    u, v = g.edges()
    deg = graphgen.degrees(u, v, g.n)
    k1 = graphgen.search_keys(deg, 16, BIG_SEED)
    assert k1 == graphgen.search_keys(deg, 16, BIG_SEED)
    assert len(set(k1)) == 16 and all(int(deg[k]) > 0 for k in k1)
    assert k1 != graphgen.search_keys(deg, 16, BIG_SEED + 1)


def test_simple_edges_drop_loops_and_duplicates():
    u = torch.tensor([0, 1, 1, 2, 3, 3], dtype=torch.int32)
    v = torch.tensor([1, 0, 1, 3, 2, 3], dtype=torch.int32)
    src, dst = simple_edges(u, v, 4)
    pairs = sorted(zip(src.tolist(), dst.tolist()))
    assert pairs == [(0, 1), (1, 0), (2, 3), (3, 2)]


def test_reference_bfs_and_the_teps_numerator():
    # a path 0-1-2, a duplicate and a self-loop on 1, and 3-4 apart
    u = torch.tensor([0, 1, 1, 1, 3], dtype=torch.int32)
    w = torch.tensor([1, 2, 2, 1, 4], dtype=torch.int32)
    dist, levels = RB.bfs(u, w, 6, 0)
    assert dist.tolist() == [0, 1, 2, -1, -1, -1] and levels == 3
    # every tuple of the component counts, the duplicate and loop too
    assert RB.component_tuples(u, w, dist >= 0) == 4
    d2, l2 = RB.bfs(u, w, 6, 2, directed=True)
    assert d2.tolist() == [-1, -1, 0, -1, -1, -1] and l2 == 1
    d5, l5 = RB.bfs(u, w, 6, 5)
    assert int((d5 >= 0).sum()) == 1 and l5 == 1


def test_reference_pagerank_matches_the_formula():
    src = torch.tensor([0, 1, 1, 2])
    dst = torch.tensor([1, 0, 2, 1])
    r = RP.pagerank(src, dst, 4, 0.85, 1)
    base = 0.15 / 4
    want = [base + 0.85 * 0.25 / 2, base + 0.85 * (0.25 + 0.25),
            base + 0.85 * 0.25 / 2, base]
    assert torch.allclose(r, torch.tensor(want, dtype=torch.float64))
    ctl = RP.pagerank(src, dst, 4, 0.85, 20, dtype=torch.bfloat16,
                      acc_dtype=torch.float32)
    ref = RP.pagerank(src, dst, 4, 0.85, 20)
    assert 0 < RP.max_relative_gap(ctl, ref) < 0.05


def _run(jobs, window=(10.0, 20.0)):
    return {"window": window, "window_s": window[1] - window[0],
            "jobs": jobs, "setup_s": 3.5, "on_card": True}


def _job(kind, sub, done, ok=True, work=None, k=16, runs=()):
    return {"kind": kind, "submitted": sub, "done": done, "ok": ok,
            "work": work or {}, "batch_k": k, "runs": list(runs)}


def test_teps_counts_the_jobs_that_finished_in_the_window():
    teps = registry.metric("teps")
    run = _run([_job("bfs", 9.0, 10.5, work={"edges": 100}),
                _job("bfs", 11.0, 19.0, work={"edges": 300}),
                _job("bfs", 15.0, 21.0, work={"edges": 1000}),
                _job("bfs", 8.0, 9.9, work={"edges": 5000})])
    assert teps.read(run) == 400 / 10.0
    assert teps.read(_run([_job("dense", 11, 12, work={"ev": 5})])) is None


def test_evps_counts_vertices_and_edges_a_job():
    evps = registry.metric("evps")
    run = _run([_job("dense", 10.0, 12.0, work={"ev": 7}),
                _job("dense", 12.0, 14.0, work={"ev": 7}),
                _job("dense", 19.0, 22.0, work={"ev": 7})])
    assert evps.read(run) == 14 / 10.0


def test_latency_p95_counts_failures_as_missing():
    lat = registry.metric("latency_p95_ms")
    jobs = [_job("bfs", 10.0 + i * 0.01, 10.1 + i * 0.01)
            for i in range(19)]
    jobs.append(_job("bfs", 11.0, 13.0))
    assert lat.read(_run(jobs)) == pytest.approx(100.0)
    jobs.append(_job("bfs", 11.0, None, ok=False))
    # 21 jobs: the 20th fastest sets the 95th percentile
    assert lat.read(_run(jobs)) == pytest.approx(2000.0)
    jobs.append(_job("bfs", 12.0, None, ok=False))
    assert math.isinf(lat.read(_run(jobs)))
    jobs[-1] = _job("bfs", 5.0, 30.0, ok=False)    # before the window
    assert lat.read(_run(jobs)) == pytest.approx(2000.0)


def test_run_shares_and_batch_size():
    runs = [(12.0, 14.0, []), (15.0, 16.0, [])]
    jobs = [_job("bfs", 11.0, 14.1, runs=runs[:1], k=16),
            _job("bfs", 11.0, 14.1, runs=runs[:1], k=16),
            _job("bfs", 14.0, 16.1, runs=runs[1:], k=8)]
    run = _run(jobs)
    assert registry.metric("serving.run_share.bfs").read(run) == 0.3
    assert registry.metric("model.bfs_run_ms").read(run) == 1500.0
    assert registry.metric("serving.batch_k").read(run) == \
        pytest.approx(40 / 3)
    assert registry.metric("serving.run_share.pagerank").read(run) is None
    run["devprof"] = {"frontier_round": {"calls": 9, "exec_s": 1.2},
                      "batched_exhaust": {"calls": 3, "exec_s": 0.3}}
    assert registry.metric("kernels.bfs_share").read(run) == \
        pytest.approx(0.5)
    run["on_card"] = False
    assert registry.metric("kernels.bfs_share").read(run) is None


def test_union_seconds():
    assert W.union_seconds([(0, 2), (1, 3), (5, 6)], 0, 10) == 4
    assert W.union_seconds([(0, 2), (1, 3), (5, 6)], 1.5, 5.5) == 2
    assert W.union_seconds([], 0, 1) == 0


def test_seg_scan_byte_model_and_roofline():
    m = registry.metric("kernels.seg_scan_roofline")
    # values and flags read once, output written once
    assert m.scan_bytes(128_316_910) == 1_154_852_190
    run = {"on_card": True, "directed_edges": 128_316_910,
           "devprof": {"seg_scan": {"calls": 20, "exec_s": 20 * 0.427e-3}}}
    assert m.read(run) == pytest.approx(
        100 * 1_154_852_190 / 3.35e12 / 0.427e-3)
    assert m.read({**run, "on_card": False}) is None
    assert m.read({**run, "devprof": {}}) is None


def test_pieces_are_found_by_name():
    bench = registry.benchmark()
    for c in bench["configs"]:
        cfg = registry.config(bench, c["name"])
        assert cfg["name"] == c["name"]
    for w in bench["workloads"]:
        mix = registry.traffic(w["traffic"])
        kind = registry.job_kind(mix["job"])
        assert hasattr(kind, "verify") and hasattr(kind, "WORK")
        assert hasattr(registry.generator(mix["generator"]), "drive")
        registry.config(bench, w["config"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(registry.metric(m["name"]).read)
    with pytest.raises(KeyError):
        registry.metric("no-such-metric")
    with pytest.raises(KeyError):
        registry.traffic("no-such-mix")


NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_keeps_to_its_shape():
    path = os.path.join(registry.ROOT, "BENCHMARK.json")
    assert os.path.getsize(path) <= 64 * 1024
    with open(path) as f:
        bench = json.load(f)
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= bench["run_seconds"] <= 51
    names = [w["name"] for w in bench["workloads"]]
    assert len(set(names)) == len(names)
    used = {w["config"] for w in bench["workloads"]}
    assert used == {c["name"] for c in bench["configs"]}
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", names)) <= set(names)
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in bench["per_layer"]:
        reports = [w for w in m["workloads"]
                   if "workloads" not in e2e[m["moves"]]
                   or w in e2e[m["moves"]]["workloads"]]
        assert reports == m["workloads"], m["name"]
    for w in bench["workloads"]:
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert len(w["why"]) <= 200 and w["chips"] in (1, 4)
        assert any(m["name"] != "setup_s" for m in
                   registry.cell_metrics(bench, w["name"], False))
        assert registry.cell_metrics(bench, w["name"], True)


def test_a_trace_slice_is_read_on_the_profilers_own_span():
    """Device events are placed by the profiler's ``Trace`` span, even
    when the trace's clock is seconds off the host's; busy time is their
    union inside the span, and the gaps are what is left."""
    from gbench.devtrace import Slice
    sl = Slice()
    sl.t0, sl.t1 = 100.0, 102.5
    off = 14.5e6                   # the trace's clock, 14.5 s late
    ev = [{"ph": "X", "cat": "Trace", "ts": off, "dur": 2.0e6},
          {"ph": "X", "cat": "kernel", "name": "k", "ts": off + 0.1e6,
           "dur": 0.4e6},
          {"ph": "X", "cat": "kernel", "name": "k", "ts": off + 0.3e6,
           "dur": 0.4e6},
          {"ph": "X", "cat": "gpu_memcpy", "name": "c", "ts": off + 1.5e6,
           "dur": 1.0e6},
          {"ph": "X", "cat": "cuda_runtime", "name": "cudaMemcpyAsync",
           "ts": off + 1.0e6, "dur": 0.2e6}]
    sl._read({"baseTimeNanoseconds": 0, "traceEvents": ev})
    assert sl.window_s == pytest.approx(2.0)
    assert sl.busy_s == pytest.approx(0.6 + 0.5)
    # an operation's seconds are its events' own, overlaps included
    assert sl.ops == {"k": pytest.approx(0.8), "c": pytest.approx(0.5)}
    gaps = sl.gaps()
    assert [round(g, 6) for _, g in gaps] == [0.8, 0.1]
    br = sl.breakdown(lambda t: "host")
    assert br["idle_gaps"][0] == ["host; in cudaMemcpyAsync",
                                  pytest.approx(0.8)]
    assert br["device_ops"][0] == ["k", pytest.approx(0.8)]
