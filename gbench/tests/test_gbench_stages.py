"""The stage readers on synthetic runs: each of the window's seam
seconds a batch (``serving.result`` calls), a superstep
(``engine.superstep`` calls) or a job (``engine.prepare`` calls), or
over the window's seconds; None where a seam is absent (a program
without it), where nothing divides, in a cell of the other kind, and
off the card for a device seam."""

import pytest

from gbench import registry

BFS = {"model.bfs_plan_ms": ("bfs_batched.plan", 0.9),
       "model.bfs_sweep_ms": ("bfs_batched.sweep", 2.4),
       "model.bfs_readback_ms": ("bfs_batched.readback", 1.5),
       "serving.result_ms.bfs": ("serving.result", 1.2),
       "serving.dispatch_ms.bfs": ("serving.dispatch", 0.3)}
PAGERANK = {"engine.prepare_ms": ("engine.prepare", 0.25, "engine.prepare"),
            "engine.gather_ms": ("engine.gather", 2.0, "engine.superstep"),
            "engine.combine_ms": ("engine.combine", 0.8, "engine.superstep"),
            "serving.result_ms.pagerank": ("serving.result", 0.05,
                                           "engine.prepare"),
            "serving.dispatch_ms.pagerank": ("serving.dispatch", 1.5,
                                             "engine.prepare")}
DEVICE = ("model.bfs_plan_ms", "model.bfs_sweep_ms", "model.bfs_readback_ms",
          "engine.prepare_ms", "engine.gather_ms", "engine.combine_ms")


def _run(kind, devprof, on_card=True, window=(10.0, 60.0)):
    return {"window": window, "window_s": window[1] - window[0],
            "on_card": on_card, "devprof": devprof,
            "jobs": [{"kind": kind, "submitted": 11.0, "done": 12.0,
                      "ok": True, "runs": []}]}


def _bfs_devprof():
    prof = {key: {"calls": 40, "exec_s": s} for key, s in BFS.values()}
    prof["serving.result"]["calls"] = 15         # 15 batches
    prof["serving.dispatch"]["calls"] = 75
    prof["serving.wait"] = {"calls": 3, "exec_s": 0.5}
    return prof


def _pagerank_devprof():
    prof = {key: {"calls": 9000, "exec_s": s}
            for key, s, _ in PAGERANK.values()}
    prof["engine.superstep"] = {"calls": 8000, "exec_s": 25.0}
    prof["engine.prepare"]["calls"] = 400        # 400 jobs
    prof["serving.result"]["calls"] = 400
    prof["serving.wait"] = {"calls": 100, "exec_s": 2.0}
    return prof


def test_bfs_stages_a_batch():
    run = _run("bfs", _bfs_devprof())
    for name, (_key, secs) in BFS.items():
        assert registry.metric(name).read(run) == \
            pytest.approx(secs / 15 * 1e3), name
    assert registry.metric("serving.wait_share.bfs").read(run) == \
        pytest.approx(0.5 / 50)


def test_engine_stages_a_superstep_or_a_job():
    run = _run("dense", _pagerank_devprof())
    for name, (_key, secs, per) in PAGERANK.items():
        calls = 8000 if per == "engine.superstep" else 400
        assert registry.metric(name).read(run) == \
            pytest.approx(secs / calls * 1e3), name
    assert registry.metric("serving.wait_share.pagerank").read(run) == \
        pytest.approx(2.0 / 50)


def test_a_worker_that_never_waited_reads_zero():
    prof = _bfs_devprof()
    prof["serving.wait"] = {"calls": 0, "exec_s": 0.0}
    assert registry.metric("serving.wait_share.bfs").read(
        _run("bfs", prof)) == 0.0


@pytest.mark.parametrize("name", sorted(BFS) + sorted(PAGERANK)
                         + ["serving.wait_share.bfs",
                            "serving.wait_share.pagerank"])
def test_none_where_there_is_nothing_to_read(name):
    kind = "bfs" if name in BFS or name.endswith(".bfs") else "dense"
    prof = _bfs_devprof() if kind == "bfs" else _pagerank_devprof()
    m = registry.metric(name)
    assert m.read(_run(kind, prof)) is not None
    # a program without the stage seams (the traced run's devprof holds
    # only the kernels), or an untraced run
    assert m.read(_run(kind, {"frontier_round": {"calls": 3,
                                                 "exec_s": 0.1}})) is None
    assert m.read(_run(kind, None)) is None
    # a cell of the other kind
    other = "dense" if kind == "bfs" else "bfs"
    assert m.read(_run(other, prof)) is None
    # a device seam off the card; the host stages read anywhere
    off = m.read(_run(kind, prof, on_card=False))
    assert (off is None) == (name in DEVICE)
    # nothing to divide by: no batch, superstep or job in the window
    if not name.startswith("serving.wait_share"):
        for key in ("serving.result", "engine.superstep", "engine.prepare"):
            if key in prof:
                prof[key] = {"calls": 0, "exec_s": 0.0}
        assert m.read(_run(kind, prof)) is None
