"""The harness end to end on the CPU, on tiny graphs through the port's
plain versions: the result line's keys, the control failing the limits,
and ``correct`` coming out false when the served path is broken
underneath (half of a batch left out, an answer altered where it is
produced, a superstep that returns its state unchanged)."""

import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest

from gbench import control, harness, registry

CELLS = ("g500-s25.bfs-k16", "g500-s22.pagerank-engine")


def _pieces(cell, scale=10):
    bench = registry.benchmark()
    c = registry.cell(bench, cell)
    cfg = dict(registry.config(bench, c["config"]), scale=scale)
    mix = dict(registry.traffic(c["traffic"]), warmup_jobs=4, warmup_s=120,
               drain_s=60)
    mix["clients"] = min(int(mix["clients"]), 8)
    return bench, cfg, mix


def _run(cell, traced=False, seed=2**31 + 101, seconds=1.5):
    bench, cfg, mix = _pieces(cell)
    metrics = registry.cell_metrics(bench, cell, traced)
    return harness.run(cell, cfg, mix, metrics, seed, seconds, traced,
                       "cpu", time.time())


@pytest.mark.parametrize("traced", [False, True])
@pytest.mark.parametrize("cell", CELLS)
def test_a_run_prints_the_contract_keys(cell, traced):
    result, compared, _ = _run(cell, traced)
    assert result["correct"] is True, result["checks"]
    assert {"correct", "attempted", "failed", "metrics",
            "device"} <= set(result)
    assert list(result)[-1] == "checks"
    assert result["attempted"] > 0 and result["failed"] == 0
    assert {"platform", "kind", "count",
            "memory_peak_bytes"} <= set(result["device"])
    bench = registry.benchmark()
    names = {m["name"] for m in registry.cell_metrics(bench, cell, traced)}
    assert set(result["metrics"]) <= names
    if not traced:
        # every end-to-end metric a run off the card can read
        assert set(result["metrics"]) == names
        assert all(v["value"] > 0 for v in result["metrics"].values())
    assert [c[0] for c in compared] == list(result["checks"])
    json.dumps(result)


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_the_limits(cell):
    _, cfg, mix = _pieces(cell, scale=12)
    for seed in (3, 2**31 + 7, 99):
        numbers = control.control_numbers(cfg, mix, seed, "cpu")
        assert any(v > mix["limits"][k] for k, v in numbers.items()), \
            numbers


def _broken_bfs(monkeypatch, mutate):
    from titan_tpu_torch.models import bfs_hybrid
    real = bfs_hybrid.frontier_bfs_batched

    def broken(*a, **kw):
        dist, levels, completed = real(*a, **kw)
        return mutate(np.array(dist)), levels, completed
    monkeypatch.setattr(bfs_hybrid, "frontier_bfs_batched", broken)


def test_half_of_a_batch_left_out_is_caught(monkeypatch):
    def drop_half(dist):
        dist[dist.shape[0] // 2:] = 1 << 30
        return dist
    _broken_bfs(monkeypatch, drop_half)
    result, _, _ = _run("g500-s25.bfs-k16")
    assert result["correct"] is False


def test_an_altered_answer_is_caught(monkeypatch):
    def alter(dist):
        for row in dist:
            hit = np.flatnonzero(row == 2)
            if hit.size:
                row[hit[0]] = 3
        return dist
    _broken_bfs(monkeypatch, alter)
    result, _, _ = _run("g500-s25.bfs-k16")
    assert result["correct"] is False
    assert result["checks"]["bfs_dist_mismatch"]["value"] > 0


def test_a_bfs_that_returns_its_state_unchanged_is_caught(monkeypatch):
    def untouched(dist):
        # every level's sweep left the state as it was: the sources alone
        return np.where(dist == 0, 0, 1 << 30).astype(dist.dtype)
    _broken_bfs(monkeypatch, untouched)
    result, _, _ = _run("g500-s25.bfs-k16")
    assert result["correct"] is False


def test_an_altered_rank_is_caught(monkeypatch):
    from titan_tpu_torch.olap import engine
    real = engine.run_single

    def altered(*a, **kw):
        res = real(*a, **kw)
        res["rank"][0] *= 1.001
        return res
    monkeypatch.setattr(engine, "run_single", altered)
    result, _, _ = _run("g500-s22.pagerank-engine")
    assert result["correct"] is False


def test_a_superstep_that_returns_its_state_is_caught(monkeypatch):
    from titan_tpu_torch.olap import engine

    def stuck(program, state, g, edata, dparams, it, n):
        return state, False
    monkeypatch.setattr(engine, "_superstep", stuck)
    result, _, _ = _run("g500-s22.pagerank-engine")
    assert result["correct"] is False
    assert result["checks"]["pagerank_rank_gap"]["value"] > \
        result["checks"]["pagerank_rank_gap"]["limit"]


def test_the_cli_needs_a_card_and_the_program(tmp_path):
    root = registry.ROOT
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    args = [sys.executable, "-m", "gbench.run", "--workload", CELLS[0],
            "--seed", str(2**31 + 3), "--seconds", "1", "--trace", "0"]
    p = subprocess.run(args, cwd=root, env=env, capture_output=True,
                       text=True, timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""
    # a directory with only BENCHMARK.json and the benchmark's files
    shutil.copy(os.path.join(root, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(root, "gbench"), tmp_path / "gbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run(args, cwd=tmp_path, env=env, capture_output=True,
                       text=True, timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "titan_tpu_torch" in p.stderr
