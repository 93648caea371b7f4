#!/usr/bin/env python3
"""The books of a traced benchmark run: one cell of ``BENCHMARK.json``,
run as ``python3 -m gbench.run --trace 1`` runs it, with the window's
stage seams (``obs/devprof``) closed against the window and the runs.

    python3 scripts/torch_stage_books.py --workload <cell> --seed <n> \\
        [--seconds 51] [--out DIR] [--all-threads] \\
        [--device cpu --scale 10]

It prints the run's result line, then one ``books`` JSON line, with
the cell's end-to-end metrics as this traced run reads them
(``end_to_end``), and:

* ``worker``: ``serving.wait`` + ``serving.dispatch`` + ``serving.result``
  + the union of the cell's ``run`` spans, against the window's seconds
  (a job run alone assembles its result inside its run span, so there
  ``serving.result`` is counted twice and ``sum_s`` leaves it out);
* ``bfs_batch``: ``bfs_batched.plan`` + ``.sweep`` + ``.readback`` a
  batch (a ``serving.result`` call) against the mean ``run`` span of the
  batches that started in the window (``model.bfs_run_ms``);
* ``pagerank_job``: ``engine.prepare`` + the mix's iterations x the mean
  ``engine.superstep`` a job (an ``engine.prepare`` call) against the
  mean ``run`` span of the jobs that started in the window;

each with its remainder, and every seam's calls and seconds. With
``--all-threads`` the profiled slice records every thread
(``profile_all_threads``), so the scheduler worker's ``record_function``
ranges lie in it, and ``ranges`` gives their count and seconds by name
inside the slice. ``--device cpu --scale N`` rehearses on the CPU at a
small scale through the port's plain versions. ``--out DIR`` also
writes the books to ``DIR/books-<cell>-<seed>.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _tap_metrics(registry, seen: dict) -> None:
    """Keep the run dict the harness hands its metric readers."""
    real = registry.metric

    def metric(name):
        mod = real(name)

        class Tap:
            @staticmethod
            def read(run):
                seen["run"] = run
                return mod.read(run)
        return Tap
    registry.metric = metric


def _all_threads(devtrace, ranges: dict) -> None:
    """Take the slice with every thread profiled, and count the
    ``user_annotation`` ranges inside the profiler's own span."""
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile

    def enter(self):
        self._prof = profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
            experimental_config=_ExperimentalConfig(
                profile_all_threads=True))
        self._prof.__enter__()
        self.t0 = time.time()
        return self
    read = devtrace.Slice._read

    def read_ranges(self, trace):
        span = [(e["ts"], e["ts"] + e["dur"])
                for e in trace.get("traceEvents", ())
                if e.get("ph") == "X" and e.get("cat") == "Trace"]
        lo, hi = span[0] if span else (float("-inf"), float("inf"))
        for e in trace.get("traceEvents", ()):
            if e.get("ph") == "X" and e.get("cat") == "user_annotation" \
                    and lo <= e["ts"] and e["ts"] + e["dur"] <= hi:
                r = ranges.setdefault(e["name"], {"count": 0, "s": 0.0})
                r["count"] += 1
                r["s"] += e["dur"] / 1e6
        return read(self, trace)
    devtrace.Slice.__enter__ = enter
    devtrace.Slice._read = read_ranges


def books(run: dict, iterations: int) -> dict:
    from gbench.metrics import _window as W

    prof = run.get("devprof") or {}
    t0, t1 = run["window"]
    window = t1 - t0

    def secs(key):
        return prof.get(key, {}).get("exec_s", 0.0)

    def calls(key):
        return prof.get(key, {}).get("calls", 0)
    kinds = {j["kind"] for j in run["jobs"]}
    kind = "bfs" if "bfs" in kinds else "dense"
    spans = W.run_spans(run, kind)
    union = W.union_seconds(spans, t0, t1)
    started = [b - a for a, b in spans if t0 <= a < t1]
    run_mean = sum(started) / len(started) if started else None
    # a job run alone assembles its result inside its run span
    inside = kind == "dense"
    total = secs("serving.wait") + secs("serving.dispatch") + union \
        + (0.0 if inside else secs("serving.result"))
    out = {"kind": kind, "window_s": window,
           "seams": {k: dict(v) for k, v in sorted(prof.items())},
           "worker": {"wait_s": secs("serving.wait"),
                      "dispatch_s": secs("serving.dispatch"),
                      "result_s": secs("serving.result"),
                      "result_inside_runs": inside,
                      "run_union_s": union, "sum_s": total,
                      "remainder_s": window - total,
                      "remainder_share": (window - total) / window}}
    if kind == "bfs" and calls("serving.result") and run_mean:
        n = calls("serving.result")
        part = {k: secs(f"bfs_batched.{k}") / n * 1e3
                for k in ("plan", "sweep", "readback")}
        staged = sum(part.values())
        out["bfs_batch"] = {"batches": n, **{f"{k}_ms": v
                                             for k, v in part.items()},
                            "staged_ms": staged, "run_ms": run_mean * 1e3,
                            "remainder_ms": run_mean * 1e3 - staged,
                            "remainder_share":
                                1 - staged / (run_mean * 1e3)}
    if kind == "dense" and calls("engine.prepare") and run_mean \
            and calls("engine.superstep"):
        n = calls("engine.prepare")
        prep = secs("engine.prepare") / n * 1e3
        step = secs("engine.superstep") / calls("engine.superstep") * 1e3
        staged = prep + iterations * step
        out["pagerank_job"] = {"jobs": n, "prepare_ms": prep,
                               "superstep_ms": step,
                               "staged_ms": staged,
                               "run_ms": run_mean * 1e3,
                               "remainder_ms": run_mean * 1e3 - staged,
                               "remainder_share":
                                   1 - staged / (run_mean * 1e3)}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--out")
    ap.add_argument("--all-threads", action="store_true")
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--scale", type=int)
    args = ap.parse_args(argv)

    from gbench import run as grun
    t_start = grun.process_start()

    import titan_tpu_torch  # noqa: F401  the system under test

    from gbench import devtrace, harness, registry

    seen: dict = {}
    ranges: dict = {}
    _tap_metrics(registry, seen)
    if args.all_threads:
        _all_threads(devtrace, ranges)
    bench = registry.benchmark()
    cell = registry.cell(bench, args.workload)
    cfg = registry.config(bench, cell["config"])
    if args.scale is not None:
        cfg = dict(cfg, scale=args.scale)
    mix = registry.traffic(cell["traffic"])
    metrics = registry.cell_metrics(bench, args.workload, True)
    result, compared, notes = harness.run(
        args.workload, cfg, mix, metrics, args.seed, args.seconds, True,
        args.device, t_start)
    for line in notes:
        print(f"gbench: {line}", file=sys.stderr)
    for name, value, limit in compared:
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    run = seen["run"]
    out = books(run, int(mix.get("iterations", 0)))
    # the end-to-end metrics of this traced run, for tracing's cost
    e2e = {m["name"]: registry.metric(m["name"]).read(run)
           for m in registry.cell_metrics(bench, args.workload, False)}
    out.update(cell=args.workload, seed=args.seed,
               correct=result["correct"], end_to_end=e2e)
    if args.all_threads:
        out["ranges"] = ranges
    print("books " + json.dumps(out), flush=True)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        path = os.path.join(args.out,
                            f"books-{args.workload}-{args.seed}.json")
        with open(path, "w") as f:
            json.dump({"result": result, "books": out}, f, indent=1)
    return 0 if result["correct"] else 1


if __name__ == "__main__":
    sys.exit(main())
