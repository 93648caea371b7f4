"""One run of one cell: set-up, the measured window, the check.

1. Set-up: the configuration's graph is made on the device from the
   seed, the job kind takes its inputs from it (search keys, degrees),
   and the system under test ingests it (``graph.ingest``). The
   benchmark's copy leaves the device, the card's peak counter starts
   over, and ``titan_tpu_torch``'s ``JobScheduler`` is built: tracing
   and the device-cost profiler off, or both on in a traced run.
2. The closed loop of the traffic mix runs until its warm-up jobs have
   finished (each shape the window uses has run, and the graph is on the
   card), then for ``seconds``. A traced run takes a ``torch.profiler``
   slice of the window and the profiler's counters at both ends.
3. Once every client is back, the card's peak is read, the scheduler
   closed and its snapshot freed. The job kind's reference, in plain
   PyTorch over the graph made again from the seed, judges the sampled
   answers and every job's summary and gives each job's work.

``run`` returns the result line and the numbers compared; the caller
prints them.
"""

from __future__ import annotations

import gc
import random
import sys
import threading
import time

import torch

from gbench import registry
from gbench.graph import Graph, ingest

#: top-level modules that may not be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "titan_tpu")


def forbidden_modules() -> list:
    """The forbidden packages loaded in this process, compared by whole
    top-level name (``titan_tpu_torch`` is not ``titan_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


class Sampler:
    """A reservoir of ``k`` finished jobs drawn from the seed: each job
    of the window is kept with the same chance, whatever their count."""

    def __init__(self, k: int, seed: int):
        self.k = int(k)
        self.rng = random.Random(f"sample/{seed}")
        self.seen = 0
        self.items: list = []
        self.lock = threading.Lock()

    def offer(self, rec: dict, payload) -> None:
        with self.lock:
            self.seen += 1
            if len(self.items) < self.k:
                self.items.append((rec, payload()))
                return
            j = self.rng.randrange(self.seen)
            if j < self.k:
                self.items[j] = (rec, payload())


def _scheduler(snap, device, traced: bool):
    from titan_tpu_torch.olap.serving import JobScheduler
    from titan_tpu_torch.utils.metrics import MetricManager

    kw = {}
    if device.type != "cuda":
        # the port's plain versions, for tests off the card
        kw = {"device": str(device), "hbm_budget_bytes": 1e12}
    # the autotuner and the flight recorder pinned to their defaults, so
    # no environment variable changes the served path
    return JobScheduler(snapshot=snap, tracing=traced, profiling=traced,
                        autotune="shadow", flight_dir="",
                        metrics=MetricManager(), **kw)


def _kernel_totals(prof) -> dict:
    return {k: {"calls": v["calls"], "exec_s": v["exec_s"]}
            for k, v in prof.kernel_stats().items()}


def _span_label(records: list):
    """``label(t)``: what the system under test's spans say its host was
    doing at ``t``: in a model run (and at which level), or serving."""
    runs = []
    for r in records:
        for a, b, rounds in r.get("runs", ()):
            runs.append((a, b, rounds))

    def label(t: float) -> str:
        for a, b, rounds in runs:
            if a <= t <= b:
                for ra, rb, lvl in rounds:
                    if ra <= t <= rb:
                        return f"run span, level {lvl}"
                return "run span, outside its levels"
        return "no run span (the scheduler and batcher's own work)"
    return label


def run(cell: str, cfg: dict, mix: dict, metrics: list, seed: int,
        seconds: float, traced: bool, device, t_start: float) -> tuple:
    """``(result, numbers, notes)``: the result line's object, the
    compared numbers ``[(name, value, limit)]`` and lines for standard
    error."""
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    kind = registry.job_kind(mix["job"])
    loop = registry.generator(mix["generator"])

    graph = Graph(cfg, seed, dev)
    u, v = graph.edges()
    inp = kind.inputs(graph, u, v, mix)
    snap = ingest(u, v, graph.n)
    del u, v
    gc.collect()
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)

    if traced and cuda:
        from gbench.devtrace import warm_up
        warm_up(dev)
    sched = _scheduler(snap, dev, traced)
    sampler = Sampler(mix["sample"], seed)
    window: dict = {}
    trace: dict = {}

    def on_done(job, rec):
        rec["summary"] = kind.summary(job) if rec["ok"] else None
        if traced:
            spans = sched.tracer.spans(job.id) or []
            runs = [s for s in spans if s.name == "run"
                    and s.t_end is not None]
            rounds = [(s.t_start, s.t_end, (s.attrs or {}).get("level"))
                      for s in spans if s.name == "round"
                      and s.t_end is not None]
            rec["runs"] = [(s.t_start, s.t_end, rounds) for s in runs]
        if rec["ok"] and rec["submitted"] >= window.get("t0", float("inf")):
            sampler.offer(rec, lambda: kind.payload(job))
        job.result = None        # the run keeps only what it needs

    def on_open(t0, t1):
        window.update(t0=t0, t1=t1)

    def in_window(t0, t1):
        if not traced:
            return
        trace["devprof0"] = _kernel_totals(sched.profiler)
        if cuda:
            from gbench.devtrace import Slice
            time.sleep(max(t0 + float(mix["profile_after_s"])
                           - time.time(), 0.0))
            with Slice() as sl:
                time.sleep(float(mix["profile_seconds"]))
            trace["slice"] = sl
        time.sleep(max(t1 - time.time(), 0.0))
        trace["devprof1"] = _kernel_totals(sched.profiler)

    try:
        done = loop.drive(sched, kind.make_specs(inp, mix, seed), on_done,
                          clients=int(mix["clients"]),
                          warmup_jobs=int(mix["warmup_jobs"]),
                          seconds=seconds, drain_s=float(mix["drain_s"]),
                          warmup_s=float(mix["warmup_s"]),
                          on_open=on_open, in_window=in_window)
        peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    finally:
        sched.close(timeout=60.0)
    del sched, snap
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    t0, t1 = done.t0, done.t1
    records = done.records
    in_win = [r for r in records if t0 <= r["submitted"] < t1]
    numbers, work = kind.verify(graph, inp, records, sampler.items)
    for rec, w in zip(records, work):
        rec["work"] = {kind.WORK: w}

    compared = [(name, value, mix["limits"][name])
                for name, value in numbers.items()]
    failed = sum(not r["ok"] for r in in_win)
    missing = int(mix["sample"]) - len(sampler.items)
    compared += [("failed_jobs", failed, 0),
                 ("stuck_clients", done.stuck, 0),
                 ("sample_missing", missing, 0)]
    correct = (all(r["ok"] for r in records)
               and all(value <= limit for _, value, limit in compared))

    info = {"cell": cell, "on_card": cuda, "window": (t0, t1),
            "window_s": seconds,
            "setup_s": t0 - t_start, "jobs": records,
            "directed_edges": inp.get("directed_edges")}
    if traced:
        d0, d1 = trace["devprof0"], trace["devprof1"]
        info["devprof"] = {k: {f: v[f] - d0.get(k, {}).get(f, 0)
                               for f in ("calls", "exec_s")}
                           for k, v in d1.items()}
        info["slice"] = trace.get("slice")
    values = {}
    for m in metrics:
        val = registry.metric(m["name"]).read(info)
        if val is not None:
            values[m["name"]] = {"value": val, "unit": m["unit"]}

    if cuda:
        dev_info = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
                    "count": 1, "memory_peak_bytes": int(peak)}
    else:
        dev_info = {"platform": "cpu", "kind": "cpu", "count": 1,
                    "memory_peak_bytes": 0}
    result = {"correct": bool(correct), "attempted": len(in_win),
              "failed": failed, "metrics": values, "device": dev_info}
    notes = [f"window {t0:.3f}-{t1:.3f}: {len(in_win)} jobs submitted, "
             f"{sum(1 for r in records if r['ok'] and t0 <= r['done'] < t1)}"
             f" finished; {len(records)} jobs in the run"]
    sl = info.get("slice")
    if sl is not None:
        notes.append(sl.describe())
    if traced and sl is not None:
        dev_info["busy_s"] = sl.busy_s
        dev_info["window_s"] = sl.window_s
        result["breakdown"] = sl.breakdown(_span_label(records))
    result["checks"] = {name: {"value": value, "limit": limit}
                        for name, value, limit in compared}
    return result, compared, notes
