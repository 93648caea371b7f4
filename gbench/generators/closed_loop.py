"""Closed-loop clients: each submits a job, waits for its result, and
submits the next, for as long as the run lasts.

Callers that each wait on a reply make a closed loop: a slower system
receives less load. Client ``c`` takes its jobs from ``make_specs(c)``,
an iterator fixed by the seed. Each finished job goes to
``on_done(job, record)`` on the client's thread, which keeps what the
run needs and releases the result.

The window opens once ``warmup_jobs`` jobs have finished (everything
before is set-up, every shape the window uses already run) and closes
``seconds`` later. From then on no client submits; each waits for the
job it has out, up to ``drain_s``. A job that fails or does not finish
by then counts as missing.
"""

from __future__ import annotations

import threading
import time


class Run:
    """What a loop leaves behind: the records of every job, the window,
    and whether every client came back."""

    def __init__(self):
        self.records: list = []
        self.t0 = None
        self.t1 = None
        self.stuck = 0


def drive(sched, make_specs, on_done, *, clients: int, warmup_jobs: int,
          seconds: float, drain_s: float, warmup_s: float,
          on_open=None, in_window=None) -> Run:
    """Run the loop. ``on_open(t0, t1)`` is told the window as it opens,
    before any job of it finishes; ``in_window(t0, t1)`` then runs on the
    calling thread (a profiler's slice) and returns by ``t1``."""
    run = Run()
    lock = threading.Condition()
    deadline = [float("inf")]       # no submit at or after this time
    finished = [0]

    def client(c: int) -> None:
        specs = make_specs(c)
        while True:
            spec = next(specs)
            t_sub = time.time()
            if t_sub >= deadline[0]:
                return
            job = sched.submit(spec)
            rec = {"client": c, "kind": spec.kind, "submitted": t_sub,
                   "done": None, "state": "queued", "ok": False}
            with lock:
                run.records.append(rec)
            ok = job.wait(max(deadline[0] + drain_s - time.time(), 0.0)
                          if deadline[0] < float("inf")
                          else warmup_s + drain_s)
            rec.update(done=time.time(), state=job.state.value,
                       ok=bool(ok) and job.state.value == "done",
                       error=job.error, batch_k=job.batch_k)
            on_done(job, rec)
            with lock:
                finished[0] += 1
                lock.notify_all()
            if not rec["ok"]:
                return

    threads = [threading.Thread(target=client, args=(c,), daemon=True,
                                name=f"gbench-client-{c}")
               for c in range(clients)]
    for t in threads:
        t.start()
    with lock:
        if not lock.wait_for(lambda: finished[0] >= warmup_jobs
                             or any(r["done"] is not None and not r["ok"]
                                    for r in run.records),
                             timeout=warmup_s):
            deadline[0] = time.time()
            raise TimeoutError(f"{finished[0]} of {warmup_jobs} warm-up "
                               f"jobs finished in {warmup_s} s")
        bad = [r for r in run.records
               if r["done"] is not None and not r["ok"]]
        if bad:
            deadline[0] = time.time()
            bad = bad[0]
            raise RuntimeError(f"a warm-up job ended {bad['state']}: "
                               f"{bad['error']}")
        run.t0 = time.time()
        run.t1 = run.t0 + seconds
        deadline[0] = run.t1
        if on_open is not None:
            on_open(run.t0, run.t1)
    if in_window is not None:
        in_window(run.t0, run.t1)
    time.sleep(max(run.t1 - time.time(), 0.0))
    for t in threads:
        t.join(max(run.t1 + drain_s + 5.0 - time.time(), 0.0))
    run.stuck = sum(t.is_alive() for t in threads)
    return run
