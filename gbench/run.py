"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 -m gbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout. It needs the cards the cell asks for
(exit 2 without them, printing no result), makes the graph from the
seed, measures the served path for ``--seconds`` seconds and checks the
answers against the plain reference. The numbers compared go to
standard error, each beside its limit, as the last lines; the result,
one JSON object, is the last line of standard output. ``--trace 0``
reports the cell's end-to-end metrics, ``--trace 1`` its per-layer ones.
It exits 3, printing no result, if ``jax``, ``jaxlib``, ``flax`` or
``titan_tpu`` is loaded once the window has closed.
"""

from __future__ import annotations

import time

T_IMPORT = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402


def process_start() -> float:
    """When this process started, by the host's clock (``T_IMPORT``
    where ``/proc`` cannot say)."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(int(line.split()[1]) for line in f
                         if line.startswith("btime"))
        start = btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return T_IMPORT
    # btime has whole seconds: never later than this module's import
    return min(start, T_IMPORT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    t_start = process_start()

    import torch

    import titan_tpu_torch  # noqa: F401  the system under test

    from gbench import harness, registry

    bench = registry.benchmark()
    cell = registry.cell(bench, args.workload)
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < int(cell["chips"]):
        print(f"gbench: {args.workload} needs {cell['chips']} CUDA "
              f"device(s); {torch.cuda.device_count()} visible",
              file=sys.stderr)
        return 2
    cfg = registry.config(bench, cell["config"])
    mix = registry.traffic(cell["traffic"])
    metrics = registry.cell_metrics(bench, args.workload, bool(args.trace))
    result, compared, notes = harness.run(
        args.workload, cfg, mix, metrics, args.seed, args.seconds,
        bool(args.trace), "cuda:0", t_start)
    bad = harness.forbidden_modules()
    if bad:
        print(f"gbench: loaded in the run: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    for line in notes:
        print(f"gbench: {line}", file=sys.stderr)
    for name, value, limit in compared:
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
