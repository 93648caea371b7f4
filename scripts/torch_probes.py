#!/usr/bin/env python3
"""The access-pattern probes of experiments/ on the card.

    python3 scripts/torch_probes.py [--reps 5] [--out DIR]

Builds ``csrc/probes.cu`` and runs ``ops/probes.run_probes``: every probe
at the TPU probes' own shapes (``probes.PROBES``: the stream copy, the
table gathers from 1-8 MB tables and from a 256 MB one, the bit lookup,
the row shuffles, the three scatters, the tile transpose, probe3_dma's
and probe3d's segment copies), each held once to its plain version, then
timed by CUDA events. Prints the card's name and power limit, one line a
probe as the TPU scripts did (ms, G elem/s, GB/s of its byte model, the
bound's share, the sector model's share for a table beyond L2 and its
lookups' sectors alone in GB/s, the plain version's and the library
call's ms), then the records as one JSON line; with ``--out`` it also
writes them to DIR/torch_probes.json. Exits 1 without a card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out", help="directory for the records (JSON)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_probes: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from titan_tpu_torch.ops import probes as PR

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    recs = PR.run_probes(reps=args.reps)
    for r in recs:
        sector = "" if r["sector_share"] is None else (
            f"  sectors {r['sector_gb_s']:8.1f} GB/s "
            f"{100 * r['sector_share']:5.1f}% (lookups alone "
            f"{r['lookup_sector_gb_s']:.1f} GB/s)")
        lib = "none" if r["library_ms"] is None else \
            f"{r['library_ms']:.4f} ms"
        print(f"{r['probe']:52s}{r['ms']:9.4f} ms {r['g_elem_s']:8.2f} "
              f"G elem/s {r['gb_s']:8.1f} GB/s {100 * r['share']:5.1f}% "
              f"of bound [{r['where']}]{sector}  plain {r['plain_ms']:.4f} "
              f"ms  library {lib}", flush=True)
    summary = {"card": card, "launches": {k.__name__: k.launches
                                          for k in PR.KERNELS},
               "probes": recs}
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "torch_probes.json"), "w") as f:
            json.dump(summary, f, indent=1)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
