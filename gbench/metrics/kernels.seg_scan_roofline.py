"""``seg_scan``'s share of its HBM roofline over the window: each call
reads its float32 values and one-byte flags once and writes its float32
output once, 9 bytes an edge of the snapshot's directed edges (counted
by the benchmark), at the card's published 3.35 TB/s, over the
device-cost profiler's ``seg_scan`` seconds."""

from gbench.peaks import H100_HBM_BYTES_S

#: bytes an element: values 4 + flags 1 read, output 4 written
BYTES_PER_EDGE = 9


def scan_bytes(edges: int) -> int:
    return BYTES_PER_EDGE * int(edges)


def read(run):
    k = run.get("devprof", {}).get("seg_scan")
    edges = run.get("directed_edges")
    if not run.get("on_card") or not k or not edges or k["calls"] <= 0 \
            or k["exec_s"] <= 0:
        return None
    bound_s = k["calls"] * scan_bytes(edges) / H100_HBM_BYTES_S
    return bound_s / k["exec_s"] * 100.0
