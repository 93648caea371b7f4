"""Shared arithmetic of the metric readers: which jobs fall in the
measured window, and the union of time intervals."""

from __future__ import annotations


def finished_in_window(run: dict, kind: str) -> list:
    """Jobs of ``kind`` that finished, correct or not, inside the
    window."""
    t0, t1 = run["window"]
    return [j for j in run["jobs"] if j["kind"] == kind and j["ok"]
            and t0 <= j["done"] < t1]


def union_seconds(intervals, lo: float, hi: float) -> float:
    """Seconds of ``[lo, hi]`` that the intervals ``(a, b)`` cover."""
    total = 0.0
    end = lo
    for a, b in sorted((max(a, lo), min(b, hi)) for a, b in intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


def run_spans(run: dict, kind: str) -> list:
    """The model-run spans ``(start, end)`` of ``kind``'s jobs, one per
    executed batch (the jobs of a batch share their run)."""
    seen = set()
    out = []
    for j in run["jobs"]:
        if j["kind"] != kind:
            continue
        for a, b, _ in j.get("runs", ()):
            key = (round(a, 3), round(b, 3))
            if key not in seen:
                seen.add(key)
                out.append((a, b))
    return sorted(out)
