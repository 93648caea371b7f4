"""The fused BFS's byte bound (``chip_smoke.fused_bytes``) and the kernel's
per-level split (``bfs_hybrid_fused.level_split``), on the CPU.

The bound's top-down levels test their neighbours against a visited
bitmap: one 32 B sector (256 vertices) for each distinct sector they fall
in (``vis_td``). The older model's ``dist`` sectors (``dist_td``) stay in
``total`` for comparison only. The split turns the kernel's
``%globaltimer`` stamps, three a level, into each level's mode and the ms
of its top, scan and walk_lists."""

import numpy as np
import pytest

import chip_smoke as cs
import titan_tpu_torch.models.bfs_hybrid as PH
import titan_tpu_torch.models.bfs_hybrid_fused as PF
from titan_tpu_torch.olap import snapshot as snap_mod
from titan_tpu_torch.olap.rmat import rmat_edges


def _rmat(scale, ef, seed):
    src, dst = rmat_edges(scale, ef, seed=seed)
    src, dst = np.asarray(src, np.int64), np.asarray(dst, np.int64)
    return snap_mod.from_arrays(1 << scale, np.concatenate([src, dst]),
                                np.concatenate([dst, src]))


def _vis_sectors_by_hand(g, dist, trace) -> int:
    """32 B for each distinct 256-vertex sector of the visited bitmap that
    each top-down level's neighbours fall in, vertex by vertex."""
    n = g["n"]
    dstT, cs_, dg = (g[k].numpy() for k in ("dstT", "colstart", "degc"))
    d = dist[:n].numpy().astype(np.int64)
    out = 0
    for level, mode, _ in trace:
        if mode != "td":
            continue
        sectors = set()
        for u in np.flatnonzero(d == level):
            cols = dstT[:, cs_[u]:cs_[u] + dg[u]].reshape(-1)
            sectors.update(int(w) >> 8 for w in cols if w < n)
        out += 32 * len(sectors)
    return out


@pytest.mark.parametrize("caps", [None, (1, 1)])
@pytest.mark.parametrize("scale,ef,seed", [(8, 4, 1), (10, 16, 10),
                                           (11, 8, 3), (12, 4, 7)])
def test_bound_tests_neighbours_against_a_visited_bitmap(scale, ef, seed,
                                                         caps, monkeypatch):
    """With the endgame's caps at 1 the levels go top-down and bottom-up;
    with JAX's, these small graphs are the endgame's."""
    if caps:
        monkeypatch.setattr(PF, "END_C_CAP", caps[0])
        monkeypatch.setattr(PF, "END_P_CAP", caps[1])
    snap = _rmat(scale, ef, seed)
    g = PH.build_chunked_csr(snap, "cpu")
    src = int(np.argmax(snap.out_degree))
    dist, _, trace = cs.fused_plain(PF, g, src)
    got = cs.fused_bytes(PF, g, dist, trace)
    assert got["vis_td"] == _vis_sectors_by_hand(g, dist, trace)
    assert got["bound"] == got["total"] - got["dist_td"] + got["vis_td"]
    n_td = sum(m == "td" for _, m, _ in trace)
    # at most the whole bitmap a top-down level, and never more than the
    # dist sectors the older model counts
    assert got["vis_td"] <= n_td * 32 * -(-g["n"] // 256)
    assert got["vis_td"] <= got["dist_td"]
    assert n_td == 0 or got["vis_td"] > 0
    if caps:
        assert n_td > 0, trace


def _stamps(levels, per_level_ns, cap=None):
    """A stamp buffer as the kernel writes it: [0] the levels stamped,
    [1] the start, [2] after the first pass, then top, after scan and
    after walk_lists a level."""
    t = [0, 1_000, 3_000]
    for top, scan, walk in per_level_ns:
        t += [t[-1] + top, t[-1] + top + scan, t[-1] + top + scan + walk]
    t[0] = levels
    return t if cap is None else t[:cap]


def test_split_reads_three_stamps_a_level():
    per = [(100, 2_000, 500), (50, 7_000, 40_000), (10, 300, 20)]
    sp = PF.level_split(_stamps(3, per), [1, 2])
    assert sp["init_ms"] == pytest.approx(0.002)
    assert [r["mode"] for r in sp["levels"]] == ["td", "bu", "endgame"]
    for row, (top, scan, walk) in zip(sp["levels"], per):
        assert set(row) == {"mode", "top_ms", "scan_ms", "walk_ms"}
        assert row["top_ms"] == pytest.approx(top / 1e6)
        assert row["scan_ms"] == pytest.approx(scan / 1e6)
        assert row["walk_ms"] == pytest.approx(walk / 1e6)
    assert sp["total_ms"] == pytest.approx(
        (2_000 + sum(map(sum, per))) / 1e6)


def test_split_stops_at_the_buffer_end():
    per = [(100, 2_000, 500)] * 4
    sp = PF.level_split(_stamps(4, per, cap=3 + 3 * 2 + 2), [1] * 4)
    assert len(sp["levels"]) == 2
    sp = PF.level_split(_stamps(1, per), [1] * 4)
    assert len(sp["levels"]) == 1
