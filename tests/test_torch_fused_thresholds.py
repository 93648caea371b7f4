"""The port's fused BFS (``fused_bfs_reference`` on the CPU) against the
JAX package's ``frontier_bfs_hybrid_fused`` on graphs whose four counts
land exactly on the mode rule's thresholds (``chip_smoke.
FUSED_THRESHOLDS``): ``m8_f == m8_unvis // 8`` with ``f > 1``,
``n_unvis == end_c`` and ``f == top_f``. Counting one vertex or chunk too
many there changes the level's mode, so the kernel, which counts where it
finds (``csrc/bfs_fused.cu``), is held to the same graphs on the card
(``chip_smoke.py`` phase 4b).

The caps are set in BOTH packages. The top top-down pair is the last of
the JAX program's td ladder (``_ladders``), so the JAX side gets a
one-pair ladder and the port ``FUSED_TD_MAX``; JAX caches its compiled
program with what it was traced under, so every test drops
``jitcache._JITS["hybrid_fused"]`` before and after it."""

import numpy as np
import pytest

import chip_smoke as cs
import titan_tpu.models.bfs_hybrid_fused as FU
import titan_tpu_torch.models.bfs_hybrid as PH
import titan_tpu_torch.models.bfs_hybrid_fused as PF
from titan_tpu.olap.tpu import snapshot as snap_mod
from titan_tpu.utils import jitcache

CASES = cs.fused_threshold_cases(snap_mod.from_arrays, PH, "cpu")


@pytest.fixture(autouse=True)
def _fresh_jit(monkeypatch):
    monkeypatch.delitem(jitcache._JITS, "hybrid_fused", raising=False)
    yield
    jitcache._JITS.pop("hybrid_fused", None)


def _set_caps(monkeypatch, caps):
    for mod in (FU, PF):
        monkeypatch.setattr(mod, "END_C_CAP", caps["END_C_CAP"])
        monkeypatch.setattr(mod, "END_P_CAP", caps["END_P_CAP"])
    if caps["top"] is not None:
        monkeypatch.setattr(PF, "FUSED_TD_MAX", caps["top"])
        ladders = FU._ladders

        def one_pair(n, total_chunks):
            _, bu, cap_n, cap_q = ladders(n, total_chunks)
            return ([(min(caps["top"][0], cap_n),
                      min(caps["top"][1], cap_q))], bu, cap_n, cap_q)
        monkeypatch.setattr(FU, "_ladders", one_pair)


def _both(case, monkeypatch, caps):
    """The JAX program and the port's plain version under ``caps``:
    ``dist``, ``levels`` equal; returns the port's modes."""
    _set_caps(monkeypatch, caps)
    g = case["g"]
    dj, lj = FU.frontier_bfs_hybrid_fused(case["snap"], case["source"])
    dp, lp, trace = cs.fused_plain(PF, g, case["source"])
    assert np.array_equal(np.asarray(dj), dp[:g["n"]].numpy())
    assert lp == lj, (lp, lj, trace)
    return [m for _, m, _ in trace]


@pytest.mark.parametrize("case", CASES,
                         ids=[f"{c['rule']}-{c['seed']}" for c in CASES])
def test_counts_on_the_threshold(case, monkeypatch):
    """At the case's level the rule takes the mode the counts give on the
    threshold, in both packages."""
    modes = _both(case, monkeypatch, case["caps"])
    assert modes[case["level"]] == case["mode"], modes


@pytest.mark.parametrize("case", CASES,
                         ids=[f"{c['rule']}-{c['seed']}" for c in CASES])
def test_one_more_changes_the_mode(case, monkeypatch):
    """One vertex or chunk counted too many at the case's level would
    change its mode: the rule's answer on the counts, then on the
    counts one past the threshold (the cap one below it), in both
    packages."""
    f, m8f, m8u, nu = case["counts"]
    g = case["g"]
    n, q = g["n"], g["q_total"] - 1
    caps = case["caps"]
    end = (min(caps["END_C_CAP"], PF.next_pow2(max(n, 2))),
           min(caps["END_P_CAP"], PF.next_pow2(max(q + 1, 2))))
    top = caps["top"] or PF.td_top(n, q)
    want = PF.MODES.index(case["mode"])
    assert PF.choose_mode([f, m8f, m8u, nu], *end, top) == want
    if case["rule"] == "m8f":
        past = PF.choose_mode([f, m8f + 1, m8u, nu], *end, top)
        moved = caps
    elif case["rule"] == "end_c":
        past = PF.choose_mode([f, m8f, m8u, nu + 1], *end, top)
        moved = {**caps, "END_C_CAP": nu - 1}
    else:
        past = PF.choose_mode([f + 1, m8f, m8u, nu], *end, top)
        moved = {**caps, "top": (f - 1, caps["top"][1])}
    assert past != want
    if moved is not caps:
        modes = _both(case, monkeypatch, moved)
        assert modes[case["level"]] != case["mode"], modes
