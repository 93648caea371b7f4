"""The port's multi-process dry run (the counterpart of
tests/test_multihost.py): ``python -m titan_tpu_torch.parallel.multihost``
spawns 2 gloo ranks on the CPU, each packing and uploading only its own
block of the same R-MAT graph (host-sharded loading); rank 0 checks the
sharded BFS bit for bit against the single-card hybrid and the run ends
in ``MULTIHOST_OK``. Its level count and bottom-up trails equal the JAX
package's sharded BFS on a 2-device mesh over the same graph."""

import json
import pathlib
import subprocess
import sys

import numpy as np

from titan_tpu.models import bfs_hybrid_sharded as JS
from titan_tpu.olap.tpu import snapshot as snap_mod
from titan_tpu.olap.tpu.rmat import rmat_edges
from titan_tpu.parallel.mesh import vertex_mesh

ROOT = pathlib.Path(__file__).resolve().parent.parent
SCALE = 12


def test_multihost_dryrun_is_bit_equal():
    out = subprocess.run(
        [sys.executable, "-m", "titan_tpu_torch.parallel.multihost",
         "--world", "2", "--scale", str(SCALE), "--device", "cpu"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    line = [ln for ln in out.stdout.splitlines()
            if ln.startswith("MULTIHOST_OK ")]
    assert len(line) == 1, out.stdout
    rec = json.loads(line[0][len("MULTIHOST_OK "):])
    assert rec["bit_equal_vs_single_chip"] is True
    assert (rec["processes"], rec["devices"], rec["scale"]) == (2, 2, SCALE)
    assert rec["dispatches_per_level_max"] <= 2

    src, dst = rmat_edges(SCALE, 16, seed=2)
    snap = snap_mod.from_arrays(1 << SCALE, np.concatenate([src, dst]),
                                np.concatenate([dst, src]))
    source = int(np.argmax(snap.out_degree))
    dist, levels = JS.frontier_bfs_hybrid_sharded(snap, source,
                                                  vertex_mesh(2))
    assert rec["levels"] == levels
    assert rec["reached"] == int((np.asarray(dist) < (1 << 30)).sum())
    bu = [p["bu_trail"] for p in JS.LAST_PROFILE if p["mode"] == "bu"]
    assert rec["bu_levels_fused"] == len(bu) and rec["bu_trails"] == bu


def test_a_difference_exits_2(monkeypatch, capsys):
    """main() exits 2 when rank 0's dist differs from the single card's
    (the record is printed either way)."""
    from titan_tpu_torch.parallel import multihost as M

    monkeypatch.setattr(M, "launch", lambda *a, **k: {
        "bit_equal_vs_single_chip": False})
    assert M.main(["--device", "cpu"]) == 2
    assert capsys.readouterr().out.startswith("MULTIHOST_OK ")
    monkeypatch.setattr(M, "launch", lambda *a, **k: {
        "bit_equal_vs_single_chip": True})
    assert M.main(["--device", "cpu"]) == 0


def test_a_failing_rank_raises_with_its_traceback():
    """A rank that raises while its peer waits in a collective ends the
    launch with RuntimeError carrying the rank's traceback, no hang."""
    import pytest

    import torch_mesh_worker as W
    from titan_tpu_torch.parallel.multihost import launch

    with pytest.raises(RuntimeError, match="rank 1 failed(.|\n)*rank 1 "
                                           "fails"):
        launch(W.fail_on_rank_1, 2, "cpu", timeout=120)
