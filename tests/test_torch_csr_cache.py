"""The port's chunked CSR is cached on the snapshot, per device, as the
JAX package caches its own (``snap._hybrid_csr_by_device`` beside JAX's
``snap._hybrid_csr``): a second call returns the same tensors, deleting
the attribute rebuilds, the upload counts once on ``obs/devprof``'s
``bfs.chunked_csr`` H2D site, and a snapshot handed to both packages
keeps both caches apart."""

import numpy as np
import pytest
import torch

from titan_tpu.models import bfs_hybrid as H
from titan_tpu.olap.tpu import snapshot as JS
from titan_tpu_torch.models import bfs_hybrid as P
from titan_tpu_torch.obs import devprof
from titan_tpu_torch.olap import snapshot as SN
from titan_tpu_torch.olap.serving.hbm import snapshot_csr_bytes
from titan_tpu_torch.utils.metrics import MetricManager

KEYS = ("dstT", "colstart", "degc", "deg")


def _snap(seed=42, n=192, m=900):
    rng = np.random.default_rng(seed)
    s = rng.integers(0, n, m)
    d = rng.integers(0, n, m)
    return SN.from_arrays(n, np.concatenate([s, d]), np.concatenate([d, s]))


def _h2d(m, site="bfs.chunked_csr"):
    return m.counter_value("device.xfer.h2d_bytes", labels={"site": site})


def test_second_call_returns_the_same_tensors():
    snap = _snap()
    a = P.build_chunked_csr(snap, "cpu")
    b = P.build_chunked_csr(snap, "cpu")
    assert a is b
    for k in KEYS:
        assert a[k].data_ptr() == b[k].data_ptr()
    assert set(snap._hybrid_csr_by_device) == {torch.device("cpu")}


def test_delete_the_attribute_rebuilds_equal_arrays():
    snap = _snap()
    a = P.build_chunked_csr(snap, "cpu")
    del snap._hybrid_csr_by_device
    b = P.build_chunked_csr(snap, "cpu")
    assert b is not a
    for k in KEYS:
        assert b[k].data_ptr() != a[k].data_ptr()
        assert torch.equal(a[k], b[k])
    assert snap._hybrid_csr_by_device[torch.device("cpu")] is b


def test_keyed_by_device():
    """A CPU build and another device's build never share a dict: a
    cached entry for another device is ignored and kept."""
    snap = _snap()
    other = torch.device("meta")
    sentinel = {"n": -1}
    snap._hybrid_csr_by_device[other] = sentinel
    g = P.build_chunked_csr(snap, "cpu")
    assert g is not sentinel and g["dstT"].device.type == "cpu"
    assert snap._hybrid_csr_by_device[other] is sentinel
    assert snap._hybrid_csr_by_device[torch.device("cpu")] is g


def test_equal_to_the_jax_layout_and_to_the_ledger_prediction():
    snap = _snap(7)
    g = P.build_chunked_csr(snap, "cpu")
    j = H.build_chunked_csr(JS.from_arrays(snap.n, snap.src, snap.dst))
    for k in KEYS:
        assert np.array_equal(g[k].numpy(), np.asarray(j[k])), k
    assert g["q_total"] == j["q_total"]
    assert sum(g[k].numel() * g[k].element_size() for k in KEYS) == \
        snapshot_csr_bytes(snap)


class _Slotted:
    """A duck-typed snapshot that cannot take the cache attribute."""

    __slots__ = ("n", "out_degree", "_s")

    def __init__(self, snap):
        self.n, self.out_degree, self._s = snap.n, snap.out_degree, snap

    def out_csr(self):
        return self._s.out_csr()


def test_duck_typed_snapshot_without_the_attribute_still_builds():
    snap = _snap()
    duck = _Slotted(snap)
    a = P.build_chunked_csr(duck, "cpu")
    b = P.build_chunked_csr(duck, "cpu")
    assert a is not b
    assert torch.equal(a["dstT"], P.build_chunked_csr(snap, "cpu")["dstT"])
    dist, _ = P.frontier_bfs_hybrid(duck, 0, device="cpu")
    ref, _ = P.frontier_bfs_hybrid(snap, 0, device="cpu")
    assert np.array_equal(dist, ref)


def test_one_h2d_count_across_two_batched_runs():
    snap = _snap()
    m = MetricManager()
    with devprof.DeviceCostProfiler(metrics=m):
        d1, _, _ = P.frontier_bfs_batched(snap, [0, 5, 9], device="cpu")
        d2, _, _ = P.frontier_bfs_batched(snap, [1, 2], device="cpu")
    assert _h2d(m) == snapshot_csr_bytes(snap)
    assert m.counter_value("device.xfer.h2d_bytes") == \
        snapshot_csr_bytes(snap)
    for i, s in enumerate([0, 5, 9]):
        ref, _ = P.frontier_bfs_hybrid(snap, s, device="cpu")
        assert np.array_equal(d1[i], ref)


@pytest.mark.parametrize("attr", ["_hybrid_csr_by_device",
                                  "_device_graphs"])
def test_fault_eviction_clears_the_device_caches(attr):
    from titan_tpu_torch.olap.engine import device_graph
    from titan_tpu_torch.olap.recovery import FaultPlan, SnapshotEvicted

    snap = _snap()
    P.build_chunked_csr(snap, "cpu")
    device_graph(snap, "cpu")
    assert getattr(snap, attr)
    with pytest.raises(SnapshotEvicted):
        FaultPlan(evict_at_round=1).check(1, 1, snap)
    assert getattr(snap, attr) == {}


@pytest.mark.parametrize("first", ["jax", "port"])
def test_one_snapshot_serves_both_packages(first):
    """Either package may build first on a shared snapshot; each then
    finds its own cache, and BFS from both agrees."""
    snap = _snap(11)
    calls = [lambda: H.build_chunked_csr(snap),
             lambda: P.build_chunked_csr(snap, "cpu")]
    if first == "port":
        calls.reverse()
    for c in calls:
        c()
    assert set(snap._hybrid_csr_by_device) == {torch.device("cpu")}
    assert "dstT" in snap._hybrid_csr
    jd, _, _ = H.frontier_bfs_batched(snap, [0, 3])
    pd, _, _ = P.frontier_bfs_batched(snap, [0, 3], device="cpu")
    assert np.array_equal(np.asarray(jd), pd)
