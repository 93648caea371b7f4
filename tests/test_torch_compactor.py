"""The port's EpochCompactor (titan_tpu_torch.olap.live.compactor) against
the JAX package's, on the CPU.

Both packages compact the same snapshot under the same overlay: the modes,
the merged snapshots (device CSR, host arrays, lazy mirror, carried-over
fields), the fallback reasons and the ``serving.live.*`` counters must be
equal, every reason of the loud host fallback included; the HBM ledger's
double buffer must take the same steps; and a two-epoch chain keeps the
out-CSR cache incremental."""

import numpy as np
import pytest
import torch

import titan_tpu.models.bfs_hybrid as JH
import titan_tpu.ops.epoch_merge as JM
from titan_tpu.olap.live import compactor as JC
from titan_tpu.olap.live.overlay import DeltaOverlay as JaxOverlay
from titan_tpu.olap.serving import hbm as JHBM
from titan_tpu.olap.tpu import snapshot as JS
from titan_tpu.utils.metrics import MetricManager as JaxMetrics
import titan_tpu_torch.models.bfs_hybrid as PH
import titan_tpu_torch.ops.epoch_merge as PM
from titan_tpu_torch.olap import snapshot as PS
from titan_tpu_torch.olap.live import DeltaOverlay, EpochCompactor
from titan_tpu_torch.olap.live import compactor as PC
from titan_tpu_torch.olap.serving import hbm as PHBM
from titan_tpu_torch.utils.metrics import MetricManager

N, M, SEED = 192, 900, 42
CPU = torch.device("cpu")
COUNTERS = ("serving.live.upload_bytes", "serving.live.download_bytes",
            "serving.live.device_merge_fallbacks")


def pair(seed=SEED, labeled=False, adds=60, removes=20, kill=False,
         resident=True, n=N, m=M):
    """The same snapshot and the same overlay in both packages; with
    ``resident`` each package's chunked CSR is built (the device path's
    precondition)."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, m).astype(np.int32)
    dst = rng.integers(0, n, m).astype(np.int32)
    labs = rng.integers(0, 3, m).astype(np.int32) if labeled else None
    js = JS.from_arrays(n, src, dst, labels=labs)
    ps = PS.from_numpy(js)
    jo = JaxOverlay(js, min_cap=64)
    po = DeltaOverlay(ps, min_cap=64, device="cpu")
    a = (rng.integers(0, n, adds).astype(np.int32),
         rng.integers(0, n, adds).astype(np.int32),
         rng.integers(0, 3, adds).astype(np.int32))
    rm = rng.choice(m, removes, replace=False) if m else []
    for ov in (jo, po):
        if adds:
            ov.append_edges(*a)
        for i in rm:
            ov.remove_edge(int(src[i]), int(dst[i]),
                           int(labs[i]) if labs is not None else None)
        if kill:
            assert ov.remove_edge(int(a[0][1]), int(a[1][1]), int(a[2][1]))
    if resident:
        JH.build_chunked_csr(js)
        PH.build_chunked_csr(ps, "cpu")
    return js, jo, ps, po


def compact_both(js, jo, ps, po, jkw=None, pkw=None, **kw):
    """Compact in both packages; returns the two (merged, mode) pairs,
    the compactors and the two metric registries."""
    jc = JC.EpochCompactor(**(jkw or {}))
    pc = EpochCompactor(device="cpu", **(pkw or {}))
    jm, pm = JaxMetrics(), MetricManager()
    jout = jc.compact(js, jo, metrics=jm, **kw)
    pout = pc.compact(ps, po, metrics=pm, **kw)
    return jout, pout, jc, pc, jm, pm


def same_counters(jm, pm):
    for name in COUNTERS:
        assert jm.counter_value(name) == pm.counter_value(name), name


def same_telemetry(jc, pc):
    assert jc.policy() == pc.policy()
    assert (jc.last_mode, jc.device_merges, jc.host_merges,
            jc.fallbacks) == (pc.last_mode, pc.device_merges,
                              pc.host_merges, pc.fallbacks)


def same_snapshot(jm, pm):
    for attr in ("src", "dst", "indptr_in", "out_degree", "vertex_ids"):
        a, b = getattr(jm, attr), getattr(pm, attr)
        assert a.dtype == b.dtype and np.array_equal(a, b), attr
    assert (jm.labels is None) == (pm.labels is None)
    if pm.labels is not None:
        assert np.array_equal(jm.labels, pm.labels)
    assert (jm.epoch, jm._build_params) == (pm.epoch, pm._build_params)


@pytest.mark.parametrize("adds,removes,labeled,kill", [
    (120, 40, False, True), (120, 40, True, True), (120, 0, False, False),
    (0, 60, True, False), (300, 10, False, False)])
@pytest.mark.parametrize("seed", [1, SEED])
def test_device_compaction_equals_jax(seed, adds, removes, labeled, kill):
    js, jo, ps, po = pair(seed, labeled, adds, removes, kill)
    (jmerged, jmode), (pmerged, pmode), jc, pc, jm, pm = \
        compact_both(js, jo, ps, po)
    assert jmode == pmode == "device"
    same_telemetry(jc, pc)
    same_counters(jm, pm)
    same_snapshot(jmerged, pmerged)
    jg, pg = jmerged._hybrid_csr, pmerged._hybrid_csr_by_device[CPU]
    assert pg["q_total"] == jg["q_total"]
    for k in ("dstT", "colstart", "degc", "deg"):
        assert np.array_equal(pg[k].numpy(), np.asarray(jg[k])), k
    # the host oracle, built from scratch
    oracle = pc.merge(ps, po)
    same_snapshot(oracle, pmerged)
    og = PH.build_chunked_csr(oracle, "cpu")
    for k in ("dstT", "colstart", "degc", "deg"):
        assert torch.equal(pg[k], og[k]), k
    for k in ("dstT", "colstart", "degc"):
        assert np.array_equal(pg["_host"][k], jg["_host"][k]), k
    assert np.array_equal(pg["_host"]["dstT"], og["dstT"].numpy())
    hist = pm.histogram("serving.live.compact_device_ms")
    assert hist.count == 1 and jm.histogram(
        "serving.live.compact_device_ms").count == 1


def test_carry_over_of_vertex_values_and_epoch():
    js, jo, ps, po = pair()
    vals = (np.array(["x"] * N, object), np.ones(N, bool))
    for s in (js, ps):
        s.vertex_values["name"] = vals
        s.epoch = 7
        s._build_params = {"labels": None}
    for host_only in (False, True):
        (jmerged, jmode), (pmerged, pmode), *_ = compact_both(
            js, jo, ps, po, host_only=host_only)
        assert jmode == pmode == ("host" if host_only else "device")
        assert pmerged.vertex_values == {"name": vals}
        assert pmerged.vertex_values is not ps.vertex_values
        assert (pmerged.epoch, pmerged._build_params) == \
            (jmerged.epoch, jmerged._build_params) == (7, {"labels": None})


def test_policy_and_should_compact_equal_jax():
    js, jo, ps, po = pair(adds=0, removes=0)
    for kw in ({}, {"max_fill": 0.25, "max_tomb_fraction": 0.125},
               {"device_merge": False, "verify_device": True}):
        jc, pc = JC.EpochCompactor(**kw), EpochCompactor(device="cpu", **kw)
        assert jc.policy() == pc.policy()
        assert jc.should_compact(jo) == pc.should_compact(po) is False
    rng = np.random.default_rng(3)
    for step in range(6):
        a = (rng.integers(0, N, 12).astype(np.int32),
             rng.integers(0, N, 12).astype(np.int32),
             np.zeros(12, np.int32))
        jo.append_edges(*a)
        po.append_edges(*a)
        assert jc.should_compact(jo) == pc.should_compact(po), step
    assert (JC.MAX_FILL, JC.MAX_TOMB_FRACTION) == \
        (PC.MAX_FILL, PC.MAX_TOMB_FRACTION)


# -- the loud host fallback: each reason, as in JAX ----------------------------

def _raise_boom(*a, **k):
    raise RuntimeError("boom")


def _wrong_mirror(self):
    return np.zeros((8, 1), np.int32)


@pytest.mark.parametrize("case", ["apply-path", "base-not-resident",
                                  "empty-base", "int32-overflow",
                                  "kernel", "verify-mismatch", "disabled"])
def test_fallback_reasons_and_counters_equal_jax(case, monkeypatch):
    kw, jkw, pkw = {}, {}, {}
    if case == "empty-base":
        js, jo, ps, po = pair(m=0, n=8, adds=6, removes=0)
    else:
        js, jo, ps, po = pair(resident=case != "base-not-resident")
    if case == "apply-path":
        kw["host_only"] = True
    elif case == "int32-overflow":
        monkeypatch.setattr(JM, "fits_int32", lambda q: False)
        monkeypatch.setattr(PM, "fits_int32", lambda q: False)
    elif case == "kernel":
        monkeypatch.setattr(JM, "merge_chunked_csr", _raise_boom)
        monkeypatch.setattr(PM, "merge_chunked_csr", _raise_boom)
    elif case == "verify-mismatch":
        monkeypatch.setattr(JM.LazyHostMirror, "_build_dstT", _wrong_mirror)
        monkeypatch.setattr(PM.LazyHostMirror, "_build_dstT", _wrong_mirror)
        jkw = pkw = {"verify_device": True}
    elif case == "disabled":
        jkw = pkw = {"device_merge": False}
    (jmerged, jmode), (pmerged, pmode), jc, pc, jm, pm = compact_both(
        js, jo, ps, po, jkw, pkw, **kw)
    assert jmode == pmode == "host"
    want = {"kernel": "kernel: RuntimeError: boom",
            "disabled": None}.get(case, case)
    assert pc.fallbacks == ({} if want is None else {want: 1})
    same_telemetry(jc, pc)
    same_counters(jm, pm)
    assert pm.counter_value("serving.live.device_merge_fallbacks") == \
        (0 if want is None else 1)
    # the host path charges the whole image's upload to the epoch
    assert pm.counter_value("serving.live.upload_bytes") >= \
        PHBM.snapshot_csr_bytes(pmerged)
    assert not pmerged._hybrid_csr_by_device
    same_snapshot(jmerged, pmerged)


def test_verify_device_charges_the_download():
    js, jo, ps, po = pair(adds=40, removes=10)
    (_, jmode), (pmerged, pmode), jc, pc, jm, pm = compact_both(
        js, jo, ps, po, {"verify_device": True}, {"verify_device": True})
    assert jmode == pmode == "device"
    same_counters(jm, pm)
    assert pm.counter_value("serving.live.download_bytes") == \
        pmerged._hybrid_csr_by_device[CPU]["dstT"].numel() * 4


# -- the ledger's double buffer ------------------------------------------------

class _Log:
    """A ledger wrapper that logs each call, keys made comparable across
    packages (the compactor's reservation key and the merged snapshot's
    id)."""

    def __init__(self, ledger):
        self.ledger, self.log, self.names = ledger, [], {}

    def _name(self, key):
        if isinstance(key, tuple):
            return key[0]
        return self.names.setdefault(key, f"snap{len(self.names)}")

    def reserve(self, key, nbytes):
        self.log.append(("reserve", self._name(key), nbytes))
        self.ledger.reserve(key, nbytes)

    def release(self, key):
        self.log.append(("release", self._name(key)))
        self.ledger.release(key)

    def unpin(self, key):
        self.log.append(("unpin", self._name(key)))
        self.ledger.unpin(key)


def test_double_buffer_keys_and_bytes_equal_jax():
    js, jo, ps, po = pair(adds=50, removes=10)
    jl = _Log(JHBM.HBMLedger(budget_bytes=10e6))
    pl = _Log(PHBM.HBMLedger(budget_bytes=10e6, device="cpu"))
    for log, s, mod in ((jl, js, JHBM), (pl, ps, PHBM)):
        # the current epoch is ledger-resident as a served image is
        log.reserve(id(s), mod.snapshot_csr_bytes(s))
        log.unpin(id(s))
    before = pl.ledger.resident_bytes()
    jmerged, jmode = JC.EpochCompactor().compact(js, jo, ledger=jl)
    pc = EpochCompactor(device="cpu")
    pmerged, pmode = pc.compact(ps, po, ledger=pl)
    assert jmode == pmode == "device"
    assert jl.log == pl.log
    assert [e[0] for e in pl.log[2:]] == ["reserve", "release", "reserve",
                                          "unpin"]
    assert pl.log[2][1] == "live-epoch-next"
    # both epochs resident (double-buffered) until the old one retires
    assert pl.ledger.resident_bytes() > before
    pl.ledger.release(id(ps))
    assert pl.ledger.resident_bytes() == PHBM.snapshot_csr_bytes(pmerged)
    assert pl.ledger.pinned_bytes() == 0
    pl.ledger.reserve(id(pmerged), PHBM.snapshot_csr_bytes(pmerged))
    assert pl.ledger.pinned_bytes() == PHBM.snapshot_csr_bytes(pmerged)


def test_ledger_full_degrades_loudly_like_jax():
    js, jo, ps, po = pair(adds=50, removes=10)
    jl = JHBM.HBMLedger(budget_bytes=16)
    pl = PHBM.HBMLedger(budget_bytes=16, device="cpu")
    jc, pc = JC.EpochCompactor(), EpochCompactor(device="cpu")
    jm, pm = JaxMetrics(), MetricManager()
    jmerged, jmode = jc.compact(js, jo, ledger=jl, metrics=jm)
    pmerged, pmode = pc.compact(ps, po, ledger=pl, metrics=pm)
    assert jmode == pmode == "host"
    assert pc.fallbacks == jc.fallbacks == {"ledger-full": 1}
    same_counters(jm, pm)
    assert pl.resident_bytes() == 0 and not pmerged._hybrid_csr_by_device


def test_kernel_failure_releases_the_reservation(monkeypatch):
    js, jo, ps, po = pair()
    monkeypatch.setattr(PM, "merge_chunked_csr", _raise_boom)
    pl = PHBM.HBMLedger(budget_bytes=10e6, device="cpu")
    pc = EpochCompactor(device="cpu")
    _, mode = pc.compact(ps, po, ledger=pl)
    assert mode == "host" and pl.resident_bytes() == 0


def test_on_resident_sees_the_published_epoch():
    js, jo, ps, po = pair()
    seen = []
    merged, mode = EpochCompactor(device="cpu").compact(
        ps, po, on_resident=seen.append)
    assert mode == "device" and seen == [merged]


# -- two epochs ----------------------------------------------------------------

def test_two_epoch_chain_keeps_out_csr_incremental():
    """Epoch 1 compacts on the device and publishes a snapshot whose
    out-CSR cache is attached; epoch 2's overlay reads it without a sort
    and compacts again on the device, bit-equal to JAX's chain."""
    js, jo, ps, po = pair(adds=24, removes=12, labeled=True)
    rng = np.random.default_rng(11)
    jc, pc = JC.EpochCompactor(), EpochCompactor(device="cpu")
    for epoch in range(2):
        jmerged, jmode = jc.compact(js, jo)
        pmerged, pmode = pc.compact(ps, po)
        assert jmode == pmode == "device", epoch
        same_snapshot(jmerged, pmerged)
        assert pmerged._out_csr is not None
        fresh = PS.GraphSnapshot(pmerged.n, pmerged.vertex_ids, pmerged.src,
                                 pmerged.dst, pmerged.indptr_in,
                                 pmerged.out_degree, {}, pmerged.labels,
                                 dict(pmerged.label_names))
        dbs, ip = fresh.out_csr()
        assert np.array_equal(pmerged._out_csr[0], dbs)
        assert np.array_equal(pmerged._out_csr[1], ip)
        assert np.array_equal(pmerged._out_csr_order, fresh._out_csr_order)
        js, ps = jmerged, pmerged
        jo = JaxOverlay(js, min_cap=64)
        po = DeltaOverlay(ps, min_cap=64, device="cpu")
        assert po._base_order() is ps._out_csr_order
        a = (rng.integers(0, N, 30).astype(np.int32),
             rng.integers(0, N, 30).astype(np.int32),
             rng.integers(0, 3, 30).astype(np.int32))
        rm = rng.choice(ps.num_edges, 9, replace=False)
        for ov in (jo, po):
            ov.append_edges(*a)
            for i in rm:
                assert ov.remove_edge(int(ps.src[i]), int(ps.dst[i]),
                                      int(ps.labels[i]))
    assert pc.device_merges == jc.device_merges == 2
