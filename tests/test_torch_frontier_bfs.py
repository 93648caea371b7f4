"""The port's push-frontier BFS (titan_tpu_torch.models.bfs:
frontier_bfs, frontier_bfs_tiled and their steps) against the JAX
package's on shared snapshots, on the CPU: ``dist`` and ``levels``
bit-equal, the shards and every level's slice plan equal, the same
truncation error and 2^31 refusal, and the port's device caches under
its own names, dropped by ``refresh()``. The tiny-tile cases are those of
tests/test_frontier_bfs.py."""

import numpy as np
import pytest
import torch

import titan_tpu.models.bfs as JB
import titan_tpu_torch.models.bfs as PB
from titan_tpu.olap.tpu import snapshot as snap_mod
from titan_tpu.olap.tpu.rmat import rmat_edges
from titan_tpu_torch.olap import engine as PE
from titan_tpu_torch.olap import snapshot as PS
from titan_tpu_torch.parallel.multihost import launch

import torch_mesh_worker as W

INF = 1 << 30


def _random(seed, directed=True, lo=30, hi=600, ef=5):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(lo, hi))
    e = int(rng.integers(10, n * ef))
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.integers(0, n, e).astype(np.int32)
    if not directed:
        src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
    return snap_mod.from_arrays(n, src, dst), src, dst


def _rmat(scale):
    src, dst = rmat_edges(scale, 16, seed=scale)
    return snap_mod.from_arrays(1 << scale, np.concatenate([src, dst]),
                                np.concatenate([dst, src]))


def _chain(n=300):
    src = np.arange(n - 1, dtype=np.int32)
    return snap_mod.from_arrays(n, src, src + 1)


def _same_plain(snap, source, **kw):
    dj, lj = JB.frontier_bfs(snap, source, **kw)
    dp, lp = PB.frontier_bfs(snap, source, device="cpu", **kw)
    assert np.array_equal(np.asarray(dj), dp) and lj == lp
    return dp, lp


def _same_tiled(snap, source, **kw):
    dj, lj = JB.frontier_bfs_tiled(snap, source, **kw)
    dp, lp = PB.frontier_bfs_tiled(snap, source, device="cpu", **kw)
    assert np.array_equal(np.asarray(dj), dp) and lj == lp
    return dp, lp


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_frontier_bfs_random_directed(seed):
    snap, src, _ = _random(seed)
    dist, levels = _same_plain(snap, int(src[0]))
    assert levels >= int(dist[dist < INF].max())


@pytest.mark.parametrize("scale", [8, 10, 12, 14])
def test_frontier_bfs_and_tiled_rmat(scale):
    snap = _rmat(scale)
    source = int(np.flatnonzero(snap.out_degree > 0)[0])
    d1, l1 = _same_plain(snap, source)
    d2, l2 = _same_tiled(snap, source)
    assert np.array_equal(d1, d2) and l1 == l2


def test_the_192_vertex_shape():
    rng = np.random.default_rng(42)
    src, dst = rng.integers(0, 192, 900), rng.integers(0, 192, 900)
    snap = snap_mod.from_arrays(192, np.concatenate([src, dst]),
                                np.concatenate([dst, src]))
    for source in (0, 7, 191):
        _same_plain(snap, source)
        _same_tiled(snap, source, f_tile=16, m_tile=64, max_shard_edges=300)


def test_isolated_source_and_chain():
    snap = snap_mod.from_arrays(5, np.array([1, 2], np.int32),
                                np.array([2, 3], np.int32))
    dist, levels = _same_plain(snap, 0)
    assert levels == 0 and dist[0] == 0 and (dist[1:] >= INF).all()
    _same_tiled(snap, 0)
    dist, levels = _same_plain(_chain(), 0)
    assert levels == 299 and np.array_equal(dist, np.arange(300))


@pytest.mark.parametrize("max_levels", [0, 1, 3])
def test_max_levels(max_levels):
    snap = _chain(40)
    _same_plain(snap, 0, max_levels=max_levels)
    _same_tiled(snap, 0, max_levels=max_levels, f_tile=4, m_tile=8,
                max_shard_edges=10)


@pytest.mark.parametrize("seed,shards", [(0, 1), (1, 3), (2, 5), (3, 2)])
def test_tiled_tiny_tiles(seed, shards):
    """tests/test_frontier_bfs.py's tiny tiles and shards: several shards,
    several slices a level (edge-budget and frontier-count splits),
    partial last slices."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(50, 700))
    e = int(rng.integers(10, n * 6))
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.integers(0, n, e).astype(np.int32)
    snap = snap_mod.from_arrays(n, src, dst)
    kw = dict(f_tile=16, m_tile=64, max_shard_edges=max(1, e // shards),
              k_max=max(64, 4 * n // 16 + 8))
    _same_tiled(snap, int(src[0]), **kw)
    _check_plans(snap, int(src[0]), **kw)


def test_tiled_hub_heavier_than_tile():
    n = 200
    hub = np.arange(1, 150, dtype=np.int32)
    src = np.concatenate([np.zeros(len(hub), np.int32), [150]])
    dst = np.concatenate([hub, [151]]).astype(np.int32)
    snap = snap_mod.from_arrays(n, src.astype(np.int32), dst)
    kw = dict(f_tile=8, m_tile=16, max_shard_edges=64)
    _same_tiled(snap, 0, **kw)
    _check_plans(snap, 0, **kw)
    t = PB.tile_params(snap, 8, 16, 64, 96, "cpu")
    assert t["m_tile"] == 2 * 149 and t["budget"] == 149


def test_tiled_chain_many_levels():
    dist, levels = _same_tiled(_chain(), 0, f_tile=4, m_tile=8,
                               max_shard_edges=50)
    assert levels == 299 and dist[-1] == 299


def _check_plans(snap, source, f_tile, m_tile, max_shard_edges, k_max=96):
    """Every level's wrapup (next frontier, slice plan, stats) and the
    shards equal JAX's, fed the same dist."""
    import jax.numpy as jnp

    dist, levels = PB.frontier_bfs_tiled(
        snap, source, f_tile=f_tile, m_tile=m_tile,
        max_shard_edges=max_shard_edges, k_max=k_max, device="cpu")
    t = PB.tile_params(snap, f_tile, m_tile, max_shard_edges, k_max, "cpu")
    bounds, block, e_max, shards = JB._shard_out_csr_balanced(
        snap, max_shard_edges)
    assert (bounds, block, e_max) == (t["bounds"], t["block"], t["e_max"])
    for (bj, *aj), (bp, *ap) in zip(shards, t["shards"]):
        assert bj == bp
        for x, y in zip(aj, ap):
            assert np.array_equal(np.asarray(x), y.numpy())
    outdeg = snap.out_degree.astype(np.int32)
    wrap = JB._tile_wrapup()
    for level in range(-1, levels + 1):
        d = np.where(dist <= level + 1, dist, INF).astype(np.int32)
        d = np.concatenate([d, [INF]]).astype(np.int32)
        fj, pj, sj = wrap(jnp.asarray(d), jnp.int32(level),
                          jnp.asarray(outdeg), f_tile=t["f_tile"],
                          budget=t["budget"], k_max=t["k_max"], n_=snap.n,
                          shard_bounds=t["bounds"])
        fp, pp, sp = PB._tile_wrapup(torch.from_numpy(d), level,
                                     torch.from_numpy(outdeg), t["f_tile"],
                                     t["budget"], t["k_max"], snap.n,
                                     t["bounds"])
        assert pp.shape == (len(t["bounds"]) - 1, 2, t["k_max"] + 1)
        assert np.array_equal(np.asarray(pj), pp.numpy()), level
        assert np.array_equal(np.asarray(fj), fp.numpy())
        assert np.array_equal(np.asarray(sj), sp.numpy())


def test_tile_sizes_are_the_jax_ladder():
    assert PB.tile_sizes(1 << 21, 1 << 27) == (
        [1 << 14, 1 << 18, 1 << 21], [1 << 18, 1 << 21, 1 << 24, 1 << 27])
    assert PB.tile_sizes(16, 300) == ([16], [300])


@pytest.mark.parametrize("seed", range(6))
def test_expand_neighbors_drops_starts_past_m_cap(seed):
    """The expansion's delta-scatter drops a start at or past m_cap
    (JAX's mode="drop") instead of clamping it onto the last live lane."""
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    f = 24
    dst = rng.integers(0, 50, 120).astype(np.int32)
    degs = rng.integers(0, 9, f).astype(np.int32)
    indptr = rng.integers(0, 110, f).astype(np.int32)
    mask = rng.random(f) < 0.8
    for m_cap in (4, 16, 37, 64, 256):
        want = JB._expand_neighbors(jnp.asarray(mask), jnp.asarray(degs),
                                    jnp.asarray(indptr), jnp.asarray(dst),
                                    m_cap, 50)
        got = PB._expand_neighbors(torch.from_numpy(mask),
                                   torch.from_numpy(degs),
                                   torch.from_numpy(indptr),
                                   torch.from_numpy(dst), m_cap, 50)
        assert np.array_equal(np.asarray(want), got.numpy()), m_cap


def test_the_truncation_check_raises_like_jax(monkeypatch):
    """A plan whose spare slot advanced raises the same RuntimeError in
    both packages (the wrapups are made to advance it)."""
    snap, src, _ = _random(7)
    real_j, real_p = JB._tile_wrapup(), PB._tile_wrapup

    def spoil_j(*a, **kw):
        fr, plan, stats = real_j(*a, **kw)
        return fr, plan.at[:, 0, -1].add(1), stats

    def spoil_p(*a, **kw):
        fr, plan, stats = real_p(*a, **kw)
        plan[:, 0, -1] += 1
        return fr, plan, stats

    monkeypatch.setattr(JB, "_TILE_WRAPUP", spoil_j)
    monkeypatch.setattr(PB, "_tile_wrapup", spoil_p)
    errs = []
    for fn, kw in ((JB.frontier_bfs_tiled, {}),
                   (PB.frontier_bfs_tiled, {"device": "cpu"})):
        with pytest.raises(RuntimeError, match="slice plan truncated") as e:
            fn(snap, int(src[0]), **kw)
        errs.append(str(e.value))
    assert errs[0] == errs[1]


class _Huge:
    """A snapshot of 2^31 edges, as far as the refusal looks."""
    n = 4
    num_edges = 1 << 31
    out_degree = np.zeros(4, np.int32)


def test_2_31_edges_are_refused_like_jax():
    errs = []
    for fn, kw in ((JB.frontier_bfs, {}),
                   (PB.frontier_bfs, {"device": "cpu"})):
        with pytest.raises(NotImplementedError, match="2\\^31") as e:
            fn(_Huge(), 0, **kw)
        errs.append(str(e.value))
    assert errs[0] == errs[1]


def test_sharded_entry_points_name_item_9():
    """The sharded entry points are ported: they run over a mesh, which
    needs an initialised process group (none here). The serving plane's
    mesh-placed cohort, item 9b, is ported too: it takes a one-process
    ``LocalMesh``, never a rank's ``VertexMesh``, and its rows equal the
    one-device run's."""
    from titan_tpu_torch.models.bfs_hybrid import (build_chunked_csr,
                                                   frontier_bfs_batched)
    from titan_tpu_torch.parallel.mesh import (VertexMesh, local_mesh,
                                               vertex_mesh)
    from titan_tpu_torch.parallel.partition import place_batched_csr

    snap, _, _ = _random(0)
    with pytest.raises(RuntimeError, match="process group"):
        PB.frontier_bfs_sharded(snap, 0, vertex_mesh(2, device="cpu"))
    with pytest.raises(RuntimeError, match="process group"):
        PE.GPUGraphComputer(snapshot=snap, device="cpu", num_devices=2) \
            .run(PB.BFS(), {"source_dense": 0})
    g = build_chunked_csr(snap, "cpu")
    for mesh in (None, VertexMesh(0, 2, torch.device("cpu"), "gloo")):
        with pytest.raises(TypeError, match="LocalMesh"):
            place_batched_csr(snap, mesh)
    placed = place_batched_csr(g, local_mesh(["cpu"] * 3))
    got = frontier_bfs_batched(placed, [0, 1], device="cpu")
    for a, b in zip(frontier_bfs_batched(g, [0, 1], device="cpu"), got):
        assert np.array_equal(a, b)


def test_caches_are_the_port_s_own_on_a_shared_snapshot():
    """One JAX snapshot handed to both packages: each finds only its own
    caches, and the port's are keyed by device."""
    snap, src, _ = _random(3, directed=False)
    PB.frontier_bfs(snap, int(src[0]), device="cpu")
    PB.frontier_bfs_tiled(snap, int(src[0]), device="cpu",
                          max_shard_edges=200)
    for name in ("_dev_frontier", "_tiled_shards", "_dev_outdeg"):
        assert getattr(snap, name, None) is None
    cpu = torch.device("cpu")
    csr = snap._frontier_csr_by_device[cpu]
    PB.frontier_bfs(snap, int(src[0]), device="cpu")
    assert snap._frontier_csr_by_device[cpu] is csr
    assert snap._tiled_shards_by_device[cpu][0] == 200
    assert cpu in snap._out_degree_by_device
    JB.frontier_bfs(snap, int(src[0]))
    JB.frontier_bfs_tiled(snap, int(src[0]), max_shard_edges=200)
    assert snap._dev_frontier is not None and snap._tiled_shards[0] == 200
    _same_plain(snap, int(src[0]))


def test_refresh_drops_the_push_bfs_caches():
    import titan_tpu_torch
    from titan_tpu_torch.ids.placement import SimpleBulkPlacement

    g = titan_tpu_torch.open("inmemory")
    try:
        g.id_assigner.placement = SimpleBulkPlacement(
            g.idm.num_partitions, batch_size=5, seed=11)
        tx = g.new_transaction()
        vs = [tx.add_vertex("node") for _ in range(12)]
        for a, b in zip(vs, vs[1:]):
            a.add_edge("link", b)
        tx.commit()
        snap = PS.build(g, directed=False)
        before, _ = PB.frontier_bfs(snap, 0, device="cpu")
        PB.frontier_bfs_tiled(snap, 0, device="cpu")
        for name in ("_frontier_csr_by_device", "_tiled_shards_by_device",
                     "_out_degree_by_device"):
            assert name in PS.GraphSnapshot._DEVICE_CACHES
            assert getattr(snap, name)
        tx = g.new_transaction()
        tx.vertex(vs[0].id).add_edge("link", tx.vertex(vs[5].id))
        tx.commit()
        snap.refresh()
        for name in ("_frontier_csr_by_device", "_tiled_shards_by_device",
                     "_out_degree_by_device"):
            assert getattr(snap, name) == {}
        d1, _ = PB.frontier_bfs(snap, 0, device="cpu")
        d2, _ = PB.frontier_bfs_tiled(snap, 0, device="cpu")
        fresh = PS.build(g, directed=False)
        want, _ = PB.frontier_bfs(fresh, 0, device="cpu")
        assert np.array_equal(d1, want) and np.array_equal(d2, want)
        assert not np.array_equal(before, want)
        snap.close()
        fresh.close()
    finally:
        g.close()


def test_a_card_is_required_without_a_device():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    snap, src, _ = _random(0)
    for fn in (PB.frontier_bfs, PB.frontier_bfs_tiled):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn(snap, int(src[0]))


# ---------------------------------------------------------------------------
# the sharded push BFS over gloo ranks, against JAX's at the same mesh size
# ---------------------------------------------------------------------------

def _sharded_cases():
    """The cases of tests/test_frontier_bfs.py's sharded tests: random
    directed graphs (seeds 0 and 5) from a random source, and a chain."""
    out = []
    for seed in (0, 5):
        rng = np.random.default_rng(seed)
        n = int(rng.integers(50, 800))
        e = int(rng.integers(10, n * 6))
        src = rng.integers(0, n, e).astype(np.int32)
        dst = rng.integers(0, n, e).astype(np.int32)
        out.append({"name": f"random{seed}", "n": n, "src": src,
                    "dst": dst, "source": int(rng.integers(0, n))})
    src = np.arange(99, dtype=np.int32)
    out.append({"name": "chain", "n": 100, "src": src, "dst": src + 1,
                "source": 0})
    return out


SHARDED = _sharded_cases()


@pytest.fixture(scope="module", params=(1, 2, 4), ids=lambda d: f"D{d}")
def sharded_runs(request):
    """One launch a world size with every case; JAX's at the same D."""
    from titan_tpu.parallel.mesh import vertex_mesh

    D = request.param
    port = launch(W.push_bfs_cases, D, "cpu", args=(
        [{k: c[k] for k in ("n", "src", "dst", "source")}
         for c in SHARDED],), timeout=240)
    jax = [JB.frontier_bfs_sharded(
        snap_mod.from_arrays(c["n"], c["src"], c["dst"]), c["source"],
        vertex_mesh(D)) for c in SHARDED]
    return port, jax


def _numpy_bfs(n, src, dst, s0):
    dist = np.full(n, INF, np.int64)
    dist[s0] = 0
    front = [s0]
    adj = [[] for _ in range(n)]
    for a, b in zip(src, dst):
        adj[a].append(b)
    while front:
        nxt = []
        for v in front:
            for w in adj[v]:
                if dist[w] == INF:
                    dist[w] = dist[v] + 1
                    nxt.append(w)
        front = nxt
    return dist


@pytest.mark.parametrize("i", range(len(SHARDED)),
                         ids=[c["name"] for c in SHARDED])
def test_frontier_bfs_sharded_equals_jax(sharded_runs, i):
    """dist and levels bit-equal to JAX's at the same D, to the port's
    single-device frontier_bfs and to a plain BFS; the chain's dist is
    its index, in n - 1 levels."""
    port, jax = sharded_runs
    case = SHARDED[i]
    (dp, lp), (dj, lj) = port[i], jax[i]
    assert np.array_equal(dp, np.asarray(dj)) and lp == lj
    snap = PS.from_arrays(case["n"], case["src"], case["dst"])
    ds, _ = PB.frontier_bfs(snap, case["source"], device="cpu")
    assert np.array_equal(dp, ds)
    assert np.array_equal(dp, _numpy_bfs(case["n"], case["src"],
                                         case["dst"], case["source"]))
    if case["name"] == "chain":
        assert np.array_equal(dp, np.arange(100)) and lp == 99


@pytest.mark.parametrize("D", [1, 2, 3, 4, 8])
def test_shard_out_csr_rows_equal_jax(D):
    """Each rank's block of the out-CSR is the JAX package's row of it."""
    case = SHARDED[0]
    js = snap_mod.from_arrays(case["n"], case["src"], case["dst"])
    block, e_max, dst_sh, ip_sh, deg_sh = JB._shard_out_csr(js, D)
    ps = PS.from_numpy(js)
    for d in range(D):
        got = PB._shard_out_csr(ps, D, d)
        assert got[:2] == (block, e_max)
        for a, b in zip(got[2:], (dst_sh[d], ip_sh[d], deg_sh[d])):
            assert np.array_equal(a, b)
