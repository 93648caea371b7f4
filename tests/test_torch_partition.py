"""The port's partitioning (titan_tpu_torch.parallel.partition and the
block layout of models/bfs_hybrid_sharded) against the JAX package's:
``plan_shard_cuts`` and its int32 guard, ``block_layout().describe()``,
every rank's ``pack_shard_block`` against the rows of JAX's
``shard_chunked_csr``, ``shard_csr`` against JAX's, and then, in gloo
ranks on the CPU at D in {1, 2, 4}, each rank's device blocks and
``exchange_found``'s ids and counts against JAX's ``exchange_found``
under ``shard_map`` at the same D."""

import json

import numpy as np
import pytest

import torch_mesh_worker as W
from titan_tpu.models import bfs_hybrid_sharded as JS
from titan_tpu.models.bfs_hybrid import build_chunked_csr
from titan_tpu.olap.tpu import snapshot as snap_mod
from titan_tpu.olap.tpu.rmat import rmat_edges
from titan_tpu.parallel import partition as JP
from titan_tpu_torch.models import bfs_hybrid_sharded as S
from titan_tpu_torch.models.bfs_hybrid import chunked_layout
from titan_tpu_torch.olap import snapshot as PS
from titan_tpu_torch.parallel import partition as P
from titan_tpu_torch.parallel.multihost import launch

SHARDS = (1, 2, 3, 4, 8)


def _graph(kind: str):
    """(n, src, dst, edge_values) of a symmetric graph."""
    if kind == "rmat9":
        src, dst = rmat_edges(9, 8, seed=3)
        n = 1 << 9
    else:                      # the serving shape, n + 1 = 256
        rng = np.random.default_rng(42)
        n = 255
        src, dst = rng.integers(0, n, 900), rng.integers(0, n, 900)
    src, dst = np.asarray(src, np.int32), np.asarray(dst, np.int32)
    s2, d2 = np.concatenate([src, dst]), np.concatenate([dst, src])
    w = np.random.default_rng(1).uniform(0.1, 10.0, len(s2))
    return n, s2, d2, {"weight": w.astype(np.float32)}


GRAPHS = ("rmat9", "serving")


def _pair(kind):
    n, src, dst, ev = _graph(kind)
    js = snap_mod.from_arrays(n, src, dst, edge_values=ev)
    return js, PS.from_numpy(js)


# ------------------------------------------------------------- no spawn

@pytest.mark.parametrize("D", SHARDS)
@pytest.mark.parametrize("seed", [0, 7])
def test_plan_shard_cuts_and_layout_equal_jax(seed, D):
    rng = np.random.default_rng(seed)
    n = 1 << 9
    degc = rng.integers(0, 5, n).astype(np.int64)
    degc[rng.integers(0, n, 3)] = 300                 # a few hubs
    colstart = np.zeros(n + 1, np.int64)
    np.cumsum(degc, out=colstart[1:])
    a, b = S.plan_shard_cuts(colstart, n, D), JS.plan_shard_cuts(
        colstart, n, D)
    assert np.array_equal(a[0], b[0]) and a[1:] == b[1:]
    la = P.block_layout(colstart, degc.astype(np.int32), n, D)
    lb = JP.block_layout(colstart, degc.astype(np.int32), n, D)
    assert la.describe() == lb.describe()
    assert la.bounds == lb.bounds and la.live_shards == lb.live_shards
    assert [la.block_window(d) for d in range(D)] == \
        [lb.block_window(d) for d in range(D)]
    json.dumps(la.describe())
    assert la.bounds[0] == 0 and la.bounds[-1] == n and len(la.bounds) == D + 1


@pytest.mark.parametrize("D", SHARDS)
@pytest.mark.parametrize("kind", GRAPHS)
def test_pack_shard_block_equals_jax_rows(kind, D):
    """Each rank's packed block is JAX's ``shard_chunked_csr`` row d, from
    a snapshot and from a host graph dict."""
    js, ps = _pair(kind)
    ref = JS.shard_chunked_csr(build_chunked_csr(js), D)
    host = S.shard_chunked_csr(ps, D)
    for k in ("n", "b_max", "q_max", "q_total", "total_chunks",
              "shard_chunks", "nunv_chip_max"):
        assert host[k] == ref[k], k
    assert np.array_equal(host["bounds"], ref["bounds"])
    assert np.array_equal(host["degc"], ref["degc"])
    assert host["layout"].describe() == ref["layout"].describe()
    dstT, colstart, _, q_total = chunked_layout(
        *ps.out_csr(), np.asarray(ps.out_degree, np.int64), ps.n)
    as_dict = S.shard_chunked_csr({"n": ps.n, "q_total": q_total,
                                   "dstT": dstT,
                                   "colstart": colstart.astype(np.int32),
                                   "deg": np.asarray(ps.out_degree)}, D)
    for sh in (host, as_dict):
        for d in range(D):
            got = S.pack_shard_block(d, sh["colstart"], sh["dstT"],
                                     sh["degc_all"], sh["bounds"],
                                     sh["b_max"], sh["q_max"], sh["n"])
            for a, b in zip(got, (ref["dstT_sh"][d], ref["colstart_sh"][d],
                                  ref["degc_sh"][d])):
                assert np.array_equal(a, b)


@pytest.mark.parametrize("D", SHARDS)
@pytest.mark.parametrize("kind", GRAPHS)
def test_shard_csr_equals_jax(kind, D):
    js, ps = _pair(kind)
    ref = JP.shard_csr(js, D)
    for ranks in (None, (D - 1,), tuple(range(D))[::-1]):
        got = P.shard_csr(ps, D, ranks=ranks)
        rows = list(range(D)) if ranks is None else list(ranks)
        assert got.ranks == tuple(rows)
        for k in ("n", "n_pad", "block", "num_shards", "e_block"):
            assert getattr(got, k) == getattr(ref, k), k
        for k in ("src_global", "dst_local", "valid", "last_idx",
                  "seg_has"):
            assert np.array_equal(getattr(got, k), getattr(ref, k)[rows]), k
        assert np.array_equal(got.edge_values["weight"],
                              ref.edge_values["weight"][rows])


def test_shard_layout_int32_safety_past_2_31_chunks():
    """tests/test_sharded_bfs.py's point on a power-law degree profile
    whose global chunk count passes 2^31 (2^20 vertices, about 2^31.6
    chunks): 8 shards' local spans stay int32-safe, cut as JAX cuts."""
    n = 1 << 20
    deg = np.random.default_rng(0).zipf(1.7, size=n).astype(np.int64)
    degc = -(-(deg * ((3 << 30) * 8 / deg.sum())).astype(np.int64) // 8)
    colstart = np.zeros(n + 1, np.int64)
    np.cumsum(degc, out=colstart[1:])
    assert colstart[-1] >= (1 << 31)
    bounds, b_max, q_max = S.plan_shard_cuts(colstart, n, 8)
    jb, jb_max, jq_max = JS.plan_shard_cuts(colstart, n, 8)
    assert np.array_equal(bounds, jb) and (b_max, q_max) == (jb_max, jq_max)
    assert q_max < (1 << 31)


def test_shard_cut_int32_boundary():
    """The cut planner at the 2^31 boundary (tests/test_sharded_bfs.py's
    cases): one shard over 3 * 2^31 chunks is refused with JAX's message,
    8 shards cut exactly, and spans just under 2^31 pass."""
    n = 1 << 10
    per_vertex = (3 * (1 << 31)) // n
    colstart = np.arange(n + 1, dtype=np.int64) * per_vertex
    with pytest.raises(NotImplementedError, match="int32") as e:
        S.plan_shard_cuts(colstart, n, 1)
    with pytest.raises(NotImplementedError) as ej:
        JS.plan_shard_cuts(colstart, n, 1)
    assert str(e.value) == str(ej.value)
    bounds, b_max, q_max = S.plan_shard_cuts(colstart, n, 8)
    assert q_max < (1 << 31)
    for d in range(len(bounds) - 1):
        lo, hi = int(bounds[d]), int(bounds[d + 1])
        c0 = int(colstart[lo])
        local = (colstart[lo:hi + 1] - c0).astype(np.int32)
        assert (local.astype(np.int64) == colstart[lo:hi + 1] - c0).all()
        assert local[-1] < q_max
    per_vertex = ((1 << 31) - 16) // (n // 4)
    colstart = np.arange(n + 1, dtype=np.int64) * per_vertex
    bounds, b_max, q_max = S.plan_shard_cuts(colstart, n, 4)
    assert (1 << 30) < q_max < (1 << 31)


def test_device_graph_dicts_are_refused():
    """Sharding reads host arrays only, as JAX's does: a device graph
    dict raises TypeError."""
    from titan_tpu_torch.models.bfs_hybrid import build_chunked_csr as pb

    _, ps = _pair("serving")
    with pytest.raises(TypeError, match="host"):
        S.shard_chunked_csr(pb(ps, "cpu"), 2)


def test_the_mesh_placed_cohort_is_item_9b():
    """Item 9b is ported: ``place_batched_csr`` cuts the vertices into
    blocks that cover [0, n], start on byte boundaries of the frontier
    words (multiples of 8 vertices) and hold their own columns, and
    caches the placement per mesh."""
    from titan_tpu_torch.parallel.mesh import local_mesh

    js, ps = _pair("serving")
    n = ps.n
    dstT, colstart, _, _ = chunked_layout(*ps.out_csr(),
                                          ps.out_degree.astype(np.int64), n)
    for D in SHARDS:
        mesh = local_mesh(["cpu"] * D)
        placed = P.place_batched_csr(ps, mesh)
        assert P.place_batched_csr(ps, mesh) is placed
        assert placed["_state_sharding"] == P.batched_state_sharding(mesh)
        shards = placed["_shards"]
        assert shards[0]["lo"] == 0 and shards[-1]["hi"] == n
        for a, b in zip(shards, shards[1:]):
            assert a["hi"] == b["lo"] and b["lo"] % P.BLOCK_ALIGN == 0
        for sh in shards:
            lo, hi, c0 = sh["lo"], sh["hi"], sh["c0"]
            q = int(colstart[hi] - colstart[lo])
            assert c0 == colstart[lo] and sh["dstT"].shape == (8, q + 1)
            assert np.array_equal(sh["dstT"][:, :q].numpy(),
                                  dstT[:, c0:c0 + q])
            assert (sh["dstT"][:, q] == n + 1).all()
            assert np.array_equal(sh["colstart"].numpy(),
                                  colstart[lo:hi + 1] - c0)
        assert set(getattr(ps, P.MESH_CACHE)) >= {mesh}
    # a second mesh of the same devices is the same key
    assert P.place_batched_csr(ps, local_mesh(["cpu"] * 2)) \
        is P.place_batched_csr(ps, local_mesh(["cpu"] * 2))
    ps._invalidate_layout_caches()        # refresh() and apply_changes

    assert getattr(ps, P.MESH_CACHE) == {}


# ------------------------------------------------- gloo ranks on the CPU

FOUND_CAPS = {"rmat9": 64, "serving": 8}


def _masks(n, D, seed):
    return np.random.default_rng(seed).random((D, n)) < 0.05


@pytest.fixture(scope="module", params=(1, 2, 4), ids=lambda d: f"D{d}")
def ranks(request):
    D = request.param
    cases = []
    for i, kind in enumerate(GRAPHS):
        n, src, dst, ev = _graph(kind)
        cases.append({"n": n, "src": src, "dst": dst, "edge_values": ev,
                      "masks": _masks(n, D, i),
                      "found_cap": FOUND_CAPS[kind]})
    return D, cases, launch(W.partition_cases, D, "cpu", args=(cases,),
                            timeout=240)


@pytest.mark.parametrize("i", range(len(GRAPHS)), ids=GRAPHS)
def test_each_rank_uploads_its_own_blocks(ranks, i):
    """rank_shard's device block of rank d is JAX's packed row d, with
    the window of the layout; the engine's block is JAX's shard_csr row."""
    D, _, out = ranks
    js, _ = _pair(GRAPHS[i])
    ref = JS.shard_chunked_csr(build_chunked_csr(js), D)
    got = out[i]
    assert np.array_equal(got["dstT"], ref["dstT_sh"])
    assert np.array_equal(got["colstart"], ref["colstart_sh"])
    assert np.array_equal(got["degc"], ref["degc_sh"])
    assert np.array_equal(got["window"],
                          np.stack([ref["bounds"][:-1], ref["bounds"][1:]],
                                   axis=1))
    assert got["describe"] == ref["layout"].describe()
    sc = JP.shard_csr(js, D)
    for k in ("src_global", "dst_local", "valid", "last_idx", "seg_has"):
        assert np.array_equal(got[k], getattr(sc, k)), k


@pytest.mark.parametrize("i", range(len(GRAPHS)), ids=GRAPHS)
def test_exchange_found_equals_jax(ranks, i):
    """Every rank's compacted ids gathered in rank order (fill n+1) and
    the largest true count: JAX's exchange_found under shard_map at the
    same D, and a numpy compaction."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as JSpec

    from titan_tpu.parallel.mesh import shard_map_compat, vertex_mesh

    D, cases, out = ranks
    case = cases[i]
    n, cap = case["n"], case["found_cap"]
    f = jax.jit(shard_map_compat(
        lambda m: JP.exchange_found(m[0], cap, n), mesh=vertex_mesh(D),
        in_specs=(JSpec("v", None),), out_specs=(JSpec(), JSpec())))
    ids, found_max = f(jnp.asarray(case["masks"]))
    assert np.array_equal(out[i]["ids"], np.asarray(ids))
    assert out[i]["found_max"] == int(found_max)
    want = np.full((D, cap), n + 1, np.int32)
    for d in range(D):
        nz = np.flatnonzero(case["masks"][d])[:cap]
        want[d, :len(nz)] = nz
    assert np.array_equal(out[i]["ids"], want)
    assert out[i]["found_max"] == int(case["masks"].sum(axis=1).max())
