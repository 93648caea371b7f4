"""The port's engine snapshot (titan_tpu_torch.olap.snapshot) on the CPU:
``from_arrays`` and ``from_numpy`` against the JAX package's snapshot,
and ``from_chunked_csr`` (the symmetric Graph500 graph, no host sort)
bit-equal to ``from_arrays`` over the same edge list."""

import numpy as np
import pytest

from titan_tpu.olap.tpu import snapshot as JS
from titan_tpu.olap.tpu.rmat import rmat_edges
from titan_tpu_torch.olap import graph500 as G
from titan_tpu_torch.olap import snapshot as PS

FIELDS = ("vertex_ids", "src", "dst", "indptr_in", "out_degree")


def _same(a, b):
    assert a.n == b.n and a.num_edges == b.num_edges
    for f in FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)
    assert sorted(a.edge_values) == sorted(b.edge_values)
    for k, v in a.edge_values.items():
        np.testing.assert_array_equal(v, b.edge_values[k])
    assert (a.labels is None) == (b.labels is None)
    if a.labels is not None:
        np.testing.assert_array_equal(a.labels, b.labels)
    assert a.label_names == b.label_names


def _labelled(scale):
    src, dst = rmat_edges(scale, 8, seed=scale)
    rng = np.random.default_rng(scale)
    labels = rng.integers(0, 3, len(src)).astype(np.int32)
    w = rng.uniform(0, 1, len(src)).astype(np.float32)
    vids = np.sort(rng.choice(1 << 40, 1 << scale, replace=False))
    return dict(n=1 << scale, src=src, dst=dst, vertex_ids=vids,
                edge_values={"weight": w}, labels=labels,
                label_names={0: "a", 1: "b", 2: "c"})


@pytest.mark.parametrize("scale", [6, 9, 12])
def test_from_arrays_and_from_numpy_match_jax(scale):
    kw = _labelled(scale)
    js = JS.from_arrays(**kw)
    ps = PS.from_arrays(**kw)
    _same(js, ps)
    _same(ps, PS.from_numpy(js))
    _same(js.reverse(), ps.reverse())
    v = int(kw["vertex_ids"][5])
    assert ps.dense_of(v) == js.dense_of(v) == 5
    with pytest.raises(KeyError):
        ps.dense_of(v + 1)


def test_from_arrays_checks_endpoints():
    with pytest.raises(IndexError):
        PS.from_arrays(4, [0, 4], [1, 2])


def _csr_edge_list(hg):
    """The half-edges of a chunked CSR in CSR order: (v, each w in its
    row), read from the lane-major dstT."""
    dstT, colstart, deg = (np.asarray(hg[k]) for k in
                           ("dstT", "colstart", "deg"))
    v = np.repeat(np.arange(len(deg)), deg)
    k = np.arange(len(v)) - np.repeat(np.cumsum(deg) - deg, deg)
    return v, dstT[k & 7, colstart[v] + (k >> 3)]


@pytest.mark.parametrize("generator", ["native", "numpy"])
@pytest.mark.parametrize("scale", [8, 11])
def test_from_chunked_csr_equals_from_arrays(generator, scale, tmp_path):
    hg = G.load_or_build(scale, 16, seed=scale, cache_dir=str(tmp_path),
                         verbose=False, generator=generator)
    got = PS.from_chunked_csr(hg)
    v, w = _csr_edge_list(hg)
    _same(got, PS.from_arrays(hg["n"], v, w))
    _same(got, JS.from_arrays(hg["n"], v, w))
    # symmetric: the in-degree of every vertex is its out-degree
    np.testing.assert_array_equal(np.diff(got.indptr_in), got.out_degree)


def test_from_chunked_csr_sorts_an_unsorted_row():
    """Rows whose neighbours are not ascending still give from_arrays'
    order (ascending sources within each destination)."""
    n = 4
    pad = n + 1
    # rows: 0 -> [3, 1, 2], 1 -> [0], 2 -> [0], 3 -> [0]; one chunk each
    rows = [[3, 1, 2], [0], [0], [0]]
    dstT = np.full((8, n + 1), pad, np.int32)
    for r, row in enumerate(rows):
        dstT[:len(row), r] = row
    hg = {"dstT": dstT, "colstart": np.arange(n + 1, dtype=np.int32),
          "deg": np.array([3, 1, 1, 1], np.int32)}
    got = PS.from_chunked_csr(hg)
    v = np.repeat(np.arange(n), hg["deg"])
    w = np.concatenate(rows)
    _same(got, PS.from_arrays(n, v, w))


def test_from_chunked_csr_checks_the_degrees():
    hg = {"dstT": np.full((8, 2), 2, np.int32),
          "colstart": np.array([0, 1], np.int32),
          "deg": np.array([3], np.int32)}
    with pytest.raises(ValueError, match="degrees sum"):
        PS.from_chunked_csr(hg)
