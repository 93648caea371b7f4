"""The port's segmented scan and segment combine (titan_tpu_torch.ops.
seg_scan and .segment) on the CPU, against the JAX package: the Pallas
kernel in interpreter mode (``pallas_seg_scan``), the XLA Hillis-Steele
``ops.segment.seg_scan``, ``sorted_segment_combine`` and the
``jax.ops.segment_*`` scatters.

Everything is exact except float32 sums, held at rtol 1e-5: the Pallas
kernel and the scatters add in another order than the Hillis-Steele
scan. The CUDA kernel is held against ``seg_scan_reference`` on the card
by chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from titan_tpu.ops import segment as J
from titan_tpu.ops.pallas_segment import (pallas_seg_scan,
                                          pallas_sorted_segment_combine)
from titan_tpu_torch.ops import seg_scan as S
from titan_tpu_torch.ops import segment as SG

COMBINES = ("sum", "min", "max")
DTYPES = (np.float32, np.int32)
#: (E, segments, seed): tests/test_pallas_segment.py's shapes, then one
#: with many empty segments and one with segments longer than a block
SHAPES = [(700, 37, 0), (1000, 37, 0), (900, 53, 3), (300, 200, 5),
          (1024, 3, 7)]
_JAX_OPS = {"sum": jax.ops.segment_sum, "min": jax.ops.segment_min,
            "max": jax.ops.segment_max}


def _segments(e, n, seed, dtype):
    rng = np.random.default_rng(seed)
    seg = np.sort(rng.integers(0, n, e)).astype(np.int32)
    if np.issubdtype(dtype, np.integer):
        vals = rng.integers(-2**31 + 1, 2**31, e).astype(dtype)
    else:
        vals = rng.uniform(-5, 5, e).astype(dtype)
    indptr = np.zeros(n + 1, np.int64)
    np.add.at(indptr[1:], seg, 1)
    return vals, seg, np.cumsum(indptr), n


def _check(got, ref, combine, dtype):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.dtype == ref.dtype
    if combine == "sum" and dtype == np.float32:
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_array_equal(got, ref)


def _scan_ref(vals, flags, combine):
    return S.seg_scan_reference(torch.from_numpy(vals),
                                torch.from_numpy(flags), combine).numpy()


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: d.__name__)
@pytest.mark.parametrize("combine", COMBINES)
def test_scan_reference_matches_jax(combine, dtype, shape):
    vals, seg, _, _ = _segments(*shape, dtype)
    flags = np.concatenate([[True], seg[1:] != seg[:-1]])
    got = _scan_ref(vals, flags, combine)
    xla = J.seg_scan(jnp.asarray(vals), jnp.asarray(flags), combine)
    np.testing.assert_array_equal(got, np.asarray(xla))  # same order
    pallas = pallas_seg_scan(jnp.asarray(vals), jnp.asarray(flags), combine,
                             block=128, interpret=True)
    _check(got, pallas, combine, dtype)
    # the wrapper takes the plain version for CPU tensors, uncounted
    launches = S.seg_scan.launches
    wrapped = S.seg_scan(torch.from_numpy(vals), torch.from_numpy(flags),
                         combine)
    np.testing.assert_array_equal(wrapped.numpy(), got)
    assert S.seg_scan.launches == launches


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: d.__name__)
@pytest.mark.parametrize("combine", COMBINES)
def test_scan_flag0_false_is_implied(combine, dtype):
    """flags[0] False still starts a segment at index 0."""
    vals, seg, _, _ = _segments(500, 20, 9, dtype)
    flags = np.concatenate([[False], seg[1:] != seg[:-1]])
    got = _scan_ref(vals, flags, combine)
    forced = flags.copy()
    forced[0] = True
    np.testing.assert_array_equal(got, _scan_ref(vals, forced, combine))
    xla = J.seg_scan(jnp.asarray(vals), jnp.asarray(flags), combine)
    np.testing.assert_array_equal(got, np.asarray(xla))


@pytest.mark.parametrize("flag", [False, True], ids=["one", "each"])
def test_scan_one_segment_and_each_its_own(flag):
    """A single segment over everything (a pure carry chain), and every
    element its own segment."""
    e = 1024
    vals = np.ones(e, np.float32)
    flags = np.full(e, flag)
    got = _scan_ref(vals, flags, "sum")
    want = np.ones(e, np.float32) if flag else np.arange(1, e + 1,
                                                        dtype=np.float32)
    np.testing.assert_array_equal(got, want)
    pallas = pallas_seg_scan(jnp.asarray(vals), jnp.asarray(flags), "sum",
                             block=128, interpret=True)
    np.testing.assert_array_equal(got, np.asarray(pallas))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: d.__name__)
@pytest.mark.parametrize("combine", COMBINES)
def test_combine_matches_jax(combine, dtype, shape):
    vals, seg, indptr, n = _segments(*shape, dtype)
    last_idx, seg_has = SG.segment_metadata(indptr)
    jl, jh = J.segment_metadata(indptr)
    np.testing.assert_array_equal(last_idx, jl)
    np.testing.assert_array_equal(seg_has, jh)
    tv, ts = torch.from_numpy(vals), torch.from_numpy(seg)
    tl, th = torch.from_numpy(last_idx), torch.from_numpy(seg_has)
    got = SG.segment_combine(tv, ts, n, combine, last_idx=tl, seg_has=th)
    np.testing.assert_array_equal(
        got.numpy(), SG.sorted_segment_combine(tv, ts, tl, th, combine))
    args = (jnp.asarray(vals), jnp.asarray(seg), jnp.asarray(last_idx),
            jnp.asarray(seg_has), combine)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(J.sorted_segment_combine(*args)))
    _check(got, pallas_sorted_segment_combine(*args, block=128,
                                              interpret=True),
           combine, dtype)
    scatter = _JAX_OPS[combine](jnp.asarray(vals), jnp.asarray(seg),
                                num_segments=n)
    _check(got, scatter, combine, dtype)
    # without metadata: the plain scatter, same answer
    _check(SG.segment_combine(tv, ts, n, combine), scatter, combine, dtype)


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: d.__name__)
@pytest.mark.parametrize("combine", COMBINES)
def test_identity_matches_jax(combine, dtype):
    got = SG.combine_identity(combine, torch.from_numpy(np.zeros(1, dtype))
                              .dtype)
    assert got == J.combine_identity(combine, dtype).item()


def test_combine_without_edges_gives_identities():
    tl, th = (torch.from_numpy(a) for a in SG.segment_metadata(
        np.zeros(4, np.int64)))
    empty = torch.zeros(0, dtype=torch.int32)
    got = SG.segment_combine(empty, empty, 3, "min", last_idx=tl,
                             seg_has=th)
    assert got.tolist() == [2**31 - 1] * 3


def test_bad_combine_raises():
    with pytest.raises(ValueError, match="unknown combine"):
        SG.segment_combine(torch.zeros(3), torch.zeros(3, dtype=torch.int32),
                           1, "mean")


def test_non_cpu_tensors_take_the_kernel_path_or_raise():
    """Tensors off the CPU never reach the plain version: the wrapper
    routes them to the kernel path, which takes CUDA tensors only and
    checks E < 2^31 before anything else runs."""
    v = torch.zeros(8, device="meta")
    f = torch.zeros(8, dtype=torch.bool, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        S.seg_scan(v, f, "sum")
    assert S.seg_scan.launches == 0
    big = (torch.empty(2**31, device="meta"),
           torch.empty(2**31, dtype=torch.bool, device="meta"))
    with pytest.raises(ValueError, match="CUDA"):
        S.seg_scan(*big, "sum")


@pytest.mark.parametrize("bad", ["dtype", "flags", "combine", "size",
                                 "row_flags", "rank"])
def test_launch_checks_its_inputs(bad, monkeypatch):
    """The kernel path's checks, reached with meta tensors posing as CUDA
    ones (no kernel is built or launched); ``row_flags``: K rows whose
    stride is shorter than the flags, ``rank``: 3-d values."""
    e = 2**31 if bad == "size" else 16
    shape = {"row_flags": (2, e - 1), "rank": (2, 2, e)}.get(bad, (e,))
    v = torch.empty(shape, dtype=torch.float64 if bad == "dtype" else
                    torch.float32, device="meta")
    f = torch.empty(e, dtype=torch.uint8 if bad == "flags" else torch.bool,
                    device="meta")
    monkeypatch.setattr(torch.Tensor, "device",
                        property(lambda t: torch.device("cuda")))
    with pytest.raises(ValueError, match="combine|float32|flags|2\\^31"):
        S._launch(v, f, "mean" if bad == "combine" else "sum")
