"""Inclusive segmented scan over the dst-sorted edge axis: the Hopper
kernel, its plain version and the dispatching wrapper (port of
``titan_tpu/ops/pallas_segment.py``).

``out[i]`` is the combine (sum, min or max) of ``values[s..i]``, where
``s`` is the last segment start at or before ``i``; ``flags[i]`` marks a
start and index 0 always starts a segment. Values are float32 or int32;
integer sums wrap. The identities follow ``combine_identity``: 0, the
type's maximum (``+inf`` for floats), the type's minimum (``-inf``).

``seg_scan`` takes one row, ``values`` [E], or K rows, ``values``
[K, ld] with E <= ld under the one ``flags`` [E] (the batched engine's
messages: ``dst`` is the same for every job); row k's scan is
``out[k, :E]`` and is exactly the scan of ``values[k, :E]`` alone.

``seg_scan`` runs ``seg_scan_reference`` when its tensors lie on the
CPU, and the CUDA kernel (``csrc/seg_scan.cu``) when they lie on a card;
there is no other route. The kernel is built with ``nvcc`` at first use
and bound with ctypes. It is one launch, a single pass with decoupled
look-back between tiles, after the wrapper zeroes its scratch (the
tile statuses and a ticket counter); K rows are one launch too, each row
bit-equal to the one-row launch on that row. Its float sums add in
another order than the plain version's, so the two agree to a tolerance, not bit for
bit, but the same inputs give the same bits on every run; min, max and
integer sums agree exactly.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from titan_tpu_torch.build import build_cuda

COMBINES = ("sum", "min", "max")
_OPS = {"sum": torch.add, "min": torch.minimum, "max": torch.maximum}
_DTYPE_CODE = {torch.float32: 0, torch.int32: 1}


def combine_identity(combine: str, dtype: torch.dtype):
    """The identity of ``combine`` for ``dtype``, as a Python number."""
    if dtype.is_floating_point:
        zero, hi, lo = 0.0, float("inf"), float("-inf")
    else:
        zero, hi, lo = 0, torch.iinfo(dtype).max, torch.iinfo(dtype).min
    try:
        return {"sum": zero, "min": hi, "max": lo}[combine]
    except KeyError:
        raise ValueError(f"unknown combine {combine!r}") from None


def seg_scan_reference(values, flags, combine: str):
    """Plain PyTorch version, on any device: the Hillis-Steele scan of the
    JAX package's ``ops/segment.seg_scan``, log2(E) shifted passes along
    the last axis (of ``values[..., :E]`` for K rows), so each row gets
    exactly the operations of its one-row scan."""
    op = _OPS[combine]
    ident = combine_identity(combine, values.dtype)
    flags = flags.bool()
    e = flags.shape[0]
    values = values[..., :e]
    d = 1
    while d < e:
        pv = torch.cat([values.new_full(values.shape[:-1] + (d,), ident),
                        values[..., :-d]], dim=-1)
        pf = torch.cat([flags.new_ones((d,)), flags[:-d]])
        values = torch.where(flags, values, op(values, pv))
        flags = flags | pf
        d <<= 1
    return values


@functools.cache
def kernel_library() -> ctypes.CDLL:
    """Build (once per source hash) and bind the kernel library."""
    lib = ctypes.CDLL(build_cuda("seg_scan"))
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.tt_seg_scan_rows.restype = i32
    lib.tt_seg_scan_rows.argtypes = [i32, i32, p, p, i64, i64, i64, p, p, p]
    lib.tt_seg_scan_tile.restype = i32
    return lib


def _launch(values, flags, combine: str):
    dev = values.device
    if dev.type != "cuda":
        raise ValueError(f"seg_scan: tensors on {dev}; the kernel takes "
                         "CUDA tensors and the plain path CPU ones")
    if combine not in COMBINES:
        raise ValueError(f"unknown combine {combine!r}")
    if values.dtype not in _DTYPE_CODE or values.dim() not in (1, 2):
        raise ValueError(f"seg_scan: values must be [E] or [K, ld] float32 "
                         f"or int32, got {values.dtype} "
                         f"{tuple(values.shape)}")
    e = flags.shape[0] if flags.dim() == 1 else -1
    if flags.dtype != torch.bool or e < 0 or e > values.shape[-1] \
            or (values.dim() == 1 and e != values.shape[0]):
        raise ValueError(f"seg_scan: flags must be bool (E,) with E = the "
                         f"length of 1-d values or at most the row stride "
                         f"of 2-d ones, got {flags.dtype} "
                         f"{tuple(flags.shape)} for values "
                         f"{tuple(values.shape)}")
    if flags.device != dev:
        raise ValueError(f"seg_scan: flags lie on {flags.device}, values "
                         f"on {dev}")
    if not (values.is_contiguous() and flags.is_contiguous()):
        raise ValueError("seg_scan: values and flags must be contiguous")
    if e >= 2**31:
        raise ValueError(f"seg_scan: E={e} >= 2^31 (segment last indices "
                         "are int32)")
    out = torch.empty_like(values)
    rows, ld = values.shape if values.dim() == 2 else (1, e)
    if e == 0 or rows == 0:
        return out[..., :e]
    lib = kernel_library()
    tiles = rows * -(-e // lib.tt_seg_scan_tile())
    if tiles >= 2**31:
        raise ValueError(f"seg_scan: {tiles} tiles >= 2^31 (the ticket is "
                         "32-bit)")
    # the tile statuses, row by row, then the ticket counter; zeroed every
    # call, so no call reads a status an earlier one left
    scratch = torch.zeros((tiles + 1,), dtype=torch.int64, device=dev)
    err = lib.tt_seg_scan_rows(
        _DTYPE_CODE[values.dtype], COMBINES.index(combine),
        values.data_ptr(), flags.data_ptr(), e, rows, ld, out.data_ptr(),
        scratch.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"seg_scan: CUDA error {err} at launch")
    seg_scan.launches += 1
    return out[..., :e]


def seg_scan(values, flags, combine: str):
    """Inclusive segmented scan of ``values`` [E] (float32 or int32) with
    segment-start ``flags`` [E] bool (``flags[0]`` implied), or of each
    row of ``values`` [K, ld] under the same ``flags`` [E], E <= ld,
    giving [K, E] (a view of [K, ld] on a card); see the module doc. On a
    card nothing synchronises."""
    if values.device.type == "cpu":
        return seg_scan_reference(values, flags, combine)
    return _launch(values, flags, combine)


#: kernel launches so far (the CPU path never counts)
seg_scan.launches = 0
