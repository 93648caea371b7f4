"""Inclusive segmented scan over the dst-sorted edge axis: the Hopper
kernel, its plain version and the dispatching wrapper (port of
``titan_tpu/ops/pallas_segment.py``).

``out[i]`` is the combine (sum, min or max) of ``values[s..i]``, where
``s`` is the last segment start at or before ``i``; ``flags[i]`` marks a
start and index 0 always starts a segment. Values are float32 or int32;
integer sums wrap. The identities follow ``combine_identity``: 0, the
type's maximum (``+inf`` for floats), the type's minimum (``-inf``).

``seg_scan`` runs ``seg_scan_reference`` when its tensors lie on the
CPU, and the CUDA kernel (``csrc/seg_scan.cu``) when they lie on a card;
there is no other route. The kernel is built with ``nvcc`` at first use
and bound with ctypes. It is one launch, a single pass with decoupled
look-back between tiles, after the wrapper zeroes its scratch (the
tile statuses and a ticket counter). Its float sums add in another order
than the plain version's, so the two agree to a tolerance, not bit for
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
    JAX package's ``ops/segment.seg_scan``, log2(E) shifted passes."""
    op = _OPS[combine]
    ident = combine_identity(combine, values.dtype)
    flags = flags.bool()
    e = values.shape[0]
    d = 1
    while d < e:
        pv = torch.cat([values.new_full((d,), ident), values[:-d]])
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
    lib.tt_seg_scan.restype = i32
    lib.tt_seg_scan.argtypes = [i32, i32, p, p, i64, p, p, p]
    lib.tt_seg_scan_tile.restype = i32
    return lib


def _launch(values, flags, combine: str):
    dev = values.device
    if dev.type != "cuda":
        raise ValueError(f"seg_scan: tensors on {dev}; the kernel takes "
                         "CUDA tensors and the plain path CPU ones")
    if combine not in COMBINES:
        raise ValueError(f"unknown combine {combine!r}")
    if values.dtype not in _DTYPE_CODE or values.dim() != 1:
        raise ValueError(f"seg_scan: values must be 1-d float32 or int32, "
                         f"got {values.dtype} {tuple(values.shape)}")
    e = values.shape[0]
    if flags.dtype != torch.bool or tuple(flags.shape) != (e,):
        raise ValueError(f"seg_scan: flags must be bool ({e},), got "
                         f"{flags.dtype} {tuple(flags.shape)}")
    if flags.device != dev:
        raise ValueError(f"seg_scan: flags lie on {flags.device}, values "
                         f"on {dev}")
    if not (values.is_contiguous() and flags.is_contiguous()):
        raise ValueError("seg_scan: values and flags must be contiguous")
    if e >= 2**31:
        raise ValueError(f"seg_scan: E={e} >= 2^31 (segment last indices "
                         "are int32)")
    out = torch.empty_like(values)
    if e == 0:
        return out
    lib = kernel_library()
    # the tile statuses, then the ticket counter; zeroed every call, so
    # no call reads a status an earlier one left
    scratch = torch.zeros((-(-e // lib.tt_seg_scan_tile()) + 1,),
                          dtype=torch.int64, device=dev)
    err = lib.tt_seg_scan(
        _DTYPE_CODE[values.dtype], COMBINES.index(combine),
        values.data_ptr(), flags.data_ptr(), e, out.data_ptr(),
        scratch.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"seg_scan: CUDA error {err} at launch")
    seg_scan.launches += 1
    return out


def seg_scan(values, flags, combine: str):
    """Inclusive segmented scan of ``values`` [E] (float32 or int32) with
    segment-start ``flags`` [E] bool (``flags[0]`` implied); see the
    module doc. On a card nothing synchronises."""
    if values.device.type == "cpu":
        return seg_scan_reference(values, flags, combine)
    return _launch(values, flags, combine)


#: kernel launches so far (the CPU path never counts)
seg_scan.launches = 0
