"""Each row's trailing-window sum by a log ladder: the port of the lint
fixture's Pallas kernel, ``_ok_kernel`` of
``tests/fixtures/graftlint/titan_tpu/models/pallas_ok.py:14`` (its
``pl.pallas_call`` at ``:29``, in ``run``), on the card as
``csrc/window_sum.cu``.

``row_window_sum(x, *, block=128, masked=False)``
    ``_ok_kernel`` with those constants on the whole ``[R, W]`` array:
    ``v = x``; for ``d = 1, 2, 4, ...`` while ``d < block``, ``v = v +
    pad(v[:, :-d])`` (``d`` zeros on the left); then ``v * 2`` if
    ``masked``; then ``+ 1`` if ``R > 1``. Each output is the sum of the
    row's last ``span`` elements up to it (``span``: twice the largest
    step, 128 at ``block=128``), added as a balanced binary tree.
``run(x)``
    the fixture's ``run``: ``row_window_sum`` with the defaults.

``x`` is a 2-D int32 or float32 tensor; int32 adds wrap, as JAX's do.
Refused (``ValueError``), as JAX refuses them: a width below the
ladder's largest step (``jnp.pad`` then yields the wrong width, and the
add does not trace), a dimension other than 2, another dtype. Also
refused: ``block > 256`` (the kernel's windows hold spans of at most
256). The tensor's device decides: a CPU tensor runs the plain version
(``row_window_sum_reference``), a CUDA tensor launches the kernel under
``device.on_card``; there is no other route. ``row_window_sum.launches``
counts the kernel's launches (the CPU path never counts).

``run_window_sum(device=None)`` times the kernel at (2^21, 128), int32
and float32, beside its byte bound, its plain version and, for float32,
``F.conv1d`` with a ones filter (the same sums in another order).

This module imports no JAX and nothing of the JAX package or of the
fixtures.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from titan_tpu_torch.build import build_cuda
from titan_tpu_torch.device import on_card, resolve_device
from titan_tpu_torch.ops.probes import _time, bound_ms

BLOCK = 128                      # the fixture's run: block=128
MAX_BLOCK = 256                  # the kernel's windows: spans up to 256
DTYPES = (torch.int32, torch.float32)
#: the timed shape: the TPU probes' (2^21, 128) rows
TIMED_SHAPE = (2**21, 128)
#: timed samples a case (``probes._time``)
TIMED_REPS = 5


def steps(block: int) -> list[int]:
    """The ladder's steps: 1, 2, 4, ... while below ``block``."""
    out, d = [], 1
    while d < block:
        out.append(d)
        d <<= 1
    return out


def span(block: int) -> int:
    """How many elements each output sums: twice the largest step (1
    where there is no step)."""
    s = steps(block)
    return 2 * s[-1] if s else 1


def _check(x, block: int) -> None:
    if x.dtype not in DTYPES:
        raise ValueError(f"row_window_sum: x must be int32 or float32, got "
                         f"{x.dtype}")
    if x.dim() != 2:
        raise ValueError(f"row_window_sum: x must be 2-D [R, W], got "
                         f"{tuple(x.shape)}")
    if block > MAX_BLOCK:
        raise ValueError(f"row_window_sum: block {block} > {MAX_BLOCK}")
    s = steps(block)
    if s and x.shape[1] < s[-1]:
        raise ValueError(f"row_window_sum: width {x.shape[1]} is below the "
                         f"ladder's largest step {s[-1]} (block {block})")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"row_window_sum: x on {x.device}; the kernel takes "
                         "CUDA tensors and the plain path CPU ones")


def ladder(x, block: int = BLOCK):
    """The ladder's steps alone: each row's window sums, before ``* 2``
    and ``+ 1``."""
    v = x
    for d in steps(block):
        v = v + F.pad(v[:, :-d], (d, 0))
    return v


def row_window_sum_reference(x, *, block: int = BLOCK, masked: bool = False):
    """Plain PyTorch version of ``row_window_sum``: the ladder step by
    step, the same adds in the same order, the pad's zeros added too
    (``-0.0 + 0.0`` is ``+0.0``, as in JAX), so float32 equals JAX bit for
    bit. ``v * 2`` is exact, so whether XLA contracts ``v * 2 + 1`` into
    a fused multiply-add changes nothing."""
    v = ladder(x, block)
    if masked:
        v = v * 2
    if x.shape[0] > 1:
        v = v + 1
    return v if v is not x else x.clone()


@functools.cache
def kernel_library() -> ctypes.CDLL:
    """Build (once per source hash) and bind the window-sum kernel."""
    lib = ctypes.CDLL(build_cuda("window_sum"))
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.tt_window_sum.argtypes = [p, p, i64, i32, i32, i32, i32, i32, p]
    lib.tt_window_sum.restype = i32
    return lib


def _launch(x, block: int, masked: bool):
    out = torch.empty_like(x)
    err = kernel_library().tt_window_sum(
        x.data_ptr(), out.data_ptr(), x.shape[0], x.shape[1], block,
        int(x.dtype == torch.float32), int(masked), int(x.shape[0] > 1),
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"row_window_sum: CUDA error {err} at launch")
    row_window_sum.launches += 1
    return out


def row_window_sum(x, *, block: int = BLOCK, masked: bool = False):
    """``_ok_kernel`` with ``block`` and ``masked`` on ``x [R, W]``; see
    the module doc."""
    _check(x, block)
    if x.device.type == "cpu":
        return row_window_sum_reference(x, block=block, masked=masked)
    with on_card(x.device):
        return _launch(x.contiguous(), block, masked)


row_window_sum.launches = 0


def run(x):
    """The fixture's ``run``: ``row_window_sum`` with ``block=128``,
    ``masked=False``."""
    return row_window_sum(x)


def window_sum_bytes(n: int) -> int:
    """Each of n elements read once and written once (4 B each)."""
    return 8 * n


def conv_window_sum(x, block: int = BLOCK):
    """The library call beside the kernel (float32 only): ``F.conv1d``
    with a ones filter of the window's width, padded by ``span - 1``;
    the same window sums as the ladder, added in cuDNN's order, without
    the ``* 2`` and ``+ 1``."""
    s = span(block)
    w = torch.ones((1, 1, s), dtype=x.dtype, device=x.device)
    return F.conv1d(x[:, None, :], w, padding=s - 1)[:, 0, :x.shape[1]]


def bits_err(got, want) -> int:
    """The largest |difference| of the two tensors' 32-bit patterns, as
    int64 (0 when they are bit-equal)."""
    g, w = got.view(torch.int32), want.view(torch.int32)
    differ = g != w
    if not differ.any():
        return 0
    return int((g[differ].long() - w[differ].long()).abs().max())


def run_window_sum(device=None) -> list[dict]:
    """Time ``row_window_sum`` (``block=128``) on the card at
    ``TIMED_SHAPE``, int32 and float32: the kernel (checked once through
    the wrapper and held bit-equal to the plain version, then the launch
    alone timed by ``probes._time``: best and median of ``TIMED_REPS``
    samples of calls back to back, by CUDA events), the plain version
    and, for float32, ``conv_window_sum`` with TF32 off (its max
    |difference| from the ladder's window sums recorded). Inputs come
    from seed 0 on the card. Raises on the CPU, where no card figure can
    be taken. One record a dtype."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError("run_window_sum times the kernel on a card; a CPU "
                         "run gives no card figure")
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    records = []
    with on_card(dev):
        for dtype in DTYPES:
            if dtype == torch.int32:
                x = torch.randint(-2**31, 2**31 - 1, TIMED_SHAPE,
                                  generator=gen, device=dev, dtype=dtype)
            else:
                x = torch.randn(TIMED_SHAPE, generator=gen, device=dev,
                                dtype=dtype)
            got = row_window_sum(x)
            err = bits_err(got, row_window_sum_reference(x))
            if err != 0:
                raise RuntimeError(f"row_window_sum {dtype}: the kernel "
                                   "differs from its plain version (max "
                                   f"|bit difference| {err})")
            ms, med = _time(lambda: _launch(x, BLOCK, False), TIMED_REPS)
            plain_ms, _ = _time(lambda: row_window_sum_reference(x),
                                TIMED_REPS)
            lib_ms = lib_diff = None
            if dtype == torch.float32:
                tf32 = torch.backends.cudnn.allow_tf32
                torch.backends.cudnn.allow_tf32 = False
                try:
                    lib_ms, _ = _time(lambda: conv_window_sum(x),
                                      TIMED_REPS)
                    lib_diff = float((conv_window_sum(x) - ladder(x))
                                     .abs().max())
                finally:
                    torch.backends.cudnn.allow_tf32 = tf32
            nbytes = window_sum_bytes(x.numel())
            b = bound_ms(nbytes)
            records.append({
                "dtype": str(dtype).replace("torch.", ""),
                "shape": list(TIMED_SHAPE), "block": BLOCK, "ms": ms,
                "median_ms": med, "bytes": nbytes, "gb_s": nbytes / ms / 1e6,
                "bound_ms": b, "share": b / ms, "max_abs_err": err,
                "plain_ms": plain_ms,
                "library": None if lib_ms is None else
                "F.conv1d(x[:, None], ones(1, 1, 128), padding=127)",
                "library_ms": lib_ms, "library_max_abs_diff": lib_diff})
            del x, got
            torch.cuda.empty_cache()
    return records
