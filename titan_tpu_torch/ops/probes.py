"""The access-pattern probes of ``experiments/`` on the card: six Hopper
kernels (``csrc/probes.cu``), each beside its plain PyTorch version, the
byte models that bound them, and ``run_probes``, which times every probe
at the TPU probes' own shapes.

The TPU probes measured the patterns the BFS lives on: random lookups
from a resident table, lane shuffles, a bit lookup, tile transposes,
scatters and DMA-driven segment copies. Their figures were TPU v5e ones;
these give the card's own, beside the data sheet's 3.35 TB/s.

``stream_copy(x)``
    ``out = x``.
``table_gather(tab, idx, shift=None)``
    ``out[i, j] = tab[idx[i, j], j]``; with ``shift``, the bit lookup
    ``(tab[idx[i, j], j] >> shift[i, j]) & 1`` (int32 ``>>`` is
    arithmetic on the card as in torch and JAX; the probes' words lie in
    [0, 2^20) and their shifts in [0, 32)). The kernel's design follows
    the shape (``gather_path``): a lookup a word for small, very tall
    or narrow tables, else the table's column stripes held in shared
    memory (by one block, or by a pair of blocks).
``row_shuffle(v, idx)``
    ``out[i, j] = v[i, idx[i, j]]``, rows of 128 words.
``table_scatter(idx, val, rows, mode)``
    a zeroed ``[rows, W]`` table, then ``tab[idx[i, j], j]`` set to
    (``"set"``), maxed with (``"max"``) or added to (``"add"``, wrapping)
    ``val[i, j]``. With ``set`` a cell written more than once holds one of
    the values written to it (``scatter_set_ok``). The kernel's design
    follows the shape (``scatter_path``): column stripes whose rows fit a
    block's shared memory, updated there and flushed once, or, for a
    table too tall for that, a global atomic or store an update.
``tile_transpose(v)``
    each 128 x 128 tile of ``v [N, 128]`` transposed in place of itself.
``segment_copy(src, starts, outpos, length, out_len, lens=None, inflight=8)``
    ``out[outpos[k]:+length] = src[starts[k]:+length]`` for every k with
    ``lens[k] > 0`` (every k without ``lens``), int32 element offsets
    (rows of 128 words are ``starts * 128`` and ``length = rows * 128``);
    ``inflight`` copies are kept in flight: a warp's segments for
    segments of at most 4 KB, a block's bulk copies for longer ones
    (``segment_path``).

Every tensor is int32 and contiguous. A wrapper runs the plain version
(``*_reference``) when its tensors lie on the CPU, and launches its kernel
under ``device.on_card`` when they lie on a card; there is no other route.
Each checks dtypes, contiguity and shapes, and the index ranges (a
reduction and a readback, not part of the kernel's time); ``segment_copy``
also refuses a live segment that would read or write out of range or is
not 16-byte aligned, where the TPU's DMA would fault or read garbage.
Outputs come from ``torch.empty``: what a probe leaves unwritten is
undefined, as in the JAX probes; ``table_scatter``'s table starts at zero.
Each wrapper's ``launches`` counts its kernel's launches (the CPU path
never counts).

This module imports no JAX, nothing of the JAX package and nothing of
``experiments/``: ``PROBES`` is its own copy of the probes' shapes.
"""

from __future__ import annotations

import ctypes
import functools
import statistics

import torch

from titan_tpu_torch.build import build_cuda
from titan_tpu_torch.device import on_card, resolve_device

HBM_BYTES_PER_S = 3.35e12        # H100 SXM (NVIDIA data sheet)
L2_BYTES = 50 * 2**20            # H100 SXM (NVIDIA data sheet)
SECTOR_BYTES = 32                # the smallest read from device memory
WIDTH = 128                      # the TPU probes' lane width
#: a block's shared memory: the 227 KB opt-in limit, all of it for
#: table_scatter's slab (the slab kernel has no static shared memory)
SHARED_BYTES = 232448
#: segment_copy's stages: less the kernel's static barriers and offsets
#: (32 * 16 B)
MAX_STAGE_BYTES = SHARED_BYTES - 512
#: a bulk copy's bytes are counted by an mbarrier's transaction count
MAX_COPY_BYTES = 2**20 - 16
MAX_INFLIGHT = 32
#: table_scatter's stripe widths, widest first
STRIPES = (8, 4)
#: table_gather's stripe widths, widest first
GATHER_STRIPES = (16, 8)
#: table_gather: the largest table, in bytes, that the per-lookup design
#: keeps (a table this small is served from L1)
LOOKUP_TABLE_BYTES = 192 * 1024
#: segment_copy: the longest segment, in bytes, that the warp design
#: copies; longer ones go by bulk copies
WARP_COPY_BYTES = 4096
SCATTER_MODES = ("set", "max", "add")
_SCATTER_REDUCE = {"max": "amax", "add": "sum"}

_M = 1024 * 512                  # probe_pallas_gather: CHUNK * STEPS rows
_B = 2**21                       # pallas_gather_bench's B; probe2's R * STEPS
#: the probes' shapes, each with the TPU kernel(s) it stands for:
#: (kernel, label, parameters, source)
PROBES = (
    ("stream_copy", "copy (524288, 128)", {"rows": _M},
     "experiments/probe_pallas_gather.py:56"),
    ("stream_copy", "copy (2^21, 128)", {"rows": _B},
     "experiments/probe2_rates.py:178"),
    ("table_gather", "gather 2 MB table, idx (524288, 128)",
     {"t_rows": 4096, "rows": _M}, "experiments/probe_pallas_gather.py:68"),
    ("table_gather", "gather T=2048 (1 MB), idx (2^21, 128)",
     {"t_rows": 2048, "rows": _B}, "experiments/pallas_gather_bench.py:18"),
    ("table_gather", "gather T=8192 (4 MB), idx (2^21, 128)",
     {"t_rows": 8192, "rows": _B}, "experiments/pallas_gather_bench.py:18"),
    ("table_gather", "gather T=16384 (8 MB), idx (2^21, 128)",
     {"t_rows": 16384, "rows": _B}, "experiments/pallas_gather_bench.py:18"),
    ("table_gather", "gather 8-row tile, idx (2^21, 128)",
     {"t_rows": 8, "rows": _B}, "experiments/probe2_rates.py:85"),
    ("table_gather", "gather T=2^19 (256 MB, beyond L2), idx (2^21, 128)",
     {"t_rows": 2**19, "rows": _B}, "experiments/gather_table_size.py"),
    ("table_gather", "bit lookup 8-row tile, (2^21, 128)",
     {"t_rows": 8, "rows": _B, "bits": True},
     "experiments/probe2_rates.py:108"),
    ("row_shuffle", "shuffle (524288, 128)", {"rows": _M},
     "experiments/probe_pallas_gather.py:87"),
    ("row_shuffle", "shuffle (2^21, 128)", {"rows": _B},
     "experiments/probe2_rates.py:58"),
    *(("table_scatter", f"scatter {m} (524288, 128) into (4096, 128)",
       {"t_rows": 4096, "rows": _M, "mode": m},
       "experiments/probe_pallas_gather.py:100") for m in SCATTER_MODES),
    ("tile_transpose", "transpose 128x128 tiles (2^21, 128)", {"rows": _B},
     "experiments/probe2_rates.py:136"),
    *(("segment_copy", f"probe3_dma deg={d} pad={p} nseg={n}",
       {"pool": 2**25, "deg": d, "pad": p, "nseg": n, "inflight": 8},
       "experiments/probe3_dma.py:26")
      for d, p, n in ((32, 128, 2**17), (128, 128, 2**17),
                      (512, 512, 2**15), (4096, 4096, 2**12))),
    *(("segment_copy", f"probe3d nseg={n} rows/seg={r} inflight={f}",
       {"src_rows": 2**17, "nseg": n, "seg_rows": r, "inflight": f},
       "experiments/probe3d_rate.py:19")
      for n, r, f in ((2**16, 1, 8), (2**16, 1, 16), (2**16, 4, 8),
                      (2**14, 32, 8), (2**18, 1, 16))),
)


# ----------------------------------------------------------- plain versions

def stream_copy_reference(x):
    """Plain PyTorch version of ``stream_copy``."""
    return x.clone()


def table_gather_reference(tab, idx, shift=None):
    """Plain PyTorch version of ``table_gather``."""
    out = torch.gather(tab, 0, idx)
    if shift is not None:
        out.bitwise_right_shift_(shift).bitwise_and_(1)
    return out


def row_shuffle_reference(v, idx):
    """Plain PyTorch version of ``row_shuffle``."""
    return torch.gather(v, 1, idx)


def table_scatter_reference(idx, val, rows: int, mode: str):
    """Plain PyTorch version of ``table_scatter``: a zeroed table, then
    ``scatter_`` (``set``) or ``scatter_reduce_`` with the zeros
    included (``max``: ``amax``, ``add``: ``sum``)."""
    tab = torch.zeros((rows, idx.shape[1]), dtype=torch.int32,
                      device=idx.device)
    if mode == "set":
        return tab.scatter_(0, idx, val)
    return tab.scatter_reduce_(0, idx, val, _SCATTER_REDUCE[mode])


def tile_transpose_reference(v):
    """Plain PyTorch version of ``tile_transpose``."""
    return v.view(-1, WIDTH, WIDTH).transpose(1, 2).reshape(v.shape)


def segment_copy_reference(src, starts, outpos, length: int, out_len: int,
                           lens=None, inflight: int = 8):
    """Plain PyTorch version of ``segment_copy`` (``inflight`` changes no
    result); what no live segment covers is left as ``torch.empty``
    gives it."""
    del inflight
    out = torch.empty(out_len, dtype=torch.int32, device=src.device)
    if lens is not None:
        live = lens > 0
        starts, outpos = starts[live], outpos[live]
    step = torch.arange(length, device=src.device)
    out[(outpos.long()[:, None] + step).reshape(-1)] = \
        src[(starts.long()[:, None] + step).reshape(-1)]
    return out


def scatter_set_ok(tab, idx, val) -> bool:
    """Whether ``tab`` is a valid ``table_scatter(idx, val, rows, "set")``:
    every cell some element wrote holds one of the values written to it,
    and every other cell is 0."""
    cols = torch.arange(idx.shape[1], device=idx.device).expand_as(idx)
    written = torch.zeros_like(tab, dtype=torch.bool)
    written[idx, cols] = True
    hit = torch.zeros_like(tab, dtype=torch.bool)
    hit[idx[tab[idx, cols] == val], cols[tab[idx, cols] == val]] = True
    return bool(torch.equal(hit, written)
                and not tab[~written].any().item())


# -------------------------------------------------------------- byte models
# Each input read once, each output written once (every figure in bytes;
# int32 words). For a table beyond L2, the sector model charges a lookup
# the 32-byte sector it reads, as chip_smoke.round_bytes counts dstT's.

def copy_bytes(n: int) -> int:
    """``stream_copy`` of n words."""
    return 8 * n


def gather_bytes(t_rows: int, n: int, width: int = WIDTH,
                 bits: bool = False) -> int:
    """``table_gather`` of n lookups (``bits``: with shifts) from a
    ``[t_rows, width]`` table: idx (and shift) read, out written, the
    table read once."""
    return 4 * n * (3 if bits else 2) + 4 * t_rows * width


def gather_sector_bytes(n: int, bits: bool = False) -> int:
    """The sector model of ``table_gather``: idx (and shift) read and out
    written as in ``gather_bytes``, and one sector a lookup."""
    return 4 * n * (3 if bits else 2) + SECTOR_BYTES * n


def shuffle_bytes(n: int) -> int:
    """``row_shuffle`` of n words: v and idx read, out written."""
    return 12 * n


def scatter_bytes(n: int, t_rows: int, width: int = WIDTH) -> int:
    """``table_scatter`` of n elements: idx and val read, the table
    written once."""
    return 8 * n + 4 * t_rows * width


def transpose_bytes(n: int) -> int:
    """``tile_transpose`` of n words."""
    return 8 * n


def _union_words(starts, length: int) -> int:
    """The words that ranges ``[s, s + length)`` cover together."""
    if not starts.numel():
        return 0
    s = torch.sort(starts.long()).values
    return int(torch.diff(s).clamp(max=length).sum()) + length


def segment_bytes(starts, outpos, length: int, lens=None) -> int:
    """``segment_copy``: the words the live segments read (their ranges
    merged: probe3_dma's segments of ``pad`` words start ``deg`` apart and
    overlap when ``deg < pad``) and write (merged too), and starts and
    outpos (and lens) read once."""
    nseg = starts.numel()
    if lens is not None:
        live = lens > 0
        starts, outpos = starts[live], outpos[live]
    return 4 * (_union_words(starts, length) + _union_words(outpos, length)
                + nseg * (2 if lens is None else 3))


def bound_ms(nbytes: int) -> float:
    """The least time the card could take to move ``nbytes`` at the data
    sheet's HBM rate."""
    return nbytes / HBM_BYTES_PER_S * 1e3


# ----------------------------------------------------------------- kernels

@functools.cache
def kernel_library() -> ctypes.CDLL:
    """Build (once per source hash) and bind the probe kernels."""
    lib = ctypes.CDLL(build_cuda("probes"))
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    for name, args in (
            ("tt_stream_copy", [p, p, i64, p]),
            ("tt_table_gather", [p, p, p, p, i64, i32, i64, i32, i32, p]),
            ("tt_row_shuffle", [p, p, p, i64, p]),
            ("tt_table_scatter", [p, p, p, i64, i32, i64, i32, i32, p]),
            ("tt_tile_transpose", [p, p, i64, p]),
            ("tt_segment_copy", [p, p, p, p, p, i64, i64, i32, i32, p])):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = args, i32
    return lib


def _ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


def _stream(t) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def _check(what: str, *tensors) -> torch.device:
    """Every tensor int32, contiguous, on one device, CPU or CUDA."""
    dev = tensors[0].device
    for t in tensors:
        if t.dtype != torch.int32:
            raise ValueError(f"{what}: tensors must be int32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: tensors must be contiguous")
        if t.device != dev:
            raise ValueError(f"{what}: tensors on {t.device} and {dev}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: tensors on {dev}; the kernel takes CUDA "
                         "tensors and the plain path CPU ones")
    return dev


def _check_range(what: str, t, hi: int) -> None:
    """Every element of ``t`` in [0, hi)."""
    if t.numel():
        lo, top = torch.aminmax(t)
        lo, top = int(lo), int(top)
        if lo < 0 or top >= hi:
            raise ValueError(f"{what}: an index in [{lo}, {top}] lies "
                             f"outside [0, {hi})")


def _check_aligned(what: str, *tensors) -> None:
    """The kernels move 16-byte vectors: every base address aligned."""
    for t in tensors:
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"{what}: a tensor's address is not 16-byte "
                             "aligned")


def _launch_stream_copy(x):
    _check_aligned("stream_copy", x)
    out = torch.empty_like(x)
    _raise_on(kernel_library().tt_stream_copy(
        x.data_ptr(), out.data_ptr(), x.numel(), _stream(x)), "stream_copy")
    stream_copy.launches += 1
    return out


def stream_copy(x):
    """``out = x`` (any shape); see the module doc."""
    if _check("stream_copy", x).type == "cpu":
        return stream_copy_reference(x)
    with on_card(x.device):
        return _launch_stream_copy(x)


def _slab_bytes(stripe: int, t_rows: int) -> int:
    """A slab's shared memory: ``stripe`` columns of ``t_rows`` rows,
    each column padded by one word."""
    return 4 * stripe * (t_rows + 1)


def gather_path(t_rows: int, width: int) -> tuple[int, int]:
    """The gather's design, by shape alone, as ``(stripe, holders)``:
    ``(0, 1)``, the per-lookup design, for a table of at most
    ``LOOKUP_TABLE_BYTES`` (read from L1), a width off 8 and a table too
    tall for the rest; ``(c, 1)``, the slab (the stripe's columns of
    every table row in one block's shared memory), the widest ``c`` of
    ``GATHER_STRIPES`` that divides the width and whose slab fits;
    ``(8, 2)``, the pair (a stripe of 8 columns held half by each block
    of a cluster of 2), where only that fits."""
    if 4 * t_rows * width <= LOOKUP_TABLE_BYTES:
        return 0, 1
    for c in GATHER_STRIPES:
        if width % c == 0 and _slab_bytes(c, t_rows) <= SHARED_BYTES:
            return c, 1
    if width % 8 == 0 and _slab_bytes(8, (t_rows + 1) // 2) <= SHARED_BYTES:
        return 8, 2
    return 0, 1


def _launch_table_gather(tab, idx, shift=None):
    _check_aligned("table_gather", tab, idx, shift)
    out = torch.empty_like(idx)
    stripe, holders = gather_path(tab.shape[0], tab.shape[1])
    _raise_on(kernel_library().tt_table_gather(
        tab.data_ptr(), idx.data_ptr(), _ptr(shift), out.data_ptr(),
        tab.shape[0], tab.shape[1], idx.numel(), stripe, holders,
        _stream(idx)), "table_gather")
    table_gather.launches += 1
    return out


def table_gather(tab, idx, shift=None):
    """``out[i, j] = tab[idx[i, j], j]``, with ``shift`` the bit lookup;
    ``tab [T, W]``, ``idx`` and ``shift`` ``[N, W]``, W a multiple of 4;
    see the module doc."""
    dev = _check("table_gather", tab, idx,
                 *(() if shift is None else (shift,)))
    if tab.dim() != 2 or idx.dim() != 2 or tab.shape[1] != idx.shape[1] \
            or tab.shape[0] < 1 or tab.shape[1] % 4 or (
                shift is not None and shift.shape != idx.shape):
        raise ValueError(
            f"table_gather: tab [T, W] and idx [N, W] (shift as idx), W a "
            f"multiple of 4, got {tuple(tab.shape)}, {tuple(idx.shape)}"
            f"{'' if shift is None else ', ' + str(tuple(shift.shape))}")
    _check_range("table_gather", idx, tab.shape[0])
    if dev.type == "cpu":
        return table_gather_reference(tab, idx, shift)
    with on_card(dev):
        return _launch_table_gather(tab, idx, shift)


def _launch_row_shuffle(v, idx):
    _check_aligned("row_shuffle", v, idx)
    out = torch.empty_like(v)
    _raise_on(kernel_library().tt_row_shuffle(
        v.data_ptr(), idx.data_ptr(), out.data_ptr(), v.shape[0],
        _stream(v)), "row_shuffle")
    row_shuffle.launches += 1
    return out


def row_shuffle(v, idx):
    """``out[i, j] = v[i, idx[i, j]]``, ``v`` and ``idx`` ``[N, 128]``;
    see the module doc."""
    dev = _check("row_shuffle", v, idx)
    if v.dim() != 2 or v.shape[1] != WIDTH or idx.shape != v.shape:
        raise ValueError(f"row_shuffle: v and idx must both be [N, {WIDTH}], "
                         f"got {tuple(v.shape)}, {tuple(idx.shape)}")
    _check_range("row_shuffle", idx, WIDTH)
    if dev.type == "cpu":
        return row_shuffle_reference(v, idx)
    with on_card(dev):
        return _launch_row_shuffle(v, idx)


def scatter_path(t_rows: int, width: int) -> int:
    """The scatter's design, by shape alone: the slab's stripe width, the
    widest of ``STRIPES`` that divides ``width`` and whose slab (its
    columns of every table row, ``C * (t_rows + 1)`` words) fits a
    block's shared memory; 0 where none fits: the global design, a global
    atomic or store an update into a zeroed table. Widths are multiples
    of 4, so a stripe is never partial."""
    for c in STRIPES:
        if width % c == 0 and 4 * c * (t_rows + 1) <= SHARED_BYTES:
            return c
    return 0


def _launch_table_scatter(idx, val, rows: int, mode: str):
    _check_aligned("table_scatter", idx, val)
    stripe = scatter_path(rows, idx.shape[1])
    tab = torch.zeros((rows, idx.shape[1]), dtype=torch.int32,
                      device=idx.device)
    _raise_on(kernel_library().tt_table_scatter(
        idx.data_ptr(), val.data_ptr(), tab.data_ptr(), rows, idx.shape[1],
        idx.numel(), SCATTER_MODES.index(mode), stripe, _stream(idx)),
        "table_scatter")
    table_scatter.launches += 1
    return tab


def table_scatter(idx, val, rows: int, mode: str):
    """A zeroed ``[rows, W]`` table updated by ``idx`` and ``val`` ``[N,
    W]`` (W a multiple of 4) in ``mode`` (``SCATTER_MODES``); see the
    module doc."""
    dev = _check("table_scatter", idx, val)
    if mode not in SCATTER_MODES:
        raise ValueError(f"table_scatter: mode must be one of "
                         f"{SCATTER_MODES}, got {mode!r}")
    if idx.dim() != 2 or idx.shape != val.shape or idx.shape[1] % 4 \
            or rows < 1:
        raise ValueError(f"table_scatter: idx and val [N, W], W a multiple "
                         f"of 4, rows >= 1, got {tuple(idx.shape)}, "
                         f"{tuple(val.shape)}, rows={rows}")
    _check_range("table_scatter", idx, rows)
    if dev.type == "cpu":
        return table_scatter_reference(idx, val, rows, mode)
    with on_card(dev):
        return _launch_table_scatter(idx, val, rows, mode)


def _launch_tile_transpose(v):
    _check_aligned("tile_transpose", v)
    out = torch.empty_like(v)
    _raise_on(kernel_library().tt_tile_transpose(
        v.data_ptr(), out.data_ptr(), v.shape[0], _stream(v)),
        "tile_transpose")
    tile_transpose.launches += 1
    return out


def tile_transpose(v):
    """Each 128 x 128 tile of ``v [N, 128]`` (N a multiple of 128)
    transposed; see the module doc."""
    dev = _check("tile_transpose", v)
    if v.dim() != 2 or v.shape[1] != WIDTH or v.shape[0] % WIDTH:
        raise ValueError(f"tile_transpose: v must be [N, {WIDTH}] with N a "
                         f"multiple of {WIDTH}, got {tuple(v.shape)}")
    if dev.type == "cpu":
        return tile_transpose_reference(v)
    with on_card(dev):
        return _launch_tile_transpose(v)


def segment_path(length: int) -> int:
    """The segment copy's design, by the segment's length (int32 words)
    alone: 1, warps copying int4s a lane, for segments of at most
    ``WARP_COPY_BYTES``; 0, bulk copies through shared memory, for longer
    ones."""
    return 1 if 4 * length <= WARP_COPY_BYTES else 0


def _launch_segment_copy(src, starts, outpos, length: int, out_len: int,
                         lens=None, inflight: int = 8):
    _check_aligned("segment_copy", src)
    out = torch.empty(out_len, dtype=torch.int32, device=src.device)
    _raise_on(kernel_library().tt_segment_copy(
        src.data_ptr(), starts.data_ptr(), _ptr(lens), outpos.data_ptr(),
        out.data_ptr(), starts.numel(), length, inflight,
        segment_path(length), _stream(src)), "segment_copy")
    segment_copy.launches += 1
    return out


def _check_segments(src, starts, outpos, length: int, out_len: int,
                    lens, inflight: int) -> None:
    if src.dim() != 1 or starts.dim() != 1 or starts.shape != outpos.shape \
            or (lens is not None and lens.shape != starts.shape):
        raise ValueError("segment_copy: src, starts, outpos (and lens) must "
                         "be 1-d, starts, outpos and lens of one length")
    if length < 4 or length % 4 or out_len < 0:
        raise ValueError(f"segment_copy: length must be a positive multiple "
                         f"of 4 words (16 bytes), got {length}; out_len "
                         f"{out_len}")
    if not 1 <= inflight <= MAX_INFLIGHT \
            or inflight * length * 4 > MAX_STAGE_BYTES \
            or length * 4 > MAX_COPY_BYTES:
        raise ValueError(f"segment_copy: {inflight} stages of {length * 4} "
                         f"bytes do not fit a block's {MAX_STAGE_BYTES} "
                         f"bytes (inflight in [1, {MAX_INFLIGHT}], a copy "
                         f"at most {MAX_COPY_BYTES} bytes)")
    if lens is not None:
        live = lens > 0
        starts, outpos = starts[live], outpos[live]
    if not starts.numel():
        return
    bad = torch.stack([
        (starts < 0).any(), (starts.long() + length > src.numel()).any(),
        (outpos < 0).any(), (outpos.long() + length > out_len).any(),
        (starts % 4 != 0).any() | (outpos % 4 != 0).any()]).tolist()
    for flag, why in zip(bad, (
            "reads before src", "reads past src's end", "writes before out",
            "writes past out's end", "is not 16-byte aligned (an offset "
            "not a multiple of 4 words)")):
        if flag:
            raise ValueError(f"segment_copy: a live segment {why}")


def segment_copy(src, starts, outpos, length: int, out_len: int, lens=None,
                 inflight: int = 8):
    """Copy ``length`` words from ``src`` at each live segment's start to
    its ``outpos`` in a new ``[out_len]`` array; see the module doc."""
    dev = _check("segment_copy", src, starts, outpos,
                 *(() if lens is None else (lens,)))
    _check_segments(src, starts, outpos, length, out_len, lens, inflight)
    if dev.type == "cpu":
        return segment_copy_reference(src, starts, outpos, length, out_len,
                                      lens, inflight)
    with on_card(dev):
        return _launch_segment_copy(src, starts, outpos, length, out_len,
                                    lens, inflight)


#: the six wrappers, each with its ``launches`` count
KERNELS = (stream_copy, table_gather, row_shuffle, table_scatter,
           tile_transpose, segment_copy)
for _k in KERNELS:
    _k.launches = 0
del _k


# ------------------------------------------------------------------ timing

#: calls a timed sample holds back to back
BACK_TO_BACK = 5


def _time(fn, reps: int) -> tuple[float, float]:
    """(best, median) ms of one ``fn()`` on the card by CUDA events,
    after one warm-up call. Each of ``reps`` samples times
    ``BACK_TO_BACK`` calls back to back and divides by their number; an
    untimed call is enqueued before the start event, so the host's
    dispatch of the timed calls (allocation, checks, the ctypes call:
    10-20 us) overlaps the card's work and a sample is the card's time,
    not the time it waited for a call's dispatch (a kernel shorter than
    its dispatch still waits)."""
    fn()
    torch.cuda.synchronize()
    ms = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        fn()
        a.record()
        for _ in range(BACK_TO_BACK):
            fn()
        b.record()
        b.synchronize()
        ms.append(a.elapsed_time(b) / BACK_TO_BACK)
    return min(ms), statistics.median(ms)


def _segment_inputs(p: dict, gen, dev):
    """A segment-copy probe's (src, starts, outpos, length, out_len, lens,
    inflight, library, lib_name): probe3_dma's pool with starts k * deg,
    each segment ``pad`` words to k * pad; probe3d's pool of 128-word rows
    with random row starts, each segment ``seg_rows`` rows to
    k * seg_rows rows. ``library`` is one PyTorch call whose output is
    ``out``: the segments as rows of an ``as_strided`` view of the pool,
    cloned (probe3_dma; it also copies dead segments, and every probe's
    segment is live) or picked by ``index_select`` (probe3d)."""
    n = p["nseg"]
    if "pool" in p:
        src = torch.randint(0, 2**20, (p["pool"],), generator=gen,
                            device=dev, dtype=torch.int32)
        k = torch.arange(n, device=dev, dtype=torch.int32)
        lens = torch.full((n,), p["deg"], device=dev, dtype=torch.int32)
        deg, pad = p["deg"], p["pad"]

        def library():
            return src.as_strided((n, pad), (deg, 1)).clone()
        return (src, k * deg, k * pad, pad, n * pad, lens, p["inflight"],
                library, f"src.as_strided(({n}, {pad}), ({deg}, 1)).clone()")
    rows = p["seg_rows"]
    src = (torch.arange(p["src_rows"] * WIDTH, device=dev,
                        dtype=torch.int32) % 1000)
    row_starts = torch.randint(0, p["src_rows"] - rows, (n,), generator=gen,
                               device=dev, dtype=torch.int32)
    k = torch.arange(n, device=dev, dtype=torch.int32)
    windows = (p["src_rows"] - rows + 1, rows * WIDTH)

    def library():
        return src.as_strided(windows, (WIDTH, 1)).index_select(0,
                                                                row_starts)
    return (src, row_starts * WIDTH, k * (rows * WIDTH), rows * WIDTH,
            n * rows * WIDTH, None, p["inflight"], library,
            f"src.as_strided({windows}, (128, 1)).index_select(0, starts)")


def _probe(kernel: str, p: dict, gen, dev) -> dict:
    """One probe's inputs as closures: ``wrapper`` (checked, launches
    once), ``kernel`` (the launch alone), ``plain``, ``library`` (or
    None), its element count, byte model, sector model (or None), where
    its random accesses land and, for the kernels that pick a design by
    shape, the design (``path``)."""
    ri = functools.partial(torch.randint, generator=gen, device=dev,
                           dtype=torch.int32)
    if kernel == "stream_copy":
        x = ri(0, 100, (p["rows"], WIDTH))
        out = torch.empty_like(x)
        return dict(args=(x,), launch=_launch_stream_copy,
                    plain=stream_copy_reference, lib_name="out.copy_(x)",
                    library=lambda: out.copy_(x), n=x.numel(),
                    bytes=copy_bytes(x.numel()), sectors=None, where="HBM")
    if kernel == "table_gather":
        t, bits = p["t_rows"], p.get("bits", False)
        tab = ri(0, 2**20, (t, WIDTH))
        idx = ri(0, t, (p["rows"], WIDTH))
        args = (tab, idx, ri(0, 32, idx.shape)) if bits else (tab, idx)
        n = idx.numel()
        table = 4 * t * WIDTH
        far = table > L2_BYTES
        return dict(args=args, launch=_launch_table_gather,
                    plain=table_gather_reference,
                    lib_name=None if bits else "torch.gather(tab, 0, idx)",
                    library=None if bits
                    else lambda: torch.gather(tab, 0, idx),
                    n=n, bytes=gather_bytes(t, n, bits=bits),
                    path=gather_path(t, WIDTH),
                    sectors=gather_sector_bytes(n, bits) if far else None,
                    where="HBM table" if far else "L2 table")
    if kernel == "row_shuffle":
        v = ri(0, 100, (p["rows"], WIDTH))
        idx = ri(0, WIDTH, v.shape)
        return dict(args=(v, idx), launch=_launch_row_shuffle,
                    plain=row_shuffle_reference,
                    lib_name="torch.gather(v, 1, idx)",
                    library=lambda: torch.gather(v, 1, idx), n=v.numel(),
                    bytes=shuffle_bytes(v.numel()), sectors=None,
                    where="HBM")
    if kernel == "table_scatter":
        t, mode = p["t_rows"], p["mode"]
        idx = ri(0, t, (p["rows"], WIDTH))
        val = ri(0, 100, idx.shape)
        acc = torch.zeros((t, WIDTH), dtype=torch.int32, device=dev)
        if mode == "set":
            lib_name = "acc.scatter_(0, idx, val)"

            def library():
                return acc.scatter_(0, idx, val)
        else:
            reduce = _SCATTER_REDUCE[mode]
            lib_name = f"acc.scatter_reduce_(0, idx, val, {reduce!r})"

            def library():
                return acc.scatter_reduce_(0, idx, val, reduce)
        return dict(args=(idx, val, t, mode), launch=_launch_table_scatter,
                    plain=table_scatter_reference, lib_name=lib_name,
                    library=library, n=idx.numel(),
                    bytes=scatter_bytes(idx.numel(), t), sectors=None,
                    path=scatter_path(t, WIDTH),
                    where="L2 table")
    if kernel == "tile_transpose":
        v = ri(0, 100, (p["rows"], WIDTH))
        return dict(args=(v,), launch=_launch_tile_transpose,
                    plain=tile_transpose_reference,
                    lib_name="v.view(-1, 128, 128).transpose(1, 2)"
                             ".contiguous()",
                    library=lambda: v.view(-1, WIDTH, WIDTH).transpose(
                        1, 2).contiguous(), n=v.numel(),
                    bytes=transpose_bytes(v.numel()), sectors=None,
                    where="HBM")
    src, starts, outpos, length, out_len, lens, inflight, library, \
        lib_name = _segment_inputs(p, gen, dev)
    n = starts.numel()
    return dict(args=(src, starts, outpos, length, out_len, lens, inflight),
                launch=_launch_segment_copy, plain=segment_copy_reference,
                lib_name=lib_name, library=library, n=n * length,
                path=segment_path(length),
                bytes=segment_bytes(starts, outpos, length, lens),
                sectors=None, where="HBM")


def _max_abs_err(kernel: str, got, want, args) -> int:
    """0 when the kernel's output is right; for ``set``, 0 when
    ``scatter_set_ok`` holds. Raises on a wrong output: a probe's rate
    means nothing when its kernel is wrong."""
    if kernel == "table_scatter" and args[3] == "set":
        ok, err = scatter_set_ok(got, args[0], args[1]), 0
    else:
        if kernel == "segment_copy":
            _, _, outpos, length, _, lens, _ = args
            if lens is not None:
                outpos = outpos[lens > 0]
            step = torch.arange(length, device=got.device)
            at = (outpos.long()[:, None] + step).reshape(-1)
            got, want = got[at], want[at]
        ok = got.shape == want.shape
        differ = got != want if ok else None
        err = int((got[differ].long() - want[differ].long()).abs().max()) \
            if ok and differ.any() else 0
        ok = ok and err == 0
    if not ok:
        raise RuntimeError(f"{kernel}: the kernel disagrees with its plain "
                           f"version (max |diff| {err})")
    return err


def run_probes(device=None, reps: int = 5, seed: int = 0) -> list[dict]:
    """Time every probe of ``PROBES`` on the card: the kernel (each probe
    checked once through its wrapper and held to its plain version, then
    the launch alone timed by ``_time``: best and median of ``reps``
    samples of ``BACK_TO_BACK`` calls, by CUDA events), the plain version
    and the library call where there is one. Inputs come from ``seed`` on
    the card. Raises on the CPU, where no card figure can be taken. One
    record a probe: ms, G elem/s (the unit the TPU probes print), GB/s of
    the byte model, the bound (``bound_ms``) and its share, the sector
    model's bound and share for a table beyond L2 (and the rate of the
    lookups' sectors alone), where the random accesses land, the plain
    version's and the library call's ms, and the design the wrapper
    took (``gather_path``, ``scatter_path``, ``segment_path``; None for
    the kernels with one)."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError("run_probes times the kernels on a card; a CPU run "
                         "gives no card figure")
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    wrappers = {k.__name__: k for k in KERNELS}
    records = []
    with on_card(dev):
        for kernel, label, p, source in PROBES:
            pr = _probe(kernel, p, gen, dev)
            args = pr["args"]
            got = wrappers[kernel](*args)
            want = pr["plain"](*args)
            err = _max_abs_err(kernel, got, want, args)
            del got, want
            ms, med = _time(lambda: pr["launch"](*args), reps)
            plain_ms, _ = _time(lambda: pr["plain"](*args), reps)
            lib_ms = None if pr["library"] is None \
                else _time(pr["library"], reps)[0]
            b = bound_ms(pr["bytes"])
            rec = {"kernel": kernel, "probe": label, "source": source,
                   "shape": p, "elements": pr["n"], "ms": ms,
                   "median_ms": med, "g_elem_s": pr["n"] / ms / 1e6,
                   "bytes": pr["bytes"], "gb_s": pr["bytes"] / ms / 1e6,
                   "bound_ms": b, "share": b / ms, "where": pr["where"],
                   "sector_bytes": pr["sectors"], "sector_bound_ms": None,
                   "sector_share": None, "max_abs_err": err,
                   "plain_ms": plain_ms, "library": pr["lib_name"],
                   "library_ms": lib_ms, "path": pr.get("path")}
            if pr["sectors"] is not None:
                rec["sector_bound_ms"] = bound_ms(pr["sectors"])
                rec["sector_share"] = rec["sector_bound_ms"] / ms
                rec["sector_gb_s"] = pr["sectors"] / ms / 1e6
                # the lookups' sectors alone, without the idx/out streams
                rec["lookup_sector_gb_s"] = SECTOR_BYTES * pr["n"] / ms / 1e6
            records.append(rec)
            del pr, args
            torch.cuda.empty_cache()
    return records
