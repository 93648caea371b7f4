"""The access-pattern probes of experiments/ (titan_tpu_torch.ops.probes),
on the CPU.

Every probe kernel's plain version is held bit-equal to the JAX probe run
in Pallas's interpret mode: either the probe module's own kernel function
passed to ``pl.pallas_call(..., interpret=True)`` at a small grid, or the
probe's own jitted function inside ``pltpu.force_tpu_interpret_mode()``,
comparing the scalar checksum it returns (its shapes cut through
``monkeypatch`` on the loaded module, in the test alone). Where the JAX
probe defines no output (the scatter, whose kernel never writes its
output and starts from an uninitialised scratch; probe3b's V1-V6 and
probe3c's W1-W3, which run their cases at import and print only OK or
FAIL, so they are not imported) the plain version is held to numpy.

Also: the wrappers' refusals, the CPU path's ``launches`` staying 0, the
byte models against hand counts, ``run_probes`` refusing the CPU, and
``PROBES``' copies of the probes' shapes against the probe modules. The
kernels themselves are held to these plain versions on the card by
chip_smoke.py's phase 21.
"""

import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from titan_tpu_torch.ops import probes as PR

ROOT = pathlib.Path(__file__).resolve().parent.parent
I32 = np.int32


def _load(name: str):
    spec = importlib.util.spec_from_file_location(
        f"_experiment_{name}", ROOT / "experiments" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def pg():
    return _load("probe_pallas_gather")


@pytest.fixture(scope="module")
def p2():
    return _load("probe2_rates")


@pytest.fixture(scope="module")
def bench():
    return _load("pallas_gather_bench")


@pytest.fixture(scope="module")
def p3():
    return _load("probe3_dma")


@pytest.fixture(scope="module")
def p3d():
    return _load("probe3d_rate")


def _t(a):
    return torch.from_numpy(np.array(a, dtype=I32))


def _interpret(kernel, out_rows, in_specs, *args, block=None):
    """``kernel`` through ``pl.pallas_call`` in interpret mode, a grid over
    blocks of ``block`` rows of a [out_rows, 128] int32 output."""
    block = block or out_rows
    return np.asarray(pl.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct((out_rows, 128), jnp.int32),
        grid=(out_rows // block,), in_specs=in_specs,
        out_specs=pl.BlockSpec((block, 128), lambda i: (i, 0)),
        interpret=True)(*args))


def _rows(block):
    return pl.BlockSpec((block, 128), lambda i: (i, 0))


def _whole(rows):
    return pl.BlockSpec((rows, 128), lambda i: (0, 0))


# ------------------------------------------------------------------ gather

@pytest.mark.parametrize("t_rows", [8, 64, 448])
def test_gather_kernel_matches_jax(pg, bench, t_rows):
    """gather_kernel of probe_pallas_gather and of pallas_gather_bench
    (the same body) against table_gather on the CPU."""
    rng = np.random.default_rng(t_rows)
    tab = rng.integers(0, 1 << 20, (t_rows, 128), dtype=I32)
    idx = rng.integers(0, t_rows, (64, 128), dtype=I32)
    want = PR.table_gather(_t(tab), _t(idx)).numpy()
    for mod in (pg, bench):
        got = _interpret(mod.gather_kernel, 64, [_whole(t_rows), _rows(32)],
                         tab, idx, block=32)
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(want, np.take_along_axis(tab, idx, 0))


def test_lane_gather_and_its_checksum(pg, monkeypatch):
    """probe_pallas_gather's lane_gather_check (whole output) and
    lane_gather (its checksum) at R = 64, CHUNK = 16, STEPS = 4."""
    for name, value in (("R", 64), ("CHUNK", 16), ("STEPS", 4)):
        monkeypatch.setattr(pg, name, value)
    rng = np.random.default_rng(1)
    tab = rng.integers(0, 1 << 20, (64, 128), dtype=I32)
    idx = rng.integers(0, 64, (64, 128), dtype=I32)
    want = PR.table_gather(_t(tab), _t(idx))
    with pltpu.force_tpu_interpret_mode():
        whole = np.asarray(pg.lane_gather_check(jnp.asarray(tab),
                                                jnp.asarray(idx)))
        total = int(pg.lane_gather(jnp.asarray(tab), jnp.asarray(idx)))
    np.testing.assert_array_equal(whole, want.numpy())
    assert total == int(want[::16 * 8].sum())


def test_pallas_gather_bench_run_checksum(bench):
    """pallas_gather_bench.run (T == BLK, as its main runs it) returns the
    sum of the gathered words."""
    rng = np.random.default_rng(2)
    t_rows = 16
    tab = rng.integers(0, 100, (t_rows, 128), dtype=I32)
    idx = rng.integers(0, t_rows, (64, 128), dtype=I32)
    with pltpu.force_tpu_interpret_mode():
        total = int(bench.run(jnp.asarray(tab), jnp.asarray(idx), T=t_rows,
                              BLK=t_rows))
    assert total == int(PR.table_gather(_t(tab), _t(idx)).sum())


def test_vreg_gather_tile_is_the_eight_row_table(p2, monkeypatch):
    """probe2_rates' vreg_gather: kernel2 over the 8-row table tiled to a
    block (its checksum through g, R = 16, STEPS = 32) and
    vreg_gather_kernel (the same body, whole output) equal table_gather
    from the 8 rows themselves, the port's form of the probe."""
    monkeypatch.setattr(p2, "R", 16)
    monkeypatch.setattr(p2, "STEPS", 32)
    rng = np.random.default_rng(3)
    tab8 = rng.integers(0, 1 << 20, (8, 128), dtype=I32)
    idx = rng.integers(0, 8, (512, 128), dtype=I32)
    want = PR.table_gather(_t(tab8), _t(idx))
    with pltpu.force_tpu_interpret_mode():
        g, tiled = p2.vreg_gather(jnp.asarray(tab8), jnp.asarray(idx))
        total = int(g(tiled, jnp.asarray(idx)))
    assert total == int(want[::16 * 16].sum())
    got = _interpret(p2.vreg_gather_kernel, 512, [_whole(16), _rows(16)],
                     np.tile(tab8, (2, 1)), idx, block=16)
    np.testing.assert_array_equal(got, want.numpy())


def test_lookup1024_is_the_bit_epilogue(p2, monkeypatch):
    """probe2_rates' lookup1024_kernel (whole output, and lookup1024's
    checksum at R = 16, STEPS = 32) equals table_gather with shifts from
    the 8 rows: words in [0, 2^20), shifts in [0, 32), so every bit
    above 19 reads 0 and the arithmetic shift never fills."""
    monkeypatch.setattr(p2, "R", 16)
    monkeypatch.setattr(p2, "STEPS", 32)
    rng = np.random.default_rng(4)
    tab8 = rng.integers(0, 1 << 20, (8, 128), dtype=I32)
    rowsel = rng.integers(0, 8, (512, 128), dtype=I32)
    shift = rng.integers(0, 32, (512, 128), dtype=I32)
    want = PR.table_gather(_t(tab8), _t(rowsel), _t(shift))
    tiled = np.tile(tab8, (2, 1))
    got = _interpret(p2.lookup1024_kernel, 512,
                     [_whole(16), _rows(16), _rows(16)], tiled, rowsel,
                     shift, block=16)
    np.testing.assert_array_equal(got, want.numpy())
    with pltpu.force_tpu_interpret_mode():
        total = int(p2.lookup1024(jnp.asarray(tiled), jnp.asarray(rowsel),
                                  jnp.asarray(shift))(
            jnp.asarray(tiled), jnp.asarray(rowsel), jnp.asarray(shift)))
    assert total == int(want[::16 * 16].sum())
    assert set(np.unique(want.numpy())) <= {0, 1}


# ----------------------------------------------------------------- shuffle

def test_shuffle_kernels_match_jax(pg, p2, monkeypatch):
    """shuffle_kernel of both probe modules (whole output), lane_shuffle's
    checksum (CHUNK = 16, STEPS = 4) and probe2's stream1 checksum
    (R = 16, STEPS = 32) against row_shuffle."""
    rng = np.random.default_rng(5)
    v = rng.integers(-2**31, 2**31 - 1, (512, 128), dtype=I32)
    idx = rng.integers(0, 128, (512, 128), dtype=I32)
    want = PR.row_shuffle(_t(v), _t(idx))
    for mod in (pg, p2):
        got = _interpret(mod.shuffle_kernel, 512, [_rows(64), _rows(64)],
                         v, idx, block=64)
        np.testing.assert_array_equal(got, want.numpy())
    small = rng.integers(0, 100, (64, 128), dtype=I32)
    for name, value in (("CHUNK", 16), ("STEPS", 4)):
        monkeypatch.setattr(pg, name, value)
    monkeypatch.setattr(p2, "R", 16)
    monkeypatch.setattr(p2, "STEPS", 32)
    with pltpu.force_tpu_interpret_mode():
        lane = int(pg.lane_shuffle(jnp.asarray(small), jnp.asarray(idx[:64])))
        streamed = int(p2.stream1(p2.shuffle_kernel, 2)(
            jnp.asarray(np.abs(v) % 100), jnp.asarray(idx)))
    assert lane == int(PR.row_shuffle(_t(small), _t(idx[:64]))[::128].sum())
    assert streamed == int(
        PR.row_shuffle(_t(np.abs(v) % 100), _t(idx))[::16 * 16].sum())


# -------------------------------------------------------- copy, transpose

def test_copy_kernel_matches_jax(pg, p2, monkeypatch):
    """copy_kernel (whole output; probe2's copy lambda at :178 is the same
    assignment through stream1), stream_copy's checksum and stream1's
    against stream_copy."""
    rng = np.random.default_rng(6)
    x = rng.integers(0, 100, (512, 128), dtype=I32)
    want = PR.stream_copy(_t(x))
    got = _interpret(pg.copy_kernel, 512, [_rows(64)], x, block=64)
    np.testing.assert_array_equal(got, want.numpy())
    for name, value in (("CHUNK", 64), ("STEPS", 8)):
        monkeypatch.setattr(pg, name, value)
    monkeypatch.setattr(p2, "R", 16)
    monkeypatch.setattr(p2, "STEPS", 32)
    with pltpu.force_tpu_interpret_mode():
        total = int(pg.stream_copy(jnp.asarray(x)))
        streamed = int(p2.stream1(pg.copy_kernel, 1)(jnp.asarray(x)))
    assert total == int(want[::64 * 8].sum())
    assert streamed == int(want[::16 * 16].sum())


def test_transpose_kernel_matches_jax(p2, monkeypatch):
    """probe2_rates' transpose_kernel over blocks of R = 256 rows (two
    128 x 128 tiles a block, two blocks) against tile_transpose."""
    monkeypatch.setattr(p2, "R", 256)
    rng = np.random.default_rng(7)
    v = rng.integers(-2**31, 2**31 - 1, (512, 128), dtype=I32)
    want = PR.tile_transpose(_t(v)).numpy()
    got = _interpret(p2.transpose_kernel, 512, [_rows(256)], v, block=256)
    np.testing.assert_array_equal(got, want)
    tiles = v.reshape(4, 128, 128)
    np.testing.assert_array_equal(
        want, tiles.transpose(0, 2, 1).reshape(512, 128))


# ----------------------------------------------------------------- scatter

def _numpy_scatter(idx, val, rows, mode):
    tab = np.zeros((rows, idx.shape[1]), I32)
    cols = np.broadcast_to(np.arange(idx.shape[1]), idx.shape)
    if mode == "set":
        tab[idx, cols] = val
    elif mode == "max":
        np.maximum.at(tab, (idx, cols), val)
    else:
        np.add.at(tab, (idx, cols), val)
    return tab


@pytest.mark.parametrize("mode", PR.SCATTER_MODES)
@pytest.mark.parametrize("rows,n", [(8, 3), (64, 200), (4096, 64)])
def test_scatter_plain_matches_numpy(mode, rows, n):
    """The scatter probe writes no output and starts from an
    uninitialised scratch (ROADMAP queue 3), so the plain version is held
    to numpy on a zeroed table: max and add exactly (add wraps as int32),
    set by membership."""
    rng = np.random.default_rng(rows * n)
    idx = rng.integers(0, rows, (n, 128), dtype=I32)
    lo, hi = (-2**31, 2**31 - 1) if mode == "add" else (-100, 100)
    val = rng.integers(lo, hi, (n, 128), dtype=I32)
    got = PR.table_scatter(_t(idx), _t(val), rows, mode)
    want = _numpy_scatter(idx, val, rows, mode)
    if mode == "set":
        assert PR.scatter_set_ok(got, _t(idx), _t(val))
        assert PR.scatter_set_ok(_t(want), _t(idx), _t(val))
    else:
        np.testing.assert_array_equal(got.numpy(), want)


def test_scatter_set_ok_refuses_wrong_tables():
    rng = np.random.default_rng(8)
    idx = _t(rng.integers(0, 16, (40, 128), dtype=I32))
    val = _t(rng.integers(1, 100, (40, 128), dtype=I32))
    good = PR.table_scatter(idx, val, 16, "set")
    assert PR.scatter_set_ok(good, idx, val)
    written = good != 0
    wrong = good.clone()
    wrong[written.nonzero()[0][0], written.nonzero()[0][1]] = 1000
    assert not PR.scatter_set_ok(wrong, idx, val)
    stray = good.clone()
    stray[~written] = 5
    assert (~written).any() and not PR.scatter_set_ok(stray, idx, val)


@pytest.mark.parametrize("t_rows,width,stripe", [
    (4096, 128, 8), (7, 128, 8), (1, 8, 8),
    (7263, 128, 8),      # 8 x 7264 words: 232,448 B, the limit
    (7264, 128, 4),      # one row more: stripes of 4
    (14527, 128, 4),     # 4 x 14528 words: the limit
    (14528, 128, 0),     # past it: the global kernel
    (4096, 4, 4), (4096, 12, 4), (4096, 132, 4), (7, 12, 4),
    (14528, 12, 0), (20000, 4, 0)])
def test_scatter_path_by_shape(t_rows, width, stripe):
    """The scatter's design is a pure function of the table's shape: the
    widest stripe that divides the width and whose slab fits a block's
    shared memory, else 0 (the global kernel); a width of 4k is never
    left with a partial stripe."""
    assert PR.scatter_path(t_rows, width) == stripe
    if stripe:
        assert width % stripe == 0
        assert 4 * stripe * (t_rows + 1) <= PR.SHARED_BYTES


@pytest.mark.parametrize("t_rows,width", [(7, 128), (14528, 12), (20, 4)])
def test_scatter_plain_on_every_path_shape(t_rows, width):
    """The plain version at shapes of each design, against numpy."""
    rng = np.random.default_rng(t_rows + width)
    idx = rng.integers(0, t_rows, (33, width), dtype=I32)
    for mode in PR.SCATTER_MODES:
        val = rng.integers(-100, 100, (33, width), dtype=I32)
        got = PR.table_scatter(_t(idx), _t(val), t_rows, mode)
        if mode == "set":
            assert PR.scatter_set_ok(got, _t(idx), _t(val))
        else:
            np.testing.assert_array_equal(
                got.numpy(), _numpy_scatter(idx, val, t_rows, mode))


# ------------------------------------------------------------ segment copy

def _written(out, outpos, length, lens=None):
    outpos = np.asarray(outpos)
    if lens is not None:
        outpos = outpos[np.asarray(lens) > 0]
    at = (outpos[:, None] + np.arange(length)).reshape(-1)
    return np.asarray(out)[at]


@pytest.mark.parametrize("deg", [32, 128])
def test_probe3_dma_kernel_matches_jax(p3, deg):
    """probe3_dma.make_kernel(128) with its PrefetchScalarGridSpec in
    interpret mode, 1024 segments (two grid steps of 512), every 7th
    segment dead: the live segments' output ranges equal segment_copy's
    (the dead ones are never written, as in the port)."""
    pad, n_seg = 128, 1024
    rng = np.random.default_rng(deg)
    edges = rng.integers(0, 1 << 20, (n_seg * deg + pad,), dtype=I32)
    starts = np.arange(n_seg, dtype=I32) * deg
    lens = np.where(np.arange(n_seg) % 7 == 3, 0, deg).astype(I32)
    outpos = np.arange(n_seg, dtype=I32) * pad
    gs = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=3, grid=(n_seg // p3.SEG_PER_BLOCK,),
        in_specs=[pl.BlockSpec(memory_space=pl.ANY)],
        out_specs=pl.BlockSpec(memory_space=pl.ANY),
        scratch_shapes=[pltpu.VMEM((8, 128), jnp.int32),
                        pltpu.SemaphoreType.DMA((8,))])
    got = pl.pallas_call(
        p3.make_kernel(pad),
        out_shape=jax.ShapeDtypeStruct((n_seg * pad,), jnp.int32),
        grid_spec=gs, interpret=True)(
            jnp.asarray(starts), jnp.asarray(lens), jnp.asarray(outpos),
            jnp.asarray(edges))
    want = PR.segment_copy(_t(edges), _t(starts), _t(outpos), pad,
                           n_seg * pad, _t(lens))
    np.testing.assert_array_equal(_written(got, outpos, pad, lens),
                                  _written(want, outpos, pad, lens))
    np.testing.assert_array_equal(
        _written(want, outpos, pad, lens),
        np.concatenate([edges[s:s + pad] for s, ln in zip(starts, lens)
                        if ln > 0]))


@pytest.mark.parametrize("nseg,rows,inflight", [(64, 4, 8), (128, 1, 16)])
def test_probe3d_seg_copy_checksum(p3d, nseg, rows, inflight):
    """probe3d_rate.seg_copy under the interpreter (its own module pool of
    2^17 rows) returns the checksum ``out[::64, 0].sum()`` of the row
    segments; segment_copy of the same rows gives it."""
    rng = np.random.default_rng(nseg + rows)
    starts = rng.integers(0, p3d.R - rows, (nseg,), dtype=I32)
    with pltpu.force_tpu_interpret_mode():
        total = int(p3d.seg_copy(nseg, rows, inflight)(
            jnp.asarray(starts), p3d.edges2d))
    src = _t(np.asarray(p3d.edges2d)).view(-1)
    k = np.arange(nseg, dtype=I32)
    out = PR.segment_copy(src, _t(starts * 128), _t(k * rows * 128),
                          rows * 128, nseg * rows * 128,
                          inflight=inflight).view(-1, 128)
    assert total == int(out[::64, 0].sum())


def _v_cases():
    """probe3b_bisect's V1-V6 (E = 2^22, the pool arange): (name, starts,
    outpos, out_len, lens, inflight)."""
    e = 1 << 22
    st = (np.arange(1024, dtype=I32) * 128) % (e - 256)
    k = np.arange(1024, dtype=I32)
    z = np.zeros(1, I32)
    return e, [("V1", z, z, 256, None, 1), ("V2", z, z, 256, None, 1),
               ("V3", st[:1], z, 256, None, 1),
               ("V4", st, k * 128, 1024 * 128, None, 1),
               ("V5", st, k * 128, 1024 * 128, (st >= 0).astype(I32), 1),
               ("V6", st, k * 128, 1024 * 128, None, 8)]


@pytest.mark.parametrize("case", range(6))
def test_probe3b_cases_match_numpy(case):
    """V1-V6 write 128-word segments (V1-V3 half of a 256-word output):
    the written ranges equal numpy's slices."""
    e, cases = _v_cases()
    name, starts, outpos, out_len, lens, inflight = cases[case]
    src = np.arange(e, dtype=I32)
    out = PR.segment_copy(_t(src), _t(starts), _t(outpos), 128, out_len,
                          None if lens is None else _t(lens), inflight)
    want = np.concatenate([src[s:s + 128] for s in starts])
    np.testing.assert_array_equal(_written(out, outpos, 128), want, name)


@pytest.mark.parametrize("case", ["W1", "W2", "W3"])
def test_probe3c_cases_match_numpy(case):
    """W1 (rows 0-7 into an [8, 128] output), W2 (1024 dynamic 8-row
    segments, one in flight) and W3 (4096, eight in flight) of a
    [2^15, 128] pool, as row segments (starts * 128, 1024 words)."""
    r = 1 << 15
    src = np.arange(r * 128, dtype=I32).reshape(r, 128)
    st = (np.arange(4096, dtype=I32) * 7) % (r - 8)
    n, inflight = {"W1": (1, 1), "W2": (1024, 1), "W3": (4096, 8)}[case]
    starts = np.zeros(1, I32) if case == "W1" else st[:n]
    out = PR.segment_copy(_t(src.reshape(-1)), _t(starts * 128),
                          _t(np.arange(n, dtype=I32) * 1024), 1024,
                          n * 1024, inflight=inflight).view(-1, 128)
    np.testing.assert_array_equal(
        out.numpy(), np.concatenate([src[s:s + 8] for s in starts]))


# --------------------------------------------------------------- refusals

def _ok():
    rng = np.random.default_rng(9)
    return (_t(rng.integers(0, 8, (8, 128), dtype=I32)),
            _t(rng.integers(0, 8, (16, 128), dtype=I32)))


@pytest.mark.parametrize("call", [
    lambda t, i: PR.stream_copy(t.long()),
    lambda t, i: PR.stream_copy(t.t()),
    lambda t, i: PR.table_gather(t, i.long()),
    lambda t, i: PR.table_gather(t, i + 8),
    lambda t, i: PR.table_gather(t, i - 1),
    lambda t, i: PR.table_gather(t[:, :126].contiguous(), i[:, :126]
                                 .contiguous()),
    lambda t, i: PR.table_gather(t, i, i[:8]),
    lambda t, i: PR.table_gather(t[:, :64].contiguous(), i),
    lambda t, i: PR.row_shuffle(i, i + 128),
    lambda t, i: PR.row_shuffle(i[:, :64].contiguous(),
                                i[:, :64].contiguous()),
    lambda t, i: PR.row_shuffle(i, i[:8]),
    lambda t, i: PR.table_scatter(i, i, 8, "min"),
    lambda t, i: PR.table_scatter(i, i, 7, "add"),
    lambda t, i: PR.table_scatter(i, i[:8], 8, "add"),
    lambda t, i: PR.table_scatter(i, i.float(), 8, "add"),
    lambda t, i: PR.tile_transpose(i),
    lambda t, i: PR.tile_transpose(torch.zeros((128, 64), dtype=torch.int32)),
], ids=["copy-dtype", "copy-strided", "gather-dtype", "gather-high",
        "gather-negative", "gather-width", "gather-shift-shape",
        "gather-widths-differ", "shuffle-high", "shuffle-width",
        "shuffle-shapes", "scatter-mode", "scatter-rows", "scatter-shapes",
        "scatter-dtype", "transpose-rows", "transpose-width"])
def test_wrappers_refuse(call):
    tab, idx = _ok()
    with pytest.raises(ValueError):
        call(tab, idx)


SRC = torch.arange(1024, dtype=torch.int32)


@pytest.mark.parametrize("starts,outpos,length,out_len,lens,inflight", [
    ([1020], [0], 8, 64, None, 1),          # reads past src's end
    ([-4], [0], 8, 64, None, 1),            # reads before src
    ([0], [60], 8, 64, None, 1),            # writes past out's end
    ([0], [-8], 8, 64, None, 1),            # writes before out
    ([2], [0], 8, 64, None, 1),             # start not 16-byte aligned
    ([0], [6], 8, 64, None, 1),             # outpos not 16-byte aligned
    ([0], [0], 6, 64, None, 1),             # length not 16-byte aligned
    ([0], [0], 0, 64, None, 1),             # empty segments
    ([0], [0], 8, 64, None, 0),             # no copy in flight
    ([0], [0], 8, 64, None, 33),            # more stages than barriers
    ([0], [0], 4096, 8192, None, 16),       # 16 stages of 16 KB
    ([0, 1020], [0, 8], 8, 64, [1, 1], 1),  # a live segment past the end
], ids=["src-end", "src-start", "out-end", "out-start", "start-align",
        "outpos-align", "length-align", "length-zero", "inflight-zero",
        "inflight-high", "stages", "live-past-end"])
def test_segment_copy_refuses(starts, outpos, length, out_len, lens,
                              inflight):
    src = torch.arange(8192, dtype=torch.int32) if length == 4096 else SRC
    with pytest.raises(ValueError):
        PR.segment_copy(src, torch.tensor(starts, dtype=torch.int32),
                        torch.tensor(outpos, dtype=torch.int32), length,
                        out_len, None if lens is None
                        else torch.tensor(lens, dtype=torch.int32), inflight)


def test_segment_copy_skips_dead_segments_out_of_range():
    """A dead segment (lens <= 0) is never read, so its start may lie
    anywhere, as probe3_dma's guard lets it."""
    out = PR.segment_copy(SRC, torch.tensor([0, 5000], dtype=torch.int32),
                          torch.tensor([0, 8], dtype=torch.int32), 8, 16,
                          torch.tensor([3, 0], dtype=torch.int32))
    assert torch.equal(out[:8], SRC[:8])


def test_segment_copy_refuses_mixed_index_types():
    with pytest.raises(ValueError):
        PR.segment_copy(SRC, torch.tensor([0]), torch.tensor([0]), 8, 8)


# ------------------------------------------------- launches, bytes, timing

def test_the_cpu_path_never_counts():
    for k in PR.KERNELS:
        k.launches = 0
    tab, idx = _ok()
    PR.stream_copy(idx)
    PR.table_gather(tab, idx)
    PR.table_gather(tab, idx, idx)
    PR.row_shuffle(idx, idx)
    PR.table_scatter(idx, idx, 8, "add")
    PR.tile_transpose(torch.zeros((128, 128), dtype=torch.int32))
    PR.segment_copy(SRC, torch.tensor([0], dtype=torch.int32),
                    torch.tensor([0], dtype=torch.int32), 8, 8)
    assert [k.launches for k in PR.KERNELS] == [0] * 6


def test_byte_models_against_hand_counts():
    # copy (524288, 128): 2^26 words read and written, 4 B each
    assert PR.copy_bytes(524288 * 128) == 2 * 4 * 2**26 == 536870912
    # gather 2 MB table, idx (524288, 128): idx + out 512 MB, table 2 MB
    assert PR.gather_bytes(4096, 524288 * 128) == 536870912 + 2097152
    # bit lookup from the 8-row tile, (2^21, 128): idx, shift, out 3 GiB
    assert PR.gather_bytes(8, 2**28, bits=True) == 3 * 2**30 + 4096
    # the 256 MB table's sector model: idx + out 2 GiB, 32 B a lookup
    assert PR.gather_sector_bytes(2**28) == 2 * 2**30 + 32 * 2**28
    assert PR.shuffle_bytes(2**28) == 3 * 2**30
    assert PR.scatter_bytes(2**26, 4096) == 2**29 + 2**21
    assert PR.transpose_bytes(2**28) == 2**31
    # probe3_dma deg=4096: 4096 segments of 4096 words each way, three
    # 16 KB index arrays
    k = torch.arange(4096, dtype=torch.int32)
    assert PR.segment_bytes(k * 4096, k * 4096, 4096,
                            torch.full((4096,), 4096, dtype=torch.int32)) \
        == 2 * 4 * 4096 * 4096 + 3 * 4 * 4096
    # probe3d (2^14, 32, 8) with its rows apart: 2^14 segments of 32 rows,
    # two index arrays
    k = torch.arange(2**14, dtype=torch.int32).flip(0)
    assert PR.segment_bytes(k * 4096, k * 4096, 32 * 128) \
        == 8 * 2**14 * 4096 + 8 * 2**14
    assert PR.bound_ms(3.35e12) == pytest.approx(1000.0)


def test_segment_bytes_merges_overlapping_ranges():
    """A word read (or written) by several segments counts once."""
    # probe3_dma deg=32 pad=128 nseg=2^17: segment k reads [32k, 32k + 128),
    # so the reads cover (n - 1) * 32 + 128 words; the writes [128k, +128)
    # cover n * 128; starts, outpos and lens once
    n = 2**17
    k = torch.arange(n, dtype=torch.int32)
    lens = torch.full((n,), 32, dtype=torch.int32)
    got = PR.segment_bytes(k * 32, k * 128, 128, lens)
    assert got == 4 * ((n - 1) * 32 + 128) + 4 * n * 128 + 3 * 4 * n
    assert got == 85_459_328
    # by hand: starts 0, 4, 4, 100 (length 8: [0, 12) and [100, 108), 20
    # words), the dead segment at 1000 not counted; writes 0, 8, 16, 24
    # apart (32 words); four segments' three index words
    starts = torch.tensor([4, 0, 1000, 100, 4], dtype=torch.int32)
    outpos = torch.tensor([0, 8, 500, 16, 24], dtype=torch.int32)
    lens = torch.tensor([1, 1, 0, 1, 1], dtype=torch.int32)
    assert PR.segment_bytes(starts, outpos, 8, lens) \
        == 4 * (20 + 32) + 3 * 4 * 5
    assert PR.segment_bytes(starts[:0], outpos[:0], 8) == 0


def test_ptxas_lines_name_their_kernels(tmp_path):
    """chip_smoke's ptxas summary heads each line with the kernels that
    print it, template arguments as mangled."""
    import chip_smoke as cs

    log = tmp_path / "lib.so.log"
    log.write_text(
        "ptxas info    : Compiling entry function '_ZN41_GLOBAL__N__3f1f59"
        "91_9_probes_cu_edd7391b19table_gather_kernelILb1EEEvPKiS2_S2_Pili"
        "l' for 'sm_90a'\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 28 registers, used 0 barriers\n"
        "ptxas info    : Compiling entry function '_Z18stream_copy_kernelPKi"
        "Pil' for 'sm_90a'\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 22 registers, used 0 barriers\n")
    lib = type("Lib", (), {"_name": str(tmp_path / "lib.so")})
    assert cs.ptxas_lines(lib) == [
        "table_gather_kernelILb1EE, stream_copy_kernel: 0 bytes stack "
        "frame, 0 bytes spill stores, 0 bytes spill loads",
        "table_gather_kernelILb1EE: Used 28 registers, used 0 barriers",
        "stream_copy_kernel: Used 22 registers, used 0 barriers"]
    assert cs.kernel_name("_ZN44_GLOBAL__N__e3f3a763_11_seg_scan_cu_f9917e72"
                          "15seg_scan_kernelIfNS_3MaxEEEvPKT_") \
        == "seg_scan_kernelIfNS_3MaxEE"


def test_run_probes_refuses_the_cpu():
    with pytest.raises(ValueError, match="card"):
        PR.run_probes(device="cpu")


def test_probe_shapes_are_the_probe_modules(pg, p2, p3, p3d):
    """PROBES keeps its own copy of the probes' shapes; they agree with
    the modules' constants."""
    by = {}
    for kernel, _, p, _ in PR.PROBES:
        by.setdefault(kernel, []).append(p)
    assert {"rows": pg.CHUNK * pg.STEPS} in by["stream_copy"]
    assert {"rows": p2.R * p2.STEPS} in by["stream_copy"]
    gathers = {(p["t_rows"], p["rows"]) for p in by["table_gather"]}
    assert (pg.R, pg.CHUNK * pg.STEPS) in gathers
    assert {(t, 2**21) for t in (2048, 8192, 16384, 8, 2**19)} <= gathers
    assert {p["mode"] for p in by["table_scatter"]} == set(PR.SCATTER_MODES)
    assert all(p["t_rows"] == pg.R and p["rows"] == pg.CHUNK * pg.STEPS
               for p in by["table_scatter"])
    dma = [p for p in by["segment_copy"] if "pool" in p]
    assert {(p["deg"], p["pad"], p["nseg"]) for p in dma} == {
        (32, 128, 2**17), (128, 128, 2**17), (512, 512, 2**15),
        (4096, 4096, 2**12)}
    assert all(p["nseg"] % p3.SEG_PER_BLOCK == 0 for p in dma)
    rate = [p for p in by["segment_copy"] if "pool" not in p]
    assert {p["src_rows"] for p in rate} == {p3d.R}
    assert len(PR.PROBES) == 24
