"""The row window sum (titan_tpu_torch.ops.window_sum), the port of the
lint fixture's Pallas kernel ``_ok_kernel``
(tests/fixtures/graftlint/titan_tpu/models/pallas_ok.py:14), on the CPU.

The fixture is loaded by compiling its source text, so nothing is
written into the fixture tree (tests/test_lint.py reads that tree). Its
kernel runs through ``pl.pallas_call(..., interpret=True)`` on seeded
numpy inputs, and the port's plain version must equal it bit for bit,
int32 and float32, signed zeros included. Also: the refusals, matched by
JAX failing on the same narrow width; the two kernels of pallas_pos.py,
which define no function (their Python control flow on traced refs
raises ``TracerBoolConversionError``); the CPU path never counting
launches. The CUDA kernel is held to the plain version on the card by
chip_smoke.py's phase 22.
"""

import functools
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from titan_tpu_torch.ops import window_sum as WS

FIXTURES = (pathlib.Path(__file__).resolve().parent / "fixtures"
            / "graftlint" / "titan_tpu" / "models")


def _fixture(name: str) -> dict:
    """The fixture module's globals, compiled from its text: no import,
    so no ``__pycache__`` lands beside it."""
    path = FIXTURES / f"{name}.py"
    ns = {"__name__": f"_fixture_{name}", "__file__": str(path)}
    exec(compile(path.read_text(), str(path), "exec"), ns)
    return ns


@pytest.fixture(scope="module")
def ok():
    return _fixture("pallas_ok")


@pytest.fixture(scope="module")
def pos():
    return _fixture("pallas_pos")


def _jax_ok(ok, x, block, masked):
    kern = functools.partial(ok["_ok_kernel"], block=block, masked=masked)
    return np.asarray(pl.pallas_call(
        kern, out_shape=jax.ShapeDtypeStruct(x.shape, x.dtype),
        interpret=True)(x))


def _inputs(dtype, rows, width, seed):
    rng = np.random.default_rng(seed)
    if dtype == np.int32:
        return rng.integers(-2**31, 2**31 - 1, (rows, width), dtype=np.int32)
    return rng.standard_normal((rows, width)).astype(np.float32)


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("block", [128, 64, 100])
@pytest.mark.parametrize("width", [64, 128, 129, 300])
@pytest.mark.parametrize("dtype", [np.int32, np.float32],
                         ids=["int32", "float32"])
def test_plain_version_bit_equal_to_the_fixture_kernel(ok, dtype, width,
                                                       block, masked):
    """rows 1, 2, 5 (the + 1 only past one row); int32 wraps."""
    for rows in (1, 2, 5):
        x = _inputs(dtype, rows, width, seed=rows * 1000 + width + block)
        want = _jax_ok(ok, x, block, masked)
        got = WS.row_window_sum(torch.from_numpy(x), block=block,
                                masked=masked).numpy()
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(_bits(got), _bits(want))


def test_fixture_run_is_the_default_window_sum(ok):
    """The fixture's own ``run`` (block 128, not masked), under
    ``pltpu.force_tpu_interpret_mode()``, against ``WS.run``; int32
    against the window sum written out with a cumulative sum."""
    x = _inputs(np.int32, 3, 300, seed=3) % 1000
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(ok["run"](jnp.asarray(x)))
    np.testing.assert_array_equal(WS.run(torch.from_numpy(x)).numpy(), want)
    c = np.cumsum(np.pad(x.astype(np.int64), ((0, 0), (128, 0))), axis=1)
    np.testing.assert_array_equal(want, c[:, 128:] - c[:, :-128] + 1)
    assert WS.span(128) == 128 and WS.span(100) == 128 \
        and WS.span(64) == 64 and WS.span(1) == 1


@pytest.mark.parametrize("rows", [1, 2])
def test_signed_zeros_bit_equal(ok, rows):
    """-0.0 inputs: the pad's +0.0 turns some sums to +0.0 and leaves
    others -0.0, in both."""
    x = np.full((rows, 200), -0.0, dtype=np.float32)
    x[:, ::7] = 0.0
    x[:, 5] = -1.5
    x[:, 6] = 1.5
    for masked in (False, True):
        want = _jax_ok(ok, x, 128, masked)
        got = WS.row_window_sum(torch.from_numpy(x), masked=masked).numpy()
        np.testing.assert_array_equal(_bits(got), _bits(want))
    assert np.signbit(want).any() or rows > 1


@pytest.mark.parametrize("width,block", [(63, 128), (31, 64), (1, 128),
                                         (15, 17)])
def test_narrow_width_refused_where_jax_fails(ok, width, block):
    x = np.ones((2, width), dtype=np.int32)
    with pytest.raises(Exception):
        _jax_ok(ok, x, block, False)
    with pytest.raises(ValueError, match="largest step"):
        WS.row_window_sum(torch.from_numpy(x), block=block)


@pytest.mark.parametrize("x", [
    torch.zeros(128, dtype=torch.int32),
    torch.zeros((2, 2, 128), dtype=torch.int32),
    torch.zeros((2, 128), dtype=torch.int64),
    torch.zeros((2, 128), dtype=torch.float64),
    torch.zeros((2, 128), dtype=torch.bfloat16),
], ids=["1-d", "3-d", "int64", "float64", "bfloat16"])
def test_wrapper_refuses(x):
    with pytest.raises(ValueError):
        WS.row_window_sum(x)


def test_block_past_the_kernels_span_refused():
    with pytest.raises(ValueError, match="block"):
        WS.row_window_sum(torch.zeros((2, 512), dtype=torch.int32),
                          block=257)


@pytest.mark.parametrize("kernel,runner", [("_bad_kernel", "run_inline"),
                                           ("_bad_local", "run_local")])
def test_pallas_pos_kernels_define_no_function(pos, kernel, runner):
    """The lint's positive fixtures branch in Python on traced refs:
    tracing raises, so there is no function to port (run eagerly,
    ``_bad_local``'s ``while y[0] > 0`` would never end). A 1-d input:
    ``x_ref[0]`` is then a traced scalar."""
    x = jnp.ones((128,), jnp.int32)
    kw = {"block": 128} if kernel == "_bad_kernel" else {"width": 8}
    with pytest.raises(jax.errors.TracerBoolConversionError):
        pl.pallas_call(functools.partial(pos[kernel], **kw),
                       out_shape=jax.ShapeDtypeStruct(x.shape, x.dtype),
                       interpret=True)(x)
    with pytest.raises(jax.errors.TracerBoolConversionError):
        pos[runner](x)


def test_the_cpu_path_never_counts():
    WS.row_window_sum.launches = 0
    x = torch.arange(256, dtype=torch.int32).view(2, 128)
    WS.run(x)
    WS.row_window_sum(x.float(), block=64, masked=True)
    assert WS.row_window_sum.launches == 0


def test_run_window_sum_refuses_the_cpu():
    with pytest.raises(ValueError, match="card"):
        WS.run_window_sum(device="cpu")


def test_bits_err_reads_the_bit_patterns():
    """``run_window_sum``'s ``max_abs_err``: 0 for bit-equal outputs,
    signed zeros told apart in float32, int32 differences as int64."""
    a = torch.tensor([[1.5, 0.0, -2.0]])
    assert WS.bits_err(a, a.clone()) == 0
    assert WS.bits_err(a, torch.tensor([[1.5, -0.0, -2.0]])) == 2**31
    i = torch.tensor([[2**31 - 1, 0]], dtype=torch.int32)
    assert WS.bits_err(i, torch.tensor([[-2**31, 0]], dtype=torch.int32)) \
        == 2**32 - 1


def test_conv_library_call_sums_the_same_windows():
    """The library call beside the kernel gives the ladder's window sums
    up to float32 rounding (another order of adds)."""
    x = torch.from_numpy(_inputs(np.float32, 3, 300, seed=7))
    tree = WS.ladder(x)
    np.testing.assert_allclose(WS.conv_window_sum(x).numpy(), tree.numpy(),
                               rtol=0, atol=1e-4)
    exact = np.cumsum(np.pad(x.numpy().astype(np.float64),
                             ((0, 0), (128, 0))), axis=1)
    np.testing.assert_allclose(tree.numpy(), exact[:, 128:] - exact[:, :-128],
                               rtol=0, atol=1e-4)


def test_window_sum_bytes():
    assert WS.window_sum_bytes(2**28) == 2**31
    assert WS.bound_ms(WS.window_sum_bytes(2**28)) \
        == pytest.approx(0.6410, abs=1e-4)
