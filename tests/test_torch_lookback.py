"""The look-back rule of the seg_scan kernel (titan_tpu_torch/csrc/
seg_scan.cu), modelled in numpy on the CPU.

The kernel carries a segment across tiles by decoupled look-back. The
model splits E into tiles of T elements and computes each tile's
aggregate (the combine of its suffix from its last start, or of the whole
tile) and whether it holds a start. It then builds each tile's carry by
the kernel's left-fold rule along two look-back paths:

* stop at the first published prefix, under a random publication
  schedule in which a tile that holds a start always publishes its prefix
  at once, and the prefixes are themselves the carries this path built;
* walk back to the last tile that holds a start (or tile 0) and fold its
  aggregate and every later one, left to right.

Both paths must give the same bits, float32 sums included. The whole
scan rebuilt from the carries must equal ``seg_scan_reference`` exactly
for int32 sum, min and max and float32 min and max, and float32 sums
within 1e-5 of the scan of |x|. For one segment over every tile the
model also folds CUB-style (the aggregates walked past right to left,
then the prefix found) and checks that this order does change the bits,
so the bit-equality above is not vacuous.
"""

import numpy as np
import pytest
import torch

from titan_tpu_torch.ops import seg_scan as S

NTILES = 160
TILES = (1, 3, 64)
#: one segment over every tile; every element its own; random starts
#: with flags[0] False; random segments spanning up to 40 tiles
INPUTS = ("one", "each", "flag0_false", "spans")
TYPES = [("sum", np.float32), ("min", np.float32), ("max", np.float32),
         ("sum", np.int32), ("min", np.int32), ("max", np.int32)]


def _op(combine, dtype):
    """The kernel's combine on numpy scalars: float32 adds in float32,
    int32 adds wrap; min and max keep the left operand on a tie."""
    if combine == "min":
        return lambda a, b: b if b < a else a
    if combine == "max":
        return lambda a, b: b if b > a else a
    if dtype == np.float32:
        return lambda a, b: np.float32(a + b)
    return lambda a, b: np.int32((int(a) + int(b) + 2**31) % 2**32 - 2**31)


def _inputs(kind, e, t, dtype, rng):
    if dtype == np.float32:
        values = rng.uniform(-1, 1, e).astype(np.float32)
    else:
        values = rng.integers(-2**31, 2**31, e).astype(np.int32)
    if kind == "one":
        flags = np.zeros(e, bool)
    elif kind == "each":
        flags = np.ones(e, bool)
    else:
        span = 4 * t if kind == "flag0_false" else 40 * t
        starts = np.cumsum(rng.integers(1, span + 1, e))
        flags = np.zeros(e, bool)
        flags[starts[starts < e]] = True
        flags[0] = kind != "flag0_false"
    return values, flags


def _scan_ref(values, flags, combine):
    return S.seg_scan_reference(torch.from_numpy(values),
                                torch.from_numpy(flags), combine).numpy()


def _bits(x):
    return np.asarray(x).view(np.uint32 if np.asarray(x).dtype == np.float32
                              else np.int32)


@pytest.mark.parametrize("combine,dtype", TYPES,
                         ids=[f"{c}-{d.__name__}" for c, d in TYPES])
@pytest.mark.parametrize("kind", INPUTS)
@pytest.mark.parametrize("t", TILES)
def test_lookback_paths_agree_and_rebuild_the_scan(t, kind, combine, dtype):
    seed = 1000 * t + 10 * INPUTS.index(kind) + TYPES.index((combine, dtype))
    rng = np.random.default_rng(seed)
    e = NTILES * t - t // 2                    # a ragged last tile
    values, flags = _inputs(kind, e, t, dtype, rng)
    nt = -(-e // t)
    op = _op(combine, dtype)
    ident = dtype(S.combine_identity(combine, torch.from_numpy(values).dtype))
    starts = flags.copy()
    starts[0] = True                           # flags[0] is implied
    pos = np.arange(e)
    # each tile scanned on its own: its aggregate is its last element
    inscan = _scan_ref(values, starts | (pos % t == 0), combine)
    agg = inscan[np.minimum(np.arange(1, nt + 1) * t, e) - 1]
    has = np.logical_or.reduceat(starts, np.arange(nt) * t)
    published = has | (rng.random(nt) < 0.5)

    prefix, carry = [None] * nt, np.empty(nt, dtype)
    right_differs = False
    for k in range(nt):
        c_a = c_b = ident
        if k > 0:
            j = k - 1                          # path A: first prefix found
            while not published[j]:
                j -= 1
            c_a = prefix[j]
            for i in range(j + 1, k):
                c_a = op(c_a, agg[i])
            s = k - 1                          # path B: back to the start
            while not has[s]:
                s -= 1
            c_b = agg[s]
            for i in range(s + 1, k):
                c_b = op(c_b, agg[i])
            assert _bits(c_a) == _bits(c_b), (k, j, s)
            if j < k - 2:                      # CUB: the window right to left
                w = agg[k - 1]
                for i in range(k - 2, j, -1):
                    w = op(agg[i], w)
                right_differs |= bool(_bits(op(prefix[j], w)) != _bits(c_a))
        carry[k] = c_a
        prefix[k] = agg[k] if has[k] else op(c_a, agg[k])

    # elements before their tile's first start continue the carry
    tile_of = pos // t
    seen = np.zeros(e, bool)
    for k in range(nt):
        seen[k * t:(k + 1) * t] = np.logical_or.accumulate(
            starts[k * t:(k + 1) * t])
    got = torch.from_numpy(inscan)
    with_carry = S._OPS[combine](torch.from_numpy(carry[tile_of]), got)
    got = torch.where(torch.from_numpy(seen), got, with_carry).numpy()
    ref = _scan_ref(values, flags, combine)
    if combine == "sum" and dtype == np.float32:
        scale = _scan_ref(np.abs(values), flags, "sum")
        assert np.all(np.abs(got - ref) <= 1e-5 * scale)
        if kind == "one":
            assert right_differs
    else:
        np.testing.assert_array_equal(got, ref)
