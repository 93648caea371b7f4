"""The port's compaction primitives (titan_tpu_torch.ops.compaction)
against the JAX package's (titan_tpu.ops.compaction), on the CPU.
Integer results must match exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from titan_tpu.ops import compaction as J
from titan_tpu_torch.ops import compaction as P


def _mask(seed, length, density):
    return np.random.default_rng(seed).random(length) < density


@pytest.mark.parametrize("seed,length,density,cap", [
    (0, 257, 0.3, 128),      # count < cap
    (1, 300, 0.7, 64),       # cap overflow: survivors past cap dropped
    (2, 64, 0.0, 16),        # nothing set
    (3, 100, 1.0, 100),      # everything set, cap == length
])
def test_scatter_compact_matches_jax(seed, length, density, cap):
    mask = _mask(seed, length, density)
    rng = np.random.default_rng(seed + 10)
    p0 = rng.integers(-50, 50, length).astype(np.int32)
    p1 = rng.integers(0, 1 << 30, length).astype(np.int32)
    jc, jouts = J.scatter_compact(jnp.asarray(mask),
                                  (jnp.asarray(p0), jnp.asarray(p1)),
                                  cap, (-7, 9))
    pc, pouts = P.scatter_compact(torch.from_numpy(mask),
                                  (torch.from_numpy(p0),
                                   torch.from_numpy(p1)), cap, (-7, 9))
    assert int(pc) == int(jc) == int(mask.sum())
    assert pc.dtype == torch.int32
    for a, b in zip(jouts, pouts):
        assert np.array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("seed,cap", [(4, 512), (5, 40)])
def test_compact_ids_matches_jax(seed, cap):
    mask = _mask(seed, 500, 0.2)
    jc, jids = J.compact_ids(jnp.asarray(mask), cap, 500)
    pc, pids = P.compact_ids(torch.from_numpy(mask), cap, 500)
    assert int(pc) == int(jc)
    assert pids.dtype == torch.int32
    assert np.array_equal(np.asarray(jids), pids.numpy())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_claim_dedup_and_reset_match_jax(seed):
    """Keys include the pad index n+1 (the claim array's last slot, in
    range) and keys past the claim array, which must drop and never
    win, as JAX's mode="drop" scatter does."""
    n = 40
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, n + 2, (8, 16)).astype(np.int32)
    keys[0, :3] = n + 1                       # the pad vertex
    keys[1, :2] = n + 2                       # past the [n+2] claim array
    keys[2, 0] = 10 ** 6
    ticket = np.arange(keys.size, dtype=np.int32).reshape(keys.shape)
    rng.shuffle(ticket.reshape(-1))
    claim0 = np.full(n + 2, J.CLAIM_SENTINEL, np.int32)

    jclaim, jwon = J.claim_dedup(jnp.asarray(claim0), jnp.asarray(keys),
                                 jnp.asarray(ticket))
    pclaim, pwon = P.claim_dedup(torch.from_numpy(claim0.copy()),
                                 torch.from_numpy(keys),
                                 torch.from_numpy(ticket))
    assert np.array_equal(np.asarray(jclaim), pclaim.numpy())
    assert np.array_equal(np.asarray(jwon), pwon.numpy())
    assert not pwon[1, :2].any() and not pwon[2, 0]
    # exactly one winner per distinct in-range key
    assert pwon.sum() == len(np.unique(keys[keys < n + 2]))

    jreset = J.claim_reset(jclaim, jnp.asarray(keys))
    preset = P.claim_reset(pclaim, torch.from_numpy(keys))
    assert np.array_equal(np.asarray(jreset), preset.numpy())
    assert (preset.numpy() == P.CLAIM_SENTINEL).all()
