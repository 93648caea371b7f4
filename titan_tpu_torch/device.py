"""Device resolution and the integer conventions shared by the port.

``INF`` and ``next_pow2`` are the port's copies of ``models/bfs.py``'s
``INF`` and ``_next_pow2``. The JAX package ships scalars to the device
once (``utils/jitcache.dev_scalar``) because of its remote host link;
the port passes plain Python ints and reads a level's stats back with
one ``.tolist()``.
"""

from __future__ import annotations

import contextlib

import torch

INF = 1 << 30


def next_pow2(x: int) -> int:
    """Smallest power of two >= x, and at least 2 (capacity buckets)."""
    return 1 << max(1, (int(x) - 1).bit_length())


def resolve_device(device=None) -> torch.device:
    """``None`` means CUDA. Raises when CUDA is asked for and absent:
    nothing carries on silently on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the host")
    return dev


def cache_key(device) -> torch.device:
    """The key of a per-device cache on a snapshot: ``device`` resolved,
    and a CUDA device without an index taken as the current one, so
    ``"cuda"`` and ``"cuda:0"`` find the same entry."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def on_card(device):
    """The context a kernel launches under: ``torch.cuda.device(device)``
    on a card, so the launcher's grid (sized for ``cudaGetDevice``) and
    stream are that card's whichever device is current, as when one
    process drives several cards; nothing on any other device, where the
    launcher raises its own error."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()
