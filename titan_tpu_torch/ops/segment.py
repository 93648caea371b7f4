"""Segment reduction, the message combine of the vertex-program engine
(port of ``titan_tpu/ops/segment.py``).

``segment_combine`` has one route per device and no flag. With the
static segment metadata of a dst-sorted edge list (``last_idx``,
``seg_has``) it is ``sorted_segment_combine``: the segmented scan
(``ops/seg_scan.seg_scan``, the CUDA kernel for a CUDA tensor), then the
gather at each segment's last edge, with the identity for empty
segments. Without metadata it is a plain ``scatter_reduce_``.
``sorted_segment_combine`` also takes K rows of messages, ``[K, ld]``
(the batched engine's): one scan launch over every row, then the gather
along the rows.
"""

from __future__ import annotations

import numpy as np
import torch

from titan_tpu_torch.ops.seg_scan import COMBINES, combine_identity, seg_scan

__all__ = ["combine_identity", "segment_combine", "segment_flags",
           "segment_metadata", "sorted_segment_combine"]

_SCATTER = {"sum": "sum", "min": "amin", "max": "amax"}


def segment_metadata(indptr) -> tuple[np.ndarray, np.ndarray]:
    """Static per-segment scan metadata from a CSR indptr: the index of each
    segment's LAST edge (int32) and whether the segment is non-empty."""
    indptr = np.asarray(indptr, dtype=np.int64)
    last_idx = (indptr[1:] - 1).astype(np.int32)
    seg_has = indptr[1:] > indptr[:-1]
    return last_idx, seg_has


def segment_flags(seg_ids):
    """Segment-start flags of sorted ``seg_ids``: True where the id
    changes, and at index 0."""
    flags = torch.ones_like(seg_ids, dtype=torch.bool)
    flags[1:] = seg_ids[1:] != seg_ids[:-1]
    return flags


def sorted_segment_combine(values, seg_ids, last_idx, seg_has, combine: str,
                           flags=None, out=None):
    """Scan-based segment combine for dst-sorted edges with static
    metadata: ``values`` [E] into [n], or K rows ``values`` [K, ld] (row
    k's E messages in its first E columns, E = ``len(seg_ids)`` <= ld)
    into [K, n], each row exactly the one-row combine of that row.
    ``flags`` are ``segment_flags(seg_ids)``, computed here when not given
    (the engine keeps them, since ``dst`` is static). ``out``, when
    given, receives the result (it may be a strided view)."""
    ident = combine_identity(combine, values.dtype)
    if seg_ids.shape[0] == 0:
        shape = values.shape[:-1] + seg_has.shape
        if out is None:
            return torch.full(shape, ident, dtype=values.dtype,
                              device=values.device)
        return out.fill_(ident)
    if flags is None:
        flags = segment_flags(seg_ids)
    r = seg_scan(values, flags, combine)
    last = r.index_select(-1, last_idx.clamp(min=0))
    if out is None:
        return torch.where(seg_has, last, ident)
    # where() takes a Python scalar only without out=
    return torch.where(seg_has, last, last.new_full((), ident), out=out)


def segment_combine(values, segment_ids, num_segments: int, combine: str,
                    last_idx=None, seg_has=None, flags=None):
    """Combine ``values`` [E] per segment into [num_segments]; empty
    segments get the identity. See the module doc for the two routes."""
    if combine not in COMBINES:
        raise ValueError(f"unknown combine {combine!r}")
    if last_idx is not None and seg_has is not None:
        return sorted_segment_combine(values, segment_ids, last_idx,
                                      seg_has, combine, flags)
    out = torch.full((num_segments,), combine_identity(combine, values.dtype),
                     dtype=values.dtype, device=values.device)
    return out.scatter_reduce_(0, segment_ids.long(), values,
                               _SCATTER[combine], include_self=False)
