"""Variable-length integer codecs.

Functional counterpart of the reference's VariableLong codec family
(reference: titan-core graphdb/database/idhandling/VariableLong.java):

* ``write_positive``/``read_positive`` — unsigned base-128 varint,
  most-significant-group first, stop bit (0x80) on the LAST byte. MSB-first
  group order makes equal-length encodings sort byte-wise like their values,
  which the edge codec relies on for column ordering.
* ``write_signed``/``read_signed`` — zigzag-mapped signed variant.
* ``write_positive_backward``/``read_positive_backward`` — readable from the
  END of a buffer (stop bit on the FIRST byte); used to park trailing fields
  (e.g. relation ids) at the end of a value so the head stays order-relevant.
* ``write_positive_with_prefix``/``read_positive_with_prefix`` — embeds a
  fixed-width bit prefix (direction/type class) into the first byte while
  preserving order within a prefix; used by the relation-type id codec
  (codec/relation_ids.py).

A vectorized numpy bulk decoder (``bulk_read_positive``) backs the CSR ingest
path when the C++ codec is unavailable.
"""

from __future__ import annotations

import numpy as np

_STOP = 0x80
_MASK = 0x7F


def positive_length(value: int) -> int:
    if value < 0:
        raise ValueError("negative value for unsigned varint")
    n = 1
    value >>= 7
    while value:
        n += 1
        value >>= 7
    return n


def write_positive(out: bytearray, value: int) -> None:
    """Unsigned varint, MSB-group first, stop bit on the last byte."""
    if value < 0:
        raise ValueError("negative value for unsigned varint")
    nbytes = positive_length(value)
    for shift in range(7 * (nbytes - 1), 6, -7):
        out.append((value >> shift) & _MASK)
    out.append((value & _MASK) | _STOP)


def read_positive(buf, pos: int) -> tuple[int, int]:
    """Returns (value, new_pos)."""
    value = 0
    while True:
        b = buf[pos]
        pos += 1
        value = (value << 7) | (b & _MASK)
        if b & _STOP:
            return value, pos


def signed_length(value: int) -> int:
    return positive_length(_zigzag_py(value))


def _zigzag_py(value: int) -> int:
    # arbitrary-precision python ints: implement zigzag without fixed width
    return (value << 1) if value >= 0 else ((-value) << 1) - 1


def _unzigzag_py(value: int) -> int:
    return (value >> 1) if (value & 1) == 0 else -((value + 1) >> 1)


def write_signed(out: bytearray, value: int) -> None:
    write_positive(out, _zigzag_py(value))


def read_signed(buf, pos: int) -> tuple[int, int]:
    v, pos = read_positive(buf, pos)
    return _unzigzag_py(v), pos


# ---------------------------------------------------------------------------
# backward-readable variant: stop bit on the FIRST (most significant) byte so
# a reader positioned at the end can walk backwards until it sees the flag.
# ---------------------------------------------------------------------------

def backward_length(value: int) -> int:
    return positive_length(value)


def write_positive_backward(out: bytearray, value: int) -> None:
    if value < 0:
        raise ValueError("negative value for unsigned varint")
    nbytes = positive_length(value)
    first = True
    for shift in range(7 * (nbytes - 1), -1, -7):
        b = (value >> shift) & _MASK
        if first:
            b |= _STOP
            first = False
        out.append(b)


def read_positive_backward(buf, end: int, limit: int = 0) -> tuple[int, int]:
    """Reads backwards from index ``end`` (exclusive); returns (value, start)
    where ``start`` is the index of the first byte of the encoding. Raises on
    corrupt data that would walk below ``limit``."""
    pos = end - 1
    shift = 0
    value = 0
    while pos >= limit:
        b = buf[pos]
        value |= (b & _MASK) << shift
        if b & _STOP:
            return value, pos
        shift += 7
        pos -= 1
    raise ValueError("unterminated backward varint (no stop bit before "
                     f"offset {limit})")


def write_signed_backward(out: bytearray, value: int) -> None:
    write_positive_backward(out, _zigzag_py(value))


def read_signed_backward(buf, end: int, limit: int = 0) -> tuple[int, int]:
    v, start = read_positive_backward(buf, end, limit)
    return _unzigzag_py(v), start


# ---------------------------------------------------------------------------
# prefixed variant. Layout (same design as the reference's
# VariableLong.writePositiveWithPrefix, VariableLong.java:145-173):
#
#   first byte:  [ prefix : P bits | continue : 1 bit | top value bits ]
#   rest:        MSB-first 7-bit groups, stop bit (0x80) on the LAST byte
#
# Keeping the prefix in the TOP bits of byte 0 gives two properties the edge
# codec depends on: (a) every encoding with prefix p lies in the one-byte
# range [p<<d, (p+1)<<d) regardless of length → category slice bounds need
# only the first byte; (b) encodings are prefix-free → a type's columns form
# one contiguous range.
# ---------------------------------------------------------------------------

def write_positive_with_prefix(out: bytearray, value: int, prefix: int,
                               prefix_bit_len: int) -> None:
    if not (0 < prefix_bit_len < 7):
        raise ValueError("prefix_bit_len out of range")
    if prefix < 0 or prefix >= (1 << prefix_bit_len):
        raise ValueError("prefix out of range")
    if value < 0:
        raise ValueError("negative value")
    delta = 8 - prefix_bit_len          # bits in first byte below the prefix
    first = prefix << delta
    vlen = max(value.bit_length(), 1)
    mod = vlen % 7
    if mod <= delta - 1:
        offset = vlen - mod             # top `mod` bits ride in the first byte
        first |= value >> offset
        value &= (1 << offset) - 1
        vlen -= mod
    else:
        vlen += 7 - mod                 # pad to whole trailing groups
    if vlen > 0:
        first |= 1 << (delta - 1)       # continue bit
    out.append(first)
    if vlen > 0:
        ngroups = vlen // 7
        for shift in range(7 * (ngroups - 1), 6, -7):
            out.append((value >> shift) & _MASK)
        out.append((value & _MASK) | _STOP)


def read_positive_with_prefix(buf, pos: int, prefix_bit_len: int) -> tuple[int, int, int]:
    """Returns (value, prefix, new_pos)."""
    delta = 8 - prefix_bit_len
    first = buf[pos]
    pos += 1
    prefix = first >> delta
    value = first & ((1 << (delta - 1)) - 1)
    if (first >> (delta - 1)) & 1:      # continue bit
        start = pos
        rest, pos = read_positive(buf, pos)
        ngroups = pos - start
        value = (value << (7 * ngroups)) | rest
    return value, prefix, pos


def prefixed_length(value: int, prefix_bit_len: int) -> int:
    out = bytearray()
    write_positive_with_prefix(out, value, 0, prefix_bit_len)
    return len(out)


# ---------------------------------------------------------------------------
# numpy bulk decode (CSR ingest fallback path; the C++ codec in
# native/edgecodec.cpp is the fast path)
# ---------------------------------------------------------------------------

def bulk_read_positive(data: np.ndarray, offsets: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Decode one MSB-first varint starting at each offset of ``data``
    (uint8 array). Returns (values int64, end_offsets int64). Vectorized over
    the number-of-varints axis; loops only over the (<=10) byte positions."""
    data = np.ascontiguousarray(data, dtype=np.uint8)
    pos = np.asarray(offsets, dtype=np.int64).copy()
    values = np.zeros(pos.shape, dtype=np.int64)
    done = np.zeros(pos.shape, dtype=bool)
    for _ in range(10):  # max 10 groups for 63-bit values
        b = np.where(done, 0, data[np.minimum(pos, len(data) - 1)])
        active = ~done
        values[active] = (values[active] << 7) | (b[active] & _MASK)
        stop = active & ((b & _STOP) != 0)
        pos[active] += 1
        done |= stop
        if done.all():
            break
    if not done.all():
        raise ValueError("unterminated varint in bulk decode")
    return values, pos
