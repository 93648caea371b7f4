"""Byte-stream primitives for the codecs.

Counterpart of the reference's WriteBuffer/ReadBuffer/DataOutput stack
(reference: titan-core diskstorage/WriteBuffer.java,
graphdb/database/serialize/DataOutput.java, util/ReadArrayBuffer.java).
"""

from __future__ import annotations

import struct

from titan_tpu_torch.utils import varint


class DataOutput:
    __slots__ = ("buf",)

    def __init__(self):
        self.buf = bytearray()

    # fixed width (big-endian, so byte order == numeric order for unsigned)
    def put_u8(self, v: int) -> "DataOutput":
        self.buf.append(v & 0xFF)
        return self

    def put_u16(self, v: int) -> "DataOutput":
        self.buf += v.to_bytes(2, "big")
        return self

    def put_u32(self, v: int) -> "DataOutput":
        self.buf += v.to_bytes(4, "big")
        return self

    def put_u64(self, v: int) -> "DataOutput":
        self.buf += v.to_bytes(8, "big")
        return self

    def put_bytes(self, b: bytes) -> "DataOutput":
        self.buf += b
        return self

    # varints
    def put_uvar(self, v: int) -> "DataOutput":
        varint.write_positive(self.buf, v)
        return self

    def put_svar(self, v: int) -> "DataOutput":
        varint.write_signed(self.buf, v)
        return self

    def put_uvar_backward(self, v: int) -> "DataOutput":
        varint.write_positive_backward(self.buf, v)
        return self

    def put_uvar_prefixed(self, v: int, prefix: int, prefix_bits: int) -> "DataOutput":
        varint.write_positive_with_prefix(self.buf, v, prefix, prefix_bits)
        return self

    def put_f64(self, v: float) -> "DataOutput":
        self.buf += struct.pack(">d", v)
        return self

    def getvalue(self) -> bytes:
        return bytes(self.buf)

    def __len__(self):
        return len(self.buf)


class ReadBuffer:
    __slots__ = ("data", "pos", "end")

    def __init__(self, data: bytes, pos: int = 0, end: int | None = None):
        self.data = data
        self.pos = pos
        self.end = len(data) if end is None else end

    @property
    def remaining(self) -> int:
        return self.end - self.pos

    def has_remaining(self) -> bool:
        return self.pos < self.end

    def get_u8(self) -> int:
        v = self.data[self.pos]
        self.pos += 1
        return v

    def get_u16(self) -> int:
        v = int.from_bytes(self.data[self.pos:self.pos + 2], "big")
        self.pos += 2
        return v

    def get_u32(self) -> int:
        v = int.from_bytes(self.data[self.pos:self.pos + 4], "big")
        self.pos += 4
        return v

    def get_u64(self) -> int:
        v = int.from_bytes(self.data[self.pos:self.pos + 8], "big")
        self.pos += 8
        return v

    def get_bytes(self, n: int) -> bytes:
        v = bytes(self.data[self.pos:self.pos + n])
        self.pos += n
        return v

    def get_uvar(self) -> int:
        v, self.pos = varint.read_positive(self.data, self.pos)
        return v

    def get_svar(self) -> int:
        v, self.pos = varint.read_signed(self.data, self.pos)
        return v

    def get_uvar_prefixed(self, prefix_bits: int) -> tuple[int, int]:
        v, p, self.pos = varint.read_positive_with_prefix(
            self.data, self.pos, prefix_bits)
        return v, p

    def get_uvar_backward_from_end(self) -> int:
        """Consume one backward varint from the logical END of the buffer,
        shrinking ``end``. Lets trailing fields (relation ids) be peeled off
        before forward parsing."""
        v, start = varint.read_positive_backward(self.data, self.end, self.pos)
        self.end = start
        return v

    def get_f64(self) -> float:
        v = struct.unpack_from(">d", self.data, self.pos)[0]
        self.pos += 8
        return v
