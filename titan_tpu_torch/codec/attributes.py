"""Attribute (property-value) serializer registry.

Counterpart of the reference's data serializer (reference: titan-core
graphdb/database/serialize/StandardSerializer.java:430 and the ~29 attribute
serializers under serialize/attribute/): a registry of typed codecs, each
with a normal variant and — for types usable in sort keys and composite-index
keys — a BYTE-ORDER-PRESERVING variant whose encoded bytes compare like the
values themselves.

Order-preserving encodings:
* unsigned/signed ints  — big-endian with the sign bit flipped;
* floats               — IEEE-754 bits; if negative, all bits flipped, else
                         sign bit flipped (standard total-order trick);
* strings              — UTF-8 bytes with 0x00 escaped as 0x00 0xFF and a
                         0x00 0x00 terminator, so no encoded string is a
                         prefix of another and order is preserved;
* bytes                — same escape scheme;
* bool/date/uuid       — derived from the above.

The wire format for a *self-describing* value is [type-code u8][payload];
order-preserving values are written raw (the schema supplies the type).
"""

from __future__ import annotations

import datetime as _dt
import struct
import uuid as _uuid
from typing import Any, Callable, Optional

from titan_tpu_torch.codec.dataio import DataOutput, ReadBuffer


class AttributeHandler:
    def __init__(self, code: int, py_type: type, write, read,
                 write_ordered=None, read_ordered=None):
        self.code = code
        self.py_type = py_type
        self.write = write
        self.read = read
        # an explicitly-passed ordered codec marks the type orderable even
        # when it IS the plain codec (bool/uuid: the natural bytes already
        # sort correctly)
        self._orderable = write_ordered is not None
        self.write_ordered = write_ordered or write
        self.read_ordered = read_ordered or read

    @property
    def orderable(self) -> bool:
        return self._orderable


# -- primitives ---------------------------------------------------------------

_SIGN = 1 << 63


def _w_long(out: DataOutput, v: int):
    out.put_svar(int(v))


def _r_long(buf: ReadBuffer) -> int:
    return buf.get_svar()


def _w_long_ordered(out: DataOutput, v: int):
    out.put_u64((int(v) + _SIGN) & ((1 << 64) - 1))  # flip sign bit


def _r_long_ordered(buf: ReadBuffer) -> int:
    return buf.get_u64() - _SIGN


def _w_f64(out: DataOutput, v: float):
    out.put_f64(float(v))


def _r_f64(buf: ReadBuffer) -> float:
    return buf.get_f64()


def _w_f64_ordered(out: DataOutput, v: float):
    bits = struct.unpack(">Q", struct.pack(">d", float(v)))[0]
    if bits & _SIGN:
        bits = ~bits & ((1 << 64) - 1)
    else:
        bits |= _SIGN
    out.put_u64(bits)


def _r_f64_ordered(buf: ReadBuffer) -> float:
    bits = buf.get_u64()
    if bits & _SIGN:
        bits &= ~_SIGN & ((1 << 64) - 1)
    else:
        bits = ~bits & ((1 << 64) - 1)
    return struct.unpack(">d", struct.pack(">Q", bits))[0]


def _escape(b: bytes) -> bytes:
    return b.replace(b"\x00", b"\x00\xff") + b"\x00\x00"


def _unescape(buf: ReadBuffer) -> bytes:
    out = bytearray()
    data, pos, end = buf.data, buf.pos, buf.end
    while pos < end:
        c = data[pos]
        if c == 0x00:
            nxt = data[pos + 1]
            if nxt == 0x00:        # terminator
                buf.pos = pos + 2
                return bytes(out)
            if nxt == 0xFF:        # escaped zero
                out.append(0x00)
                pos += 2
                continue
            raise ValueError("bad escape in ordered bytes")
        out.append(c)
        pos += 1
    raise ValueError("unterminated ordered bytes")


def _w_str(out: DataOutput, v: str):
    b = v.encode("utf-8")
    out.put_uvar(len(b))
    out.put_bytes(b)


def _r_str(buf: ReadBuffer) -> str:
    n = buf.get_uvar()
    return buf.get_bytes(n).decode("utf-8")


def _w_str_ordered(out: DataOutput, v: str):
    out.put_bytes(_escape(v.encode("utf-8")))


def _r_str_ordered(buf: ReadBuffer) -> str:
    return _unescape(buf).decode("utf-8")


def _w_bytes(out: DataOutput, v: bytes):
    out.put_uvar(len(v))
    out.put_bytes(bytes(v))


def _r_bytes(buf: ReadBuffer) -> bytes:
    return buf.get_bytes(buf.get_uvar())


def _w_bytes_ordered(out: DataOutput, v: bytes):
    out.put_bytes(_escape(bytes(v)))


def _w_bool(out: DataOutput, v: bool):
    out.put_u8(1 if v else 0)


def _r_bool(buf: ReadBuffer) -> bool:
    return buf.get_u8() != 0


def _w_uuid(out: DataOutput, v: _uuid.UUID):
    out.put_bytes(v.bytes)


def _r_uuid(buf: ReadBuffer) -> _uuid.UUID:
    return _uuid.UUID(bytes=buf.get_bytes(16))


def _w_date(out: DataOutput, v: _dt.datetime):
    if v.tzinfo is None:
        v = v.replace(tzinfo=_dt.timezone.utc)
    _w_long(out, int(v.timestamp() * 1_000_000))


def _r_date(buf: ReadBuffer) -> _dt.datetime:
    return _dt.datetime.fromtimestamp(_r_long(buf) / 1_000_000, _dt.timezone.utc)


def _w_date_ordered(out: DataOutput, v: _dt.datetime):
    if v.tzinfo is None:
        v = v.replace(tzinfo=_dt.timezone.utc)
    _w_long_ordered(out, int(v.timestamp() * 1_000_000))


def _r_date_ordered(buf: ReadBuffer) -> _dt.datetime:
    return _dt.datetime.fromtimestamp(_r_long_ordered(buf) / 1_000_000,
                                      _dt.timezone.utc)


def _w_geoshape(out: DataOutput, v):
    flat = v.to_floats()
    out.put_u8(len(flat))
    for f in flat:
        out.put_f64(f)


def _r_geoshape(buf: ReadBuffer):
    from titan_tpu_torch.core.attribute import Geoshape
    n = buf.get_u8()
    return Geoshape.from_floats([buf.get_f64() for _ in range(n)])


class Serializer:
    """Type registry + self-describing value codec."""

    def __init__(self):
        self._by_code: dict[int, AttributeHandler] = {}
        self._by_type: dict[type, AttributeHandler] = {}
        # codes are part of the stored format — never renumber
        self.register(AttributeHandler(1, bool, _w_bool, _r_bool,
                                       _w_bool, _r_bool))
        self.register(AttributeHandler(2, int, _w_long, _r_long,
                                       _w_long_ordered, _r_long_ordered))
        self.register(AttributeHandler(3, float, _w_f64, _r_f64,
                                       _w_f64_ordered, _r_f64_ordered))
        self.register(AttributeHandler(4, str, _w_str, _r_str,
                                       _w_str_ordered, _r_str_ordered))
        self.register(AttributeHandler(5, bytes, _w_bytes, _r_bytes,
                                       _w_bytes_ordered,
                                       lambda b: _unescape(b)))
        # the 16 fixed big-endian bytes ARE the RFC-4122 sort order
        self.register(AttributeHandler(6, _uuid.UUID, _w_uuid, _r_uuid,
                                       _w_uuid, _r_uuid))
        self.register(AttributeHandler(7, _dt.datetime, _w_date, _r_date,
                                       _w_date_ordered, _r_date_ordered))
        self.register(AttributeHandler(8, list, self._w_list, self._r_list))
        self.register(AttributeHandler(9, dict, self._w_dict, self._r_dict))
        self.register(AttributeHandler(10, type(None),
                                       lambda o, v: None, lambda b: None))
        from titan_tpu_torch.core.attribute import Geoshape
        self.register(AttributeHandler(11, Geoshape, _w_geoshape, _r_geoshape))
        # widening toward the reference's ~30-type registry (Java's
        # byte/short/char/array types collapse into Python int/bytes/list,
        # so the meaningful additions are these)
        import decimal as _decimal
        self.register(AttributeHandler(
            12, _decimal.Decimal,
            lambda o, v: _w_str(o, str(v)),
            lambda b: _decimal.Decimal(_r_str(b))))
        def _ordinal(v) -> int:
            # datetime IS a date subclass; silently truncating its time
            # component under a date-typed key would be data loss
            if isinstance(v, _dt.datetime):
                raise TypeError(
                    "datetime value under a date-typed key (use a datetime "
                    "property key, or pass value.date() explicitly)")
            return v.toordinal()

        self.register(AttributeHandler(
            13, _dt.date,
            lambda o, v: o.put_svar(_ordinal(v)),
            lambda b: _dt.date.fromordinal(b.get_svar()),
            lambda o, v: _w_long_ordered(o, _ordinal(v)),
            lambda b: _dt.date.fromordinal(_r_long_ordered(b))))
        def _time_micros(v) -> int:
            if v.tzinfo is not None:
                raise TypeError(
                    "tz-aware time has no total order (offsets vary); "
                    "store naive times or a full datetime")
            return ((v.hour * 60 + v.minute) * 60 + v.second) * 1_000_000 \
                + v.microsecond

        def _time_from_micros(us: int) -> _dt.time:
            s, us = divmod(us, 1_000_000)
            m, s = divmod(s, 60)
            h, m = divmod(m, 60)
            return _dt.time(h, m, s, us)

        self.register(AttributeHandler(
            14, _dt.time,
            lambda o, v: _w_str(o, v.isoformat()),
            lambda b: _dt.time.fromisoformat(_r_str(b)),
            lambda o, v: _w_long_ordered(o, _time_micros(v)),
            lambda b: _time_from_micros(_r_long_ordered(b))))

        def _micros(v) -> int:
            us = v.days * 86_400_000_000 + v.seconds * 1_000_000 \
                + v.microseconds
            if not (-(1 << 62) <= us < (1 << 62)):
                # the order-preserving int codec is 63-bit; wrapping would
                # silently corrupt value AND sort order
                raise ValueError("timedelta out of 63-bit-microsecond range")
            return us

        self.register(AttributeHandler(
            15, _dt.timedelta,
            lambda o, v: o.put_svar(_micros(v)),
            lambda b: _dt.timedelta(microseconds=b.get_svar()),
            lambda o, v: _w_long_ordered(o, _micros(v)),
            lambda b: _dt.timedelta(microseconds=_r_long_ordered(b))))
        self.register(AttributeHandler(
            16, tuple, lambda o, v: self._w_list(o, list(v)),
            lambda b: tuple(self._r_list(b))))
        self.register(AttributeHandler(
            17, set, lambda o, v: self._w_list(o, sorted(v, key=repr)),
            lambda b: set(self._r_list(b))))
        self.register(AttributeHandler(
            18, frozenset, lambda o, v: self._w_list(o, sorted(v, key=repr)),
            lambda b: frozenset(self._r_list(b))))
        # numpy arrays: the reference's primitive-array serializers
        # (ByteArraySerializer..DoubleArraySerializer) collapse to one
        # dtype-tagged dense codec — also the natural carrier for device-
        # bound property vectors (embeddings) in a TPU framework
        import numpy as _np

        def _w_ndarray(o, v):
            a = _np.ascontiguousarray(v)
            if a.dtype.hasobject or a.dtype.names is not None:
                # a structured/object dtype would serialize but its str()
                # is not np.dtype()-parseable — the row would be
                # permanently unreadable
                raise TypeError(
                    f"only plain numeric/bool ndarrays are storable "
                    f"(got dtype {a.dtype})")
            _w_str(o, a.dtype.str)
            o.put_uvar(a.ndim)
            for s in a.shape:
                o.put_uvar(s)
            _w_bytes(o, a.tobytes())

        def _r_ndarray(b):
            dtype = _np.dtype(_r_str(b))
            shape = tuple(b.get_uvar() for _ in range(b.get_uvar()))
            return _np.frombuffer(_r_bytes(b), dtype=dtype).reshape(shape) \
                .copy()

        self.register(AttributeHandler(19, _np.ndarray, _w_ndarray,
                                       _r_ndarray))
        # Enum members (reference: serialize/attribute/EnumSerializer —
        # stores the enum class + ordinal; here class path + member name,
        # resilient to member reordering)
        import enum as _enum
        import importlib as _importlib

        def _w_enum(o, v):
            cls = type(v)
            # refuse classes that cannot be re-imported by path (local
            # scopes, __main__): the bytes would be permanently unreadable
            if "<locals>" in cls.__qualname__ or \
                    cls.__module__ in ("__main__", "builtins"):
                raise TypeError(
                    f"enum class {cls.__qualname__} is not importable by "
                    f"path (module {cls.__module__!r}); move it to a "
                    f"module before storing its members")
            _w_str(o, f"{cls.__module__}:{cls.__qualname__}")
            _w_str(o, v.name)

        def _r_enum(b):
            path, name = _r_str(b), _r_str(b)
            mod_name, _, qual = path.partition(":")
            # deserialization must never IMPORT from stored bytes (module
            # import runs module-level code — crafted cells could execute
            # any module on sys.path). Resolve only from modules the
            # application already imported, or from titan_tpu_torch's
            # own packages (safe: first-party, import is idempotent).
            import sys as _sys
            obj = _sys.modules.get(mod_name)
            if obj is None:
                if mod_name == "titan_tpu_torch" or \
                        mod_name.startswith("titan_tpu_torch."):
                    obj = _importlib.import_module(mod_name)
                else:
                    raise TypeError(
                        f"stored enum module {mod_name!r} is not "
                        "imported; import it before reading this value")
            for part in qual.split("."):
                obj = getattr(obj, part)
            # guard the deserialization surface: only genuine Enum
            # classes may be indexed (arbitrary __getitem__ on a stored
            # path would be an attack vector)
            if not (isinstance(obj, type) and issubclass(obj, _enum.Enum)):
                raise TypeError(
                    f"stored enum path {path!r} does not resolve to an "
                    f"Enum class")
            return obj[name]

        self.register(AttributeHandler(20, _enum.Enum, _w_enum, _r_enum))

    def register(self, h: AttributeHandler):
        if h.code in self._by_code or h.py_type in self._by_type:
            raise ValueError(f"duplicate attribute handler: {h.code}/{h.py_type}")
        self._by_code[h.code] = h
        self._by_type[h.py_type] = h

    def handler_for(self, value_or_type) -> AttributeHandler:
        import enum as _enum
        t = value_or_type if isinstance(value_or_type, type) else type(value_or_type)
        h = self._by_type.get(t)
        if h is None:
            # Enum FIRST: IntEnum/StrEnum also subclass int/str, and the
            # primitive handlers would silently strip the enum type
            if issubclass(t, _enum.Enum) and _enum.Enum in self._by_type:
                return self._by_type[_enum.Enum]
            for base, hh in self._by_type.items():
                if base is not type(None) and issubclass(t, base):
                    return hh
            raise TypeError(f"no serializer registered for {t.__name__}")
        return h

    # -- self-describing values ([code u8][payload]) -------------------------

    def write_value(self, out: DataOutput, value: Any) -> None:
        h = self.handler_for(value)
        out.put_u8(h.code)
        h.write(out, value)

    def read_value(self, buf: ReadBuffer) -> Any:
        h = self._by_code[buf.get_u8()]
        return h.read(buf)

    def value_bytes(self, value: Any) -> bytes:
        out = DataOutput()
        self.write_value(out, value)
        return out.getvalue()

    def value_from_bytes(self, b: bytes) -> Any:
        return self.read_value(ReadBuffer(b))

    # -- order-preserving values (schema-typed, raw payload) -----------------

    def orderable(self, py_type: type) -> bool:
        h = self._by_type.get(py_type)
        return h is not None and h.orderable

    def write_ordered(self, out: DataOutput, value: Any, py_type: type) -> None:
        h = self._by_type.get(py_type) or self.handler_for(value)
        if not h.orderable:
            raise TypeError(f"{py_type.__name__} has no order-preserving codec")
        h.write_ordered(out, value)

    def read_ordered(self, buf: ReadBuffer, py_type: type) -> Any:
        h = self._by_type[py_type]
        if not h.orderable:
            raise TypeError(f"{py_type.__name__} has no order-preserving codec")
        return h.read_ordered(buf)

    def ordered_bytes(self, value: Any, py_type: Optional[type] = None) -> bytes:
        out = DataOutput()
        self.write_ordered(out, value, py_type or type(value))
        return out.getvalue()

    # -- containers ----------------------------------------------------------

    def _w_list(self, out: DataOutput, v: list):
        out.put_uvar(len(v))
        for item in v:
            self.write_value(out, item)

    def _r_list(self, buf: ReadBuffer) -> list:
        return [self.read_value(buf) for _ in range(buf.get_uvar())]

    def _w_dict(self, out: DataOutput, v: dict):
        out.put_uvar(len(v))
        for key, val in v.items():
            self.write_value(out, key)
            self.write_value(out, val)

    def _r_dict(self, buf: ReadBuffer) -> dict:
        return {self.read_value(buf): self.read_value(buf)
                for _ in range(buf.get_uvar())}


DEFAULT = Serializer()
