"""The `isg_ai.ImageYoloBoxesPair` record in proto2 wire format, without
the protobuf package.

Fields 1-9 of `yolov3_tpu/data/isg_ai.proto` (the reference schema,
reference/isg_ai.proto:15-31). `SerializeToString` writes the fields
that were set, in field-number order, as protobuf does, so its bytes
equal the generated `isg_ai_pb2` message's; `ParseFromString` reads what
either writes: the last occurrence of a field wins, and fields of other
numbers are skipped, as protobuf skips unknown fields.
"""

from __future__ import annotations

import struct
from typing import Tuple

# wire types
VARINT, I64, LEN, SGROUP, EGROUP, I32 = 0, 1, 2, 3, 4, 5

# field number -> (name, kind); int32 travels as a varint, bytes and
# string as length-delimited
FIELDS = {
    1: ("channels", "int32"),
    2: ("img_height", "int32"),
    3: ("img_width", "int32"),
    4: ("image", "bytes"),
    5: ("box_count", "int32"),
    6: ("boxes", "bytes"),
    7: ("img_type", "string"),
    8: ("box_type", "string"),
    9: ("label", "int32"),
}
_DEFAULTS = {"int32": 0, "bytes": b"", "string": ""}


def _put_varint(out: bytearray, value: int) -> None:
    value &= (1 << 64) - 1  # negative int32 as its 64-bit two's complement
    while True:
        low = value & 0x7F
        value >>= 7
        if value:
            out.append(low | 0x80)
        else:
            out.append(low)
            return


def _get_varint(buf: memoryview, pos: int) -> Tuple[int, int]:
    value = shift = 0
    while True:
        if pos >= len(buf) or shift >= 70:
            raise ValueError("truncated or overlong varint")
        b = buf[pos]
        pos += 1
        value |= (b & 0x7F) << shift
        if not b & 0x80:
            return value & ((1 << 64) - 1), pos
        shift += 7


def _skip(buf: memoryview, pos: int, wire: int, field: int) -> int:
    """Position after an unknown field's value."""
    if wire == VARINT:
        return _get_varint(buf, pos)[1]
    if wire == I64:
        pos += 8
    elif wire == I32:
        pos += 4
    elif wire == LEN:
        n, pos = _get_varint(buf, pos)
        pos += n
    elif wire == SGROUP:
        while True:
            key, pos = _get_varint(buf, pos)
            if key & 7 == EGROUP:
                if key >> 3 != field:
                    raise ValueError("mismatched end group")
                return pos
            pos = _skip(buf, pos, key & 7, key >> 3)
    else:
        raise ValueError(f"invalid wire type {wire}")
    if pos > len(buf):
        raise ValueError("truncated field")
    return pos


class ImageYoloBoxesPair:
    """The record message: attributes named as the proto's fields."""

    def __init__(self, **values):
        self._set = set()
        for name, kind in FIELDS.values():
            object.__setattr__(self, name, _DEFAULTS[kind])
        for name, value in values.items():
            setattr(self, name, value)

    def __setattr__(self, name, value):
        if name != "_set":
            self._set.add(name)
        object.__setattr__(self, name, value)

    def SerializeToString(self) -> bytes:
        out = bytearray()
        for number, (name, kind) in FIELDS.items():
            if name not in self._set:
                continue
            value = getattr(self, name)
            if kind == "int32":
                _put_varint(out, number << 3 | VARINT)
                _put_varint(out, int(value))
                continue
            data = value.encode("utf-8") if kind == "string" else bytes(value)
            _put_varint(out, number << 3 | LEN)
            _put_varint(out, len(data))
            out += data
        return bytes(out)

    def ParseFromString(self, blob) -> int:
        """Replace this message's fields with those in `blob`; returns its
        length, as protobuf does."""
        self.__init__()
        buf = memoryview(blob).cast("B")
        pos = 0
        while pos < len(buf):
            key, pos = _get_varint(buf, pos)
            number, wire = key >> 3, key & 7
            if number == 0:
                raise ValueError("field number 0")
            name, kind = FIELDS.get(number, (None, None))
            expect = VARINT if kind == "int32" else LEN
            if name is None or wire != expect:
                pos = _skip(buf, pos, wire, number)
                continue
            if kind == "int32":
                value, pos = _get_varint(buf, pos)
                # the low 32 bits, signed (protobuf's int32 cast)
                value = struct.unpack("<i", struct.pack("<I",
                                                        value & 0xFFFFFFFF))[0]
            else:
                n, pos = _get_varint(buf, pos)
                if pos + n > len(buf):
                    raise ValueError("truncated field")
                value = bytes(buf[pos:pos + n])
                pos += n
                if kind == "string":
                    value = value.decode("utf-8")
            setattr(self, name, value)
        return len(buf)
