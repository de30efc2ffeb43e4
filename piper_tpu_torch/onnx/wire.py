"""Minimal protobuf wire-format codec (no protobuf dependency).

The port's copy of piper_tpu.onnx.wire. The only thing the package uses
ONNX for is extracting named weights and node attributes, so it needs no
`onnx` package.

Wire types: 0 = varint, 1 = fixed64, 2 = length-delimited, 5 = fixed32.
"""

from __future__ import annotations

import struct
from typing import Iterator, List, Tuple

WIRE_VARINT = 0
WIRE_FIXED64 = 1
WIRE_LEN = 2
WIRE_FIXED32 = 5


class WireError(ValueError):
    pass


class Reader:
    __slots__ = ("buf", "pos", "end")

    def __init__(self, buf: bytes | memoryview, pos: int = 0, end: int | None = None):
        self.buf = memoryview(buf)
        self.pos = pos
        self.end = len(self.buf) if end is None else end

    def at_end(self) -> bool:
        return self.pos >= self.end

    def read_varint(self) -> int:
        result = 0
        shift = 0
        buf, pos, end = self.buf, self.pos, self.end
        while True:
            if pos >= end:
                raise WireError(f"truncated varint at offset {pos}")
            b = buf[pos]
            pos += 1
            result |= (b & 0x7F) << shift
            if not (b & 0x80):
                break
            shift += 7
            if shift > 63:
                raise WireError(f"varint too long at offset {self.pos}")
        self.pos = pos
        return result

    def read_tag(self) -> Tuple[int, int]:
        tag = self.read_varint()
        return tag >> 3, tag & 0x7

    def read_fixed32(self) -> int:
        if self.pos + 4 > self.end:
            raise WireError(f"truncated fixed32 at offset {self.pos}")
        (v,) = struct.unpack_from("<I", self.buf, self.pos)
        self.pos += 4
        return v

    def read_fixed64(self) -> int:
        if self.pos + 8 > self.end:
            raise WireError(f"truncated fixed64 at offset {self.pos}")
        (v,) = struct.unpack_from("<Q", self.buf, self.pos)
        self.pos += 8
        return v

    def read_bytes(self) -> memoryview:
        n = self.read_varint()
        if self.pos + n > self.end:
            raise WireError(
                f"truncated length-delimited field at offset {self.pos} (len {n})"
            )
        out = self.buf[self.pos : self.pos + n]
        self.pos += n
        return out

    def read_string(self) -> str:
        return bytes(self.read_bytes()).decode("utf-8")

    def sub_reader(self) -> "Reader":
        data = self.read_bytes()
        return Reader(data)

    def skip(self, wire_type: int) -> None:
        if wire_type == WIRE_VARINT:
            self.read_varint()
        elif wire_type == WIRE_FIXED64:
            self.pos += 8
        elif wire_type == WIRE_LEN:
            n = self.read_varint()
            self.pos += n
        elif wire_type == WIRE_FIXED32:
            self.pos += 4
        else:
            raise WireError(f"unsupported wire type {wire_type} at offset {self.pos}")
        if self.pos > self.end:
            raise WireError("skip ran past end of buffer")

    def read_packed_varints(self) -> List[int]:
        sub = self.sub_reader()
        out: List[int] = []
        while not sub.at_end():
            out.append(sub.read_varint())
        return out

    def read_packed_fixed32(self) -> bytes:
        """Raw little-endian bytes of a packed fixed32 field (for np.frombuffer)."""
        return bytes(self.read_bytes())

    def fields(self) -> Iterator[Tuple[int, int]]:
        while not self.at_end():
            yield self.read_tag()


def zigzag_decode(v: int) -> int:
    return (v >> 1) ^ -(v & 1)


def decode_signed_varint(v: int) -> int:
    """Interpret a varint as a signed int64 (two's complement), the encoding
    protobuf uses for plain int64 fields (not zigzag)."""
    if v >= 1 << 63:
        v -= 1 << 64
    return v


class Writer:
    """Protobuf wire-format encoder, used to emit synthetic ONNX checkpoints
    for tests and benchmarks (the reference has no writer; we need one because
    real voice downloads are unavailable offline)."""

    __slots__ = ("parts",)

    def __init__(self):
        self.parts: List[bytes] = []

    def _varint(self, v: int) -> bytes:
        if v < 0:
            v += 1 << 64
        out = bytearray()
        while True:
            b = v & 0x7F
            v >>= 7
            if v:
                out.append(b | 0x80)
            else:
                out.append(b)
                return bytes(out)

    def tag(self, field: int, wire_type: int) -> None:
        self.parts.append(self._varint((field << 3) | wire_type))

    def varint_field(self, field: int, value: int) -> None:
        self.tag(field, WIRE_VARINT)
        self.parts.append(self._varint(value))

    def bytes_field(self, field: int, value: bytes) -> None:
        self.tag(field, WIRE_LEN)
        self.parts.append(self._varint(len(value)))
        self.parts.append(value)

    def string_field(self, field: int, value: str) -> None:
        self.bytes_field(field, value.encode("utf-8"))

    def float_field(self, field: int, value: float) -> None:
        self.tag(field, WIRE_FIXED32)
        self.parts.append(struct.pack("<f", value))

    def message_field(self, field: int, sub: "Writer") -> None:
        self.bytes_field(field, sub.to_bytes())

    def packed_varints_field(self, field: int, values) -> None:
        sub = bytearray()
        for v in values:
            vv = int(v)
            if vv < 0:
                vv += 1 << 64
            while True:
                b = vv & 0x7F
                vv >>= 7
                if vv:
                    sub.append(b | 0x80)
                else:
                    sub.append(b)
                    break
        self.bytes_field(field, bytes(sub))

    def to_bytes(self) -> bytes:
        return b"".join(self.parts)
