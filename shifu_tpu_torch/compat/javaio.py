"""Java DataInput/DataOutput wire-format primitives (counterpart of
`shifu_tpu/compat/javaio.py`).

The reference serializes every model spec with java.io.DataOutputStream:
big-endian fixed-width primitives, `writeUTF` modified-UTF-8 strings
(2-byte length prefix), and Shifu's own `StringUtils.writeString`
(4-byte length + plain UTF-8, ml/shifu/shifu/core/dtrain/StringUtils.java).
This module reimplements those primitives so the port can read and write
the reference's binary model specs byte-compatibly.
"""

from __future__ import annotations

import struct
from typing import BinaryIO, List


class JavaDataInput:
    """DataInputStream reader over a bytes-like stream."""

    def __init__(self, stream: BinaryIO):
        self._s = stream

    def _read(self, n: int) -> bytes:
        data = self._s.read(n)
        if len(data) != n:
            raise EOFError(f"expected {n} bytes, got {len(data)}")
        return data

    def read_boolean(self) -> bool:
        return self._read(1)[0] != 0

    def read_byte(self) -> int:
        return struct.unpack(">b", self._read(1))[0]

    def read_unsigned_byte(self) -> int:
        return self._read(1)[0]

    def read_short(self) -> int:
        return struct.unpack(">h", self._read(2))[0]

    def read_unsigned_short(self) -> int:
        return struct.unpack(">H", self._read(2))[0]

    def read_int(self) -> int:
        return struct.unpack(">i", self._read(4))[0]

    def read_long(self) -> int:
        return struct.unpack(">q", self._read(8))[0]

    def read_float(self) -> float:
        return struct.unpack(">f", self._read(4))[0]

    def read_double(self) -> float:
        return struct.unpack(">d", self._read(8))[0]

    def read_utf(self) -> str:
        """DataInputStream.readUTF: 2-byte length + modified UTF-8."""
        n = self.read_unsigned_short()
        return decode_modified_utf8(self._read(n))

    def read_utf_body(self, n: int) -> str:
        """Modified UTF-8 body whose length was already consumed.

        Mirrors IndependentTreeModel.readUTF(in, utflen)
        (dt/IndependentTreeModel.java:1105) used when a short marker
        doubles as the length.
        """
        return decode_modified_utf8(self._read(n))

    def read_string(self) -> str:
        """Shifu StringUtils.readString: 4-byte length + plain UTF-8."""
        n = self.read_int()
        if n == 0:
            return ""
        return self._read(n).decode("utf-8")

    def read_int_array(self) -> List[int]:
        n = self.read_int()
        return list(struct.unpack(f">{n}i", self._read(4 * n))) if n else []

    def read_double_array(self) -> List[float]:
        n = self.read_int()
        return list(struct.unpack(f">{n}d", self._read(8 * n))) if n else []


class JavaDataOutput:
    """DataOutputStream writer over a binary stream."""

    def __init__(self, stream: BinaryIO):
        self._s = stream

    def write_boolean(self, v: bool) -> None:
        self._s.write(b"\x01" if v else b"\x00")

    def write_byte(self, v: int) -> None:
        self._s.write(struct.pack(">b", v))

    def write_short(self, v: int) -> None:
        self._s.write(struct.pack(">h", v))

    def write_int(self, v: int) -> None:
        self._s.write(struct.pack(">i", v))

    def write_long(self, v: int) -> None:
        self._s.write(struct.pack(">q", v))

    def write_float(self, v: float) -> None:
        self._s.write(struct.pack(">f", v))

    def write_double(self, v: float) -> None:
        self._s.write(struct.pack(">d", v))

    def write_utf(self, s: str) -> None:
        body = encode_modified_utf8(s)
        if len(body) > 0xFFFF:
            raise ValueError("writeUTF limited to 65535 encoded bytes")
        self._s.write(struct.pack(">H", len(body)))
        self._s.write(body)

    def write_string(self, s: str) -> None:
        """Shifu StringUtils.writeString: 4-byte length + plain UTF-8."""
        if s is None:
            self.write_int(0)
            return
        body = s.encode("utf-8")
        self.write_int(len(body))
        self._s.write(body)

    def write_int_array(self, arr) -> None:
        if arr is None:
            self.write_int(0)
            return
        self.write_int(len(arr))
        for v in arr:
            self.write_int(int(v))

    def write_double_array(self, arr) -> None:
        if arr is None:
            self.write_int(0)
            return
        self.write_int(len(arr))
        for v in arr:
            self.write_double(float(v))

    def write_raw(self, data: bytes) -> None:
        self._s.write(data)


def encode_modified_utf8(s: str) -> bytes:
    """Java modified UTF-8: U+0000 -> C0 80; supplementary chars as
    surrogate pairs each encoded as 3 bytes."""
    out = bytearray()
    for ch in s:
        cp = ord(ch)
        if cp >= 0x10000:  # encode as CESU-8 surrogate pair
            cp -= 0x10000
            for half in (0xD800 | (cp >> 10), 0xDC00 | (cp & 0x3FF)):
                out += bytes(
                    (0xE0 | (half >> 12), 0x80 | ((half >> 6) & 0x3F), 0x80 | (half & 0x3F))
                )
        elif cp >= 0x800:
            out += bytes((0xE0 | (cp >> 12), 0x80 | ((cp >> 6) & 0x3F), 0x80 | (cp & 0x3F)))
        elif cp >= 0x80 or cp == 0:
            out += bytes((0xC0 | (cp >> 6), 0x80 | (cp & 0x3F)))
        else:
            out.append(cp)
    return bytes(out)


def decode_modified_utf8(data: bytes) -> str:
    out: List[str] = []
    i, n = 0, len(data)
    pending_high = -1
    while i < n:
        b0 = data[i]
        if b0 < 0x80:
            cp = b0
            i += 1
        elif (b0 >> 5) == 0b110:
            cp = ((b0 & 0x1F) << 6) | (data[i + 1] & 0x3F)
            i += 2
        elif (b0 >> 4) == 0b1110:
            cp = ((b0 & 0x0F) << 12) | ((data[i + 1] & 0x3F) << 6) | (data[i + 2] & 0x3F)
            i += 3
        else:
            raise ValueError(f"invalid modified-UTF-8 lead byte {b0:#x}")
        if 0xD800 <= cp <= 0xDBFF:
            pending_high = cp
            continue
        if 0xDC00 <= cp <= 0xDFFF and pending_high >= 0:
            cp = 0x10000 + ((pending_high - 0xD800) << 10) + (cp - 0xDC00)
            pending_high = -1
        out.append(chr(cp))
    return "".join(out)
