"""The parts of ``surge_tpu/log/segment.py`` the columnar segment uses: the
per-payload codec ids and the uvarint framing. The port writes every payload
raw (``CODEC_RAW``); its SLZ codec (the reference's native ``csrc/segment.cc``)
is not carried, so a payload stored with ``CODEC_SLZ`` raises on read."""

from __future__ import annotations

from typing import Tuple

CODEC_RAW = 0
CODEC_SLZ = 1


def slz_decompress(data: bytes, uncompressed_len: int) -> bytes:
    """What the reference raises when its native codec is not built."""
    raise RuntimeError("native segment codec not built (csrc/build.sh) but a "
                       "compressed block was encountered")


def _put_uvarint(buf: bytearray, n: int) -> None:
    while n >= 0x80:
        buf.append((n & 0x7F) | 0x80)
        n >>= 7
    buf.append(n)


def _get_uvarint(data: bytes, pos: int) -> Tuple[int, int]:
    shift = n = 0
    while True:
        b = data[pos]
        pos += 1
        n |= (b & 0x7F) << shift
        if not b & 0x80:
            return n, pos
        shift += 7
