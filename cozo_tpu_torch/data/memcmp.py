"""Order-preserving binary codec for values and tuples.

This is the single serialization used for both storage *keys* and *values*
(the reference uses memcmp keys + msgpack values; here one self-delimiting
order-preserving codec serves both roles, which keeps the storage layer to
exactly one code path).

Type-tag order mirrors the reference storage order
(`cozo-core/src/data/memcmp.rs:21-35`): note vectors sort *before*
numbers in storage keys, unlike the value order — a reference quirk we
preserve so index layouts match.

Byte-level format (self-designed, NOT the reference's):

- NULL/FALSE/TRUE/BOT: tag only
- NUM:   tag + 8B f64-total-order bits + 1B disc (0=int,1=float)
         + (ints only) 8B sign-flipped exact value
- STR/BYTES/REGEX/JSON: tag + 0x00-escaped payload + 0x00 0x00 terminator
- UUID:  tag + 16B field-reordered bytes
- VEC:   tag + 1B eltype (1=f32, 2=f64) + 4B BE length + order-bits per el
- LIST/SET: tag + encoded elements + 0x00 terminator
- VLD:   tag + 8B bitwise-NOT(sign-flipped ts) (descending) + 1B (0=assert)

All variable-length encodings keep the prefix property so concatenated
tuples compare correctly bytewise.
"""

from __future__ import annotations

import json as _json
import struct
from typing import Any, List, Tuple

import numpy as np

from .value import (
    BOT,
    DSet,
    Json,
    Regex,
    Uuid,
    Validity,
    Vector,
    _BotType,
    bits_to_float,
    coerce_int,
    float_order_bits,
)

INIT_TAG = 0x00
NULL_TAG = 0x01
FALSE_TAG = 0x02
TRUE_TAG = 0x03
VEC_TAG = 0x04
NUM_TAG = 0x05
STR_TAG = 0x06
BYTES_TAG = 0x07
UUID_TAG = 0x08
REGEX_TAG = 0x09
LIST_TAG = 0x0A
SET_TAG = 0x0B
VLD_TAG = 0x0C
JSON_TAG = 0x0D
BOT_TAG = 0xFF

_U64 = struct.Struct(">Q")
_U32 = struct.Struct(">I")
_F32 = struct.Struct(">f")

U64_MASK = 0xFFFF_FFFF_FFFF_FFFF


def _enc_escaped(buf: bytearray, payload: bytes) -> None:
    buf.extend(payload.replace(b"\x00", b"\x00\x01"))
    buf.extend(b"\x00\x00")


def _dec_escaped(data: bytes, pos: int) -> Tuple[bytes, int]:
    """Decode a 0x00-escaped payload: chunks between 0x00 markers are
    sliced wholesale (bytes.find) instead of walking byte-by-byte — this
    is the hot inner loop of every row decode."""
    n = len(data)
    z = data.find(b"\x00", pos)
    if z < 0 or z + 1 >= n:
        raise ValueError("unterminated escaped encoding")
    if data[z + 1] == 0:  # common case: payload has no embedded zero bytes
        return data[pos:z], z + 2
    out = bytearray()
    while True:
        nxt = data[z + 1]
        if nxt == 0:
            out.extend(data[pos:z])
            return bytes(out), z + 2
        if nxt != 1:
            raise ValueError("corrupt escaped encoding")
        out.extend(data[pos:z])
        out.append(0)
        pos = z + 2
        z = data.find(b"\x00", pos)
        if z < 0 or z + 1 >= n:
            raise ValueError("unterminated escaped encoding")


def _f32_order_bits(f: float) -> int:
    (bits,) = struct.unpack(">I", _F32.pack(f))
    if bits & 0x8000_0000:
        return (~bits) & 0xFFFF_FFFF
    return bits | 0x8000_0000


def _f32_from_bits(key: int) -> float:
    if key & 0x8000_0000:
        bits = key & 0x7FFF_FFFF
    else:
        bits = (~key) & 0xFFFF_FFFF
    return struct.unpack(">f", struct.pack(">I", bits))[0]


def encode_value(buf: bytearray, v: Any) -> None:
    if v is None:
        buf.append(NULL_TAG)
        return
    t = type(v)
    if t is bool:
        buf.append(TRUE_TAG if v else FALSE_TAG)
        return
    if t is int:
        coerce_int(v)  # raise (not silently wrap) outside the i64 domain
        buf.append(NUM_TAG)
        buf.extend(_U64.pack(float_order_bits(float(v))))
        buf.append(0)
        buf.extend(_U64.pack((v + (1 << 63)) & U64_MASK))
        return
    if t is float:
        buf.append(NUM_TAG)
        buf.extend(_U64.pack(float_order_bits(v)))
        buf.append(1)
        return
    if t is str:
        buf.append(STR_TAG)
        _enc_escaped(buf, v.encode("utf-8"))
        return
    if t is bytes:
        buf.append(BYTES_TAG)
        _enc_escaped(buf, v)
        return
    if t is Uuid:
        buf.append(UUID_TAG)
        buf.extend(v.sort_bytes())
        return
    if t is Regex:
        buf.append(REGEX_TAG)
        _enc_escaped(buf, v.source.encode("utf-8"))
        return
    if t is list or t is tuple:
        buf.append(LIST_TAG)
        for e in v:
            encode_value(buf, e)
        buf.append(INIT_TAG)
        return
    if t is DSet:
        buf.append(SET_TAG)
        for e in v.items:
            encode_value(buf, e)
        buf.append(INIT_TAG)
        return
    if t is Vector:
        buf.append(VEC_TAG)
        a = np.ascontiguousarray(v.a)
        # vectorized order-bit transform (bit-identical to the scalar
        # _f32_order_bits/float_order_bits loops; ~100x faster per row)
        if a.dtype == np.float32:
            buf.append(1)
            buf.extend(_U32.pack(a.shape[0]))
            u = a.view(np.uint32)
            ob = np.where(u & 0x8000_0000, ~u, u | np.uint32(0x8000_0000))
            buf.extend(ob.astype(">u4").tobytes())
        else:
            buf.append(2)
            buf.extend(_U32.pack(a.shape[0]))
            u = a.view(np.uint64)
            ob = np.where(
                u & 0x8000_0000_0000_0000,
                ~u,
                u | np.uint64(0x8000_0000_0000_0000),
            )
            buf.extend(ob.astype(">u8").tobytes())
        return
    if t is Json:
        buf.append(JSON_TAG)
        _enc_escaped(buf, v.canonical().encode("utf-8"))
        return
    if t is Validity:
        buf.append(VLD_TAG)
        asc = (v.ts + (1 << 63)) & U64_MASK
        buf.extend(_U64.pack((~asc) & U64_MASK))
        buf.append(0 if v.is_assert else 1)
        return
    if t is _BotType:
        buf.append(BOT_TAG)
        return
    if isinstance(v, np.integer):
        encode_value(buf, int(v))
        return
    if isinstance(v, np.floating):
        encode_value(buf, float(v))
        return
    raise TypeError(f"cannot encode value {v!r} ({type(v)})")


def decode_value(data: bytes, pos: int) -> Tuple[Any, int]:
    tag = data[pos]
    pos += 1
    if tag == NULL_TAG:
        return None, pos
    if tag == FALSE_TAG:
        return False, pos
    if tag == TRUE_TAG:
        return True, pos
    if tag == NUM_TAG:
        (bits,) = _U64.unpack_from(data, pos)
        pos += 8
        disc = data[pos]
        pos += 1
        if disc == 0:
            (raw,) = _U64.unpack_from(data, pos)
            pos += 8
            return raw - (1 << 63), pos
        return bits_to_float(bits), pos
    if tag == STR_TAG:
        payload, pos = _dec_escaped(data, pos)
        return payload.decode("utf-8"), pos
    if tag == BYTES_TAG:
        payload, pos = _dec_escaped(data, pos)
        return payload, pos
    if tag == UUID_TAG:
        sb = data[pos : pos + 16]
        pos += 16
        orig = sb[4:8] + sb[2:4] + sb[0:2] + sb[8:16]
        return Uuid(orig), pos
    if tag == REGEX_TAG:
        payload, pos = _dec_escaped(data, pos)
        return Regex(payload.decode("utf-8")), pos
    if tag == LIST_TAG:
        out: List[Any] = []
        while data[pos] != INIT_TAG:
            v, pos = decode_value(data, pos)
            out.append(v)
        return out, pos + 1
    if tag == SET_TAG:
        out = []
        while data[pos] != INIT_TAG:
            v, pos = decode_value(data, pos)
            out.append(v)
        return DSet(out), pos + 1
    if tag == VEC_TAG:
        eltype = data[pos]
        pos += 1
        (n,) = _U32.unpack_from(data, pos)
        pos += 4
        if eltype == 1:
            ob = np.frombuffer(data, dtype=">u4", count=n, offset=pos).astype(
                np.uint32
            )
            pos += 4 * n
            bits = np.where(
                ob & 0x8000_0000, ob & np.uint32(0x7FFF_FFFF), ~ob
            )
            return Vector(bits.view(np.float32)), pos
        ob = np.frombuffer(data, dtype=">u8", count=n, offset=pos).astype(
            np.uint64
        )
        pos += 8 * n
        bits = np.where(
            ob & 0x8000_0000_0000_0000,
            ob & np.uint64(0x7FFF_FFFF_FFFF_FFFF),
            ~ob,
        )
        return Vector(bits.view(np.float64)), pos
    if tag == JSON_TAG:
        payload, pos = _dec_escaped(data, pos)
        return Json(_json.loads(payload.decode("utf-8"))), pos
    if tag == VLD_TAG:
        (flipped,) = _U64.unpack_from(data, pos)
        pos += 8
        asc = (~flipped) & U64_MASK
        ts = asc - (1 << 63)
        is_assert = data[pos] == 0
        pos += 1
        return Validity(ts, is_assert), pos
    if tag == BOT_TAG:
        return BOT, pos
    raise ValueError(f"unknown value tag 0x{tag:02x} at {pos - 1}")


def _py_encode_tuple(tup) -> bytes:
    buf = bytearray()
    for v in tup:
        encode_value(buf, v)
    return bytes(buf)


def _py_decode_tuple(data: bytes, pos: int = 0, end: int | None = None) -> list:
    out = []
    if end is None:
        end = len(data)
    while pos < end:
        v, pos = decode_value(data, pos)
        out.append(v)
    return out


try:  # C scalar codec (native/codec.c); falls back per-call on complex
    from ..utils.native_codec import load as _load_ccodec

    _ccodec = _load_ccodec()
except Exception:  # pragma: no cover — no compiler / exotic platform
    _ccodec = None

if _ccodec is not None:
    _c_enc = _ccodec.encode_tuple
    _c_dec = _ccodec.decode_tuple

    def encode_tuple(tup) -> bytes:
        out = _c_enc(tup)
        return out if out is not None else _py_encode_tuple(tup)

    def decode_tuple(data: bytes, pos: int = 0, end: int | None = None) -> list:
        out = _c_dec(data, pos, -1 if end is None else end)
        return out if out is not None else _py_decode_tuple(data, pos, end)

else:  # pragma: no cover
    encode_tuple = _py_encode_tuple
    decode_tuple = _py_decode_tuple
