"""Dynamic value model for cozo_tpu.

Mirrors the 13-variant value system of the reference engine
(`cozo-core/src/data/value.rs:146-174`), redesigned for a Python host +
TPU (JAX) compute core:

- scalars are plain Python objects (None / bool / int / float / str / bytes)
- special database types get small wrapper classes (Uuid, Regex, Vector,
  Json, Validity, DSet, Bot)
- vectors wrap numpy arrays (f32/f64) so they can move to device untouched.

Two total orders exist, as in the reference:

- ``cmp_key(v)``: the *value order* (enum-declaration order in the
  reference: Null < Bool < Num < Str < Bytes < Uuid < Regex < List < Set <
  Vec < Json < Validity < Bot), used for `:order`, aggregations min/max,
  and temp-store sorting.
- the *storage order* implied by the memcmp codec (see ``memcmp.py``),
  whose type tags deliberately differ (vectors sort before numbers),
  mirroring `cozo-core/src/data/memcmp.rs:21-35`.

Numbers follow the reference's cross-type total order
(`data/value.rs:576-598`): ints and floats interleave numerically by the
f64 total order; on ties the int sorts first. Note equality in this order
distinguishes ``1`` from ``1.0`` (while the ``==`` *operator* coerces, see
`functions.py::op_eq`).
"""

from __future__ import annotations

import json as _json
import math
import re as _re
import struct
import uuid as _uuid
from typing import Any, Iterable, Tuple

import numpy as np

__all__ = [
    "Uuid",
    "Regex",
    "Vector",
    "Json",
    "Validity",
    "DSet",
    "Bot",
    "BOT",
    "cmp_key",
    "value_eq",
    "deep_freeze",
    "float_order_bits",
    "bits_to_float",
    "to_json",
    "from_json",
    "type_name",
    "MAX_I64",
    "MIN_I64",
    "coerce_int",
]

MAX_I64 = (1 << 63) - 1
MIN_I64 = -(1 << 63)

_F64 = struct.Struct(">d")
_I64 = struct.Struct(">q")
_U64 = struct.Struct(">Q")


def coerce_int(v: int) -> int:
    """Range-check to the engine's 64-bit signed integer domain."""
    if v > MAX_I64 or v < MIN_I64:
        from ..utils.errors import EvalError

        raise EvalError(
            f"integer out of 64-bit range: {v}", code="eval::int_out_of_range"
        )
    return v


def float_order_bits(f: float) -> int:
    """Map an f64 to an integer whose natural order == IEEE total order.

    Equivalent to Rust's ``f64::total_cmp``: flip all bits for negatives,
    flip the sign bit for non-negatives.
    """
    (bits,) = _U64.unpack(_F64.pack(f))
    if bits & 0x8000_0000_0000_0000:
        return (~bits) & 0xFFFF_FFFF_FFFF_FFFF
    return bits | 0x8000_0000_0000_0000


def bits_to_float(key: int) -> float:
    if key & 0x8000_0000_0000_0000:
        bits = key & 0x7FFF_FFFF_FFFF_FFFF
    else:
        bits = (~key) & 0xFFFF_FFFF_FFFF_FFFF
    return _F64.unpack(_U64.pack(bits))[0]


class Uuid:
    """UUID value. Ordering reorders fields so v1 UUIDs sort by timestamp
    (reference `data/value.rs:40-49`)."""

    __slots__ = ("u",)

    def __init__(self, u) -> None:
        if isinstance(u, Uuid):
            u = u.u
        elif isinstance(u, str):
            u = _uuid.UUID(u)
        elif isinstance(u, (bytes, bytearray)):
            u = _uuid.UUID(bytes=bytes(u))
        if not isinstance(u, _uuid.UUID):
            raise TypeError(f"cannot make Uuid from {u!r}")
        self.u = u

    def sort_bytes(self) -> bytes:
        b = self.u.bytes
        # (time_hi_and_version, time_mid, time_low, rest)
        return b[6:8] + b[4:6] + b[0:4] + b[8:16]

    def __eq__(self, other) -> bool:
        return isinstance(other, Uuid) and self.u == other.u

    def __hash__(self) -> int:
        return hash(("uuid", self.u))

    def __repr__(self) -> str:
        return f"Uuid({self.u})"

    def __str__(self) -> str:
        return str(self.u)


class Regex:
    """Regex value; only used transiently in expressions (cannot be stored)."""

    __slots__ = ("source", "compiled")

    def __init__(self, source: str) -> None:
        self.source = source
        self.compiled = _re.compile(source)

    def __eq__(self, other) -> bool:
        return isinstance(other, Regex) and self.source == other.source

    def __hash__(self) -> int:
        return hash(("regex", self.source))

    def __repr__(self) -> str:
        return f"Regex({self.source!r})"


class Vector:
    """Dense vector (f32 or f64), backed by a numpy array.

    This is the type that flows to the TPU index kernels; keep the buffer
    contiguous and typed.
    """

    __slots__ = ("a",)

    def __init__(self, a, dtype=None) -> None:
        if isinstance(a, Vector):
            a = a.a
        arr = np.asarray(a, dtype=dtype)
        if arr.dtype == np.float32 or arr.dtype == np.float64:
            pass
        elif dtype is None:
            arr = arr.astype(np.float64)
        if arr.ndim != 1:
            arr = arr.reshape(-1)
        self.a = np.ascontiguousarray(arr)

    @property
    def dtype(self):
        return self.a.dtype

    def __len__(self) -> int:
        return self.a.shape[0]

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, Vector)
            and self.a.dtype == other.a.dtype
            and self.a.shape == other.a.shape
            and bool(np.all(self.a == other.a))
        )

    def __hash__(self) -> int:
        return hash(("vec", self.a.dtype.char, self.a.tobytes()))

    def __repr__(self) -> str:
        return f"Vector({self.a.tolist()!r}, dtype={self.a.dtype})"


class Json:
    """JSON document value (distinct from List/Str scalars)."""

    __slots__ = ("v",)

    def __init__(self, v) -> None:
        if isinstance(v, Json):
            v = v.v
        self.v = v

    def canonical(self) -> str:
        return _json.dumps(self.v, sort_keys=True, separators=(",", ":"))

    def __eq__(self, other) -> bool:
        return isinstance(other, Json) and self.canonical() == other.canonical()

    def __hash__(self) -> int:
        return hash(("json", self.canonical()))

    def __repr__(self) -> str:
        return f"Json({self.v!r})"


class Validity:
    """Time-travel validity: (timestamp_micros, is_assert).

    Orders DESCENDING by timestamp then assert-first, mirroring the
    reference's ``Reverse`` wrappers (`data/value.rs:112-137`) so that
    scans see the latest fact first.
    """

    __slots__ = ("ts", "is_assert")

    def __init__(self, ts: int, is_assert: bool) -> None:
        self.ts = coerce_int(int(ts))
        self.is_assert = bool(is_assert)

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, Validity)
            and self.ts == other.ts
            and self.is_assert == other.is_assert
        )

    def __hash__(self) -> int:
        return hash(("vld", self.ts, self.is_assert))

    def __repr__(self) -> str:
        return f"Validity({self.ts}, {self.is_assert})"


class DSet:
    """Set value (sorted unique elements in value order)."""

    __slots__ = ("items",)

    def __init__(self, items: Iterable[Any]) -> None:
        uniq = {}
        for it in items:
            uniq[cmp_key(it)] = it
        self.items = tuple(v for _, v in sorted(uniq.items()))

    def __iter__(self):
        return iter(self.items)

    def __len__(self) -> int:
        return len(self.items)

    def __eq__(self, other) -> bool:
        return isinstance(other, DSet) and self.items == other.items

    def __hash__(self) -> int:
        return hash(("set", tuple(cmp_key(i) for i in self.items)))

    def __repr__(self) -> str:
        return f"DSet({list(self.items)!r})"


class _BotType:
    """Bottom — the guaranteed-largest value."""

    _inst = None

    def __new__(cls):
        if cls._inst is None:
            cls._inst = super().__new__(cls)
        return cls._inst

    def __repr__(self) -> str:
        return "Bot"

    def __eq__(self, other) -> bool:
        return isinstance(other, _BotType)

    def __hash__(self) -> int:
        return hash("__bot__")


Bot = _BotType
BOT = _BotType()

# --- value order (enum order in the reference) ------------------------------

T_NULL = 0
T_BOOL = 1
T_NUM = 2
T_STR = 3
T_BYTES = 4
T_UUID = 5
T_REGEX = 6
T_LIST = 7
T_SET = 8
T_VEC = 9
T_JSON = 10
T_VLD = 11
T_BOT = 12


def num_key(v) -> Tuple[int, int, int]:
    """Total-order key for a number: (f64 order bits, 0 int/1 float, exact)."""
    if isinstance(v, bool):  # defensive; bools are not Num
        raise TypeError("bool is not a number value")
    if isinstance(v, int):
        return (float_order_bits(float(v)), 0, v)
    return (float_order_bits(v), 1, 0)


def cmp_key(v) -> tuple:
    """Hashable, totally ordered key for any value (the *value order*)."""
    if v is None:
        return (T_NULL,)
    t = type(v)
    if t is bool:
        return (T_BOOL, v)
    if t is int:
        return (T_NUM,) + num_key(v)
    if t is float:
        return (T_NUM,) + num_key(v)
    if t is str:
        return (T_STR, v)
    if t is bytes:
        return (T_BYTES, v)
    if t is Uuid:
        return (T_UUID, v.sort_bytes())
    if t is Regex:
        return (T_REGEX, v.source)
    if t is list or t is tuple:
        return (T_LIST, tuple(cmp_key(e) for e in v))
    if t is DSet:
        return (T_SET, tuple(cmp_key(e) for e in v.items))
    if t is Vector:
        dt = 0 if v.a.dtype == np.float32 else 1
        # big-endian order-bit bytes: lexicographic byte order == elementwise
        # IEEE total order, and building one bytes object is ~100x faster
        # than a per-element Python tuple
        a = np.ascontiguousarray(v.a.astype(np.float64, copy=False))
        u = a.view(np.uint64)
        ob = np.where(
            u & 0x8000_0000_0000_0000,
            ~u,
            u | np.uint64(0x8000_0000_0000_0000),
        )
        return (T_VEC, dt, ob.astype(">u8").tobytes())
    if t is Json:
        return (T_JSON, v.canonical())
    if t is Validity:
        return (T_VLD, -v.ts, 0 if v.is_assert else 1)
    if t is _BotType:
        return (T_BOT,)
    if isinstance(v, np.integer):
        return (T_NUM,) + num_key(int(v))
    if isinstance(v, np.floating):
        return (T_NUM,) + num_key(float(v))
    if isinstance(v, frozenset) or isinstance(v, set):
        return cmp_key(DSet(v))
    raise TypeError(f"not a database value: {v!r} ({type(v)})")


def tuple_key(tup) -> tuple:
    return tuple(cmp_key(v) for v in tup)


_NEGZERO_KEY = (T_NUM, "-0.0")


def fast_key(v):
    """Hashable dedup key with cmp_key's EQUALITY semantics but NOT its
    order (keys of different types don't compare).  ~10x cheaper than
    cmp_key for the scalar-heavy case: raw Python hashing instead of
    float_order_bits bit-twiddling per value.  Used by entry-store dedup
    (query/eval.FastEntryStore) where output order is imposed later by
    the Db's own value-order sort.

    Equality pitfalls handled: 1 == 1.0 == True in Python but Int(1),
    Float(1.0), Bool(true) are distinct values (type tag in the key);
    -0.0 == 0.0 (sign special-cased); NaN != NaN (canonicalized)."""
    t = type(v)
    if t is int:
        return v  # plain ints dominate keys; bare int is its own tag
    if t is float:
        if v != v:
            # NaNs with distinct payloads are distinct values under
            # cmp_key (order bits); match that exactly
            return (T_NUM, 2, float_order_bits(v))
        if v == 0.0 and _F64.pack(v)[0] & 0x80:
            return _NEGZERO_KEY
        return (T_NUM, 1, v)
    if t is str:
        return (T_STR, v)
    if t is bool:
        return (T_BOOL, v)
    if v is None:
        return (T_NULL,)
    if t is bytes:
        return (T_BYTES, v)
    return cmp_key(v)


def value_eq(a, b) -> bool:
    """Identity-level equality (Int 1 != Float 1.0); the `==` operator in
    expressions coerces numerics separately."""
    return cmp_key(a) == cmp_key(b)


def deep_freeze(v):
    """Normalize a parsed/user value into canonical engine form."""
    if isinstance(v, tuple):
        return [deep_freeze(e) for e in v]
    if isinstance(v, list):
        return [deep_freeze(e) for e in v]
    if isinstance(v, np.integer):
        return int(v)
    if isinstance(v, np.floating):
        return float(v)
    if isinstance(v, np.ndarray):
        # 1-D float arrays become vectors (bulk-ingest ergonomics); other
        # arrays fall through to per-element freezing as lists
        if v.ndim == 1 and v.dtype in (np.float32, np.float64):
            return Vector(v, dtype=v.dtype.type)
        return [deep_freeze(e) for e in v.tolist()]
    return v


def type_name(v) -> str:
    if v is None:
        return "Null"
    t = type(v)
    return {
        bool: "Bool",
        int: "Int",
        float: "Float",
        str: "String",
        bytes: "Bytes",
        Uuid: "Uuid",
        Regex: "Regex",
        list: "List",
        tuple: "List",
        DSet: "Set",
        Vector: "Vec",
        Json: "Json",
        Validity: "Validity",
        _BotType: "Bot",
    }.get(t, type(v).__name__)


# --- JSON interop (reference `data/json.rs`) --------------------------------


def to_json(v):
    """Convert a value to a JSON-serializable object for output rows."""
    if v is None or isinstance(v, (bool, int, str)):
        return v
    if isinstance(v, float):
        if math.isnan(v):
            return None
        if math.isinf(v):
            return "NEGATIVE_INFINITY" if v < 0 else "INFINITY"
        return v
    if isinstance(v, bytes):
        import base64

        return base64.standard_b64encode(v).decode("ascii")
    if isinstance(v, (list, tuple)):
        return [to_json(e) for e in v]
    if isinstance(v, DSet):
        return [to_json(e) for e in v.items]
    if isinstance(v, Uuid):
        return str(v.u)
    if isinstance(v, Regex):
        return v.source
    if isinstance(v, Vector):
        return [float(x) for x in v.a]
    if isinstance(v, Validity):
        return [v.ts, v.is_assert]
    if isinstance(v, Json):
        return {"json": v.v} if False else v.v
    if isinstance(v, _BotType):
        raise ValueError("found bottom value in output")
    if isinstance(v, np.integer):
        return int(v)
    if isinstance(v, np.floating):
        return to_json(float(v))
    raise TypeError(f"cannot jsonify {v!r}")


def from_json(j):
    """Convert a JSON object to a value (objects become Json documents,
    arrays become Lists — reference `data/json.rs:17-33`)."""
    if j is None or isinstance(j, (bool, str)):
        return j
    if isinstance(j, int):
        return coerce_int(j)
    if isinstance(j, float):
        return j
    if isinstance(j, list):
        return [from_json(e) for e in j]
    if isinstance(j, dict):
        return Json(j)
    raise TypeError(f"cannot convert from json: {j!r}")
