"""Builtin scalar functions — the full ~139-op surface of the reference
(`cozo-core/src/data/functions.rs`, names listed in SURVEY.md §A.1).

Each op is registered with (fn, min_arity, vararg, deterministic).
Semantics match the reference, including its quirks:

- `add`/`mul` varargs stay Int if the float accumulator is exactly 0/1
- `l2_dist` returns the SQUARED euclidean distance
- `mod` is truncated (Rust `Rem`), not floored
- comparisons (`<` etc.) require same-type operands; `==` coerces numerics
- `floor`/`ceil`/`round` preserve Int inputs
"""

from __future__ import annotations

import base64 as _b64
import json as _json
import math
import random
import re as _re
import time as _time
import unicodedata
import uuid as _uuid
from datetime import datetime, timezone
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from ..utils.errors import EvalError
from .value import (
    BOT,
    DSet,
    Json,
    Regex,
    Uuid,
    Validity,
    Vector,
    _BotType,
    cmp_key,
    coerce_int,
    to_json,
    value_eq,
)

MAX_VALIDITY_TS = (1 << 63) - 1


def _is_num(v) -> bool:
    return (isinstance(v, int) or isinstance(v, float)) and not isinstance(v, bool)


def _get_float(v) -> Optional[float]:
    if _is_num(v):
        return float(v)
    return None


def _get_int(v) -> Optional[int]:
    if isinstance(v, int) and not isinstance(v, bool):
        return v
    return None


def _get_slice(v) -> Optional[list]:
    if isinstance(v, list):
        return v
    if isinstance(v, DSet):
        return list(v.items)
    return None


def _req_num(v, name):
    if not _is_num(v):
        raise EvalError(f"'{name}' requires numbers")
    return v


def _unary_float_math(name, fn):
    def op(args):
        v = args[0]
        if isinstance(v, Vector):
            return Vector(fn(v.a.astype(v.a.dtype)), dtype=v.a.dtype)
        return float(fn(float(_req_num(v, name))))

    op.__name__ = f"op_{name}"
    return op


# --- json helpers ------------------------------------------------------------


def _val2str(v) -> str:
    if isinstance(v, str):
        return v
    if isinstance(v, Json) and isinstance(v.v, str):
        return v.v
    return _json.dumps(to_json(v), separators=(",", ":"), ensure_ascii=False)


def _json2val(j):
    """Unwrap a json scalar; arrays/objects stay Json (functions.rs json2val)."""
    if j is None or isinstance(j, (bool, str)):
        return j
    if isinstance(j, int):
        return j
    if isinstance(j, float):
        return j
    return Json(j)


def _nav_json_path(doc, path, create=False):
    ptr = doc
    for key in path:
        if isinstance(ptr, dict):
            k = _val2str(key)
            if k not in ptr:
                if not create:
                    raise EvalError("json path does not exist")
                ptr[k] = {}
            ptr = ptr[k]
        elif isinstance(ptr, list):
            i = _get_int(key)
            if i is None:
                raise EvalError("json path must be a string or a number")
            if create and len(ptr) <= i:
                ptr.extend([None] * (i + 1 - len(ptr)))
            if i >= len(ptr):
                raise EvalError("json path does not exist")
            ptr = ptr[i]
        else:
            raise EvalError("json path does not exist")
    return ptr


def _deep_merge_json(a, b):
    if isinstance(a, dict) and isinstance(b, dict):
        out = dict(a)
        for k, v in b.items():
            out[k] = _deep_merge_json(out.get(k), v)
        return out
    if isinstance(a, list) and isinstance(b, list):
        return a + b
    return b


# --- core ops ----------------------------------------------------------------


def op_coalesce(args):
    for v in args:
        if v is not None:
            return v
    return None


def op_eq(args):
    a, b = args
    if _is_num(a) and _is_num(b):
        return float(a) == float(b)
    return value_eq(a, b)


def op_neq(args):
    return not op_eq(args)


_SAME_TYPE_GROUPS = [
    (type(None),),
    (bool,),
    (int, float),
    (str,),
    (bytes,),
    (Regex,),
    (list, DSet),
    (_BotType,),
]


def _ensure_same_value_type(a, b, name):
    def group(v):
        if isinstance(v, bool):
            return 1
        for i, g in enumerate(_SAME_TYPE_GROUPS):
            if isinstance(v, g):
                return i
        return None

    ga, gb = group(a), group(b)
    if ga is None or gb is None or ga != gb:
        raise EvalError(
            f"comparison can only be done between the same datatypes, "
            f"got {a!r} and {b!r}"
        )


def _cmp(a, b) -> int:
    if _is_num(a) and _is_num(b):
        fa, fb = float(a), float(b)
        if fa < fb:
            return -1
        if fa > fb:
            return 1
        return 0
    ka, kb = cmp_key(a), cmp_key(b)
    if ka < kb:
        return -1
    if ka > kb:
        return 1
    return 0


def op_gt(args):
    _ensure_same_value_type(args[0], args[1], "gt")
    return _cmp(args[0], args[1]) > 0


def op_ge(args):
    _ensure_same_value_type(args[0], args[1], "ge")
    return _cmp(args[0], args[1]) >= 0


def op_lt(args):
    _ensure_same_value_type(args[0], args[1], "lt")
    return _cmp(args[0], args[1]) < 0


def op_le(args):
    _ensure_same_value_type(args[0], args[1], "le")
    return _cmp(args[0], args[1]) <= 0


def _vec_dtype_promote(a: Vector, b: Vector):
    if a.a.dtype == np.float32 and b.a.dtype == np.float32:
        return np.float32
    return np.float64


def _binary_vec(a, b, fn, name):
    if isinstance(a, Vector) and isinstance(b, Vector):
        if len(a) != len(b):
            raise EvalError(f"can only {name} vectors of the same length")
        dt = _vec_dtype_promote(a, b)
        return Vector(fn(a.a.astype(dt), b.a.astype(dt)), dtype=dt)
    if isinstance(a, Vector):
        f = _get_float(b)
        if f is None:
            raise EvalError(f"can only {name} numbers and vectors")
        return Vector(fn(a.a, np.asarray(f, dtype=a.a.dtype)), dtype=a.a.dtype)
    if isinstance(b, Vector):
        f = _get_float(a)
        if f is None:
            raise EvalError(f"can only {name} numbers and vectors")
        return Vector(fn(np.asarray(f, dtype=b.a.dtype), b.a), dtype=b.a.dtype)
    raise EvalError(f"'{name}' requires numbers")


def op_add(args):
    if any(isinstance(a, Vector) for a in args):
        acc = args[0]
        for b in args[1:]:
            acc = _binary_vec(acc, b, lambda x, y: x + y, "add")
        return acc
    i_acc, f_acc = 0, 0.0
    for a in args:
        if isinstance(a, bool) or not isinstance(a, (int, float)):
            raise EvalError("addition requires numbers")
        if isinstance(a, int):
            i_acc += a
        else:
            f_acc += a
    # reference quirk (functions.rs op_add): all-int iff float accum == 0.0
    if f_acc == 0.0:
        return coerce_int(i_acc)
    return i_acc + f_acc


def op_mul(args):
    if any(isinstance(a, Vector) for a in args):
        acc = args[0]
        for b in args[1:]:
            acc = _binary_vec(acc, b, lambda x, y: x * y, "mul")
        return acc
    i_acc, f_acc = 1, 1.0
    for a in args:
        if isinstance(a, bool) or not isinstance(a, (int, float)):
            raise EvalError("multiplication requires numbers")
        if isinstance(a, int):
            i_acc *= a
        else:
            f_acc *= a
    if f_acc == 1.0:
        return coerce_int(i_acc)
    return i_acc * f_acc


def op_sub(args):
    a, b = args
    if isinstance(a, Vector) or isinstance(b, Vector):
        return _binary_vec(a, b, lambda x, y: x - y, "subtract")
    if not (_is_num(a) and _is_num(b)):
        raise EvalError("subtraction requires numbers")
    if isinstance(a, int) and isinstance(b, int):
        return coerce_int(a - b)
    return float(a) - float(b)


def op_div(args):
    a, b = args
    if isinstance(a, Vector) or isinstance(b, Vector):
        return _binary_vec(a, b, lambda x, y: x / y, "divide")
    if not (_is_num(a) and _is_num(b)):
        raise EvalError("division requires numbers")
    fa, fb = float(a), float(b)
    if fb == 0.0:
        if fa == 0.0:
            return float("nan")
        return math.copysign(float("inf"), fa) * math.copysign(1.0, fb)
    return fa / fb


def op_minus(args):
    v = args[0]
    if isinstance(v, Vector):
        return Vector(-v.a, dtype=v.a.dtype)
    if isinstance(v, int) and not isinstance(v, bool):
        return coerce_int(-v)
    if isinstance(v, float):
        return -v
    raise EvalError("minus can only be applied to numbers")


def op_abs(args):
    v = args[0]
    if isinstance(v, Vector):
        return Vector(np.abs(v.a), dtype=v.a.dtype)
    if isinstance(v, int) and not isinstance(v, bool):
        return coerce_int(abs(v))
    if isinstance(v, float):
        return abs(v)
    raise EvalError("'abs' requires numbers")


def op_signum(args):
    v = args[0]
    if isinstance(v, int) and not isinstance(v, bool):
        return (v > 0) - (v < 0)
    if isinstance(v, float):
        # Rust f64::signum (reference delegates to it): sign-bit based, so
        # -0.0 → -1.0, +0.0 → 1.0, NaN → NaN; always a Float for Float input.
        if math.isnan(v):
            return float("nan")
        return math.copysign(1.0, v)
    raise EvalError("'signum' requires numbers")


def op_floor(args):
    v = args[0]
    if isinstance(v, int) and not isinstance(v, bool):
        return v
    if isinstance(v, float):
        return math.floor(v) * 1.0 if math.isfinite(v) else v
    raise EvalError("'floor' requires numbers")


def op_ceil(args):
    v = args[0]
    if isinstance(v, int) and not isinstance(v, bool):
        return v
    if isinstance(v, float):
        return math.ceil(v) * 1.0 if math.isfinite(v) else v
    raise EvalError("'ceil' requires numbers")


def op_round(args):
    v = args[0]
    if isinstance(v, int) and not isinstance(v, bool):
        return v
    if isinstance(v, float):
        if not math.isfinite(v):
            return v
        # Rust f64::round: half away from zero
        return math.floor(v + 0.5) * 1.0 if v >= 0 else math.ceil(v - 0.5) * 1.0
    raise EvalError("'round' requires numbers")


def op_pow(args):
    a, b = args
    if isinstance(a, Vector):
        f = _get_float(b)
        if f is None:
            raise EvalError("'pow' requires numbers")
        return Vector(np.power(a.a, np.asarray(f, dtype=a.a.dtype)), dtype=a.a.dtype)
    if not (_is_num(a) and _is_num(b)):
        raise EvalError("'pow' requires numbers")
    return float(a) ** float(b) if not _pow_domain_err(a, b) else _pow_nan()


def _pow_domain_err(a, b):
    try:
        float(a) ** float(b)
        return False
    except (OverflowError, ValueError):
        return True


def _pow_nan():
    return float("nan")


def op_mod(args):
    a, b = args
    if not (_is_num(a) and _is_num(b)):
        raise EvalError("'mod' requires numbers")
    if isinstance(a, int) and isinstance(b, int):
        if b == 0:
            raise EvalError("'mod' requires non-zero divisor")
        return math.fmod(a, b).__trunc__()  # truncated remainder (Rust Rem)
    return math.fmod(float(a), float(b))


def op_max(args):
    best = None
    for a in args:
        if not _is_num(a):
            raise EvalError("'max' can only be applied to numbers")
        if best is None or _cmp(a, best) > 0:
            best = a
    return best if best is not None else float("-inf")


def op_min(args):
    best = None
    for a in args:
        if not _is_num(a):
            raise EvalError("'min' can only be applied to numbers")
        if best is None or _cmp(a, best) < 0:
            best = a
    return best if best is not None else float("inf")


def op_and(args):
    for a in args:
        if not isinstance(a, bool):
            raise EvalError("'and' requires booleans")
        if not a:
            return False
    return True


def op_or(args):
    for a in args:
        if not isinstance(a, bool):
            raise EvalError("'or' requires booleans")
        if a:
            return True
    return False


def op_negate(args):
    if isinstance(args[0], bool):
        return not args[0]
    raise EvalError("'negate' requires booleans")


# --- bit ops on bytes --------------------------------------------------------


def _bit_binop(args, fn, name):
    a, b = args
    if not (isinstance(a, bytes) and isinstance(b, bytes)):
        raise EvalError(f"'{name}' requires bytes")
    if len(a) != len(b):
        raise EvalError(f"operands of '{name}' must have the same lengths")
    return bytes(fn(x, y) for x, y in zip(a, b))


def op_bit_and(args):
    return _bit_binop(args, lambda x, y: x & y, "bit_and")


def op_bit_or(args):
    return _bit_binop(args, lambda x, y: x | y, "bit_or")


def op_bit_xor(args):
    return _bit_binop(args, lambda x, y: x ^ y, "bit_xor")


def op_bit_not(args):
    if not isinstance(args[0], bytes):
        raise EvalError("'bit_not' requires bytes")
    return bytes((~x) & 0xFF for x in args[0])


def op_unpack_bits(args):
    if not isinstance(args[0], bytes):
        raise EvalError("'unpack_bits' requires bytes")
    out = []
    for byte in args[0]:
        for i in range(7, -1, -1):
            out.append(bool((byte >> i) & 1))
    return out


def op_pack_bits(args):
    v = _get_slice(args[0])
    if v is None:
        raise EvalError("'pack_bits' requires list of booleans")
    nbytes = (len(v) + 7) // 8
    res = bytearray(nbytes)
    for i, b in enumerate(v):
        if not isinstance(b, bool):
            raise EvalError("'pack_bits' requires list of booleans")
        if b:
            res[i // 8] |= 1 << (7 - i % 8)
    return bytes(res)


# --- strings -----------------------------------------------------------------


def op_concat(args):
    first = args[0]
    if isinstance(first, str):
        out = []
        for a in args:
            if not isinstance(a, str):
                raise EvalError("'concat' requires strings, or lists")
            out.append(a)
        return "".join(out)
    if isinstance(first, (list, DSet)):
        out = []
        for a in args:
            s = _get_slice(a)
            if s is None:
                raise EvalError("'concat' requires strings, or lists")
            out.extend(s)
        return out
    if isinstance(first, Json):
        acc = None
        for a in args:
            if not isinstance(a, Json):
                raise EvalError("'concat' requires strings, lists, or JSON objects")
            acc = _deep_merge_json(acc, a.v)
        return Json(acc)
    raise EvalError("'concat' requires strings, lists, or JSON objects")


def op_str_includes(args):
    a, b = args
    if isinstance(a, str) and isinstance(b, str):
        return b in a
    raise EvalError("'str_includes' requires strings")


def _str_op(name, fn):
    def op(args):
        if not isinstance(args[0], str):
            raise EvalError(f"'{name}' requires strings")
        return fn(args[0])

    op.__name__ = f"op_{name}"
    return op


op_lowercase = _str_op("lowercase", str.lower)
op_uppercase = _str_op("uppercase", str.upper)
op_trim = _str_op("trim", str.strip)
op_trim_start = _str_op("trim_start", str.lstrip)
op_trim_end = _str_op("trim_end", str.rstrip)


def op_starts_with(args):
    a, b = args
    if isinstance(a, str) and isinstance(b, str):
        return a.startswith(b)
    if isinstance(a, bytes) and isinstance(b, bytes):
        return a.startswith(b)
    raise EvalError("'starts_with' requires strings or bytes")


def op_ends_with(args):
    a, b = args
    if isinstance(a, str) and isinstance(b, str):
        return a.endswith(b)
    if isinstance(a, bytes) and isinstance(b, bytes):
        return a.endswith(b)
    raise EvalError("'ends_with' requires strings or bytes")


def op_unicode_normalize(args):
    s, n = args
    if not (isinstance(s, str) and isinstance(n, str)):
        raise EvalError("'unicode_normalize' requires strings")
    forms = {"nfc": "NFC", "nfd": "NFD", "nfkc": "NFKC", "nfkd": "NFKD"}
    if n not in forms:
        raise EvalError(f"unknown normalization {n} for 'unicode_normalize'")
    return unicodedata.normalize(forms[n], s)


def op_chars(args):
    if not isinstance(args[0], str):
        raise EvalError("'chars' requires strings")
    return list(args[0])


def op_slice_string(args):
    s, m, n = args
    if not isinstance(s, str):
        raise EvalError("first argument to 'slice_string' must be a string")
    mi, ni = _get_int(m), _get_int(n)
    if mi is None or mi < 0:
        raise EvalError("second argument to 'slice_string' must be a positive integer")
    if ni is None or ni < mi:
        raise EvalError(
            "third argument to 'slice_string' must be >= the second argument"
        )
    return s[mi:ni]


def op_from_substrings(args):
    ss = _get_slice(args[0])
    if ss is None:
        raise EvalError("'from_substrings' requires a list of strings")
    out = []
    for s in ss:
        if not isinstance(s, str):
            raise EvalError("'from_substrings' requires a list of strings")
        out.append(s)
    return "".join(out)


def op_encode_base64(args):
    if not isinstance(args[0], bytes):
        raise EvalError("'encode_base64' requires bytes")
    return _b64.standard_b64encode(args[0]).decode("ascii")


def op_decode_base64(args):
    if not isinstance(args[0], str):
        raise EvalError("'decode_base64' requires strings")
    try:
        return _b64.standard_b64decode(args[0])
    except Exception:
        raise EvalError("Data is not properly encoded")


def op_t2s(args):
    # Traditional → Simplified Chinese; the reference vendors fast2s. We keep
    # the function (identity fallback) so scripts don't break; a conversion
    # table can be dropped in later.
    return args[0]


# --- regex -------------------------------------------------------------------


def op_regex(args):
    v = args[0]
    if isinstance(v, Regex):
        return v
    if isinstance(v, str):
        try:
            return Regex(v)
        except _re.error as e:
            raise EvalError(f"The string cannot be interpreted as regex: {e}")
    raise EvalError("'regex' requires strings")


def _rust_replacement_to_py(rp: str) -> str:
    # Rust regex replacement: $1, ${name}; Python: \1, \g<name>
    out = _re.sub(r"\$\{(\w+)\}", r"\\g<\1>", rp)
    out = _re.sub(r"\$(\w+)", r"\\g<\1>", out)
    return out


def op_regex_matches(args):
    s, r = args
    if isinstance(s, str) and isinstance(r, Regex):
        return r.compiled.search(s) is not None
    raise EvalError("'regex_matches' requires strings")


def op_regex_replace(args):
    s, r, rp = args
    if isinstance(s, str) and isinstance(r, Regex) and isinstance(rp, str):
        return r.compiled.sub(_rust_replacement_to_py(rp), s, count=1)
    raise EvalError("'regex_replace' requires strings")


def op_regex_replace_all(args):
    s, r, rp = args
    if isinstance(s, str) and isinstance(r, Regex) and isinstance(rp, str):
        return r.compiled.sub(_rust_replacement_to_py(rp), s)
    raise EvalError("'regex_replace_all' requires strings")


def op_regex_extract(args):
    s, r = args
    if isinstance(s, str) and isinstance(r, Regex):
        return [m.group(0) for m in r.compiled.finditer(s)]
    raise EvalError("'regex_extract' requires strings")


def op_regex_extract_first(args):
    s, r = args
    if isinstance(s, str) and isinstance(r, Regex):
        m = r.compiled.search(s)
        return m.group(0) if m else None
    raise EvalError("'regex_extract_first' requires strings")


# --- predicates --------------------------------------------------------------


def op_is_null(args):
    return args[0] is None


def op_is_int(args):
    return isinstance(args[0], int) and not isinstance(args[0], bool)


def op_is_float(args):
    return isinstance(args[0], float)


def op_is_num(args):
    return _is_num(args[0])


def op_is_finite(args):
    v = args[0]
    if isinstance(v, bool):
        return False
    if isinstance(v, int):
        return True
    if isinstance(v, float):
        return math.isfinite(v)
    return False


def op_is_infinite(args):
    return isinstance(args[0], float) and math.isinf(args[0])


def op_is_nan(args):
    return isinstance(args[0], float) and math.isnan(args[0])


def op_is_string(args):
    return isinstance(args[0], str)


def op_is_list(args):
    return isinstance(args[0], (list, DSet))


def op_is_bytes(args):
    return isinstance(args[0], bytes)


def op_is_uuid(args):
    return isinstance(args[0], Uuid)


def op_is_vec(args):
    return isinstance(args[0], Vector)


def op_is_json(args):
    return isinstance(args[0], Json)


def op_is_in(args):
    l, r = args
    rs = _get_slice(r)
    if rs is None:
        raise EvalError("right hand side of 'is_in' must be a list")
    lk = cmp_key(l)
    return any(cmp_key(e) == lk for e in rs)


# --- lists -------------------------------------------------------------------


def op_list(args):
    return list(args)


def op_append(args):
    l = _get_slice(args[0])
    if l is None:
        raise EvalError("'append' requires first argument to be a list")
    return l + [args[1]]


def op_prepend(args):
    l = _get_slice(args[0])
    if l is None:
        raise EvalError("'prepend' requires first argument to be a list")
    return [args[1]] + l


def op_length(args):
    v = args[0]
    if isinstance(v, (list, DSet)):
        return len(v)
    if isinstance(v, str):
        return len(v)
    if isinstance(v, bytes):
        return len(v)
    if isinstance(v, Vector):
        return len(v)
    raise EvalError("'length' requires lists")


def op_sorted(args):
    l = _get_slice(args[0])
    if l is None:
        raise EvalError("'sorted' requires lists")
    return sorted(l, key=cmp_key)


def op_reverse(args):
    l = _get_slice(args[0])
    if l is None:
        raise EvalError("'reverse' requires lists")
    return list(reversed(l))


def op_first(args):
    l = _get_slice(args[0])
    if l is None:
        raise EvalError("'first' requires lists")
    return l[0] if l else None


def op_last(args):
    l = _get_slice(args[0])
    if l is None:
        raise EvalError("'last' requires lists")
    return l[-1] if l else None


def _chunk_arg(args, name):
    l = _get_slice(args[0])
    if l is None:
        raise EvalError(f"first argument of '{name}' must be a list")
    n = _get_int(args[1])
    if n is None:
        raise EvalError(f"second argument of '{name}' must be an integer")
    if n <= 0:
        raise EvalError(f"second argument to '{name}' must be positive")
    return l, n


def op_chunks(args):
    l, n = _chunk_arg(args, "chunks")
    return [l[i : i + n] for i in range(0, len(l), n)]


def op_chunks_exact(args):
    l, n = _chunk_arg(args, "chunks_exact")
    return [l[i : i + n] for i in range(0, len(l) - n + 1, n)]


def op_windows(args):
    l, n = _chunk_arg(args, "windows")
    return [l[i : i + n] for i in range(0, len(l) - n + 1)]


def _get_index(i: int, total: int, is_upper: bool) -> int:
    if i < 0:
        i += total
    if i < 0 or i > total or (not is_upper and i == total):
        raise EvalError(f"index {i} out of bound")
    return i


def _get_impl(args):
    v = args[0]
    if isinstance(v, (list, DSet)):
        l = _get_slice(v)
        n = _get_int(args[1])
        if n is None:
            raise EvalError("second argument to 'get' must be an integer")
        return l[_get_index(n, len(l), False)]
    if isinstance(v, Json):
        key = args[1]
        doc = v.v
        if isinstance(key, str):
            if not isinstance(doc, dict) or key not in doc:
                raise EvalError(f"key '{key}' not found in json")
            return _json2val(doc[key])
        ki = _get_int(key)
        if ki is not None:
            if not isinstance(doc, list) or ki >= len(doc) or ki < 0:
                raise EvalError(f"index '{key}' not found in json")
            return _json2val(doc[ki])
        if isinstance(key, list):
            return _json2val(_nav_json_path(doc, key, create=False))
        raise EvalError("second argument to 'get' must be a string or integer")
    raise EvalError("first argument to 'get' must be a list or json")


def op_get(args):
    try:
        return _get_impl(args)
    except EvalError:
        if len(args) > 2:
            return args[2]
        raise


def op_maybe_get(args):
    try:
        return _get_impl(args)
    except EvalError:
        return None


def op_slice(args):
    l = _get_slice(args[0])
    if l is None:
        raise EvalError("first argument to 'slice' must be a list")
    m = _get_int(args[1])
    n = _get_int(args[2])
    if m is None or n is None:
        raise EvalError("'slice' requires integer indices")
    return l[_get_index(m, len(l), False) : _get_index(n, len(l), True)]


def op_union(args):
    seen = {}
    for a in args:
        s = _get_slice(a)
        if s is None:
            raise EvalError("'union' requires lists")
        for e in s:
            seen[cmp_key(e)] = e
    return [v for _, v in sorted(seen.items())]


def op_intersection(args):
    s0 = _get_slice(args[0])
    if s0 is None:
        raise EvalError("'intersection' requires lists")
    acc = {cmp_key(e): e for e in s0}
    for a in args[1:]:
        s = _get_slice(a)
        if s is None:
            raise EvalError("'intersection' requires lists")
        keys = {cmp_key(e) for e in s}
        acc = {k: v for k, v in acc.items() if k in keys}
    return [v for _, v in sorted(acc.items())]


def op_difference(args):
    s0 = _get_slice(args[0])
    if s0 is None:
        raise EvalError("'difference' requires lists")
    acc = {cmp_key(e): e for e in s0}
    for a in args[1:]:
        s = _get_slice(a)
        if s is None:
            raise EvalError("'difference' requires lists")
        for e in s:
            acc.pop(cmp_key(e), None)
    return [v for _, v in sorted(acc.items())]


# --- geo ---------------------------------------------------------------------


def _haversine(lat1, lon1, lat2, lon2):
    return 2.0 * math.asin(
        math.sqrt(
            math.sin((lat1 - lat2) / 2.0) ** 2
            + math.cos(lat1) * math.cos(lat2) * math.sin((lon1 - lon2) / 2.0) ** 2
        )
    )


def op_haversine(args):
    vals = [_get_float(a) for a in args]
    if any(v is None for v in vals):
        raise EvalError("'haversine' requires numbers")
    return _haversine(*vals)


def op_haversine_deg_input(args):
    vals = [_get_float(a) for a in args]
    if any(v is None for v in vals):
        raise EvalError("'haversine_deg_input' requires numbers")
    return _haversine(*(v * math.pi / 180.0 for v in vals))


def op_deg_to_rad(args):
    f = _get_float(args[0])
    if f is None:
        raise EvalError("'deg_to_rad' requires numbers")
    return f * math.pi / 180.0


def op_rad_to_deg(args):
    f = _get_float(args[0])
    if f is None:
        raise EvalError("'rad_to_deg' requires numbers")
    return f * 180.0 / math.pi


# --- coercions ---------------------------------------------------------------


def op_to_bool(args):
    v = args[0]
    if v is None:
        return False
    if isinstance(v, bool):
        return v
    if isinstance(v, int):
        return v != 0
    if isinstance(v, float):
        return True  # reference: n.get_int() != Some(0); floats have no int
    if isinstance(v, str):
        return len(v) > 0
    if isinstance(v, bytes):
        return len(v) > 0
    if isinstance(v, Uuid):
        return v.u.int != 0
    if isinstance(v, Regex):
        return len(v.source) > 0
    if isinstance(v, (list, DSet)):
        return len(v) > 0
    if isinstance(v, Vector):
        return True
    if isinstance(v, Validity):
        return v.is_assert
    if isinstance(v, _BotType):
        return False
    if isinstance(v, Json):
        j = v.v
        if j is None:
            return False
        if isinstance(j, bool):
            return j
        if isinstance(j, int):
            return j != 0
        if isinstance(j, float):
            return True
        if isinstance(j, (str, list, dict)):
            return len(j) > 0
    raise EvalError(f"cannot convert {v!r} to bool")


def op_to_unity(args):
    v = args[0]
    if _is_num(v):
        return int(float(v) != 0.0)
    return 1 if op_to_bool(args) else 0


def op_to_int(args):
    v = args[0]
    if isinstance(v, bool):
        return 1 if v else 0
    if isinstance(v, int):
        return v
    if isinstance(v, float):
        if math.isnan(v) or math.isinf(v):
            raise EvalError("cannot convert non-finite float to int")
        return math.trunc(v)
    if v is None:
        return 0
    if isinstance(v, str):
        try:
            return coerce_int(int(v))
        except ValueError:
            raise EvalError("The string cannot be interpreted as int")
    if isinstance(v, Validity):
        return v.ts
    raise EvalError(f"'to_int' does not recognize {v!r}")


_FLOAT_NAMES = {
    "PI": math.pi,
    "E": math.e,
    "NAN": float("nan"),
    "INF": float("inf"),
    "NEG_INF": float("-inf"),
}


def op_to_float(args):
    v = args[0]
    if isinstance(v, bool):
        return 1.0 if v else 0.0
    if _is_num(v):
        return float(v)
    if v is None:
        return 0.0
    if isinstance(v, str):
        if v in _FLOAT_NAMES:
            return _FLOAT_NAMES[v]
        try:
            return float(v)
        except ValueError:
            raise EvalError("The string cannot be interpreted as float")
    raise EvalError(f"'to_float' does not recognize {v!r}")


def op_to_string(args):
    return _val2str(args[0])


def op_to_uuid(args):
    v = args[0]
    if isinstance(v, Uuid):
        return v
    if isinstance(v, str):
        try:
            return Uuid(v)
        except ValueError:
            raise EvalError("invalid UUID")
    raise EvalError("'to_uuid' requires a string")


# --- json ops ----------------------------------------------------------------


def op_json(args):
    return Json(to_json(args[0]))


def op_parse_json(args):
    if not isinstance(args[0], str):
        raise EvalError("parse_json requires a string argument")
    try:
        return Json(_json.loads(args[0]))
    except _json.JSONDecodeError as e:
        raise EvalError(f"invalid json: {e}")


def op_dump_json(args):
    if not isinstance(args[0], Json):
        raise EvalError("dump_json requires a json argument")
    return _json.dumps(args[0].v, separators=(",", ":"), ensure_ascii=False)


def op_json_object(args):
    if len(args) % 2 != 0:
        raise EvalError("json_object requires an even number of arguments")
    obj = {}
    for i in range(0, len(args), 2):
        obj[_val2str(args[i])] = to_json(args[i + 1])
    return Json(obj)


def op_json_to_scalar(args):
    v = args[0]
    if isinstance(v, Json):
        return _json2val(v.v)
    return v


def op_set_json_path(args):
    doc = to_json(args[0])
    path = _get_slice(args[1])
    if path is None:
        raise EvalError("json path must be a list")
    if not path:
        return Json(to_json(args[2]))
    parent = _nav_json_path(doc, path[:-1], create=True)
    last = path[-1]
    if isinstance(parent, dict):
        parent[_val2str(last)] = to_json(args[2])
    elif isinstance(parent, list):
        i = _get_int(last)
        if i is None:
            raise EvalError("json path must be a string or a number")
        if len(parent) <= i:
            parent.extend([None] * (i + 1 - len(parent)))
        parent[i] = to_json(args[2])
    else:
        raise EvalError("json path does not exist")
    return Json(doc)


def op_remove_json_path(args):
    doc = to_json(args[0])
    path = _get_slice(args[1])
    if not path:
        raise EvalError("json path must not be empty")
    parent = _nav_json_path(doc, path[:-1], create=True)
    last = path[-1]
    if isinstance(parent, dict):
        parent.pop(_val2str(last), None)
    elif isinstance(parent, list):
        i = _get_int(last)
        if i is None:
            raise EvalError("json path must be a string or a number")
        del parent[i]
    else:
        raise EvalError("json path does not exist")
    return Json(doc)


# --- vectors -----------------------------------------------------------------


def _vec_eltype(args, idx=1):
    if len(args) > idx:
        s = args[idx]
        if not isinstance(s, str):
            raise EvalError("'vec' requires a string as second argument")
        if s in ("F32", "Float"):
            return np.float32
        if s in ("F64", "Double"):
            return np.float64
        raise EvalError(f"'vec' does not recognize type {s}")
    return np.float32


def op_vec(args):
    dt = _vec_eltype(args)
    v = args[0]
    if isinstance(v, Json):
        if not isinstance(v.v, list):
            raise EvalError("'vec' requires a list of numbers")
        try:
            return Vector(np.asarray([float(x) for x in v.v], dtype=dt), dtype=dt)
        except (TypeError, ValueError):
            raise EvalError("'vec' requires a list of numbers")
    if isinstance(v, (list, DSet)):
        vals = []
        for e in _get_slice(v):
            f = _get_float(e)
            if f is None:
                raise EvalError("'vec' requires a list of numbers")
            vals.append(f)
        return Vector(np.asarray(vals, dtype=dt), dtype=dt)
    if isinstance(v, Vector):
        return Vector(v.a.astype(dt), dtype=dt)
    if isinstance(v, str):
        try:
            raw = _b64.standard_b64decode(v)
        except Exception:
            raise EvalError("Data is not base64 encoded")
        return Vector(np.frombuffer(raw, dtype=dt).copy(), dtype=dt)
    raise EvalError("'vec' requires a list or a vector")


def op_rand_vec(args):
    n = _get_int(args[0])
    if n is None:
        raise EvalError("'rand_vec' requires an integer")
    dt = _vec_eltype(args)
    return Vector(np.random.random(n).astype(dt), dtype=dt)


def op_l2_normalize(args):
    v = args[0]
    if not isinstance(v, Vector):
        raise EvalError("'l2_normalize' requires a vector")
    norm = math.sqrt(float(v.a.dot(v.a)))
    return Vector(v.a / np.asarray(norm, dtype=v.a.dtype), dtype=v.a.dtype)


def _two_vecs(args, name):
    a, b = args
    if not (isinstance(a, Vector) and isinstance(b, Vector)):
        raise EvalError(f"'{name}' requires two vectors of the same type")
    if a.a.dtype != b.a.dtype:
        raise EvalError(f"'{name}' requires two vectors of the same type")
    if len(a) != len(b):
        raise EvalError(f"'{name}' requires two vectors of the same length")
    return a.a, b.a


def op_l2_dist(args):
    a, b = _two_vecs(args, "l2_dist")
    d = a - b
    return float(d.dot(d))  # squared L2, as in the reference


def op_ip_dist(args):
    a, b = _two_vecs(args, "ip_dist")
    return 1.0 - float(a.dot(b))


def op_cos_dist(args):
    a, b = _two_vecs(args, "cos_dist")
    na, nb = float(a.dot(a)), float(b.dot(b))
    return 1.0 - float(a.dot(b)) / math.sqrt(na * nb)


# --- ranges / random ---------------------------------------------------------


def op_int_range(args):
    ints = [_get_int(a) for a in args]
    if any(i is None for i in ints):
        raise EvalError("'int_range' requires integer arguments")
    if len(ints) == 1:
        return list(range(ints[0]))
    if len(ints) == 2:
        return list(range(ints[0], ints[1]))
    if len(ints) == 3:
        if ints[2] == 0:
            return []
        return list(range(ints[0], ints[1], ints[2]))
    raise EvalError("'int_range' requires 1 to 3 arguments")


def op_rand_float(args):
    return random.random()


def op_rand_bernoulli(args):
    f = _get_float(args[0])
    if f is None or not (0.0 <= f <= 1.0):
        raise EvalError("'rand_bernoulli' requires number between 0. and 1.")
    return random.random() < f


def op_rand_int(args):
    lo, hi = _get_int(args[0]), _get_int(args[1])
    if lo is None or hi is None:
        raise EvalError("'rand_int' requires integers")
    return random.randint(lo, hi)


def op_rand_choose(args):
    l = _get_slice(args[0])
    if l is None:
        raise EvalError("'rand_choose' requires lists")
    return random.choice(l) if l else None


def op_assert(args):
    if args[0] is True:
        return True
    raise EvalError(f"assertion failed: {args!r}")


# --- uuid / time -------------------------------------------------------------


def op_rand_uuid_v1(args):
    return Uuid(_uuid.uuid1(node=random.getrandbits(48) | (1 << 40)))


def op_rand_uuid_v4(args):
    return Uuid(_uuid.uuid4())


def op_uuid_timestamp(args):
    v = args[0]
    if not isinstance(v, Uuid):
        raise EvalError("not an UUID")
    if v.u.version != 1:
        return None
    # 100-ns ticks since 1582-10-15 → unix seconds
    ticks = v.u.time
    unix_ticks = ticks - 0x01B21DD213814000
    return unix_ticks / 1e7


def op_now(args):
    return _time.time()


def current_validity_ts() -> int:
    return int(_time.time() * 1_000_000)


def op_format_timestamp(args):
    v = args[0]
    if isinstance(v, Validity):
        millis = v.ts // 1000
    else:
        f = _get_float(v)
        if f is None:
            raise EvalError("'format_timestamp' expects a number")
        millis = int(f * 1000.0)
    dt = datetime.fromtimestamp(millis / 1000.0, tz=timezone.utc)
    if len(args) > 1:
        tz_s = args[1]
        if not isinstance(tz_s, str):
            raise EvalError("'format_timestamp' timezone specification requires a string")
        try:
            from zoneinfo import ZoneInfo

            dt = dt.astimezone(ZoneInfo(tz_s))
        except Exception:
            raise EvalError(f"bad timezone specification: {tz_s}")
    return dt.isoformat(timespec="milliseconds" if millis % 1000 else "seconds")


_RFC3339_RE = _re.compile(
    r"^(\d{4})-(\d{2})-(\d{2})[Tt ](\d{2}):(\d{2}):(\d{2})(\.\d+)?"
    r"([Zz]|[+-]\d{2}:\d{2})$"
)


def parse_rfc3339(s: str) -> float:
    m = _RFC3339_RE.match(s.strip())
    if not m:
        raise EvalError(f"bad datetime: {s}")
    iso = s.strip().replace("Z", "+00:00").replace("z", "+00:00")
    try:
        dt = datetime.fromisoformat(iso)
    except ValueError:
        raise EvalError(f"bad datetime: {s}")
    return dt.timestamp()


def op_parse_timestamp(args):
    if not isinstance(args[0], str):
        raise EvalError("'parse_timestamp' expects a string")
    return parse_rfc3339(args[0])


def str2vld(s: str) -> int:
    """RFC3339 string → validity timestamp in microseconds."""
    return int(parse_rfc3339(s) * 1_000_000)


def op_validity(args):
    ts = _get_int(args[0])
    if ts is None:
        raise EvalError("'validity' expects an integer")
    is_assert = True
    if len(args) > 1:
        if not isinstance(args[1], bool):
            raise EvalError("'validity' expects a boolean as second argument")
        is_assert = args[1]
    return Validity(ts, is_assert)


# --- registry ----------------------------------------------------------------


class Op:
    __slots__ = ("name", "fn", "min_arity", "vararg", "deterministic")

    def __init__(self, name, fn, min_arity, vararg, deterministic=True):
        self.name = name
        self.fn = fn
        self.min_arity = min_arity
        self.vararg = vararg
        self.deterministic = deterministic

    def __repr__(self):
        return f"Op({self.name})"


def _reg():
    # (name, fn, min_arity, vararg, deterministic)
    specs = [
        ("coalesce", op_coalesce, 0, True),
        ("list", op_list, 0, True),
        ("json", op_json, 1, False),
        ("set_json_path", op_set_json_path, 3, False),
        ("remove_json_path", op_remove_json_path, 2, False),
        ("parse_json", op_parse_json, 1, False),
        ("dump_json", op_dump_json, 1, False),
        ("json_object", op_json_object, 0, True),
        ("is_json", op_is_json, 1, False),
        ("json_to_scalar", op_json_to_scalar, 1, False),
        ("add", op_add, 0, True),
        ("sub", op_sub, 2, False),
        ("mul", op_mul, 0, True),
        ("div", op_div, 2, False),
        ("minus", op_minus, 1, False),
        ("abs", op_abs, 1, False),
        ("signum", op_signum, 1, False),
        ("floor", op_floor, 1, False),
        ("ceil", op_ceil, 1, False),
        ("round", op_round, 1, False),
        ("mod", op_mod, 2, False),
        ("max", op_max, 1, True),
        ("min", op_min, 1, True),
        ("pow", op_pow, 2, False),
        ("sqrt", _unary_float_math("sqrt", np.sqrt), 1, False),
        ("exp", _unary_float_math("exp", np.exp), 1, False),
        ("exp2", _unary_float_math("exp2", np.exp2), 1, False),
        ("ln", _unary_float_math("ln", np.log), 1, False),
        ("log2", _unary_float_math("log2", np.log2), 1, False),
        ("log10", _unary_float_math("log10", np.log10), 1, False),
        ("sin", _unary_float_math("sin", np.sin), 1, False),
        ("cos", _unary_float_math("cos", np.cos), 1, False),
        ("tan", _unary_float_math("tan", np.tan), 1, False),
        ("asin", _unary_float_math("asin", np.arcsin), 1, False),
        ("acos", _unary_float_math("acos", np.arccos), 1, False),
        ("atan", _unary_float_math("atan", np.arctan), 1, False),
        (
            "atan2",
            lambda args: math.atan2(
                _req_num(args[0], "atan2"), _req_num(args[1], "atan2")
            ),
            2,
            False,
        ),
        ("sinh", _unary_float_math("sinh", np.sinh), 1, False),
        ("cosh", _unary_float_math("cosh", np.cosh), 1, False),
        ("tanh", _unary_float_math("tanh", np.tanh), 1, False),
        ("asinh", _unary_float_math("asinh", np.arcsinh), 1, False),
        ("acosh", _unary_float_math("acosh", np.arccosh), 1, False),
        ("atanh", _unary_float_math("atanh", np.arctanh), 1, False),
        ("eq", op_eq, 2, False),
        ("neq", op_neq, 2, False),
        ("gt", op_gt, 2, False),
        ("ge", op_ge, 2, False),
        ("lt", op_lt, 2, False),
        ("le", op_le, 2, False),
        ("or", op_or, 0, True),
        ("and", op_and, 0, True),
        ("negate", op_negate, 1, False),
        ("bit_and", op_bit_and, 2, False),
        ("bit_or", op_bit_or, 2, False),
        ("bit_not", op_bit_not, 1, False),
        ("bit_xor", op_bit_xor, 2, False),
        ("pack_bits", op_pack_bits, 1, False),
        ("unpack_bits", op_unpack_bits, 1, False),
        ("concat", op_concat, 1, True),
        ("str_includes", op_str_includes, 2, False),
        ("lowercase", op_lowercase, 1, False),
        ("uppercase", op_uppercase, 1, False),
        ("trim", op_trim, 1, False),
        ("trim_start", op_trim_start, 1, False),
        ("trim_end", op_trim_end, 1, False),
        ("starts_with", op_starts_with, 2, False),
        ("ends_with", op_ends_with, 2, False),
        ("regex", op_regex, 1, False),
        ("regex_matches", op_regex_matches, 2, False),
        ("regex_replace", op_regex_replace, 3, False),
        ("regex_replace_all", op_regex_replace_all, 3, False),
        ("regex_extract", op_regex_extract, 2, False),
        ("regex_extract_first", op_regex_extract_first, 2, False),
        ("t2s", op_t2s, 1, False),
        ("is_null", op_is_null, 1, False),
        ("is_int", op_is_int, 1, False),
        ("is_float", op_is_float, 1, False),
        ("is_num", op_is_num, 1, False),
        ("is_string", op_is_string, 1, False),
        ("is_list", op_is_list, 1, False),
        ("is_bytes", op_is_bytes, 1, False),
        ("is_in", op_is_in, 2, False),
        ("is_finite", op_is_finite, 1, False),
        ("is_infinite", op_is_infinite, 1, False),
        ("is_nan", op_is_nan, 1, False),
        ("is_uuid", op_is_uuid, 1, False),
        ("is_vec", op_is_vec, 1, False),
        ("length", op_length, 1, False),
        ("sorted", op_sorted, 1, False),
        ("reverse", op_reverse, 1, False),
        ("append", op_append, 2, False),
        ("prepend", op_prepend, 2, False),
        ("unicode_normalize", op_unicode_normalize, 2, False),
        ("haversine", op_haversine, 4, False),
        ("haversine_deg_input", op_haversine_deg_input, 4, False),
        ("deg_to_rad", op_deg_to_rad, 1, False),
        ("rad_to_deg", op_rad_to_deg, 1, False),
        ("get", op_get, 2, True),
        ("maybe_get", op_maybe_get, 2, False),
        ("chars", op_chars, 1, False),
        ("slice_string", op_slice_string, 3, False),
        ("from_substrings", op_from_substrings, 1, False),
        ("slice", op_slice, 3, False),
        ("first", op_first, 1, False),
        ("last", op_last, 1, False),
        ("chunks", op_chunks, 2, False),
        ("chunks_exact", op_chunks_exact, 2, False),
        ("windows", op_windows, 2, False),
        ("to_int", op_to_int, 1, False),
        ("to_float", op_to_float, 1, False),
        ("to_string", op_to_string, 1, False),
        ("to_bool", op_to_bool, 1, False),
        ("to_unity", op_to_unity, 1, False),
        ("to_uuid", op_to_uuid, 1, False),
        ("l2_dist", op_l2_dist, 2, False),
        ("l2_normalize", op_l2_normalize, 1, False),
        ("ip_dist", op_ip_dist, 2, False),
        ("cos_dist", op_cos_dist, 2, False),
        ("int_range", op_int_range, 1, True),
        ("assert", op_assert, 1, True),
        ("union", op_union, 1, True),
        ("intersection", op_intersection, 1, True),
        ("difference", op_difference, 2, True),
        ("vec", op_vec, 1, True),
        ("encode_base64", op_encode_base64, 1, False),
        ("decode_base64", op_decode_base64, 1, False),
        ("validity", op_validity, 1, True),
        ("format_timestamp", op_format_timestamp, 1, True),
        ("parse_timestamp", op_parse_timestamp, 1, False),
        ("uuid_timestamp", op_uuid_timestamp, 1, False),
    ]
    nondet = [
        ("rand_float", op_rand_float, 0, False),
        ("rand_bernoulli", op_rand_bernoulli, 1, False),
        ("rand_int", op_rand_int, 2, False),
        ("rand_choose", op_rand_choose, 1, False),
        ("rand_uuid_v1", op_rand_uuid_v1, 0, False),
        ("rand_uuid_v4", op_rand_uuid_v4, 0, False),
        ("rand_vec", op_rand_vec, 1, True),
        ("now", op_now, 0, False),
    ]
    reg: Dict[str, Op] = {}
    for name, fn, ar, va in specs:
        reg[name] = Op(name, fn, ar, va, True)
    for name, fn, ar, va in nondet:
        reg[name] = Op(name, fn, ar, va, False)
    return reg


OP_REGISTRY: Dict[str, Op] = _reg()


def get_op(name: str) -> Optional[Op]:
    return OP_REGISTRY.get(name)
