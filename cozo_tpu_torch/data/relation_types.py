"""Column types and coercion (reference `cozo-core/src/data/relation.rs:84-103`)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, List, Optional

import numpy as np

from ..utils.errors import EvalError
from .value import DSet, Json, Uuid, Validity, Vector, coerce_int


@dataclass
class ColType:
    kind: str  # Any|Bool|Int|Float|String|Bytes|Uuid|Validity|Json|List|Tuple|Vec
    nullable: bool = False
    # List: eltype + optional fixed len; Tuple: eltypes; Vec: eltype F32/F64 + len
    inner: Optional["ColType"] = None
    inner_list: List["ColType"] = field(default_factory=list)
    length: Optional[int] = None
    vec_eltype: Optional[str] = None  # "F32" | "F64"

    def display(self) -> str:
        if self.kind == "List":
            s = f"[{self.inner.display()}" + (
                f";{self.length}]" if self.length is not None else "]"
            )
        elif self.kind == "Tuple":
            s = "(" + ",".join(t.display() for t in self.inner_list) + ")"
        elif self.kind == "Vec":
            s = f"<{self.vec_eltype};{self.length}>"
        else:
            s = self.kind
        return s + ("?" if self.nullable else "")


ANY_TYPE = ColType("Any", nullable=True)


def coerce_value(v: Any, t: Optional[ColType]):
    """Coerce a value to a column type, raising on mismatch."""
    if t is None or t.kind == "Any":
        if t is not None and v is None and not t.nullable:
            raise EvalError("null value for non-nullable column")
        return v
    if v is None:
        if t.nullable:
            return None
        raise EvalError(f"null value for non-nullable column of type {t.display()}")
    k = t.kind
    if k == "Bool":
        if isinstance(v, bool):
            return v
    elif k == "Int":
        if isinstance(v, bool):
            pass
        elif isinstance(v, int):
            return coerce_int(v)
        elif isinstance(v, float) and float(v).is_integer():
            return int(v)
    elif k == "Float":
        if isinstance(v, bool):
            pass
        elif isinstance(v, (int, float)):
            return float(v)
    elif k == "String":
        if isinstance(v, str):
            return v
    elif k == "Bytes":
        if isinstance(v, bytes):
            return v
        if isinstance(v, str):
            import base64

            try:
                return base64.standard_b64decode(v)
            except Exception:
                pass
    elif k == "Uuid":
        if isinstance(v, Uuid):
            return v
        if isinstance(v, str):
            try:
                return Uuid(v)
            except Exception:
                pass
    elif k == "Validity":
        if isinstance(v, Validity):
            return v
        if isinstance(v, list) and len(v) == 2:
            from .functions import str2vld

            ts, ass = v
            if isinstance(ts, str):
                if ts == "ASSERT":
                    from .functions import current_validity_ts

                    return Validity(current_validity_ts(), True)
                if ts == "RETRACT":
                    from .functions import current_validity_ts

                    return Validity(current_validity_ts(), False)
                return Validity(str2vld(ts), bool(ass))
            if isinstance(ts, int) and isinstance(ass, bool):
                return Validity(ts, ass)
        if isinstance(v, str):
            from .functions import current_validity_ts, str2vld

            if v == "ASSERT":
                return Validity(current_validity_ts(), True)
            if v == "RETRACT":
                return Validity(current_validity_ts(), False)
            return Validity(str2vld(v), True)
        if isinstance(v, int) and not isinstance(v, bool):
            return Validity(v, True)
    elif k == "Json":
        if isinstance(v, Json):
            return v
        from .value import to_json

        return Json(to_json(v))
    elif k == "List":
        if isinstance(v, (list, DSet)):
            items = list(v) if isinstance(v, DSet) else v
            if t.length is not None and len(items) != t.length:
                raise EvalError(
                    f"list length mismatch: expected {t.length}, got {len(items)}"
                )
            return [coerce_value(e, t.inner) for e in items]
    elif k == "Tuple":
        if isinstance(v, (list, DSet)):
            items = list(v) if isinstance(v, DSet) else v
            if len(items) != len(t.inner_list):
                raise EvalError(
                    f"tuple length mismatch: expected {len(t.inner_list)}, "
                    f"got {len(items)}"
                )
            return [coerce_value(e, it) for e, it in zip(items, t.inner_list)]
    elif k == "Vec":
        dt = np.float32 if t.vec_eltype == "F32" else np.float64
        if isinstance(v, Vector):
            if len(v) != t.length:
                raise EvalError(
                    f"vector length mismatch: expected {t.length}, got {len(v)}"
                )
            return Vector(v.a.astype(dt), dtype=dt)
        if isinstance(v, np.ndarray):
            # embedding-API ergonomics: numpy params become vectors with a
            # zero-copy-ish cast (bulk ingest path; reference accepts only
            # list literals, data/relation.rs:84-103)
            if v.ndim != 1 or v.shape[0] != t.length:
                raise EvalError(
                    f"vector shape mismatch: expected ({t.length},), got {v.shape}"
                )
            return Vector(v.astype(dt, copy=False), dtype=dt)
        if isinstance(v, list):
            if len(v) != t.length:
                raise EvalError(
                    f"vector length mismatch: expected {t.length}, got {len(v)}"
                )
            try:
                return Vector(np.asarray([float(x) for x in v], dtype=dt), dtype=dt)
            except (TypeError, ValueError):
                pass
    raise EvalError(f"cannot coerce {v!r} to type {t.display()}")
