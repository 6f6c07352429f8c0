"""Aggregation operators — all 25 of the reference's
(`cozo-core/src/data/aggr.rs`).

Two flavors, as in the reference:

- *meet* aggregations (monotone semilattice ops) expose
  ``meet_init``/``meet_update`` and may appear in recursive rules —
  semi-naive evaluation merges them in place;
- *normal* aggregations expose an accumulator object with set/get and
  require stratification.

Flags follow the reference's define_aggr! declarations (note `bit_xor`
and `latest_by`/`smallest_by` are NOT meet)."""

from __future__ import annotations

import math
import random
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..utils.errors import EvalError
from .value import DSet, cmp_key, value_eq


def _get_float(v):
    if isinstance(v, bool) or not isinstance(v, (int, float)):
        raise EvalError(f"aggregation applied to non-numerical value {v!r}")
    return float(v)


# --- normal accumulator objects ------------------------------------------------


class _Acc:
    def set(self, value) -> None:
        raise NotImplementedError

    def get(self):
        raise NotImplementedError


class AccCount(_Acc):
    def __init__(self, extra):
        self.count = 0

    def set(self, value):
        self.count += 1

    def get(self):
        return self.count


class AccCountUnique(_Acc):
    def __init__(self, extra):
        self.seen = set()

    def set(self, value):
        self.seen.add(cmp_key(value))

    def get(self):
        return len(self.seen)


class AccUnique(_Acc):
    def __init__(self, extra):
        self.accum: Dict[tuple, Any] = {}

    def set(self, value):
        self.accum[cmp_key(value)] = value

    def get(self):
        return [v for _, v in sorted(self.accum.items())]


class AccGroupCount(_Acc):
    def __init__(self, extra):
        self.accum: Dict[tuple, List[Any]] = {}

    def set(self, value):
        k = cmp_key(value)
        if k in self.accum:
            self.accum[k][1] += 1
        else:
            self.accum[k] = [value, 1]

    def get(self):
        return [[v, c] for _, (v, c) in sorted(self.accum.items())]


class AccUnion(_Acc):
    def __init__(self, extra):
        self.accum: Dict[tuple, Any] = {}

    def set(self, value):
        if isinstance(value, (list, DSet)):
            for e in value:
                self.accum[cmp_key(e)] = e
        else:
            raise EvalError(f"cannot compute 'union' for value {value!r}")

    def get(self):
        return [v for _, v in sorted(self.accum.items())]


class AccIntersection(_Acc):
    def __init__(self, extra):
        self.accum: Optional[Dict[tuple, Any]] = None

    def set(self, value):
        if not isinstance(value, (list, DSet)):
            raise EvalError(f"cannot compute 'intersection' for value {value!r}")
        cur = {cmp_key(e): e for e in value}
        if self.accum is None:
            self.accum = cur
        else:
            self.accum = {k: v for k, v in self.accum.items() if k in cur}

    def get(self):
        if self.accum is None:
            return []
        return [v for _, v in sorted(self.accum.items())]


class AccCollect(_Acc):
    def __init__(self, extra):
        self.limit = None
        if extra:
            self.limit = int(extra[0])
        self.accum: List[Any] = []

    def set(self, value):
        if self.limit is not None and len(self.accum) >= self.limit:
            return
        self.accum.append(value)

    def get(self):
        return list(self.accum)


class AccChoiceRand(_Acc):
    def __init__(self, extra):
        self.count = 0
        self.value = None

    def set(self, value):
        self.count += 1
        if random.random() < 1.0 / self.count:
            self.value = value

    def get(self):
        return self.value


class AccVariance(_Acc):
    def __init__(self, extra):
        self.sum = 0.0
        self.sum_sq = 0.0
        self.count = 0

    def set(self, value):
        f = _get_float(value)
        self.sum += f
        self.sum_sq += f * f
        self.count += 1

    def get(self):
        ct = float(self.count)
        if ct <= 1:
            return float("nan")
        return (self.sum_sq - self.sum * self.sum / ct) / (ct - 1.0)


class AccStdDev(AccVariance):
    def get(self):
        v = super().get()
        return math.sqrt(v) if v == v and v >= 0 else float("nan")


class AccMean(_Acc):
    def __init__(self, extra):
        self.sum = 0.0
        self.count = 0

    def set(self, value):
        self.sum += _get_float(value)
        self.count += 1

    def get(self):
        return self.sum / float(self.count) if self.count else float("nan")


class AccSum(_Acc):
    def __init__(self, extra):
        self.sum = 0.0

    def set(self, value):
        self.sum += _get_float(value)

    def get(self):
        return self.sum


class AccProduct(_Acc):
    def __init__(self, extra):
        self.product = 1.0

    def set(self, value):
        self.product *= _get_float(value)

    def get(self):
        return self.product


class AccMin(_Acc):
    def __init__(self, extra):
        self.found = None

    def set(self, value):
        _get_float(value)
        if self.found is None or _get_float(value) < _get_float(self.found):
            self.found = value

    def get(self):
        return self.found


class AccMax(_Acc):
    def __init__(self, extra):
        self.found = None

    def set(self, value):
        _get_float(value)
        if self.found is None or _get_float(value) > _get_float(self.found):
            self.found = value

    def get(self):
        return self.found


class AccAnd(_Acc):
    def __init__(self, extra):
        self.accum = True

    def set(self, value):
        if not isinstance(value, bool):
            raise EvalError(f"cannot compute 'and' on {value!r}")
        self.accum = self.accum and value

    def get(self):
        return self.accum


class AccOr(_Acc):
    def __init__(self, extra):
        self.accum = False

    def set(self, value):
        if not isinstance(value, bool):
            raise EvalError(f"cannot compute 'or' on {value!r}")
        self.accum = self.accum or value

    def get(self):
        return self.accum


class AccLatestBy(_Acc):
    def __init__(self, extra):
        self.found = None
        self.cost = None

    def set(self, value):
        if not isinstance(value, list) or len(value) != 2:
            raise EvalError("'latest_by' requires a list of exactly two items")
        v, c = value
        if self.cost is None or cmp_key(c) > cmp_key(self.cost):
            self.cost = c
            self.found = v

    def get(self):
        return self.found


class AccSmallestBy(_Acc):
    def __init__(self, extra):
        self.found = None
        self.cost = None

    def set(self, value):
        if not isinstance(value, list) or len(value) != 2:
            raise EvalError("'smallest_by' requires a list of exactly two items")
        v, c = value
        if c is None:
            return
        if self.cost is None or cmp_key(c) < cmp_key(self.cost):
            self.cost = c
            self.found = v

    def get(self):
        return self.found


class AccMinCost(_Acc):
    def __init__(self, extra):
        self.found = None
        self.cost = float("inf")

    def set(self, value):
        if not isinstance(value, list) or len(value) != 2:
            raise EvalError("'min_cost' requires a list of exactly two items")
        v, c = value
        cost = _get_float(c)
        if cost < self.cost:
            self.cost = cost
            self.found = v

    def get(self):
        return [self.found, self.cost]


class AccShortest(_Acc):
    def __init__(self, extra):
        self.found = None

    def set(self, value):
        if not isinstance(value, list):
            raise EvalError(f"cannot compute 'shortest' on {value!r}")
        if self.found is None or len(value) < len(self.found):
            self.found = value

    def get(self):
        return self.found


class AccChoice(_Acc):
    def __init__(self, extra):
        self.found = None

    def set(self, value):
        if self.found is None:
            self.found = value

    def get(self):
        return self.found


class AccBitAnd(_Acc):
    op = "bit_and"

    def __init__(self, extra):
        self.res = None

    def _combine(self, a, b):
        return bytes(x & y for x, y in zip(a, b))

    def set(self, value):
        if not isinstance(value, bytes):
            raise EvalError(f"cannot compute '{self.op}' on {value!r}")
        if self.res is None:
            self.res = value
        else:
            if len(self.res) != len(value):
                raise EvalError(f"operands of '{self.op}' must have the same lengths")
            self.res = self._combine(self.res, value)

    def get(self):
        return self.res if self.res is not None else b""


class AccBitOr(AccBitAnd):
    op = "bit_or"

    def _combine(self, a, b):
        return bytes(x | y for x, y in zip(a, b))


class AccBitXor(AccBitAnd):
    op = "bit_xor"

    def _combine(self, a, b):
        return bytes(x ^ y for x, y in zip(a, b))


# --- meet operations -----------------------------------------------------------
# meet_update(left, right) -> (new_left, changed)


def _meet_min(l, r):
    if l is None:
        return (r, r is not None)
    if r is None:
        return (l, False)
    if _get_float(r) < _get_float(l):
        return (r, True)
    return (l, False)


def _meet_max(l, r):
    if l is None:
        return (r, r is not None)
    if r is None:
        return (l, False)
    if _get_float(r) > _get_float(l):
        return (r, True)
    return (l, False)


def _meet_and(l, r):
    if not isinstance(r, bool):
        raise EvalError(f"cannot compute 'and' on {r!r}")
    new = l and r
    return (new, new != l)


def _meet_or(l, r):
    if not isinstance(r, bool):
        raise EvalError(f"cannot compute 'or' on {r!r}")
    new = l or r
    return (new, new != l)


def _meet_union(l, r):
    if not isinstance(r, (list, DSet)):
        raise EvalError(f"cannot compute 'union' for value {r!r}")
    cur = {cmp_key(e): e for e in (l or [])}
    n0 = len(cur)
    for e in r:
        cur.setdefault(cmp_key(e), e)
    if len(cur) == n0:
        return (l, False)
    return ([v for _, v in sorted(cur.items())], True)


def _meet_intersection(l, r):
    if not isinstance(r, (list, DSet)):
        raise EvalError(f"cannot compute 'intersection' for value {r!r}")
    if l is None:
        return (sorted(r, key=cmp_key) if isinstance(r, DSet) else list(r), True)
    keys = {cmp_key(e) for e in r}
    new = [e for e in l if cmp_key(e) in keys]
    return (new, len(new) != len(l))


def _meet_min_cost(l, r):
    if not (isinstance(r, list) and len(r) == 2):
        raise EvalError("'min_cost' requires a list of length 2")
    if l is None:
        l = [None, float("inf")]
    if _get_float(l[1]) <= _get_float(r[1]):
        return (l, False)
    return (list(r), True)


def _meet_shortest(l, r):
    if l is None and r is not None:
        return (r, True)
    if r is None:
        return (l, False)
    if not (isinstance(l, list) and isinstance(r, list)):
        raise EvalError("cannot compute 'shortest' on non-lists")
    if len(r) < len(l):
        return (r, True)
    return (l, False)


def _meet_choice(l, r):
    if l is None and r is not None:
        return (r, True)
    return (l, False)


def _meet_bit_and(l, r):
    if not isinstance(r, bytes):
        raise EvalError(f"cannot compute 'bit_and' on {r!r}")
    if l is None:
        return (r, True)
    if len(l) != len(r):
        raise EvalError("operands of 'bit_and' must have the same lengths")
    new = bytes(x & y for x, y in zip(l, r))
    return (new, new != l)


def _meet_bit_or(l, r):
    if not isinstance(r, bytes):
        raise EvalError(f"cannot compute 'bit_or' on {r!r}")
    if l is None:
        return (r, True)
    if len(l) != len(r):
        raise EvalError("operands of 'bit_or' must have the same lengths")
    new = bytes(x | y for x, y in zip(l, r))
    return (new, new != l)


class Aggregation:
    __slots__ = ("name", "is_meet", "acc_factory", "meet_update")

    def __init__(self, name, is_meet, acc_factory, meet_update=None):
        self.name = name
        self.is_meet = is_meet
        self.acc_factory = acc_factory
        self.meet_update = meet_update

    def make(self, extra_args) -> _Acc:
        return self.acc_factory(extra_args)


AGGR_REGISTRY: Dict[str, Aggregation] = {
    "and": Aggregation("and", True, AccAnd, _meet_and),
    "or": Aggregation("or", True, AccOr, _meet_or),
    "unique": Aggregation("unique", False, AccUnique),
    "group_count": Aggregation("group_count", False, AccGroupCount),
    "union": Aggregation("union", True, AccUnion, _meet_union),
    "intersection": Aggregation("intersection", True, AccIntersection, _meet_intersection),
    "count": Aggregation("count", False, AccCount),
    "count_unique": Aggregation("count_unique", False, AccCountUnique),
    "variance": Aggregation("variance", False, AccVariance),
    "std_dev": Aggregation("std_dev", False, AccStdDev),
    "sum": Aggregation("sum", False, AccSum),
    "product": Aggregation("product", False, AccProduct),
    "min": Aggregation("min", True, AccMin, _meet_min),
    "max": Aggregation("max", True, AccMax, _meet_max),
    "mean": Aggregation("mean", False, AccMean),
    "collect": Aggregation("collect", False, AccCollect),
    "choice_rand": Aggregation("choice_rand", False, AccChoiceRand),
    "latest_by": Aggregation("latest_by", False, AccLatestBy),
    "smallest_by": Aggregation("smallest_by", False, AccSmallestBy),
    "min_cost": Aggregation("min_cost", True, AccMinCost, _meet_min_cost),
    "shortest": Aggregation("shortest", True, AccShortest, _meet_shortest),
    "choice": Aggregation("choice", True, AccChoice, _meet_choice),
    "bit_and": Aggregation("bit_and", True, AccBitAnd, _meet_bit_and),
    "bit_or": Aggregation("bit_or", True, AccBitOr, _meet_bit_or),
    "bit_xor": Aggregation("bit_xor", False, AccBitXor),
}


def get_aggr(name: str) -> Optional[Aggregation]:
    return AGGR_REGISTRY.get(name)
