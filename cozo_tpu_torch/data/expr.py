"""Expression ASTs and evaluation.

Mirrors the reference `cozo-core/src/data/expr.rs`: expressions are
compiled against a binding order (variable → tuple position) and then
evaluated per-tuple.  Instead of the reference's stack bytecode
({Binding, Const, Apply, JumpIfFalse, Goto}, expr.rs:29-60) we evaluate
the tree directly with explicit short-circuiting for `and`/`or`/`cond`
— same semantics, simpler host code (the hot per-row loops in the TPU
rebuild are vectorized elsewhere, not bytecode-bound).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

from ..utils.errors import EvalError, QueryError
from .functions import Op, get_op
from .value import cmp_key

__all__ = [
    "Expr",
    "Const",
    "Binding",
    "Apply",
    "Cond",
    "eval_expr",
    "compute_single_bound",
]


class Expr:
    __slots__ = ()

    def clone(self) -> "Expr":
        """Structural copy — binding indices are filled per compiled clause,
        so clauses must never share mutable Expr nodes."""
        return self

    def bindings(self, out: Set[str]) -> None:
        pass

    def fill_binding_indices(self, binding_map: Dict[str, int]) -> None:
        pass

    def eval(self, tup: Sequence[Any]) -> Any:
        raise NotImplementedError

    def eval_env(self, env: Dict[str, Any]) -> Any:
        raise NotImplementedError

    def is_const(self) -> bool:
        return False

    def fold_const(self) -> "Expr":
        return self


class Const(Expr):
    __slots__ = ("val",)

    def __init__(self, val: Any) -> None:
        self.val = val

    def eval(self, tup) -> Any:
        return self.val

    def eval_env(self, env) -> Any:
        return self.val

    def is_const(self) -> bool:
        return True

    def __repr__(self) -> str:
        return f"Const({self.val!r})"


class Binding(Expr):
    __slots__ = ("var", "tuple_pos")

    def __init__(self, var: str, tuple_pos: Optional[int] = None) -> None:
        self.var = var
        self.tuple_pos = tuple_pos

    def clone(self) -> "Binding":
        return Binding(self.var, self.tuple_pos)

    def bindings(self, out: Set[str]) -> None:
        out.add(self.var)

    def fill_binding_indices(self, binding_map: Dict[str, int]) -> None:
        if self.var not in binding_map:
            raise QueryError(
                f"binding '{self.var}' not found in the current context",
                code="eval::unbound",
            )
        self.tuple_pos = binding_map[self.var]

    def eval(self, tup) -> Any:
        if self.tuple_pos is None:
            raise EvalError(f"binding index for '{self.var}' not filled")
        return tup[self.tuple_pos]

    def eval_env(self, env) -> Any:
        if self.var not in env:
            raise EvalError(f"unbound variable '{self.var}'")
        return env[self.var]

    def __repr__(self) -> str:
        return f"Binding({self.var}@{self.tuple_pos})"


class Apply(Expr):
    __slots__ = ("op", "args")

    def __init__(self, op: Op, args: List[Expr]) -> None:
        self.op = op
        self.args = args

    def clone(self) -> "Apply":
        return Apply(self.op, [a.clone() for a in self.args])

    def bindings(self, out: Set[str]) -> None:
        for a in self.args:
            a.bindings(out)

    def fill_binding_indices(self, binding_map) -> None:
        for a in self.args:
            a.fill_binding_indices(binding_map)

    def eval(self, tup) -> Any:
        name = self.op.name
        if name == "and":
            for a in self.args:
                v = a.eval(tup)
                if not isinstance(v, bool):
                    raise EvalError("'and' requires booleans")
                if not v:
                    return False
            return True
        if name == "or":
            for a in self.args:
                v = a.eval(tup)
                if not isinstance(v, bool):
                    raise EvalError("'or' requires booleans")
                if v:
                    return True
            return False
        if name == "coalesce":
            for a in self.args:
                v = a.eval(tup)
                if v is not None:
                    return v
            return None
        return self.op.fn([a.eval(tup) for a in self.args])

    def eval_env(self, env) -> Any:
        name = self.op.name
        if name == "and":
            for a in self.args:
                v = a.eval_env(env)
                if not isinstance(v, bool):
                    raise EvalError("'and' requires booleans")
                if not v:
                    return False
            return True
        if name == "or":
            for a in self.args:
                v = a.eval_env(env)
                if not isinstance(v, bool):
                    raise EvalError("'or' requires booleans")
                if v:
                    return True
            return False
        if name == "coalesce":
            for a in self.args:
                v = a.eval_env(env)
                if v is not None:
                    return v
            return None
        return self.op.fn([a.eval_env(env) for a in self.args])

    def fold_const(self) -> Expr:
        self.args = [a.fold_const() for a in self.args]
        if self.op.deterministic and all(a.is_const() for a in self.args):
            try:
                return Const(self.op.fn([a.val for a in self.args]))
            except EvalError:
                return self
        return self

    def __repr__(self) -> str:
        return f"{self.op.name}({', '.join(map(repr, self.args))})"


class Cond(Expr):
    """cond(c1, r1, c2, r2, ...) / if(c, t, e) — short-circuit clauses."""

    __slots__ = ("clauses",)

    def __init__(self, clauses: List[Tuple[Expr, Expr]]) -> None:
        self.clauses = clauses

    def clone(self) -> "Cond":
        return Cond([(c.clone(), r.clone()) for c, r in self.clauses])

    def bindings(self, out: Set[str]) -> None:
        for c, r in self.clauses:
            c.bindings(out)
            r.bindings(out)

    def fill_binding_indices(self, binding_map) -> None:
        for c, r in self.clauses:
            c.fill_binding_indices(binding_map)
            r.fill_binding_indices(binding_map)

    def eval(self, tup) -> Any:
        for c, r in self.clauses:
            v = c.eval(tup)
            if v is True:
                return r.eval(tup)
            if v is not False:
                raise EvalError("'cond' conditions must be booleans")
        return None

    def eval_env(self, env) -> Any:
        for c, r in self.clauses:
            v = c.eval_env(env)
            if v is True:
                return r.eval_env(env)
            if v is not False:
                raise EvalError("'cond' conditions must be booleans")
        return None

    def fold_const(self) -> Expr:
        self.clauses = [(c.fold_const(), r.fold_const()) for c, r in self.clauses]
        return self

    def __repr__(self) -> str:
        return f"Cond({self.clauses!r})"


class ParamRef(Expr):
    """Late-bound parameter placeholder (template-cached plans): replaced
    by a Const per execution in `query/template.py`."""

    __slots__ = ("name",)

    def __init__(self, name: str) -> None:
        self.name = name

    def clone(self) -> "ParamRef":
        return ParamRef(self.name)

    def fill_binding_indices(self, binding_map) -> None:
        raise QueryError(f"parameter ${self.name} was not substituted")

    def eval(self, tup):
        raise EvalError(f"parameter ${self.name} was not substituted")

    def eval_env(self, env):
        raise EvalError(f"parameter ${self.name} was not substituted")

    def __repr__(self) -> str:
        return f"ParamRef(${self.name})"


class UnboundApply(Expr):
    """A named function not in the registry; resolved against custom ops at
    compile time or an error."""

    __slots__ = ("name", "args")

    def __init__(self, name: str, args: List[Expr]) -> None:
        self.name = name
        self.args = args

    def bindings(self, out: Set[str]) -> None:
        for a in self.args:
            a.bindings(out)

    def fill_binding_indices(self, binding_map) -> None:
        raise QueryError(f"Named function '{self.name}' not found")

    def eval(self, tup):
        raise EvalError(f"Named function '{self.name}' not found")

    def eval_env(self, env):
        raise EvalError(f"Named function '{self.name}' not found")

    def __repr__(self) -> str:
        return f"UnboundApply({self.name})"


def eval_expr(expr: Expr, env: Dict[str, Any]) -> Any:
    return expr.eval_env(env)


def expr_bindings(expr: Expr) -> Set[str]:
    out: Set[str] = set()
    expr.bindings(out)
    return out


def compute_single_bound(expr: Expr, var: str):
    """Derive a (lower, upper) bound hint for `var` from a filter expression
    (simplified analog of reference `compute_bounds`, expr.rs:660).

    Returns (lower_val_or_None, lower_incl, upper_val_or_None, upper_incl)
    or None when nothing can be derived."""
    if not isinstance(expr, Apply):
        return None
    name = expr.op.name
    if name == "and":
        lo, lo_i, hi, hi_i = None, True, None, True
        for a in expr.args:
            sub = compute_single_bound(a, var)
            if sub is None:
                continue
            slo, slo_i, shi, shi_i = sub
            if slo is not None and (lo is None or cmp_key(slo) > cmp_key(lo)):
                lo, lo_i = slo, slo_i
            if shi is not None and (hi is None or cmp_key(shi) < cmp_key(hi)):
                hi, hi_i = shi, shi_i
        if lo is None and hi is None:
            return None
        return (lo, lo_i, hi, hi_i)
    if name in ("eq", "gt", "ge", "lt", "le") and len(expr.args) == 2:
        a, b = expr.args
        if isinstance(a, Binding) and a.var == var and b.is_const():
            v = b.val
        elif isinstance(b, Binding) and b.var == var and a.is_const():
            v = a.val
            name = {"gt": "lt", "ge": "le", "lt": "gt", "le": "ge"}.get(name, name)
        else:
            return None
        if name == "eq":
            return (v, True, v, True)
        if name == "gt":
            return (v, False, None, True)
        if name == "ge":
            return (v, True, None, True)
        if name == "lt":
            return (None, True, v, False)
        if name == "le":
            return (None, True, v, True)
    return None
