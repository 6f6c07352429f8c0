"""Query-plan template cache support.

Scripts are parsed once with parameters deferred (`ParamRef` nodes);
each execution clones the program AST substituting actual parameter
values — skipping lexing/parsing entirely for repeated queries (the
reference's Rust parser is cheap; the Python host's is not, so this is
the OLTP hot-path optimization).

Templates are only used when every `$param` occurs inside rule bodies or
constant-rule data; params in const-evaluated positions (options,
fixed-rule args, index DDL) fall back to plain parsing."""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from ..data.expr import Apply, Binding, Cond, Const, Expr, ParamRef, UnboundApply
from ..data.program import (
    AggrSpec,
    ConjunctionAtom,
    ConstRule,
    DisjunctionAtom,
    ExprAtom,
    FixedRuleApply,
    InputProgram,
    InputRule,
    NegationAtom,
    QueryOutOptions,
    RelationApplyAtom,
    RuleApplyAtom,
    SearchApplyAtom,
    StoreRelation,
    UnificationAtom,
)
from ..data.value import deep_freeze
from ..utils.errors import ParseError, QueryError


class NotTemplatable(Exception):
    pass


def _subst_expr(e: Expr, params: Optional[Dict[str, Any]]) -> Expr:
    if isinstance(e, ParamRef):
        if params is None:
            raise NotTemplatable(e.name)
        if e.name not in params:
            raise QueryError(
                f"Required parameter {e.name} not found",
                code="parser::param_not_found",
            )
        return Const(deep_freeze(params[e.name]))
    if isinstance(e, Const) or isinstance(e, Binding):
        return e.clone() if isinstance(e, Binding) else Const(e.val)
    if isinstance(e, Apply):
        return Apply(e.op, [_subst_expr(a, params) for a in e.args])
    if isinstance(e, Cond):
        return Cond(
            [(_subst_expr(c, params), _subst_expr(r, params)) for c, r in e.clauses]
        )
    if isinstance(e, UnboundApply):
        return UnboundApply(e.name, [_subst_expr(a, params) for a in e.args])
    return e


def _subst_atom(a, params):
    if isinstance(a, RuleApplyAtom):
        return RuleApplyAtom(a.name, [_subst_expr(x, params) for x in a.args])
    if isinstance(a, RelationApplyAtom):
        return RelationApplyAtom(
            a.name,
            args=[_subst_expr(x, params) for x in a.args]
            if a.args is not None
            else None,
            pairs=[(c, _subst_expr(x, params)) for c, x in a.pairs]
            if a.pairs is not None
            else None,
            validity=_subst_expr(a.validity, params)
            if a.validity is not None
            else None,
        )
    if isinstance(a, SearchApplyAtom):
        return SearchApplyAtom(
            a.rel,
            a.idx,
            [(c, _subst_expr(x, params)) for c, x in a.pairs],
            {k: _subst_expr(v, params) for k, v in a.opts.items()},
        )
    if isinstance(a, UnificationAtom):
        return UnificationAtom(a.var, _subst_expr(a.expr, params), a.one_many)
    if isinstance(a, ExprAtom):
        return ExprAtom(_subst_expr(a.expr, params))
    if isinstance(a, NegationAtom):
        return NegationAtom(_subst_atom(a.inner, params))
    if isinstance(a, ConjunctionAtom):
        return ConjunctionAtom([_subst_atom(x, params) for x in a.inner])
    if isinstance(a, DisjunctionAtom):
        return DisjunctionAtom([_subst_atom(x, params) for x in a.inner])
    raise NotTemplatable(type(a).__name__)


def _check_no_params(obj) -> None:
    """Raise NotTemplatable if any ParamRef lurks in a const-eval position."""
    if isinstance(obj, ParamRef):
        raise NotTemplatable(obj.name)
    if isinstance(obj, Apply):
        for a in obj.args:
            _check_no_params(a)
    elif isinstance(obj, Cond):
        for c, r in obj.clauses:
            _check_no_params(c)
            _check_no_params(r)
    elif isinstance(obj, UnboundApply):
        for a in obj.args:
            _check_no_params(a)


def instantiate(prog: InputProgram, params: Optional[Dict[str, Any]]) -> InputProgram:
    """Clone the template, substituting parameters.  params=None validates
    templatability without substituting."""
    out = InputProgram()
    for name, rules in prog.rules.items():
        new_rules = []
        for r in rules:
            if isinstance(r, InputRule):
                new_rules.append(
                    InputRule(
                        list(r.head),
                        [
                            AggrSpec(a.name, list(a.extra_args)) if a else None
                            for a in r.aggrs
                        ],
                        [_subst_atom(a, params) for a in r.body],
                    )
                )
            elif isinstance(r, ConstRule):
                new_rules.append(ConstRule(list(r.head), _subst_expr(r.data, params)))
            elif isinstance(r, FixedRuleApply):
                # options/inputs are const-evaluated: params not allowed
                for v in r.options.values():
                    if isinstance(v, Expr):
                        _check_no_params(v)
                import copy

                new_rules.append(
                    FixedRuleApply(
                        r.fixed_name,
                        list(r.head),
                        copy.deepcopy(r.inputs),
                        dict(r.options),
                    )
                )
            else:
                raise NotTemplatable(type(r).__name__)
        out.rules[name] = new_rules
    oo = prog.out_opts
    new_oo = QueryOutOptions(
        limit=oo.limit,
        offset=oo.offset,
        timeout=oo.timeout,
        sleep=oo.sleep,
        sorters=list(oo.sorters),
        store_relation=None,
        assert_none=oo.assert_none,
        assert_some=oo.assert_some,
        returning=oo.returning,
        disable_magic_rewrite=oo.disable_magic_rewrite,
    )
    if oo.store_relation is not None:
        sr = oo.store_relation
        if sr.schema is not None:
            for col in list(sr.schema.keys) + list(sr.schema.values):
                if col.default is not None:
                    _check_no_params(col.default[0])
        new_oo.store_relation = StoreRelation(sr.op, sr.name, sr.schema)
    out.out_opts = new_oo
    return out
