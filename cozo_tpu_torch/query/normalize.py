"""Normalization: InputProgram → NormalFormProgram.

Three passes, mirroring the reference pipeline
(`query/logical.rs` DNF lowering + `query/reorder.rs:34` safety reorder):

1. DNF-expand each rule body (push `not` inward, split `or` into
   separate rules);
2. canonicalize atom arguments: every positional arg becomes a fresh
   variable, a bound variable, or a constant (general expressions are
   extracted into unifications);
3. safety-reorder atoms so every variable is bound before use in
   filters/negations, and detect unsafe rules.
"""

from __future__ import annotations

import itertools
from typing import Any, Dict, List, Optional, Set, Tuple

from ..data.expr import Apply, Binding, Const, Expr
from ..data.functions import get_op
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
    NormalFormProgram,
    NormalRule,
    NormalRuleSet,
    RelationApplyAtom,
    RuleApplyAtom,
    SearchApplyAtom,
    UnificationAtom,
)
from ..utils.errors import QueryError
from ..data.aggr import get_aggr


class ConstantRuleSet:
    """Inline constant data (`<-` rules, reference `utilities/constant.rs`)."""

    def __init__(self, head: List[str], rows: List[List[Any]]):
        self.head = head
        self.rows = rows


class FixedRuleSet:
    def __init__(self, apply: FixedRuleApply):
        self.apply = apply


# --- DNF ---------------------------------------------------------------------


def _negate_atom(atom) -> List[List[Any]]:
    """Return DNF (list of conjunctions) of NOT atom."""
    if isinstance(atom, NegationAtom):
        return _to_dnf(atom.inner)
    if isinstance(atom, ExprAtom):
        return [[ExprAtom(Apply(get_op("negate"), [atom.expr]))]]
    if isinstance(atom, DisjunctionAtom):
        # not (a or b) = not a AND not b → product of the negated DNFs
        parts = [_negate_atom(x) for x in atom.inner]
        out = []
        for combo in itertools.product(*parts):
            conj: List[Any] = []
            for c in combo:
                conj.extend(c)
            out.append(conj)
        return out
    if isinstance(atom, ConjunctionAtom):
        # not (a and b) = not a OR not b
        out = []
        for x in atom.inner:
            out.extend(_negate_atom(x))
        return out
    if isinstance(atom, (RuleApplyAtom, RelationApplyAtom)):
        return [[NegationAtom(atom)]]
    if isinstance(atom, UnificationAtom):
        raise QueryError("cannot negate a unification", code="parser::bad_negation")
    if isinstance(atom, SearchApplyAtom):
        raise QueryError("cannot negate an index search", code="parser::bad_negation")
    raise QueryError(f"cannot negate {atom!r}")


def _to_dnf(atom) -> List[List[Any]]:
    """DNF of one atom: list of conjunctions (lists of simple atoms)."""
    if isinstance(atom, DisjunctionAtom):
        out = []
        for x in atom.inner:
            out.extend(_to_dnf(x))
        return out
    if isinstance(atom, ConjunctionAtom):
        parts = [_to_dnf(x) for x in atom.inner]
        out = []
        for combo in itertools.product(*parts):
            conj: List[Any] = []
            for c in combo:
                conj.extend(c)
            out.append(conj)
        return out
    if isinstance(atom, NegationAtom):
        return _negate_atom(atom.inner)
    return [[atom]]


def body_to_dnf(body: List[Any]) -> List[List[Any]]:
    parts = [_to_dnf(a) for a in body]
    out = []
    for combo in itertools.product(*parts):
        conj: List[Any] = []
        for c in combo:
            conj.extend(c)
        out.append(conj)
    return out


# --- arg canonicalization -------------------------------------------------------


class _FreshVars:
    def __init__(self):
        self.n = 0

    def make(self) -> str:
        self.n += 1
        return f"*fv{self.n}"


def _canon_args(
    args: List[Expr], seen_in_atom: Set[str], fresh: _FreshVars, post: List[Any]
) -> List[Any]:
    """Normalize atom args to Const / var-name strings; extract exprs."""
    out: List[Any] = []
    for a in args:
        a = a.fold_const()
        if isinstance(a, Const):
            out.append(a)
        elif isinstance(a, Binding):
            if a.var == "_":
                out.append(fresh.make())
            elif a.var in seen_in_atom:
                fv = fresh.make()
                out.append(fv)
                post.append(
                    ExprAtom(Apply(get_op("eq"), [Binding(fv), Binding(a.var)]))
                )
            else:
                seen_in_atom.add(a.var)
                out.append(a.var)
        else:
            fv = fresh.make()
            out.append(fv)
            post.append(UnificationAtom(fv, a, one_many=False))
    return out


def canonicalize_conj(conj: List[Any], fresh: _FreshVars) -> List[Any]:
    out: List[Any] = []
    for atom in conj:
        if isinstance(atom, RuleApplyAtom):
            post: List[Any] = []
            args = _canon_args(atom.args, set(), fresh, post)
            out.append(RuleApplyAtom(atom.name, args))
            out.extend(post)
        elif isinstance(atom, RelationApplyAtom):
            post = []
            if atom.args is not None:
                args = _canon_args(atom.args, set(), fresh, post)
                out.append(RelationApplyAtom(atom.name, args=args, validity=atom.validity))
            else:
                seen: Set[str] = set()
                pairs = []
                for col, e in atom.pairs:
                    canon = _canon_args([e], seen, fresh, post)
                    pairs.append((col, canon[0]))
                out.append(RelationApplyAtom(atom.name, pairs=pairs, validity=atom.validity))
            out.extend(post)
        elif isinstance(atom, SearchApplyAtom):
            post = []
            seen = set()
            pairs = []
            for col, e in atom.pairs:
                canon = _canon_args([e], seen, fresh, post)
                pairs.append((col, canon[0]))
            out.append(SearchApplyAtom(atom.rel, atom.idx, pairs, atom.opts))
            out.extend(post)
        elif isinstance(atom, NegationAtom):
            inner = atom.inner
            if isinstance(inner, RuleApplyAtom):
                post = []
                args = _canon_args(inner.args, set(), fresh, post)
                if any(isinstance(p, UnificationAtom) for p in post):
                    # expr args inside negation must be pre-bound; hoist them
                    for p in post:
                        out.append(p)
                out.append(NegationAtom(RuleApplyAtom(inner.name, args)))
            elif isinstance(inner, RelationApplyAtom):
                post = []
                if inner.args is not None:
                    args = _canon_args(inner.args, set(), fresh, post)
                    new_inner = RelationApplyAtom(
                        inner.name, args=args, validity=inner.validity
                    )
                else:
                    seen = set()
                    pairs = []
                    for col, e in inner.pairs:
                        canon = _canon_args([e], seen, fresh, post)
                        pairs.append((col, canon[0]))
                    new_inner = RelationApplyAtom(
                        inner.name, pairs=pairs, validity=inner.validity
                    )
                for p in post:
                    out.append(p)
                out.append(NegationAtom(new_inner))
            else:
                raise QueryError("unsupported negation target")
        else:
            out.append(atom)
    return out


# --- variable sets ----------------------------------------------------------------


def atom_bind_vars(atom) -> Set[str]:
    """Vars an atom can BIND (fresh bindings it can produce)."""
    if isinstance(atom, RuleApplyAtom):
        return {a for a in atom.args if isinstance(a, str)}
    if isinstance(atom, RelationApplyAtom):
        if atom.args is not None:
            return {a for a in atom.args if isinstance(a, str)}
        return {a for _, a in atom.pairs if isinstance(a, str)}
    if isinstance(atom, SearchApplyAtom):
        out = {a for _, a in atom.pairs if isinstance(a, str)}
        # bind_* options are OUTPUTS of the search, not inputs
        for name, e in atom.opts.items():
            if name.startswith("bind_") and isinstance(e, Binding):
                out.add(e.var)
        return out
    if isinstance(atom, UnificationAtom):
        return {atom.var}
    return set()


def atom_req_vars(atom) -> Set[str]:
    """Vars an atom REQUIRES bound before it can run."""
    out: Set[str] = set()
    if isinstance(atom, UnificationAtom):
        atom.expr.bindings(out)
        return out
    if isinstance(atom, ExprAtom):
        atom.expr.bindings(out)
        return out
    if isinstance(atom, NegationAtom):
        return atom_bind_vars(atom.inner)
    if isinstance(atom, SearchApplyAtom):
        # `filter` is evaluated against candidate rows inside the search;
        # bind_* are outputs — neither constrains ordering
        for name, e in atom.opts.items():
            if not name.startswith("bind_") and name != "filter":
                e.bindings(out)
        return out
    return out


def reorder_for_safety(conj: List[Any], head: List[str], rule_name: str) -> List[Any]:
    pending = list(conj)
    bound: Set[str] = set()
    ordered: List[Any] = []
    # wildcards (`_` → fresh `*fv` vars) inside a negated atom that no
    # positive atom binds are existential — `not rel[x, _]` means "no row
    # with first component x" (reference query/reorder.rs wildcard rule)
    pos_bound: Set[str] = set()
    for a in conj:
        if not isinstance(a, NegationAtom):
            pos_bound |= atom_bind_vars(a)
    while pending:
        progressed = False
        for i, atom in enumerate(pending):
            req = atom_req_vars(atom)
            if isinstance(atom, NegationAtom):
                req = {
                    v for v in req
                    if not (v.startswith("*fv") and v not in pos_bound)
                }
                # all its vars must already be bound (safe negation)
                if not req <= bound:
                    continue
            elif not req <= bound:
                continue
            ordered.append(atom)
            bound |= atom_bind_vars(atom)
            pending.pop(i)
            progressed = True
            break
        if not progressed:
            missing = set()
            for atom in pending:
                missing |= atom_req_vars(atom) - bound
            raise QueryError(
                f"rule '{rule_name}' is unsafe: variables {sorted(missing)} "
                f"cannot be bound",
                code="eval::unsafe_rule",
            )
    for h in head:
        if h not in bound and h != "_":
            raise QueryError(
                f"head variable '{h}' of rule '{rule_name}' is unbound in body",
                code="eval::unbound_head",
            )
    return ordered


# --- program-level ------------------------------------------------------------------


def normalize_program(prog: InputProgram) -> NormalFormProgram:
    out = NormalFormProgram()
    fresh = _FreshVars()
    for name, rules in prog.rules.items():
        kinds = {type(r) for r in rules}
        if FixedRuleApply in kinds or ConstRule in kinds:
            if len(rules) != 1:
                raise QueryError(
                    f"rule '{name}': fixed/constant rules cannot have multiple clauses"
                )
        r0 = rules[0]
        if isinstance(r0, ConstRule):
            data = r0.data.fold_const()
            if not isinstance(data, Const):
                raise QueryError(
                    f"constant rule '{name}' requires a constant expression"
                )
            rows = data.val
            if not isinstance(rows, list) or not all(isinstance(r, list) for r in rows):
                raise QueryError(
                    f"constant rule '{name}' requires a list of lists"
                )
            head = r0.head
            if head:
                for r in rows:
                    if len(r) != len(head):
                        raise QueryError(
                            f"constant rule '{name}': row arity mismatch: {r!r}"
                        )
            elif rows:
                head = [f"_{i}" for i in range(len(rows[0]))]
            out.prog[name] = ConstantRuleSet(head, rows)
            continue
        if isinstance(r0, FixedRuleApply):
            out.prog[name] = FixedRuleSet(r0)
            continue
        normal_rules: List[NormalRule] = []
        arity = len(r0.head)
        aggr_sig = [a.name if a else None for a in r0.aggrs]
        for r in rules:
            if len(r.head) != arity:
                raise QueryError(f"arity mismatch among clauses of rule '{name}'")
            if [a.name if a else None for a in r.aggrs] != aggr_sig:
                raise QueryError(
                    f"aggregation signature mismatch among clauses of rule '{name}'"
                )
            for a in r.aggrs:
                if a is not None and get_aggr(a.name) is None:
                    raise QueryError(f"aggregation '{a.name}' not found")
            for conj in body_to_dnf(r.body):
                conj = canonicalize_conj(conj, fresh)
                conj = reorder_for_safety(conj, r.head, name)
                normal_rules.append(NormalRule(list(r.head), list(r.aggrs), conj))
        out.prog[name] = NormalRuleSet(normal_rules)
    return out
