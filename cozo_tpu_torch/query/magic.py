"""Magic-set rewriting (reference `cozo-core/src/query/magic.rs`).

Classic demand-driven rewrite: rules called with bound arguments get
adorned copies (`name|bbf…`) restricted by magic predicates
(`magic name|bbf…`) seeded from each call site's prefix.  Exemptions
match the reference (`magic.rs:31-52`): the entry rule, rules with
aggregations, and rules reached through negation or as fixed-rule inputs
are evaluated in full (adorned all-free, bodies still rewritten).

Unlike the reference we skip supplementary (`Sup`) predicates: magic
seed rules carry the call-site prefix directly — same semantics, some
recomputation, far less machinery."""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Set, Tuple

from ..data.expr import Const
from ..data.program import (
    NegationAtom,
    NormalFormProgram,
    NormalRule,
    NormalRuleSet,
    RuleApplyAtom,
    UnificationAtom,
)
from .normalize import ConstantRuleSet, FixedRuleSet, atom_bind_vars


def _mangle(name: str, sigma: Tuple[bool, ...]) -> str:
    return f"{name}|{''.join('b' if b else 'f' for b in sigma)}"


def _magic_name(name: str, sigma: Tuple[bool, ...]) -> str:
    return f"*magic*{_mangle(name, sigma)}"


def magic_rewrite(nf: NormalFormProgram) -> NormalFormProgram:
    prog = nf.prog
    entry = "?"
    if entry not in prog:
        return nf

    rewritable: Set[str] = set()
    for name, rs in prog.items():
        if name == entry or not isinstance(rs, NormalRuleSet):
            continue
        if any(a is not None for a in rs.rules[0].aggrs):
            continue  # aggregations must see the full extension
        if any(len(set(r.head)) != len(r.head) for r in rs.rules):
            continue
        rewritable.add(name)

    # quick scan: is any rewritable rule ever called with a bound argument?
    def has_bound_call() -> bool:
        for rs in prog.values():
            if isinstance(rs, NormalRuleSet):
                for rule in rs.rules:
                    bound: Set[str] = set()
                    for atom in rule.body:
                        if (
                            isinstance(atom, RuleApplyAtom)
                            and atom.name in rewritable
                        ):
                            for a in atom.args:
                                if isinstance(a, Const) or (
                                    isinstance(a, str) and a in bound
                                ):
                                    return True
                        bound |= atom_bind_vars(atom)
        return False

    if not rewritable or not has_bound_call():
        return nf

    out: Dict[str, Any] = {}
    magic_rules: Dict[str, List[NormalRule]] = {}
    fresh_n = [0]

    def fresh() -> str:
        fresh_n[0] += 1
        return f"*mv{fresh_n[0]}"

    done: Set[Tuple[str, Tuple[bool, ...]]] = set()
    work: List[Tuple[str, Tuple[bool, ...]]] = []

    def enqueue(name: str, sigma: Tuple[bool, ...]) -> str:
        if name not in prog:
            return name
        rs = prog[name]
        if not isinstance(rs, NormalRuleSet):
            # constants / fixed rules: never adorned
            if (name, ()) not in done:
                done.add((name, ()))
                out[name] = rs
                if isinstance(rs, FixedRuleSet):
                    _rewrite_fixed_inputs(rs)
            return name
        if name not in rewritable:
            sigma = tuple(False for _ in sigma)
        key = (name, sigma)
        if key not in done:
            done.add(key)
            work.append(key)
        return name if name == entry else _mangle(name, sigma)

    def _rewrite_fixed_inputs(rs: FixedRuleSet) -> None:
        from ..data.program import FixedRuleRuleArg

        for inp in rs.apply.inputs:
            if isinstance(inp, FixedRuleRuleArg) and inp.name in prog:
                arity = _arity_of(inp.name)
                inp.name = enqueue(inp.name, tuple([False] * arity))

    def _arity_of(name: str) -> int:
        rs = prog[name]
        if isinstance(rs, NormalRuleSet):
            return len(rs.rules[0].head)
        if isinstance(rs, ConstantRuleSet):
            return len(rs.head)
        return 0

    def process(name: str, sigma: Tuple[bool, ...]) -> None:
        rs = prog[name]
        mangled = name if name == entry else _mangle(name, sigma)
        magic_pred = _magic_name(name, sigma) if any(sigma) else None
        new_rules: List[NormalRule] = []
        for rule in rs.rules:
            bound: Set[str] = set()
            new_body: List[Any] = []
            if magic_pred is not None:
                bound_head = [h for h, b in zip(rule.head, sigma) if b]
                new_body.append(RuleApplyAtom(magic_pred, list(bound_head)))
                bound |= set(bound_head)
            for atom in rule.body:
                if isinstance(atom, RuleApplyAtom) and atom.name in prog:
                    callee = atom.name
                    sig = tuple(
                        isinstance(a, Const)
                        or (isinstance(a, str) and a in bound)
                        for a in atom.args
                    )
                    if callee not in rewritable:
                        sig = tuple(False for _ in sig)
                    target = enqueue(callee, sig)
                    if any(sig) and callee in rewritable:
                        mp = _magic_name(callee, sig)
                        seed_body = list(new_body)
                        head_vars: List[str] = []
                        for a, b in zip(atom.args, sig):
                            if not b:
                                continue
                            if isinstance(a, Const):
                                fv = fresh()
                                seed_body.append(
                                    UnificationAtom(fv, Const(a.val), False)
                                )
                                head_vars.append(fv)
                            else:
                                head_vars.append(a)
                        magic_rules.setdefault(mp, []).append(
                            NormalRule(
                                head_vars, [None] * len(head_vars), seed_body
                            )
                        )
                    new_body.append(RuleApplyAtom(target, list(atom.args)))
                elif isinstance(atom, NegationAtom) and isinstance(
                    atom.inner, RuleApplyAtom
                ) and atom.inner.name in prog:
                    # negated predicates must be complete: all-free adornment
                    callee = atom.inner.name
                    arity = len(atom.inner.args)
                    target = enqueue(callee, tuple([False] * arity))
                    new_body.append(
                        NegationAtom(RuleApplyAtom(target, list(atom.inner.args)))
                    )
                else:
                    new_body.append(atom)
                bound |= atom_bind_vars(atom)
            new_rules.append(NormalRule(list(rule.head), list(rule.aggrs), new_body))
        out[mangled] = NormalRuleSet(new_rules)

    enqueue(entry, tuple([False] * _arity_of(entry)))
    while work:
        name, sigma = work.pop()
        process(name, sigma)

    for mp, rules in magic_rules.items():
        out[mp] = NormalRuleSet(rules)

    result = NormalFormProgram()
    result.prog = out
    return result
