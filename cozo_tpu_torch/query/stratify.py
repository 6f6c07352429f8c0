"""Stratification: dependency analysis + SCC condensation → strata.

Mirrors reference `query/stratify.rs`: edges from a rule to the rules it
reads are "poisoned" when the reading rule negates the target, applies a
non-meet aggregation, or is a fixed rule (its inputs must be complete);
a poisoned edge inside a cycle is unstratifiable.  Strata are emitted in
dependency order (callees first); the entry rule `?` lands in the last
stratum."""

from __future__ import annotations

from typing import Any, Dict, List, Set, Tuple

from ..data.aggr import get_aggr
from ..data.program import (
    NegationAtom,
    NormalFormProgram,
    NormalRuleSet,
    RuleApplyAtom,
)
from ..utils.errors import QueryError
from .normalize import ConstantRuleSet, FixedRuleSet


def _rule_deps(name: str, ruleset, prog) -> List[Tuple[str, bool]]:
    """(dep_name, poisoned) pairs."""
    deps: List[Tuple[str, bool]] = []
    if isinstance(ruleset, ConstantRuleSet):
        return deps
    if isinstance(ruleset, FixedRuleSet):
        from ..data.program import FixedRuleRuleArg

        for inp in ruleset.apply.inputs:
            if isinstance(inp, FixedRuleRuleArg) and inp.name in prog:
                deps.append((inp.name, True))
        return deps
    for rule in ruleset.rules:
        has_normal_aggr = any(
            a is not None and not get_aggr(a.name).is_meet for a in rule.aggrs
        )
        has_meet_aggr = any(
            a is not None and get_aggr(a.name).is_meet for a in rule.aggrs
        )
        for atom in rule.body:
            if isinstance(atom, RuleApplyAtom) and atom.name in prog:
                deps.append((atom.name, has_normal_aggr))
            elif isinstance(atom, NegationAtom) and isinstance(
                atom.inner, RuleApplyAtom
            ):
                if atom.inner.name in prog:
                    deps.append((atom.inner.name, True))
        _ = has_meet_aggr  # meet aggrs allow recursion
    return deps


def _tarjan_scc(nodes: List[str], edges: Dict[str, List[str]]) -> List[List[str]]:
    index: Dict[str, int] = {}
    low: Dict[str, int] = {}
    on_stack: Set[str] = set()
    stack: List[str] = []
    out: List[List[str]] = []
    counter = [0]

    def strongconnect(v: str):
        # iterative Tarjan to avoid recursion limits on deep programs
        work = [(v, 0)]
        while work:
            node, pi = work[-1]
            if pi == 0:
                index[node] = low[node] = counter[0]
                counter[0] += 1
                stack.append(node)
                on_stack.add(node)
            recurse = False
            succs = edges.get(node, [])
            for i in range(pi, len(succs)):
                w = succs[i]
                if w not in index:
                    work[-1] = (node, i + 1)
                    work.append((w, 0))
                    recurse = True
                    break
                elif w in on_stack:
                    low[node] = min(low[node], index[w])
            if recurse:
                continue
            if low[node] == index[node]:
                comp = []
                while True:
                    w = stack.pop()
                    on_stack.discard(w)
                    comp.append(w)
                    if w == node:
                        break
                out.append(comp)
            work.pop()
            if work:
                parent = work[-1][0]
                low[parent] = min(low[parent], low[node])

    for v in nodes:
        if v not in index:
            strongconnect(v)
    return out


def stratify_program(nf: NormalFormProgram) -> List[Dict[str, Any]]:
    """Return a list of strata; each stratum is {rule_name: ruleset},
    ordered so dependencies come first."""
    prog = nf.prog
    nodes = list(prog)
    edges: Dict[str, List[str]] = {n: [] for n in nodes}
    poisoned: Set[Tuple[str, str]] = set()
    for name, rs in prog.items():
        for dep, poison in _rule_deps(name, rs, prog):
            edges[name].append(dep)
            if poison:
                poisoned.add((name, dep))

    sccs = _tarjan_scc(nodes, edges)  # already in reverse topological order
    comp_of: Dict[str, int] = {}
    for i, comp in enumerate(sccs):
        for n in comp:
            comp_of[n] = i

    # poisoned edge within one SCC → unstratifiable
    for (a, b) in poisoned:
        if comp_of[a] == comp_of[b]:
            raise QueryError(
                f"query is unstratifiable: rule '{a}' depends on '{b}' "
                f"through negation or a non-meet aggregation inside a cycle",
                code="eval::unstratifiable",
            )
    # every FixedRuleSet / normal-aggr self-recursion check
    for name, rs in prog.items():
        if isinstance(rs, NormalRuleSet):
            for rule in rs.rules:
                has_normal_aggr = any(
                    a is not None and not get_aggr(a.name).is_meet for a in rule.aggrs
                )
                if has_normal_aggr:
                    for atom in rule.body:
                        if (
                            isinstance(atom, RuleApplyAtom)
                            and atom.name in prog
                            and comp_of.get(atom.name) == comp_of[name]
                        ):
                            raise QueryError(
                                f"rule '{name}' with a non-meet aggregation "
                                f"cannot be recursive",
                                code="eval::unstratifiable",
                            )

    # Tarjan emits SCCs with callees first, which is our evaluation order.
    strata: List[Dict[str, Any]] = []
    for comp in sccs:
        stratum = {n: prog[n] for n in comp}
        strata.append(stratum)
    return strata
