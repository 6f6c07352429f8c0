"""Program ASTs — the IR pipeline of the query engine.

Mirrors the reference `cozo-core/src/data/program.rs`:
InputProgram (parsed) → NormalFormProgram (DNF'd, safety-reordered) →
StratifiedProgram (list of strata).  Search atoms (`~rel:idx{...}`) are
lowered here too (`SearchInput.normalize_*`, program.rs:1034,1341).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from .expr import Expr


# --- atoms (rule bodies) -----------------------------------------------------


@dataclass
class RuleApplyAtom:
    """`name[args...]` — application of another rule or a temp relation."""

    name: str
    args: List[Expr]


@dataclass
class RelationApplyAtom:
    """`*rel[args...]` or `*rel{col: expr, ...}` — stored relation scan."""

    name: str
    args: Optional[List[Expr]] = None  # positional form
    pairs: Optional[List[Tuple[str, Expr]]] = None  # named form
    validity: Optional[Expr] = None


@dataclass
class SearchApplyAtom:
    """`~rel:idx{bindings | opts}` — index search (HNSW / FTS / LSH)."""

    rel: str
    idx: str
    pairs: List[Tuple[str, Expr]]
    opts: Dict[str, Expr]


@dataclass
class UnificationAtom:
    """`var = expr` (one) or `var in expr` (iterate list)."""

    var: str
    expr: Expr
    one_many: bool = False  # True for `in`


@dataclass
class NegationAtom:
    inner: Any  # atom


@dataclass
class ExprAtom:
    expr: Expr


@dataclass
class ConjunctionAtom:
    inner: List[Any]


@dataclass
class DisjunctionAtom:
    inner: List[Any]


# --- rules -------------------------------------------------------------------


@dataclass
class AggrSpec:
    name: str
    extra_args: List[Any]  # evaluated const exprs


@dataclass
class InputRule:
    head: List[str]  # head variable names
    aggrs: List[Optional[AggrSpec]]  # per head position
    body: List[Any]  # atoms (each a disjunction at top level)


@dataclass
class ConstRule:
    """`head <- expr` — inline constant data."""

    head: List[str]
    data: Any  # Expr producing list of lists (evaluated at parse finish)


@dataclass
class FixedRuleArg:
    pass


@dataclass
class FixedRuleRuleArg(FixedRuleArg):
    name: str
    bindings: List[str]


@dataclass
class FixedRuleRelArg(FixedRuleArg):
    name: str
    bindings: List[str]
    validity: Optional[Expr] = None


@dataclass
class FixedRuleNamedRelArg(FixedRuleArg):
    name: str
    pairs: List[Tuple[str, Optional[str]]]  # (col, binding-name or None)
    validity: Optional[Expr] = None
    # constant equality pins `{layer: 0, fr_id, to_id}` — filter rows to
    # col == const without emitting the column (extension over the
    # reference's NamedStored bindings, fixed_rule/mod.rs:229; enables
    # prefix scans and the HNSW proximity-graph fast staging)
    pins: List[Tuple[str, Any]] = field(default_factory=list)


@dataclass
class FixedRuleApply:
    fixed_name: str
    head: List[str]
    inputs: List[FixedRuleArg]
    options: Dict[str, Any]  # name -> const value (evaluated)


# --- out options -------------------------------------------------------------

RELATION_OPS = (
    "create",
    "replace",
    "put",
    "insert",
    "update",
    "rm",
    "delete",
    "ensure",
    "ensure_not",
)


@dataclass
class ColSpec:
    name: str
    typing: Any = None  # ColType or None (Any?)
    default: Optional[Tuple[Expr, str]] = None  # (expr, source text)
    gen_binding: Optional[str] = None  # `= out_var` form


@dataclass
class TableSchema:
    keys: List[ColSpec]
    values: List[ColSpec]


@dataclass
class StoreRelation:
    op: str  # one of RELATION_OPS
    name: str
    schema: Optional[TableSchema] = None


@dataclass
class QueryOutOptions:
    limit: Optional[int] = None
    offset: Optional[int] = None
    timeout: Optional[float] = None
    sleep: Optional[float] = None
    sorters: List[Tuple[str, bool]] = field(default_factory=list)  # (var, desc)
    store_relation: Optional[StoreRelation] = None
    assert_none: bool = False
    assert_some: bool = False
    returning: bool = False
    disable_magic_rewrite: bool = False


@dataclass
class InputProgram:
    rules: Dict[str, List[Any]] = field(default_factory=dict)  # name → rule list
    out_opts: QueryOutOptions = field(default_factory=QueryOutOptions)

    def entry_arity(self) -> Optional[int]:
        rs = self.rules.get("?")
        if not rs:
            return None
        r = rs[0]
        if isinstance(r, (InputRule, ConstRule)):
            return len(r.head)
        if isinstance(r, FixedRuleApply):
            return len(r.head) if r.head else None
        return None


# --- normal form -------------------------------------------------------------


@dataclass
class NormalRule:
    """One DNF'd, safety-ordered rule: flat list of positive/negative atoms."""

    head: List[str]
    aggrs: List[Optional[AggrSpec]]
    body: List[Any]  # flat atoms, reordered for safety


@dataclass
class NormalRuleSet:
    rules: List[NormalRule]


@dataclass
class FixedRuleSet:
    apply: FixedRuleApply


@dataclass
class NormalFormProgram:
    # name → NormalRuleSet | FixedRuleSet
    prog: Dict[str, Any] = field(default_factory=dict)


@dataclass
class StratifiedProgram:
    strata: List[NormalFormProgram]
    # per-stratum: store names whose lifetime ends after that stratum
    expendable: List[List[str]] = field(default_factory=list)
