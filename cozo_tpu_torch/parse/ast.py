"""Script-level ASTs: CozoScript variants, sys-ops, imperative statements.

Mirrors reference `parse/mod.rs:50` (CozoScript enum), `parse/sys.rs:30-50`
(SysOp), `parse/mod.rs:75-120` (imperative AST)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from ..data.program import InputProgram


@dataclass
class QueryScript:
    prog: InputProgram


@dataclass
class SysScript:
    op: "SysOp"


@dataclass
class ImperativeScript:
    stmts: List[Any]


# --- sys ops -----------------------------------------------------------------


@dataclass
class SysOp:
    kind: str  # see below
    payload: Dict[str, Any] = field(default_factory=dict)


# kinds:
#   compact, list_relations, list_columns(rel), list_indices(rel),
#   list_fixed_rules, remove_relations(rels), rename_relations(pairs),
#   running, kill(id), explain(prog), access_level(level, rels),
#   describe(rel, text), show_triggers(rel), set_triggers(rel, puts, rms, replaces),
#   create_index(rel, idx, cols), create_hnsw/fts/lsh(rel, idx, opts),
#   drop_index(rel, idx, kind)


# --- index configs (parse/sys.rs:53-98) --------------------------------------


@dataclass
class HnswIndexConfig:
    base_relation: str
    index_name: str
    dim: int
    dtype: str  # F32 | F64
    fields: List[str]
    distance: str  # L2 | Cosine | IP
    ef_construction: int
    m_neighbours: int
    index_filter: Optional[str] = None
    extend_candidates: bool = False
    keep_pruned_connections: bool = False


@dataclass
class FtsIndexConfig:
    base_relation: str
    index_name: str
    extractor: str
    tokenizer: Any
    filters: List[Any] = field(default_factory=list)


@dataclass
class MinHashLshConfig:
    base_relation: str
    index_name: str
    extractor: str
    tokenizer: Any
    filters: List[Any]
    n_gram: int
    n_perm: int
    false_positive_weight: float
    false_negative_weight: float
    target_threshold: float


# --- imperative statements ----------------------------------------------------


@dataclass
class ImperativeQuery:
    prog: InputProgram
    store_as: Optional[str] = None


@dataclass
class ImperativeSysOp:
    op: SysOp
    store_as: Optional[str] = None


@dataclass
class ImperativeIf:
    condition: Any  # str (temp rel name) or ImperativeQuery
    negated: bool
    then_branch: List[Any]
    else_branch: List[Any]


@dataclass
class ImperativeLoop:
    label: Optional[str]
    body: List[Any]


@dataclass
class ImperativeBreak:
    label: Optional[str]


@dataclass
class ImperativeContinue:
    label: Optional[str]


@dataclass
class ImperativeReturn:
    values: List[Any]  # str names or ImperativeQuery


@dataclass
class ImperativeSwap:
    left: str
    right: str


@dataclass
class ImperativeDebug:
    name: str


@dataclass
class ImperativeIgnoreError:
    clause: ImperativeQuery
