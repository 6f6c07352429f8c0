"""Compiled-rule executor + semi-naive fixpoint evaluation.

Mirrors reference `query/{compile.rs,ra.rs,eval.rs}` semantics with one
idiomatic change (SURVEY.md §7.3): evaluation is *set-at-a-time* — each
step transforms a whole batch of binding tuples — so index-search atoms
(HNSW et al.) receive entire batches of query vectors and can run as one
device call instead of a per-row pointer chase.

Semi-naive: epoch 0 evaluates every clause from totals; later epochs run
one variant per changed same-stratum dependency occurrence (delta at that
occurrence, totals elsewhere), falling back to a full re-run when a
changed dependency occurs more than once in a clause
(reference `eval.rs:505-610`)."""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Set, Tuple

from ..data.aggr import get_aggr
from ..data.expr import Binding, Const, Expr
from ..data.program import (
    ExprAtom,
    NegationAtom,
    NormalRule,
    RelationApplyAtom,
    RuleApplyAtom,
    SearchApplyAtom,
    UnificationAtom,
)
from ..data.value import DSet, Validity, cmp_key, fast_key, value_eq
from ..utils.errors import EvalError, QueryError
from .normalize import ConstantRuleSet, FixedRuleSet

# ---------------------------------------------------------------------------
# stores


class MemoStore:
    """Set-semantics store with epoch deltas (reference EpochStore,
    `runtime/temp_store.rs:249-336`)."""

    __slots__ = ("total", "delta", "new", "_indexes", "presorted",
                 "_sorted", "_no_sort")

    def __init__(self) -> None:
        self.total: Dict[tuple, list] = {}
        self.delta: Dict[tuple, list] = {}
        self.new: Dict[tuple, list] = {}
        self._indexes: Dict[tuple, dict] = {}
        # set by fill_bulk: rows already in cmp_key order (skip output sort)
        self.presorted = False
        # cached sorted-row lists [total, delta]; reference stores are
        # BTreeMaps, so scans must yield rows in cmp_key order (matters
        # for order-sensitive aggregations: collect/choice/shortest)
        self._sorted: List[Optional[list]] = [None, None]
        self._no_sort = False

    def fill_bulk(self, rows: List[list], distinct: bool, presorted: bool) -> None:
        """Bulk-load a one-shot result (fixed rules emit millions of rows;
        per-row cmp_key dedup costs ~15µs/row). When the producer
        guarantees distinctness, keys are positional — joins via
        index_for/rows() are unaffected, and nothing ever put_new()s into
        a fixed rule's store after it runs."""
        if distinct:
            self.total = dict(enumerate(rows))
        else:
            self.total = {self.key_of(r): r for r in rows}
        self.delta = self.total
        self.presorted = presorted
        self._sorted = [None, None]
        # positional int keys: insertion order already ascending; cmp_key
        # sorting of bulk fixed-rule output would cost O(n log n) at 69M
        self._no_sort = True

    def key_of(self, row: Sequence[Any]) -> tuple:
        return tuple(cmp_key(v) for v in row)

    def put_new(self, row: list) -> None:
        k = self.key_of(row)
        if k not in self.total:
            self.new[k] = row

    def put_new_many(self, rows) -> None:
        """Bulk put_new: hoists the method dispatch + key construction
        out of the per-row epoch loop (the entry store takes 40K+ rows
        per vector-pivot join batch)."""
        ko = self.key_of
        total = self.total
        new = self.new
        for row in rows:
            k = ko(row)
            if k not in total:
                new[k] = list(row)

    def exists(self, row) -> bool:
        return self.key_of(row) in self.total or self.key_of(row) in self.new

    def merge_epoch(self) -> bool:
        self.delta = self.new
        self.new = {}
        self.total.update(self.delta)
        self._indexes.clear()
        self._sorted = [None, None]
        return bool(self.delta)

    def rows(self, delta: bool):
        d = self.delta if delta else self.total
        if self._no_sort:
            return d.values()
        i = 1 if delta else 0
        c = self._sorted[i]
        if c is None:
            c = [d[k] for k in sorted(d.keys())]
            self._sorted[i] = c
        return c

    def index_for(self, positions: Tuple[int, ...], delta: bool) -> dict:
        key = (positions, delta)
        idx = self._indexes.get(key)
        if idx is None or delta:
            idx = {}
            for row in self.rows(delta):
                k = tuple(cmp_key(row[p]) for p in positions)
                idx.setdefault(k, []).append(row)
            if not delta:
                self._indexes[key] = idx
        return idx


class FastEntryStore(MemoStore):
    """MemoStore for the entry rule ('?') only: dedup keys come from
    `fast_key` (equality-exact, order-free — ~10x cheaper than cmp_key's
    per-value bit twiddling, which dominated the vector-pivot join's host
    time at 4096x10 result rows).  Valid ONLY for '?' because nothing ever
    scans the entry store as a dependency — the Db imposes value order on
    the final rows itself (runtime/db.py output sort), so rows() may
    yield insertion order."""

    __slots__ = ()

    def key_of(self, row: Sequence[Any]) -> tuple:
        return tuple(map(fast_key, row))

    def put_new_many(self, rows) -> None:
        # rows stay tuples: nothing mutates entry-store rows, and the Db
        # copies to lists at output
        total = self.total
        new = self.new
        fk = fast_key
        for row in rows:
            k = tuple(map(fk, row))
            if k not in total:
                new[k] = row

    def rows(self, delta: bool):
        # fast keys are not mutually orderable; insertion order is fine
        # for the only consumer (db output, which sorts by value order)
        return (self.delta if delta else self.total).values()


class MeetStore(MemoStore):
    """Grouped store with in-place monotone (meet) aggregation
    (reference MeetAggrStore, `runtime/temp_store.rs:92`)."""

    __slots__ = ("aggr_specs", "group_pos", "aggr_pos", "groups")

    def __init__(self, aggrs: List[Optional[Any]]) -> None:
        super().__init__()
        # aggrs: per head position, None or (Aggregation, extra_args)
        self.aggr_specs = aggrs
        self.group_pos = [i for i, a in enumerate(aggrs) if a is None]
        self.aggr_pos = [i for i, a in enumerate(aggrs) if a is not None]
        self.groups: Dict[tuple, list] = {}

    def meet_new(self, row: list) -> None:
        gk = tuple(cmp_key(row[p]) for p in self.group_pos)
        cur = self.groups.get(gk)
        if cur is None:
            newrow = list(row)
            for p in self.aggr_pos:
                aggr, extra = self.aggr_specs[p]
                val, _ = aggr.meet_update(None, row[p])
                newrow[p] = val
            self.groups[gk] = newrow
            self.new[self.key_of(newrow)] = newrow
            return
        changed = False
        for p in self.aggr_pos:
            aggr, extra = self.aggr_specs[p]
            val, ch = aggr.meet_update(cur[p], row[p])
            if ch:
                cur[p] = val
                changed = True
        if changed:
            self.new[self.key_of(cur)] = cur

    def merge_epoch(self) -> bool:
        # groups already hold the merged state; rebuild total from groups
        self.delta = {}
        for k, row in self.new.items():
            self.delta[self.key_of(row)] = row
        self.new = {}
        self.total = {self.key_of(r): r for r in self.groups.values()}
        self._indexes.clear()
        self._sorted = [None, None]
        return bool(self.delta)


# ---------------------------------------------------------------------------
# compiled steps

CONST = 0
BOUND = 1
FRESH = 2


def _classify_args(args, binding_map: Dict[str, int]):
    """Per arg: (CONST, value) | (BOUND, env_pos) | (FRESH, new_pos)."""
    spec = []
    for a in args:
        if a is None:
            spec.append((None, None))
        elif isinstance(a, Const):
            spec.append((CONST, a.val))
        elif isinstance(a, str):
            if a in binding_map:
                spec.append((BOUND, binding_map[a]))
            else:
                pos = len(binding_map)
                binding_map[a] = pos
                spec.append((FRESH, pos))
        else:
            raise QueryError(f"uncanonicalized arg {a!r}")
    return spec


class Step:
    def run(self, envs: List[tuple], ctx: "EvalContext", delta: bool) -> List[tuple]:
        raise NotImplementedError

    store_dep: Optional[str] = None


class StepRuleScan(Step):
    """Join against a memo store (another rule's results)."""

    def __init__(self, name: str, spec) -> None:
        self.name = name
        self.spec = spec
        self.store_dep = name
        self.const_pos = [(i, v) for i, (k, v) in enumerate(spec) if k == CONST]
        self.bound = [(i, p) for i, (k, p) in enumerate(spec) if k == BOUND]
        self.fresh = [(i, p) for i, (k, p) in enumerate(spec) if k == FRESH]

    def run(self, envs, ctx, delta):
        store = ctx.stores[self.name]
        out = []
        fresh = self.fresh
        if not self.bound:
            rows = []
            for row in store.rows(delta):
                if all(value_eq(row[i], v) for i, v in self.const_pos):
                    rows.append(row)
            for env in envs:
                ctx.tick(len(rows))
                for row in rows:
                    out.append(env + tuple(row[i] for i, _ in fresh))
            return out
        positions = tuple(i for i, _ in self.bound)
        idx = store.index_for(positions, delta)
        cpos = self.const_pos
        for env in envs:
            ctx.tick()
            k = tuple(cmp_key(env[p]) for _, p in self.bound)
            for row in idx.get(k, ()):
                if cpos and not all(value_eq(row[i], v) for i, v in cpos):
                    continue
                out.append(env + tuple(row[i] for i, _ in fresh))
        return out


class StepStoredScan(Step):
    """Scan/join a stored relation, using key-prefix range scans where the
    leading key columns are constants or bound vars."""

    def __init__(self, handle, spec, vld_expr: Optional[Expr], binding_map) -> None:
        self.handle = handle
        self.spec = spec  # one entry per relation column (may be (None, None))
        self.vld_expr = vld_expr
        # (lo, lo_incl, hi, hi_incl) range hint on the first fresh key column
        self.bounds = None
        nk = handle.key_arity
        # longest key prefix of consts/bound vars usable as scan prefix
        self.n_prefix = 0
        for i in range(nk):
            k, _ = spec[i]
            if k in (CONST, BOUND):
                self.n_prefix += 1
            else:
                break
        if vld_expr is not None and not handle.has_validity():
            raise QueryError(
                f"relation '{handle.name}' has no validity column for time travel"
            )
        self.post = [
            (i, kv)
            for i, kv in enumerate(spec)
            if i >= self.n_prefix and kv[0] in (CONST, BOUND)
        ]
        self.fresh = [(i, p) for i, (k, p) in enumerate(spec) if k == FRESH]

    def _prefix_vals(self, env):
        vals = []
        for i in range(self.n_prefix):
            k, v = self.spec[i]
            vals.append(v if k == CONST else env[v])
        return vals

    def run(self, envs, ctx, delta):
        handle = self.handle
        tx = ctx.tx.store_tx_for(handle)
        out = []
        vld_ts = None
        if self.vld_expr is not None:
            vld_ts = ctx.eval_vld(self.vld_expr)
        # group envs by prefix values to share scans
        groups: Dict[tuple, list] = {}
        for env in envs:
            pv = self._prefix_vals(env)
            groups.setdefault(tuple(cmp_key(v) for v in pv), (pv, []))[1].append(env)
        for _, (pv, genvs) in groups.items():
            if vld_ts is not None:
                rows = list(handle.scan_at_validity(tx, pv, vld_ts))
            elif self.bounds is not None:
                lo, lo_i, hi, hi_i = self.bounds
                rows = list(handle.scan_bounded(tx, pv, lo, lo_i, hi, hi_i))
            elif pv:
                rows = list(handle.scan_prefix(tx, pv))
            else:
                rows = list(handle.scan_all(tx))
            for env in genvs:
                ctx.tick(len(rows))
                for row in rows:
                    ok = True
                    for i, (k, v) in self.post:
                        want = v if k == CONST else env[v]
                        if not value_eq(row[i], want):
                            ok = False
                            break
                    if ok:
                        out.append(env + tuple(row[i] for i, _ in self.fresh))
        return out


class StepNegation(Step):
    """Absence probe; all vars are pre-bound (safe negation)."""

    def __init__(self, target_kind: str, name_or_handle, spec) -> None:
        self.kind = target_kind  # "rule" | "stored"
        self.target = name_or_handle
        self.spec = spec
        self.probe = [(i, kv) for i, kv in enumerate(spec) if kv[0] is not None]
        if self.kind == "stored":
            nk = name_or_handle.key_arity
            self.n_prefix = 0
            for i in range(nk):
                if i < len(spec) and spec[i][0] in (CONST, BOUND):
                    self.n_prefix += 1
                else:
                    break

    def run(self, envs, ctx, delta):
        out = []
        if self.kind == "rule":
            store = ctx.stores[self.target]
            positions = tuple(i for i, _ in self.probe)
            idx = store.index_for(positions, False)
            for env in envs:
                k = tuple(
                    cmp_key(v if kk == CONST else env[v])
                    for _, (kk, v) in self.probe
                )
                if k not in idx:
                    out.append(env)
            return out
        handle = self.target
        tx = ctx.tx.store_tx_for(handle)
        for env in envs:
            pv = []
            for i in range(self.n_prefix):
                k, v = self.spec[i]
                pv.append(v if k == CONST else env[v])
            found = False
            for row in handle.scan_prefix(tx, pv):
                ok = True
                for i, (k, v) in self.probe:
                    want = v if k == CONST else env[v]
                    if not value_eq(row[i], want):
                        ok = False
                        break
                if ok:
                    found = True
                    break
            if not found:
                out.append(env)
        return out


class StepUnify(Step):
    def __init__(self, var: str, expr: Expr, one_many: bool, binding_map) -> None:
        self.expr = expr
        self.one_many = one_many
        if var in binding_map:
            self.mode = "check"
            self.pos = binding_map[var]
        else:
            self.mode = "bind"
            self.pos = len(binding_map)
            binding_map[var] = self.pos

    def run(self, envs, ctx, delta):
        out = []
        ev = self.expr.eval
        if self.one_many:
            for env in envs:
                vals = ev(env)
                if isinstance(vals, (list, DSet)):
                    items = list(vals)
                elif isinstance(vals, bytes):
                    items = [bytes([b]) for b in vals]
                else:
                    raise EvalError(
                        f"right-hand side of 'in' must be a list, got {vals!r}"
                    )
                if self.mode == "bind":
                    for v in items:
                        out.append(env + (v,))
                else:
                    cur = env[self.pos]
                    for v in items:
                        if value_eq(cur, v):
                            out.append(env)
                            break
            return out
        for env in envs:
            v = ev(env)
            if self.mode == "bind":
                out.append(env + (v,))
            elif value_eq(env[self.pos], v):
                out.append(env)
        return out


class StepFilter(Step):
    def __init__(self, expr: Expr) -> None:
        self.expr = expr

    def run(self, envs, ctx, delta):
        ev = self.expr.eval
        out = []
        for env in envs:
            ctx.tick()
            v = ev(env)
            if v is True:
                out.append(env)
            elif v is not False and v is not None:
                raise EvalError(f"filter expression must be boolean, got {v!r}")
        return out


class StepSearch(Step):
    """Index search (HNSW/FTS/LSH): batched over the whole env set."""

    def __init__(self, impl, params) -> None:
        self.impl = impl  # callable(envs, params, ctx) -> list[envs]
        self.params = params

    def run(self, envs, ctx, delta):
        return self.impl(envs, self.params, ctx)


# ---------------------------------------------------------------------------
# clause compilation


class CompiledClause:
    def __init__(
        self,
        steps: List[Step],
        head_pos: List[int],
        aggrs: List[Optional[Tuple[Any, list]]],
        contained: Dict[str, int],
    ) -> None:
        self.steps = steps
        self.head_pos = head_pos
        self.aggrs = aggrs
        self.contained = contained  # same-stratum store name → occurrence count

    def eval(self, ctx: "EvalContext", delta_at: Optional[int]) -> List[tuple]:
        envs: List[tuple] = [()]
        for i, step in enumerate(self.steps):
            envs = step.run(envs, ctx, delta=(i == delta_at))
            if not envs:
                return []
        hp = self.head_pos
        if hp == list(range(len(envs[0]))):
            return envs  # identity projection: envs are already tuples
        if len(hp) > 1:
            from operator import itemgetter

            return list(map(itemgetter(*hp), envs))
        return [(env[hp[0]],) for env in envs]


def compile_clause(
    rule: NormalRule, ctx: "EvalContext", same_stratum: Set[str]
) -> CompiledClause:
    binding_map: Dict[str, int] = {}
    steps: List[Step] = []
    contained: Dict[str, int] = {}
    for atom in rule.body:
        if isinstance(atom, RuleApplyAtom):
            if atom.name in ctx.stores or atom.name in ctx.rule_names:
                spec = _classify_args(atom.args, binding_map)
                steps.append(StepRuleScan(atom.name, spec))
                if atom.name in same_stratum:
                    contained[atom.name] = contained.get(atom.name, 0) + 1
            elif atom.name.startswith("_"):
                handle = ctx.tx.get_relation(atom.name)
                if handle.arity != len(atom.args):
                    raise QueryError(
                        f"arity mismatch for '{atom.name}': expected "
                        f"{handle.arity}, got {len(atom.args)}"
                    )
                spec = _classify_args(atom.args, binding_map)
                steps.append(StepStoredScan(handle, spec, None, binding_map))
            else:
                raise QueryError(
                    f"rule '{atom.name}' not found", code="eval::rule_not_found"
                )
        elif isinstance(atom, RelationApplyAtom):
            handle = ctx.tx.get_relation(atom.name)
            handle.ensure_can_read()
            args = _rel_args_positional(atom, handle)
            scan_steps = _compile_stored_scan(
                ctx, handle, args, atom.validity, binding_map, rule.body
            )
            steps.extend(scan_steps)
        elif isinstance(atom, SearchApplyAtom):
            steps.append(ctx.compile_search(atom, binding_map))
        elif isinstance(atom, UnificationAtom):
            expr = atom.expr.clone()  # clauses share parsed Expr nodes
            expr.fill_binding_indices(binding_map)
            steps.append(StepUnify(atom.var, expr, atom.one_many, binding_map))
        elif isinstance(atom, ExprAtom):
            expr = atom.expr.clone().fold_const()
            expr.fill_binding_indices(binding_map)
            steps.append(StepFilter(expr))
        elif isinstance(atom, NegationAtom):
            inner = atom.inner

            def _neg_spec(args):
                # classify against a COPY: unbound (wildcard) vars inside
                # a negation are existential — they must not claim env
                # positions, and the probe skips them entirely
                spec = _classify_args(args, dict(binding_map))
                return [
                    (None, None) if k == FRESH else (k, v) for k, v in spec
                ]

            if isinstance(inner, RuleApplyAtom):
                if inner.name in ctx.stores or inner.name in ctx.rule_names:
                    spec = _neg_spec(inner.args)
                    steps.append(StepNegation("rule", inner.name, spec))
                else:
                    handle = ctx.tx.get_relation(inner.name)
                    spec = _neg_spec(
                        list(inner.args)
                        + [None] * (handle.arity - len(inner.args))
                    )
                    steps.append(StepNegation("stored", handle, spec))
            else:
                handle = ctx.tx.get_relation(inner.name)
                handle.ensure_can_read()
                args = _rel_args_positional(inner, handle)
                spec = _neg_spec(args)
                steps.append(StepNegation("stored", handle, spec))
        else:
            raise QueryError(f"cannot compile atom {atom!r}")
    head_pos = []
    for h in rule.head:
        if h not in binding_map:
            raise QueryError(f"head variable '{h}' unbound")
        head_pos.append(binding_map[h])
    aggrs = []
    for a in rule.aggrs:
        if a is None:
            aggrs.append(None)
        else:
            aggrs.append((get_aggr(a.name), a.extra_args))
    return CompiledClause(steps, head_pos, aggrs, contained)


def _derive_bounds(scan: StepStoredScan, args, body_atoms):
    """Derive a range hint for the first fresh key column from filter
    atoms (simplified reference compute_bounds, expr.rs:660)."""
    from .normalize import ConstantRuleSet  # noqa: F401 (avoid cycle warnings)
    from ..data.expr import compute_single_bound

    i = scan.n_prefix
    if i >= scan.handle.key_arity or i >= len(args):
        return
    var = args[i]
    if not isinstance(var, str):
        return
    lo, lo_i, hi, hi_i = None, True, None, True
    for a in body_atoms:
        if not isinstance(a, ExprAtom):
            continue
        expr = a.expr.clone().fold_const()
        sub = compute_single_bound(expr, var)
        if sub is None:
            continue
        slo, slo_i, shi, shi_i = sub
        if slo is not None and (lo is None or cmp_key(slo) > cmp_key(lo)):
            lo, lo_i = slo, slo_i
        if shi is not None and (hi is None or cmp_key(shi) < cmp_key(hi)):
            hi, hi_i = shi, shi_i
    if lo is not None or hi is not None:
        scan.bounds = (lo, lo_i, hi, hi_i)


def _compile_stored_scan(ctx, handle, args, vld_expr, binding_map, body_atoms):
    """Pick the best access path: base-key prefix scan, or a lateral index
    whose leading columns are better bound (reference choose_index,
    relation.rs:196-246), with an optional point-get back to the base."""
    nk = handle.key_arity

    def is_bound(a):
        return isinstance(a, Const) or (isinstance(a, str) and a in binding_map)

    base_prefix = 0
    for i in range(nk):
        if i < len(args) and args[i] is not None and is_bound(args[i]):
            base_prefix += 1
        else:
            break

    best = None
    if vld_expr is None:
        for idx_name, meta in handle.indices.items():
            if meta.get("kind") != "normal":
                continue
            order = list(meta["positions"]) + list(range(nk))
            p = 0
            for bp in order:
                if bp < len(args) and args[bp] is not None and is_bound(args[bp]):
                    p += 1
                else:
                    break
            if p > base_prefix and (best is None or p > best[2]):
                best = (idx_name, order, p)

    if best is None:
        spec = _classify_args(args, binding_map)
        scan = StepStoredScan(handle, spec, vld_expr, binding_map)
        _derive_bounds(scan, args, body_atoms)
        return [scan]

    idx_name, order, _p = best
    idx_handle = ctx.tx.get_relation(f"{handle.name}:{idx_name}")

    def key_arg(i):
        # unreferenced base keys get fresh vars bound by the index row so
        # the base point-get below is fully keyed
        a = args[i]
        if a is None:
            a = f"*ix{id(idx_handle)}_{i}"
            args[i] = a
        return a

    # index relation columns: chosen cols, then all base keys
    idx_args = [
        (args[bp] if bp < len(args) else None)
        for bp in handle.indices[idx_name]["positions"]
    ]
    for i in range(nk):
        idx_args.append(key_arg(i))
    idx_spec = _classify_args(idx_args, binding_map)
    steps = [StepStoredScan(idx_handle, idx_spec, None, binding_map)]
    # covering check: every referenced base column available from the index?
    idx_base_cols = set(handle.indices[idx_name]["positions"]) | set(range(nk))
    referenced = {i for i, a in enumerate(args) if a is not None}
    if not referenced <= idx_base_cols:
        base_args = []
        for i, a in enumerate(args):
            if i < nk:
                base_args.append(key_arg(i))
            elif i in idx_base_cols and isinstance(a, str):
                # already bound by the index row; keep as equality check
                base_args.append(a)
            else:
                base_args.append(a)
        base_spec = _classify_args(base_args, binding_map)
        steps.append(StepStoredScan(handle, base_spec, None, binding_map))
    return steps


def _rel_args_positional(atom: RelationApplyAtom, handle) -> list:
    if atom.args is not None:
        arity = handle.arity
        if handle.has_validity() and len(atom.args) == arity - 1 and atom.validity is not None:
            return list(atom.args) + [None]
        if len(atom.args) != arity:
            raise QueryError(
                f"arity mismatch for relation '{handle.name}': expected "
                f"{arity}, got {len(atom.args)}"
            )
        return list(atom.args)
    cols = handle.col_names()
    by_col = dict(atom.pairs)
    unknown = set(by_col) - set(cols)
    if unknown:
        raise QueryError(
            f"columns {sorted(unknown)} not found in relation '{handle.name}'"
        )
    return [by_col.get(c) for c in cols]


# ---------------------------------------------------------------------------
# stratified evaluation


class EvalContext:
    def __init__(self, tx, fixed_rules, poison=None, search_compiler=None,
                 db=None) -> None:
        self.db = db
        self.tx = tx
        self.stores: Dict[str, MemoStore] = {}
        self.rule_names: Set[str] = set()
        self.fixed_rules = fixed_rules
        self.poison = poison
        self._search_compiler = search_compiler
        self._tick = 0

    def check_poison(self):
        if self.poison is not None:
            self.poison.check()

    def tick(self, n: int = 1):
        """Cheap periodic poison check inside hot step loops
        (reference checks Poison per batch, db.rs:1926)."""
        self._tick += n
        if self._tick >= 16384:
            self._tick = 0
            if self.poison is not None:
                self.poison.check()

    def eval_vld(self, expr: Expr) -> int:
        e = expr.fold_const()
        if not isinstance(e, Const):
            raise QueryError("validity specification must be a constant")
        v = e.val
        from ..data.functions import current_validity_ts, str2vld

        if isinstance(v, Validity):
            return v.ts
        if isinstance(v, bool):
            raise QueryError(f"bad validity specification {v!r}")
        if isinstance(v, int):
            return v
        if isinstance(v, float):
            return int(v * 1_000_000)
        if isinstance(v, str):
            if v == "NOW":
                return self.tx.cur_vld
            if v == "END":
                return (1 << 63) - 1
            return str2vld(v)
        raise QueryError(f"bad validity specification {v!r}")

    def compile_search(self, atom: SearchApplyAtom, binding_map):
        if self._search_compiler is None:
            raise QueryError("index search is not available in this context")
        return self._search_compiler(atom, binding_map, self)


def evaluate_strata(
    strata: List[Dict[str, Any]],
    ctx: EvalContext,
    limit_hint: Optional[int] = None,
) -> None:
    for name_set in strata:
        ctx.rule_names.update(name_set.keys())
    for stratum in strata:
        _eval_stratum(stratum, ctx, limit_hint)


def _limit_reached(ctx, limit_hint) -> bool:
    """Early return once the entry store holds enough rows
    (reference QueryLimiter, eval.rs:33-62; only engaged when the caller
    determined no sorting/mutation follows)."""
    if limit_hint is None:
        return False
    store = ctx.stores.get("?")
    return store is not None and len(store.total) + len(store.new) >= limit_hint


def _eval_stratum(stratum: Dict[str, Any], ctx: EvalContext, limit_hint) -> None:
    same = set(stratum)
    # create stores
    for name, rs in stratum.items():
        if isinstance(rs, (ConstantRuleSet, FixedRuleSet)):
            ctx.stores[name] = MemoStore()
        else:
            aggrs0 = rs.rules[0].aggrs
            if any(a is not None for a in aggrs0) and all(
                a is None or get_aggr(a.name).is_meet for a in aggrs0
            ):
                specs = [
                    None if a is None else (get_aggr(a.name), a.extra_args)
                    for a in aggrs0
                ]
                ctx.stores[name] = MeetStore(specs)
            elif name == "?" and all(a is None for a in aggrs0):
                # entry store with plain rules: nothing scans '?', the Db
                # sorts output itself — cheap equality-only dedup keys
                ctx.stores[name] = FastEntryStore()
            else:
                ctx.stores[name] = MemoStore()

    compiled: Dict[str, List[CompiledClause]] = {}
    kind: Dict[str, str] = {}
    for name, rs in stratum.items():
        if isinstance(rs, ConstantRuleSet):
            kind[name] = "const"
        elif isinstance(rs, FixedRuleSet):
            kind[name] = "fixed"
        else:
            aggrs0 = rs.rules[0].aggrs
            if all(a is None for a in aggrs0):
                kind[name] = "plain"
            elif all(a is None or get_aggr(a.name).is_meet for a in aggrs0):
                kind[name] = "meet"
            else:
                kind[name] = "aggr"
            compiled[name] = [compile_clause(r, ctx, same) for r in rs.rules]

    # --- epoch 0
    for name, rs in stratum.items():
        ctx.check_poison()
        store = ctx.stores[name]
        k = kind[name]
        if k == "const":
            for row in rs.rows:
                store.put_new(list(row))
        elif k == "fixed":
            _run_fixed(name, rs, ctx)
        elif k == "plain":
            for clause in compiled[name]:
                store.put_new_many(clause.eval(ctx, None))
                if name == "?" and _limit_reached(ctx, limit_hint):
                    break
        elif k == "meet":
            for clause in compiled[name]:
                for row in clause.eval(ctx, None):
                    store.meet_new(list(row))
            _meet_empty_case(rs, store)
        else:  # normal aggr
            _eval_aggr_rule(compiled[name], rs, store, ctx)

    changed = False
    for name in stratum:
        if ctx.stores[name].merge_epoch():
            changed = True

    # --- fixpoint epochs
    while changed:
        ctx.check_poison()
        if "?" in stratum and _limit_reached(ctx, limit_hint):
            break
        for name, rs in stratum.items():
            k = kind[name]
            if k in ("const", "fixed", "aggr"):
                continue
            store = ctx.stores[name]
            put = store.meet_new if k == "meet" else store.put_new
            for clause in compiled[name]:
                deps_changed = {
                    dep: cnt
                    for dep, cnt in clause.contained.items()
                    if ctx.stores[dep].delta
                }
                if not deps_changed:
                    continue
                if any(cnt > 1 for cnt in deps_changed.values()):
                    for row in clause.eval(ctx, None):
                        put(list(row))
                    continue
                for i, step in enumerate(clause.steps):
                    dep = getattr(step, "store_dep", None)
                    if dep in deps_changed:
                        for row in clause.eval(ctx, i):
                            put(list(row))
        changed = False
        for name in stratum:
            if ctx.stores[name].merge_epoch():
                changed = True


def _meet_empty_case(rs, store: MeetStore) -> None:
    aggrs0 = rs.rules[0].aggrs
    if store.groups or not all(a is not None for a in aggrs0):
        return
    row = []
    for a in aggrs0:
        aggr = get_aggr(a.name)
        acc = aggr.make(a.extra_args)
        row.append(acc.get())
    store.new[store.key_of(row)] = row
    store.groups[()] = row


def _eval_aggr_rule(clauses, rs, store: MemoStore, ctx) -> None:
    aggrs0 = rs.rules[0].aggrs
    key_idx = [i for i, a in enumerate(aggrs0) if a is None]
    val_idx = [i for i, a in enumerate(aggrs0) if a is not None]
    work: Dict[tuple, tuple] = {}
    for clause in clauses:
        for row in clause.eval(ctx, None):
            gk = tuple(cmp_key(row[i]) for i in key_idx)
            ent = work.get(gk)
            if ent is None:
                accs = []
                for i in val_idx:
                    aggr, extra = clause.aggrs[i]
                    accs.append(aggr.make(extra))
                work[gk] = (tuple(row[i] for i in key_idx), accs)
                ent = work[gk]
            for j, i in enumerate(val_idx):
                ent[1][j].set(row[i])
    if not work and not key_idx:
        row = []
        for i in val_idx:
            a = aggrs0[i]
            row.append(get_aggr(a.name).make(a.extra_args).get())
        store.put_new(row)
        return
    for gk, (keys, accs) in work.items():
        row: list = [None] * len(aggrs0)
        for j, i in enumerate(key_idx):
            row[i] = keys[j]
        for j, i in enumerate(val_idx):
            row[i] = accs[j].get()
        store.put_new(row)


def _run_fixed(name: str, rs: FixedRuleSet, ctx: EvalContext) -> None:
    apply = rs.apply
    impl = ctx.fixed_rules.get(apply.fixed_name)
    if impl is None:
        raise QueryError(
            f"fixed rule '{apply.fixed_name}' not found",
            code="eval::fixed_rule_not_found",
        )
    from .fixed_payload import FixedRulePayload

    payload = FixedRulePayload(apply, ctx)
    arity = impl.arity(apply.options, apply.head)
    if apply.head and arity is not None and len(apply.head) != arity:
        raise QueryError(
            f"fixed rule '{apply.fixed_name}' returns {arity} columns, "
            f"but head has {len(apply.head)}"
        )
    store = ctx.stores[name]

    run_bulk = getattr(impl, "run_bulk", None)
    if run_bulk is not None:
        out = run_bulk(payload, ctx.poison)
        if out is not None:
            rows, distinct, presorted = out
            store.fill_bulk(rows, distinct, presorted)
            return

    def out_put(row):
        store.put_new(list(row))

    impl.run(payload, out_put, ctx.poison)
