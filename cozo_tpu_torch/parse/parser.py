"""Recursive-descent + Pratt parser for CozoScript.

Covers the full grammar of the reference (`cozo-core/src/cozoscript.pest`):
query scripts (rules / const rules / fixed rules / options), sys scripts,
and imperative scripts.  Parameters (`$x`) are substituted at parse time
(reference `parse/expr.rs:186-200`); `if`/`cond` lower to Cond nodes
(`parse/expr.rs:313-379`)."""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

from ..data.expr import Apply, Binding, Cond, Const, Expr, UnboundApply
from ..data.functions import get_op
from ..data.program import (
    AggrSpec,
    ColSpec,
    ConstRule,
    DisjunctionAtom,
    ExprAtom,
    FixedRuleApply,
    FixedRuleNamedRelArg,
    FixedRuleRelArg,
    FixedRuleRuleArg,
    InputProgram,
    InputRule,
    NegationAtom,
    QueryOutOptions,
    RelationApplyAtom,
    RuleApplyAtom,
    SearchApplyAtom,
    StoreRelation,
    TableSchema,
    UnificationAtom,
)
from ..data.relation_types import ColType
from ..utils.errors import ParseError
from . import ast as A
from .lexer import EOF, FLOAT, INT, NAME, PARAM, PUNCT, STR, Token, tokenize

# precedence (higher binds tighter); ops are left-assoc except ^
_INFIX_PREC = {
    "||": (1, "or"),
    "&&": (2, "and"),
    ">": (3, "gt"),
    "<": (3, "lt"),
    ">=": (3, "ge"),
    "<=": (3, "le"),
    "==": (4, "eq"),
    "!=": (4, "neq"),
    "%": (5, "mod"),
    "+": (6, "add"),
    "-": (6, "sub"),
    "++": (6, "concat"),
    "*": (7, "mul"),
    "/": (7, "div"),
    "^": (8, "pow"),
    "~": (9, "coalesce"),
}
_RIGHT_ASSOC = {"^"}

_AGGR_NAMES = None  # filled lazily from aggr module


def _is_aggr(name: str) -> bool:
    global _AGGR_NAMES
    if _AGGR_NAMES is None:
        from ..data.aggr import AGGR_REGISTRY

        _AGGR_NAMES = set(AGGR_REGISTRY)
    return name in _AGGR_NAMES


class Parser:
    def __init__(
        self,
        src: str,
        params: Optional[Dict[str, Any]] = None,
        defer_params: bool = False,
    ) -> None:
        self.src = src
        self.toks = tokenize(src)
        self.pos = 0
        self.params = params or {}
        self.defer_params = defer_params

    # --- token helpers -------------------------------------------------------

    def peek(self, k: int = 0) -> Token:
        i = min(self.pos + k, len(self.toks) - 1)
        return self.toks[i]

    def next(self) -> Token:
        t = self.toks[self.pos]
        if t.kind != EOF:
            self.pos += 1
        return t

    def at_punct(self, p: str, k: int = 0) -> bool:
        t = self.peek(k)
        return t.kind == PUNCT and t.text == p

    def at_name(self, text: Optional[str] = None, k: int = 0) -> bool:
        t = self.peek(k)
        return t.kind == NAME and (text is None or t.text == text)

    def expect_punct(self, p: str) -> Token:
        t = self.next()
        if t.kind != PUNCT or t.text != p:
            raise self.err(f"expected '{p}', got {t.text!r}", t)
        return t

    def expect_name(self, what: str = "identifier") -> Token:
        t = self.next()
        if t.kind != NAME:
            raise self.err(f"expected {what}, got {t.text!r}", t)
        return t

    def eat_punct(self, p: str) -> bool:
        if self.at_punct(p):
            self.next()
            return True
        return False

    def err(self, msg: str, tok: Optional[Token] = None) -> ParseError:
        t = tok or self.peek()
        line = self.src.count("\n", 0, t.start) + 1
        return ParseError(f"{msg} (line {line})", pos=t.start)

    def adjacent(self, k: int = 0) -> bool:
        """True if token k+1 starts immediately after token k."""
        return self.peek(k).end == self.peek(k + 1).start

    # --- entry ---------------------------------------------------------------

    def parse_script(self):
        if self.at_punct("::"):
            self.next()
            op = self.parse_sys_op()
            self.expect_eof()
            return A.SysScript(op)
        if self.at_punct("%") or self.at_punct("{"):
            stmts = self.parse_imperative_block(top=True)
            self.expect_eof()
            return A.ImperativeScript(stmts)
        prog = self.parse_query_program(until_brace=False)
        self.expect_eof()
        return A.QueryScript(prog)

    def expect_eof(self) -> None:
        if self.peek().kind != EOF:
            raise self.err(f"unexpected trailing input {self.peek().text!r}")

    # --- expressions ---------------------------------------------------------

    def parse_expr(self, min_prec: int = 0) -> Expr:
        lhs = self.parse_unary()
        while True:
            t = self.peek()
            if t.kind != PUNCT or t.text not in _INFIX_PREC:
                return lhs
            prec, opname = _INFIX_PREC[t.text]
            if prec < min_prec:
                return lhs
            self.next()
            next_min = prec if t.text in _RIGHT_ASSOC else prec + 1
            rhs = self.parse_expr(next_min)
            lhs = Apply(get_op(opname), [lhs, rhs])
        # unreachable

    def parse_unary(self) -> Expr:
        if self.at_punct("-"):
            self.next()
            inner = self.parse_unary()
            if isinstance(inner, Const) and isinstance(inner.val, (int, float)) and not isinstance(inner.val, bool):
                return Const(-inner.val)
            return Apply(get_op("minus"), [inner])
        if self.at_punct("!"):
            self.next()
            return Apply(get_op("negate"), [self.parse_unary()])
        return self.parse_postfix()

    def parse_postfix(self) -> Expr:
        e = self.parse_term()
        while self.at_punct("->"):
            self.next()
            rhs = self.parse_term()
            e = Apply(get_op("maybe_get"), [e, rhs])
        return e

    def parse_term(self) -> Expr:
        t = self.peek()
        if t.kind == INT or t.kind == FLOAT:
            self.next()
            return Const(t.val)
        if t.kind == STR:
            self.next()
            return Const(t.val)
        if t.kind == PARAM:
            self.next()
            if self.defer_params:
                from ..data.expr import ParamRef

                return ParamRef(t.val)
            if t.val not in self.params:
                raise self.err(f"Required parameter {t.val} not found", t)
            from ..data.value import deep_freeze

            return Const(deep_freeze(self.params[t.val]))
        if t.kind == PUNCT and t.text == "(":
            self.next()
            e = self.parse_expr()
            self.expect_punct(")")
            return e
        if t.kind == PUNCT and t.text == "[":
            self.next()
            args = []
            while not self.at_punct("]"):
                args.append(self.parse_expr())
                if not self.eat_punct(","):
                    break
            self.expect_punct("]")
            return Apply(get_op("list"), args)
        if t.kind == PUNCT and t.text == "{":
            self.next()
            args = []
            while not self.at_punct("}"):
                k = self.parse_expr()
                self.expect_punct(":")
                v = self.parse_expr()
                args.extend([k, v])
                if not self.eat_punct(","):
                    break
            self.expect_punct("}")
            return Apply(get_op("json_object"), args)
        if t.kind == NAME:
            name = t.text
            if name == "true":
                self.next()
                return Const(True)
            if name == "false":
                self.next()
                return Const(False)
            if name == "null":
                self.next()
                return Const(None)
            if self.at_punct("(", 1):
                self.next()
                self.next()
                args = []
                while not self.at_punct(")"):
                    args.append(self.parse_expr())
                    if not self.eat_punct(","):
                        break
                self.expect_punct(")")
                return self._make_apply(name, args, t)
            self.next()
            return Binding(name)
        raise self.err(f"unexpected token {t.text!r} in expression", t)

    def _make_apply(self, name: str, args: List[Expr], tok: Token) -> Expr:
        if name == "cond":
            if not args:
                raise self.err("'cond' cannot have empty body", tok)
            if len(args) % 2 == 1:
                args = args[:-1] + [Const(None), args[-1]]
            clauses = [(args[i], args[i + 1]) for i in range(0, len(args), 2)]
            last_cond = clauses[-1][0]
            if not (isinstance(last_cond, Const) and last_cond.val is True):
                clauses.append((Const(True), Const(None)))
            return Cond(clauses)
        if name == "if":
            if len(args) not in (2, 3):
                raise self.err("wrong number of arguments to if: 2 or 3 required", tok)
            els = args[2] if len(args) == 3 else Const(None)
            return Cond([(args[0], args[1]), (Const(True), els)])
        op = get_op(name)
        if op is None:
            return UnboundApply(name, args)
        # regex_* ops coerce their pattern argument (expr.rs:938-946)
        if name.startswith("regex_") and len(args) >= 2:
            args[1] = Apply(get_op("regex"), [args[1]])
        if op.vararg:
            if len(args) < op.min_arity:
                raise self.err(
                    f"Wrong number of arguments for function '{name}': "
                    f"need at least {op.min_arity}",
                    tok,
                )
        elif len(args) != op.min_arity:
            raise self.err(
                f"Wrong number of arguments for function '{name}': "
                f"need exactly {op.min_arity}",
                tok,
            )
        return Apply(op, args)

    def eval_const_expr(self, e: Expr) -> Any:
        e = e.fold_const()
        if not isinstance(e, Const):
            raise self.err("expected a constant expression")
        return e.val

    # --- query scripts ---------------------------------------------------------

    def parse_query_program(self, until_brace: bool) -> InputProgram:
        prog = InputProgram()
        saw_any = False
        while True:
            t = self.peek()
            if t.kind == EOF:
                break
            if until_brace and self.at_punct("}"):
                break
            if self.at_punct(":") and self.peek(1).kind == NAME and self.adjacent():
                self.parse_option(prog.out_opts)
                self.eat_punct(";")
                saw_any = True
                continue
            if t.kind == NAME or self.at_punct("?"):
                self.parse_rule_into(prog)
                self.eat_punct(";")
                saw_any = True
                continue
            raise self.err(f"unexpected token {t.text!r} in query")
        if not saw_any:
            raise self.err("empty query script")
        return prog

    def parse_rule_into(self, prog: InputProgram) -> None:
        if self.at_punct("?"):
            head_tok = self.next()
            name = "?"
        else:
            head_tok = self.expect_name("rule name")
            name = head_tok.text
        self.expect_punct("[")
        head_vars: List[str] = []
        aggrs: List[Optional[AggrSpec]] = []
        while not self.at_punct("]"):
            if self.peek().kind == NAME and self.at_punct("(", 1):
                aggr_name = self.next().text
                self.expect_punct("(")
                var = self.expect_name("variable").text
                extras = []
                while self.eat_punct(","):
                    extras.append(self.eval_const_expr(self.parse_expr()))
                self.expect_punct(")")
                head_vars.append(var)
                aggrs.append(AggrSpec(aggr_name, extras))
            else:
                v = self.expect_name("variable").text
                head_vars.append(v)
                aggrs.append(None)
            if not self.eat_punct(","):
                break
        self.expect_punct("]")
        t = self.next()
        if t.kind != PUNCT or t.text not in (":=", "<-", "<~"):
            raise self.err("expected ':=', '<-' or '<~' after rule head", t)
        if t.text == "<-":
            data_expr = self.parse_expr()
            rule: Any = ConstRule(head_vars, data_expr)
        elif t.text == "<~":
            fixed_name = self.expect_name("fixed rule name").text
            rule = self.parse_fixed_args(fixed_name, head_vars)
        else:
            if any(a is not None for a in aggrs) and name == "?" and False:
                pass
            body = self.parse_rule_body(terminators=(";",))
            rule = InputRule(head_vars, aggrs, body)
        prog.rules.setdefault(name, []).append(rule)

    def parse_fixed_args(self, fixed_name: str, head: List[str]) -> FixedRuleApply:
        self.expect_punct("(")
        inputs: List[Any] = []
        options: Dict[str, Any] = {}
        while not self.at_punct(")"):
            if self.at_punct("*"):
                self.next()
                rel = self.expect_name("relation name").text
                # compound_or_index_ident: `rel:idx` (e.g. a proximity graph)
                while (
                    self.at_punct(":")
                    and self.peek(1).kind == NAME
                    and self.adjacent()
                ):
                    self.next()
                    rel += ":" + self.expect_name("index name").text
                if self.at_punct("["):
                    self.next()
                    bindings = []
                    vld = None
                    while not self.at_punct("]"):
                        if self.at_punct("@"):
                            self.next()
                            vld = self.parse_expr()
                            break
                        bindings.append(self.expect_name("variable").text)
                        if not self.eat_punct(","):
                            if self.at_punct("@"):
                                self.next()
                                vld = self.parse_expr()
                            break
                    self.expect_punct("]")
                    inputs.append(FixedRuleRelArg(rel, bindings, vld))
                elif self.at_punct("{"):
                    self.next()
                    pairs = []
                    pins = []
                    vld = None
                    while not self.at_punct("}"):
                        if self.at_punct("@"):
                            self.next()
                            vld = self.parse_expr()
                            break
                        col = self.expect_name("column").text
                        if self.eat_punct(":"):
                            if self.peek().kind == NAME and self.peek().text not in (
                                "true", "false", "null",
                            ):
                                pairs.append((col, self.next().text))
                            else:
                                # constant pin: `layer: 0` filters instead
                                # of binding (extension; see program.py)
                                from ..data.expr import Const

                                e = self.parse_expr().fold_const()
                                if not isinstance(e, Const):
                                    raise self.err(
                                        "fixed-rule column pin must be a "
                                        "constant"
                                    )
                                pins.append((col, e.val))
                        else:
                            pairs.append((col, None))
                        if not self.eat_punct(","):
                            if self.at_punct("@"):
                                self.next()
                                vld = self.parse_expr()
                            break
                    self.expect_punct("}")
                    inputs.append(
                        FixedRuleNamedRelArg(rel, pairs, vld, pins=pins)
                    )
                else:
                    raise self.err("expected '[' or '{' after relation in fixed rule")
            elif self.peek().kind == NAME and self.at_punct("[", 1):
                rname = self.next().text
                self.next()
                bindings = []
                while not self.at_punct("]"):
                    bindings.append(self.expect_name("variable").text)
                    if not self.eat_punct(","):
                        break
                self.expect_punct("]")
                inputs.append(FixedRuleRuleArg(rname, bindings))
            elif self.peek().kind == NAME and self.at_punct(":", 1):
                optname = self.next().text
                self.next()
                # kept as Expr: some options are per-row condition/weight
                # expressions evaluated by the fixed rule itself
                options[optname] = self.parse_expr().fold_const()
            else:
                raise self.err("bad fixed rule argument")
            if not self.eat_punct(","):
                break
        self.expect_punct(")")
        return FixedRuleApply(fixed_name, head, inputs, options)

    # --- rule bodies -----------------------------------------------------------

    def parse_rule_body(self, terminators=(";",)) -> List[Any]:
        """rule_body = (disjunction ,)* — returns list of top-level atoms."""
        atoms: List[Any] = []
        while True:
            t = self.peek()
            if t.kind == EOF:
                break
            if t.kind == PUNCT and t.text in terminators:
                break
            if t.kind == PUNCT and t.text == ")":
                break
            # trailing comma before an out-option / relation-op (':limit',
            # ':replace', ...): ':' can never start an atom (reference
            # grammar allows trailing commas in rule bodies)
            if t.kind == PUNCT and t.text == ":":
                break
            atoms.append(self.parse_disjunction())
            if not self.eat_punct(","):
                break
        return atoms

    def parse_disjunction(self) -> Any:
        first = self.parse_atom()
        if not self.at_name("or"):
            return first
        items = [first]
        while self.at_name("or"):
            self.next()
            items.append(self.parse_atom())
        return DisjunctionAtom(items)

    def parse_atom(self) -> Any:
        t = self.peek()
        if self.at_name("not"):
            self.next()
            return NegationAtom(self.parse_atom())
        if self.at_punct("*") and self.peek(1).kind == NAME and self.adjacent():
            return self.parse_relation_apply()
        if self.at_punct("~") and self.peek(1).kind == NAME and self.adjacent():
            return self.parse_search_apply()
        if t.kind == NAME and self.at_punct("[", 1):
            name = self.next().text
            self.next()
            args = []
            while not self.at_punct("]"):
                args.append(self.parse_expr())
                if not self.eat_punct(","):
                    break
            self.expect_punct("]")
            return RuleApplyAtom(name, args)
        if t.kind == NAME and self.at_punct("=", 1) and t.text not in ("true", "false", "null"):
            var = self.next().text
            self.next()
            return UnificationAtom(var, self.parse_expr(), one_many=False)
        if t.kind == NAME and self.at_name("in", 1) and t.text not in ("true", "false", "null"):
            var = self.next().text
            self.next()
            return UnificationAtom(var, self.parse_expr(), one_many=True)
        if self.at_punct("("):
            # try expression first (pest order: ... | expr | grouped)
            save = self.pos
            try:
                e = self.parse_expr()
                return ExprAtom(e)
            except ParseError:
                self.pos = save
            self.next()
            inner = self.parse_rule_body(terminators=())
            self.expect_punct(")")
            from ..data.program import ConjunctionAtom

            if len(inner) == 1:
                return inner[0]
            return ConjunctionAtom(inner)
        return ExprAtom(self.parse_expr())

    def parse_relation_apply(self) -> RelationApplyAtom:
        self.expect_punct("*")
        name = self.expect_name("relation name").text
        # compound_or_index_ident: `rel:idx` addresses an index relation
        while self.at_punct(":") and self.peek(1).kind == NAME and self.adjacent():
            self.next()
            name += ":" + self.expect_name("index name").text
        if self.at_punct("["):
            self.next()
            args = []
            vld = None
            while not self.at_punct("]"):
                if self.at_punct("@"):
                    self.next()
                    vld = self.parse_expr()
                    break
                args.append(self.parse_expr())
                if not self.eat_punct(","):
                    if self.at_punct("@"):
                        self.next()
                        vld = self.parse_expr()
                    break
            self.expect_punct("]")
            return RelationApplyAtom(name, args=args, validity=vld)
        if self.at_punct("{"):
            self.next()
            pairs = []
            vld = None
            while not self.at_punct("}"):
                if self.at_punct("@"):
                    self.next()
                    vld = self.parse_expr()
                    break
                col = self.expect_name("column").text
                if self.eat_punct(":"):
                    e = self.parse_expr()
                else:
                    e = Binding(col)
                pairs.append((col, e))
                if not self.eat_punct(","):
                    if self.at_punct("@"):
                        self.next()
                        vld = self.parse_expr()
                    break
            self.expect_punct("}")
            return RelationApplyAtom(name, pairs=pairs, validity=vld)
        raise self.err("expected '[' or '{' after relation name")

    def parse_search_apply(self) -> SearchApplyAtom:
        self.expect_punct("~")
        rel_tok = self.expect_name("relation name")
        rel = rel_tok.text
        # compound_or_index_ident: rel(:idx)+
        self.expect_punct(":")
        idx = self.expect_name("index name").text
        self.expect_punct("{")
        pairs = []
        while not self.at_punct("|"):
            col = self.expect_name("column").text
            if self.eat_punct(":"):
                e = self.parse_expr()
            else:
                e = Binding(col)
            pairs.append((col, e))
            if not self.eat_punct(","):
                break
        self.expect_punct("|")
        opts: Dict[str, Expr] = {}
        while not self.at_punct("}"):
            oname = self.expect_name("option").text
            self.expect_punct(":")
            opts[oname] = self.parse_expr()
            if not self.eat_punct(","):
                break
        self.expect_punct("}")
        return SearchApplyAtom(rel, idx, pairs, opts)

    # --- options ---------------------------------------------------------------

    def parse_option(self, opts: QueryOutOptions) -> None:
        self.expect_punct(":")
        name = self.expect_name("option name").text
        if name == "limit":
            opts.limit = int(self.eval_const_expr(self.parse_expr()))
        elif name == "offset":
            opts.offset = int(self.eval_const_expr(self.parse_expr()))
        elif name == "timeout":
            opts.timeout = float(self.eval_const_expr(self.parse_expr()))
        elif name == "sleep":
            opts.sleep = float(self.eval_const_expr(self.parse_expr()))
        elif name == "returning":
            opts.returning = True
        elif name == "disable_magic_rewrite":
            opts.disable_magic_rewrite = bool(self.eval_const_expr(self.parse_expr()))
        elif name in ("sort", "order"):
            while True:
                desc = False
                if self.at_punct("-"):
                    self.next()
                    desc = True
                elif self.at_punct("+"):
                    self.next()
                var = self.expect_name("sort variable").text
                if self.at_punct("("):
                    self.next()
                    inner = self.expect_name("variable").text
                    self.expect_punct(")")
                    var = f"{var}({inner})"
                opts.sorters.append((var, desc))
                if not self.eat_punct(","):
                    break
        elif name == "assert":
            what = self.expect_name("'none' or 'some'").text
            if what == "none":
                opts.assert_none = True
            elif what == "some":
                opts.assert_some = True
            else:
                raise self.err("':assert' requires 'none' or 'some'")
        elif name in (
            "create",
            "replace",
            "put",
            "insert",
            "update",
            "rm",
            "delete",
            "ensure",
            "ensure_not",
        ):
            rel = self.expect_name("relation name").text
            schema = None
            if self.at_punct("{"):
                schema = self.parse_table_schema()
            opts.store_relation = StoreRelation(name, rel, schema)
        else:
            raise self.err(f"unknown query option ':{name}'")

    def parse_table_schema(self) -> TableSchema:
        self.expect_punct("{")
        keys = self.parse_table_cols(stop=("=>", "}"))
        values: List[ColSpec] = []
        if self.at_punct("=>"):
            self.next()
            values = self.parse_table_cols(stop=("}",))
        self.expect_punct("}")
        return TableSchema(keys, values)

    def parse_table_cols(self, stop) -> List[ColSpec]:
        cols = []
        while not any(self.at_punct(s) for s in stop):
            name = self.expect_name("column name").text
            typing = None
            default = None
            gen = None
            if self.at_punct(":"):
                self.next()
                typing = self.parse_col_type()
            if self.at_name("default"):
                self.next()
                start_tok = self.peek()
                default = self.parse_expr()
                end_tok = self.toks[self.pos - 1]
                default = (default, self.src[start_tok.start : end_tok.end])
            elif self.at_punct("="):
                self.next()
                gen = self.expect_name("output variable").text
                if self.at_punct("("):
                    self.next()
                    inner = self.expect_name("variable").text
                    self.expect_punct(")")
                    gen = f"{gen}({inner})"
            cols.append(ColSpec(name, typing, default, gen))
            if not self.eat_punct(","):
                break
        return cols

    def parse_col_type(self) -> ColType:
        t = self.peek()
        if self.at_punct("["):
            self.next()
            inner = self.parse_col_type()
            length = None
            if self.eat_punct(";"):
                length = int(self.eval_const_expr(self.parse_expr()))
            self.expect_punct("]")
            ct = ColType("List", inner=inner, length=length)
        elif self.at_punct("("):
            self.next()
            inners = []
            while not self.at_punct(")"):
                inners.append(self.parse_col_type())
                if not self.eat_punct(","):
                    break
            self.expect_punct(")")
            ct = ColType("Tuple", inner_list=inners)
        elif self.at_punct("<"):
            self.next()
            el = self.expect_name("vector element type").text
            if el in ("F32", "Float"):
                el = "F32"
            elif el in ("F64", "Double"):
                el = "F64"
            else:
                raise self.err(f"bad vector element type {el}")
            self.expect_punct(";")
            dim_tok = self.next()
            if dim_tok.kind != INT:
                raise self.err("vector dimension must be an integer")
            self.expect_punct(">")
            ct = ColType("Vec", vec_eltype=el, length=dim_tok.val)
        elif t.kind == NAME:
            kinds = {
                "Any": "Any",
                "Bool": "Bool",
                "Int": "Int",
                "Float": "Float",
                "String": "String",
                "Bytes": "Bytes",
                "Uuid": "Uuid",
                "Validity": "Validity",
                "Json": "Json",
            }
            if t.text not in kinds:
                raise self.err(f"unknown column type {t.text}")
            self.next()
            ct = ColType(kinds[t.text])
        else:
            raise self.err("expected column type")
        if self.at_punct("?"):
            self.next()
            ct.nullable = True
        return ct

    # --- sys scripts -------------------------------------------------------------

    def parse_sys_op(self) -> A.SysOp:
        t = self.expect_name("sys op")
        kw = t.text
        if kw == "compact":
            return A.SysOp("compact")
        if kw == "relations":
            return A.SysOp("list_relations")
        if kw == "fixed_rules":
            return A.SysOp("list_fixed_rules")
        if kw == "running":
            return A.SysOp("running")
        if kw == "fallbacks":
            return A.SysOp("fallbacks")
        if kw == "kill":
            v = self.eval_const_expr(self.parse_expr())
            return A.SysOp("kill", {"id": v})
        if kw == "columns":
            rel = self.parse_compound_or_index_ident()
            return A.SysOp("list_columns", {"rel": rel})
        if kw == "indices":
            rel = self.parse_compound_or_index_ident()
            return A.SysOp("list_indices", {"rel": rel})
        if kw == "describe":
            rel = self.parse_compound_or_index_ident()
            text = ""
            if self.peek().kind == STR:
                text = self.next().val
            return A.SysOp("describe", {"rel": rel, "text": text})
        if kw == "remove":
            rels = [self.expect_name("relation").text]
            while self.eat_punct(","):
                rels.append(self.expect_name("relation").text)
            return A.SysOp("remove_relations", {"rels": rels})
        if kw == "rename":
            pairs = []
            while True:
                old = self.expect_name("relation").text
                self.expect_punct("->")
                new = self.expect_name("relation").text
                pairs.append((old, new))
                if not self.eat_punct(","):
                    break
            return A.SysOp("rename_relations", {"pairs": pairs})
        if kw == "access_level":
            level = self.expect_name("access level").text
            if level not in ("normal", "protected", "read_only", "hidden"):
                raise self.err(f"bad access level {level}")
            rels = [self.expect_name("relation").text]
            while self.eat_punct(","):
                rels.append(self.expect_name("relation").text)
            return A.SysOp("access_level", {"level": level, "rels": rels})
        if kw == "explain":
            self.expect_punct("{")
            prog = self.parse_query_program(until_brace=True)
            self.expect_punct("}")
            return A.SysOp("explain", {"prog": prog})
        if kw == "show_triggers":
            rel = self.expect_name("relation").text
            return A.SysOp("show_triggers", {"rel": rel})
        if kw == "set_triggers":
            rel = self.expect_name("relation").text
            puts, rms, replaces = [], [], []
            while self.at_name("on"):
                self.next()
                which = self.expect_name("'put', 'rm' or 'replace'").text
                self.expect_punct("{")
                start = self.pos
                depth = 1
                while depth > 0:
                    tok = self.next()
                    if tok.kind == EOF:
                        raise self.err("unterminated trigger body")
                    if tok.kind == PUNCT and tok.text == "{":
                        depth += 1
                    elif tok.kind == PUNCT and tok.text == "}":
                        depth -= 1
                end_tok = self.toks[self.pos - 1]
                body_src = self.src[self.toks[start].start : end_tok.start]
                if which == "put":
                    puts.append(body_src)
                elif which == "rm":
                    rms.append(body_src)
                elif which == "replace":
                    replaces.append(body_src)
                else:
                    raise self.err(f"bad trigger event {which}")
            return A.SysOp(
                "set_triggers",
                {"rel": rel, "puts": puts, "rms": rms, "replaces": replaces},
            )
        if kw == "index":
            return self.parse_index_op()
        if kw == "hnsw":
            return self.parse_hnsw_op()
        if kw == "fts":
            return self.parse_fts_op()
        if kw == "lsh":
            return self.parse_lsh_op()
        raise self.err(f"unknown sys op '{kw}'", t)

    def parse_compound_or_index_ident(self) -> str:
        name = self.expect_name("relation").text
        while self.at_punct(":"):
            self.next()
            name += ":" + self.expect_name("index").text
        return name

    def _parse_rel_colon_idx(self) -> Tuple[str, str]:
        rel = self.expect_name("relation").text
        self.expect_punct(":")
        idx = self.expect_name("index name").text
        return rel, idx

    def parse_index_op(self) -> A.SysOp:
        which = self.expect_name("'create' or 'drop'").text
        if which == "create":
            rel, idx = self._parse_rel_colon_idx()
            self.expect_punct("{")
            cols = []
            while not self.at_punct("}"):
                cols.append(self.expect_name("column").text)
                if not self.eat_punct(","):
                    break
            self.expect_punct("}")
            if not cols:
                raise self.err("index must have at least one column specified")
            return A.SysOp("create_index", {"rel": rel, "idx": idx, "cols": cols})
        if which == "drop":
            rel, idx = self._parse_rel_colon_idx()
            return A.SysOp("drop_index", {"rel": rel, "idx": idx})
        raise self.err("expected 'create' or 'drop'")

    def _parse_adv_index_fields(self) -> Dict[str, Any]:
        """index_create_adv fields: `name: <raw expr>` — values kept both as
        source text (for filter/extractor) and evaluated when constant."""
        self.expect_punct("{")
        fields: Dict[str, Any] = {}
        while not self.at_punct("}"):
            fname = self.expect_name("option").text
            self.expect_punct(":")
            start_tok = self.peek()
            expr = self.parse_expr()
            end_tok = self.toks[self.pos - 1]
            src_text = self.src[start_tok.start : end_tok.end]
            fields[fname] = (expr, src_text.strip())
            if not self.eat_punct(","):
                break
        self.expect_punct("}")
        return fields

    def parse_hnsw_op(self) -> A.SysOp:
        which = self.expect_name("'create' or 'drop'").text
        if which == "drop":
            rel, idx = self._parse_rel_colon_idx()
            return A.SysOp("drop_index", {"rel": rel, "idx": idx})
        if which != "create":
            raise self.err("expected 'create' or 'drop'")
        rel, idx = self._parse_rel_colon_idx()
        fields = self._parse_adv_index_fields()

        def cval(name, default=None):
            if name not in fields:
                return default
            return self.eval_const_expr(fields[name][0])

        def ctext(name, default=None):
            if name not in fields:
                return default
            return fields[name][1]

        dim = cval("dim", 0)
        ef = cval("ef_construction", cval("ef", 0))
        m = cval("m_neighbours", cval("m", 0))
        if not ef:
            raise self.err("ef_construction must be set")
        if not m:
            raise self.err("m_neighbours must be set")
        flds = fields.get("fields")
        if flds is None:
            raise self.err("hnsw index requires 'fields'")
        fexpr = flds[0]
        from ..data.expr import Apply as _Ap

        vec_fields = []
        if isinstance(fexpr, Binding):
            vec_fields = [fexpr.var]
        elif isinstance(fexpr, _Ap) and fexpr.op.name == "list":
            for a in fexpr.args:
                if isinstance(a, Binding):
                    vec_fields.append(a.var)
                else:
                    raise self.err("'fields' must be a list of column names")
        else:
            raise self.err("'fields' must be a list of column names")
        distance = ctext("distance", ctext("dist", "L2"))
        if distance not in ("L2", "IP", "Cosine"):
            raise self.err(f"Invalid distance: {distance}")
        dtype = ctext("dtype", "F32")
        if dtype in ("F32", "Float"):
            dtype = "F32"
        elif dtype in ("F64", "Double"):
            dtype = "F64"
        else:
            raise self.err(f"Invalid dtype: {dtype}")
        cfg = A.HnswIndexConfig(
            base_relation=rel,
            index_name=idx,
            dim=int(dim),
            dtype=dtype,
            fields=vec_fields,
            distance=distance,
            ef_construction=int(ef),
            m_neighbours=int(m),
            index_filter=ctext("filter"),
            extend_candidates=bool(cval("extend_candidates", False)),
            keep_pruned_connections=bool(cval("keep_pruned_connections", False)),
        )
        return A.SysOp("create_hnsw_index", {"config": cfg})

    def _parse_tokenizer_spec(self, field):
        """tokenizer: Simple or NGram(2, 3, false) — name + const args."""
        expr, text = field
        if isinstance(expr, Binding):
            return (expr.var, [])
        if isinstance(expr, (Apply, UnboundApply)):
            name = expr.name if isinstance(expr, UnboundApply) else expr.op.name
            args = [self.eval_const_expr(a) for a in expr.args]
            return (name, args)
        raise self.err("Tokenizer must be a symbol or a call")

    def _parse_filters_spec(self, field):
        expr, text = field
        from ..data.expr import Apply as _Ap

        if not (isinstance(expr, _Ap) and expr.op.name == "list"):
            raise self.err("Filters must be a list of filters")
        out = []
        for a in expr.args:
            if isinstance(a, Binding):
                out.append((a.var, []))
            elif isinstance(a, (Apply, UnboundApply)):
                name = a.name if isinstance(a, UnboundApply) else a.op.name
                out.append((name, [self.eval_const_expr(x) for x in a.args]))
            else:
                raise self.err("Filters must be a list of filters")
        return out

    def parse_fts_op(self) -> A.SysOp:
        which = self.expect_name("'create' or 'drop'").text
        if which == "drop":
            rel, idx = self._parse_rel_colon_idx()
            return A.SysOp("drop_index", {"rel": rel, "idx": idx})
        rel, idx = self._parse_rel_colon_idx()
        fields = self._parse_adv_index_fields()
        extractor = fields["extractor"][1] if "extractor" in fields else ""
        if "extract_filter" in fields:
            extractor = f"if({fields['extract_filter'][1]}, {extractor})"
        tokenizer = (
            self._parse_tokenizer_spec(fields["tokenizer"])
            if "tokenizer" in fields
            else ("Simple", [])
        )
        filters = self._parse_filters_spec(fields["filters"]) if "filters" in fields else []
        cfg = A.FtsIndexConfig(rel, idx, extractor, tokenizer, filters)
        return A.SysOp("create_fts_index", {"config": cfg})

    def parse_lsh_op(self) -> A.SysOp:
        which = self.expect_name("'create' or 'drop'").text
        if which == "drop":
            rel, idx = self._parse_rel_colon_idx()
            return A.SysOp("drop_index", {"rel": rel, "idx": idx})
        rel, idx = self._parse_rel_colon_idx()
        fields = self._parse_adv_index_fields()

        def cval(name, default=None):
            if name not in fields:
                return default
            return self.eval_const_expr(fields[name][0])

        extractor = fields["extractor"][1] if "extractor" in fields else ""
        if "extract_filter" in fields:
            extractor = f"if({fields['extract_filter'][1]}, {extractor})"
        tokenizer = (
            self._parse_tokenizer_spec(fields["tokenizer"])
            if "tokenizer" in fields
            else ("Simple", [])
        )
        filters = self._parse_filters_spec(fields["filters"]) if "filters" in fields else []
        n_gram = int(cval("n_gram", 1))
        n_perm = int(cval("n_perm", 200))
        target_threshold = float(cval("target_threshold", 0.9))
        fp = float(cval("false_positive_weight", 1.0))
        fn_ = float(cval("false_negative_weight", 1.0))
        if n_gram <= 0 or n_perm <= 0:
            raise self.err("n_gram/n_perm must be positive")
        if not (0.0 < target_threshold < 1.0):
            raise self.err("target_threshold must be between 0 and 1")
        cfg = A.MinHashLshConfig(
            rel, idx, extractor, tokenizer, filters, n_gram, n_perm, fp, fn_, target_threshold
        )
        return A.SysOp("create_lsh_index", {"config": cfg})

    # --- imperative scripts --------------------------------------------------------

    def parse_imperative_block(self, top=False) -> List[Any]:
        stmts = []
        while True:
            t = self.peek()
            if t.kind == EOF:
                break
            if self.at_punct("%"):
                nxt = self.peek(1)
                if nxt.kind == NAME and nxt.text in (
                    "end",
                    "else",
                    "then",
                ):
                    break
                stmts.append(self.parse_imperative_stmt())
            elif self.at_punct("{"):
                stmts.append(self.parse_imperative_clause())
            else:
                break
        if not stmts:
            raise self.err("empty imperative block")
        return stmts

    def parse_imperative_clause(self):
        self.expect_punct("{")
        if self.at_punct("::"):
            self.next()
            op = self.parse_sys_op()
            self.expect_punct("}")
            store_as = self._parse_store_as()
            return A.ImperativeSysOp(op, store_as)
        prog = self.parse_query_program(until_brace=True)
        self.expect_punct("}")
        store_as = self._parse_store_as()
        return A.ImperativeQuery(prog, store_as)

    def _parse_store_as(self) -> Optional[str]:
        if self.at_name("as"):
            self.next()
            name = self.expect_name("temp relation name").text
            if not name.startswith("_"):
                raise self.err("'as' target must start with '_'")
            return name
        return None

    def parse_imperative_stmt(self):
        self.expect_punct("%")
        kw_tok = self.expect_name("imperative keyword")
        kw = kw_tok.text
        if kw in ("if", "if_not"):
            cond = self.parse_imperative_condition()
            if self.at_punct("%") and self.at_name("then", 1):
                self.next()
                self.next()
            then_branch = self.parse_imperative_block()
            else_branch = []
            if self.at_punct("%") and self.at_name("else", 1):
                self.next()
                self.next()
                else_branch = self.parse_imperative_block()
            self._expect_imp_kw("end")
            return A.ImperativeIf(cond, kw == "if_not", then_branch, else_branch)
        if kw == "loop":
            body = self.parse_imperative_block()
            self._expect_imp_kw("end")
            return A.ImperativeLoop(None, body)
        if kw == "mark":
            label = self.expect_name("label").text
            self._expect_imp_kw("loop")
            body = self.parse_imperative_block()
            self._expect_imp_kw("end")
            return A.ImperativeLoop(label, body)
        if kw == "break":
            label = self.next().text if self.peek().kind == NAME else None
            return A.ImperativeBreak(label)
        if kw == "continue":
            label = self.next().text if self.peek().kind == NAME else None
            return A.ImperativeContinue(label)
        if kw == "return":
            values = []
            while True:
                if self.at_punct("{"):
                    values.append(self.parse_imperative_clause())
                elif self.peek().kind == NAME:
                    values.append(self.next().text)
                else:
                    break
                if not self.eat_punct(","):
                    break
            return A.ImperativeReturn(values)
        if kw == "swap":
            left = self.expect_name("temp relation").text
            right = self.expect_name("temp relation").text
            return A.ImperativeSwap(left, right)
        if kw == "debug":
            return A.ImperativeDebug(self.expect_name("name").text)
        if kw == "ignore_error":
            clause = self.parse_imperative_clause()
            return A.ImperativeIgnoreError(clause)
        raise self.err(f"unknown imperative statement %{kw}", kw_tok)

    def _expect_imp_kw(self, kw: str) -> None:
        self.expect_punct("%")
        t = self.expect_name(f"%{kw}")
        if t.text != kw:
            raise self.err(f"expected %{kw}, got %{t.text}", t)

    def parse_imperative_condition(self):
        if self.at_punct("{"):
            return self.parse_imperative_clause()
        name = self.expect_name("temp relation or clause").text
        return name


def parse_script(
    src: str,
    params: Optional[Dict[str, Any]] = None,
    defer_params: bool = False,
):
    return Parser(src, params, defer_params=defer_params).parse_script()


def parse_expressions(src: str, params: Optional[Dict[str, Any]] = None) -> Expr:
    p = Parser(src, params)
    e = p.parse_expr()
    p.expect_eof()
    return e
