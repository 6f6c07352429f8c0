"""FTS query AST + hand-rolled parser for the search mini-grammar
(reference `cozo-core/src/parse/fts.rs` + `fts/ast.rs`):

    term := phrase | NEAR/n(p1 p2 ...) | (expr...)
    expr := term ((AND | OR | , | ; | NOT) term)*
    phrase := words | "quoted" ~ marked with `*` (prefix) and `^boost`

Juxtaposed expressions combine with AND."""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import List, Optional

from ..utils.errors import QueryError


@dataclass
class FtsLiteral:
    value: str
    is_prefix: bool = False
    booster: float = 1.0


@dataclass
class FtsNear:
    literals: List[FtsLiteral]
    distance: int = 10


@dataclass
class FtsAnd:
    items: List[object]


@dataclass
class FtsOr:
    items: List[object]


@dataclass
class FtsNot:
    lhs: object
    rhs: object


_TOK_RE = re.compile(
    r"""\s*(?:
        (?P<lparen>\()|(?P<rparen>\))|
        (?P<and>AND)|(?P<or>OR|,|;)|(?P<not>NOT)|
        (?P<near>NEAR(?:/(?P<dist>\d+))?)|
        (?P<quoted>"(?:[^"\\]|\\.)*"|'(?:[^'\\]|\\.)*')|
        (?P<word>[\w一-鿿]+)|
        (?P<star>\*)|(?P<boost>\^\d+(?:\.\d+)?)
    )""",
    re.VERBOSE | re.UNICODE,
)


class _P:
    def __init__(self, q: str):
        self.toks = []
        pos = 0
        while pos < len(q):
            m = _TOK_RE.match(q, pos)
            if not m or m.end() == pos:
                if q[pos:].strip() == "":
                    break
                raise QueryError(f"cannot parse FTS query at: {q[pos:]!r}")
            pos = m.end()
            for kind in ("lparen", "rparen", "and", "or", "not", "near",
                         "quoted", "word", "star", "boost"):
                if m.group(kind):
                    self.toks.append((kind, m.group(kind), m.group("dist")))
                    break
        self.i = 0

    def peek(self):
        return self.toks[self.i] if self.i < len(self.toks) else (None, None, None)

    def next(self):
        t = self.peek()
        self.i += 1
        return t

    def parse_doc(self):
        items = []
        while self.peek()[0] is not None and self.peek()[0] != "rparen":
            items.append(self.parse_expr())
        if not items:
            raise QueryError("empty FTS query")
        return items[0] if len(items) == 1 else FtsAnd(items)

    def parse_expr(self):
        lhs = self.parse_term()
        while True:
            kind, _, _ = self.peek()
            if kind == "and":
                self.next()
                lhs = FtsAnd([lhs, self.parse_term()])
            elif kind == "or":
                self.next()
                lhs = FtsOr([lhs, self.parse_term()])
            elif kind == "not":
                self.next()
                lhs = FtsNot(lhs, self.parse_term())
            else:
                return lhs

    def parse_term(self):
        kind, text, dist = self.peek()
        if kind == "lparen":
            self.next()
            items = []
            while self.peek()[0] not in (None, "rparen"):
                items.append(self.parse_expr())
            if self.peek()[0] != "rparen":
                raise QueryError("unbalanced parentheses in FTS query")
            self.next()
            return items[0] if len(items) == 1 else FtsAnd(items)
        if kind == "near":
            self.next()
            d = int(dist) if dist else 10
            if self.peek()[0] != "lparen":
                raise QueryError("NEAR requires parentheses")
            self.next()
            lits = []
            while self.peek()[0] in ("word", "quoted"):
                lits.append(self._phrase())
            if self.peek()[0] != "rparen":
                raise QueryError("unbalanced parentheses in NEAR")
            self.next()
            return FtsNear(lits, d)
        if kind in ("word", "quoted"):
            return self._phrase()
        raise QueryError(f"unexpected token in FTS query: {text!r}")

    def _phrase(self) -> FtsLiteral:
        kind, text, _ = self.next()
        if kind == "quoted":
            value = text[1:-1].replace('\\"', '"').replace("\\'", "'")
        else:
            # consecutive words form a phrase group
            parts = [text]
            while self.peek()[0] == "word":
                parts.append(self.next()[1])
            value = " ".join(parts)
        lit = FtsLiteral(value)
        while True:
            kind, text, _ = self.peek()
            if kind == "star":
                self.next()
                lit.is_prefix = True
            elif kind == "boost":
                self.next()
                lit.booster = float(text[1:])
            else:
                break
        return lit


def parse_fts_query(q: str):
    return _P(q).parse_doc()


def tokenize_ast(node, analyzer):
    """Expand literals through the analyzer (reference `fts/ast.rs` tokenize):
    a multi-token literal becomes an AND of its tokens; prefix literals stay
    untokenized."""
    if isinstance(node, FtsLiteral):
        if node.is_prefix:
            return node
        toks = analyzer.analyze(node.value)
        lits = [FtsLiteral(t.text, False, node.booster) for t in toks]
        if not lits:
            return FtsLiteral("", False, 0.0)
        if len(lits) == 1:
            return lits[0]
        return FtsAnd(lits)
    if isinstance(node, FtsNear):
        out = []
        for lit in node.literals:
            toks = analyzer.analyze(lit.value)
            out.extend(FtsLiteral(t.text, False, lit.booster) for t in toks)
        return FtsNear(out, node.distance)
    if isinstance(node, FtsAnd):
        return FtsAnd([tokenize_ast(x, analyzer) for x in node.items])
    if isinstance(node, FtsOr):
        return FtsOr([tokenize_ast(x, analyzer) for x in node.items])
    if isinstance(node, FtsNot):
        return FtsNot(tokenize_ast(node.lhs, analyzer), tokenize_ast(node.rhs, analyzer))
    raise QueryError(f"bad FTS AST node {node!r}")
