"""Tokenizer for CozoScript.

Follows the lexical rules of the reference grammar
(`cozo-core/src/cozoscript.pest`): `#` line comments, nesting `/* */`
block comments, `_`-separated numerals with 0x/0o/0b bases, three string
forms (double/single quoted with escapes, `___"..."___` raw), names that
may contain dots (vars/compound idents), and `$params`.
"""

from __future__ import annotations

import unicodedata
from dataclasses import dataclass
from typing import List, Optional

from ..utils.errors import ParseError

# token kinds
NAME = "NAME"
PARAM = "PARAM"
INT = "INT"
FLOAT = "FLOAT"
STR = "STR"
PUNCT = "PUNCT"
EOF = "EOF"

_MULTI_PUNCT = [
    ":=",
    "<~",
    "<-",
    "=>",
    "->",
    "==",
    "!=",
    ">=",
    "<=",
    "&&",
    "||",
    "++",
    "::",
]
_SINGLE_PUNCT = set("?[](){},;:=<>+-*/%^!~@|.&$")


@dataclass
class Token:
    kind: str
    text: str
    val: object
    start: int
    end: int

    def __repr__(self) -> str:
        return f"{self.kind}({self.text!r})"


def _is_xid_start(c: str) -> bool:
    return c.isalpha() or unicodedata.category(c) in ("Lo", "Nl") or c == "_"


def _is_xid_continue(c: str) -> bool:
    return c.isalnum() or c == "_" or unicodedata.category(c) in ("Mn", "Mc", "Nd", "Pc")


_ESCAPES = {
    '"': '"',
    "'": "'",
    "\\": "\\",
    "/": "/",
    "b": "\b",
    "f": "\f",
    "n": "\n",
    "r": "\r",
    "t": "\t",
}


class Lexer:
    def __init__(self, src: str) -> None:
        self.src = src
        self.pos = 0
        self.n = len(src)

    def error(self, msg: str) -> ParseError:
        return ParseError(msg, pos=self.pos)

    def _skip_trivia(self) -> None:
        src, n = self.src, self.n
        while self.pos < n:
            c = src[self.pos]
            if c in " \t\r\n":
                self.pos += 1
            elif c == "#":
                while self.pos < n and src[self.pos] != "\n":
                    self.pos += 1
            elif c == "/" and self.pos + 1 < n and src[self.pos + 1] == "*":
                depth = 1
                self.pos += 2
                while self.pos < n and depth:
                    if src.startswith("/*", self.pos):
                        depth += 1
                        self.pos += 2
                    elif src.startswith("*/", self.pos):
                        depth -= 1
                        self.pos += 2
                    else:
                        self.pos += 1
                if depth:
                    raise self.error("unterminated block comment")
            else:
                return

    def _lex_number(self) -> Token:
        src, n = self.src, self.n
        start = self.pos
        if src[self.pos] == "0" and self.pos + 1 < n and src[self.pos + 1] in "xob":
            base = {"x": 16, "o": 8, "b": 2}[src[self.pos + 1]]
            self.pos += 2
            digs = []
            while self.pos < n and (src[self.pos].isalnum() or src[self.pos] == "_"):
                if src[self.pos] != "_":
                    digs.append(src[self.pos])
                self.pos += 1
            try:
                v = int("".join(digs), base)
            except ValueError:
                raise self.error("invalid numeral")
            return Token(INT, src[start : self.pos], v, start, self.pos)
        digs = []
        is_float = False
        while self.pos < n and (src[self.pos].isdigit() or src[self.pos] == "_"):
            if src[self.pos] != "_":
                digs.append(src[self.pos])
            self.pos += 1
        # fraction: "." followed by digit/underscore or end-of-number context
        if (
            self.pos < n
            and src[self.pos] == "."
            and (self.pos + 1 >= n or not _is_xid_start(src[self.pos + 1]))
            and (self.pos + 1 >= n or src[self.pos + 1] != ".")
        ):
            is_float = True
            digs.append(".")
            self.pos += 1
            while self.pos < n and (src[self.pos].isdigit() or src[self.pos] == "_"):
                if src[self.pos] != "_":
                    digs.append(src[self.pos])
                self.pos += 1
        if self.pos < n and src[self.pos] in "eE":
            save = self.pos
            self.pos += 1
            sign = ""
            if self.pos < n and src[self.pos] in "+-":
                sign = src[self.pos]
                self.pos += 1
            if self.pos < n and (src[self.pos].isdigit() or src[self.pos] == "_"):
                is_float = True
                digs.append("e")
                digs.append(sign)
                while self.pos < n and (src[self.pos].isdigit() or src[self.pos] == "_"):
                    if src[self.pos] != "_":
                        digs.append(src[self.pos])
                    self.pos += 1
            else:
                self.pos = save
        text = src[start : self.pos]
        num = "".join(digs)
        if is_float:
            return Token(FLOAT, text, float(num), start, self.pos)
        ival = int(num)
        if ival > (1 << 63) - 1 or ival < -(1 << 63):
            raise self.error(f"integer literal out of 64-bit range: {text}")
        return Token(INT, text, ival, start, self.pos)

    def _lex_quoted(self, quote: str) -> Token:
        src, n = self.src, self.n
        start = self.pos
        self.pos += 1
        out = []
        while self.pos < n:
            c = src[self.pos]
            if c == quote:
                self.pos += 1
                return Token(STR, src[start : self.pos], "".join(out), start, self.pos)
            if c == "\\":
                self.pos += 1
                if self.pos >= n:
                    break
                e = src[self.pos]
                if e == "u":
                    hexs = src[self.pos + 1 : self.pos + 5]
                    if len(hexs) < 4:
                        raise self.error("bad unicode escape")
                    out.append(chr(int(hexs, 16)))
                    self.pos += 5
                elif e in _ESCAPES:
                    out.append(_ESCAPES[e])
                    self.pos += 1
                else:
                    raise self.error(f"bad escape \\{e}")
            else:
                out.append(c)
                self.pos += 1
        raise self.error("unterminated string")

    def _lex_raw_string(self) -> Optional[Token]:
        # ___"...."___ with matching number of underscores (>=1)
        src, n = self.src, self.n
        start = self.pos
        i = self.pos
        while i < n and src[i] == "_":
            i += 1
        n_unders = i - self.pos
        if n_unders == 0 or i >= n or src[i] != '"':
            return None
        terminator = '"' + "_" * n_unders
        end = src.find(terminator, i + 1)
        if end < 0:
            raise self.error("unterminated raw string")
        content = src[i + 1 : end]
        self.pos = end + len(terminator)
        return Token(STR, src[start : self.pos], content, start, self.pos)

    def next_token(self) -> Token:
        self._skip_trivia()
        src, n = self.src, self.n
        if self.pos >= n:
            return Token(EOF, "", None, self.pos, self.pos)
        start = self.pos
        c = src[self.pos]
        if c.isdigit():
            return self._lex_number()
        if c == '"':
            return self._lex_quoted('"')
        if c == "'":
            return self._lex_quoted("'")
        if c == "_":
            raw = self._lex_raw_string()
            if raw is not None:
                return raw
        if c == "$":
            i = self.pos + 1
            while i < n and (_is_xid_continue(src[i]) or src[i] in "._"):
                i += 1
            if i == self.pos + 1:
                raise self.error("empty parameter name")
            tok = Token(PARAM, src[start:i], src[start + 1 : i], start, i)
            self.pos = i
            return tok
        if _is_xid_start(c):
            i = self.pos + 1
            while i < n and (_is_xid_continue(src[i]) or src[i] in "._"):
                i += 1
            # a trailing dot not followed by an ident char belongs outside
            while i > self.pos + 1 and src[i - 1] == ".":
                i -= 1
            tok = Token(NAME, src[start:i], src[start:i], start, i)
            self.pos = i
            return tok
        for mp in _MULTI_PUNCT:
            if src.startswith(mp, self.pos):
                self.pos += len(mp)
                return Token(PUNCT, mp, mp, start, self.pos)
        if c in _SINGLE_PUNCT:
            self.pos += 1
            return Token(PUNCT, c, c, start, self.pos)
        raise self.error(f"unexpected character {c!r}")


def tokenize(src: str) -> List[Token]:
    lx = Lexer(src)
    out = []
    while True:
        t = lx.next_token()
        out.append(t)
        if t.kind == EOF:
            return out
