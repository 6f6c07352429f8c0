"""Text analysis stack: tokenizers + filter chain.

Feature-parity with the reference's vendored tantivy stack
(`cozo-core/src/fts/tokenizer/`, construction switch `fts/mod.rs:77-235`):

tokenizers: Raw, Simple, Whitespace, NGram(min,max,prefix_only),
Cangjie(kind, hmm) — Chinese segmentation falls back to per-codepoint
tokens (no jieba in this environment; the seam is pluggable);
filters: AlphaNumOnly, AsciiFolding, Lowercase, RemoveLong(n),
SplitCompoundWords(list), Stemmer(lang — Porter for English, identity
otherwise), Stopwords(lang | explicit list)."""

from __future__ import annotations

import re
import unicodedata
from dataclasses import dataclass
from typing import Iterable, List, Optional, Tuple

from ..utils.errors import QueryError


@dataclass
class Token:
    text: str
    position: int
    offset_from: int
    offset_to: int


# --- tokenizers ---------------------------------------------------------------


def tok_raw(text: str) -> List[Token]:
    return [Token(text, 0, 0, len(text))] if text else []


_SIMPLE_RE = re.compile(r"[^\W_]+", re.UNICODE)


def tok_simple(text: str) -> List[Token]:
    out = []
    for i, m in enumerate(_SIMPLE_RE.finditer(text)):
        out.append(Token(m.group(0), i, m.start(), m.end()))
    return out


def tok_whitespace(text: str) -> List[Token]:
    out = []
    pos = 0
    i = 0
    for part in re.finditer(r"\S+", text):
        out.append(Token(part.group(0), i, part.start(), part.end()))
        i += 1
    return out


def make_ngram(min_gram: int, max_gram: int, prefix_only: bool):
    if min_gram <= 0 or max_gram < min_gram:
        raise QueryError("bad NGram parameters")

    def tok(text: str) -> List[Token]:
        out = []
        pos = 0
        starts = [0] if prefix_only else range(len(text))
        for s in starts:
            for n in range(min_gram, max_gram + 1):
                if s + n > len(text):
                    break
                out.append(Token(text[s : s + n], pos, s, s + n))
                pos += 1
        return out

    return tok


def make_cangjie(kind: str = "default", hmm: bool = False):
    """Chinese segmentation (reference Cangjie = jieba,
    fts/cangjie/*): dictionary segmentation via jieba when available —
    `default`/`all` use cut(), `search` uses cut_for_search, `unicode`
    falls back to per-codepoint.  Without jieba, CJK runs split per
    codepoint and non-CJK runs tokenize like Simple."""
    if kind != "unicode":
        try:
            import jieba

            jieba.setLogLevel(60)

            def tok_jieba(text: str) -> List[Token]:
                if kind == "search":
                    words = jieba.cut_for_search(text)
                elif kind == "all":
                    words = jieba.cut(text, cut_all=True, HMM=hmm)
                else:
                    words = jieba.cut(text, HMM=hmm)
                out = []
                pos = 0
                off = 0
                for w in words:
                    start = text.find(w, off)
                    if start < 0:
                        start = off
                    if w.strip() and any(c.isalnum() for c in w):
                        out.append(Token(w, pos, start, start + len(w)))
                        pos += 1
                    off = max(off, start + len(w)) if kind != "all" else off
                return out

            return tok_jieba
        except ImportError:  # pragma: no cover
            pass

    def is_cjk(c: str) -> bool:
        return 0x3400 <= ord(c) <= 0x9FFF or 0xF900 <= ord(c) <= 0xFAFF

    def tok(text: str) -> List[Token]:
        out = []
        pos = 0
        i = 0
        n = len(text)
        while i < n:
            c = text[i]
            if is_cjk(c):
                out.append(Token(c, pos, i, i + 1))
                pos += 1
                i += 1
            elif c.isalnum():
                j = i
                while j < n and text[j].isalnum() and not is_cjk(text[j]):
                    j += 1
                out.append(Token(text[i:j], pos, i, j))
                pos += 1
                i = j
            else:
                i += 1
        return out

    return tok


# --- filters -------------------------------------------------------------------


def flt_alpha_num_only(tokens):
    return [t for t in tokens if t.text.isalnum()]


def flt_ascii_folding(tokens):
    out = []
    for t in tokens:
        folded = unicodedata.normalize("NFKD", t.text)
        folded = "".join(c for c in folded if not unicodedata.combining(c))
        out.append(Token(folded, t.position, t.offset_from, t.offset_to))
    return out


def flt_lowercase(tokens):
    return [Token(t.text.lower(), t.position, t.offset_from, t.offset_to) for t in tokens]


def make_remove_long(limit: int):
    def f(tokens):
        return [t for t in tokens if len(t.text) < limit]

    return f


def make_split_compound(word_list: List[str]):
    words = sorted(set(word_list), key=len, reverse=True)

    def split(text: str) -> Optional[List[str]]:
        parts = []
        i = 0
        while i < len(text):
            for w in words:
                if text.startswith(w, i):
                    parts.append(w)
                    i += len(w)
                    break
            else:
                return None
        return parts

    def f(tokens):
        out = []
        for t in tokens:
            parts = split(t.text)
            if parts and len(parts) > 1:
                for p in parts:
                    out.append(Token(p, t.position, t.offset_from, t.offset_to))
            else:
                out.append(t)
        return out

    return f


# --- Porter stemmer (English) ----------------------------------------------------

_V = "aeiou"


def _is_cons(word, i):
    c = word[i]
    if c in _V:
        return False
    if c == "y":
        return i == 0 or not _is_cons(word, i - 1)
    return True


def _measure(stem):
    m = 0
    prev_vowel = False
    for i in range(len(stem)):
        cons = _is_cons(stem, i)
        if not cons:
            prev_vowel = True
        elif prev_vowel:
            m += 1
            prev_vowel = False
    return m


def _has_vowel(stem):
    return any(not _is_cons(stem, i) for i in range(len(stem)))


def porter_stem(word: str) -> str:
    if len(word) <= 2:
        return word
    w = word

    # step 1a
    if w.endswith("sses"):
        w = w[:-2]
    elif w.endswith("ies"):
        w = w[:-2]
    elif w.endswith("ss"):
        pass
    elif w.endswith("s"):
        w = w[:-1]
    # step 1b
    flag = False
    if w.endswith("eed"):
        if _measure(w[:-3]) > 0:
            w = w[:-1]
    elif w.endswith("ed") and _has_vowel(w[:-2]):
        w = w[:-2]
        flag = True
    elif w.endswith("ing") and _has_vowel(w[:-3]):
        w = w[:-3]
        flag = True
    if flag:
        if w.endswith(("at", "bl", "iz")):
            w += "e"
        elif (
            len(w) >= 2
            and w[-1] == w[-2]
            and _is_cons(w, len(w) - 1)
            and w[-1] not in "lsz"
        ):
            w = w[:-1]
        elif _measure(w) == 1 and _cvc(w):
            w += "e"
    # step 1c
    if w.endswith("y") and _has_vowel(w[:-1]):
        w = w[:-1] + "i"
    # step 2
    for suf, rep in (
        ("ational", "ate"), ("tional", "tion"), ("enci", "ence"), ("anci", "ance"),
        ("izer", "ize"), ("abli", "able"), ("alli", "al"), ("entli", "ent"),
        ("eli", "e"), ("ousli", "ous"), ("ization", "ize"), ("ation", "ate"),
        ("ator", "ate"), ("alism", "al"), ("iveness", "ive"), ("fulness", "ful"),
        ("ousness", "ous"), ("aliti", "al"), ("iviti", "ive"), ("biliti", "ble"),
    ):
        if w.endswith(suf):
            if _measure(w[: -len(suf)]) > 0:
                w = w[: -len(suf)] + rep
            break
    # step 3
    for suf, rep in (
        ("icate", "ic"), ("ative", ""), ("alize", "al"), ("iciti", "ic"),
        ("ical", "ic"), ("ful", ""), ("ness", ""),
    ):
        if w.endswith(suf):
            if _measure(w[: -len(suf)]) > 0:
                w = w[: -len(suf)] + rep
            break
    # step 4
    for suf in (
        "al", "ance", "ence", "er", "ic", "able", "ible", "ant", "ement",
        "ment", "ent", "ou", "ism", "ate", "iti", "ous", "ive", "ize",
    ):
        if w.endswith(suf):
            if _measure(w[: -len(suf)]) > 1:
                w = w[: -len(suf)]
            break
    else:
        if w.endswith("ion") and len(w) > 3 and w[-4] in "st" and _measure(w[:-3]) > 1:
            w = w[:-3]
    # step 5a
    if w.endswith("e"):
        stem = w[:-1]
        m = _measure(stem)
        if m > 1 or (m == 1 and not _cvc(stem)):
            w = stem
    # step 5b
    if len(w) >= 2 and w[-1] == "l" and w[-2] == "l" and _measure(w) > 1:
        w = w[:-1]
    return w


def _cvc(w):
    if len(w) < 3:
        return False
    return (
        _is_cons(w, len(w) - 3)
        and not _is_cons(w, len(w) - 2)
        and _is_cons(w, len(w) - 1)
        and w[-1] not in "wxy"
    )


_SNOWBALL_LANGS = frozenset(
    "arabic danish dutch english finnish french german hungarian italian "
    "norwegian portuguese romanian russian spanish swedish".split()
)

# the full reference language set (fts/mod.rs:176-208)
STEMMER_LANGS = _SNOWBALL_LANGS | {"greek", "tamil", "turkish"}


def make_stemmer(lang: str = "english"):
    """Stemmer filter for all 18 reference languages (fts/mod.rs:176-208):
    Snowball algorithms via nltk for 15 of them, compact suffix-stripping
    implementations (fts/stemmers_extra.py) for greek/tamil/turkish."""
    lang = lang.lower()
    if lang == "en":
        lang = "english"
    if lang not in STEMMER_LANGS:
        from ..utils.errors import QueryError

        raise QueryError(f"Unsupported language: {lang}")
    if lang in ("greek", "tamil", "turkish"):
        from . import stemmers_extra

        stem = {
            "greek": stemmers_extra.stem_greek,
            "tamil": stemmers_extra.stem_tamil,
            "turkish": stemmers_extra.stem_turkish,
        }[lang]
    else:
        try:
            from nltk.stem.snowball import SnowballStemmer

            stem = SnowballStemmer(lang).stem
        except Exception:  # pragma: no cover — nltk absent: porter fallback
            stem = porter_stem if lang == "english" else (lambda w: w)

    def f(tokens):
        return [
            Token(stem(t.text), t.position, t.offset_from, t.offset_to)
            for t in tokens
        ]

    return f


_STOPWORDS_CACHE: dict = {}


def stopwords_for_lang(lang: str) -> frozenset:
    """Per-language stopword lists (ISO 639-1 codes, 58 languages), the
    same stopwords-iso data (MIT) the reference vendors
    (fts/tokenizer/stop_word_filter/stopwords.rs)."""
    got = _STOPWORDS_CACHE.get(lang)
    if got is not None:
        return got
    if not _STOPWORDS_CACHE:
        import json as _json
        import os as _os

        path = _os.path.join(_os.path.dirname(__file__), "stopwords_data.json")
        for code, words in _json.load(open(path, encoding="utf-8")).items():
            _STOPWORDS_CACHE[code] = frozenset(words)
    got = _STOPWORDS_CACHE.get(lang)
    if got is None:
        from ..utils.errors import QueryError

        raise QueryError(f"Unsupported language: {lang}")
    return got


_LANG_ALIASES = {
    "english": "en", "german": "de", "french": "fr", "spanish": "es",
    "italian": "it", "portuguese": "pt", "dutch": "nl", "danish": "da",
    "norwegian": "no", "swedish": "sv", "finnish": "fi", "russian": "ru",
    "arabic": "ar", "hungarian": "hu", "romanian": "ro", "greek": "el",
    "turkish": "tr", "tamil": "ta", "chinese": "zh", "japanese": "ja",
}


def make_stopwords(arg) -> callable:
    if isinstance(arg, str):
        code = _LANG_ALIASES.get(arg.lower(), arg.lower())
        words = stopwords_for_lang(code)
    else:
        words = frozenset(str(w).lower() for w in arg)

    def f(tokens):
        return [t for t in tokens if t.text.lower() not in words]

    return f


# --- analyzer construction ---------------------------------------------------------


class TextAnalyzer:
    def __init__(self, tokenize, filters) -> None:
        self.tokenize_fn = tokenize
        self.filters = filters

    def analyze(self, text: str) -> List[Token]:
        toks = self.tokenize_fn(text)
        for f in self.filters:
            toks = f(toks)
        return toks

    def analyze_texts(self, texts: List[str]) -> List[List[str]]:
        """Batch analyze, TEXT ONLY (positions/offsets dropped) — the bulk
        LSH/minhash path needs token strings, not spans.  Fast path for
        Simple/Whitespace tokenizers: ONE regex pass over a joined buffer
        (per-doc analyze() costs ~20µs of dispatch), then the filter
        chain runs once per UNIQUE token via a memo (backfill chunks
        repeat vocabulary heavily; stemmers/stopwords are pure per-token
        functions of the text)."""
        if self.tokenize_fn is tok_simple:
            pat = _SIMPLE_RE
        elif self.tokenize_fn is tok_whitespace:
            pat = re.compile(r"\S+")
        else:
            return [[t.text for t in self.analyze(x)] for x in texts]
        bounds = []
        pos = 0
        for x in texts:
            pos += len(x) + 1
            bounds.append(pos)
        joined = "\n".join(texts) + "\n"
        per_doc: List[List[str]] = [[] for _ in texts]
        if self.filters:
            memo: dict = {}
            d = 0
            for m in pat.finditer(joined):
                s = m.start()
                while s >= bounds[d]:
                    d += 1
                raw = m.group(0)
                out = memo.get(raw)
                if out is None:
                    toks = [Token(raw, 0, 0, len(raw))]
                    for f in self.filters:
                        toks = f(toks)
                    out = [t.text for t in toks]
                    memo[raw] = out
                per_doc[d].extend(out)
        else:
            d = 0
            for m in pat.finditer(joined):
                s = m.start()
                while s >= bounds[d]:
                    d += 1
                per_doc[d].append(m.group(0))
        return per_doc


def build_analyzer(tokenizer_spec, filter_specs) -> TextAnalyzer:
    """tokenizer_spec = (name, args); filter_specs = [(name, args), ...]
    (matches the parse of ::fts/::lsh create options)."""
    name, args = tokenizer_spec
    if name == "Raw":
        tok = tok_raw
    elif name == "Simple":
        tok = tok_simple
    elif name == "Whitespace":
        tok = tok_whitespace
    elif name == "NGram":
        min_g = int(args[0]) if len(args) > 0 else 1
        max_g = int(args[1]) if len(args) > 1 else min_g
        prefix = bool(args[2]) if len(args) > 2 else False
        tok = make_ngram(min_g, max_g, prefix)
    elif name == "Cangjie":
        kind = str(args[0]) if args else "default"
        hmm = bool(args[1]) if len(args) > 1 else False
        tok = make_cangjie(kind, hmm)
    else:
        raise QueryError(f"unknown tokenizer '{name}'")
    filters = []
    for fname, fargs in filter_specs:
        if fname == "AlphaNumOnly":
            filters.append(flt_alpha_num_only)
        elif fname == "AsciiFolding":
            filters.append(flt_ascii_folding)
        elif fname in ("LowerCase", "Lowercase"):
            filters.append(flt_lowercase)
        elif fname == "RemoveLong":
            filters.append(make_remove_long(int(fargs[0])))
        elif fname == "SplitCompoundWords":
            filters.append(make_split_compound([str(w) for w in fargs[0]]))
        elif fname == "Stemmer":
            filters.append(make_stemmer(str(fargs[0]) if fargs else "english"))
        elif fname == "Stopwords":
            filters.append(make_stopwords(fargs[0] if fargs else "english"))
        else:
            raise QueryError(f"unknown token filter '{fname}'")
    return TextAnalyzer(tok, filters)
