"""Suffix-stripping stemmers for the three reference languages that
nltk's Snowball set does not cover (reference `fts/mod.rs:176-208` maps
greek/tamil/turkish to rust-stemmers algorithms).

These are compact approximations of the Snowball algorithms — longest-
match iterative suffix removal with the language's core constraints
(Turkish vowel harmony, Greek minimum-stem lengths, Tamil layered
case/verb endings).  They normalize inflected forms to shared stems,
which is what the FTS index needs; they are not bit-exact with
rust-stemmers."""

from __future__ import annotations

# --------------------------------------------------------------------- greek

_EL_VOWELS = set("αεηιουω")

_EL_SUFFIXES = [
    # longest first: common noun/adjective/verb endings (Ntais-style step set)
    "ιουσαν", "ουσανε", "ματων", "ματοσ", "ουσεσ", "ηθηκα", "ηθηκε",
    "ονταν", "ομουν", "οσουν", "ουσαν", "ιεμαι", "ιεσαι", "ιεται",
    "ουμε", "ετε", "ουνε", "ονται", "ομαι", "εσαι", "εται",
    "ματα", "αμε", "ατε", "ανε", "ετα", "ηκα", "ηκε", "ησα", "ησε",
    "θηκα", "θηκε", "ουσα", "ουσε", "αγα", "αγε",
    "ων", "ου", "ησ", "εσ", "οσ", "ον", "αν", "ασ", "ια", "ιο",
    "ει", "ικ", "α", "ε", "η", "ι", "ο", "υ", "ω",
]


def stem_greek(word: str) -> str:
    w = word.lower().replace("ς", "σ")
    # strip accents
    trans = str.maketrans("άέήίόύώϊϋΐΰ", "αεηιουωιυιυ")
    w = w.translate(trans)
    for suf in _EL_SUFFIXES:
        if w.endswith(suf) and len(w) - len(suf) >= 3:
            return w[: -len(suf)]
    return w


# -------------------------------------------------------------------- turkish

_TR_FRONT = set("eiöü")
_TR_BACK = set("aıou")

_TR_SUFFIXES = [
    # nominal + possessive + case + verbal endings, longest first
    "larımızdan", "lerimizden", "larımıza", "lerimize",
    "larından", "lerinden", "larımız", "lerimiz", "larınız", "leriniz",
    "larında", "lerinde", "lardan", "lerden", "ları", "leri",
    "ınızı", "inizi", "unuzu", "ünüzü", "lara", "lere", "larda", "lerde",
    "ımız", "imiz", "umuz", "ümüz", "ınız", "iniz", "unuz", "ünüz",
    "ıyor", "iyor", "uyor", "üyor", "acak", "ecek", "mıştı", "mişti",
    "lar", "ler", "dan", "den", "tan", "ten", "nın", "nin", "nun", "nün",
    "ını", "ini", "unu", "ünü", "ında", "inde", "unda", "ünde",
    "mış", "miş", "muş", "müş", "dı", "di", "du", "dü", "tı", "ti", "tu", "tü",
    "ın", "in", "un", "ün", "ım", "im", "um", "üm", "sı", "si", "su", "sü",
    "da", "de", "ta", "te", "ya", "ye", "a", "e", "ı", "i", "u", "ü",
]


def _tr_harmonic(stem: str, suf: str) -> bool:
    """Last stem vowel and first suffix vowel must agree in frontness."""
    sv = next((c for c in reversed(stem) if c in _TR_FRONT or c in _TR_BACK), None)
    fv = next((c for c in suf if c in _TR_FRONT or c in _TR_BACK), None)
    if sv is None or fv is None:
        return True
    return (sv in _TR_FRONT) == (fv in _TR_FRONT)


def stem_turkish(word: str) -> str:
    w = word.lower()
    changed = True
    while changed and len(w) > 4:
        changed = False
        for suf in _TR_SUFFIXES:
            if w.endswith(suf) and len(w) - len(suf) >= 3:
                stem = w[: -len(suf)]
                if _tr_harmonic(stem, suf):
                    w = stem
                    changed = True
                    break
    return w


# ---------------------------------------------------------------------- tamil

_TA_SUFFIXES = [
    # case endings / plural / verbal participles, longest first
    "களுக்கு", "களில்", "களின்", "களால்", "கள்",
    "உக்கு", "ுக்கு", "ிலிருந்து", "ில்", "ின்", "ால்", "ுடன்",
    "ோடு", "ையும்", "ையே", "ை", "ும்", "ாக", "ாய்",
    "கிறேன்", "கிறான்", "கிறாள்", "கிறது", "கின்றன",
    "ந்தேன்", "ந்தான்", "ந்தாள்", "ந்தது",
    "வேன்", "வான்", "வாள்", "வது", "ாமல்", "ாத", "ிய",
]


def stem_tamil(word: str) -> str:
    w = word
    for suf in _TA_SUFFIXES:
        if w.endswith(suf) and len(w) - len(suf) >= 2:
            return w[: -len(suf)]
    return w
