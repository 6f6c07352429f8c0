"""Full-text search (`cozo_tpu_torch/fts/`) against the JAX package's
(`cozo_tpu/fts/`): the tokenizers and filters give the same tokens on the
same texts, and the FTS scripts of `test_fts_lsh.py` and
`test_tokenizers_i18n.py` (create and search, AND / OR / NOT, prefix and
phrase, maintenance on `:put` and `:rm`, NEAR, German stemming, Chinese)
give the same rows through both Dbs (`run_both`: headers and rows equal,
scores exactly: both packages compute them in the same host code).  Both
packages run with the same installed `jieba` and `nltk`, where present."""

import pytest

import cozo_tpu.fts.tokenizer as J
import cozo_tpu_torch.fts.tokenizer as T
from tests.test_torch_db_scripts import new_dbs, run_both

TEXTS = [
    "Hello, World! Déjà vu",
    "The quick extraordinarily brown fox jumps over the lazy dog",
    "a b,c  d\tnew\nline",
    "running runs ran flies caresses",
    "abc",
    "",
    "你好world 今天天气很好",
    "Die aufeinanderfolgenden Ereignisse",
]

# (tokenizer, filters) of test_fts_lsh.py::test_tokenizers and
# test_stopwords_and_remove_long, and test_analyze_texts_batch_parity
ANALYZERS = [
    (("Simple", []), [("LowerCase", [])]),
    (("Simple", []), [("AsciiFolding", []), ("LowerCase", [])]),
    (("NGram", [2, 3, False]), []),
    (("NGram", [2, 3]), []),
    (("Whitespace", []), []),
    (("Cangjie", []), []),
    (("Simple", []), [("LowerCase", []), ("Stopwords", [["the"]]),
                      ("RemoveLong", [8])]),
    (("Simple", []), [("LowerCase", []), ("Stemmer", ["english"])]),
    (("Simple", []), [("LowerCase", []), ("Stemmer", ["german"]),
                      ("Stopwords", ["de"])]),
]


def spans(analyzer, text):
    return [(t.text, t.position, t.offset_from, t.offset_to)
            for t in analyzer.analyze(text)]


@pytest.mark.parametrize("tok,filters", ANALYZERS,
                         ids=[f"{a[0][0]}-{len(a[1])}" for a in ANALYZERS])
def test_analyzers_give_the_same_tokens(tok, filters):
    j = J.build_analyzer(tok, filters)
    t = T.build_analyzer(tok, filters)
    for text in TEXTS:
        assert spans(t, text) == spans(j, text), text
    assert t.analyze_texts(TEXTS) == j.analyze_texts(TEXTS)


def _toks(mod, ws):
    return [mod.Token(w, i, 0, 0) for i, w in enumerate(ws)]


WORDS = ["running", "aufeinanderfolgenden", "continuellement",
         "следующими", "corriendo", "kitaplarımızdan", "test", "flies"]


@pytest.mark.parametrize("lang", sorted(J.STEMMER_LANGS))
def test_stemmers_give_the_same_stems(lang):
    assert T.STEMMER_LANGS == J.STEMMER_LANGS
    got = [t.text for t in T.make_stemmer(lang)(_toks(T, WORDS))]
    assert got == [t.text for t in J.make_stemmer(lang)(_toks(J, WORDS))]


def test_stopwords_cangjie_and_porter_are_the_jax_packages():
    for code in ("en", "de", "fr", "ru", "zh", "ja", "ar", "fi"):
        assert T.stopwords_for_lang(code) == J.stopwords_for_lang(code)
    ws = ["und", "haus", "der", "baum", "foo", "bar"]
    for arg in ("de", ["foo"]):
        assert ([t.text for t in T.make_stopwords(arg)(_toks(T, ws))]
                == [t.text for t in J.make_stopwords(arg)(_toks(J, ws))])
    for mode in ("default", "search"):
        for text in ("今天天气很好", "中华人民共和国", "你好world"):
            assert ([t.text for t in T.make_cangjie(mode)(text)]
                    == [t.text for t in J.make_cangjie(mode)(text)])
    for w in ("running", "flies", "caresses", "generously", "sky"):
        assert T.porter_stem(w) == J.porter_stem(w)
    with pytest.raises(Exception):
        T.make_stemmer("klingon")


DOCS = [
    [1, "The quick brown fox jumps over the lazy dog"],
    [2, "A fast auburn fox leaped over a sleepy canine"],
    [3, "Lorem ipsum dolor sit amet"],
    [4, "The dog sleeps while the fox runs"],
]
CREATE = ("::fts create docs:ft {extractor: body, tokenizer: Simple, "
          "filters: [Lowercase]}")


def seeded():
    dbs = new_dbs()
    run_both(dbs, ":create docs {id: Int => body: String}")
    run_both(dbs, "?[id, body] <- $rows :put docs {id => body}",
             {"rows": DOCS})
    run_both(dbs, CREATE)
    return dbs


SEARCHES = [
    "?[id, s] := ~docs:ft{id | query: 'fox', k: 10, bind_score: s}",
    "?[id] := ~docs:ft{id | query: 'fox AND dog', k: 10}",
    "?[id] := ~docs:ft{id | query: 'fox NOT dog', k: 10}",
    "?[id] := ~docs:ft{id | query: 'lorem OR canine', k: 10}",
    "?[id] := ~docs:ft{id | query: 'sle*', k: 10}",
    "?[id] := ~docs:ft{id | query: 'quick brown', k: 10}",
    "?[id, s] := ~docs:ft{id | query: '\"lazy dog\"', k: 10, bind_score: s}",
    "?[id] := ~docs:ft{id | query: 'NEAR/4(fox dog)', k: 10}",
    "?[id] := ~docs:ft{id | query: 'NEAR/5(fox dog)', k: 10}",
    "?[id, s] := ~docs:ft{id | query: 'fox', k: 2, bind_score: s}",
    "?[id, s] := ~docs:ft{id | query: 'fox dog', k: 10, bind_score: s, "
    "score_kind: 'tf'}",
]


@pytest.mark.parametrize("script", SEARCHES)
def test_fts_searches_give_the_same_rows(script):
    res = run_both(seeded(), script)
    assert res.rows or "NOT" in script


def test_fts_maintenance_gives_the_same_rows():
    """`:put` of a new doc, `:rm`, and an update that reindexes."""
    dbs = seeded()
    q = "?[id, s] := ~docs:ft{id | query: 'fox', k: 10, bind_score: s}"
    run_both(dbs, "?[id, body] <- [[5, 'another fox story']] "
                  ":put docs {id => body}")
    assert 5 in [r[0] for r in run_both(dbs, q).rows]
    run_both(dbs, "?[id] <- [[1]] :rm docs {id}")
    assert 1 not in [r[0] for r in run_both(dbs, q).rows]
    run_both(dbs, "?[id, body] <- [[2, 'nothing here']] :put docs {id => body}")
    assert sorted(r[0] for r in run_both(dbs, q).rows) == [4, 5]
    run_both(dbs, "::fts drop docs:ft", errors=True)
    run_both(dbs, "?[id, body] <- [[6, 'fox']] :put docs {id => body}")


def test_fts_errors_are_the_same():
    dbs = seeded()
    run_both(dbs, CREATE, errors=True)  # exists already
    run_both(dbs, "?[id] := ~docs:ft{id | k: 3}", errors=True)  # no query
    run_both(dbs, "?[id] := ~docs:nope{id | query: 'fox', k: 3}", errors=True)


def test_fts_german_and_chinese_scripts_give_the_same_rows():
    dbs = new_dbs()
    run_both(dbs, ":create art {id: Int => body: String}")
    run_both(dbs, "::fts create art:ft {extractor: body, tokenizer: Simple, "
                  "filters: [Lowercase, Stemmer('german'), Stopwords('de')]}")
    run_both(dbs, '?[id, body] <- [[1, "Die aufeinanderfolgenden '
                  'Ereignisse"], [2, "Ein ruhiger Tag"]] :put art {id => body}')
    for q in ("aufeinanderfolgende", "ereignis", "die"):
        run_both(dbs, f"?[id, s] := ~art:ft{{id | query: '{q}', k: 5, "
                      "bind_score: s}")
    run_both(dbs, ":create zh {id: Int => body: String}")
    run_both(dbs, "::fts create zh:ft {extractor: body, "
                  "tokenizer: Cangjie('search')}")
    run_both(dbs, '?[id, body] <- [[1, "今天天气很好"], [2, "明天下雨"]] '
                  ":put zh {id => body}")
    res = run_both(dbs, "?[id, s] := ~zh:ft{id | query: '天气', k: 5, "
                        "bind_score: s}")
    assert [r[0] for r in res.rows] == [1]
