"""MinHash-LSH through `cozo_tpu_torch.Db` against `cozo_tpu.Db`: the LSH
scripts of `test_fts_lsh.py` (create and search, maintenance on `:put`
and `:rm`, bulk backfill equal to incremental indexing, band parameters
that do not divide n_perm) and the batched join of
`benches/bench_lsh_1m.py`, through both Dbs on the CPU (`run_both`:
headers and rows equal; similarities exactly, both being the mean of
equal signature entries).

The corpus is 2,000 docs of 8-17 words (~25,000 tokens), so each
backfill chunk passes `DEVICE_MIN_TOKENS`: the JAX package takes its
device segment-min (jitted on the JAX CPU device), the port its device
route, which on a CPU Db is the kernel's plain version.  The signature
bytes stored in each Db's inverse relation must be EQUAL, and equal to
the host `minhash_segments`."""

import numpy as np
import pytest

import cozo_tpu_torch.ops.minhash as T
from tests.test_torch_db_scripts import new_dbs, run_both

N_DOCS, VOCAB = 2000, 400


def corpus(n=N_DOCS, seed=5):
    """n docs of 8-17 words over VOCAB words; doc i + n // 2 repeats doc i
    (i < 50) with its first word replaced, as the bench plants them."""
    rng = np.random.default_rng(seed)
    docs = [" ".join(f"w{w}" for w in rng.integers(0, VOCAB,
                                                   8 + rng.integers(0, 10)))
            for _ in range(n)]
    for i in range(50):
        words = docs[i].split()
        words[0] = "wDUP"
        docs[n // 2 + i] = " ".join(words)
    return docs


CREATE = ("::lsh create doc:sim {extractor: body, tokenizer: Simple, "
          "n_perm: 128, target_threshold: 0.7}")


@pytest.fixture(scope="module")
def dbs_and_docs():
    """Both Dbs holding the corpus under `::lsh create` (a backfill through
    each package's device route; the port's counted)."""
    docs = corpus()
    dbs = new_dbs()
    run_both(dbs, ":create doc {id: Int => body: String}")
    run_both(dbs, "?[id, body] <- $rows :put doc {id => body}",
             {"rows": [[i, d] for i, d in enumerate(docs)]})
    calls = []
    real = T._dispatch
    T._dispatch = lambda *a: calls.append(len(a[0])) or real(*a)
    try:
        run_both(dbs, CREATE)
    finally:
        T._dispatch = real
    assert calls and min(calls) >= T.DEVICE_MIN_TOKENS
    return dbs, docs


def signatures(dbs):
    """Each Db's stored signature bytes, by id."""
    res = run_both(dbs, "?[id, s] := *doc:sim:inv{id, signature: s}")
    return {r[0]: r[1] for r in res.rows}


def test_backfill_signatures_are_equal_and_the_hosts(dbs_and_docs):
    dbs, docs = dbs_and_docs
    stored = signatures(dbs)
    assert len(stored) == N_DOCS
    from cozo_tpu_torch.fts.tokenizer import build_analyzer

    toks = build_analyzer(("Simple", []), []).analyze_texts(docs)
    offs = np.zeros(len(toks), np.int64)
    np.cumsum([len(t) for t in toks[:-1]], out=offs[1:])
    flat = T.hash_tokens_dedup([t for ts in toks for t in ts])
    assert len(flat) >= T.DEVICE_MIN_TOKENS
    host = T.minhash_segments(flat, offs, 128)
    assert all(stored[i] == host[i].tobytes() for i in range(N_DOCS))


@pytest.mark.parametrize("q", [0, 7, 49, 300])
def test_single_queries_give_the_same_rows(dbs_and_docs, q):
    dbs, docs = dbs_and_docs
    res = run_both(dbs, "?[id, s] := ~doc:sim{id | query: $q, k: 5, "
                        "bind_similarity: s}", {"q": docs[q]})
    assert [q, 1.0] in res.rows
    if q < 50:
        assert N_DOCS // 2 + q in [r[0] for r in res.rows]


def test_search_options_give_the_same_rows(dbs_and_docs):
    dbs, docs = dbs_and_docs
    run_both(dbs, "?[id] := ~doc:sim{id | query: $q}", {"q": docs[3]})
    run_both(dbs, "?[id, s] := ~doc:sim{id | query: $q, k: 2, "
                  "filter: id > 10, bind_similarity: s}", {"q": docs[20]})
    run_both(dbs, "?[id, body] := ~doc:sim{id, body | query: 'w1 w2 w3', "
                  "k: 3}")
    for bad in ("?[id] := ~doc:sim{id | k: 3}",
                "?[id] := ~doc:sim{id | query: 1, k: 3}",
                "?[id] := ~doc:sim{id | query: 'a', k: 3, bogus: 1}"):
        run_both(dbs, bad, errors=True)


def test_batched_join_gives_the_same_rows(dbs_and_docs):
    """The bench's set-at-a-time join: every stored query through one
    serving-image pass."""
    dbs, docs = dbs_and_docs
    run_both(dbs, ":create q {qid: Int => body: String}")
    run_both(dbs, "?[qid, body] <- $rows :put q {qid => body}",
             {"rows": [[i, docs[i]] for i in range(100)]})
    res = run_both(dbs, "?[qid, id] := *q{qid, body}, "
                        "~doc:sim{id | query: body, k: 5}")
    pairs = {(r[0], r[1]) for r in res.rows}
    assert sum((i, N_DOCS // 2 + i) in pairs for i in range(50)) >= 45


def seed_small(dbs, n_perm=100, threshold=0.3):
    run_both(dbs, ":create docs {id: Int => body: String}")
    run_both(dbs, "?[id, body] <- $rows :put docs {id => body}", {"rows": [
        [1, "The quick brown fox jumps over the lazy dog"],
        [2, "A fast auburn fox leaped over a sleepy canine"],
        [3, "Lorem ipsum dolor sit amet"],
        [4, "The dog sleeps while the fox runs"],
    ]})
    run_both(dbs, "::lsh create docs:lsh {extractor: body, tokenizer: Simple, "
                  f"filters: [Lowercase], n_perm: {n_perm}, "
                  f"target_threshold: {threshold}, n_gram: 1}}")


QUERY = ("?[id, s] := ~docs:lsh{id | query: 'The quick brown fox jumps "
         "over the lazy dog', k: 5, bind_similarity: s}")


def test_lsh_create_search_and_maintenance_give_the_same_rows():
    dbs = new_dbs()
    seed_small(dbs)
    assert 1 in [r[0] for r in run_both(dbs, QUERY).rows]
    run_both(dbs, "?[id] := ~docs:lsh{id | query: 'The quick brown fox jumps "
                  "over a lazy dog', k: 3}")
    run_both(dbs, "?[id] <- [[1]] :rm docs {id}")
    assert 1 not in [r[0] for r in run_both(dbs, QUERY).rows]
    run_both(dbs, "?[id, body] <- [[5, 'the quick brown fox jumps over the "
                  "lazy dog again']] :put docs {id => body}")
    run_both(dbs, "?[id, body] <- [[4, 'nothing alike']] :put docs {id => body}")
    assert 5 in [r[0] for r in run_both(dbs, QUERY).rows]
    res = run_both(dbs, "?[id, s] := *docs:lsh:inv{id, signature: s}")
    assert sorted(r[0] for r in res.rows) == [2, 3, 4, 5]
    run_both(dbs, "::lsh create docs:lsh {extractor: body, tokenizer: Simple, "
                  "n_perm: 8, target_threshold: 0.5}", errors=True)


def test_ngrams_and_the_self_match_give_the_same_rows():
    dbs = new_dbs()
    run_both(dbs, ":create sents {id: Int => t: String}")
    run_both(dbs, "?[id, t] <- $rows :put sents {id => t}", {"rows": [
        [i, f"sentence number {i} about topic {i % 3}"] for i in range(30)]})
    run_both(dbs, "::lsh create sents:l {extractor: t, tokenizer: Simple, "
                  "filters: [Lowercase], n_perm: 64, target_threshold: 0.5, "
                  "n_gram: 2}")
    res = run_both(dbs, "?[id] := ~sents:l{id | query: 'sentence number 7 "
                        "about topic 1', k: 1}")
    assert res.rows[0][0] == 7


def test_bulk_backfill_matches_incremental():
    """A doc put after `::lsh create` is found exactly like one indexed by
    the backfill, in both Dbs."""
    dbs = new_dbs()
    run_both(dbs, ":create bk {id: Int => t: String}")
    run_both(dbs, "?[id, t] <- $rows :put bk {id => t}", {"rows": [
        [i, f"alpha beta gamma delta {i % 5}"] for i in range(200)]})
    run_both(dbs, "::lsh create bk:l {extractor: t, tokenizer: Simple, "
                  "filters: [Lowercase], n_perm: 64, target_threshold: 0.5, "
                  "n_gram: 1}")
    run_both(dbs, "?[id, t] <- [[999, 'alpha beta gamma delta 99'], "
                  "[3, 'alpha beta gamma delta 3']] :put bk {id => t}")
    res = run_both(dbs, "?[id, s] := ~bk:l{id | query: 'alpha beta gamma "
                        "delta 99', k: 3, bind_similarity: s}")
    assert [999, 1.0] in res.rows
    res = run_both(dbs, "?[id, s] := *bk:l:inv{id, signature: s}")
    assert len(res.rows) == 201


def test_nondividing_band_params_give_the_same_rows():
    """n_perm 128 at threshold 0.7 takes 14 bands x 9 rows (126 of 128):
    the serving image answers in both Dbs, and never falls back."""
    from cozo_tpu_torch.utils import fallback

    dbs = new_dbs()
    seed_small(dbs, n_perm=128, threshold=0.7)
    before = fallback.counts().get("lsh.serving_image", 0)
    res = run_both(dbs, QUERY)
    assert 1 in [r[0] for r in res.rows]
    assert fallback.counts().get("lsh.serving_image", 0) == before
