"""`cozo_tpu_torch.Db` against `cozo_tpu.Db` on relational CozoScript:
rules, recursion, aggregations, magic sets, mutations, `:order` /
`:limit`, imperative scripts and sys-ops.  Each case is a short sequence
of scripts (taken from `test_query_basic.py`, `test_aggr.py`,
`test_magic.py` and `test_misc_features.py`) run through a fresh Db of
each package; every step's headers and rows must be equal, values
compared exactly, and a step that fails must fail in both.

The helpers here (`new_dbs`, `run_both`, `norm`, `same`, `rows_sorted`)
run one script through both packages' Dbs, on the CPU, and compare
headers and rows; `test_torch_db_hnsw.py` and `test_torch_db_storage.py`
use them too.  Relational values are compared exactly (each package's
own `cmp_key`, and vectors element by element); floats exactly too
unless a caller passes a tolerance, which then applies to every float of
the rows (distances from the device lanes)."""

import math

import numpy as np
import pytest


def _module_of(v):
    import importlib

    return importlib.import_module(type(v).__module__)


def norm(v):
    """A plain, comparable form of one value of either package."""
    if isinstance(v, bool) or v is None or isinstance(v, (int, str, bytes)):
        return v
    if isinstance(v, float):
        return v
    if isinstance(v, (list, tuple)):
        return [norm(x) for x in v]
    if isinstance(v, np.ndarray):
        return ("ndarray", str(v.dtype), [norm(x) for x in v.tolist()])
    name = type(v).__name__
    if name == "Vector":
        return ("Vector", str(v.a.dtype), [float(x) for x in v.a.tolist()])
    return (name, _module_of(v).cmp_key(v))


def same(a, b, tol=None) -> bool:
    if isinstance(a, float) and isinstance(b, float):
        if math.isnan(a) or math.isnan(b):
            return math.isnan(a) and math.isnan(b)
        if tol is None:
            return a == b
        return abs(a - b) <= tol * (1.0 + abs(b))
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(same(x, y, tol) for x, y in zip(a, b))
    return type(a) is type(b) and a == b


def new_dbs(engine="mem", path_jax="", path_torch=""):
    import cozo_tpu
    import cozo_tpu_torch

    return (cozo_tpu.Db(engine, path_jax),
            cozo_tpu_torch.Db(engine, path_torch, device="cpu"))


def run_both(dbs, script, params=None, tol=None, errors=False):
    """Run `script` in the JAX Db and in the port's; assert equal headers
    and rows.  With `errors`, a script may also fail, in both packages
    with the same error class; the port's exception is then returned.
    Returns the port's NamedRows."""
    outs = []
    for db in dbs:
        try:
            outs.append(db.run_script(script, params))
        except Exception as e:  # noqa: BLE001 - compared below
            outs.append(e)
    j, t = outs
    if isinstance(j, Exception) or isinstance(t, Exception):
        if not errors:
            raise t if isinstance(t, Exception) else j
        assert type(j).__name__ == type(t).__name__, (script, j, t)
        return t
    assert j.headers == t.headers, (script, j.headers, t.headers)
    nj, nt = norm(j.rows), norm(t.rows)
    assert same(nt, nj, tol), (script, j.rows[:8], t.rows[:8])
    return t


def rows_sorted(res):
    return sorted(tuple(r) for r in res.rows)

EDGES = [[i, i + 1] for i in range(50)] + [[100 + i, 101 + i] for i in range(50)]
MAGIC_SEED = ("?[f, t] <- $e :create e {f, t}", {"e": EDGES})
TC = """
tc[a, b] := *e[a, b]
tc[a, c] := tc[a, b], *e[b, c]
?[b] := tc[1, b]
"""

CASES = {
    # test_query_basic.py
    "const_rule": ["?[a] <- [[1], [2], [1]]"],
    "expressions": ["?[a, b] := a in [1, 2, 3], b = a * 2, b > 2"],
    "joins": [
        "?[a, b] <- [[1, 'x'], [2, 'y']] :create r1 {a => b}",
        "?[a, c] <- [[1, 10], [2, 20], [3, 30]] :create r2 {a => c}",
        "?[b, c] := *r1[a, b], *r2[a, c]",
    ],
    "transitive_closure": [
        "?[f, t] <- [[1,2],[2,3],[3,4]] :create e {f, t}",
        "reach[a, b] := *e[a, b]\nreach[a, c] := reach[a, b], *e[b, c]\n"
        "?[a, b] := reach[a, b]",
    ],
    "negation": [
        "?[a] <- [[1],[2],[3]] :create n1 {a}",
        "?[a] <- [[2]] :create n2 {a}",
        "?[a] := *n1[a], not *n2[a]",
    ],
    "disjunction": ["r[a] <- [[1],[2]]; s[a] <- [[3]]; ?[a] := r[a] or s[a]"],
    "aggregations": [
        "?[count(a), sum(a), min(a), max(a)] := a in [1, 2, 3, 4]",
        "?[a, count(b)] := a in [1, 2], b in [10, 20, 30]",
    ],
    "meet_shortest_path": [
        "?[f, t, w] <- [['a','b',1.0],['b','c',2.0],['a','c',5.0]] "
        ":create edge {f, t => w}",
        "sp[t, min(c)] := *edge['a', t, w], c = w\n"
        "sp[t, min(c)] := sp[m, c0], *edge[m, t, w], c = c0 + w\n"
        "?[t, c] := sp[t, c]",
    ],
    "order_limit_offset": [
        "?[a] := a in [5, 3, 1, 4, 2] :order -a :limit 2 :offset 1",
        "?[a, b] := a in [3, 1, 2], b = -a :order b",
        "?[a] := a in [9, 7, 8, 6] :limit 2",
    ],
    "put_update_rm": [
        ":create t1 {k: Int => v: Int}",
        "?[k, v] <- [[1, 10], [2, 20]] :put t1 {k => v}",
        "?[k, v] := *t1[k, v]",
        "?[k, v] <- [[1, 11]] :put t1 {k => v}",
        "?[v] := *t1[1, v]",
        "?[k] <- [[2]] :rm t1 {k}",
        "?[k, v] := *t1[k, v]",
    ],
    "insert_conflict": [
        ":create t2 {k: Int}",
        "?[k] <- [[1]] :insert t2 {k}",
        "?[k] <- [[1]] :insert t2 {k}",
        "?[k] := *t2[k]",
    ],
    "update_keeps_columns": [
        ":create t3 {k => a default 0, b default 0}",
        "?[k, a, b] <- [[1, 5, 6]] :put t3 {k => a, b}",
        "?[k, a] <- [[1, 50]] :update t3 {k => a}",
        "?[a, b] := *t3[1, a, b]",
    ],
    "defaults": [
        ":create t4 {k: Int => v: Int default 42}",
        "?[k] <- [[1]] :put t4 {k}",
        "?[v] := *t4[1, v]",
    ],
    "named_access": [
        ":create loc {name: String => lat: Float, lon: Float}",
        "?[name, lat, lon] <- [['a', 1.0, 2.0]] :put loc {name => lat, lon}",
        "?[lat] := *loc{name: 'a', lat}",
    ],
    "unstratifiable": [
        "p[a] := a in [1], not q[a]; q[a] := a in [1], not p[a]; ?[a] := p[a]",
    ],
    "assertions": [
        "?[a] <- [[1]] :assert some",
        "?[a] <- [[1]] :assert none",
        "?[a] <- [] :assert none",
    ],
    "fixed_rules_small": [
        "?[f, t] <- [[1,2],[2,3],[3,1],[1,3]] :create pr_e {f, t}",
        "?[node, score] <~ PageRank(*pr_e[])",
        "?[f, t, w] <- [['a','b',1.0],['b','c',1.0],['a','c',5.0]] "
        ":create dj {f, t => w}",
        "st[n] <- [['a']]; en[n] <- [['c']]; "
        "?[s, g, c, p] <~ ShortestPathDijkstra(*dj[], st[], en[])",
        "?[f, t] <- [['a','b'],['b','c']] :create ts {f, t}",
        "?[i, n] <~ TopSort(*ts[])",
    ],
    "reorder_sort": [
        "r[a, b] <- [[1, 'x'], [3, 'z'], [2, 'y']]; "
        "?[rank, b] <~ ReorderSort(r[a, b], out: [b], sort_by: a, "
        "descending: true)",
    ],
    "sys_relations": [
        ":create sysrel {a}",
        "::relations",
        "::columns sysrel",
        "::rename sysrel -> sysrel2",
        "::relations",
        "::remove sysrel2",
        "::relations",
        "::fixed_rules",
        "::fallbacks",
    ],
    "triggers": [
        ":create main_rel {k => v}",
        ":create audit {k => v}",
        "::set_triggers main_rel on put { ?[k, v] := _new[k, v] "
        ":put audit {k => v} }",
        "?[k, v] <- [[1, 2]] :put main_rel {k => v}",
        "?[k, v] := *audit[k, v]",
    ],
    "imperative_loop": [
        """
        {?[a] <- [[1]] :replace _test {a}}
        %loop
            %if { ?[x] := *_test[x], x >= 10 }
                %then %break
            %end
            { ?[a] := *_test[b], a = b + 1 :replace _test {a} }
        %end
        %return _test
        """,
    ],
    "params": [("?[a] := a in $list, a > $min", {"list": [1, 2, 3], "min": 1})],
    "validity_time_travel": [
        ":create hist {k: String, at: Validity => v: Int}",
        "?[k, at, v] <- [['a', [100, true], 1]] :put hist {k, at => v}",
        "?[k, at, v] <- [['a', [200, true], 2]] :put hist {k, at => v}",
        "?[v] := *hist{k: 'a', v @ 150}",
        "?[v] := *hist{k: 'a', v @ 250}",
        "?[v] := *hist{k: 'a', v @ 50}",
    ],
    "disjunct_binding_order": [
        "?[x, y] <- [[1, 10]] :create dr1 {x => y}",
        "?[y, x] <- [[2, 20]] :create dr2 {y => x}",
        "?[s] := (*dr1[x, y] or *dr2[y, x]), s = x * 100 + y",
    ],
    # test_aggr.py
    "aggr_collect_variance": [
        "?[b, collect(a)] := a in [1,2,3,4], b = a % 2",
        "?[variance(a)] := a in [1.0, 2.0, 3.0]",
        "?[group_count(a)] := a in ['x', 'y', 'x']",
        "?[count(a)] := a in []",
        "?[mean(a), std_dev(a), product(a)] := a in [1.0, 2.0, 4.0]",
        "?[a, count_unique(b)] := a in [1, 2], b in ['x', 'y', 'x']",
    ],
    "aggr_recursive_union": [
        "?[f, t] <- [[1,2],[2,3],[1,3]] :create ug {f, t}",
        "grp[x, union(s)] := *ug[x, y], s = [y]\n"
        "grp[x, union(s)] := grp[y, s0], *ug[x, y], s = s0\n"
        "?[x, s] := grp[x, s]",
    ],
    # test_magic.py, each with and without the rewrite
    "magic_transitive": [MAGIC_SEED, TC, TC + " :disable_magic_rewrite true"],
    "magic_aggr_exempt": [
        MAGIC_SEED,
        "cnt[a, count(b)] := *e[a, b]\n?[c] := cnt[1, c]",
        "cnt[a, count(b)] := *e[a, b]\n?[c] := cnt[1, c] "
        ":disable_magic_rewrite true",
    ],
    "magic_negation_exempt": [
        MAGIC_SEED,
        "reach[b] := *e[1, b]\nreach[c] := reach[b], *e[b, c]\n"
        "other[x] := *e[x, y], x > 25\n?[b] := reach[b], not other[b]",
    ],
    "magic_mutual_recursion": [
        MAGIC_SEED,
        "even[a, b] := *e[a, b]\neven[a, c] := odd[a, b], *e[b, c]\n"
        "odd[a, c] := even[a, b], *e[b, c]\n?[b] := odd[1, b]",
    ],
    "magic_multiple_adornments": [
        MAGIC_SEED,
        "tc[a, b] := *e[a, b]\ntc[a, c] := tc[a, b], *e[b, c]\n"
        "?[x, y] := tc[1, x], tc[x, y]",
    ],
    "magic_const_seed": [MAGIC_SEED, "p[a, b] := *e[a, b]\n?[b] := p[3, b]"],
    # test_misc_features.py
    "access_levels": [
        ":create guarded {a}",
        "?[a] <- [[1]] :put guarded {a}",
        "::access_level read_only guarded",
        "?[a] <- [[2]] :put guarded {a}",
        "?[a] := *guarded[a]",
        "::access_level hidden guarded",
        "?[a] := *guarded[a]",
        "::access_level protected guarded",
        "::remove guarded",
    ],
    "returning": [
        ":create ret {k => v}",
        "?[k, v] <- [[1, 2]] :put ret {k => v} :returning",
        "?[k] <- [[1]] :rm ret {k} :returning",
    ],
    "describe": [
        ":create desc_rel {a}",
        "::describe desc_rel 'my relation'",
        "::relations",
    ],
    "json_values": [
        ":create jdoc {k: Int => doc: Json}",
        "?[k, doc] <- [[1, parse_json('{\"a\": {\"b\": 2}}')]] "
        ":put jdoc {k => doc}",
        "?[x] := *jdoc[1, doc], x = doc->'a'->'b'",
        "?[k, doc] := *jdoc[k, doc]",
    ],
    "ensure": [
        ":create ens {k => v}",
        "?[k, v] <- [[1, 2]] :put ens {k => v}",
        "?[k, v] <- [[1, 2]] :ensure ens {k => v}",
        "?[k, v] <- [[1, 3]] :ensure ens {k => v}",
        "?[k] <- [[1]] :ensure_not ens {k}",
        "?[k] <- [[9]] :ensure_not ens {k}",
    ],
    "replace_with_trigger": [
        ":create rp {k}",
        ":create rp_log {k}",
        "::set_triggers rp on put { ?[k] := _new[k] :put rp_log {k} }",
        "?[k] <- [[5]] :replace rp {k}",
        "?[k] <- [[6]] :put rp {k}",
        "?[k] := *rp_log[k]",
    ],
    "functions": [
        "?[a, b, c, d] := a = lowercase('ABC'), b = length([1, 2, 3]), "
        "c = concat('x', 'y'), d = 7 % 3",
        "?[x] := x = to_float(3) / 2",
        "?[v, n] := v = vec([1.0, 2.0, 2.0]), n = l2_normalize(v)",
    ],
    "explain": ["::explain { ?[a] := a in [1, 2] }"],
    "comments_and_semicolons": [
        "# comment line\nr1[a] <- [[1]]; /* block\ncomment */ r2[a] <- [[2]];\n"
        "?[a] := r1[a] or r2[a]",
    ],
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_script_rows_equal(name):
    dbs = new_dbs()
    for step in CASES[name]:
        script, params = step if isinstance(step, tuple) else (step, None)
        run_both(dbs, script, params, errors=True)
