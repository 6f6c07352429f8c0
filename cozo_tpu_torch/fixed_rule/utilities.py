"""Utility fixed rules: Constant, ReorderSort, CsvReader, JsonReader
(reference `cozo-core/src/fixed_rule/utilities/`)."""

from __future__ import annotations

import csv
import io
import json as _json
import os
from typing import Any, Dict, List, Optional

from ..data.expr import Apply, Const, Expr
from ..data.value import cmp_key
from ..utils.errors import QueryError
from . import FixedRule


class Constant(FixedRule):
    """Inline data (`<-` const rules lower to this; reference
    `utilities/constant.rs`)."""

    name = "Constant"

    def arity(self, options, head):
        if head:
            return len(head)
        data = options.get("data")
        if isinstance(data, Const) and isinstance(data.val, list) and data.val:
            return len(data.val[0])
        return None

    def run(self, payload, out_put, poison):
        data = payload.option("data", [])
        if not isinstance(data, list):
            raise QueryError("option 'data' for Constant must be a list")
        for row in data:
            if not isinstance(row, list):
                raise QueryError("rows of 'data' must be lists")
            out_put(list(row))


class ReorderSort(FixedRule):
    """Expression-keyed re-sort with ranking
    (reference `utilities/reorder_sort.rs`): output = [rank, *out_exprs]."""

    name = "ReorderSort"

    def arity(self, options, head):
        out = options.get("out")
        if isinstance(out, Const) and isinstance(out.val, list):
            return len(out.val) + 1
        if isinstance(out, Apply) and out.op.name == "list":
            return len(out.args) + 1
        return None

    def run(self, payload, out_put, poison):
        in_rel = payload.get_input(0)
        out_opt = payload.expr_option("out", None)
        if isinstance(out_opt, Const) and isinstance(out_opt.val, list):
            out_exprs: List[Expr] = [Const(v) for v in out_opt.val]
        elif isinstance(out_opt, Apply) and out_opt.op.name == "list":
            out_exprs = list(out_opt.args)
        else:
            raise QueryError("option 'out' for ReorderSort must be a list")
        sort_by = payload.expr_option("sort_by", Const(None))
        descending = payload.bool_option("descending", False)
        break_ties = payload.bool_option("break_ties", False)
        skip = payload.int_option("skip", 0)
        take = payload.int_option("take", 0)

        bmap = in_rel.binding_map()
        sort_by.fill_binding_indices(bmap)
        for e in out_exprs:
            e.fill_binding_indices(bmap)

        buffer = []
        for tup in in_rel.rows():
            sorter = sort_by.eval(tup)
            row = [e.eval(tup) for e in out_exprs]
            buffer.append((sorter, row))
        buffer.sort(key=lambda x: cmp_key(x[0]), reverse=descending)

        count = 0
        rank = 0
        last_key = None
        limit = (take + skip) if take else None
        for sorter, row in buffer:
            k = cmp_key(sorter)
            count += 1
            if k != last_key:
                rank = count
                last_key = k
            if limit is not None and count > limit:
                break
            if count <= skip:
                continue
            out_put([count if break_ties else rank] + row)


class CsvReader(FixedRule):
    """Load CSV from a local file or URL (reference `utilities/csv.rs`).
    Options: url, types (list of column type strings), delimiter, prepend_index,
    has_headers."""

    name = "CsvReader"

    def arity(self, options, head):
        types = options.get("types")
        n = None
        if isinstance(types, Const) and isinstance(types.val, list):
            n = len(types.val)
        elif isinstance(types, Apply) and types.op.name == "list":
            n = len(types.args)
        if n is None:
            return None
        prepend = options.get("prepend_index")
        if isinstance(prepend, Const) and prepend.val is True:
            n += 1
        return n

    def run(self, payload, out_put, poison):
        from ..data.relation_types import coerce_value
        from ..runtime.relation import parse_col_type_str

        url = payload.string_option("url", None)
        if url is None:
            raise QueryError("option 'url' required for CsvReader")
        types_v = payload.option("types", [])
        types = [parse_col_type_str(t) if isinstance(t, str) else None for t in types_v]
        delimiter = payload.string_option("delimiter", ",")
        prepend_index = payload.bool_option("prepend_index", False)
        has_headers = payload.bool_option("has_headers", True)

        content = _read_url(url)
        reader = csv.reader(io.StringIO(content), delimiter=delimiter)
        rows = iter(reader)
        if has_headers:
            next(rows, None)
        for i, raw in enumerate(rows):
            if poison is not None:
                poison.check()
            if len(raw) < len(types):
                raw = raw + [""] * (len(types) - len(raw))
            out_row: List[Any] = [i] if prepend_index else []
            ok = True
            for cell, t in zip(raw, types):
                try:
                    out_row.append(_coerce_csv_cell(cell, t, coerce_value))
                except Exception:
                    ok = False
                    break
            if ok:
                out_put(out_row)


def _coerce_csv_cell(cell: str, t, coerce_value):
    if t is None or t.kind == "Any":
        return cell
    if t.kind == "Int":
        if cell == "" and t.nullable:
            return None
        return int(cell)
    if t.kind == "Float":
        if cell == "" and t.nullable:
            return None
        return float(cell)
    if t.kind == "Bool":
        if cell == "" and t.nullable:
            return None
        return cell.lower() in ("true", "1", "yes")
    if t.kind == "String":
        if cell == "" and t.nullable:
            return None
        return cell
    return coerce_value(cell, t)


def _read_url(url: str) -> str:
    if url.startswith("file://"):
        path = url[len("file://") :]
        with open(path, "r", encoding="utf-8") as f:
            return f.read()
    if url.startswith(("http://", "https://")):
        import urllib.request

        with urllib.request.urlopen(url) as resp:  # noqa: S310
            return resp.read().decode("utf-8")
    with open(url, "r", encoding="utf-8") as f:
        return f.read()


class JsonReader(FixedRule):
    """Load JSON lines (reference `utilities/jlines.rs`).
    Options: url, fields (list of field names), json_lines, null_if_absent,
    prepend_index."""

    name = "JsonReader"

    def arity(self, options, head):
        fields = options.get("fields")
        n = None
        if isinstance(fields, Const) and isinstance(fields.val, list):
            n = len(fields.val)
        elif isinstance(fields, Apply) and fields.op.name == "list":
            n = len(fields.args)
        if n is None:
            return None
        prepend = options.get("prepend_index")
        if isinstance(prepend, Const) and prepend.val is True:
            n += 1
        return n

    def run(self, payload, out_put, poison):
        from ..data.value import from_json

        url = payload.string_option("url", None)
        if url is None:
            raise QueryError("option 'url' required for JsonReader")
        fields = payload.option("fields", [])
        json_lines = payload.bool_option("json_lines", True)
        null_if_absent = payload.bool_option("null_if_absent", False)
        prepend_index = payload.bool_option("prepend_index", False)
        content = _read_url(url)
        if json_lines:
            docs = [
                _json.loads(line) for line in content.splitlines() if line.strip()
            ]
        else:
            data = _json.loads(content)
            if not isinstance(data, list):
                raise QueryError("JSON document must be an array of objects")
            docs = data
        for i, doc in enumerate(docs):
            if poison is not None:
                poison.check()
            row: List[Any] = [i] if prepend_index else []
            for f in fields:
                if f not in doc:
                    if null_if_absent:
                        row.append(None)
                    else:
                        raise QueryError(f"field '{f}' absent from json line {i}")
                else:
                    row.append(from_json(doc[f]))
            out_put(row)
