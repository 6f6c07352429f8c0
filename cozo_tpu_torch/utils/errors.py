"""Error hierarchy for cozo_tpu."""

from __future__ import annotations


class CozoError(Exception):
    """Base error; carries an error code compatible with the reference's
    miette diagnostic codes where practical."""

    code = "cozo::error"

    def __init__(self, message: str, code: str | None = None) -> None:
        super().__init__(message)
        if code is not None:
            self.code = code

    @property
    def message(self) -> str:
        return str(self.args[0]) if self.args else ""


class ParseError(CozoError):
    code = "parser::error"

    def __init__(self, message: str, pos: int | None = None, code: str | None = None):
        super().__init__(message, code)
        self.pos = pos


class EvalError(CozoError):
    code = "eval::error"


class QueryError(CozoError):
    code = "query::error"


class StoredRelationError(CozoError):
    code = "stored::error"


class TransactError(CozoError):
    code = "transact::error"


class IndexError_(CozoError):
    code = "index::error"


class QueryKilled(CozoError):
    code = "query::killed"


class QueryTimeout(CozoError):
    code = "query::timeout"
