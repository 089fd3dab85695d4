"""Error model: one exception type carrying an ``ErrorKind``.

The subset of ``pushcdn_tpu.proto.error`` the device plane raises."""

from __future__ import annotations

import enum
from typing import NoReturn, Optional


class ErrorKind(enum.Enum):
    """What failed."""

    PARSE = "parse"                  # a configuration value is invalid
    EXCEEDED_SIZE = "exceeded_size"  # a table or frame slot is too small


class Error(Exception):
    """The single framework error type; ``kind`` drives policy."""

    def __init__(self, kind: ErrorKind, message: str,
                 cause: Optional[BaseException] = None):
        super().__init__(f"{kind.value}: {message}")
        self.kind = kind
        self.message = message
        self.cause = cause


def bail(kind: ErrorKind, message: str,
         cause: Optional[BaseException] = None) -> NoReturn:
    """Raise an :class:`Error`, chaining ``cause`` if given."""
    err = Error(kind, message, cause)
    if cause is not None:
        raise err from cause
    raise err
