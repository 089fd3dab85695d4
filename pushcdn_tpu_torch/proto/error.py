"""Error model.

Capability parity with the reference's 9-variant error enum that
distinguishes reconnect-worthy from fatal errors
(cdn-proto/src/error.rs:21-72). We keep one exception type carrying an
``ErrorKind`` so callers can branch on kind without a deep class hierarchy,
plus ``bail``/``bail_option`` helpers mirroring the reference's macros
(error.rs contains `bail!` / `bail_option!` / `parse_endpoint!`).
"""

from __future__ import annotations

import enum
import re
from typing import NoReturn, Optional, TypeVar

T = TypeVar("T")

# typed retry-after hint embedded in shed contexts: "...; retry-after=2.5"
_RETRY_AFTER = re.compile(r"retry-after=([0-9]+(?:\.[0-9]+)?)")


def retry_after_hint(context: str) -> Optional[float]:
    """Parse the ``retry-after=<seconds>`` hint a shedding server appends
    to its rejection context. Returns None when absent/unparseable — the
    hint is advisory; clients fall back to plain jittered backoff."""
    if not context:
        return None
    m = _RETRY_AFTER.search(context)
    if m is None:
        return None
    try:
        return float(m.group(1))
    except ValueError:  # pragma: no cover - regex guarantees a float
        return None


class ErrorKind(enum.Enum):
    """What failed — used to decide reconnect vs fatal vs drop-message."""

    CONNECTION = "connection"      # transport-level send/recv failure (reconnect-worthy)
    AUTHENTICATION = "authentication"  # handshake rejected (re-auth via marshal)
    SERIALIZE = "serialize"        # could not encode a message
    DESERIALIZE = "deserialize"    # malformed inbound frame (disconnect peer)
    CRYPTO = "crypto"              # sign/verify failure
    PARSE = "parse"                # endpoint / config parse failure
    FILE = "file"                  # file I/O (CA certs, embedded DB path)
    EXCEEDED_SIZE = "exceeded_size"  # frame larger than MAX_MESSAGE_SIZE
    TIMEOUT = "timeout"            # I/O deadline elapsed
    SHED = "shed"                  # server load-shed a request (back off;
    #                                the connection itself is still live)


class Error(Exception):
    """The single framework error type.

    ``kind`` drives policy: ``CONNECTION``/``TIMEOUT`` are reconnect-worthy
    for the elastic client; ``AUTHENTICATION`` means go back through the
    marshal; ``DESERIALIZE`` means disconnect the sending peer.
    """

    def __init__(self, kind: ErrorKind, message: str, cause: Optional[BaseException] = None):
        super().__init__(f"{kind.value}: {message}")
        self.kind = kind
        self.message = message
        self.cause = cause
        # typed backoff hint (seconds) for SHED errors — parsed from the
        # server's context by retry_after_hint(); None when absent
        self.retry_after_s: Optional[float] = retry_after_hint(message) \
            if kind is ErrorKind.SHED else None

    @property
    def is_reconnectable(self) -> bool:
        """Errors the elastic client heals by re-dialing (vs giving up)."""
        return self.kind in (ErrorKind.CONNECTION, ErrorKind.TIMEOUT)


def bail(kind: ErrorKind, message: str, cause: Optional[BaseException] = None) -> NoReturn:
    """Raise an :class:`Error`, chaining ``cause`` if given."""
    err = Error(kind, message, cause)
    if cause is not None:
        raise err from cause
    raise err


def bail_option(value: Optional[T], kind: ErrorKind, message: str) -> T:
    """Unwrap ``value`` or raise — analog of the reference's `bail_option!`."""
    if value is None:
        bail(kind, message)
    return value


def parse_endpoint(endpoint: str) -> tuple[str, int]:
    """Split ``"host:port"``; analog of the reference's `parse_endpoint!`."""
    host, sep, port = endpoint.rpartition(":")
    if not sep or not host:
        bail(ErrorKind.PARSE, f"malformed endpoint {endpoint!r}, want 'host:port'")
    try:
        return host, int(port)
    except ValueError as exc:
        bail(ErrorKind.PARSE, f"malformed port in endpoint {endpoint!r}", exc)
