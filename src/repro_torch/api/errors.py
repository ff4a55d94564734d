"""The query API's typed error hierarchy.

One set of exceptions for both transports: a local :class:`~repro_torch.api.Session`
raises them directly, a remote one maps the server's structured wire
errors (``{"id": ..., "error": "...", "code": "..."}``) through
:func:`error_from_reply`.  Every class subclasses :class:`KGError`, which
subclasses ``RuntimeError`` — callers that predate the hierarchy (and
matched on ``RuntimeError`` / the ``"server error: ..."`` message) keep
working unchanged.

Wire error codes (documented in the README wire-protocol section):

========== ==========================  =====================================
code       exception                   meaning
========== ==========================  =====================================
parse      QueryParseError             the query text failed to parse
bad_request BadRequestError            malformed request (missing ``query``,
                                       bad ``limit``/``triples``, bad json)
read_only  ReadOnlyError               mutation op on a read-only store
internal   ServerError                 unexpected failure inside a handler
(none)     ServerError                 pre-code servers / unknown failures
========== ==========================  =====================================

``ProtocolError`` is client-side only: the transport itself broke (the
server hung up mid-request, or answered something that isn't a reply).
"""

from __future__ import annotations


class KGError(RuntimeError):
    """Base of every query-API error; ``code`` is the structured wire
    code when one applies (None for purely local failures)."""

    code: str | None = None

    def __init__(self, message: str, code: str | None = None):
        super().__init__(message)
        if code is not None:
            self.code = code


class QueryParseError(KGError):
    """The query text is not valid SPARQL-lite."""

    code = "parse"


class BadRequestError(KGError):
    """A structurally malformed request (missing ``query``, a negative
    ``limit``, non-triple ``triples``, unparseable json)."""

    code = "bad_request"


class ReadOnlyError(KGError):
    """A mutation (insert/delete/compact) against a read-only store."""

    code = "read_only"


class ServerError(KGError):
    """The server failed while handling the request (or answered an
    error without a structured code)."""

    code = "internal"


class ProtocolError(KGError, ConnectionError):
    """The wire transport itself broke: connection closed mid-request,
    or a reply that violates the protocol.  (Also a ``ConnectionError``
    for callers that predate the hierarchy.)"""

    code = "protocol"


_BY_CODE: dict[str, type[KGError]] = {
    cls.code: cls
    for cls in (QueryParseError, BadRequestError, ReadOnlyError, ServerError)
}


def error_from_reply(resp: dict) -> KGError:
    """The typed exception for an error reply off the wire.  The message
    keeps the historical ``"server error: ..."`` prefix — existing
    callers match on it."""
    code = resp.get("code")
    cls = _BY_CODE.get(code, ServerError)
    err = cls(f"server error: {resp.get('error')}")
    if code is not None:
        err.code = code
    return err
