"""Minimal asyncio HTTP/1.1 substrate for the gateway.

The container has no third-party web stack (no aiohttp/FastAPI/uvicorn),
so the gateway speaks HTTP directly over asyncio streams.  Scope is
deliberately tiny — exactly what the gateway and its bench client need:

* request parsing (request line, headers, body framed by Content-Length
  or ``Transfer-Encoding: chunked``; bodies are capped either way),
* fixed responses and SSE streaming responses,
* HTTP/1.1 keep-alive: fixed responses carry ``Connection: keep-alive``
  unless the client asked to close, so one connection can carry many
  exchanges (pipelining is not supported — bytes arriving while a chat
  stream is in flight are treated as a client disconnect).  SSE
  streaming responses always close: the stream *is* the response body,
  so its end is signalled by EOF.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from urllib.parse import parse_qs, urlsplit

MAX_BODY_BYTES = 1 << 20
MAX_HEADER_LINES = 64

REASONS = {200: "OK", 400: "Bad Request", 404: "Not Found",
           405: "Method Not Allowed", 429: "Too Many Requests",
           500: "Internal Server Error"}


@dataclass
class HTTPRequest:
    method: str
    path: str                     # path only, query stripped
    query: dict = field(default_factory=dict)   # first value per key
    headers: dict = field(default_factory=dict)  # lower-cased names
    body: bytes = b""


class BadRequest(ValueError):
    pass


async def read_request(reader, first: bytes = b"") -> HTTPRequest | None:
    """Parse one HTTP/1.1 request; None on immediate EOF (client went
    away between connect and send).  Raises BadRequest on malformed or
    oversized input.  ``first`` is prepended to the request line — the
    keep-alive loop uses it to push back bytes its disconnect watcher
    consumed between exchanges."""
    line = first + await reader.readline()
    if not line:
        return None
    try:
        method, target, _version = line.decode("ascii").split()
    except ValueError:
        raise BadRequest(f"malformed request line: {line[:80]!r}")
    headers: dict[str, str] = {}
    for _ in range(MAX_HEADER_LINES):
        h = await reader.readline()
        if h in (b"\r\n", b"\n", b""):
            break
        name, _, val = h.decode("latin1").partition(":")
        headers[name.strip().lower()] = val.strip()
    else:
        raise BadRequest("too many header lines")
    if "chunked" in headers.get("transfer-encoding", "").lower():
        body = await _read_chunked(reader)
    else:
        try:
            clen = int(headers.get("content-length", "0"))
        except ValueError:
            raise BadRequest("bad Content-Length")
        if not 0 <= clen <= MAX_BODY_BYTES:
            raise BadRequest(f"body too large ({clen} bytes)")
        body = await reader.readexactly(clen) if clen else b""
    parts = urlsplit(target)
    query = {k: v[0] for k, v in parse_qs(parts.query).items()}
    return HTTPRequest(method=method.upper(), path=parts.path, query=query,
                       headers=headers, body=body)


async def _read_chunked(reader) -> bytes:
    """Decode a ``Transfer-Encoding: chunked`` request body (RFC 9112
    §7.1): ``size-in-hex[;ext] CRLF data CRLF`` frames until a zero-size
    chunk, then trailer lines up to a blank line.  Trailers are read and
    discarded; the cumulative body is capped at ``MAX_BODY_BYTES`` so a
    client cannot stream unbounded data by never sending the terminal
    chunk."""
    body = bytearray()
    while True:
        line = await reader.readline()
        if not line.endswith(b"\n"):
            raise BadRequest("truncated chunk size line")
        size_s = line.strip().split(b";", 1)[0]   # drop chunk extensions
        try:
            size = int(size_s, 16)
        except ValueError:
            raise BadRequest(f"bad chunk size: {size_s[:20]!r}")
        if size < 0:
            raise BadRequest(f"bad chunk size: {size_s[:20]!r}")
        if size == 0:
            break
        if len(body) + size > MAX_BODY_BYTES:
            raise BadRequest(f"chunked body too large "
                             f"(> {MAX_BODY_BYTES} bytes)")
        body += await reader.readexactly(size)
        if await reader.readexactly(2) != b"\r\n":
            raise BadRequest("chunk data not CRLF-terminated")
    for _ in range(MAX_HEADER_LINES):
        t = await reader.readline()
        if t in (b"\r\n", b"\n", b""):
            return bytes(body)
    raise BadRequest("too many trailer lines")


def response(status: int, body: bytes, *,
             content_type: str = "application/json",
             keep_alive: bool = False,
             extra_headers: dict | None = None) -> bytes:
    head = [f"HTTP/1.1 {status} {REASONS.get(status, 'Unknown')}",
            f"Content-Type: {content_type}",
            f"Content-Length: {len(body)}",
            f"Connection: {'keep-alive' if keep_alive else 'close'}"]
    for k, v in (extra_headers or {}).items():
        head.append(f"{k}: {v}")
    return ("\r\n".join(head) + "\r\n\r\n").encode() + body


def wants_keep_alive(headers: dict) -> bool:
    """HTTP/1.1 default: keep the connection open unless the client
    sent ``Connection: close``."""
    return headers.get("connection", "").lower() != "close"


SSE_HEADER = (b"HTTP/1.1 200 OK\r\n"
              b"Content-Type: text/event-stream\r\n"
              b"Cache-Control: no-cache\r\n"
              b"Connection: close\r\n\r\n")
