"""OpenAI chat-completions wire format for the Synera gateway.

The repro serves a synthetic integer-token task (benchmarks/prepare.py),
so the "tokenizer" is the identity over decimal token ids: message
``content`` is whitespace-separated token ids (e.g. ``"5 17 23 9"``)
and completion text is emitted the same way, one ``"<id> "`` atom per
token.  Concatenating every streamed delta therefore reproduces the
full completion text byte-for-byte, and parsing it back with
:func:`parse_tokens` yields exactly the token stream an in-process
``run_synera`` call returns (identity-tested in tests/test_gateway.py).

Everything here is pure data-in/data-out — no sockets, no clocks — so
the framing is unit-testable in isolation.
"""
from __future__ import annotations

import json
import uuid
from dataclasses import dataclass, field

SSE_DONE = b"data: [DONE]\n\n"


class ProtocolError(ValueError):
    """Malformed client request (maps to HTTP 400)."""


@dataclass
class ChatRequest:
    """A validated /v1/chat/completions request."""
    prompt: list                  # concatenated message token ids
    max_tokens: int
    stream: bool
    model: str
    include_usage: bool = True
    raw: dict = field(default_factory=dict)


def parse_tokens(text: str) -> list[int]:
    """Whitespace-separated decimal token ids -> list[int]."""
    try:
        return [int(t) for t in text.split()]
    except ValueError as e:
        raise ProtocolError(
            f"message content must be whitespace-separated integer token "
            f"ids (synthetic-task vocabulary): {e}") from None


def detok(tokens) -> str:
    """Token ids -> text atoms; concatenation-safe across deltas."""
    return "".join(f"{int(t)} " for t in tokens)


def parse_chat_request(body: bytes, *, default_model: str,
                       default_max_tokens: int,
                       max_tokens_cap: int) -> ChatRequest:
    try:
        obj = json.loads(body or b"{}")
    except json.JSONDecodeError as e:
        raise ProtocolError(f"request body is not valid JSON: {e}") from None
    if not isinstance(obj, dict):
        raise ProtocolError("request body must be a JSON object")
    msgs = obj.get("messages")
    if not isinstance(msgs, list) or not msgs:
        raise ProtocolError("'messages' must be a non-empty array")
    prompt: list[int] = []
    for m in msgs:
        if not isinstance(m, dict) or "content" not in m:
            raise ProtocolError("each message needs a 'content' field")
        prompt += parse_tokens(str(m["content"]))
    if len(prompt) < 2:
        raise ProtocolError("need at least 2 prompt tokens")
    mt = obj.get("max_tokens", obj.get("max_completion_tokens",
                                       default_max_tokens))
    if not isinstance(mt, int) or mt < 1:
        raise ProtocolError("'max_tokens' must be a positive integer")
    include_usage = bool(obj.get("stream_options", {}).get(
        "include_usage", True)) if isinstance(
            obj.get("stream_options", {}), dict) else True
    return ChatRequest(prompt=prompt,
                       max_tokens=min(mt, max_tokens_cap),
                       stream=bool(obj.get("stream", False)),
                       model=str(obj.get("model", default_model)),
                       include_usage=include_usage, raw=obj)


def new_completion_id() -> str:
    return "chatcmpl-" + uuid.uuid4().hex[:24]


def usage_dict(prompt_tokens: int, completion_tokens: int) -> dict:
    return {"prompt_tokens": prompt_tokens,
            "completion_tokens": completion_tokens,
            "total_tokens": prompt_tokens + completion_tokens}


def chunk_dict(cid: str, created: int, model: str, *,
               content: str | None = None, role: str | None = None,
               finish_reason: str | None = None,
               usage: dict | None = None) -> dict:
    """One ``chat.completion.chunk``.  The delta carries ``role`` on the
    first chunk, ``content`` on token chunks, and is empty on the final
    chunk (which carries ``finish_reason`` and, per
    ``stream_options.include_usage`` semantics, ``usage``)."""
    delta: dict = {}
    if role is not None:
        delta["role"] = role
    if content is not None:
        delta["content"] = content
    out = {"id": cid, "object": "chat.completion.chunk",
           "created": created, "model": model,
           "choices": [{"index": 0, "delta": delta,
                        "finish_reason": finish_reason}]}
    if usage is not None:
        out["usage"] = usage
    return out


def completion_dict(cid: str, created: int, model: str, content: str,
                    finish_reason: str, usage: dict) -> dict:
    return {"id": cid, "object": "chat.completion", "created": created,
            "model": model,
            "choices": [{"index": 0,
                         "message": {"role": "assistant",
                                     "content": content},
                         "finish_reason": finish_reason}],
            "usage": usage}


def sse_event(data: dict) -> bytes:
    """One SSE frame: ``data: <json>\\n\\n`` (no spaces after colons in
    the JSON — keeps frames compact and byte-stable for tests)."""
    return b"data: " + json.dumps(
        data, separators=(",", ":")).encode() + b"\n\n"


def _hist_lines(name: str, h: dict, out: list) -> None:
    """Render one cumulative histogram (serving/trace.py ``hist_*``
    shape: ``{"le": (...), "buckets": [...], "sum": s}``) as standard
    Prometheus ``_bucket``/``_sum``/``_count`` samples.  ``buckets`` is
    already cumulative; its last entry is the +Inf bucket == count."""
    out.append(f"# TYPE {name} histogram")
    for le, c in zip(h["le"], h["buckets"]):
        out.append(f'{name}_bucket{{le="{float(le):g}"}} {c}')
    out.append(f'{name}_bucket{{le="+Inf"}} {h["buckets"][-1]}')
    out.append(f'{name}_sum {h["sum"]}')
    out.append(f'{name}_count {h["buckets"][-1]}')


def metrics_text(stats: dict, prefix: str = "synera_") -> str:
    """Prometheus-style text exposition of a flat stats dict: numeric
    fields become ``<prefix><name> <value>`` samples, booleans 0/1,
    ``hist_*`` dicts become real histograms (``_bucket``/``_sum``/
    ``_count``), strings become info comments."""
    lines = []
    for k, v in sorted(stats.items()):
        if isinstance(v, bool):
            lines.append(f"{prefix}{k} {int(v)}")
        elif isinstance(v, (int, float)):
            lines.append(f"{prefix}{k} {v}")
        elif (isinstance(v, dict) and "le" in v and "buckets" in v
              and "sum" in v):
            name = k[5:] if k.startswith("hist_") else k
            _hist_lines(f"{prefix}{name}", v, lines)
        else:
            lines.append(f"# {prefix}{k}: {v}")
    return "\n".join(lines) + "\n"
