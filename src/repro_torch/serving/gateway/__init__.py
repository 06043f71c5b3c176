"""Async serving gateway: OpenAI-compatible streaming HTTP front door
over ``SyneraServer`` (a port of ``repro/serving/gateway/``; see
docs/serving_api.md, "HTTP gateway").

Modules:

* ``protocol`` — request parsing + ``chat.completion``/``chunk`` JSON
  and SSE framing (pure functions, unit-testable without sockets),
* ``http``     — a minimal stdlib-asyncio HTTP/1.1 server substrate
  (no third-party web framework in the container),
* ``app``      — the ``Gateway``: endpoint routing, admission +
  backpressure, the engine thread driving ``SyneraServer.step()``, and
  per-stream token queues bridging the engine thread to asyncio.
"""
from repro_torch.serving.gateway.app import Gateway, GatewayConfig  # noqa: F401
