"""The Synera gateway: an asyncio OpenAI-compatible front door over
``SyneraServer``.

The ``server`` may equally be a ``ReplicaRouter`` (serving/router.py)
fronting N cloud replicas — it exposes the same open/cancel/step/stats
surface, every admission is then routed by the fleet policy, and
``/metrics?replica=N`` exposes one replica's own counters next to the
aggregated fleet view at ``/metrics``.

Two threads cooperate:

* the **asyncio thread** owns the sockets: it parses HTTP, enforces
  admission (429 + ``Retry-After`` past the queue cap), writes SSE
  frames, and watches each connection for client disconnect;
* the **engine thread** owns the (GIL-releasing, torch-heavy) serving
  loop: it admits accepted requests into ``SyneraServer`` sessions,
  calls ``server.step()``, and forwards tokens emitted by the device
  coroutines into per-request ``asyncio.Queue``s via
  ``loop.call_soon_threadsafe``.

Commands cross from asyncio to the engine thread through a locked inbox
(open / cancel); tokens and completion events cross back through the
per-stream queues.  Cancellation (explicit or disconnect-driven) lands
in ``SyneraServer.cancel``, which purges the stream's scheduler
requests and releases its slot row, blocks, prefix refs and swap state
— the resource-leak regression tests poll ``pool_stats`` back to
baseline after mid-stream disconnects.

Clock modes (see ``serving/link.py``):

* ``SimClock`` — modeled time only; useful for tests that want
  deterministic schedules over a real socket.
* ``RealClock(pace=False)`` (the default for ``serve.py --http``) —
  wall-clock serving: requests are served as fast as the host allows,
  arrivals are clamped to "now", and the modeled costs accumulate into
  ``clock.modeled_ms`` for the modeled-vs-real cross-check.
* ``RealClock(pace=True)`` — cloud iterations and idle gaps *sleep*
  through their modeled cost, so wall-clock latencies track the modeled
  schedule (real >= modeled; the excess is host compute + overhead).
"""
from __future__ import annotations

import asyncio
import json
import sys
import threading
import time
import traceback
from collections import deque
from dataclasses import dataclass

from repro_torch.serving.gateway import http as H
from repro_torch.serving.gateway import protocol as P


@dataclass
class GatewayConfig:
    host: str = "127.0.0.1"
    port: int = 0                  # 0 = ephemeral (bound port on .port)
    model_name: str = "synera-tiny"
    max_new_default: int = 32      # max_tokens when the client omits it
    max_new_cap: int = 256         # hard per-request cap
    max_active: int = 8            # sessions open in the server at once
    queue_cap: int = 8             # accepted-but-not-opened beyond that
    retry_after_s: int = 1         # Retry-After on 429
    idle_tick_s: float = 0.02      # engine poll interval when idle
    stats_refresh_s: float = 0.25  # /metrics snapshot staleness bound


def _cuda_index(server) -> int | None:
    """Index of the CUDA device ``server`` (a ``SyneraServer`` or a
    ``ReplicaRouter``) serves on: that of its shared ``DeviceRuntime``,
    or the calling thread's current device for a bare ``"cuda"``.  None
    off CUDA."""
    dev = getattr(getattr(server, "device", None), "device", None)
    if getattr(dev, "type", None) != "cuda":
        return None
    import torch
    return torch.cuda.current_device() if dev.index is None else dev.index


class _Stream:
    """One accepted chat-completions request, shared between threads."""
    __slots__ = ("req", "loop", "queue", "session", "dead")

    def __init__(self, req: P.ChatRequest, loop):
        self.req = req
        self.loop = loop
        self.queue: asyncio.Queue = asyncio.Queue()
        self.session = None            # DeviceSession once opened
        self.dead = False              # client gone; drop further pushes

    def push(self, item) -> None:
        """Engine thread -> asyncio queue (thread-safe, never blocks)."""
        if self.dead:
            return
        try:
            self.loop.call_soon_threadsafe(self.queue.put_nowait, item)
        except RuntimeError:
            self.dead = True           # loop already closed


class Gateway:
    """HTTP front door over one ``SyneraServer``.

    ``start()`` launches the engine + asyncio threads and returns once
    the socket is bound (``.port`` holds the real port); ``close()``
    tears both down.  ``run_forever()`` is the blocking CLI entry.
    """

    def __init__(self, server, config: GatewayConfig | None = None):
        self.server = server
        self.cfg = config or GatewayConfig()
        self.host = self.cfg.host
        self.port = self.cfg.port
        self._lock = threading.Lock()
        self._n_queued = 0             # accepted, waiting for a session
        self._n_open = 0               # sessions open, not finished
        self._inbox: deque = deque()   # ("open"|"cancel", _Stream)
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._ready = threading.Event()
        self._pending: deque = deque()  # engine-thread-owned admit queue
        self._active: list[_Stream] = []
        self._stats = server.stats()
        self._stats_t = time.monotonic()
        self._loop: asyncio.AbstractEventLoop | None = None
        self._threads: list[threading.Thread] = []
        self._cuda_index = _cuda_index(server)

    # -- lifecycle ------------------------------------------------------
    def start(self) -> "Gateway":
        t_eng = threading.Thread(target=self._engine_loop,
                                 name="gw-engine", daemon=True)
        t_http = threading.Thread(target=lambda: asyncio.run(self._amain()),
                                  name="gw-http", daemon=True)
        self._threads = [t_eng, t_http]
        t_eng.start()
        t_http.start()
        if not self._ready.wait(timeout=30):
            raise RuntimeError("gateway failed to bind within 30s")
        return self

    def close(self) -> None:
        self._stop.set()
        self._wake.set()
        if self._loop is not None:
            try:
                self._loop.call_soon_threadsafe(lambda: None)  # wake loop
            except RuntimeError:
                pass
        for t in self._threads:
            t.join(timeout=10)

    def run_forever(self) -> None:
        self.start()
        print(f"synera gateway listening on http://{self.host}:{self.port} "
              f"(queue_cap={self.cfg.queue_cap}, "
              f"max_active={self.cfg.max_active})", flush=True)
        try:
            while not self._stop.is_set():
                time.sleep(0.5)
        except KeyboardInterrupt:
            pass
        finally:
            self.close()

    # -- engine thread --------------------------------------------------
    def _submit(self, cmd) -> None:
        with self._lock:
            self._inbox.append(cmd)
        self._wake.set()

    def _drain_inbox(self) -> None:
        while True:
            with self._lock:
                if not self._inbox:
                    return
                kind, st = self._inbox.popleft()
            if kind == "open":
                self._pending.append(st)
            elif kind == "cancel":
                self._cancel(st)
            elif kind == "stats":
                # fresh stats computed on the engine thread: server state
                # is only ever touched here, so /metrics never races a
                # step() in progress.  ridx selects one replica's view
                # behind a ReplicaRouter (/metrics?replica=N).
                loop, fut, ridx = st
                if ridx is None:
                    self._refresh_stats(force=True)
                    snap = dict(self._stats)
                else:
                    try:
                        snap = self.server.replica_stats(int(ridx))
                    except (AttributeError, IndexError, ValueError):
                        snap = {"error": f"no replica {ridx!r}"}
                try:
                    loop.call_soon_threadsafe(
                        lambda f=fut, s=snap:
                        f.done() or f.set_result(s))
                except RuntimeError:
                    pass
            elif kind == "trace":
                # trace snapshot rendered on the engine thread for the
                # same reason as stats: the tracer's buffers are only
                # ever appended to there, so /v1/traces never races a
                # step() in progress
                loop, fut = st
                tr = getattr(self.server, "tracer", None)
                if tr is not None and getattr(tr, "enabled", False):
                    snap = tr.to_dict()
                    snap["enabled"] = True
                else:
                    snap = {"enabled": False, "traceEvents": [],
                            "displayTimeUnit": "ms"}
                try:
                    loop.call_soon_threadsafe(
                        lambda f=fut, s=snap:
                        f.done() or f.set_result(s))
                except RuntimeError:
                    pass

    def _cancel(self, st: _Stream) -> None:
        st.dead = True
        if st.session is None:
            try:
                self._pending.remove(st)
            except ValueError:
                return                 # already opened+finished, or unknown
            with self._lock:
                self._n_queued -= 1
            return
        if self.server.cancel(st.session):
            with self._lock:
                self._n_open -= 1
            try:
                self._active.remove(st)
            except ValueError:
                pass

    def _open(self, st: _Stream) -> None:
        st.session = self.server.open_session(
            st.req.prompt, st.req.max_tokens,
            emit=lambda toks, t_ms, _st=st: _st.push(("tok", list(toks))))
        with self._lock:
            self._n_queued -= 1
            self._n_open += 1
        self._active.append(st)

    def _finish(self, st: _Stream) -> None:
        self._active.remove(st)
        with self._lock:
            self._n_open -= 1
        st.push(("done", st.session))

    def _refresh_stats(self, force: bool = False) -> None:
        now = time.monotonic()
        if force or now - self._stats_t >= self.cfg.stats_refresh_s:
            self._stats = self.server.stats()
            self._stats_t = now

    def _engine_loop(self) -> None:
        srv = self.server
        if self._cuda_index is not None:
            # the engine's tensors live on this card: make it the
            # thread's current device before the loop steps
            import torch
            torch.cuda.set_device(self._cuda_index)
        while not self._stop.is_set():
            try:
                self._drain_inbox()
                while self._pending and self._n_open < self.cfg.max_active:
                    self._open(self._pending.popleft())
                srv.ext_queue_depth = len(self._pending)
                if not self._active:
                    self._refresh_stats()
                    self._wake.wait(self.cfg.idle_tick_s)
                    self._wake.clear()
                    continue
                srv.step()
                for st in [s for s in self._active if s.session.done]:
                    self._finish(st)
                self._refresh_stats(force=not self._active)
            except Exception:
                # a serving-loop failure must not strand open sockets:
                # fail every in-flight stream, keep accepting (each new
                # request sees a fresh attempt / its own error)
                msg = traceback.format_exc()
                print(f"gateway engine error:\n{msg}",
                      file=sys.stderr, flush=True)
                for st in list(self._active):
                    try:
                        srv.cancel(st.session)
                    except Exception:
                        pass
                    self._active.remove(st)
                    with self._lock:
                        self._n_open -= 1
                    st.push(("err", msg.strip().splitlines()[-1]))

    # -- asyncio thread -------------------------------------------------
    async def _amain(self) -> None:
        self._loop = asyncio.get_running_loop()
        server = await asyncio.start_server(self._client, self.host,
                                            self.port)
        self.port = server.sockets[0].getsockname()[1]
        self._ready.set()
        async with server:
            while not self._stop.is_set():
                await asyncio.sleep(0.1)

    async def _client(self, reader, writer) -> None:
        # keep-alive loop: one connection carries exchanges until the
        # client closes, asks to close, or an exchange requires it
        # (SSE streams, disconnects, framing errors)
        try:
            first = b""
            while not self._stop.is_set():
                try:
                    hreq = await H.read_request(reader, first=first)
                except (H.BadRequest, asyncio.IncompleteReadError) as e:
                    writer.write(H.response(400, json.dumps(
                        {"error": {"message": str(e)}}).encode()))
                    return
                if hreq is None:
                    return
                keep = H.wants_keep_alive(hreq.headers)
                first = await self._route(hreq, reader, writer, keep)
                if first is None:
                    return
        except (ConnectionResetError, BrokenPipeError):
            pass
        finally:
            try:
                if writer.can_write_eof():
                    writer.write_eof()
            except (OSError, RuntimeError):
                pass
            writer.close()

    async def _route(self, hreq: H.HTTPRequest, reader, writer,
                     keep: bool) -> bytes | None:
        """Handle one exchange.  Returns pushback bytes for the next
        ``read_request`` (b"" normally) to keep the connection open, or
        None to close it."""
        if hreq.path == "/v1/chat/completions":
            if hreq.method != "POST":
                writer.write(H.response(405, b'{"error":"POST only"}',
                                        keep_alive=keep))
            else:
                nxt = await self._chat(hreq, reader, writer, keep)
                await writer.drain()
                return nxt
        elif hreq.path == "/v1/models":
            body = json.dumps({"object": "list", "data": [
                {"id": self.cfg.model_name, "object": "model",
                 "owned_by": "synera-repro"}]}).encode()
            writer.write(H.response(200, body, keep_alive=keep))
        elif hreq.path == "/healthz":
            with self._lock:
                body = json.dumps({"status": "ok", "active": self._n_open,
                                   "queued": self._n_queued}).encode()
            writer.write(H.response(200, body, keep_alive=keep))
        elif hreq.path == "/metrics":
            ridx = hreq.query.get("replica")
            loop = asyncio.get_running_loop()
            fut = loop.create_future()
            self._submit(("stats", (loop, fut, ridx)))
            try:
                stats = await asyncio.wait_for(fut, timeout=10)
            except asyncio.TimeoutError:
                if ridx is not None:
                    stats = {"error": "engine busy; retry"}
                else:
                    stats = dict(self._stats)  # engine wedged: last snapshot
            if "error" in stats:
                # unknown replica index, or a single-server gateway asked
                # for a per-replica view (no ReplicaRouter in front)
                writer.write(H.response(
                    404, json.dumps({"error": {
                        "message": stats["error"]}}).encode(),
                    keep_alive=keep))
                await writer.drain()
                return b"" if keep else None
            if ridx is None:
                # gateway-level gauges only make sense on the fleet view
                with self._lock:
                    stats["gateway_active"] = self._n_open
                    stats["gateway_queued"] = self._n_queued
            if hreq.query.get("format") == "json":
                writer.write(H.response(200, json.dumps(stats).encode(),
                                        keep_alive=keep))
            else:
                writer.write(H.response(
                    200, P.metrics_text(stats).encode(),
                    content_type="text/plain; version=0.0.4",
                    keep_alive=keep))
        elif hreq.path == "/v1/traces":
            # Chrome/Perfetto trace-event snapshot of everything the
            # tracer has recorded so far; {"enabled": false} when the
            # gateway was started without --trace
            loop = asyncio.get_running_loop()
            fut = loop.create_future()
            self._submit(("trace", (loop, fut)))
            try:
                trace = await asyncio.wait_for(fut, timeout=10)
            except asyncio.TimeoutError:
                trace = {"enabled": False, "traceEvents": [],
                         "error": "engine busy; retry"}
            writer.write(H.response(200, json.dumps(trace).encode(),
                                    keep_alive=keep))
        else:
            writer.write(H.response(404, b'{"error":"not found"}',
                                    keep_alive=keep))
        await writer.drain()
        return b"" if keep else None

    # -- chat completions ----------------------------------------------
    async def _chat(self, hreq: H.HTTPRequest, reader, writer,
                    keep: bool) -> bytes | None:
        try:
            req = P.parse_chat_request(
                hreq.body, default_model=self.cfg.model_name,
                default_max_tokens=self.cfg.max_new_default,
                max_tokens_cap=self.cfg.max_new_cap)
        except P.ProtocolError as e:
            writer.write(H.response(400, json.dumps(
                {"error": {"message": str(e),
                           "type": "invalid_request_error"}}).encode(),
                keep_alive=keep))
            await writer.drain()
            return b"" if keep else None
        # admission: the system holds at most max_active running plus
        # queue_cap waiting requests.  Bounding the *total* (not just
        # the wait queue) keeps a cold burst from queueing unboundedly
        # before the engine has opened its first session.  Counted under
        # the lock so concurrent handlers + the engine thread agree.
        with self._lock:
            saturated = (self._n_open + self._n_queued
                         >= self.cfg.max_active + self.cfg.queue_cap)
            if not saturated:
                self._n_queued += 1
        if saturated:
            self.server.rejected_requests += 1
            writer.write(H.response(
                429, json.dumps({"error": {
                    "message": f"server saturated: {self.cfg.max_active} "
                               f"active streams and a full wait queue "
                               f"({self.cfg.queue_cap}); retry later",
                    "type": "rate_limit_error"}}).encode(),
                keep_alive=keep,
                extra_headers={"Retry-After": str(self.cfg.retry_after_s)}))
            await writer.drain()
            return b"" if keep else None
        st = _Stream(req, asyncio.get_running_loop())
        self._submit(("open", st))
        # per-stream disconnect watch: any bytes (or EOF) while this
        # stream is in flight = the client went away (no pipelining)
        eof_task = asyncio.ensure_future(reader.read(1))
        try:
            if req.stream:
                await self._chat_stream(st, writer, eof_task)
                return None        # SSE body ends at EOF: always close
            done = await self._chat_full(st, writer, eof_task, keep)
            if done and keep:
                return await self._harvest(eof_task)
            return None
        except (ConnectionResetError, BrokenPipeError):
            self._disconnect(st)
            return None
        finally:
            if not eof_task.done():
                eof_task.cancel()

    @staticmethod
    async def _harvest(eof_task) -> bytes | None:
        """Retire the disconnect watcher after a completed keep-alive
        exchange.  If it already consumed a byte, that byte is the start
        of the next request line (push it back); a completed empty read
        means the client hit EOF (close).  Must *await* the cancelled
        task: until cancellation lands, the watcher still owns the
        stream reader and the next ``readline`` would race it."""
        eof_task.cancel()
        try:
            data = await eof_task
        except asyncio.CancelledError:
            return b""                 # watcher retired without reading
        except Exception:
            return None
        return data if data else None  # byte = next request; b"" = EOF

    async def _next_event(self, st: _Stream, eof_task):
        """Next queue item, or None if the client disconnected first."""
        get_task = asyncio.ensure_future(st.queue.get())
        done, _ = await asyncio.wait({get_task, eof_task},
                                     return_when=asyncio.FIRST_COMPLETED)
        if get_task in done:
            return get_task.result()
        get_task.cancel()
        return None

    def _disconnect(self, st: _Stream) -> None:
        st.dead = True
        self._submit(("cancel", st))

    async def _chat_stream(self, st: _Stream, writer, eof_task) -> None:
        req = st.req
        cid, created = P.new_completion_id(), int(time.time())
        writer.write(H.SSE_HEADER)
        writer.write(P.sse_event(P.chunk_dict(cid, created, req.model,
                                              role="assistant")))
        await writer.drain()
        n_tok = 0
        while True:
            ev = await self._next_event(st, eof_task)
            if ev is None:
                self._disconnect(st)
                return
            kind, payload = ev
            if kind == "tok":
                n_tok += len(payload)
                try:
                    writer.write(P.sse_event(P.chunk_dict(
                        cid, created, req.model,
                        content=P.detok(payload))))
                    await writer.drain()
                except (ConnectionResetError, BrokenPipeError):
                    self._disconnect(st)
                    return
            elif kind == "done":
                finish = "length" if n_tok >= req.max_tokens else "stop"
                usage = (P.usage_dict(len(req.prompt), n_tok)
                         if req.include_usage else None)
                writer.write(P.sse_event(P.chunk_dict(
                    cid, created, req.model, finish_reason=finish,
                    usage=usage)))
                writer.write(P.SSE_DONE)
                await writer.drain()
                return
            else:  # "err"
                writer.write(P.sse_event(
                    {"error": {"message": str(payload)}}))
                await writer.drain()
                return

    async def _chat_full(self, st: _Stream, writer, eof_task,
                         keep: bool) -> bool:
        """Non-streamed completion.  Returns True when the exchange
        finished cleanly and the connection may be kept alive."""
        req = st.req
        cid, created = P.new_completion_id(), int(time.time())
        toks: list[int] = []
        while True:
            ev = await self._next_event(st, eof_task)
            if ev is None:
                self._disconnect(st)
                return False
            kind, payload = ev
            if kind == "tok":
                toks += payload
            elif kind == "done":
                finish = ("length" if len(toks) >= req.max_tokens
                          else "stop")
                body = P.completion_dict(
                    cid, created, req.model, P.detok(toks).rstrip(),
                    finish, P.usage_dict(len(req.prompt), len(toks)))
                writer.write(H.response(200, json.dumps(body).encode(),
                                        keep_alive=keep))
                await writer.drain()
                return True
            else:  # "err"
                writer.write(H.response(500, json.dumps(
                    {"error": {"message": str(payload)}}).encode()))
                await writer.drain()
                return False
