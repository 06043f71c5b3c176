"""The port's HTTP gateway (``serving/gateway/``) against the reference.

Wire units (request validation, SSE and completion framing, the HTTP
parser, ``/metrics`` text) are compared output for output with the
reference's modules.  Over a real socket, a ``Gateway`` fronting a
two-replica port fleet streams one chat completion whose tokens must
equal the reference's ``run_synera`` stream, and a saturated gateway
answers 429.  Every socket has a timeout and every gateway is closed in
a ``finally``.
"""
import asyncio
import json
import socket
import threading

import numpy as np
import pytest

import jax
import torch

from repro.configs.synera_pair import tiny_pair
from repro.core.offload import OffloadPolicy as RefPolicy
from repro.models import model as JM
from repro.serving import synergy as RSY
from repro.serving.device import DeviceRuntime as RefDevice
from repro.serving.engine import CloudEngine as RefEngine
from repro.serving.gateway import http as RH
from repro.serving.gateway import protocol as RP
from repro_torch import bridge
from repro_torch.configs.synera_pair import tiny_pair as port_tiny_pair
from repro_torch.core.offload import OffloadPolicy
from repro_torch.serving.device import DeviceRuntime
from repro_torch.serving.engine import CloudEngine
from repro_torch.serving.gateway import Gateway, GatewayConfig
from repro_torch.serving.gateway import http as H
from repro_torch.serving.gateway import protocol as P
from repro_torch.serving.link import RealClock
from repro_torch.serving.router import ReplicaRouter
from repro_torch.serving.server import build_fleet
from repro_torch.serving.trace import hist_from

SOCKET_TIMEOUT_S = 30
MAX_NEW = 12
DEVICE_KW = dict(s_max=256, gamma=4, seed=0, use_early_exit=False,
                 use_pi=False)
ENGINE_KW = dict(max_slots=2, s_max=256, cache_impl="paged", block_size=16,
                 share_prefix=True)
KW = dict(default_model="m", default_max_tokens=8, max_tokens_cap=16)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# Wire units
# ---------------------------------------------------------------------------

BODIES = [
    {"messages": [{"role": "user", "content": "3 5 7"}], "stream": True,
     "max_tokens": 99},
    {"messages": [{"role": "user", "content": "3 5"}]},
    {"messages": [{"role": "system", "content": "1 2"},
                  {"role": "user", "content": "9"}], "model": "x",
     "stream": True, "stream_options": {"include_usage": False}},
    "not json", [], {"messages": []}, {"messages": [{"role": "u"}]},
    {"messages": [{"content": "hello world"}]},
    {"messages": [{"content": "7"}]},
    {"messages": [{"content": "3 5"}], "max_tokens": 0},
]


def _parse(mod, body):
    raw = body.encode() if isinstance(body, str) else json.dumps(body).encode()
    try:
        return "ok", vars(mod.parse_chat_request(raw, **KW))
    except mod.ProtocolError as e:
        return "error", str(e)


@pytest.mark.parametrize("i", range(len(BODIES)))
def test_parse_chat_request_matches_reference(i):
    assert _parse(P, BODIES[i]) == _parse(RP, BODIES[i])


def test_framing_matches_reference():
    for mod in (P, RP):
        assert mod.parse_tokens(mod.detok([1, 22, 63])) == [1, 22, 63]
    cases = [
        ("chunk_dict", ("cid", 1, "m"), dict(role="assistant")),
        ("chunk_dict", ("cid", 1, "m"), dict(content=P.detok([4, 9]))),
        ("chunk_dict", ("cid", 1, "m"),
         dict(finish_reason="length", usage=P.usage_dict(3, 5))),
        ("completion_dict", ("cid", 1, "m", "4 9", "stop",
                             P.usage_dict(2, 2)), {}),
        ("usage_dict", (3, 5), {}),
    ]
    for name, args, kw in cases:
        got, want = getattr(P, name)(*args, **kw), getattr(RP, name)(*args,
                                                                     **kw)
        assert got == want
        assert P.sse_event(got) == RP.sse_event(want)
    assert P.SSE_DONE == RP.SSE_DONE and H.SSE_HEADER == RH.SSE_HEADER
    stats = {"queue_depth": 2, "swap": True, "clock": "wall",
             "mean_verify_occupancy": 1.25,
             "hist_ttft_ms": hist_from([0.5, 12.0, 900.0, 1e6])}
    assert P.metrics_text(stats) == RP.metrics_text(stats)
    for status, kw in ((200, {}), (429, dict(extra_headers={
            "Retry-After": "1"})), (400, dict(keep_alive=True))):
        assert H.response(status, b"{}", **kw) == RH.response(status, b"{}",
                                                             **kw)


REQUESTS = [
    b"GET /metrics?replica=1&format=json HTTP/1.1\r\nHost: x\r\n\r\n",
    b"POST /v1/chat/completions HTTP/1.1\r\nContent-Length: 2\r\n"
    b"Connection: keep-alive\r\n\r\n{}",
    b"POST /v HTTP/1.1\r\nTransfer-Encoding: chunked\r\n\r\n"
    b"3\r\nabc\r\n0\r\n\r\n",
    b"BROKEN\r\n\r\n",
]


def _read(mod, data):
    async def go():
        reader = asyncio.StreamReader()
        reader.feed_data(data)
        reader.feed_eof()
        try:
            req = await mod.read_request(reader)
        except mod.BadRequest as e:
            return "error", str(e)
        return "ok", vars(req), mod.wants_keep_alive(req.headers)
    return asyncio.run(go())


@pytest.mark.parametrize("i", range(len(REQUESTS)))
def test_read_request_matches_reference(i):
    assert _read(H, REQUESTS[i]) == _read(RH, REQUESTS[i])


@pytest.mark.parametrize("dev,want", [("cpu", None), ("cuda", 3),
                                      ("cuda:1", 1)])
def test_engine_thread_device(monkeypatch, dev, want):
    """The engine thread serves on the card of the fleet's shared
    ``DeviceRuntime``; a bare ``"cuda"`` means the caller's current
    device (here 3)."""
    from types import SimpleNamespace
    from repro_torch.serving.gateway.app import _cuda_index
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 3)
    server = SimpleNamespace(device=SimpleNamespace(device=torch.device(dev)))
    assert _cuda_index(server) == want


# ---------------------------------------------------------------------------
# Over a socket
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pair():
    slm, llm = tiny_pair(vocab=64)
    slm_p = JM.init_params(slm, jax.random.PRNGKey(0))
    llm_p = JM.init_params(llm, jax.random.PRNGKey(1))
    pslm, pllm = port_tiny_pair(vocab=64)
    return dict(
        slm=slm, llm=llm, slm_p=slm_p, llm_p=llm_p, pslm=pslm, pllm=pllm,
        t_slm_p=bridge.params_from_reference(
            jax.tree.map(np.asarray, slm_p), device="cpu"),
        t_llm_p=bridge.params_from_reference(
            jax.tree.map(np.asarray, llm_p), device="cpu"))


def _router(pair):
    dev = DeviceRuntime(pair["pslm"], pair["t_slm_p"], device="cpu",
                        policy=OffloadPolicy(mode="all"), **DEVICE_KW)
    engines = [CloudEngine(pair["pllm"], pair["t_llm_p"], device="cpu",
                           **ENGINE_KW) for _ in range(2)]
    return ReplicaRouter(build_fleet(dev, engines, clock=RealClock(),
                                     clamp_arrivals=True),
                         policy="prefix-affinity")


def _prompt(seed=5, length=8):
    rng = np.random.default_rng(seed)
    return [int(t) for t in rng.integers(1, 60, length)]


def _chat(prompt, max_new):
    body = json.dumps({"model": "synera-tiny", "stream": True,
                       "max_tokens": max_new,
                       "messages": [{"role": "user",
                                     "content": P.detok(prompt)}]}).encode()
    return (b"POST /v1/chat/completions HTTP/1.1\r\nHost: localhost\r\n"
            b"Connection: close\r\nContent-Type: application/json\r\n"
            + f"Content-Length: {len(body)}\r\n\r\n".encode() + body)


def _connect(port):
    return socket.create_connection(("127.0.0.1", port),
                                    timeout=SOCKET_TIMEOUT_S)


def _read_all(sock) -> bytes:
    data = b""
    while chunk := sock.recv(65536):
        data += chunk
    return data


def _status(data: bytes) -> int:
    return int(data.split(b"\r\n", 1)[0].split()[1])


def _streamed_tokens(body: bytes) -> list[int]:
    frames = [f[len(b"data: "):] for f in body.split(b"\n\n")
              if f.startswith(b"data: ")]
    assert frames[-1] == b"[DONE]"
    chunks = [json.loads(f) for f in frames[:-1]]
    assert chunks[0]["choices"][0]["delta"] == {"role": "assistant"}
    assert chunks[-1]["choices"][0]["finish_reason"] == "length"
    return P.parse_tokens("".join(c["choices"][0]["delta"].get("content", "")
                                  for c in chunks[1:-1]))


def test_stream_over_socket_matches_reference(pair):
    prompt = _prompt()
    ref_dev = RefDevice(pair["slm"], pair["slm_p"],
                        policy=RefPolicy(mode="all"), **DEVICE_KW)
    ref_eng = RefEngine(pair["llm"], pair["llm_p"], **ENGINE_KW)
    want = [int(t) for t in RSY.run_synera(ref_dev, ref_eng, [prompt],
                                           MAX_NEW).outputs[0]]
    router = _router(pair)
    gw = Gateway(router, GatewayConfig(port=0, max_active=2,
                                       queue_cap=2)).start()
    try:
        sock = _connect(gw.port)
        try:
            sock.sendall(_chat(prompt, MAX_NEW))
            data = _read_all(sock)
        finally:
            sock.close()
        assert _status(data) == 200
        assert _streamed_tokens(data.partition(b"\r\n\r\n")[2]) == want
    finally:
        gw.close()
    assert not any(t.is_alive() for t in gw._threads)
    stats = router.stats()
    assert stats["completed_streams"] == 1 and stats["replicas"] == 2


def test_429_at_queue_cap(pair):
    """One stream held open (its fleet is not stepped) fills
    ``max_active + queue_cap``: the next request is refused with 429 and
    ``Retry-After``; released, the held stream completes."""
    router = _router(pair)
    gate = threading.Event()

    def held_step():
        gate.wait(SOCKET_TIMEOUT_S)
        return ReplicaRouter.step(router)

    router.step = held_step
    gw = Gateway(router, GatewayConfig(port=0, max_active=1,
                                       queue_cap=0)).start()
    held = _connect(gw.port)
    try:
        held.sendall(_chat(_prompt(7), 4))
        head = b""
        while b"data: " not in head:          # accepted: the role frame
            head += held.recv(65536)
        sock = _connect(gw.port)
        try:
            sock.sendall(_chat(_prompt(9), 4))
            data = _read_all(sock)
        finally:
            sock.close()
        assert _status(data) == 429
        head_lines = data.partition(b"\r\n\r\n")[0].lower()
        assert b"retry-after: 1" in head_lines
        body = json.loads(data.partition(b"\r\n\r\n")[2])
        assert body["error"]["type"] == "rate_limit_error"
        gate.set()
        rest = head + _read_all(held)
        assert len(_streamed_tokens(rest.partition(b"\r\n\r\n")[2])) == 4
    finally:
        gate.set()
        held.close()
        gw.close()
    stats = router.stats()
    assert stats["rejected_requests"] == 1
    assert stats["completed_streams"] == 1
