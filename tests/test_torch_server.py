"""The port's streaming HTTP server (`repro_torch.serving.server`, NDJSON
over a persistent AsyncEngine) on the narrow syncode-demo of
tests/test_async_engine.py, with the reference's weights bridged into
the port (tests/_torch_parity.py).

The streamed `text` chunks join to the terminal line's text, which is
the reference's AsyncEngine output for the same request, token for
token; a client that walks away cancels its request and frees its slot;
`POST /grammars` compiles with the port's copied `core/` and hot-loads
into the live engine; the observability routes answer, and on the CPU
`POST /profile` captures host spans only (no backend profiler is bound
there)."""
import asyncio
import json

import pytest

from repro.serving.async_engine import AsyncEngine as JaxAsyncEngine
from repro_torch.serving.async_engine import AsyncEngine
from repro_torch.serving.engine import Engine
from repro_torch.serving.server import EngineServer
from tests._torch_parity import (NARROW, build_sides, engines,
                                 jax_noise_fn, requests)

MAX_LEN = 160


@pytest.fixture(scope="module")
def sides():
    return build_sides(**NARROW)


def _port(sides, grammars=None, **kw):
    _, _, _, _, tm, tp, ttok, tb = sides
    bs = tb if grammars is None else {k: tb[k] for k in grammars}
    return Engine(tm, tp, ttok, bs, max_len=MAX_LEN, slots=4, device="cpu",
                  **kw)


async def _http(host, port, method, path, body=b""):
    reader, writer = await asyncio.open_connection(host, port)
    writer.write((f"{method} {path} HTTP/1.1\r\nHost: x\r\n"
                  f"Content-Length: {len(body)}\r\n\r\n").encode() + body)
    await writer.drain()
    data = await reader.read()
    writer.close()
    try:
        await writer.wait_closed()
    except (ConnectionError, BrokenPipeError):
        pass
    head, _, rest = data.partition(b"\r\n\r\n")
    status = int(head.split(b" ")[1])
    if b"chunked" in head.lower():
        out, rem = b"", rest
        while rem:
            size, _, rem = rem.partition(b"\r\n")
            n = int(size, 16)
            if n == 0:
                break
            out += rem[:n]
            rem = rem[n + 2:]
        return status, out
    return status, rest


def _serve(aeng, body):
    """Start a server over `aeng`, run `body(host, port)`, stop."""
    async def go():
        srv = EngineServer(aeng)
        host, port = await srv.start(port=0)
        try:
            return await body(host, port)
        finally:
            await srv.stop(drain=False)
    return asyncio.run(go())


@pytest.mark.parametrize("method,grammar", [("sample", "json"),
                                            ("greedy", "sql")])
def test_server_streams_the_reference_output(sides, method, grammar):
    jeng, _ = engines(sides, MAX_LEN, slots=4)
    spec = (0, grammar, b"say:", 10, method, 1.0, None, None)

    async def ref():
        aeng = JaxAsyncEngine(jeng)
        try:
            return (await aeng.generate(requests([spec])[0]))[0][0]
        finally:
            await aeng.drain()
    want = asyncio.run(ref())
    teng = _port(sides, noise_fn=jax_noise_fn)

    async def body(host, port):
        status, out = await _http(host, port, "GET", "/healthz")
        assert status == 200 and json.loads(out)["ok"] is True
        status, out = await _http(
            host, port, "POST", "/generate",
            json.dumps({"prompt": "say:", "grammar": grammar,
                        "max_new_tokens": 10, "method": method,
                        "temperature": 1.0,
                        "seed": want.req.seed}).encode())
        assert status == 200
        lines = [json.loads(ln) for ln in out.splitlines() if ln]
        final = lines[-1]
        assert final["done"] is True
        assert "".join(ln["text"] for ln in lines[:-1]) == final["text"]
        assert final["text"] == want.generated.decode()
        assert final["finish_reason"] == want.finish_reason
        assert final["tokens"] == len(lines) - 1
        status, _ = await _http(host, port, "POST", "/generate",
                                json.dumps({"grammar": "nope"}).encode())
        assert status == 400
    _serve(AsyncEngine(teng), body)


def test_server_disconnect_cancels_request(sides):
    aeng = AsyncEngine(_port(sides))

    async def body(host, port):
        reader, writer = await asyncio.open_connection(host, port)
        req = json.dumps({"prompt": "Q:", "grammar": "json",
                          "max_new_tokens": 400, "method": "sample",
                          "temperature": 1.0}).encode()
        writer.write((f"POST /generate HTTP/1.1\r\nHost: x\r\n"
                      f"Content-Length: {len(req)}\r\n\r\n").encode() + req)
        await writer.drain()
        await reader.readline()              # the status line arrives
        writer.close()                       # the client walks away
        try:
            await writer.wait_closed()
        except (ConnectionError, BrokenPipeError):
            pass
        for _ in range(300):
            await asyncio.sleep(0.02)
            if not aeng._loop_obj.active() and not aeng._handles:
                break
        assert not aeng._loop_obj.active()
        status, out = await _http(host, port, "GET", "/healthz")
        health = json.loads(out)
        assert health["active"] == 0
        assert health["finish_reasons"].get("cancelled") == 1
    _serve(aeng, body)


def test_server_grammar_mode_and_hot_load(sides):
    """POST /grammars compiles and hot-loads a grammar into the live
    server; the next /generate may use it. grammar_mode is validated
    and passed per request."""
    tiny = 'start: "x" start | "x"\n'
    eng = _port(sides, grammars=("json",))

    async def body(host, port):
        status, _ = await _http(host, port, "POST", "/generate", json.dumps(
            {"grammar": "json", "grammar_mode": "nope"}).encode())
        assert status == 400
        status, _ = await _http(host, port, "POST", "/generate",
                                json.dumps({"grammar": "tiny"}).encode())
        assert status == 400
        status, out = await _http(
            host, port, "POST", "/grammars",
            json.dumps({"name": "tiny", "text": tiny}).encode())
        assert status == 200, out
        assert json.loads(out)["ok"] is True
        status, out = await _http(host, port, "GET", "/healthz")
        assert "tiny" in json.loads(out)["grammars"]
        status, out = await _http(
            host, port, "POST", "/generate",
            json.dumps({"prompt": "go:", "grammar": "tiny",
                        "grammar_mode": "grammar_strict",
                        "max_new_tokens": 6, "stream": False}).encode())
        assert status == 200, out
        final = json.loads(out.splitlines()[-1])
        assert final["done"] is True
        assert final["text"] and set(final["text"]) <= {"x"}
        status, _ = await _http(
            host, port, "POST", "/grammars",
            json.dumps({"name": "tiny", "text": tiny}).encode())
        assert status == 409
        status, _ = await _http(
            host, port, "POST", "/grammars",
            json.dumps({"name": "bad", "text": "start: %%"}).encode())
        assert status == 400
    _serve(AsyncEngine(eng), body)


def test_server_observability_routes(sides):
    """/metrics is Prometheus text, /stats JSON, /trace and /profile
    capture host spans; the CPU binds no backend profiler."""
    aeng = AsyncEngine(_port(sides))

    async def body(host, port):
        status, out = await _http(host, port, "POST", "/profile",
                                  json.dumps({"action": "start"}).encode())
        assert status == 200
        assert json.loads(out)["backend_profiler"] is False
        await _http(host, port, "POST", "/generate", json.dumps(
            {"prompt": "Q:", "grammar": "calc", "max_new_tokens": 4,
             "stream": False}).encode())
        status, _ = await _http(host, port, "POST", "/profile",
                                json.dumps({"action": "stop"}).encode())
        assert status == 200
        status, out = await _http(host, port, "POST", "/profile",
                                  json.dumps({"action": "dump"}).encode())
        names = {e.get("name") for e in json.loads(out)["traceEvents"]}
        assert {"forward", "mask_dispatch"} <= names
        status, out = await _http(host, port, "GET", "/metrics")
        text = out.decode()
        assert status == 200
        assert "repro_tokens_total" in text
        assert "repro_opportunistic_hits_total" in text
        status, out = await _http(host, port, "GET", "/stats")
        assert status == 200 and isinstance(json.loads(out), dict)
        status, _ = await _http(host, port, "POST", "/trace",
                                json.dumps({"action": "bogus"}).encode())
        assert status == 400
    _serve(aeng, body)
