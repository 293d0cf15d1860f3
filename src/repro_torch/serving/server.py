"""Minimal streaming HTTP endpoint over the AsyncEngine (stdlib only;
port of `repro.serving.server`).

`python -m repro_torch.launch.serve --serve --port 8400` starts it on
the card; clients
POST JSON and read newline-delimited JSON (NDJSON) chunks as tokens
commit — the paper's constrained decoding, served live:

  POST /generate
      {"prompt": "...", "grammar": "json" | null,
       "grammar_mode": "grammar_mask" | "grammar_strict" | null,
       "max_new_tokens": 64, "method": "greedy" | "sample",
       "temperature": 1.0, "top_k": 0, "top_p": 1.0, "seed": 0,
       "deadline": null | seconds, "stream": true}
  ->  {"token": 17, "text": "{\""}        one line per committed token
      ...
      {"done": true, "finish_reason": "eos", "tokens": 12,
       "text": "<full output>"}           terminal line

  `"stream": false` returns only the terminal line. Disconnecting
  mid-stream cancels the request — its slot and KV pages free at the
  next engine step. `"grammar_mode"` null/omitted uses the engine
  default (--grammar-mode).

  POST /grammars
      {"name": "my_dsl", "text": "<lark grammar source>"}
  ->  {"ok": true, "grammar": "my_dsl", "terminals": n, "rows": r}

  compiles the grammar, builds its mask store, and hot-loads it into
  the live engine between steps (AsyncEngine.load_grammar) — requests
  already streaming keep running; the next /generate may use it.

  GET /healthz -> {"ok": true, "slots": B, "active": n,
                   "grammars": [...], "uptime_seconds": s,
                   "queue_depth": q, "finish_reasons": {...}}

Observability surfaces (docs/observability.md):

  GET  /metrics  -> Prometheus text exposition: step-phase seconds,
                    TTFT/ITL/queue-wait histograms, token/mask/overlap
                    counters, KV pool gauges, device-attribution
                    counters and (in profile mode) device intervals.
  GET  /stats    -> the same data as one JSON snapshot (plus request
                    p50/p99 summaries, build identity, the per-step
                    attribution split and trace-buffer state).
  POST /trace    -> {"action": "start" | "stop" | "dump" | "clear"}.
                    start/stop toggle span capture into the bounded
                    ring buffer; dump returns Chrome trace-event JSON
                    (loadable in ui.perfetto.dev) without stopping.
  POST /profile  -> {"action": "start" | "stop" | "dump"}. Live
                    profiler capture: start flips device spans into
                    sync-on-exit mode (the documented profile-mode
                    exception to the serving no-sync contract), starts
                    trace capture AND a torch.profiler trace (CPU and
                    CUDA activities, serving/devbridge.py); dump (after
                    stop) returns ONE Chrome trace document with the
                    host phase spans, the synced device brackets, and
                    the profiler's kernel-thread slices merged on a
                    shared host-clock timeline.

The HTTP layer is deliberately tiny (HTTP/1.1, Content-Length bodies,
chunked responses); production fronting belongs in a real proxy — this
endpoint's job is exercising live admission, streaming, cancellation
and backpressure against the persistent step loop.
"""
from __future__ import annotations

import asyncio
import json
from typing import Optional

from ..core.constrain import GrammarConstraint
from ..core.decoding import DecodeConfig
from ..obs import build_info
from .async_engine import AsyncEngine
from .engine import Request

_MAX_BODY = 1 << 20


class ServerError(Exception):
    def __init__(self, status: int, msg: str):
        super().__init__(msg)
        self.status = status
        self.msg = msg


async def _read_request(reader) -> tuple[str, str, bytes]:
    line = await reader.readline()
    if not line:
        raise ConnectionError("closed")
    try:
        method, path, _ = line.decode("latin-1").split(" ", 2)
    except ValueError:
        raise ServerError(400, "bad request line")
    clen = 0
    while True:
        h = await reader.readline()
        if h in (b"\r\n", b"\n", b""):
            break
        name, _, val = h.decode("latin-1").partition(":")
        if name.strip().lower() == "content-length":
            try:
                clen = int(val.strip())
            except ValueError:
                raise ServerError(400, "bad content-length")
    if clen > _MAX_BODY:
        raise ServerError(413, "body too large")
    body = await reader.readexactly(clen) if clen else b""
    return method, path, body


def _start_response(writer, status: int, reason: str,
                    content_type: str = "application/x-ndjson",
                    chunked: bool = True,
                    body: Optional[bytes] = None) -> None:
    hdr = [f"HTTP/1.1 {status} {reason}",
           f"Content-Type: {content_type}",
           "Connection: close"]
    if chunked:
        hdr.append("Transfer-Encoding: chunked")
    else:
        hdr.append(f"Content-Length: {len(body or b'')}")
    writer.write(("\r\n".join(hdr) + "\r\n\r\n").encode("latin-1"))
    if not chunked and body:
        writer.write(body)


def _chunk(writer, data: bytes) -> None:
    writer.write(f"{len(data):x}\r\n".encode("latin-1") + data + b"\r\n")


def _end_chunks(writer) -> None:
    writer.write(b"0\r\n\r\n")


def _parse_generate(body: bytes, grammars, rid: int) -> tuple[Request, bool]:
    try:
        spec = json.loads(body.decode() or "{}")
    except (ValueError, UnicodeDecodeError):
        raise ServerError(400, "body is not JSON")
    grammar = spec.get("grammar")
    if grammar is not None and grammar not in grammars:
        raise ServerError(400, f"unknown grammar {grammar!r}; "
                               f"have {sorted(grammars)}")
    gmode = spec.get("grammar_mode")
    if gmode is not None and gmode not in GrammarConstraint.MODES:
        raise ServerError(400, f"bad grammar_mode {gmode!r}; expected "
                               f"one of {list(GrammarConstraint.MODES)}")
    method = spec.get("method", "greedy")
    if method not in ("greedy", "sample"):
        raise ServerError(400, f"bad method {method!r}")
    dc = DecodeConfig(method=method,
                      temperature=float(spec.get("temperature", 1.0)),
                      top_k=spec.get("top_k") or None,
                      top_p=spec.get("top_p"))
    deadline = spec.get("deadline")
    req = Request(rid=rid,
                  prompt=str(spec.get("prompt", "")).encode(),
                  grammar=grammar,
                  grammar_mode=gmode,
                  max_new_tokens=int(spec.get("max_new_tokens", 64)),
                  decode=dc,
                  seed=int(spec.get("seed", 0)),
                  deadline=float(deadline) if deadline is not None
                  else None)
    return req, bool(spec.get("stream", True))


class EngineServer:
    def __init__(self, async_engine: AsyncEngine):
        self.aeng = async_engine
        self._server: Optional[asyncio.AbstractServer] = None

    # ------------------------------ routes ----------------------------

    async def _generate(self, reader, writer, body: bytes) -> None:
        req, stream = _parse_generate(body, self.aeng.engine.bundles,
                                      self.aeng.next_rid())
        handle = self.aeng.submit(req)      # raises pre-response: the
                                            # generic 503 path applies
        # disconnect watch: streamed responses notice a dead peer at the
        # next chunk write, but a "stream": false request writes nothing
        # until the end — watch the read side for EOF so a disconnect
        # cancels (frees the slot + KV pages) in that mode too
        def on_eof(t):
            if not t.cancelled():
                t.exception()               # retrieve; reset == EOF here
                if not handle.finished:
                    handle.cancel()
        eof_watch = asyncio.ensure_future(reader.read())
        eof_watch.add_done_callback(on_eof)
        _start_response(writer, 200, "OK")
        n = 0
        try:
            async for tid, tb in handle.tokens():
                n += 1
                if stream:
                    _chunk(writer, json.dumps(
                        {"token": tid,
                         "text": tb.decode("utf-8", "replace")}
                    ).encode() + b"\n")
                    await writer.drain()
            st = await handle.result()
            _chunk(writer, json.dumps(
                {"done": True,
                 "finish_reason": st.finish_reason if st else "error",
                 "tokens": n,
                 "text": (st.generated if st else b"").decode(
                     "utf-8", "replace")}).encode() + b"\n")
            _end_chunks(writer)
            await writer.drain()
        except (ConnectionError, BrokenPipeError, asyncio.CancelledError):
            # client went away mid-stream: free the slot + KV pages now
            handle.cancel()
            raise
        except Exception:
            # mid-stream engine failure: the chunked body has already
            # started, so no status line can help — cancel the request
            # and close; the truncated chunked stream signals the error
            handle.cancel()
        finally:
            eof_watch.cancel()

    async def _load_grammar(self, writer, body: bytes) -> None:
        """Compile + hot-load a grammar into the live engine (no restart).

        The compile and mask-store build run in a worker thread (they are
        pure CPU and can take seconds); only the final registration —
        growing the concatenated device store — crosses onto the step
        loop's control queue between steps."""
        try:
            spec = json.loads(body.decode() or "{}")
        except (ValueError, UnicodeDecodeError):
            raise ServerError(400, "body is not JSON")
        name = spec.get("name")
        text = spec.get("text")
        if not name or not isinstance(name, str):
            raise ServerError(400, "missing grammar 'name'")
        if not text or not isinstance(text, str):
            raise ServerError(400, "missing grammar 'text'")
        if name in self.aeng.engine.bundles:
            raise ServerError(409, f"grammar {name!r} already loaded")

        def compile_bundle():
            from ..core.grammar import Grammar
            from ..core.lr import build_lr_table
            from ..core.mask_store import build_mask_store
            g = Grammar(text, name=name)
            tab = build_lr_table(g)
            store = build_mask_store(g, self.aeng.engine.tok)
            return g, tab, store
        try:
            bundle = await asyncio.get_running_loop().run_in_executor(
                None, compile_bundle)
        except Exception as e:
            raise ServerError(400, f"grammar compile failed: {e}")
        await self.aeng.load_grammar(name, bundle)
        g = bundle[0]
        out = json.dumps({"ok": True, "grammar": name,
                          "terminals": len(g.terminal_names),
                          "rows": int(bundle[2].packed.shape[0])}).encode()
        _start_response(writer, 200, "OK", "application/json",
                        chunked=False, body=out)

    async def _healthz(self, writer) -> None:
        loop = self.aeng._loop_obj
        tele = self.aeng.telemetry
        active = 0 if loop is None else len(loop.active())
        body = json.dumps({
            "ok": True,
            "slots": self.aeng.engine.slots,
            "active": active,
            "grammars": sorted(self.aeng.engine.bundles),
            "uptime_seconds": tele.uptime(),
            "queue_depth": len(self.aeng._source),
            "finish_reasons": tele.lifecycle.finish_reasons(),
            "build": build_info(),
        }).encode()
        _start_response(writer, 200, "OK", "application/json",
                        chunked=False, body=body)

    async def _metrics(self, writer) -> None:
        text = self.aeng.telemetry.registry.render_prometheus()
        _start_response(writer, 200, "OK",
                        "text/plain; version=0.0.4; charset=utf-8",
                        chunked=False, body=text.encode())

    async def _stats(self, writer) -> None:
        body = json.dumps(self.aeng.telemetry.stats_json()).encode()
        _start_response(writer, 200, "OK", "application/json",
                        chunked=False, body=body)

    async def _trace(self, writer, body: bytes) -> None:
        try:
            spec = json.loads(body.decode() or "{}")
        except (ValueError, UnicodeDecodeError):
            raise ServerError(400, "body is not JSON")
        action = spec.get("action")
        tele = self.aeng.telemetry
        if action == "start":
            if not tele.enabled:
                raise ServerError(409, "telemetry disabled "
                                       "(engine started with "
                                       "telemetry=False)")
            tele.tracer.clear()
            tele.tracer.start()
            out = {"ok": True, "tracing": True}
        elif action == "stop":
            tele.tracer.stop()
            out = {"ok": True, "tracing": False,
                   "buffered_events": len(tele.tracer)}
        elif action == "dump":
            out = tele.tracer.export_chrome()
        elif action == "clear":
            tele.tracer.clear()
            out = {"ok": True, "buffered_events": 0}
        else:
            raise ServerError(400, f"bad trace action {action!r}; "
                                   f"expected start|stop|dump|clear")
        _start_response(writer, 200, "OK", "application/json",
                        chunked=False, body=json.dumps(out).encode())

    async def _profile(self, writer, body: bytes) -> None:
        """Live profiler capture: devtime sync-on-exit + torch.profiler
        trace, dumped as one merged host+device Chrome timeline."""
        try:
            spec = json.loads(body.decode() or "{}")
        except (ValueError, UnicodeDecodeError):
            raise ServerError(400, "body is not JSON")
        action = spec.get("action")
        tele = self.aeng.telemetry
        prof = tele.profiler
        if action == "start":
            if not tele.enabled:
                raise ServerError(409, "telemetry disabled "
                                       "(engine started with "
                                       "telemetry=False)")
            if prof.active:
                raise ServerError(409, "profile capture already active")
            out = {"ok": True, "profiling": True, **prof.start()}
        elif action == "stop":
            if not prof.active:
                raise ServerError(409, "no profile capture active")
            out = {"ok": True, "profiling": False, **prof.stop()}
        elif action == "dump":
            if prof.active:
                raise ServerError(409, "stop the capture before dump")
            if prof.log_dir is None:
                raise ServerError(409, "no profile capture to dump")
            out = tele.tracer.export_chrome(
                extra_events=prof.collect_chrome_events())
        else:
            raise ServerError(400, f"bad profile action {action!r}; "
                                   f"expected start|stop|dump")
        _start_response(writer, 200, "OK", "application/json",
                        chunked=False, body=json.dumps(out).encode())

    # ---------------------------- connection --------------------------

    async def _handle(self, reader, writer) -> None:
        try:
            try:
                method, path, body = await _read_request(reader)
                if method == "POST" and path == "/generate":
                    await self._generate(reader, writer, body)
                elif method == "POST" and path == "/grammars":
                    await self._load_grammar(writer, body)
                elif method == "GET" and path == "/healthz":
                    await self._healthz(writer)
                elif method == "GET" and path == "/metrics":
                    await self._metrics(writer)
                elif method == "GET" and path == "/stats":
                    await self._stats(writer)
                elif method == "POST" and path == "/trace":
                    await self._trace(writer, body)
                elif method == "POST" and path == "/profile":
                    await self._profile(writer, body)
                else:
                    raise ServerError(404, f"no route {method} {path}")
            except ServerError as e:
                body = json.dumps({"error": e.msg}).encode()
                _start_response(writer, e.status, "Error",
                                "application/json", chunked=False,
                                body=body)
            except (ConnectionError, BrokenPipeError,
                    asyncio.CancelledError):
                raise
            except Exception as e:
                # engine-side failures before any bytes went out (e.g.
                # submit() during drain) become a JSON 503 instead of a
                # silent connection reset. Mid-stream failures can only
                # append garbage to an already-started chunked body, so
                # _generate keeps its own narrower handling.
                body = json.dumps(
                    {"error": f"engine unavailable: {e}"}).encode()
                _start_response(writer, 503, "Service Unavailable",
                                "application/json", chunked=False,
                                body=body)
            await writer.drain()
        except (ConnectionError, BrokenPipeError, asyncio.CancelledError):
            pass
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except (ConnectionError, BrokenPipeError):
                pass

    # ----------------------------- lifecycle --------------------------

    async def start(self, host: str = "127.0.0.1", port: int = 8400):
        """Listen. A sharded engine's step loop starts with the server:
        its other ranks take rank 0's broadcast from the start (the
        server runs on rank 0 alone)."""
        mesh = self.aeng.engine.mesh
        if mesh is not None and mesh.size > 1:
            self.aeng.start()
        self._server = await asyncio.start_server(self._handle, host, port)
        return self._server.sockets[0].getsockname()[:2]

    async def serve_forever(self) -> None:
        async with self._server:
            await self._server.serve_forever()

    async def stop(self, drain: bool = True) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
        if drain:
            await self.aeng.drain()
        else:
            await self.aeng.abort()


async def run_server(async_engine: AsyncEngine, host: str = "127.0.0.1",
                     port: int = 8400) -> None:
    srv = EngineServer(async_engine)
    addr = await srv.start(host, port)
    print(f"serving on http://{addr[0]}:{addr[1]} "
          f"(POST /generate, POST /grammars, POST /trace, "
          f"POST /profile, GET /healthz, GET /metrics, GET /stats)")
    await srv.serve_forever()
