"""AsyncEngine: asyncio front-end over the persistent step loop (port
of `repro.serving.async_engine`).

One background thread runs ONE persistent `StepLoop` (serving/loop.py)
against a live `QueueSource`; asyncio callers talk to it through
`AsyncRequest` handles:

  * `submit(req)`       — enqueue for live admission; returns a handle.
  * `handle.tokens()`   — async iterator of (token_id, bytes) pairs, one
                          per committed token, as they are committed
                          (jump-forward tokens stream mid-step).
  * `handle.result()`   — await the finished RequestState.
  * `handle.cancel()`   — frees the slot and (paged) its KV pages at the
                          next loop step; finish_reason "cancelled". A
                          still-queued request is withdrawn immediately.
  * `Request.deadline`  — seconds from admission; on expiry the request
                          finishes with reason "deadline".
  * `generate(reqs)`    — batch convenience: submit all, await all (the
                          async twin of Engine.generate, token-for-token
                          identical because it drives the same loop).
  * `drain()`           — stop admission, wait for in-flight requests,
                          stop the loop thread. `abort()` cancels
                          everything first.

Sharded engines (`Engine(mesh=...)`): the front end runs on rank 0
alone. Every other rank calls `run_follower(engine, ...)` with the same
mode arguments: it runs the same `StepLoop`, fed by rank 0's
per-iteration broadcast (serving/loop.py), until rank 0's loop ends on
`drain()`. Hot grammar loads reach the followers through that broadcast.

Thread bridging: the loop thread never touches the event loop directly —
tokens and finishes are posted with `call_soon_threadsafe` onto
per-request asyncio queues. Cancellation crosses the other way as a
plain bool on RequestState (safe under the GIL; the loop reads it at the
next step boundary). Nothing here touches the device: the loop thread's
one [B] ids copy per step stays in serving/loop.py and serving/engine.py.
"""
from __future__ import annotations

import asyncio
import threading
from typing import AsyncIterator, Optional

from ..core.tokenizer import EOS_ID
from ..obs import Telemetry
from ..spec.scheduler import SpecConfig
from .devbridge import attach as _attach_devbridge
from .engine import Engine, Request, RequestState
from .loop import ListSource, QueueSource, StepLoop, make_mode

_DONE = object()


class AsyncRequest:
    """Caller-side handle for one submitted request."""

    def __init__(self, req: Request, loop: asyncio.AbstractEventLoop):
        self.req = req
        self._aio = loop
        self._events: asyncio.Queue = asyncio.Queue()
        self._state: Optional[RequestState] = None
        self._cancelled = False
        self._finished = asyncio.Event()
        self._withdraw = None       # set by AsyncEngine (cancel-in-queue)

    # ---- loop-thread side (called via engine callbacks) ----

    def _on_admit(self, st: RequestState) -> None:
        self._state = st
        if self._cancelled:
            st.cancelled = True

    def _on_token(self, st: RequestState, token: int) -> None:
        self._aio.call_soon_threadsafe(self._events.put_nowait, token)

    def _on_finish(self, st: RequestState) -> None:
        self._state = st

        def fin():
            self._events.put_nowait(_DONE)
            self._finished.set()
        self._aio.call_soon_threadsafe(fin)

    # ---- asyncio side ----

    def cancel(self) -> None:
        """Cancel: a queued request is withdrawn immediately; an active
        one frees its slot (and KV pages) at the next loop step."""
        self._cancelled = True
        if self._state is not None:
            self._state.cancelled = True
        elif self._withdraw is not None and self._withdraw():
            st = RequestState(req=self.req)
            st.done = True
            st.finish_reason = "cancelled"
            self._state = st
            self._events.put_nowait(_DONE)
            self._finished.set()

    async def tokens(self) -> AsyncIterator[tuple[int, bytes]]:
        """Stream (token_id, token_bytes) as tokens commit. EOS is not
        yielded; the iterator just ends (await `result()` for the
        finish reason)."""
        while True:
            ev = await self._events.get()
            if ev is _DONE:
                return
            t = int(ev)
            if t == EOS_ID:
                continue
            yield t, self._tokenizer.id_to_bytes[t]

    async def text(self) -> AsyncIterator[bytes]:
        """Stream just the byte chunks."""
        async for _, tb in self.tokens():
            yield tb

    async def result(self) -> RequestState:
        await self._finished.wait()
        return self._state

    @property
    def finished(self) -> bool:
        return self._finished.is_set()


class AsyncEngine:
    """Persistent async serving wrapper around a (sync) Engine.

    The mode — dense / paged / speculative — mirrors the Engine flags,
    exactly like the synchronous entry points; `spec` switches to the
    speculative step body. The loop thread starts lazily on the first
    submit and runs until `drain()`/`abort()`.
    """

    def __init__(self, engine: Engine, spec: Optional[SpecConfig] = None,
                 speculative: bool = False,
                 overlap: Optional[bool] = None, verbose: bool = False,
                 telemetry: Optional[Telemetry] = None):
        self.engine = engine
        self._mode = make_mode(engine, spec=spec, speculative=speculative,
                               overlap=overlap)
        self._verbose = verbose
        # ONE persistent Telemetry for the engine's whole lifetime: the
        # HTTP server scrapes it live (/metrics, /stats, /trace) while
        # the loop streams — cumulative across requests, unlike the
        # per-run instance a sync generate() call creates
        self.telemetry = telemetry if telemetry is not None else \
            Telemetry(enabled=engine.telemetry_enabled)
        # bind the CUDA sync and profiler now, not at lazy loop start:
        # POST /profile must work before the first request
        _attach_devbridge(self.telemetry, engine.device)
        self._source = QueueSource()
        self._handles: dict[int, AsyncRequest] = {}
        self._hlock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._loop_obj: Optional[StepLoop] = None
        self._loop_error: Optional[BaseException] = None
        self._aio: Optional[asyncio.AbstractEventLoop] = None
        self._next_rid = 0
        self._loading: set = set()      # grammar names posted, not applied

    # ------------------------------ loop ------------------------------

    def start(self) -> None:
        """Start the step loop now, not at the first submit (a sharded
        engine's followers wait on its broadcast from the start). Must be
        called from a running asyncio event loop; idempotent."""
        self._ensure_started()

    def _ensure_started(self) -> None:
        if self._thread is not None:
            return
        self._aio = asyncio.get_running_loop()
        self._loop_obj = StepLoop(
            self.engine, self._mode, self._source,
            verbose=self._verbose,
            on_token=self._dispatch_token,
            on_admit=self._dispatch_admit,
            on_finish=self._dispatch_finish,
            keep_states=False,
            telemetry=self.telemetry)
        self._thread = threading.Thread(
            target=self._run_loop, name="repro-step-loop", daemon=True)
        self._thread.start()

    def _run_loop(self) -> None:
        try:
            self._loop_obj.run()
        except BaseException as e:         # surface in result()/drain()
            self._loop_error = e
            if self._aio is not None:
                self._aio.call_soon_threadsafe(self._fail_all, e)

    def _fail_all(self, e: BaseException) -> None:
        with self._hlock:
            handles = list(self._handles.values())
            self._handles.clear()
        for h in handles:
            if not h.finished:
                h._events.put_nowait(_DONE)
                h._finished.set()

    def _handle_for(self, st: RequestState) -> Optional[AsyncRequest]:
        with self._hlock:
            return self._handles.get(st.req.rid)

    def _dispatch_admit(self, st: RequestState) -> None:
        h = self._handle_for(st)
        if h is not None:
            h._on_admit(st)

    def _dispatch_token(self, st: RequestState, token: int) -> None:
        h = self._handle_for(st)
        if h is not None:
            h._on_token(st, token)

    def _dispatch_finish(self, st: RequestState) -> None:
        h = self._handle_for(st)
        if h is not None:
            # Pop BEFORE signalling the finish: `result()` returning must
            # imply the rid is free for re-submission (the pop runs on the
            # loop thread; the finish event fires later on the asyncio
            # thread, so the reverse order races with a fresh submit()).
            with self._hlock:
                self._handles.pop(st.req.rid, None)
            h._on_finish(st)

    # ---------------------------- interface ---------------------------

    def submit(self, req: Request) -> AsyncRequest:
        """Enqueue a request for live admission. Must be called from a
        running asyncio event loop. rid must be unique among in-flight
        requests (use `next_rid()`)."""
        self._ensure_started()
        if self._loop_error is not None:
            raise RuntimeError("step loop died") from self._loop_error
        h = AsyncRequest(req, self._aio)
        h._tokenizer = self.engine.tok

        def withdraw():
            if self._source.remove(req):
                with self._hlock:
                    self._handles.pop(req.rid, None)
                self.telemetry.lifecycle.on_finish(req.rid, "cancelled")
                return True
            return False
        h._withdraw = withdraw
        with self._hlock:
            if req.rid in self._handles:
                raise ValueError(f"rid {req.rid} already in flight")
            self._handles[req.rid] = h
        # enqueue-time stamp BEFORE the queue insert: the loop thread
        # can admit the request the instant it lands in the source
        self.telemetry.lifecycle.on_enqueue(req.rid)
        try:
            self._source.submit(req)
        except BaseException:
            # e.g. the source closed (drain) between checks: don't leak
            # the registered handle (or its lifecycle record)
            with self._hlock:
                self._handles.pop(req.rid, None)
            self.telemetry.lifecycle.on_finish(req.rid, "rejected")
            raise
        return h

    def next_rid(self) -> int:
        self._next_rid += 1
        return self._next_rid - 1

    async def load_grammar(self, name: str, bundle) -> None:
        """Hot-load a freshly compiled (grammar, table, store) bundle
        into the LIVE engine — no restart, no dropped requests.

        The registration itself (growing the concatenated device store)
        runs on the step-loop thread between steps via the loop's
        control queue; this coroutine resolves once it has been applied,
        after which `name` is valid in Request.grammar. If the loop
        thread has not started yet (nothing submitted so far), the
        engine is mutated directly — there is no concurrent step to
        race with.
        """
        if self._loop_error is not None:
            raise RuntimeError("step loop died") from self._loop_error
        mesh = self.engine.mesh
        if mesh is not None and mesh.size > 1:
            # the other ranks replay the registration, so it must not
            # fail there: refuse a bad one here, and run it on the loop
            self.engine.check_grammar(name, bundle)
            if name in self._loading:
                raise ValueError(f"grammar {name!r} already loading")
            self._ensure_started()
        elif self._thread is None or not self._thread.is_alive():
            self.engine.register_grammar(name, bundle)
            return
        aio = asyncio.get_running_loop()
        done = asyncio.Event()
        box: list = [None]

        def apply():
            try:
                self.engine.register_grammar(name, bundle)
            except BaseException as e:     # deliver to the awaiting caller
                box[0] = e
            aio.call_soon_threadsafe(done.set)

        self._loading.add(name)
        self._loop_obj.post_control(
            apply, replicate=("register_grammar", (name, bundle)))
        try:
            await self._await_control(done, name, bundle)
        finally:
            self._loading.discard(name)
        if box[0] is not None:
            raise box[0]

    async def _await_control(self, done, name, bundle) -> None:
        while not done.is_set():
            try:
                await asyncio.wait_for(done.wait(), timeout=0.2)
            except asyncio.TimeoutError:
                if not self._thread.is_alive() and not done.is_set():
                    # the loop exited (drain/death) without running the
                    # control: no concurrent steps remain, apply directly
                    if name not in self.engine.bundles:
                        self.engine.register_grammar(name, bundle)
                    return

    async def generate(self, requests: list[Request]):
        """Async twin of Engine.generate/generate_speculative: submit
        everything, await everything. Token-for-token identical to the
        sync engine because it drives the same StepLoop + mode."""
        handles = [self.submit(r) for r in requests]
        states = [await h.result() for h in handles]
        if self._loop_error is not None:
            raise RuntimeError("step loop died") from self._loop_error
        return states, self.stats()

    def stats(self):
        if self._loop_obj is None:
            raise RuntimeError("loop not started")
        return self._loop_obj.stats()

    async def drain(self) -> None:
        """Graceful drain: no new submissions; in-flight requests run to
        completion; the loop thread exits."""
        if self._thread is None:
            return
        self._source.close()
        while self._thread.is_alive():
            await asyncio.sleep(0.01)
        if self._loop_error is not None:
            raise RuntimeError("step loop died") from self._loop_error

    async def abort(self) -> None:
        """Cancel everything in flight, then drain."""
        with self._hlock:
            handles = list(self._handles.values())
        for h in handles:
            h.cancel()
        await self.drain()


def run_follower(engine: Engine, spec: Optional[SpecConfig] = None,
                 speculative: bool = False, overlap: Optional[bool] = None,
                 telemetry: Optional[Telemetry] = None,
                 keep_states: bool = False):
    """A follower rank's side of a sharded AsyncEngine (rank 0 runs the
    front end): the same step loop and mode as rank 0's AsyncEngine, fed
    by rank 0's broadcast, until rank 0's loop ends. -> (states, or None
    without `keep_states`; stats)."""
    mesh = engine.mesh
    if mesh is None or mesh.rank == 0:
        raise ValueError("run_follower runs on the ranks 1.. of a sharded "
                         "engine's mesh; rank 0 runs the AsyncEngine")
    loop = StepLoop(engine, make_mode(engine, spec=spec,
                                      speculative=speculative,
                                      overlap=overlap),
                    ListSource([]), keep_states=keep_states,
                    telemetry=telemetry)
    return loop.run()
