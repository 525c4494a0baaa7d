"""Asyncio ingestion in front of the continuous-batching scheduler (port of
:mod:`repro.serving.frontend`: ``AsyncFrontend``, ``result_summary`` and
``request_from_wire``).

The :class:`Scheduler` is synchronous: one thread owns the hot loop and
calls :meth:`~Scheduler.step`.  :class:`AsyncFrontend` puts an asyncio
surface in front of it without blocking that loop:

* Clients ``await submit(request)`` (or connect to the localhost TCP
  socket :meth:`serve_tcp` opens); submissions land on an
  ``asyncio.Queue``.
* One engine task drains the queue into ``Scheduler.submit`` between
  scheduler iterations — a chunk boundary — so an arrival over the front
  joins the batch in flight under the scheduler's own bitwise admission
  contract (tests/test_torch_frontend.py holds a run through the front to
  a direct ``step`` loop, bitwise).
* Each ``Scheduler.step`` runs on a one-worker thread pool through
  ``run_in_executor``, so the event loop keeps taking submissions while a
  batch runs on the card.  All scheduler calls are serialised: ``submit``
  on the loop thread strictly between executor steps.

Ordering: submissions reach the scheduler in queue (arrival) order.
Results resolve per-request futures keyed by ``rid``, each exactly once,
in the scheduler's completion order.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import json
import math
from typing import Dict, Optional, Tuple

from .scheduler import Scheduler
from .types import Request, ServeResult

#: Engine wakeup cadence while idle (seconds).  Only paid when the
#: scheduler has no work at all; any queued submission wakes it at once.
_IDLE_POLL_S = 0.002


def result_summary(result: ServeResult) -> dict:
    """The JSON-safe wire form of a :class:`ServeResult` — everything but
    the sample payload (trajectories never cross the TCP loopback; batch
    clients that want payloads use :class:`AsyncFrontend` in-process with
    a collecting scheduler)."""
    return {
        "rid": result.rid,
        "model_id": result.model_id,
        "size": result.size,
        "num_converged": result.num_converged,
        "latency_s": result.latency_s,
        "deadline_ms": (result.deadline_ms
                        if math.isfinite(result.deadline_ms) else None),
        "deadline_met": bool(result.deadline_met),
        "rtol": result.rtol,
    }


def request_from_wire(obj: dict) -> Request:
    """Build a :class:`Request` from a decoded JSON object (the TCP
    protocol's request form).  Unknown fields error by name — a typo'd
    field silently ignored would serve the wrong ask."""
    if not isinstance(obj, dict):
        raise ValueError(f"request must be a JSON object, got "
                         f"{type(obj).__name__}")
    allowed = {"rid", "size", "seed", "rtol", "deadline_ms", "model_id",
               "kind"}
    unknown = sorted(set(obj) - allowed)
    if unknown:
        raise ValueError(f"unknown request fields {unknown} "
                         f"(allowed: {sorted(allowed)})")
    kw = dict(obj)
    if kw.get("deadline_ms") is None:
        kw["deadline_ms"] = math.inf
    return Request(**kw)


class AsyncFrontend:
    """Async ingestion in front of one :class:`Scheduler` (see the module
    docstring for the threading and bitwise contracts).

    Usage::

        front = AsyncFrontend(scheduler)
        await front.start()
        result = await front.submit(Request(rid=0, size=2, seed=7))
        await front.close()

    ``submit`` returns when the scheduler completes the request; N
    concurrent ``submit`` coroutines form an open-loop client population.
    """

    def __init__(self, scheduler: Scheduler):
        self.scheduler = scheduler
        self._queue: Optional[asyncio.Queue] = None
        self._futures: Dict[int, asyncio.Future] = {}
        self._engine: Optional[asyncio.Task] = None
        self._executor: Optional[concurrent.futures.ThreadPoolExecutor] = None
        self._server: Optional[asyncio.AbstractServer] = None
        #: Scheduler iterations the engine has run (tests observe progress).
        self.steps = 0

    # -- lifecycle ----------------------------------------------------------

    async def start(self) -> None:
        """Start the engine task.  Idempotent; must run inside the event
        loop that will carry the submissions."""
        if self._engine is not None:
            return
        self._queue = asyncio.Queue()
        self._executor = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="serve-step")
        self._engine = asyncio.get_running_loop().create_task(
            self._run_engine())

    async def close(self) -> None:
        """Stop the engine after the queue drains and every outstanding
        request resolves; shuts the TCP server down first if one is up."""
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None
        if self._engine is None:
            return
        while self._futures or not self._queue.empty():
            await asyncio.sleep(_IDLE_POLL_S)
        engine, self._engine = self._engine, None
        engine.cancel()
        try:
            await engine
        except asyncio.CancelledError:
            pass
        self._executor.shutdown(wait=True)
        self._executor = None

    # -- submission ---------------------------------------------------------

    async def submit(self, request: Request,
                     arrival_s: Optional[float] = None) -> ServeResult:
        """Enqueue one request and await its :class:`ServeResult`.

        ``arrival_s`` (scheduler-clock seconds) is forwarded to
        ``Scheduler.submit`` so open-loop drivers can stamp synthetic
        arrival times; by default the scheduler stamps hand-off time, so
        reported latency includes time spent queued in the frontend.
        ``rid`` values must be unique among in-flight requests — the rid
        keys the result future."""
        if self._engine is None:
            raise RuntimeError("AsyncFrontend.start() has not run — "
                               "submissions have no engine to serve them")
        if request.rid in self._futures:
            raise ValueError(
                f"request rid {request.rid} is already in flight — rids "
                f"key result delivery and must be unique")
        future: asyncio.Future = asyncio.get_running_loop().create_future()
        self._futures[request.rid] = future
        self._queue.put_nowait((request, arrival_s))
        return await future

    # -- the engine ---------------------------------------------------------

    def _drain_queue(self) -> None:
        # runs on the loop thread between executor steps — the only place
        # submissions enter the scheduler, so arrivals join at chunk
        # boundaries by construction
        while not self._queue.empty():
            request, arrival_s = self._queue.get_nowait()
            try:
                self.scheduler.submit(request, arrival_s=arrival_s)
            except Exception as e:  # noqa: BLE001 — deliver, don't kill loop
                self._futures.pop(request.rid).set_exception(e)

    async def _run_engine(self) -> None:
        loop = asyncio.get_running_loop()
        while True:
            if self._queue.empty() and not self.scheduler.busy:
                await asyncio.sleep(_IDLE_POLL_S)
                continue
            self._drain_queue()
            if not self.scheduler.busy:
                continue
            results = await loop.run_in_executor(
                self._executor, self.scheduler.step)
            self.steps += 1
            for result in results:
                future = self._futures.pop(result.rid, None)
                if future is not None and not future.done():
                    future.set_result(result)
            # yield so submit() callers queued behind the step get in
            # before the next iteration
            await asyncio.sleep(0)

    # -- TCP loopback -------------------------------------------------------

    async def serve_tcp(self, host: str = "127.0.0.1",
                        port: int = 0) -> Tuple[str, int]:
        """Expose the frontend on a TCP loopback socket; returns the bound
        ``(host, port)``.

        Wire protocol: JSON lines.  Each client line is one request object
        (fields of :class:`Request`; ``deadline_ms: null`` means no SLO),
        answered — in completion order, not necessarily request order — by
        one :func:`result_summary` line, or ``{"rid": ..., "error": msg}``
        for a rejected submission.  Payloads never cross the socket."""
        if self._engine is None:
            await self.start()

        async def handle(reader, writer):
            pending = set()

            async def roundtrip(line):
                try:
                    result = await self.submit(request_from_wire(
                        json.loads(line)))
                    out = result_summary(result)
                except Exception as e:  # noqa: BLE001 — report to client
                    try:
                        rid = json.loads(line).get("rid")
                    except Exception:  # noqa: BLE001
                        rid = None
                    out = {"rid": rid, "error": str(e)}
                writer.write(json.dumps(out).encode() + b"\n")
                await writer.drain()

            try:
                while True:
                    line = await reader.readline()
                    if not line:
                        break
                    pending.add(asyncio.get_running_loop().create_task(
                        roundtrip(line.decode())))
                    pending = {t for t in pending if not t.done()}
                if pending:
                    await asyncio.gather(*pending)
            finally:
                writer.close()
                await writer.wait_closed()

        self._server = await asyncio.start_server(handle, host, port)
        sock = self._server.sockets[0].getsockname()
        return sock[0], sock[1]
