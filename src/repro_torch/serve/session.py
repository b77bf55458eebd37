"""ServeSession: the async host loop over the continuous-batching
scheduler.

The loop is the classic serving shape — request queue -> batch assembly ->
device step -> complete — run either inline (:meth:`step` /
:meth:`run_until_idle` for tests and measurements that want
deterministic tick control) or on a background thread (:meth:`start`,
the "async host loop": callers ``submit`` from any thread and block on
``RequestHandle.result()`` while the loop keeps the device fed).

Built from a :class:`~repro_torch.serve.spec.ServeSpec` plus parameters.
Over a model-parallel mesh every rank of the model group builds the
session with its shards of the parameters and submits the same requests
(the same uids); the scheduler's admissions come from model rank 0
(``serve/scheduler.py``), and ``run_until_idle`` and the async loop take
rank 0's busy and stop flags, so the ranks tick in lockstep.  Stop the
loop on every rank; results come back on every rank.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional

from repro_torch.launch import report as report_lib
from repro_torch.serve import pool as pool_lib
from repro_torch.serve.scheduler import Request, Scheduler, Status
from repro_torch.serve.spec import ServeSpec


class RequestHandle:
    """Caller-facing future for one submitted request."""

    def __init__(self, req: Request):
        self.request = req
        self._done = threading.Event()
        self._error: Optional[Exception] = None

    @property
    def done(self) -> bool:
        return self._done.is_set()

    def result(self, timeout: Optional[float] = None) -> List[int]:
        """Block until served; returns the generated token ids."""
        if not self._done.wait(timeout):
            raise TimeoutError(
                f"request uid={self.request.uid} not complete after "
                f"{timeout}s (status={self.request.status.value})")
        if self._error is not None:
            raise RuntimeError(f"request uid={self.request.uid}: the "
                               f"serving loop failed") from self._error
        return list(self.request.tokens)


class ServeSession:
    """A live serving session: one model, one slot pool, many requests.

    Thread-safety: ``submit``/``step`` serialize on one lock, so the
    background loop and foreground submitters never race the scheduler's
    host state.  Use as a context manager to guarantee the loop stops::

        with ServeSession(spec, params).start() as sess:
            h = sess.submit(prompt, max_new=32)
            tokens = h.result(timeout=60)
    """

    def __init__(self, spec: ServeSpec, params, policy=None, mesh=None):
        self.spec = spec
        self.scheduler = Scheduler(spec, params, policy=policy, mesh=mesh)
        self._handles: Dict[int, RequestHandle] = {}
        self._n_completed = 0
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.error: Optional[Exception] = None

    # ------------------------------------------------------------------
    # intake
    # ------------------------------------------------------------------

    def submit(self, prompt, max_new: int, temperature: float = 0.0,
               seed: int = 0, uid: Optional[int] = None) -> RequestHandle:
        with self._lock:
            req = self.scheduler.submit(prompt, max_new,
                                        temperature=temperature,
                                        seed=seed, uid=uid)
            h = RequestHandle(req)
            if req.status is Status.DONE:     # served before this submit
                h._done.set()
            else:
                self._handles[req.uid] = h
        self._wake.set()
        return h

    # ------------------------------------------------------------------
    # inline driving (tests / measurements)
    # ------------------------------------------------------------------

    def step(self) -> bool:
        """One scheduling round; returns whether device work ran."""
        with self._lock:
            did = self.scheduler.tick()
            self._publish()
        return did

    def run_until_idle(self) -> List[Request]:
        """Drive ticks until all submitted work completes (inline —
        do not mix with a running background loop)."""
        while self.scheduler.agree(self.busy):
            if not self.step():
                raise RuntimeError("serve session stalled with work "
                                   "pending")
        return self.scheduler.completed

    @property
    def busy(self) -> bool:
        with self._lock:
            return self.scheduler.busy

    @property
    def stats(self) -> dict:
        with self._lock:
            return dict(self.scheduler.stats,
                        occupancy=self.scheduler.occupancy)

    def report(self) -> str:
        """Markdown §Serving section: pool geometry + session counters
        (``launch.report.serve_report``)."""
        return report_lib.serve_report(
            self.spec, self.stats,
            pool_bytes=pool_lib.pool_bytes(self.scheduler.cfg, self.spec))

    def _publish(self) -> None:
        # under self._lock: flip handles for newly completed requests
        done = self.scheduler.completed
        for req in done[self._n_completed:]:
            h = self._handles.pop(req.uid, None)
            if h is not None:
                h._done.set()
        self._n_completed = len(done)

    # ------------------------------------------------------------------
    # async host loop
    # ------------------------------------------------------------------

    def start(self) -> "ServeSession":
        """Start the background serving loop (idempotent)."""
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, name="serve-loop", daemon=True)
            self._thread.start()
        return self

    def _loop(self) -> None:
        agree = self.scheduler.agree
        try:
            while not agree(self._stop.is_set()):
                if not self.step() and not agree(self.busy):
                    # idle: park until the next submit (or stop) wakes us
                    self._wake.clear()
                    self._wake.wait(timeout=0.05)
        except Exception as exc:
            # every waiting caller gets the failure at once (``result``
            # raises it), and ``stop`` re-raises it
            self.error = exc
            with self._lock:
                for h in self._handles.values():
                    h._error = exc
                    h._done.set()

    def stop(self) -> None:
        self._stop.set()
        self._wake.set()
        if self._thread is not None:
            # a model rank's loop ends when rank 0's does
            self._thread.join(timeout=10.0 if self.scheduler.mesh is None
                              else 120.0)
            self._thread = None
        if self.error is not None:
            raise RuntimeError("the serving loop failed") from self.error

    def __enter__(self) -> "ServeSession":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()
