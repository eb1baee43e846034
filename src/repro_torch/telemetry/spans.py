"""Nested span timelines with Chrome-trace and plain-text exports.

A :class:`Tracer` is a zero-dependency (stdlib-only) span recorder.  While
active it also registers itself on the comm layer's trace stack, so every
live :class:`~repro_torch.core.comm.CommEvent` lands as a child span of whatever
span is currently open -- carrying flow / stage / est_source / program_id /
fused_from provenance into the timeline.  Spans come in two time domains,
distinguished by the ``cat`` field rather than separate clocks:

* ``trace`` -- host-side work that happens at trace/lower/plan time
  (program recording, lowering passes, joint planning);
* ``wall``  -- wall-clock phases (dispatch, train/serve step loops).

Both are stamped with the same injectable monotonic clock (default
``time.perf_counter``); tests inject a fake clock so exports are
byte-deterministic.  CommEvent child spans get their *duration* from the
event's planner estimate (``event.seconds``; 0 while the port's planner
leaves it unset) -- the timeline shows where time is *expected* to go
inside a step whose envelope is measured.

Exports:

* :meth:`Tracer.to_chrome_trace` / :meth:`Tracer.chrome_trace_json` --
  ``trace_event``-format JSON (complete ``"X"`` events plus ``"i"``
  instants), loadable in Perfetto / ``chrome://tracing``;
* :meth:`Tracer.timeline` -- an indented plain-text tree for CI logs.
"""
from __future__ import annotations

import contextlib
import json
import threading
import time

_ACTIVE: list["Tracer"] = []


def current_tracer() -> "Tracer | None":
    """The innermost active tracer, or None."""
    return _ACTIVE[-1] if _ACTIVE else None


@contextlib.contextmanager
def maybe_span(name: str, cat: str = "wall", **args):
    """Open a span on the active tracer if there is one; no-op otherwise.

    The disabled path is one list check -- cheap enough for hot loops.
    """
    if not _ACTIVE:
        yield None
        return
    tr = _ACTIVE[-1]
    handle = tr.begin(name, cat=cat, **args)
    try:
        yield handle
    finally:
        tr.end(handle)


def maybe_instant(name: str, **args) -> None:
    """Record an instant annotation on the active tracer, if any."""
    if _ACTIVE:
        _ACTIVE[-1].instant(name, **args)


class _Span:
    __slots__ = ("name", "cat", "args", "ts", "dur", "depth", "ph", "tid")

    def __init__(self, name, cat, args, ts, depth, ph="X", dur=0.0, tid=1):
        self.name, self.cat, self.args = name, cat, args
        self.ts, self.dur, self.depth, self.ph = ts, dur, depth, ph
        self.tid = tid


class Tracer:
    """Records nested spans; context manager.

    Thread-aware: each OS thread gets its own open-span stack and its own
    exported ``tid`` lane (the thread that entered the tracer keeps the
    constructor's ``tid``; later threads get the next integers in first-use
    order), so background workers — e.g. the checkpoint save executor —
    can begin/end spans concurrently with the main loop without corrupting
    its nesting.  ``end()`` must be called on the span's own thread.

    Parameters
    ----------
    clock:
        Monotonic ``() -> float`` seconds source; defaults to
        ``time.perf_counter``.  Inject a fake for deterministic exports.
    pid, tid:
        Identifiers stamped on every exported trace event.
    """

    def __init__(self, clock=None, *, pid: int = 1, tid: int = 1):
        self.clock = clock if clock is not None else time.perf_counter
        self.pid, self.tid = pid, tid
        self._t0: float | None = None
        self._stacks: dict[int, list[_Span]] = {}
        self._tids: dict[int, int] = {}
        self._lock = threading.Lock()
        self._events: list[_Span] = []
        self.comm_events: list = []

    @property
    def _stack(self) -> list[_Span]:
        """This thread's open-span stack."""
        ident = threading.get_ident()
        stack = self._stacks.get(ident)
        if stack is None:
            stack = self._stacks.setdefault(ident, [])
        return stack

    def _tid_here(self) -> int:
        ident = threading.get_ident()
        tid = self._tids.get(ident)
        if tid is None:
            with self._lock:
                tid = self._tids.get(ident)
                if tid is None:
                    tid = self.tid if not self._tids \
                        else max(self._tids.values()) + 1
                    self._tids[ident] = tid
        return tid

    # ------------------------------------------------------------ lifecycle
    def __enter__(self) -> "Tracer":
        if self._t0 is None:
            self._t0 = self.clock()
        self._tid_here()  # the entering thread claims the base tid lane
        _ACTIVE.append(self)
        # Register on the comm trace stack so live CommEvents flow in.
        # Imported lazily: comm imports torch, telemetry only the stdlib.
        from repro_torch.core import comm as _comm
        _comm._TRACES.append(self)
        return self

    def __exit__(self, *exc) -> None:
        from repro_torch.core import comm as _comm
        if self in _comm._TRACES:
            _comm._TRACES.remove(self)
        if self in _ACTIVE:
            _ACTIVE.remove(self)

    def _now_us(self) -> float:
        if self._t0 is None:
            self._t0 = self.clock()
        return round((self.clock() - self._t0) * 1e6, 3)

    # ------------------------------------------------------------ recording
    def begin(self, name: str, cat: str = "wall", **args) -> _Span:
        stack = self._stack
        sp = _Span(name, cat, args, self._now_us(), len(stack),
                   tid=self._tid_here())
        stack.append(sp)
        return sp

    def end(self, handle: _Span) -> None:
        stack = self._stack
        while stack:
            sp = stack.pop()
            sp.dur = round(self._now_us() - sp.ts, 3)
            self._events.append(sp)
            if sp is handle:
                return
        raise RuntimeError(f"span {handle.name!r} is not open on this thread")

    @contextlib.contextmanager
    def span(self, name: str, cat: str = "wall", **args):
        handle = self.begin(name, cat=cat, **args)
        try:
            yield handle
        finally:
            self.end(handle)

    def instant(self, name: str, **args) -> None:
        self._events.append(_Span(name, "annotation", args,
                                  self._now_us(), len(self._stack), ph="i",
                                  tid=self._tid_here()))

    def record(self, event) -> None:
        """CommTrace duck-type hook: ingest a live CommEvent as a child
        span whose duration is the event's planner estimate."""
        self.comm_events.append(event)
        args = {
            "primitive": event.primitive,
            "bitmap": event.bitmap,
            "algorithm": event.algorithm,
            "flow": event.flow,
            "stage": event.stage,
            "est_source": event.est_source,
            "program_id": event.program_id,
            "fused_from": list(event.fused_from),
            "payload_bytes": event.payload_bytes,
            "ici_bytes": event.ici_bytes,
            "dcn_bytes": event.dcn_bytes,
            "est_seconds": event.seconds,
        }
        self._events.append(_Span(
            f"comm:{event.primitive}", "comm", args, self._now_us(),
            len(self._stack) + 1, dur=round((event.seconds or 0.0) * 1e6, 3),
            tid=self._tid_here()))

    # -------------------------------------------------------------- exports
    def finished(self) -> list:
        """Finished spans in deterministic (ts, then insertion) order."""
        return sorted(self._events, key=lambda s: (s.ts, s.depth))

    def to_chrome_trace(self) -> dict:
        events = []
        for sp in self.finished():
            ev = {"name": sp.name, "cat": sp.cat, "ph": sp.ph,
                  "ts": sp.ts, "pid": self.pid, "tid": sp.tid,
                  "args": sp.args}
            if sp.ph == "X":
                ev["dur"] = sp.dur
            else:
                ev["s"] = "t"
            events.append(ev)
        return {"displayTimeUnit": "ms", "traceEvents": events}

    def chrome_trace_json(self) -> str:
        """Deterministic serialization of :meth:`to_chrome_trace`."""
        return json.dumps(self.to_chrome_trace(), sort_keys=True, indent=1)

    def timeline(self) -> str:
        """Plain-text indented timeline for CI logs."""
        lines = []
        for sp in self.finished():
            pad = "  " * sp.depth
            if sp.ph == "i":
                head = f"{pad}@ {sp.name}"
            else:
                head = f"{pad}{sp.name} [{sp.cat}] {sp.dur:.1f}us"
            keys = ("flow", "stage", "est_source", "program_id")
            tail = " ".join(f"{k}={sp.args[k]}" for k in keys
                            if sp.args.get(k) is not None)
            lines.append(f"{head} {tail}".rstrip())
        return "\n".join(lines) + ("\n" if lines else "")


__all__ = ["Tracer", "current_tracer", "maybe_instant", "maybe_span"]
