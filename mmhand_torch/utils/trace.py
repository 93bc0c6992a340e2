"""Spans and counters of the port, on the profiler's clock.

Spans mark the layer boundaries where the work happens (the GAN step's G
and D phases, each backward and Adam step, the loader's batch assembly,
the PNG encode, ...)::

    with trace.span("g_phase", device):
        ...

A span records its name, its start and end, the innermost span open on
the same thread when it began (its parent), the thread, and the step: the
owner of a step (``TrainStep.__call__``, the HPE ``train_step``, the eval
step) calls ``begin_step()``, and every span on that thread carries its
number until the next call.  Times are taken on ``time.perf_counter_ns()``
and converted, with one anchor taken when recording starts, to unix-epoch
ns: the clock of the profiler's event timestamps
(``_KinetoEvent.start_ns()``), so a span can be laid over the device
activities it caused.  Given a CUDA ``device``, a span also records a pair
of timing events on the device's current stream; their milliseconds
(``Span.device_ms``) are read only when the spans are read, after the
caller's own synchronize: a span never synchronizes.  While a profiler
records, each span also opens ``record_function(name)``, so it shows on the
profiler's timeline.

Spans record while a torch profiler records in the process, and between
``enable()`` and ``disable()``.  Off, ``span()`` returns one shared no-op
object: no clock read, no allocation.  The records stay in memory, at most
``CAPACITY`` of them; a span past that is dropped and counted in the
counter ``trace.spans_dropped``.

Counters are always on: ``count(name, n)`` adds to one registry,
``timed(name)`` adds the seconds of a scope, ``counters()`` and ``reset()``
read and clear it.  All of it is safe from worker threads; the stack of
open spans is per thread.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from typing import Optional

import torch
from torch.autograd import profiler as _profiler

CAPACITY = 1 << 16
DROPPED = "trace.spans_dropped"


class _Noop:
    """The span of a tracer that is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False


NOOP = _Noop()


class Span:
    """One span: a context manager while open, a record once closed.
    ``start_ns`` and ``end_ns`` are unix-epoch ns; ``parent`` is the
    ``id`` of the enclosing span on the same thread, or None."""

    __slots__ = ("name", "id", "parent", "thread", "step", "start_ns",
                 "end_ns", "_tracer", "_device", "_stream", "_events",
                 "_range")

    def __init__(self, tracer: "Tracer", name: str, device=None):
        self.name = name
        self._tracer = tracer
        self._device = device
        self._events = self._range = None

    def __enter__(self) -> "Span":
        t = self._tracer
        local = t._thread()
        self.id = next(t._ids)
        self.parent = local.stack[-1] if local.stack else None
        self.thread = threading.get_ident()
        self.step = local.step
        local.stack.append(self.id)
        if _profiler._is_profiler_enabled:
            self._range = _profiler.record_function(self.name)
            self._range.__enter__()
        device = self._device
        if device is not None and device.type == "cuda":
            self._stream = torch.cuda.current_stream(device)
            self._events = (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True))
            self._events[0].record(self._stream)
        self.start_ns = time.perf_counter_ns() + t._offset
        return self

    def __exit__(self, *exc) -> bool:
        t = self._tracer
        self.end_ns = time.perf_counter_ns() + t._offset
        if self._events is not None:
            self._events[1].record(self._stream)
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self._range = None
        t._thread().stack.pop()
        t._record(self)
        return False

    @property
    def host_ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6

    @property
    def device_ms(self) -> Optional[float]:
        """Milliseconds between the span's two events on its stream; None
        for a span without a CUDA device.  Read after a synchronize."""
        if self._events is None:
            return None
        return self._events[0].elapsed_time(self._events[1])

    def as_dict(self) -> dict:
        return {"name": self.name, "id": self.id, "parent": self.parent,
                "thread": self.thread, "step": self.step,
                "start_ns": self.start_ns, "end_ns": self.end_ns,
                "device_ms": self.device_ms}


class Tracer:
    """Spans in a bounded buffer and a registry of counters."""

    def __init__(self, capacity: int = CAPACITY):
        self.capacity = capacity
        self.enabled = False
        self._stale = True          # the clock anchor, until recording starts
        self._offset = 0
        self._spans: list[Span] = []
        self._counters: dict[str, float] = {}
        self._lock = threading.Lock()
        self._local = threading.local()
        self._ids = itertools.count(1)

    def _thread(self):
        local = self._local
        if not hasattr(local, "stack"):
            local.stack, local.step = [], None
        return local

    def span(self, name: str, device: Optional[torch.device] = None):
        """A span named ``name``; with a CUDA ``device``, timed on it too.
        Off, the shared no-op object."""
        if not (self.enabled or _profiler._is_profiler_enabled):
            self._stale = True
            return NOOP
        if self._stale:
            self._offset = time.time_ns() - time.perf_counter_ns()
            self._stale = False
        return Span(self, name, device)

    def _record(self, span: Span) -> None:
        with self._lock:
            if len(self._spans) < self.capacity:
                self._spans.append(span)
                return
        self.count(DROPPED)

    def begin_step(self) -> int:
        """Start this thread's next step; returns its number."""
        local = self._thread()
        local.step = (local.step or 0) + 1
        return local.step

    def enable(self) -> None:
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def spans(self) -> list[Span]:
        """The closed spans, in the order they closed."""
        with self._lock:
            return list(self._spans)

    def clear(self) -> None:
        """Empty the span buffer."""
        with self._lock:
            self._spans.clear()

    def count(self, name: str, n: float = 1) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + n

    @contextlib.contextmanager
    def timed(self, name: str):
        """Add the seconds of the scope to counter ``name``."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.count(name, time.perf_counter() - t0)

    def counters(self) -> dict:
        with self._lock:
            return dict(self._counters)

    def reset(self) -> None:
        """Set every counter back to nothing."""
        with self._lock:
            self._counters.clear()


# the process's tracer, which the port's modules record into
TRACER = Tracer()
span = TRACER.span
begin_step = TRACER.begin_step
enable = TRACER.enable
disable = TRACER.disable
spans = TRACER.spans
clear = TRACER.clear
count = TRACER.count
timed = TRACER.timed
counters = TRACER.counters
reset = TRACER.reset
