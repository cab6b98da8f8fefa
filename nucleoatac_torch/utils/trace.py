"""The port's one tracer: spans, counters and loop records.

A span (``with span("loop.wait"):``) adds its inclusive wall time, from
``time.perf_counter_ns``, and one call to its name; a counter
(``count("graphs.copy_in_bytes", n)``) adds an integer to its name. Both
add to the newest loop record: ``models/occ.py::_pipelined`` opens one per
call (``open_loop``), so a batch loop's totals stay apart from the loops
before it; the tracer keeps only that newest record. Before the first
loop the totals go to the record "process".

Each thread adds to its own accumulator inside the record, so the
finishing threads of the fused pass take no lock on the main thread's
path; a read (``Record.spans``, ``Record.counters``) merges the threads.

While a ``torch.profiler`` session records, a span enters
``record_function(<name>)`` instead and adds nothing: the profiler's
device trace then names the host's work on its own clock (an idle gap
under ``loop.wait`` is a wait on the card), and a traced stretch stays
out of the record of the loop it interrupts. Counters skip it too.
``annotated(name)`` marks a function the same way under a profiler and
costs one flag test off it: the engine's stage methods, which run eagerly
only at a warm-up, a capture and on the CPU, carry such ranges
(``engine.<stage>``) so that profiling/stages.py can map each kernel of a
replayed step to a stage.

Summing is always on. Off the profiler a span costs one object, two clock
reads and two dict updates (PERF.md gives the cost measured on the card's
host).

A device counter (``device_counters(names, buffers)``) is summed by a
kernel on the card, into integer tensors of fixed address that a replayed
graph adds to as well; the host adds nothing per batch. A record copies
their values on the card when it opens (no sync) and reads the difference
only when its counters are read, which waits for the card. They count
whatever ran in the loop's time, a profiled stretch included.
"""
from __future__ import annotations

import functools
from threading import get_ident
from time import perf_counter_ns

import torch.autograd.profiler as _profiler

__all__ = ["Record", "Tracer", "TRACER", "span", "count", "open_loop", "newest",
           "annotated"]

class Record:
    """The totals of one batch loop, per thread: ns and calls of each span
    and each counter's sum, merged when read."""

    def __init__(self, label: str, sources: tuple = ()):
        self.label = label
        self._threads: dict = {}  # thread ident -> (span ns, span calls, counters)
        # (names, buffers, {buffer's address: its values when the record opened})
        self._device = [(names, buffers, {b.data_ptr(): b.clone() for b in buffers()})
                        for names, buffers in sources]

    def _acc(self) -> tuple:
        """This thread's accumulators (made on its first use)."""
        ident = get_ident()
        acc = self._threads.get(ident)
        if acc is None:
            acc = self._threads[ident] = ({}, {}, {})
        return acc

    def spans(self) -> dict:
        """{name: (seconds, calls)} over every thread."""
        ns: dict = {}
        calls: dict = {}
        for t_ns, t_calls, _ in list(self._threads.values()):
            for name, n in dict(t_calls).items():
                calls[name] = calls.get(name, 0) + n
                ns[name] = ns.get(name, 0) + t_ns.get(name, 0)
        return {k: (ns[k] / 1e9, n) for k, n in calls.items()}

    def counters(self) -> dict:
        """{name: n} over every thread, and the device counters since the
        record opened (read from the card)."""
        out: dict = {}
        for _, _, ct in list(self._threads.values()):
            for name, n in dict(ct).items():
                out[name] = out.get(name, 0) + n
        for names, buffers, base in self._device:
            for buf in buffers():
                b0 = base.get(buf.data_ptr())
                vals = (buf - b0 if b0 is not None else buf).tolist()
                for name, n in zip(names, vals):
                    out[name] = out.get(name, 0) + int(n)
        return out

    def seconds(self, name: str) -> float:
        return self.spans().get(name, (0.0, 0))[0]

    def calls(self, name: str) -> int:
        return self.spans().get(name, (0.0, 0))[1]

    def mean_ms(self, name: str):
        """Mean ms per call of span ``name``; None if it never ran."""
        t, n = self.spans().get(name, (0.0, 0))
        return t / n * 1e3 if n else None

    def counter(self, name: str) -> int:
        return self.counters().get(name, 0)


class _Span:
    __slots__ = ("tracer", "name", "t0", "rf")

    def __init__(self, tracer, name: str):
        self.tracer, self.name = tracer, name

    def __enter__(self):
        if _profiler._is_profiler_enabled:
            self.t0 = None
            self.rf = _profiler.record_function(self.name)
            self.rf.__enter__()
        else:
            self.t0 = perf_counter_ns()
        return self

    def __exit__(self, et, ev, tb):
        t0 = self.t0
        if t0 is None:
            self.rf.__exit__(et, ev, tb)
            return False
        dt = perf_counter_ns() - t0
        rec = self.tracer.rec
        acc = rec._threads.get(get_ident()) or rec._acc()
        ns, calls, name = acc[0], acc[1], self.name
        ns[name] = ns.get(name, 0) + dt
        calls[name] = calls.get(name, 0) + 1
        return False


class Tracer:
    """Spans and counters into the newest loop record (``rec``)."""

    def __init__(self):
        self.sources: list = []  # (names, buffers) of the device counters
        self.rec = Record("process")

    def span(self, name: str) -> _Span:
        return _Span(self, name)

    def count(self, name: str, n: int = 1) -> None:
        if _profiler._is_profiler_enabled:
            return
        rec = self.rec
        ct = (rec._threads.get(get_ident()) or rec._acc())[2]
        ct[name] = ct.get(name, 0) + n

    def device_counters(self, names: tuple, buffers) -> None:
        """Counters ``names`` that kernels sum on the card: ``buffers()``
        gives the integer tensors (one per card, one value per name) as
        they are now. Records opened from now on report them."""
        self.sources.append((tuple(names), buffers))

    def open_loop(self, label: str) -> Record:
        """A new record, the newest from now on."""
        self.rec = Record(label, tuple(self.sources))
        return self.rec

    def newest(self) -> Record:
        return self.rec


def annotated(name: str):
    """A decorator: the function runs inside ``record_function(name)``
    while a profiler records, as itself otherwise. Never summed."""
    def wrap(f):
        @functools.wraps(f)
        def run(*args, **kwargs):
            if not _profiler._is_profiler_enabled:
                return f(*args, **kwargs)
            with _profiler.record_function(name):
                return f(*args, **kwargs)
        return run
    return wrap


# the process's tracer: the program's spans and counters, and what the
# benchmark's metric readers read
TRACER = Tracer()
span, count, open_loop, newest = TRACER.span, TRACER.count, TRACER.open_loop, TRACER.newest
