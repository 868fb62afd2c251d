"""Observability: counters, running metrics, timers, terminal dashboard,
and the program's one tracer.

The framework's profiling/metrics system, with the capability set of the
reference's StatsPrinter (stats_printer.py:43-347): occurrence counters,
scalar metric aggregation with local (since last print) and global windows,
named context-manager timers around pipeline stages, a 1 Hz in-place ANSI
dashboard, and one-shot setup timers.  Device-side stage timings come from
torch.profiler (``utils/profiling.py``, the benchmark's device trace);
these host-side timers measure wall-clock per stage including dispatch.

The tracer (``span``, ``records``) keeps records, not aggregates: a
span's name, start, end, the enclosing open span and a tag.  It records
only while a ``torch.profiler`` session records; otherwise ``span`` returns
one shared no-op context after a single flag read, with no clock read.
``records`` gives the times in seconds of ``time.perf_counter``, the clock
a profiler trace is tied to by a marker kernel, so spans and device
intervals share one time axis.  A dashboard timer (``measure_time``) is
also a span of its label.
"""

from __future__ import annotations

import time
from array import array
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Dict, NamedTuple, Optional

from torch.autograd import profiler as _profiler

#: records kept at most; later ones are dropped (and counted), never grown
TRACE_CAPACITY = 1 << 20

# The records, one column each (no object a record, so a long trace leaves
# the garbage collector nothing to walk): name, start and end in
# perf_counter ns (end -1 while open), the enclosing open span's index (-1
# at the top) and the tag.
_name: list = []
_tag: list = []
_start = array("q")
_end = array("q")
_parent = array("q")
_dropped = 0
#: the indices of the open spans, innermost last: one stack, as the
#: program's host path runs on one thread
_stack: list = []


class Record(NamedTuple):
    """One traced record, in seconds of ``time.perf_counter``; ``parent`` is
    the index in ``records()`` of the span open around it (None at the top),
    ``end`` None while the span is open."""

    name: str
    start: float
    end: Optional[float]
    parent: Optional[int]
    tag: Any


def _append(name: str, tag, start_ns: int, end_ns: int) -> int:
    """Append a record; its index, or -1 where the buffer is full."""
    global _dropped
    i = len(_name)
    if i >= TRACE_CAPACITY:
        _dropped += 1
        return -1
    _name.append(name)
    _tag.append(tag)
    _start.append(start_ns)
    _end.append(end_ns)
    _parent.append(_stack[-1] if _stack else -1)
    return i


def _open(name: str, tag, start_ns: int) -> int:
    """Start a span at ``start_ns``; its index (-1: dropped)."""
    i = _append(name, tag, start_ns, -1)
    if i >= 0:
        _stack.append(i)
    return i


def _close(i: int) -> None:
    """End span ``i`` now (nothing for -1: dropped, or not recording)."""
    if i >= 0:
        _end[i] = time.perf_counter_ns()
        _stack.pop()


class _Span:
    __slots__ = ("name", "tag", "i")

    def __init__(self, name: str, tag):
        self.name, self.tag = name, tag

    def __enter__(self):
        self.i = _open(self.name, self.tag, time.perf_counter_ns())
        return self

    def __exit__(self, exc_type, exc, tb):
        _close(self.i)
        return False


class _Off:
    """The shared no-op context of a span while nothing records."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, exc_type, exc, tb):
        return False


_OFF = _Off()


def span(name: str, tag=None):
    """A context manager recording the block as a span of ``name`` while a
    profiler records; else the shared no-op context."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, tag)


def records() -> list:
    """Every record kept, as ``Record``s in the order they started."""
    return [Record(n, a / 1e9, None if b < 0 else b / 1e9, None if p < 0 else p, tag)
            for n, a, b, p, tag in zip(_name, _start, _end, _parent, _tag)]


def dropped() -> int:
    """Records dropped since the last ``clear`` because the buffer was full."""
    return _dropped


def clear() -> None:
    """Forget every record (call with no span open)."""
    global _dropped
    for col in (_name, _tag, _start, _end, _parent, _stack):
        del col[:]
    _dropped = 0


def human_readable_time(ns: float) -> str:
    if abs(ns) >= 1e9:
        return f"{ns / 1e9:.2f} s"
    if abs(ns) >= 1e6:
        return f"{ns / 1e6:.2f} ms"
    if abs(ns) >= 1e3:
        return f"{ns / 1e3:.2f} us"
    return f"{ns:.0f} ns"


def human_readable_qty(q: float) -> str:
    for thresh, suffix in ((1e9, "G"), (1e6, "M"), (1e3, "k")):
        if abs(q) >= thresh:
            return f"{q / thresh:.2f}{suffix}"
    return f"{q:.6g}"


@dataclass
class _Agg:
    """Count/sum/min/max aggregation for one named quantity."""

    n: int = 0
    total: float = 0.0
    vmin: float = float("inf")
    vmax: float = float("-inf")

    def add(self, v: float):
        self.n += 1
        self.total += v
        self.vmin = min(self.vmin, v)
        self.vmax = max(self.vmax, v)

    @property
    def mean(self) -> float:
        return self.total / self.n if self.n else 0.0


@dataclass
class _Window:
    counters: Dict[str, int] = field(default_factory=dict)
    metrics: Dict[str, _Agg] = field(default_factory=dict)
    times_ns: Dict[str, _Agg] = field(default_factory=dict)

    def count(self, name, inc=1):
        self.counters[name] = self.counters.get(name, 0) + inc

    def metric(self, name, v):
        self.metrics.setdefault(name, _Agg()).add(v)

    def time_ns(self, name, v):
        self.times_ns.setdefault(name, _Agg()).add(v)


class StatsPrinter:
    """Pipeline statistics with periodic in-place terminal output."""

    def __init__(self, print_every_ms: int = 1000, silent: bool = False):
        self.print_every_ms = print_every_ms
        self.silent = silent
        self._local = _Window()
        self._global = _Window()
        self._start_ns = time.perf_counter_ns()
        self._last_print_ns = self._start_ns
        self._lines_printed = 0

    # -- recording -------------------------------------------------------

    def reset(self):
        self._local = _Window()
        self._global = _Window()
        self._start_ns = time.perf_counter_ns()
        self._last_print_ns = self._start_ns

    def count(self, name: str, inc: int = 1):
        self._local.count(name, inc)
        self._global.count(name, inc)

    def add_metric(self, name: str, value: float):
        self._local.metric(name, value)
        self._global.metric(name, value)

    def add_time_measure_ns(self, name: str, ns: float):
        self._local.time_ns(name, ns)
        self._global.time_ns(name, ns)

    @contextmanager
    def measure_time(self, name: str):
        # The dashboard's timer; while a profiler records, the block is also
        # a span of ``name`` that starts at the timer's own clock read and
        # ends just before its last one (so it leaves out the aggregation).
        t0 = time.perf_counter_ns()
        i = _open(name, None, t0) if _profiler._is_profiler_enabled else -1
        try:
            yield
        finally:
            _close(i)
            self.add_time_measure_ns(name, time.perf_counter_ns() - t0)

    # -- output ----------------------------------------------------------

    def toggle_silence(self) -> bool:
        self.silent = not self.silent
        return self.silent

    def log(self, msg: str):
        """Print a message without corrupting the dashboard redraw."""
        self._clear_dashboard()
        print(msg)

    def _clear_dashboard(self):
        if self._lines_printed:
            print(f"\x1b[{self._lines_printed}A\x1b[J", end="")
            self._lines_printed = 0

    def _format(self, win: _Window, header: str) -> list[str]:
        lines = [header]
        for name in sorted(win.counters):
            lines.append(f"  {name:28s} {human_readable_qty(win.counters[name])}")
        for name in sorted(win.metrics):
            a = win.metrics[name]
            lines.append(
                f"  {name:28s} avg {a.mean:10.3f}  min {a.vmin:10.3f}  "
                f"max {a.vmax:10.3f}  n {a.n}"
            )
        for name in sorted(win.times_ns):
            a = win.times_ns[name]
            lines.append(
                f"  {name:28s} avg {human_readable_time(a.mean):>10s}  "
                f"max {human_readable_time(a.vmax):>10s}  n {a.n}"
            )
        return lines

    def print_stats_if_needed(self):
        now = time.perf_counter_ns()
        if (now - self._last_print_ns) / 1e6 < self.print_every_ms:
            return
        self._last_print_ns = now
        if self.silent:
            return
        self._clear_dashboard()
        lines = self._format(self._local, "-- stats (last window) --")
        for line in lines:
            print(line)
        self._lines_printed = len(lines)
        self._local = _Window()

    def print_stats(self):
        """Final global summary (called at session end)."""
        self._clear_dashboard()
        for line in self._format(self._global, "== stats (global) =="):
            print(line)
        elapsed = (time.perf_counter_ns() - self._start_ns) / 1e9
        print(f"  total wall time: {elapsed:.2f} s")


class SingleTimer:
    """One-shot timer context for setup phases
    (reference: stats_printer.py:309-347)."""

    def __init__(self, message: str, silent: bool = False):
        self.message = message
        self.silent = silent

    def __enter__(self):
        self._t0 = time.perf_counter_ns()
        if not self.silent:
            print(f"{self.message}...", end="", flush=True)
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter_ns() - self._t0
        if not self.silent:
            print(f" done in {human_readable_time(dt)}")
        return False
