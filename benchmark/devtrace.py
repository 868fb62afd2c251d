"""The device trace of a traced run: torch.profiler over a sub-window.

``DeviceTrace`` profiles CUDA activity only (kernels, copies, memsets)
between two marker kernels (``torch.cuda._sleep``), launched on an idle
card so that each starts as its host call returns: the first marker ties
the profiler's clock to the host's, the events between the markers are
the window's (the profiler can lose events near a session's edges, so the
session starts before the first marker and ends after the second), and
the window is from the end of the first marker to the start of the
second.  Busy time is the union of the device intervals in the window.
"""

from __future__ import annotations

import time

import torch

MARKER = "spin_kernel"


class DeviceTrace:
    def __init__(self, device):
        self.device = device
        self.events = []  # (name, start us, end us) in the host's clock
        self.window = None  # (start us, end us) in the host's clock
        self._prof = None

    def start(self):
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize(self.device)
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()

    def mark(self) -> float:
        """Launch a marker on the idle card; its host time in us."""
        torch.cuda.synchronize(self.device)
        t = time.perf_counter() * 1e6
        torch.cuda._sleep(1000)
        return t

    def stop(self, host_marks: tuple):
        from torch.autograd import DeviceType

        torch.cuda.synchronize(self.device)
        self._prof.__exit__(None, None, None)
        evs = sorted(((e.name, e.time_range.start, e.time_range.end)
                      for e in self._prof.events() if e.device_type == DeviceType.CUDA),
                     key=lambda e: e[1])
        self._prof = None
        marks = [i for i, e in enumerate(evs) if MARKER in e[0]]
        if len(marks) < 2:
            raise RuntimeError(f"the profiler lost a marker kernel ({len(marks)} of 2)")
        a, b = marks[0], marks[-1]
        shift = host_marks[0] - evs[a][1]
        self.window = (evs[a][2] + shift, evs[b][1] + shift)
        self.events = [(n, s + shift, e + shift) for n, s, e in evs[a + 1:b]
                       if MARKER not in n]

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    def busy_intervals(self) -> list:
        """The union of the window's device intervals, in us."""
        out = []
        lo, hi = self.window
        for _, s, e in self.events:
            s, e = max(s, lo), min(e, hi)
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e6

    def kernel_seconds(self, names) -> float:
        """Device seconds of the events whose name holds one of ``names``."""
        return sum(e - s for n, s, e in self.events if any(k in n for k in names)) / 1e6

    def top_ops(self, k: int = 10) -> list:
        tot = {}
        for n, s, e in self.events:
            tot[n] = tot.get(n, 0.0) + (e - s) / 1e6
        return sorted(([n[:120], v] for n, v in tot.items()), key=lambda x: -x[1])[:k]

    def idle_gaps(self, spans: list, k: int = 10) -> list:
        """The ``k`` longest idle gaps of the window, each named by the
        host span that covers most of it (``host`` where none does)."""
        busy = self.busy_intervals()
        lo, hi = self.window
        edges = [lo] + [x for iv in busy for x in iv] + [hi]
        gaps = sorted(((edges[i + 1] - edges[i], edges[i]) for i in range(0, len(edges), 2)
                       if edges[i + 1] > edges[i]), reverse=True)[:k]
        out = []
        for length, s in gaps:
            e = s + length
            best, name = 0.0, "host"
            for sp_name, a, b, _ in spans:
                cover = min(b * 1e6, e) - max(a * 1e6, s)
                if cover > best:
                    best, name = cover, sp_name
            out.append([name, length / 1e6])
        return out
