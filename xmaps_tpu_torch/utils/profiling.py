"""Device time of calls on the card, from torch.profiler.

``device_events`` returns the device-side events (kernels, memsets,
copies) of ``iters`` calls of a function.  The profiler can lose device
events near the start and the end of a session (9 to 40 of 50 short
kernels in single sessions on the H100), so
the calls sit between two marker kernels (``torch.cuda._sleep``), with
untimed calls for ``pad_s`` seconds of host time before the first marker
and after the second, and only the events between the markers count.  A
session that lost a marker, or that holds a device event a non-whole
number of times a call (it lost events), is taken again (at most twice
more).  On a mesh of several cards the events of every card count: the
sum is device time, not wall time.
"""

from __future__ import annotations

import collections
import time

import torch

__all__ = ["device_events"]

#: host seconds of untimed calls on each side of a profiled window
PAD_S = 0.02


def device_events(fn, iters: int, pad_s: float = PAD_S, devices=None) -> list:
    """The device events of ``iters`` calls of ``fn`` as (name, start us,
    duration us) in time order (the module docstring).  ``devices``: the
    cards ``fn`` runs on (default: the current one); each gets its own
    two markers, and its events count between them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cards = [torch.device("cuda", torch.cuda.current_device())] if devices is None else [
        torch.device(d) for d in devices]

    def pad():
        t0 = time.perf_counter()
        fn()
        while time.perf_counter() - t0 < pad_s:
            fn()

    def mark():
        for d in cards:
            with torch.cuda.device(d):
                torch.cuda._sleep(1)

    def sync():
        for d in cards:
            torch.cuda.synchronize(d)

    for _ in range(3):
        sync()
        # an empty session first: device records of work run outside a
        # session that are still buffered are delivered to it
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            sync()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            pad()
            mark()
            for _ in range(iters):
                fn()
            mark()
            pad()
            sync()
        # on one card every device event counts as that card's
        by_card: dict = {d.index: [] for d in cards}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                card = e.device_index if len(cards) > 1 else cards[0].index
                by_card.setdefault(card, []).append(
                    (e.name, e.time_range.start, e.time_range.elapsed_us()))
        events, lost = [], None
        for card, evs in by_card.items():
            evs.sort(key=lambda e: e[1])
            marks = [i for i, e in enumerate(evs) if "spin_kernel" in e[0]]
            if len(marks) != 2:
                lost = f"{len(marks)} marker kernels on card {card}"
                break
            events += evs[marks[0] + 1:marks[1]]
        if lost is not None:
            continue
        counts = collections.Counter(e[0] for e in events)
        lost = {k[:60]: c / iters for k, c in counts.items() if c % iters}
        if not lost:
            return sorted(events, key=lambda e: e[1])
    raise RuntimeError(f"the profiler lost device events in 3 sessions: {lost}")
