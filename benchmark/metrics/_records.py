"""The program's own records, for the readers of ``program_span`` metrics.

``xmaps_tpu_torch.utils.stats.records()`` holds the spans and counters the
program took while a traced run's profiler recorded: name, start and end in
seconds of ``time.perf_counter`` (the clock of ``run.window`` and of the
device trace), the index of the span open around it, and a tag.  A program
without the tracer, or one that kept nothing, gives None, and so does every
reader built on it.
"""

from __future__ import annotations


def load(run):
    """The run's records as a ``Tree`` (None: nothing to read)."""
    try:
        from xmaps_tpu_torch.utils.stats import records
    except ImportError:
        return None
    recs = records()
    if not recs or run.window is None:
        return None
    return Tree(recs, run.window)


class Tree:
    """The records with their children, and the window's records by name."""

    def __init__(self, recs, window):
        self.recs, (self.w0, self.w1) = recs, window
        self.kids = {}
        for i, r in enumerate(recs):
            if r.parent is not None:
                self.kids.setdefault(r.parent, []).append(i)

    def in_window(self, name) -> list:
        """The indices of the closed records of ``name`` that start in the window."""
        return [i for i, r in enumerate(self.recs) if r.name == name and r.end is not None
                and self.w0 <= r.start < self.w1]

    def seconds(self, i) -> float:
        return self.recs[i].end - self.recs[i].start

    def total(self, name) -> float:
        """Seconds of the window's records of ``name``."""
        return sum(self.seconds(i) for i in self.in_window(name))

    def children(self, i, name) -> list:
        return [j for j in self.kids.get(i, ()) if self.recs[j].name == name]

    def descendants(self, i, name) -> list:
        """The closed records of ``name`` below ``i`` (not below one another)."""
        out, todo = [], list(self.kids.get(i, ()))
        while todo:
            j = todo.pop()
            if self.recs[j].name == name:
                if self.recs[j].end is not None:
                    out.append(j)
            else:
                todo.extend(self.kids.get(j, ()))
        return sorted(out)

    def triggering_packets(self) -> list:
        """The window's ``pipe.packet`` spans that hand a frame over."""
        return [i for i in self.in_window("pipe.packet") if self.descendants(i, "pipe.handover")]


def median_child_us(run, name, below=False):
    """The median, over the window's triggering packets, of the µs of
    their ``name`` child (``below``: their ``name`` spans at any depth;
    None without one)."""
    import numpy as np

    tree = load(run)
    if tree is None:
        return None
    find = tree.descendants if below else tree.children
    us = [sum(tree.seconds(j) for j in find(i, name)) * 1e6
          for i in tree.triggering_packets() if find(i, name)]
    return float(np.median(us)) if us else None


def per_frame_us(run, name):
    """µs of the window's ``name`` spans over the window's frames."""
    tree = load(run)
    frames = run.values.get("frames")
    if tree is None or not frames or not tree.in_window(name):
        return None
    return tree.total(name) / frames * 1e6


def group_split_us(run, launches: bool):
    """The mean, over the window's ``engine.group`` spans, of the µs of
    their ``kernel.launch`` descendants (``launches``) or of the rest."""
    tree = load(run)
    groups = tree.in_window("engine.group") if tree is not None else []
    if not groups:
        return None
    out = []
    for i in groups:
        launch = sum(tree.seconds(j) for j in tree.descendants(i, "kernel.launch"))
        out.append(launch if launches else tree.seconds(i) - launch)
    return sum(out) / len(out) * 1e6
