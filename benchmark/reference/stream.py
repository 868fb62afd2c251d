"""The plain reference of the stream path on the host, in NumPy.

Written from X-maps' published stream semantics (``depth_reprojection_pipe.py``
and ``trigger_finder.py``), sharing no code with the system under test:

- polarity filter: only ON events (p == 1) go on;
- activity filter (Metavision's ActivityNoiseFilterAlgorithm with a window
  of one projector period): an ON event is kept when one of its eight
  neighbour pixels had an ON event, earlier in the stream, at most
  ``window_us`` before it; every ON event, kept or not, counts as
  activity for later ones;
- frame segmentation: a pause is a gap of ``pause_us`` or more between
  consecutive filtered events; a frame is handed over when the span from
  the last event before its leading pause to its own last event lies in
  (period / 2, period] and more than ``min_events`` events lie in it; a
  pause pair spanning half a period or less is passed over, a longer one
  that fails the test is dropped; the frame handed over leaves out the
  first of its events and the last three (``trigger_finder.py:172``).

The frames of a stream are the generator's frames, so the expected frame
k is the generator's frame k, filtered, then trimmed.
"""

from __future__ import annotations

import numpy as np

NEIGHBOURS = [(dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1) if (dy, dx) != (0, 0)]
NONE = np.iinfo(np.int64).min // 4


def activity_keep(x, y, t, lead: int, width: int, window_us: int) -> np.ndarray:
    """Keep mask of the ON events ``lead:`` of a time-ordered ON stream
    (x, y, t); events ``:lead`` are only earlier activity (the previous
    frame, which holds every event within ``window_us`` of these)."""
    n = len(t)
    pix = (y.astype(np.int64) + 1) * (width + 2) + x.astype(np.int64) + 1
    order = np.lexsort((np.arange(n), pix))  # by pixel, then stream order
    spix, sidx = pix[order], np.arange(n)[order]
    i = np.arange(lead, n)
    latest = np.full(n - lead, NONE, dtype=np.int64)
    for dy, dx in NEIGHBOURS:
        q = pix[i] + dy * (width + 2) + dx
        # the last event at pixel q before event i: the sorted entry just
        # below (q, i)
        pos = np.searchsorted(spix * n + sidx, q * n + i) - 1
        hit = (pos >= 0) & (spix[np.maximum(pos, 0)] == q)
        latest = np.maximum(latest, np.where(hit, t[sidx[np.maximum(pos, 0)]], NONE))
    return t[i] - latest <= window_us


def filtered_frame(prev: np.ndarray | None, cur: np.ndarray, width: int,
                   window_us: int) -> np.ndarray:
    """The frame ``cur`` after the polarity and activity filters, with
    ``prev`` (the frame before it in the stream, or None) as its earlier
    activity."""
    cur = cur[cur["p"] == 1]
    both = cur if prev is None else np.concatenate([prev[prev["p"] == 1], cur])
    lead = len(both) - len(cur)
    keep = activity_keep(both["x"], both["y"], both["t"], lead, width, window_us)
    return cur[keep]


def segment(t: np.ndarray, period_us: float, pause_us: int, min_events: int) -> list:
    """The frames the trigger rule hands over from a filtered stream's
    times ``t``: (start, stop) slices, in stream order."""
    pauses = np.nonzero(np.diff(t) >= pause_us)[0]
    out = []
    for a, b in zip(pauses[:-1], pauses[1:]):
        span = int(t[b]) - int(t[a])
        if span <= period_us / 2:
            continue
        if span <= period_us and b - a > min_events:
            out.append((int(a) + 2, int(b) - 2))
    return out
