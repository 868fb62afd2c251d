"""Event RAW encoders (EVT2 / EVT3 / DAT) for fixtures and round-trip tests.

A copy of ``xmaps_tpu.io.evt_encode`` (pinned equal, byte for byte of
output, by tests/test_torch_io.py).

The ESL .raw recordings are not part of the repository, so tests
synthesize RAW files from simulated events and validate the decoders by
round trip, mirroring the reference's reliance on golden replay data
(SURVEY.md §4).
"""

from __future__ import annotations

import numpy as np


def encode_evt2(events: np.ndarray, width: int, height: int) -> bytes:
    """Encode structured events into a Prophesee RAW container with EVT2
    payload (32-bit words, TIME_HIGH interleaved)."""
    header = (
        "% camera_integrator_name Prophesee\n"
        "% format EVT2;height={h};width={w}\n"
        "% geometry {w}x{h}\n"
        "% integrator_name Prophesee\n"
        "% plugin_name hal_plugin_gen31_fx3\n"
        "% end\n"
    ).format(w=width, h=height)

    t = np.asarray(events["t"], dtype=np.int64)
    x = np.asarray(events["x"], dtype=np.uint32)
    y = np.asarray(events["y"], dtype=np.uint32)
    p = np.asarray(events["p"], dtype=np.uint32) & 1

    th = (t >> 6).astype(np.int64)  # TIME_HIGH value per event
    ts6 = (t & 0x3F).astype(np.uint32)

    words = []
    last_th = None
    for i in range(len(t)):
        if last_th is None or th[i] != last_th:
            words.append((0x8 << 28) | (int(th[i]) & 0x0FFFFFFF))
            last_th = th[i]
        words.append(
            (int(p[i]) << 28)
            | (int(ts6[i]) << 22)
            | ((int(x[i]) & 0x7FF) << 11)
            | (int(y[i]) & 0x7FF)
        )
    payload = np.asarray(words, dtype="<u4").tobytes()
    return header.encode() + payload


def encode_evt3(events: np.ndarray, width: int, height: int) -> bytes:
    """Encode structured events into a RAW container with EVT3 payload,
    exercising ADDR_Y/ADDR_X and the VECT_12/VECT_8 vector words."""
    header = (
        "% camera_integrator_name Prophesee\n"
        "% format EVT3;height={h};width={w}\n"
        "% geometry {w}x{h}\n"
        "% end\n"
    ).format(w=width, h=height)

    t = np.asarray(events["t"], dtype=np.int64)
    x = np.asarray(events["x"], dtype=np.int64)
    y = np.asarray(events["y"], dtype=np.int64)
    p = np.asarray(events["p"], dtype=np.int64) & 1

    words: list[int] = []
    cur_y = None
    cur_th = None
    cur_tl = None

    i = 0
    n = len(t)
    while i < n:
        th = int(t[i] >> 12) & 0xFFF
        tl = int(t[i]) & 0xFFF
        if cur_th != th:
            words.append((0x8 << 12) | th)
            cur_th = th
            cur_tl = None
        if cur_tl != tl:
            words.append((0x6 << 12) | tl)
            cur_tl = tl
        if cur_y != int(y[i]):
            cur_y = int(y[i])
            words.append((0x0 << 12) | cur_y)

        # group a run of same-(t, y, p) events with consecutive-ish x into a
        # vector word when >= 3, else a single ADDR_X
        j = i + 1
        while (
            j < n
            and t[j] == t[i]
            and y[j] == y[i]
            and p[j] == p[i]
            and 0 < x[j] - x[j - 1]
            and x[j] - x[i] < 12
        ):
            j += 1
        run = j - i
        if run >= 3:
            base = int(x[i])
            mask = 0
            for k in range(i, j):
                mask |= 1 << int(x[k] - base)
            words.append((0x3 << 12) | (int(p[i]) << 11) | base)
            words.append((0x4 << 12) | (mask & 0xFFF))
            i = j
        else:
            words.append((0x2 << 12) | (int(p[i]) << 11) | (int(x[i]) & 0x7FF))
            i += 1

    payload = np.asarray(words, dtype="<u2").tobytes()
    return header.encode() + payload


def encode_dat(events: np.ndarray, width: int, height: int) -> bytes:
    """Encode structured events into the Prophesee DAT container."""
    header = (
        "% Data file containing CD events.\n"
        "% Version 2\n"
        "% Width {w}\n"
        "% Height {h}\n"
    ).format(w=width, h=height)
    prefix = bytes([0x0C, 0x08])  # event type CD, event size 8
    t = np.asarray(events["t"], dtype=np.uint32)
    data = (
        (np.asarray(events["x"], np.uint32) & 0x3FFF)
        | ((np.asarray(events["y"], np.uint32) & 0x3FFF) << 14)
        | ((np.asarray(events["p"], np.uint32) & 0xF) << 28)
    )
    recs = np.empty((len(t), 2), dtype="<u4")
    recs[:, 0] = t
    recs[:, 1] = data
    return header.encode() + prefix + recs.tobytes()
