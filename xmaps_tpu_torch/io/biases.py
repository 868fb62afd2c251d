"""Camera bias handling (reference: biases.py).

Copy of ``xmaps_tpu.io.biases``.  Parses ``.bias`` text files
(``value % name`` per line) and models the Gen3.0 default biases with
interactive cycling/increase/decrease, preserving the reference's limits.
A capture backend (``io.capture``) programs the parsed values into its
camera.
"""

from __future__ import annotations


def load_bias_file(path: str) -> dict[str, int]:
    """Parse a `.bias` file: lines of 'value % name'
    (reference: biases.py:1-9)."""
    biases: dict[str, int] = {}
    with open(path, "r") as f:
        for line in f.readlines():
            parts = line.split("%")
            if len(parts) >= 2 and parts[0].strip():
                biases[parts[1].strip()] = int(parts[0].strip())
    return biases


_DEFAULT_BIASES = {
    "bias_diff": 300,
    "bias_diff_off": 225,
    "bias_diff_on": 375,
    "bias_fo": 1725,
    "bias_hpf": 1500,
    "bias_pr": 1500,
    "bias_refr": 1500,
}

_DEFAULT_LIMITS = {
    "bias_diff": (300, 300),
    "bias_diff_off": (0, 299),
    "bias_diff_on": (301, 1800),
    "bias_fo": (1650, 1800),
    "bias_hpf": (0, 1800),
    "bias_pr": (1200, 1800),
    "bias_refr": (1300, 1700),
}


class Biases:
    """Gen3.0 camera bias set with interactive tuning
    (reference: biases.py:12-75)."""

    def __init__(self, biases=None, biases_limits=None):
        self.biases = dict(biases) if biases else dict(_DEFAULT_BIASES)
        self.biases_limits = (
            dict(biases_limits) if biases_limits else dict(_DEFAULT_LIMITS)
        )
        self.bias_keys = list(self.biases.keys())
        self.current_bias_idx = 0
        self.current_bias = self.bias_keys[0]

    def cycle_current_bias(self) -> str:
        self.current_bias_idx = (self.current_bias_idx + 1) % len(self.biases)
        self.current_bias = self.bias_keys[self.current_bias_idx]
        return self.current_bias

    def _limit(self, name):
        return self.biases_limits.get(name, (-(1 << 31), 1 << 31))

    def increase_current(self, step_size: int = 1) -> int:
        lo, hi = self._limit(self.current_bias)
        self.biases[self.current_bias] = min(
            self.biases[self.current_bias] + step_size, hi
        )
        return self.biases[self.current_bias]

    def decrease_current(self, step_size: int = 1) -> int:
        lo, hi = self._limit(self.current_bias)
        self.biases[self.current_bias] = max(
            self.biases[self.current_bias] - step_size, lo
        )
        return self.biases[self.current_bias]
