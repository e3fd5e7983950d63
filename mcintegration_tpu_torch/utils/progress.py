"""Minimal terminal progress bar with speed display.

Stands in for the reference's ProgressMeter integration (src/main.jl:124-127,
289-291): tracks iterations x blocks of the root worker and prints evals/s.
"""

import sys
import time


class ProgressBar:
    def __init__(self, total: int, desc: str = "", enabled: bool = True,
                 min_interval: float = 0.5, stream=None):
        self.total = max(int(total), 1)
        self.count = 0
        self.desc = desc
        self.enabled = enabled and (stream or sys.stderr).isatty()
        self.min_interval = min_interval
        self.stream = stream or sys.stderr
        self.start = time.time()
        self._last = 0.0
        self.evals = 0

    def update(self, n: int = 1, evals: int = 0):
        self.count += n
        self.evals += evals
        now = time.time()
        if not self.enabled:
            return
        if now - self._last < self.min_interval and self.count < self.total:
            return
        self._last = now
        frac = self.count / self.total
        width = 30
        filled = int(width * frac)
        rate = self.evals / max(now - self.start, 1e-9)
        bar = "#" * filled + "-" * (width - filled)
        self.stream.write(
            f"\r{self.desc}[{bar}] {self.count}/{self.total} "
            f"({rate:.3g} evals/s)"
        )
        if self.count >= self.total:
            self.stream.write("\n")
        self.stream.flush()
