"""Interval timer for periodic progress reports.

Reference: src/utility/stopwatch.jl — ``check(watch, args...)`` fires the
callback whenever ``interval`` seconds have elapsed since the last firing.
Polled by ``integrate`` between device dispatches (host sync points), the
counterpart of the reference's every-1000-steps poll.
"""

import time


class StopWatch:
    def __init__(self, interval: float, callback):
        self.start = time.time()
        self.interval = float(interval)
        self.callback = callback

    def check(self, *args, **kwargs):
        now = time.time()
        if now - self.start > self.interval:
            self.callback(*args, **kwargs)
            self.start = now
