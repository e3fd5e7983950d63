"""ANSI color helpers (reference src/utility/color.jl)."""

import os
import sys

_ENABLED = sys.stdout.isatty() and os.environ.get("NO_COLOR") is None


def _wrap(code):
    def f(s):
        if not _ENABLED:
            return str(s)
        return f"\033[{code}m{s}\033[0m"
    return f


black = _wrap(30)
red = _wrap(31)
green = _wrap(32)
yellow = _wrap(33)
blue = _wrap(34)
magenta = _wrap(35)
cyan = _wrap(36)
white = _wrap(37)
