from .color import black, red, green, yellow, blue, magenta, cyan, white
from .stopwatch import StopWatch
from .progress import ProgressBar
