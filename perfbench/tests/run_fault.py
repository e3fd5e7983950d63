r"""A run of the benchmark with a fault of ``faults.py`` planted in the port:

    python3 perfbench/tests/run_fault.py <fault> --workload <cell> --seed <n> \
        --seconds <s> --trace 0

The readings of the faults in ``PERF.md`` come from this, on the card at
each cell's own size; ``test_bench_faults.py`` runs the same on the CPU.
"""

import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE.parent), str(HERE)]

import faults  # noqa: E402
import run  # noqa: E402

if __name__ == "__main__":
    faults.plant(sys.argv[1])
    sys.exit(run.main(sys.argv[2:]))
