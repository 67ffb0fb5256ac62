"""Run one cell of the port's benchmark and print its result as the last line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with the cell's CUDA devices. The
program builds its CUDA kernels once into its own directory inside the
checkout; see README.md.
"""

import os
import sys
import time


def _process_start() -> float:
    """Wall-clock time at which this process started (the clock of
    ``setup_s``), from /proc; else now."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - (uptime - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.time()


if __name__ == "__main__":
    started = _process_start()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    os.environ["USE_FLAX"] = "0"
    sys.path.insert(0, root)
    from portbench.harness import main

    sys.exit(main(sys.argv[1:], process_start=started))
