"""Run one cell of the benchmark:

  python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Prints each compared number beside its limit
on standard error and the result as the last line of standard output.
"""

import time

T_IMPORT = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

# The bytecode of every module a run imports, PyTorch's and the program's,
# is cached inside the checkout at a fixed path. Where the installed
# packages hold no bytecode and none can be written beside them, each run
# would otherwise compile some 1 700 modules from source in its set-up.
sys.pycache_prefix = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                  "_pycache")
sys.dont_write_bytecode = False


def process_start() -> float:
    """This process's start on the perf_counter clock (/proc's tick
    resolution), or the import of this module where /proc cannot say."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        return T_IMPORT
    age = uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    return time.perf_counter() - age if 0 <= age < 60 else T_IMPORT


if __name__ == "__main__":
    t_start = process_start()
    from portbench.harness import main

    sys.exit(main(sys.argv[1:], t_start, T_IMPORT))
