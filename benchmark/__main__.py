"""`python3 -m benchmark --workload NAME --seed N --seconds S --trace 0|1`."""
import time

STARTED = time.perf_counter()  # set-up is timed from here

import sys  # noqa: E402

from benchmark.run import main  # noqa: E402

sys.exit(main(started=STARTED))
