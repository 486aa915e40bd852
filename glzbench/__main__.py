import time

T0 = time.perf_counter()  # set-up is counted from here

import sys  # noqa: E402

from glzbench import harness  # noqa: E402

sys.exit(harness.main(sys.argv[1:], T0))
